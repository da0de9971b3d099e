"""The ArcFace IResNet face embedder (``reference/arcface.py``), with
bundled weights that the port reads from the same ``.npz`` itself."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from port_bench.flops import layer_flops
from port_bench.reference import arcface as AF
from port_bench.reference.weights import load_arcface as load_reference

from . import config_args


def reference(arch: Dict) -> AF.IResNet:
    return AF.IResNet(AF.ArcFaceConfig(**config_args(arch)))


def port_model(runtime):
    return runtime["inner_face"].arcface_model


def load_port(backends, tree) -> None:
    """The port loads the bundled file itself."""


def flops(arch: Dict, size: Optional[int] = None) -> int:
    """One chip at the tower's ``input_size``."""
    model = reference(arch)
    s = model.cfg.input_size
    return layer_flops(model, torch.empty(1, 3, s, s))


def encode(model: AF.IResNet, chips: torch.Tensor) -> torch.Tensor:
    return AF.encode_chips(model, chips, flip_tta=False)


def dim(model: AF.IResNet) -> int:
    return int(model.cfg.embed_dim)
