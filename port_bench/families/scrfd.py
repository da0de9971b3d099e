"""The repo's SCRFD-style face detector (``reference/scrfd.py``), with
bundled weights that the port reads from the same ``.npz`` itself."""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.flops import layer_flops
from port_bench.reference import scrfd as SD
from port_bench.reference.weights import load_scrfd as load_reference

from . import config_args

detect_faces = SD.detect_faces


def reference(arch: Dict) -> SD.SCRFD:
    return SD.SCRFD(SD.SCRFDConfig(**config_args(arch)))


def port_model(runtime):
    return runtime["inner_face"].scrfd_model


def load_port(backends, tree) -> None:
    """The port loads the bundled file itself."""


def flops(arch: Dict, size: int) -> int:
    return layer_flops(reference(arch), torch.empty(1, 3, size, size))
