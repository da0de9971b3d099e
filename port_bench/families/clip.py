"""A CLIP ViT image tower as the face embedder (``reference/clip_vit.py``).
No trained weights exist here: ``seeded`` draws the tower with the port's
initialisers (``clipweights.py``), and ``load_port`` hands the same tree
to every face backend through the port's own loader."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from port_bench.clipweights import clip_variables as seeded
from port_bench.reference import clip_vit as CV
from port_bench.reference.weights import load_clip as load_reference

from . import config_args


def reference(arch: Dict) -> CV.ClipViT:
    return CV.ClipViT(CV.ClipVitConfig(**config_args(arch)))


def port_model(runtime):
    return runtime["inner_face"].clip_model


def load_port(backends, tree) -> None:
    from person_capture_tpu_torch.models.bridge import load_clip

    for face in backends:
        load_clip(face.clip_model, tree)


def flops(arch: Dict, size: Optional[int] = None) -> int:
    """One image through a CLIP ViT tower: patch embedding, per layer the
    qkv, attention logits, attention-weighted values, output projection
    and MLP, and the final projection."""
    s, p, w = int(arch["image_size"]), int(arch["patch"]), int(arch["width"])
    t = (s // p) ** 2 + 1
    patch = 2 * (t - 1) * w * 3 * p * p
    per_layer = (2 * t * w * 3 * w          # qkv
                 + 2 * t * t * w            # q @ k^T over all heads
                 + 2 * t * t * w            # att @ v
                 + 2 * t * w * w            # out
                 + 2 * t * w * 4 * w * 2)   # fc and proj
    return patch + int(arch["layers"]) * per_layer + 2 * w * int(
        arch["embed_dim"])


def encode(model: CV.ClipViT, chips: torch.Tensor) -> torch.Tensor:
    return CV.encode_images(model, chips)


def dim(model: CV.ClipViT) -> int:
    return int(model.cfg.embed_dim)
