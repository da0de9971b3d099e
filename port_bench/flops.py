"""Model FLOPs of the benchmark's networks, from their shapes.

A multiply-add counts 2. Convolutions and dense layers count
``2 · out elements · in channels per group · kernel area``, worked out from
the output shape of each layer of the reference model at the given input
size (the model runs once on the ``meta`` device, which allocates and
computes nothing). Each model family counts its own (``families/<kind>.py``
``flops``): the convolutional ones by ``layer_flops``, a CLIP tower by
formula with its attention products. Elementwise work, norms, activations,
decoding and NMS are not counted: model FLOPs, as MFU counts them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn as nn

from .families import family, kind_of
# the ViT formula under its first name; the clip family owns it
from .families.clip import flops as clip_flops  # noqa: F401


def layer_flops(model: nn.Module, x: torch.Tensor) -> int:
    """FLOPs of ``model``'s ``Conv2d`` and ``Linear`` layers on ``x``."""
    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, nn.Conv2d):
            kh, kw = mod.kernel_size
            per = (mod.in_channels // mod.groups) * kh * kw
        else:
            per = mod.in_features
        total[0] += 2 * out.numel() * per

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            model.eval().to("meta")(x.to("meta"))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _key(arch: Dict):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in arch.items()))


@functools.lru_cache(maxsize=None)
def _counted(kind: str, arch, size: Optional[int]) -> int:
    return family(kind).flops(dict(arch), size)


def detector_flops(det: Dict, canvas: int) -> int:
    """One frame through the face detector at a ``canvas``² letterbox."""
    return _counted(kind_of(det, "detector"), _key(det["arch"]), int(canvas))


def person_flops(per: Dict) -> int:
    return _counted(kind_of(per, "person"), _key(per["arch"]),
                    int(per["det_size"]))


def embedder_flops(emb: Dict) -> int:
    """One face chip through the embedder."""
    return _counted(kind_of(emb, "embedder"), _key(emb["arch"]), None)
