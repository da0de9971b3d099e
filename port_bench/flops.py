"""Model FLOPs of the benchmark's networks, from their shapes.

A multiply-add counts 2. Convolutions and dense layers count
``2 · out elements · in channels per group · kernel area``, worked out from
the output shape of each layer of the reference model at the given input
size (the model runs once on the ``meta`` device, which allocates and
computes nothing). A CLIP tower adds its attention products and its
projection by formula. Elementwise work, norms, activations, decoding and
NMS are not counted: model FLOPs, as MFU counts them.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn as nn

from .reference import arcface as AF
from .reference import scrfd as SD
from .reference import yolov8 as YV
from .reference.pipeline import _arch


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
def _scrfd(arch, size: int) -> int:
    model = SD.SCRFD(SD.SCRFDConfig(**dict(arch)))
    return layer_flops(model, torch.empty(1, 3, size, size))


@functools.lru_cache(maxsize=None)
def _yolo(arch, size: int) -> int:
    model = YV.YoloV8(YV.YoloConfig(**dict(arch)))
    return layer_flops(model, torch.empty(1, 3, size, size))


@functools.lru_cache(maxsize=None)
def _arcface(arch) -> int:
    cfg = AF.ArcFaceConfig(**dict(arch))
    s = cfg.input_size
    return layer_flops(AF.IResNet(cfg), torch.empty(1, 3, s, s))


def clip_flops(arch: Dict) -> int:
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


def detector_flops(det: Dict, canvas: int) -> int:
    """One frame through the face detector at a ``canvas``² letterbox."""
    return _scrfd(_key(_arch(det["arch"])), int(canvas))


def person_flops(per: Dict) -> int:
    return _yolo(_key(_arch(per["arch"])), int(per["det_size"]))


def embedder_flops(emb: Dict) -> int:
    """One face chip through the embedder."""
    if emb["kind"] == "arcface":
        return _arcface(_key(_arch(emb["arch"])))
    return clip_flops(emb["arch"])
