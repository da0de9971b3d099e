"""Seeded weights of a CLIP ViT image tower as flax variables.

The port's initialisers (``models/clip_vit.random_init``): LeCun-normal
kernels (variance 1/fan-in), zero biases, unit LayerNorm scales,
normal(0.02) class token, positions and projection. The normal draws are
one call on the device from a ``torch.Generator`` seeded there, so the
same seed gives the same tower; the tree goes to the port through its
own loader and to the reference through its copy of the mapping.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _leaves(cfg: Dict) -> List[Tuple[str, tuple, str, float]]:
    """(path, flax shape, kind, scale) of every leaf, in draw order."""
    w, p = int(cfg["width"]), int(cfg["patch"])
    n = (int(cfg["image_size"]) // p) ** 2
    out = [("params/patch_embed/kernel", (p, p, 3, w), "normal",
            (p * p * 3) ** -0.5),
           ("params/class_token", (1, 1, w), "normal", 0.02),
           ("params/pos_embed", (1, n + 1, w), "normal", 0.02),
           ("params/proj", (w, int(cfg["embed_dim"])), "normal", 0.02)]

    def norm(scope):
        out.append((f"params/{scope}/scale", (w,), "ones", 1.0))
        out.append((f"params/{scope}/bias", (w,), "zeros", 0.0))

    def dense(scope, fan_in, fan_out):
        out.append((f"params/{scope}/kernel", (fan_in, fan_out), "normal",
                    fan_in ** -0.5))
        out.append((f"params/{scope}/bias", (fan_out,), "zeros", 0.0))

    norm("ln_pre")
    for i in range(int(cfg["layers"])):
        s = f"block_{i}"
        norm(f"{s}/LayerNorm_0")
        dense(f"{s}/MHA_0/Dense_0", w, 3 * w)
        dense(f"{s}/MHA_0/Dense_1", w, w)
        norm(f"{s}/LayerNorm_1")
        dense(f"{s}/Dense_0", w, 4 * w)
        dense(f"{s}/Dense_1", 4 * w, w)
    norm("ln_post")
    return out


def clip_variables(cfg: Dict, seed: int, device) -> Dict:
    """The flax variable tree (numpy float32) of a tower of ``cfg``'s
    widths (``image_size``, ``patch``, ``width``, ``layers``,
    ``embed_dim``) drawn from ``seed`` on ``device``."""
    from .reference.weights import unflatten_tree

    leaves = _leaves(cfg)
    total = sum(int(np.prod(s)) for _, s, kind, _ in leaves
                if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draws = torch.randn(total, generator=gen, device=device).cpu().numpy()
    flat, at = {}, 0
    for path, shape, kind, scale in leaves:
        if kind == "normal":
            size = int(np.prod(shape))
            flat[path] = draws[at:at + size].reshape(shape) * np.float32(
                scale)
            at += size
        else:
            flat[path] = np.full(shape, scale, np.float32)
    return unflatten_tree(flat)
