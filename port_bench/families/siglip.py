"""A SigLIP vision tower as the face embedder (``reference/siglip.py``).
No trained SigLIP weights are in the repository: ``seeded`` draws the
tower with the port's initialisers (``models/siglip.random_init``) in
big_vision's layout, and ``load_port`` hands the same tree to every face
backend through the port's own loader (``bridge.load_siglip``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from port_bench.reference import siglip as SG
from port_bench.reference.siglip import load_reference  # noqa: F401

from . import config_args


def reference(arch: Dict) -> SG.SiglipViT:
    return SG.SiglipViT(SG.SiglipConfig(**config_args(arch)))


def _leaves(arch: Dict) -> List[Tuple[str, tuple, str, float]]:
    """(path, flax shape, kind, scale) of every leaf, in draw order:
    LeCun-normal kernels (variance 1/fan-in), zero biases, unit LayerNorm
    scales, normal(0.02) positions and probe."""
    w, p = int(arch["width"]), int(arch["patch"])
    heads, mlp = int(arch["heads"]), int(arch["mlp_dim"])
    n = (int(arch["image_size"]) // p) ** 2
    d = w // heads
    out = [("params/embedding/kernel", (p, p, 3, w), "normal",
            (p * p * 3) ** -0.5),
           ("params/embedding/bias", (w,), "zeros", 0.0),
           ("params/pos_embedding", (1, n, w), "normal", 0.02)]

    def norm(scope):
        out.append((f"params/{scope}/scale", (w,), "ones", 1.0))
        out.append((f"params/{scope}/bias", (w,), "zeros", 0.0))

    def dense(scope, fan_in, fan_out):
        out.append((f"params/{scope}/kernel", (fan_in, fan_out), "normal",
                    fan_in ** -0.5))
        out.append((f"params/{scope}/bias", (fan_out,), "zeros", 0.0))

    def attention(scope):
        for part in ("query", "key", "value"):
            out.append((f"params/{scope}/{part}/kernel", (w, heads, d),
                        "normal", w ** -0.5))
            out.append((f"params/{scope}/{part}/bias", (heads, d), "zeros",
                        0.0))
        out.append((f"params/{scope}/out/kernel", (heads, d, w), "normal",
                    w ** -0.5))
        out.append((f"params/{scope}/out/bias", (w,), "zeros", 0.0))

    def mlp_block(scope):
        dense(f"{scope}/Dense_0", w, mlp)
        dense(f"{scope}/Dense_1", mlp, w)

    for i in range(int(arch["layers"])):
        s = f"Transformer/encoderblock_{i}"
        norm(f"{s}/LayerNorm_0")
        attention(f"{s}/MultiHeadDotProductAttention_0")
        norm(f"{s}/LayerNorm_1")
        mlp_block(f"{s}/MlpBlock_0")
    norm("Transformer/encoder_norm")
    out.append(("params/MAPHead_0/probe", (1, 1, w), "normal", 0.02))
    attention("MAPHead_0/MultiHeadDotProductAttention_0")
    norm("MAPHead_0/LayerNorm_0")
    mlp_block("MAPHead_0/MlpBlock_0")
    return out


def seeded(arch: Dict, seed: int, device) -> Dict:
    """The flax tree (numpy float32) of a tower of ``arch``'s widths,
    its normal draws one call on ``device`` from a generator seeded
    there."""
    from port_bench.reference.weights import unflatten_tree

    leaves = _leaves(arch)
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


def port_model(runtime):
    return runtime["inner_face"].clip_model


def load_port(backends, tree) -> None:
    from person_capture_tpu_torch.models.bridge import load_siglip

    for face in backends:
        load_siglip(face.clip_model, tree)


def flops(arch: Dict, size: Optional[int] = None) -> int:
    """One image through the tower: the patch conv; per layer the qkv
    projection, q·kᵀ and the attention-weighted values over all heads,
    the output projection and the MLP; the MAP head's query (the probe,
    one row), keys and values, its two attention products over one
    query, output projection and MLP (one row)."""
    s, p, w = int(arch["image_size"]), int(arch["patch"]), int(arch["width"])
    mlp = int(arch["mlp_dim"])
    t = (s // p) ** 2
    patch = 2 * t * w * 3 * p * p
    per_layer = (2 * t * w * 3 * w          # qkv
                 + 2 * t * t * w            # q @ k^T over all heads
                 + 2 * t * t * w            # att @ v
                 + 2 * t * w * w            # out
                 + 2 * t * w * mlp * 2)     # fc1 and fc2
    head = (2 * w * w                       # q of the probe
            + 2 * t * w * 2 * w             # k and v
            + 2 * t * w * 2                 # q @ k^T and att @ v, one query
            + 2 * w * w                     # out
            + 2 * w * mlp * 2)              # MLP
    return patch + int(arch["layers"]) * per_layer + head


def encode(model: SG.SiglipViT, chips: torch.Tensor) -> torch.Tensor:
    return SG.encode_images(model, chips)


def dim(model: SG.SiglipViT) -> int:
    return int(model.cfg.embed_dim)
