"""CLIP ViT image tower (torch) — the ReID embedder and the CLIP-face
fallback.

Counterpart of ``person_capture_tpu/models/clip_vit.py``: patch-embed conv →
class token prepended, learned positions added → pre-LN transformer → final
LN on the class token → projection (no bias). The same configurations;
parameters load from the JAX package's checkpoints through
:func:`.bridge.load_clip`. What the flax model fixes and torch's defaults
differ on: LayerNorm ε = 1e-6, exact GELU, attention logits and softmax in
float32 (cast to ``v``'s dtype before ``att @ v``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from .preprocess import normalize_clip, resize_bicubic

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


@dataclass(frozen=True)
class ClipVitConfig:
    name: str = "ViT-L-14"
    image_size: int = 224
    patch: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    embed_dim: int = 768          # projection output


TINY = ClipVitConfig(name="clip_tiny", image_size=32, patch=8, width=32,
                     layers=2, heads=2, embed_dim=16)
# compact tower of the bundled synthetic-trained ReID embedder
REID_S = ClipVitConfig(name="clip_reid_s", image_size=96, patch=8,
                       width=128, layers=5, heads=4, embed_dim=128)
VIT_B_32 = ClipVitConfig(name="ViT-B-32", patch=32, width=768, layers=12,
                         heads=12, embed_dim=512)
VIT_L_14 = ClipVitConfig(name="ViT-L-14")

CONFIGS = {c.name: c for c in (TINY, REID_S, VIT_B_32, VIT_L_14)}


class MHA(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.out = nn.Linear(width, width)

    def forward(self, x):
        b, t, w = x.shape
        d = w // self.heads
        q, k, v = (u.reshape(b, t, self.heads, d).transpose(1, 2)
                   for u in self.qkv(x).split(w, dim=-1))
        att = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(d)
        att = torch.softmax(att, dim=-1).to(v.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, t, w)
        return self.out(out)


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = MHA(width, heads)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.fc = nn.Linear(width, 4 * width)
        self.proj = nn.Linear(4 * width, width)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.proj(F.gelu(self.fc(self.ln2(x))))


class ClipViT(nn.Module):
    """Input ``[B, S, S, 3]`` normalized RGB (channels last, as the JAX
    model takes it) → ``[B, embed_dim]``."""

    def __init__(self, cfg: ClipVitConfig):
        super().__init__()
        self.cfg = cfg
        n = cfg.image_size // cfg.patch
        w = cfg.width
        self.patch_embed = nn.Conv2d(3, w, cfg.patch, cfg.patch, bias=False)
        self.class_token = nn.Parameter(torch.zeros(1, 1, w))
        self.pos_embed = nn.Parameter(torch.zeros(1, n * n + 1, w))
        self.ln_pre = nn.LayerNorm(w, eps=LN_EPS)
        self.blocks = nn.ModuleList(Block(w, cfg.heads)
                                    for _ in range(cfg.layers))
        self.ln_post = nn.LayerNorm(w, eps=LN_EPS)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, x):
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                # [B, n·n, W], (h, w)
        cls = self.class_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        x = self.ln_pre(x)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_post(x[:, 0]) @ self.proj


def random_init(model: ClipViT, generator: torch.Generator) -> ClipViT:
    """Random weights drawn from ``generator`` with the flax model's
    initialisers: LeCun-normal kernels (variance 1/fan-in), zero biases,
    unit LayerNorm scales, normal(0.02) class token, positions and
    projection. (The JAX package draws other numbers from its PRNG key.)"""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("class_token", "pos_embed", "proj"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif leaf == "weight" and p.dim() > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(fan_in))
            elif leaf == "bias":
                p.zero_()
            else:                                       # LayerNorm scale
                p.fill_(1.0)
    return model


def encode_images(model: ClipViT, crops_bgr):
    """Embed BGR crops ``[N, H, W, 3]`` (uint8 or float, any size) →
    L2-normalized float32 ``[N, D]``. A crop not already ``S×S`` has its
    shortest side resized to ``S`` (bicubic, as ``jax.image.resize``) and is
    centre-cropped, like the open_clip preprocess."""
    s = model.cfg.image_size
    x = crops_bgr.float()
    h, w = int(x.shape[1]), int(x.shape[2])
    if (h, w) != (s, s):
        scale = s / min(h, w)
        nh, nw = max(s, int(h * scale)), max(s, int(w * scale))
        x = resize_bicubic(x, nh, nw)
        y0 = int(round((nh - s) / 2.0))
        x0 = int(round((nw - s) / 2.0))
        x = x[:, y0:y0 + s, x0:x0 + s]
    dtype = model.proj.dtype
    with torch.inference_mode():
        emb = model(normalize_clip(x).to(dtype).contiguous()).float()
    norm = torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                       min=1e-10)
    return emb / norm
