"""SigLIP vision tower (torch) — a CLIP-face embedder.

SigLIP So400m/14 at 384 px (Zhai et al. 2023, arXiv:2303.15343; the
shape of Alabdulmohsin et al. 2023, arXiv:2305.13035; open_clip's
``ViT-SO400M-14-SigLIP-384``, the ``vision_config`` of
``google/siglip-so400m-patch14-384``): a 14×14 stride-14 patch conv with
bias → learned positions added, no class token and no pre-LN → pre-LN
blocks ``x + attn(LN(x))``, ``x + fc2(gelu_tanh(fc1(LN(x))))`` → final LN
→ the multi-head attention-pooling ("MAP") head: a learned probe queries
the tokens, then ``h + mlp(LN(h))``, and its one row is the embedding (no
projection). LayerNorm ε 1e-6, GELU in its tanh form, inputs normalised
with mean = std = 0.5.

Attention runs through ``F.scaled_dot_product_attention``, which on the
card never holds the ``[N, heads, T, T]`` logits (flash, memory-efficient
or cuDNN kernels; the plain one is refused there): bf16 q·k accumulated in
float32, a float32 softmax, bf16 probabilities into ·v, the numerics of
the port's CLIP towers. Weights load from a flax tree in big_vision's
layout through :func:`.bridge.load_siglip`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.preprocess import normalize_siglip
from ..utils.timing import NULL_TIMER

LN_EPS = 1e-6


@dataclass(frozen=True)
class SiglipConfig:
    name: str = "ViT-SO400M-14-SigLIP-384"
    image_size: int = 384
    patch: int = 14
    width: int = 1152
    layers: int = 27
    heads: int = 16
    mlp_dim: int = 4304
    embed_dim: int = 1152         # the MAP head's width: no projection
    pool: str = "map"


SO400M_14_384 = SiglipConfig()
TINY = SiglipConfig(name="siglip_tiny", image_size=32, patch=8, width=32,
                    layers=2, heads=2, mlp_dim=72, embed_dim=32)

CONFIGS = {c.name: c for c in (TINY, SO400M_14_384)}


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def attention(q, k, v):
    """``softmax(q·kᵀ/√d)·v`` over ``[B, heads, T, d]``. On CUDA only the
    fused kernels may run: none of them materialises the logits."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v)


def _heads(x, heads: int):
    b, t, w = x.shape
    return x.reshape(b, t, heads, w // heads).transpose(1, 2)


def _merge(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


class MHA(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.out = nn.Linear(width, width)

    def forward(self, x, timer=NULL_TIMER):
        q, k, v = (_heads(u, self.heads)
                   for u in self.qkv(x).split(x.shape[-1], dim=-1))
        with timer("face.attn"):
            out = _merge(attention(q, k, v))
        return self.out(out)


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: SiglipConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.width, eps=LN_EPS)
        self.attn = MHA(cfg.width, cfg.heads)
        self.ln2 = nn.LayerNorm(cfg.width, eps=LN_EPS)
        self.mlp = Mlp(cfg.width, cfg.mlp_dim)

    def forward(self, x, timer=NULL_TIMER):
        x = x + self.attn(self.ln1(x), timer)
        return x + self.mlp(self.ln2(x))


class MapHead(nn.Module):
    """Multi-head attention pooling: the learned probe is the one query,
    the tokens are keys and values."""

    def __init__(self, cfg: SiglipConfig):
        super().__init__()
        w = cfg.width
        self.heads = cfg.heads
        self.probe = nn.Parameter(torch.zeros(1, 1, w))
        self.q = nn.Linear(w, w)
        self.kv = nn.Linear(w, 2 * w)
        self.out = nn.Linear(w, w)
        self.ln = nn.LayerNorm(w, eps=LN_EPS)
        self.mlp = Mlp(w, cfg.mlp_dim)

    def forward(self, x, timer=NULL_TIMER):
        q = _heads(self.q(self.probe).expand(x.shape[0], -1, -1).contiguous(),
                   self.heads)
        k, v = (_heads(u, self.heads)
                for u in self.kv(x).split(x.shape[-1], dim=-1))
        with timer("face.attn"):
            h = _merge(attention(q, k, v))
        h = self.out(h)
        h = h + self.mlp(self.ln(h))
        return h[:, 0]


class SiglipViT(nn.Module):
    """Input ``[B, S, S, 3]`` normalised RGB (channels last, as
    ``ClipViT`` takes it) → ``[B, embed_dim]``."""

    normalize = staticmethod(normalize_siglip)

    def __init__(self, cfg: SiglipConfig):
        super().__init__()
        if cfg.pool != "map" or cfg.embed_dim != cfg.width:
            raise ValueError(f"{cfg.name}: the tower pools with its MAP head "
                             f"to its width (pool='map', embed_dim=width)")
        self.cfg = cfg
        n = cfg.image_size // cfg.patch
        w = cfg.width
        self.patch_embed = nn.Conv2d(3, w, cfg.patch, cfg.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, n * n, w))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        self.ln_post = nn.LayerNorm(w, eps=LN_EPS)
        self.head = MapHead(cfg)

    def forward(self, x, timer=NULL_TIMER):
        """``timer`` names each attention call ``face.attn``."""
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2) + self.pos_embed   # [B, n·n, W]
        for blk in self.blocks:
            x = blk(x, timer)
        return self.head(self.ln_post(x), timer)


def random_init(model: SiglipViT, generator: torch.Generator) -> SiglipViT:
    """Random weights drawn from ``generator`` with the port's
    initialisers (as ``clip_vit.random_init``): LeCun-normal kernels
    (variance 1/fan-in), zero biases, unit LayerNorm scales, normal(0.02)
    positions and probe."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("pos_embed", "probe"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif leaf == "weight" and p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(p[0].numel()))
            elif leaf == "bias":
                p.zero_()
            else:                                       # LayerNorm scale
                p.fill_(1.0)
    return model
