"""SigLIP vision tower, plain float32 (torch) — the reference of the
SigLIP face embedder.

Written from the published description (Zhai et al. 2023,
arXiv:2303.15343; the So400m shape of Alabdulmohsin et al. 2023,
arXiv:2305.13035; ``vision_config`` of
https://huggingface.co/google/siglip-so400m-patch14-384): a 14×14
stride-14 patch conv with bias, learned positions added (no class token,
no pre-LN), pre-LN blocks ``x + attn(LN(x))`` then
``x + fc2(gelu_tanh(fc1(LN(x))))``, a final LN, and the multi-head
attention-pooling head: a learned probe is the one query over the tokens
(``q``, ``k``, ``v`` and ``out`` projections), then ``h + mlp(LN(h))``,
and ``h[:, 0]`` is the 1152-d embedding (no projection). LayerNorm ε
1e-6; GELU in its tanh form; attention the explicit
``softmax(q·kᵀ/√d)·v`` in float32. TF32 is off while it runs, and chips
go through in blocks so that the logits of one block fit.

Departures from the published model, each the pipeline's and not the
tower's: the input is the pipeline's aligned 112-px face chip (BGR),
resized to 384 with the Keys cubic (a = -0.5, half-pixel centres) of
``jax.image.resize``, not PIL's bicubic of a whole image; the weights are
drawn from a seed (no trained SigLIP weights are in the repository).
Weights come as a flax tree in big_vision's layout (a SigLIP
checkpoint's ``img`` subtree, unscanned).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from .preprocess import resize_bicubic

LN_EPS = 1e-6
MEAN = STD = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class SiglipConfig:
    name: str = "ViT-SO400M-14-SigLIP-384"
    image_size: int = 384
    patch: int = 14
    width: int = 1152
    layers: int = 27
    heads: int = 16
    mlp_dim: int = 4304
    embed_dim: int = 1152
    pool: str = "map"


def gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def attention(q, k, v):
    """``[B, heads, Tq, d]`` queries over ``[B, heads, T, d]``."""
    logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return torch.softmax(logits, dim=-1) @ v


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(width, width)
        self.k = nn.Linear(width, width)
        self.v = nn.Linear(width, width)
        self.out = nn.Linear(width, width)

    def _split(self, x):
        b, t, w = x.shape
        return x.reshape(b, t, self.heads, w // self.heads).transpose(1, 2)

    def forward(self, query, tokens):
        o = attention(self._split(self.q(query)), self._split(self.k(tokens)),
                      self._split(self.v(tokens)))
        b, h, t, d = o.shape
        return self.out(o.transpose(1, 2).reshape(b, t, h * d))


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
        self.attn = Attention(cfg.width, cfg.heads)
        self.ln2 = nn.LayerNorm(cfg.width, eps=LN_EPS)
        self.mlp = Mlp(cfg.width, cfg.mlp_dim)

    def forward(self, x):
        y = self.ln1(x)
        x = x + self.attn(y, y)
        return x + self.mlp(self.ln2(x))


class SiglipViT(nn.Module):
    """Input ``[B, S, S, 3]`` normalised RGB → ``[B, width]``."""

    def __init__(self, cfg: SiglipConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        n = cfg.image_size // cfg.patch
        self.patch_embed = nn.Conv2d(3, w, cfg.patch, cfg.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, n * n, w))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        self.ln_post = nn.LayerNorm(w, eps=LN_EPS)
        self.probe = nn.Parameter(torch.zeros(1, 1, w))
        self.map_attn = Attention(w, cfg.heads)
        self.map_ln = nn.LayerNorm(w, eps=LN_EPS)
        self.map_mlp = Mlp(w, cfg.mlp_dim)

    def forward(self, x):
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_post(x)
        h = self.map_attn(self.probe.expand(x.shape[0], -1, -1), x)
        h = h + self.map_mlp(self.map_ln(h))
        return h[:, 0]


def load_reference(model: SiglipViT, tree) -> SiglipViT:
    """A flax tree in big_vision's layout (``params/embedding``,
    ``pos_embedding``, ``Transformer/encoderblock_{i}``,
    ``Transformer/encoder_norm``, ``MAPHead_0``) into ``model``; every
    leaf used once, every tensor filled."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v, np.float32)

    walk(tree, "")
    sd = {}

    def take(path):
        return torch.from_numpy(np.array(flat.pop(f"params/{path}")))

    def norm(name, scope):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = (take(f"{scope}/scale"),
                                                    take(f"{scope}/bias"))

    def dense(name, scope):
        sd[f"{name}.weight"] = take(f"{scope}/kernel").T
        sd[f"{name}.bias"] = take(f"{scope}/bias")

    def attn(name, scope):
        for p in ("q", "k", "v"):
            part = {"q": "query", "k": "key", "v": "value"}[p]
            kernel = take(f"{scope}/{part}/kernel")          # [W, H, d]
            sd[f"{name}.{p}.weight"] = kernel.reshape(kernel.shape[0], -1).T
            sd[f"{name}.{p}.bias"] = take(f"{scope}/{part}/bias").reshape(-1)
        kernel = take(f"{scope}/out/kernel")                 # [H, d, W]
        sd[f"{name}.out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
        sd[f"{name}.out.bias"] = take(f"{scope}/out/bias")

    sd["patch_embed.weight"] = take("embedding/kernel").permute(3, 2, 0, 1)
    sd["patch_embed.bias"] = take("embedding/bias")
    sd["pos_embed"] = take("pos_embedding")
    for i in range(len(model.blocks)):
        scope = f"Transformer/encoderblock_{i}"
        norm(f"blocks.{i}.ln1", f"{scope}/LayerNorm_0")
        attn(f"blocks.{i}.attn", f"{scope}/MultiHeadDotProductAttention_0")
        norm(f"blocks.{i}.ln2", f"{scope}/LayerNorm_1")
        dense(f"blocks.{i}.mlp.fc1", f"{scope}/MlpBlock_0/Dense_0")
        dense(f"blocks.{i}.mlp.fc2", f"{scope}/MlpBlock_0/Dense_1")
    norm("ln_post", "Transformer/encoder_norm")
    sd["probe"] = take("MAPHead_0/probe")
    attn("map_attn", "MAPHead_0/MultiHeadDotProductAttention_0")
    norm("map_ln", "MAPHead_0/LayerNorm_0")
    dense("map_mlp.fc1", "MAPHead_0/MlpBlock_0/Dense_0")
    dense("map_mlp.fc2", "MAPHead_0/MlpBlock_0/Dense_1")
    if flat:
        raise KeyError(f"leaves the tower does not use: {sorted(flat)[:8]}")
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()},
                          strict=True)
    return model


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def normalize(img_bgr):
    """BGR → RGB, /255, mean = std = 0.5."""
    rgb = img_bgr.flip(-1).float() / 255.0
    mean = torch.tensor(MEAN, device=rgb.device)
    std = torch.tensor(STD, device=rgb.device)
    return (rgb - mean) / std


@torch.no_grad()
def encode_images(model: SiglipViT, chips_bgr, block: int = 32):
    """BGR chips ``[N, H, W, 3]`` → L2-normalised float32 ``[N, width]``:
    the shortest side resized to the tower's size (Keys cubic), centre
    crop, normalised, ``block`` chips at a time."""
    s = model.cfg.image_size
    outs = []
    with _no_tf32():
        for at in range(0, chips_bgr.shape[0], block):
            x = chips_bgr[at:at + block].float()
            h, w = int(x.shape[1]), int(x.shape[2])
            if (h, w) != (s, s):
                scale = s / min(h, w)
                nh, nw = max(s, int(h * scale)), max(s, int(w * scale))
                x = resize_bicubic(x, nh, nw)
                y0, x0 = int(round((nh - s) / 2.0)), int(round((nw - s) / 2.0))
                x = x[:, y0:y0 + s, x0:x0 + s]
            outs.append(model(normalize(x).contiguous()).float())
    emb = torch.cat(outs) if outs else torch.zeros(
        0, model.cfg.width, device=chips_bgr.device)
    return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                             min=1e-10)
