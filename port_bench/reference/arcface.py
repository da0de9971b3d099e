"""ArcFace identity embedder (iResNet) in torch.

Counterpart of ``person_capture_tpu/models/arcface.py``: 112×112 BGR chip →
RGB, x/127.5-1 → iResNet → embedding, with optional flip-TTA (embed(x) +
embed(mirror(x)), then L2-normalize). Parameters load from the JAX
package's checkpoints through :mod:`.bridge`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn

from .layers import (BN_EPS, IRESNET_MOMENTUM, BatchNorm1d, BatchNorm2d,
                     IBasicBlock, PReLU)
from .preprocess import normalize_arcface


@dataclass(frozen=True)
class ArcFaceConfig:
    name: str = "w600k_r50"
    stage_channels: Tuple[int, ...] = (64, 128, 256, 512)
    stage_blocks: Tuple[int, ...] = (3, 4, 14, 3)     # iresnet50
    embed_dim: int = 512
    input_size: int = 112


TINY = ArcFaceConfig(name="arcface_tiny", stage_channels=(8, 16, 24, 32),
                     stage_blocks=(1, 1, 1, 1), embed_dim=64, input_size=112)

# compact embedder for the in-repo synthetic-identity weights
SYNTH_R18 = ArcFaceConfig(name="arcface_synth",
                          stage_channels=(24, 48, 96, 192),
                          stage_blocks=(2, 2, 2, 2), embed_dim=256)

W600K_R50 = ArcFaceConfig(name="w600k_r50")

GLINTR100 = ArcFaceConfig(name="glintr100", stage_blocks=(3, 13, 30, 3))

CONFIGS = {c.name: c for c in (TINY, SYNTH_R18, W600K_R50, GLINTR100)}


class IResNet(nn.Module):
    def __init__(self, cfg: ArcFaceConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.stage_channels
        self.conv1 = nn.Conv2d(3, chans[0], 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(chans[0], eps=BN_EPS,
                               momentum=IRESNET_MOMENTUM)
        self.prelu = PReLU(chans[0])
        blocks = []
        cin = chans[0]
        for ch, nblocks in zip(chans, cfg.stage_blocks):
            for bi in range(nblocks):
                blocks.append(IBasicBlock(cin, ch, 2 if bi == 0 else 1))
                cin = ch
        self.blocks = nn.Sequential(*blocks)
        self.bn2 = BatchNorm2d(chans[-1], eps=BN_EPS,
                               momentum=IRESNET_MOMENTUM)
        s = cfg.input_size // 16
        self.fc = nn.Linear(chans[-1] * s * s, cfg.embed_dim)
        self.features = BatchNorm1d(cfg.embed_dim, eps=BN_EPS,
                                    momentum=IRESNET_MOMENTUM)

    def forward(self, x):
        """x: normalized ``[N, 3, S, S]`` RGB → ``[N, D]``."""
        x = self.prelu(self.bn1(self.conv1(x)))
        x = self.bn2(self.blocks(x))
        # the flax model flattens channels-last before its Dense
        x = x.permute(0, 2, 3, 1).flatten(1)
        return self.features(self.fc(x))


@torch.no_grad()
def encode_chips(model: IResNet, chips_bgr, flip_tta: bool = True):
    """Embed ``[N, 112, 112, 3]`` BGR chips → L2-normalized ``[N, D]``
    float32; flip_tta sums the embedding of the chip and its mirror before
    normalization."""
    dtype = next(model.parameters()).dtype
    x = normalize_arcface(chips_bgr).permute(0, 3, 1, 2).to(dtype)
    if flip_tta:
        x = torch.cat([x, x.flip(-1)], dim=0)
    emb = model(x).float()
    if flip_tta:
        n = emb.shape[0] // 2
        emb = emb[:n] + emb[n:]
    norm = torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                       min=1e-10)
    return emb / norm
