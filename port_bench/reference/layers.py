"""Shared building blocks for the model zoo (torch ``nn.Module``s, NCHW).

Counterparts of ``person_capture_tpu/models/layers.py``; parameters load
from the JAX package's checkpoints through :mod:`.bridge`.

BatchNorm momentum is torch's, ``1 −`` flax's: ``ConvBN`` 0.1 (flax 0.9),
the iResNet's BatchNorms 0.01 (flax's default 0.99). It is read only in
training, as is the running-statistics rule of :class:`BatchNorm2d`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
IRESNET_MOMENTUM = 0.01   # flax BatchNorm's default momentum 0.99


class _FlaxStats:
    """A BatchNorm whose training step keeps flax's running statistics:
    ``running ← (1 − m)·running + m·batch`` with the *biased* batch variance,
    where torch's own writes the unbiased one (a factor n/(n−1), 2 % for a
    batch of 48 in ArcFace's final BatchNorm1d). The batch is normalised
    exactly as torch does; only the variance written back differs."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        # copies: autograd keeps the statistics it was given for backward
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            # torch wrote keep + m·var·n/(n−1); flax keeps keep + m·var
            keep = self.running_var * (1.0 - self.momentum)
            self.running_mean.copy_(mean)
            self.running_var.copy_((var - keep) * ((n - 1) / n) + keep)
        return y


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


class ConvBN(nn.Module):
    """Conv (no bias) → BatchNorm → optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm2d(cout, eps=BN_EPS, momentum=0.1)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class PReLU(nn.Module):
    """Channelwise PReLU (ArcFace iResNet uses it throughout)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        alpha = self.alpha.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, alpha * x)


class DWConvBN(ConvBN):
    """Depthwise conv + BN + act."""

    def __init__(self, channels: int, kernel: int = 3, stride: int = 1,
                 act: bool = True):
        super().__init__(channels, channels, kernel, stride, groups=channels,
                         act=act)


class ResBasicBlock(nn.Module):
    """Post-activation ResNet basic block (used by the SCRFD backbone)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, stride)
        self.conv2 = ConvBN(cout, cout, 3, 1, act=False)
        self.down = (ConvBN(cin, cout, 1, stride, act=False)
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        identity = x if self.down is None else self.down(x)
        return F.relu(y + identity)


class IBasicBlock(nn.Module):
    """ArcFace iResNet block: BN → Conv3x3 → BN → PReLU → Conv3x3(s) → BN,
    residual with a 1x1-conv downsample when the shape changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        m = IRESNET_MOMENTUM
        self.bn1 = BatchNorm2d(cin, eps=BN_EPS, momentum=m)
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout, eps=BN_EPS, momentum=m)
        self.prelu = PReLU(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, stride, 1, bias=False)
        self.bn3 = BatchNorm2d(cout, eps=BN_EPS, momentum=m)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout, eps=BN_EPS, momentum=m))

    def forward(self, x):
        y = self.conv1(self.bn1(x))
        y = self.conv2(self.prelu(self.bn2(y)))
        y = self.bn3(y)
        identity = x if self.down is None else self.down(x)
        return y + identity


def upsample2x(x):
    """Nearest 2× upsample (FPN top-down path), NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def make_anchor_centers(feat_h: int, feat_w: int, stride: int,
                        num_anchors: int, device=None) -> torch.Tensor:
    """SCRFD-style anchor centers ``[h*w*A, 2]`` in input-image pixels
    (x, y = grid * stride; anchors share the center)."""
    ys = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
    xs = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    centers = torch.stack([grid_x.reshape(-1), grid_y.reshape(-1)], -1)
    return centers.repeat_interleave(num_anchors, dim=0)


def distance2bbox(centers, distances, stride: float):
    """Decode ltrb stride-unit distances to xyxy boxes."""
    d = distances * stride
    return torch.stack([centers[..., 0] - d[..., 0],
                        centers[..., 1] - d[..., 1],
                        centers[..., 0] + d[..., 2],
                        centers[..., 1] + d[..., 3]], -1)


def distance2kps(centers, offsets, stride: float):
    """Decode (dx, dy)*5 stride-unit offsets to landmark coordinates
    ``[..., 5, 2]``."""
    o = offsets * stride
    pts = o.reshape(*o.shape[:-1], 5, 2)
    return pts + centers[..., None, :]
