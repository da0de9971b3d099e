"""Speckle / artifact cleanup (torch).

Counterpart of ``person_capture_tpu/kernels/cleanup.py``: HDR still renders
can contain isolated saturated blue/red/magenta pixels in dark regions;
detect the impossible outliers (high chroma + dark + isolated) and replace
them with a neighborhood median; pull deep-shadow chroma blobs toward their
low-frequency field; pull dark pixels that disagree with a guide render
toward it. Plain elementwise, shift and resize ops on the caller's device.
"""

from __future__ import annotations

import torch

from .color import YCBCR_BT601, rgb_to_ycbcr, ycbcr_to_bgr_u8
from .hdr import _resize2d
from ..ops.preprocess import resize_bilinear


def _shift2d(x, dy: int, dx: int):
    """Edge-replicated shift of [..., H, W]."""
    if dy > 0:
        x = torch.cat([x[..., :1, :].expand(*x.shape[:-2], dy, x.shape[-1]),
                       x[..., :-dy, :]], -2)
    elif dy < 0:
        x = torch.cat([x[..., -dy:, :],
                       x[..., -1:, :].expand(*x.shape[:-2], -dy, x.shape[-1])],
                      -2)
    if dx > 0:
        x = torch.cat([x[..., :, :1].expand(*x.shape[:-1], dx),
                       x[..., :, :-dx]], -1)
    elif dx < 0:
        x = torch.cat([x[..., :, -dx:],
                       x[..., :, -1:].expand(*x.shape[:-1], -dx)], -1)
    return x


def neighborhood_median3(x):
    """3×3 median of [..., H, W]: element 4 of the 9 sorted shifted planes
    (edges replicated)."""
    planes = torch.stack([_shift2d(x, dy, dx)
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=0)
    return torch.sort(planes, dim=0).values[4]


def _bgr_ycbcr(bgr):
    return rgb_to_ycbcr(bgr.flip(-1).float() / 255.0, YCBCR_BT601)


def detect_speckles(bgr, dark_y: float = 0.22, chroma_thresh: float = 0.18,
                    isolation_delta: float = 0.10):
    """Boolean mask of saturated-speckle pixels: strong chroma far above the
    local chroma median (isolated), inside a dark *neighborhood* (the
    speckle pixel itself is bright; its surroundings are what's dark)."""
    ycc = _bgr_ycbcr(bgr)
    local_y = neighborhood_median3(ycc[..., 0])
    chroma = torch.sqrt(ycc[..., 1] ** 2 + ycc[..., 2] ** 2)
    local = neighborhood_median3(chroma)
    return (local_y < dark_y) & (chroma > chroma_thresh) \
        & (chroma - local > isolation_delta)


def despeckle_bgr(bgr, dark_y: float = 0.22, chroma_thresh: float = 0.18,
                  isolation_delta: float = 0.10):
    """Replace detected speckles with the per-channel 3×3 median. Returns
    (uint8 BGR, mask)."""
    mask = detect_speckles(bgr, dark_y, chroma_thresh, isolation_delta)
    x = bgr.float()
    med = neighborhood_median3(x.permute(2, 0, 1)).permute(1, 2, 0)
    out = torch.where(mask[..., None], med, x)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8), mask


def shadow_deblob_bgr(bgr, strength: float = 0.5, dark_y: float = 0.16,
                      grid_div: int = 8):
    """Suppress chroma blobs in deep shadows: chroma in sub-``dark_y`` luma
    is pulled toward its low-frequency field by up to ``strength``; luma
    and lit regions are untouched."""
    ycc = _bgr_ycbcr(bgr)
    y = ycc[..., 0]
    h, w = y.shape
    gh, gw = max(1, h // grid_div), max(1, w // grid_div)
    darkness = torch.clamp(1.0 - y / max(float(dark_y), 1e-5), 0.0, 1.0)
    pull = float(strength) * darkness
    out_c = [y]
    for c in (ycc[..., 1], ycc[..., 2]):
        low = _resize2d(_resize2d(c, gh, gw), h, w)
        out_c.append(c + pull * (low - c))
    return ycbcr_to_bgr_u8(out_c[0], out_c[1], out_c[2], YCBCR_BT601)


def guide_cleanup_bgr(bgr, guide_bgr, strength: float = 1.0,
                      dark_y: float = 0.20, delta: float = 0.12):
    """Guide-masked artifact cleanup: pixels that disagree strongly with the
    guide render in dark regions are artifacts of the primary chain (the
    guide was rendered through an independent chain) — pull them toward
    the guide. ``guide_bgr`` may be reduced resolution; it is upsampled."""
    x = bgr.float()
    g = guide_bgr.float()
    if g.shape != x.shape:
        g = resize_bilinear(g, x.shape[0], x.shape[1])
    y = rgb_to_ycbcr(x.flip(-1) / 255.0, YCBCR_BT601)[..., 0]
    diff = (x - g).abs().amax(dim=-1) / 255.0
    dark = torch.clamp(1.0 - y / max(float(dark_y), 1e-5), 0.0, 1.0)
    bad = torch.clamp((diff - float(delta)) / max(float(delta), 1e-5), 0.0,
                      1.0)
    wgt = (float(strength) * dark * bad)[..., None]
    out = x + wgt * (g - x)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
