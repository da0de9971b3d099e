"""5-point face alignment: similarity solve and chip warp (torch, batched).

Counterpart of ``person_capture_tpu/ops/align.py``. The TPU computes the
chip warp (``align_chips_matmul_jnp``) as matmuls with bilinear "hat"
weights only because TPU gathers serialise; on a GPU a gather is the
natural form. :func:`align_chips` resamples through the same chain of
bilinear steps — an axis-aligned window around the inverse-mapped chip quad,
then the Catmull–Smith two-pass similarity warp — with every step a direct
inverse-mapped gather at clamped (replicate-border) positions, so it agrees
with the TPU form to float rounding; invalid slots give zero chips.
"""

from __future__ import annotations

import numpy as np
import torch

# ArcFace 112×112 landmark template (LFW standard, public constant)
ARC_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)

ARC_SIZE = 112


def umeyama_similarity(src, dst):
    """Batched least-squares similarity (uniform scale + rotation +
    translation) mapping ``src [..., P, 2]`` → ``dst [P, 2]`` (or
    ``[..., P, 2]``). Returns ``[..., 2, 3]`` float32, closed-form
    Umeyama (1991)."""
    src = src.float()
    dst = torch.as_tensor(dst, dtype=torch.float32,
                          device=src.device).expand_as(src)
    p = src.shape[-2]
    mu_s = src.mean(-2, keepdim=True)
    mu_d = dst.mean(-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    cov = torch.einsum("...pi,...pj->...ij", dc, sc) / p
    u, s, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    sign = torch.stack([torch.ones_like(det), torch.sign(det)], dim=-1)
    r = torch.einsum("...ij,...j,...jk->...ik", u, sign, vt)
    var_s = (sc ** 2).sum((-1, -2)) / p
    scale = (s * sign).sum(-1) / torch.clamp(var_s, min=1e-12)
    a = scale[..., None, None] * r
    t = mu_d[..., 0, :] - torch.einsum("...ij,...j->...i", a, mu_s[..., 0, :])
    return torch.cat([a, t[..., None]], dim=-1)


def invert_affine(m):
    """Invert a 2×3 affine (batched): returns M' with M'([M x + t]) = x."""
    a = m[..., :2, :2]
    t = m[..., :2, 2]
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv = torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], -1),
    ], -2) / det[..., None, None]
    ti = -torch.einsum("...ij,...j->...i", inv, t)
    return torch.cat([inv, ti[..., None]], dim=-1)


def _taps(pos, n: int):
    """Bilinear taps at ``pos`` clamped to ``[0, n-1]`` (replicate border):
    (lower index, upper index, upper weight). Non-finite positions (a
    degenerate transform on an empty slot) read pixel 0 instead of indexing
    out of bounds."""
    p = torch.clamp(torch.nan_to_num(pos, nan=0.0), 0.0, n - 1.0)
    i0 = torch.floor(p)
    frac = p - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), frac


def _resample(src, dim: int, pos):
    """1-D bilinear resample of ``src`` along ``dim`` at ``pos`` (the shape
    of ``src`` with ``dim`` replaced by the sample count, minus channels)."""
    i0, i1, frac = _taps(pos, src.shape[dim])
    shape = (*pos.shape, src.shape[-1])
    g0 = torch.gather(src, dim, i0[..., None].expand(shape))
    g1 = torch.gather(src, dim, i1[..., None].expand(shape))
    f = frac[..., None]
    return g0 * (1 - f) + g1 * f


def align_chips(frames, kps, valid, out_size: int = ARC_SIZE,
                window: int = 128):
    """ArcFace chips for every face slot of a frame batch.

    Args:
      frames: ``[B, H, W, C]`` float32 (BGR or RGB — passthrough).
      kps:    ``[B, F, 5, 2]`` landmarks in frame coordinates.
      valid:  ``[B, F]`` bool.
    Returns ``[B, F, out_size, out_size, C]`` float32 (zeros where invalid).
    """
    frames = frames.float()
    b, h, w, c = frames.shape
    f = kps.shape[1]
    dev = frames.device
    n = b * f
    dst = torch.as_tensor(ARC_DST * (out_size / float(ARC_SIZE)), device=dev)
    minv = invert_affine(umeyama_similarity(kps.reshape(n, 5, 2), dst))

    corners = torch.tensor([[0.0, 0.0], [out_size - 1.0, 0.0],
                            [0.0, out_size - 1.0],
                            [out_size - 1.0, out_size - 1.0]], device=dev)
    src_corners = torch.einsum("fij,cj->fci", minv[:, :, :2], corners) \
        + minv[:, None, :, 2]
    lo = src_corners.amin(1)
    hi = src_corners.amax(1)
    center = 0.5 * (lo + hi)
    half = torch.clamp(0.5 * (hi - lo).amax(1) * 1.02 + 2.0, min=4.0)

    # axis-aligned window around the chip quad: separable bilinear taps,
    # gathered straight from the frame
    s = 2.0 * half / window                                    # [N]
    idx = torch.arange(window, dtype=torch.float32, device=dev) + 0.5
    py = center[:, 1:2] - half[:, None] + idx[None] * s[:, None] - 0.5
    px = center[:, 0:1] - half[:, None] + idx[None] * s[:, None] - 0.5
    y0, y1, fy = _taps(py, h)                                  # [N, Wr]
    x0, x1, fx = _taps(px, w)                                  # [N, Wc]
    base = (torch.arange(n, device=dev) // f) * (h * w)
    flat = frames.reshape(b * h * w, c)

    def tap(yy, xx):
        return flat[base[:, None, None] + yy[:, :, None] * w + xx[:, None, :]]

    fy3 = fy[:, :, None, None]
    fx3 = fx[:, None, :, None]
    rows0 = tap(y0, x0) * (1 - fy3) + tap(y1, x0) * fy3
    rows1 = tap(y0, x1) * (1 - fy3) + tap(y1, x1) * fy3
    win = rows0 * (1 - fx3) + rows1 * fx3                      # [N, U, V, C]

    # chip -> window affine: win = (src - off) / s
    offx = center[:, 0] - half + 0.5 * s - 0.5
    offy = center[:, 1] - half + 0.5 * s - 0.5
    inv_s = 1.0 / s
    m00 = minv[:, 0, 0] * inv_s
    m01 = minv[:, 0, 1] * inv_s
    m02 = (minv[:, 0, 2] - offx) * inv_s
    m10 = minv[:, 1, 0] * inv_s
    m11 = minv[:, 1, 1] * inv_s
    m12 = (minv[:, 1, 2] - offy) * inv_s

    # two-pass affine (Catmull–Smith): guard m11 away from 0
    m11 = torch.where(m11.abs() < 1e-3, torch.full_like(m11, 1e-3), m11)
    alpha = m00 - m01 * m10 / m11
    beta = m01 / m11
    gamma = m02 - m01 * m12 / m11

    xs = torch.arange(out_size, dtype=torch.float32, device=dev)
    us = torch.arange(window, dtype=torch.float32, device=dev)
    # pass 1: tmp[n,u,x] = win[n,u,v] at v = αx + βu + γ
    vx = (alpha[:, None, None] * xs[None, None, :]
          + beta[:, None, None] * us[None, :, None] + gamma[:, None, None])
    tmp = _resample(win, 2, vx)                                # [N, U, X, C]
    # pass 2: chip[n,y,x] = tmp[n,u,x] at u = m10·x + m11·y + m12
    uy = (m10[:, None, None] * xs[None, None, :]
          + m11[:, None, None] * xs[None, :, None] + m12[:, None, None])
    chip = _resample(tmp, 1, uy)                               # [N, Y, X, C]
    chip = chip.reshape(b, f, out_size, out_size, c)
    return torch.where(valid[:, :, None, None, None], chip,
                       torch.zeros((), device=dev))
