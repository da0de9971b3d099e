"""Device-side image preprocessing: resize, letterbox, normalize (torch).

Counterparts of ``person_capture_tpu/ops/preprocess.py``. Images keep the
JAX package's channels-last layout (``[..., H, W, C]``) at these public
functions so callers and tests compare like with like.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(img, out_h: int, out_w: int):
    """Bilinear resize of ``[..., H, W, C]`` with half-pixel centres,
    antialiased when shrinking — ``jax.image.resize(..., "linear")``."""
    *lead, h, w, c = img.shape
    x = img.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    shrink = out_h < h or out_w < w
    out = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                        align_corners=False, antialias=shrink)
    return out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def _cubic_weights(m: int, n: int, device=None) -> torch.Tensor:
    """``[m, n]`` float32 weights resampling one axis of size ``m`` to ``n``
    as ``jax.image.scale_and_translate`` builds them for the Keys cubic
    kernel (a = -0.5; scale ``n/m``, no translation, antialiased):
    half-pixel centres, the kernel widened by ``m/n`` when shrinking, each
    output's weights normalised over the input samples, zero where the
    sample falls outside the input."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(n / m, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=f32)[:, None]).abs() \
        / kernel_scale
    weights = ((1.5 * x - 2.5) * x) * x + 1.0
    weights = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                          weights)
    weights = torch.where(x >= 2.0, torch.zeros_like(x), weights)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(torch.finfo(f32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


def resize_bicubic(img, out_h: int, out_w: int):
    """Bicubic resize of ``[..., H, W, C]`` — ``jax.image.resize(...,
    "cubic")``: Keys cubic (a = -0.5), half-pixel centres, antialiased when
    shrinking, an axis of unchanged size left as it is. (``F.interpolate``'s
    bicubic uses a = -0.75 and clamps at the borders: another function.)"""
    *lead, h, w, c = img.shape
    x = img.float()
    if out_h != h:
        x = torch.einsum("...hwc,hH->...Hwc", x,
                         _cubic_weights(h, out_h, x.device))
    if out_w != w:
        x = torch.einsum("...hwc,wW->...hWc", x,
                         _cubic_weights(w, out_w, x.device))
    return x


def letterbox_size(h: int, w: int, size: int):
    """``(new_h, new_w, det_scale)`` of the top-left letterbox."""
    im_ratio = h / w
    if im_ratio > 1.0:
        new_h = size
        new_w = int(round(size / im_ratio))
    else:
        new_w = size
        new_h = int(round(size * im_ratio))
    return new_h, new_w, new_h / h


def letterbox_topleft(img, size: int):
    """SCRFD-style letterbox: scale to fit in ``size×size`` preserving aspect,
    place at top-left, zero-fill the rest.

    Args: img ``[H, W, C]`` or a batch ``[B, H, W, C]`` of one shape.
    Returns (padded ``[..., size, size, C]`` float32, det_scale float —
    multiply detector output coords by ``1/det_scale`` to map back)."""
    h, w = img.shape[-3], img.shape[-2]
    new_h, new_w, det_scale = letterbox_size(h, w, size)
    if (new_h, new_w) == (h, w):
        resized = img.float()
    else:
        resized = resize_bilinear(img, new_h, new_w)
    if (new_h, new_w) == (size, size):
        return resized, det_scale
    out = resized.new_zeros((*img.shape[:-3], size, size, img.shape[-1]))
    out[..., :new_h, :new_w, :] = resized
    return out, det_scale


def normalize_scrfd(img_bgr):
    """SCRFD input normalization: (x - 127.5) / 128, BGR→RGB."""
    return (img_bgr.flip(-1).float() - 127.5) / 128.0


def normalize_arcface(chip_bgr):
    """ArcFace input normalization: BGR→RGB then x/127.5 - 1."""
    return chip_bgr.flip(-1).float() / 127.5 - 1.0


def normalize_yolo(img_bgr):
    """Ultralytics YOLO ingress: BGR→RGB, x/255."""
    return img_bgr.flip(-1).float() / 255.0


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_clip(img_bgr):
    """OpenCLIP normalization (BGR input → RGB, /255, CLIP mean/std)."""
    rgb = img_bgr.flip(-1).float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=rgb.device)
    std = torch.tensor(CLIP_STD, device=rgb.device)
    return (rgb - mean) / std
