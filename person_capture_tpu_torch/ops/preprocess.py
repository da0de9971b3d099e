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
