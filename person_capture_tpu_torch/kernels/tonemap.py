"""Tone-mapping curves (HDR→SDR luminance compression), torch.

Same curves as ``person_capture_tpu/kernels/tonemap.py``. All curves act on
linear luminance normalized so 1.0 == SDR peak; input may exceed 1.0 up to
``peak`` (source peak / SDR peak ratio). ``peak`` is a Python float or a
float32 scalar tensor (the peak-detect path measures it on the device).
"""

from __future__ import annotations

import torch

from .color import _f32, pq_eotf, pq_inv_eotf


def tm_clip(x, peak):
    return torch.clamp(x, 0.0, 1.0)


# Each curve's per-call constants come from one helper, so the CUDA
# kernel's wrapper (kernels/hdr.curve_constants) can be held to exactly what
# the curves compute.

def reinhard_gain(peak, contrast: float = 0.5):
    offset = (1.0 - contrast) / contrast
    return (peak + offset) / peak


def tm_reinhard(x, peak, contrast: float = 0.5):
    offset = (1.0 - contrast) / contrast
    gain = reinhard_gain(peak, contrast)
    return torch.clamp(x * gain / (x + offset), 0.0, 1.0)


def mobius_coeffs(peak, param: float = 0.3, like=None):
    """Knee ``j`` and the coefficients ``a``, ``b``, ``scale`` of the Möbius
    roll-off ``scale * (x + a) / (x + b)``, float32."""
    j = _f32(param, like)
    peak = torch.clamp(_f32(peak, like), min=1.0 + 1e-6)
    a = -j * j * (peak - 1.0) / torch.clamp(j * j - 2.0 * j + peak, min=1e-6)
    b = (j * j - 2.0 * j * peak + peak) / torch.clamp(peak - 1.0, min=1e-6)
    return j, a, b, (b * b + 2.0 * b * j + j * j) / (b - a)


def tm_mobius(x, peak, param: float = 0.3):
    """Mobius: linear below the knee ``param``, hyperbolic roll-off above —
    matches libplacebo's formulation."""
    j, a, b, scale = mobius_coeffs(peak, param, x)
    mapped = scale * (x + a) / (x + b)
    return torch.clamp(torch.where(x <= j, x, mapped), 0.0, 1.0)


def _hable_partial(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def hable_norm(peak, like=None):
    """The Hable curve's value at the source peak, which normalizes it."""
    return _hable_partial(_f32(peak, like))


def tm_hable(x, peak):
    """Hable/Uncharted-2 filmic curve normalized to the source peak."""
    norm = hable_norm(peak, x)
    return torch.clamp(_hable_partial(x) / torch.clamp(norm, min=1e-6),
                       0.0, 1.0)


def bt2390_knee(peak, sdr_nits: float = 100.0, like=None):
    """BT.2390's clamped peak, source peak in PQ (``src_max_pq``), target
    peak relative to it (``max_lum``) and knee start ``ks``, float32."""
    peak = torch.clamp(_f32(peak, like), min=1.0 + 1e-6)
    src_max_pq = pq_inv_eotf(peak * sdr_nits / 10000.0)
    max_lum = pq_inv_eotf(_f32(sdr_nits, like) / 10000.0) / src_max_pq
    return peak, src_max_pq, max_lum, 1.5 * max_lum - 0.5


def tm_bt2390(x, peak, sdr_nits: float = 100.0):
    """BT.2390 EETF: hermite-spline knee in normalized-PQ space (ITU-R
    BT.2390-3 §5.4). ``x`` is linear in SDR-peak units; the source peak is
    ``peak`` (ratio), target display max is 1.0 (== sdr_nits)."""
    peak, src_max_pq, max_lum, ks = bt2390_knee(peak, sdr_nits, x)
    e1 = pq_inv_eotf(torch.minimum(torch.clamp(x, min=0.0), peak)
                     * sdr_nits / 10000.0) / src_max_pq

    t = (e1 - ks) / torch.clamp(1.0 - ks, min=1e-6)
    t = torch.clamp(t, 0.0, 1.0)
    t2 = t * t
    t3 = t2 * t
    p = ((2 * t3 - 3 * t2 + 1) * ks
         + (t3 - 2 * t2 + t) * (1.0 - ks)
         + (-2 * t3 + 3 * t2) * max_lum)
    e2 = torch.where(e1 < ks, e1, p)
    out_nits = pq_eotf(e2 * src_max_pq) * 10000.0
    return torch.clamp(out_nits / sdr_nits, 0.0, 1.0)


TONEMAPPERS = {
    "clip": tm_clip,
    "reinhard": tm_reinhard,
    "mobius": tm_mobius,
    "hable": tm_hable,
    "bt.2390": tm_bt2390,
    "bt2390": tm_bt2390,
    "auto": tm_bt2390,
    "spline": tm_bt2390,        # mapped: libplacebo spline ≈ bt2390 shape
    "st2094-40": tm_bt2390,     # mapped until dynamic metadata lands
}


def apply_tonemap(rgb_lin, peak, algo: str = "bt.2390",
                  desat: float = 0.25, param: float | None = None,
                  sdr_nits: float = 100.0):
    """Tone-map linear RGB ``[..., 3]`` (1.0 == SDR peak) with luma-driven
    desaturation: maps max(R,G,B) through the curve and scales the pixel,
    preserving hue; ``desat`` blends toward per-channel mapping in
    highlights. ``sdr_nits`` anchors the BT.2390 knee."""
    fn = TONEMAPPERS.get(algo, tm_bt2390)
    kwargs = {}
    if param is not None and fn is tm_mobius:
        kwargs["param"] = param
    if fn is tm_bt2390:
        kwargs["sdr_nits"] = sdr_nits
    lum = torch.clamp(rgb_lin.amax(dim=-1, keepdim=True), min=1e-6)
    mapped_lum = fn(lum, peak, **kwargs)
    scaled = rgb_lin * (mapped_lum / lum)
    if desat and desat > 0.0:
        per_channel = fn(rgb_lin, peak, **kwargs)
        overshoot = torch.clamp(
            (lum - 1.0) / torch.clamp(_f32(peak, lum) - 1.0, min=1e-6),
            0.0, 1.0)
        w = desat * overshoot
        scaled = scaled * (1.0 - w) + per_channel * w
    return torch.clamp(scaled, 0.0, 1.0)
