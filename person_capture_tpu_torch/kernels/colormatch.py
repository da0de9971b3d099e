"""YCbCr color-match repair (torch).

Counterpart of ``person_capture_tpu/kernels/colormatch.py``: transfer the
*color response* of a reference rendering (the accepted yuv420/full
"WIC/Paint look") onto a clean rendering (yuv444/limited texture) —
  * luma: 33-point quantile LUT from clean→reference distribution,
  * chroma: per-side gain around the neutral axis (Cb/Cr sign preserved),
  * shadow protection ramps that keep clean shadow texture/neutrality.

Plain torch ops (sorts, interpolation, elementwise) on the caller's device.
The quantiles are written as sort + linear interpolation in float32, the
estimator of ``jnp.quantile`` (``torch.quantile`` refuses inputs over 2²⁴
elements, which a 4K still plane comes close to).
"""

from __future__ import annotations

import numpy as np
import torch

from .color import YCBCR_BT601, rgb_to_ycbcr, ycbcr_to_bgr_u8
from .hdr import _resize2d, quantile_linear

# jnp.interp treats a LUT segment this narrow as a step
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _to_ycbcr(bgr):
    rgb = bgr.flip(-1).float() / 255.0
    ycc = rgb_to_ycbcr(rgb, YCBCR_BT601)
    return ycc[..., 0], ycc[..., 1], ycc[..., 2]


def _from_ycbcr(y, cb, cr):
    return ycbcr_to_bgr_u8(y, cb, cr, YCBCR_BT601)


def fit_quantile_lut(clean, ref, n_points: int = 33):
    """Fit a monotone LUT mapping the ``clean`` distribution onto ``ref``.

    Returns (xs, ys): LUT nodes at evenly spaced quantiles."""
    qs = torch.linspace(0.0, 1.0, n_points, device=clean.device)
    xs = quantile_linear(clean, qs)
    ys = quantile_linear(ref, qs)
    # enforce strict monotonicity of xs for interp stability
    ramp = torch.arange(n_points, dtype=torch.float32,
                        device=clean.device) * 1e-7
    xs = torch.cummax(xs + ramp, dim=0).values
    ys = torch.cummax(ys, dim=0).values
    return xs, ys


def apply_lut(x, xs, ys):
    """``jnp.interp(x, xs, ys)``: piecewise linear, clamped to the end
    values outside ``[xs[0], xs[-1]]``."""
    i = torch.clamp(torch.searchsorted(xs, x.contiguous(), right=True), 1,
                    xs.shape[0] - 1)
    x0, x1 = xs[i - 1], xs[i]
    y0, y1 = ys[i - 1], ys[i]
    dx = x1 - x0
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, y0,
                    y0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx))
                    * (y1 - y0))
    f = torch.where(x < xs[0], ys[0], f)
    return torch.where(x > xs[-1], ys[-1], f)


def _masked_percentile(vals, sel, q: float):
    """Linear-interpolated percentile of ``vals[sel]`` with fixed shapes:
    unselected values sort to +inf, the percentile interpolates inside the
    selected prefix. Returns (percentile, n_selected); not finite when
    nothing is selected."""
    n = sel.sum()
    v = torch.sort(torch.where(sel, vals, torch.full_like(vals,
                                                          float("inf")))).values
    last = vals.shape[0] - 1
    pos = q * torch.clamp(n - 1, min=0).float()
    lo = torch.clamp(torch.floor(pos).long(), 0, last)
    hi = torch.clamp(torch.minimum(lo + 1, torch.clamp(n - 1, min=0)), 0,
                     last)
    frac = pos - lo.float()
    return v[lo] * (1.0 - frac) + v[hi] * frac, n


def fit_chroma_side_gains(clean_c, ref_c, max_gain: float = 2.25,
                          min_gain: float = 0.40, min_side_px: int = 256):
    """Per-side chroma gains pinned at the neutral axis: each side's gain is
    the p75 ratio of deviations over pixels where EITHER rendering
    excursions past ~1 8-bit code unit. A side with too few such pixels (or
    a near-neutral clean p75) falls back to the all-pixel gain, then to 1.0.

    ``clean_c``/``ref_c`` must be the same shape."""
    unit = 1.0 / 255.0  # one 8-bit code unit in normalized chroma
    c = clean_c.reshape(-1)
    r = ref_c.reshape(-1)
    if c.shape[0] < 1024:  # reference bails without enough pixels
        one = torch.ones((), dtype=torch.float32, device=c.device)
        return one, one

    def side(sign: float):
        cd, rd = sign * c, sign * r
        sel = (cd > unit) | (rd > unit)
        cp, n_sel = _masked_percentile(cd, sel, 0.75)
        rp, _ = _masked_percentile(rd, sel, 0.75)
        valid = ((n_sel >= min_side_px) & torch.isfinite(cp)
                 & torch.isfinite(rp) & (cp >= unit))
        g = torch.clamp(rp / torch.clamp(cp, min=1e-6), min_gain, max_gain)
        return g, valid

    # all-pixel fallback gain (reference fallback_gain)
    cpa = quantile_linear(c.abs(), 0.75)
    rpa = quantile_linear(r.abs(), 0.75)
    fb = torch.where(cpa >= unit,
                     torch.clamp(rpa / torch.clamp(cpa, min=1e-6), min_gain,
                                 max_gain),
                     torch.ones_like(cpa))
    pos_g, pos_ok = side(1.0)
    neg_g, neg_ok = side(-1.0)
    return torch.where(pos_ok, pos_g, fb), torch.where(neg_ok, neg_g, fb)


def shadow_protect_weight(y, protect: float, knee: float = 0.18):
    """0..1 multiplier reducing match strength in dark regions: 1 above the
    knee, ramping to (1 - protect) at black."""
    ramp = torch.clamp(y / max(knee, 1e-5), 0.0, 1.0)
    return 1.0 - float(protect) * (1.0 - ramp)


def lowfreq_residual(out_c, ref_c, amount: float, weight, grid: int = 24):
    """Low-frequency chroma residual transfer: the coarse-grid difference
    ref−matched is added back. ``ref_c`` may be a reduced-resolution
    rendering — both sides are pooled onto a common coarse grid before
    differencing."""
    h, w = out_c.shape
    gh, gw = min(grid, h), min(grid, w)
    low_out = _resize2d(out_c, gh, gw)
    low_ref = _resize2d(ref_c, gh, gw)
    resid = _resize2d(low_ref - low_out, h, w)
    return out_c + float(amount) * weight * resid


def color_match_bgr(clean_bgr, ref_bgr, strength: float = 1.0,
                    luma_strength: float = 0.45,
                    chroma_strength: float = 0.85,
                    shadow_luma_protect: float = 0.85,
                    shadow_chroma_protect: float = 0.80,
                    n_points: int = 33, lowfreq: float = 0.0):
    """Match ``clean_bgr`` to ``ref_bgr``'s color response (uint8 BGR
    ``[H, W, 3]`` tensors on one device; returns uint8 BGR).

    ``ref_bgr`` may be a reduced-resolution rendering (statistics only);
    output is full resolution. ``lowfreq`` > 0 additionally transfers the
    coarse spatial chroma field.
    """
    y_c, cb_c, cr_c = _to_ycbcr(clean_bgr)
    y_r, cb_r, cr_r = _to_ycbcr(ref_bgr)

    s = float(strength)
    # --- luma: quantile LUT with shadow protection -----------------------
    xs, ys = fit_quantile_lut(y_c, y_r, n_points)
    y_mapped = apply_lut(y_c, xs, ys)
    w_y = s * float(luma_strength) * shadow_protect_weight(
        y_c, shadow_luma_protect)
    y_out = y_c + w_y * (y_mapped - y_c)

    # --- chroma: neutral-pinned side gains with shadow protection --------
    def _fit_view(c_clean, c_ref):
        # the side-gain fit pairs pixels, so a reduced-res statistics
        # reference needs the clean plane on its grid — NEAREST (half-pixel
        # centres), not linear: averaging would shrink the clean side's
        # deviation distribution and bias every gain upward
        if c_clean.shape != c_ref.shape:
            return _resize2d(c_clean, *c_ref.shape, method="nearest")
        return c_clean

    out_c = []
    for c_clean, c_ref in ((cb_c, cb_r), (cr_c, cr_r)):
        pos_g, neg_g = fit_chroma_side_gains(_fit_view(c_clean, c_ref),
                                             c_ref)
        mapped = torch.where(c_clean >= 0, c_clean * pos_g, c_clean * neg_g)
        w_c = s * float(chroma_strength) * shadow_protect_weight(
            y_c, shadow_chroma_protect)
        matched = c_clean + w_c * (mapped - c_clean)
        if lowfreq > 0.0:
            matched = lowfreq_residual(matched, c_ref, s * lowfreq, w_c)
        out_c.append(matched)

    return _from_ycbcr(y_out, out_c[0], out_c[1])
