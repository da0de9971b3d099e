"""Full-resolution HDR→SDR still export.

Torch port of ``person_capture_tpu/hdr/stills.py``: the crop is legalized
for 4:2:0 (`even_hdr_crop_xyxy` semantics), tone-mapped on the configured
device (kernels/hdr.py; the plain PQ chain through the hand-written CUDA
kernel), optionally colour-matched to the WIC-look response of a
statistics-reference render (kernels/colormatch.py) and cleaned up
(kernels/cleanup.py), then written atomically as PNG/JPG. Validation
oracles re-implement the reference's decode-and-inspect checks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def scale_crop_xyxy_to_source(crop_xyxy, frame_size, source_size):
    """Map processed-frame crop coords to source pixels (round + clamp)."""
    fw, fh = max(1, int(frame_size[0])), max(1, int(frame_size[1]))
    sw, sh = max(1, int(source_size[0])), max(1, int(source_size[1]))
    sx, sy = sw / fw, sh / fh
    x1, y1, x2, y2 = crop_xyxy
    ox1 = max(0, min(sw - 1, int(round(x1 * sx))))
    oy1 = max(0, min(sh - 1, int(round(y1 * sy))))
    ox2 = max(ox1 + 1, min(sw, int(round(x2 * sx))))
    oy2 = max(oy1 + 1, min(sh, int(round(y2 * sy))))
    return ox1, oy1, ox2, oy2


def even_hdr_crop_xyxy(crop_xyxy, source_size):
    """Legalize a crop for 4:2:0: even origin, even extent, in bounds,
    ≥2px each axis, staying as close as possible to the chosen box."""
    def legalize(a1: int, a2: int, limit: int) -> Tuple[int, int]:
        a1 = max(0, min(limit - 2, a1 & ~1))
        a2 = max(a1 + 2, min(limit, a2))
        if (a2 - a1) & 1:
            if a2 < limit:
                a2 += 1
            elif a2 > a1 + 2:
                a2 -= 1
            elif a1 >= 2:
                a1 -= 2
            else:
                a2 = min(limit, a1 + 2)
        if a1 & 1:
            if a1 + 1 <= limit - 2:
                a1 += 1
                a2 = max(a1 + 2, min(limit, a2 + 1))
            else:
                a1 -= 1
        a1 = max(0, min(limit - 2, a1 & ~1))
        a2 = max(a1 + 2, min(limit, a2))
        if (a2 - a1) & 1:
            a2 = max(a1 + 2, min(limit, a2 - 1))
        return a1, a2

    sw, sh = max(2, int(source_size[0])), max(2, int(source_size[1]))
    x1, y1, x2, y2 = (int(v) for v in crop_xyxy)
    x1, x2 = legalize(x1, x2, sw)
    y1, y2 = legalize(y1, y2, sh)
    return x1, y1, x2, y2


@dataclass
class HdrExportParams:
    transfer: str = "pq"            # pq | hlg
    full_range: bool = False
    src_peak_nits: float = 1000.0
    sdr_nits: float = 100.0
    tonemap: str = "bt.2390"        # auto|bt.2390|spline|st2094-40|mobius|hable
    desat: float = 0.25
    tm_param: Optional[float] = None
    dither: bool = True
    peak_detect: bool = True
    color_match: bool = True
    color_match_strength: float = 1.0
    color_match_luma: float = 0.45
    color_match_chroma: float = 0.85
    shadow_luma_protect: float = 0.85
    shadow_chroma_protect: float = 0.80
    speckle_cleanup: bool = True
    clean_range: str = "limited"    # hdr_wic_yuv444_color_match_clean_range
    ref_max_side: int = 960         # reduced-res statistics reference
    lowfreq: float = 0.0            # coarse chroma-field residual transfer
    shadow_deblob: float = 0.0      # wic_shadow_deblob_strength
    contrast_recovery: float = 0.0  # hdr_sdr_contrast_recovery
    gamut: str = "clip"             # hdr_sdr_gamut_mapping
    guide_cleanup: bool = False     # hdr_wic_yuv444_guide_cleanup
    # pad crops to multiples of this before the render and trim after, as
    # the JAX package does (its reason: one compiled program for varying
    # crop sizes). Edge-replicated padding only duplicates pixel values,
    # but they enter the statistics (peak detect, LUT fit), so the port pads
    # alike to render the same stills. 0 disables.
    shape_bucket: int = 64
    device: str = "cuda"            # SessionConfig.device

    @staticmethod
    def from_cfg(cfg, transfer: str = "",
                 full_range: Optional[bool] = None) -> "HdrExportParams":
        """``transfer``/``full_range`` come from the SOURCE probe (engine:
        detect_hdr().transfer, color_range_full) — an HLG video tone-mapped
        through the PQ EOTF renders with grossly wrong luminance, so the
        probed transfer must override the 'pq' default."""
        p = HdrExportParams(
            sdr_nits=cfg.sdr_nits,
            tonemap=cfg.hdr_sdr_tonemap,
            desat=cfg.tm_desat,
            tm_param=cfg.tm_param,
            peak_detect=cfg.hdr_sdr_peak_detect,
            color_match=cfg.hdr_wic_yuv444_color_match,
            color_match_strength=cfg.hdr_wic_yuv444_color_match_strength,
            color_match_luma=cfg.hdr_wic_yuv444_color_match_luma_strength,
            color_match_chroma=cfg.hdr_wic_yuv444_color_match_chroma_strength,
            shadow_luma_protect=cfg.hdr_wic_yuv444_color_match_shadow_luma_protect,
            shadow_chroma_protect=cfg.hdr_wic_yuv444_color_match_shadow_chroma_protect,
            speckle_cleanup=cfg.hdr_wic_speckle_cleanup,
            clean_range=cfg.hdr_wic_yuv444_color_match_clean_range,
            ref_max_side=cfg.hdr_wic_yuv444_color_match_ref_max_side,
            lowfreq=cfg.hdr_wic_yuv444_color_match_lowfreq,
            shadow_deblob=cfg.wic_shadow_deblob_strength,
            contrast_recovery=cfg.hdr_sdr_contrast_recovery,
            gamut=cfg.hdr_sdr_gamut_mapping,
            guide_cleanup=cfg.hdr_wic_yuv444_guide_cleanup,
            device=cfg.device,
        )
        tr = (transfer or "").lower()
        if tr in ("hlg", "arib-std-b67"):
            p.transfer = "hlg"
        elif tr in ("pq", "smpte2084", "smpte st 2084"):
            p.transfer = "pq"
        if full_range is not None:
            p.full_range = bool(full_range)
        # conversion backend selection (reference: windows_wic = WIC-look
        # with color-match repair; ffmpeg = plain libplacebo/zscale render)
        if (cfg.hdr_sdr_conversion or "").lower() == "ffmpeg":
            p.color_match = False
        # quality preset ladder. DIVERGENCE from the reference (documented):
        # the reference maps these names to libplacebo parameter sets
        # (peak-detect/contrast-recovery/LUT/dither, gui_app.py:12598+);
        # this chain has no libplacebo, so the presets instead scale the
        # device chain's expensive stages — "balanced" keeps the WIC-look
        # color match but fits it against a half-resolution statistics
        # reference (quality barely differs, render cost drops), "fast"
        # drops the repair/dither stages entirely.
        quality = (cfg.hdr_sdr_quality or "madvr_like").lower()
        if quality == "fast":
            p.color_match = False
            p.speckle_cleanup = False
            p.peak_detect = False
            p.dither = False
        elif quality == "balanced":
            p.ref_max_side = max(256, int(p.ref_max_side) // 2 or 480)
        # madvr_like / resolve_like keep the full chain
        return p


def _ref_subsample_step(shape_hw, ref_max_side: int) -> int:
    """Stride k so the statistics reference renders at ≤ ref_max_side (the
    reference's reduced-reference fast path)."""
    if ref_max_side <= 0:
        return 1
    side = max(shape_hw[0], shape_hw[1])
    k = -(-side // int(ref_max_side))
    return max(1, int(k))


def _tonemap(y, uv, params: HdrExportParams) -> torch.Tensor:
    """The clean tone-map of P010 crop tensors → uint8 BGR.

    The plain PQ configuration (no contrast-recovery/gamut-map — e.g. the
    "fast" quality preset) goes through the fused tone-map (the
    hand-written CUDA kernel on a GPU). With peak-detect on, the measured
    scene peak replaces the fixed source peak first: the rest of
    ``p010_to_sdr_bgr``'s peak-detect chain is then the plain one, so it
    takes the kernel too (the JAX package sends it through its jnp chain,
    with the same result). Richer configurations take the general torch
    chain."""
    from ..kernels.hdr import (detect_peak_nits, hdr_to_sdr_bgr,
                               p010_rgb_prime, p010_to_sdr_bgr)

    clean_full = params.full_range or params.clean_range == "full"
    plain = (params.transfer == "pq" and params.gamut == "clip"
             and float(params.contrast_recovery) == 0.0)
    if plain:
        peak_nits = params.src_peak_nits
        if params.peak_detect:
            peak_nits = float(detect_peak_nits(
                p010_rgb_prime(y, uv, clean_full)))
        return hdr_to_sdr_bgr(
            y, uv, full_range=clean_full, transfer=params.transfer,
            src_peak_nits=peak_nits, sdr_nits=params.sdr_nits,
            algo=params.tonemap, desat=params.desat, param=params.tm_param,
            dither=params.dither)
    return p010_to_sdr_bgr(
        y, uv, full_range=clean_full, transfer=params.transfer,
        src_peak_nits=params.src_peak_nits, sdr_nits=params.sdr_nits,
        algo=params.tonemap, desat=params.desat, param=params.tm_param,
        dither=params.dither, peak_detect=params.peak_detect,
        contrast_recovery=params.contrast_recovery, gamut=params.gamut)


def _reference_render(y, uv, params: HdrExportParams) -> torch.Tensor:
    """The WIC-look statistics reference: a genuinely different decode chain
    (full-range expansion, nearest 420-style chroma, pure-2.2 gamma, no
    dither) rendered from every k-th pixel of the crop."""
    from ..kernels.hdr import p010_to_sdr_bgr

    k = _ref_subsample_step(tuple(y.shape), params.ref_max_side)
    return p010_to_sdr_bgr(
        y[::k, ::k], uv[::k, ::k], full_range=True,
        transfer=params.transfer, src_peak_nits=params.src_peak_nits,
        sdr_nits=params.sdr_nits, algo=params.tonemap, desat=params.desat,
        param=params.tm_param, dither=False, peak_detect=params.peak_detect,
        chroma_upsample="nearest", oetf="gamma22",
        contrast_recovery=params.contrast_recovery, gamut=params.gamut)


def _post_stages(bgr, ref, params: HdrExportParams) -> torch.Tensor:
    """The render's post-stages, in the JAX chain's order: colour match
    against ``ref`` (when given) → guide cleanup → shadow deblob →
    despeckle."""
    from ..kernels.cleanup import (despeckle_bgr, guide_cleanup_bgr,
                                   shadow_deblob_bgr)
    from ..kernels.colormatch import color_match_bgr

    if ref is not None:
        bgr = color_match_bgr(
            bgr, ref, strength=params.color_match_strength,
            luma_strength=params.color_match_luma,
            chroma_strength=params.color_match_chroma,
            shadow_luma_protect=params.shadow_luma_protect,
            shadow_chroma_protect=params.shadow_chroma_protect,
            lowfreq=params.lowfreq)
        if params.guide_cleanup:
            bgr = guide_cleanup_bgr(bgr, ref)
    if params.shadow_deblob > 0.0:
        bgr = shadow_deblob_bgr(bgr, strength=params.shadow_deblob)
    if params.speckle_cleanup:
        bgr, _ = despeckle_bgr(bgr)
    return bgr


def render_crop(y_crop: np.ndarray, uv_crop: np.ndarray,
                params: HdrExportParams,
                reference_bgr: Optional[np.ndarray] = None) -> torch.Tensor:
    """P010 crop planes (numpy) → uint8 BGR tensor on ``params.device``:
    the clean tone-map (:func:`_tonemap`), then, with colour match on, the
    match against the statistics reference — ``reference_bgr`` when given,
    else :func:`_reference_render` of the same crop — and the cleanup
    stages (:func:`_post_stages`)."""
    from ..kernels.hdr import plane_tensor

    y = plane_tensor(y_crop, params.device)
    uv = plane_tensor(uv_crop, params.device)
    ref = None
    if params.color_match:
        if reference_bgr is not None:
            ref = torch.from_numpy(np.ascontiguousarray(reference_bgr)).to(
                params.device)
        else:
            ref = _reference_render(y, uv, params)
    return _post_stages(_tonemap(y, uv, params), ref, params)


def crop_planes(y_plane: np.ndarray, uv_plane: np.ndarray, crop_xyxy):
    """The crop legalized for 4:2:0 (:func:`even_hdr_crop_xyxy`), cut from
    the P010 planes: ``(y_crop, uv_crop)``."""
    h, w = y_plane.shape[:2]
    x1, y1, x2, y2 = even_hdr_crop_xyxy(crop_xyxy, (w, h))
    y_crop = np.ascontiguousarray(np.asarray(y_plane)[y1:y2, x1:x2])
    uv_crop = np.ascontiguousarray(
        np.asarray(uv_plane)[y1 // 2:y2 // 2, x1 // 2:x2 // 2])
    return y_crop, uv_crop


def bucketed_crop_arrays(y_plane: np.ndarray, uv_plane: np.ndarray,
                         crop_xyxy, params: HdrExportParams):
    """:func:`crop_planes`, edge-padded to a multiple of
    ``params.shape_bucket`` when that adds at most a quarter of the pixels,
    as the JAX package prepares every render (there, so that XLA reuses one
    compiled program; here, because the replicated pixels enter the
    render's statistics — peak detect, LUT fit, coarse grids — and the
    stills must match). Returns ``(y_crop, uv_crop, trim)``, ``trim`` the
    pre-pad (h, w) to slice the render back to, or None."""
    y_crop, uv_crop = crop_planes(y_plane, uv_plane, crop_xyxy)
    ch, cw = y_crop.shape
    bucket = int(params.shape_bucket or 0)
    trim = None
    if bucket > 1 and (ch % bucket or cw % bucket):
        ph = (-ch) % bucket
        pw = (-cw) % bucket
        pad_frac = ((ch + ph) * (cw + pw) - ch * cw) / float(ch * cw)
        if pad_frac <= 0.25:
            y_crop = np.pad(y_crop, ((0, ph), (0, pw)), mode="edge")
            uv_crop = np.pad(uv_crop, ((0, ph // 2), (0, pw // 2), (0, 0)),
                             mode="edge")
            trim = (ch, cw)
    return y_crop, uv_crop, trim


def submit_sdr_crop_render(y_plane: np.ndarray, uv_plane: np.ndarray,
                           crop_xyxy, params: HdrExportParams,
                           reference_bgr: Optional[np.ndarray] = None):
    """Dispatch the device render for a P010 crop; return a zero-arg
    ``fetch() -> np.ndarray`` that blocks on the result.

    CUDA work is asynchronous: the device computes between ``submit`` and
    ``fetch``, so a caller can overlap the previous still's host-side PNG
    encode with this render (the saver thread does).

    Cropping happens *before* the render (as the reference's PNG path
    crops in HDR space) so tone-map statistics see only the exported
    region.

    ``reference_bgr``: optional externally-rendered statistics reference for
    the colour match (e.g. a reduced-resolution render); when None and
    colour match is on, the render makes its own reference.
    """
    from ..pipeline.backends import start_download

    y_crop, uv_crop, trim = bucketed_crop_arrays(y_plane, uv_plane,
                                                 crop_xyxy, params)
    ref = None
    if reference_bgr is not None and params.color_match:
        ref = np.asarray(reference_bgr)
        if trim is not None:
            # pad the reference by the same FRACTION of its own size as the
            # crop was padded, so the spatial post-stages (lowfreq residual
            # pooling, guide-cleanup resize) keep both inputs on the same
            # normalized grid
            ch, cw = trim
            rh, rw = ref.shape[:2]
            rph = int(round(rh * (y_crop.shape[0] - ch) / float(ch)))
            rpw = int(round(rw * (y_crop.shape[1] - cw) / float(cw)))
            if rph or rpw:
                ref = np.pad(ref, ((0, rph), (0, rpw), (0, 0)), mode="edge")
    download = start_download(render_crop(y_crop, uv_crop, params, ref))
    if trim is None:
        return download
    return lambda: download()[: trim[0], : trim[1]]


def render_sdr_crop_from_p010(y_plane: np.ndarray, uv_plane: np.ndarray,
                              crop_xyxy, params: HdrExportParams,
                              reference_bgr: Optional[np.ndarray] = None
                              ) -> np.ndarray:
    """Blocking crop-render (see :func:`submit_sdr_crop_render`)."""
    return submit_sdr_crop_render(y_plane, uv_plane, crop_xyxy, params,
                                  reference_bgr)()


def save_sdr_still(bgr: np.ndarray, out_path: str) -> Tuple[bool, str]:
    """Atomic PNG/JPG write + validation. The format follows the
    ``out_path`` extension (HdrStillExporter.out_path_for sets it)."""
    from ..pipeline.saver import atomic_image_write

    ok, err = atomic_image_write(bgr, out_path)
    if not ok:
        return False, err
    return validate_sdr_export(out_path,
                               expected_size=(bgr.shape[1], bgr.shape[0]))


def validate_sdr_export(path: str,
                        expected_size: Optional[Tuple[int, int]] = None
                        ) -> Tuple[bool, str]:
    """Decode-and-inspect validation (no byte-size heuristics): missing/
    empty/undecodable/wrong-size/near-black ⇒ reject."""
    if cv2 is None:
        return os.path.exists(path), "cv2_unavailable"
    try:
        if not path or not os.path.exists(path):
            return False, "missing_output"
        if os.path.getsize(path) <= 16:
            return False, "empty_output"
        data = np.fromfile(path, dtype=np.uint8)
        img = cv2.imdecode(data, cv2.IMREAD_COLOR)
        if img is None or img.ndim != 3 or img.size == 0:
            return False, "decode_failed"
        ih, iw = img.shape[:2]
        if expected_size is not None:
            ew, eh = int(expected_size[0]), int(expected_size[1])
            if ew > 0 and eh > 0 and (abs(iw - ew) > 2 or abs(ih - eh) > 2):
                return False, f"wrong_size got={iw}x{ih} expected={ew}x{eh}"
        y = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        mean = float(np.mean(y))
        p95 = float(np.percentile(y, 95.0))
        p99 = float(np.percentile(y, 99.0))
        if mean < 1.0 and p95 < 3.0 and p99 < 8.0:
            return False, (f"near_black_output mean={mean:.3f} "
                           f"p95={p95:.3f} p99={p99:.3f}")
        return True, ""
    except Exception as exc:  # noqa: BLE001 — oracle must not raise
        return False, f"validate_failed:{exc}"


def detect_block_corruption_bgr(bgr: np.ndarray) -> Tuple[bool, str]:
    """Detect block-dropout corruption: many small hard-edged regions much
    darker than their local dark neighborhood (reference oracle:
    gui_app.py:12525-12597)."""
    if cv2 is None or bgr is None or bgr.ndim != 3 or bgr.shape[2] < 3:
        return False, ""
    bgr = bgr[:, :, :3]
    h, w = bgr.shape[:2]
    if h < 64 or w < 64:
        return False, ""
    ycc = cv2.cvtColor(bgr, cv2.COLOR_BGR2YCrCb)
    y = ycc[:, :, 0].astype(np.int16, copy=False)
    y_med = cv2.medianBlur(ycc[:, :, 0], 17).astype(np.int16, copy=False)
    drop = (y <= 52) & (y_med >= 12) & ((y_med - y) >= 12)
    drop_count = int(np.count_nonzero(drop))
    if drop_count < 2500:
        return False, ""
    n, _labels, stats, _cent = cv2.connectedComponentsWithStats(
        drop.astype(np.uint8), 8)
    rect_count = 0
    rect_area = 0
    for i in range(1, n):
        cw = int(stats[i, cv2.CC_STAT_WIDTH])
        ch = int(stats[i, cv2.CC_STAT_HEIGHT])
        area = int(stats[i, cv2.CC_STAT_AREA])
        if area < 12 or cw < 3 or ch < 3 or cw > 80 or ch > 80:
            continue
        if area / max(1, cw * ch) < 0.15:
            continue
        rect_count += 1
        rect_area += area
    bad = ((rect_count >= 80 and rect_area >= 5000)
           or (rect_count >= 50 and drop_count >= 12000))
    if not bad:
        return False, ""
    return True, (f"dark_block_dropouts pixels={drop_count} "
                  f"components={rect_count} area={rect_area}")
