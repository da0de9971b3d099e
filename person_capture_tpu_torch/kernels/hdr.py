"""HDR→SDR conversion: P010/10-bit YCbCr planes → dithered SDR BGR.

Torch port of ``person_capture_tpu/kernels/hdr.py``. The plain-PQ chain
(EOTF → tone-map → gamut → OETF) has two entries, each with a plain
PyTorch version (the CPU path, and the yardstick the tests and
``chip_smoke.py`` hold the kernel to) and a hand-written Hopper kernel in
``csrc/tonemap.cu``:

  * :func:`hdr_to_sdr_bgr` — P010 planes → uint8 BGR in one fused pass
    (kernel entry ``hdr_to_sdr_bgr_launch``; plain version
    :func:`hdr_to_sdr_bgr_reference`); replaces the TPU's
    ``tonemap_planes_pallas`` together with the glue around it;
  * :func:`tonemap_planes` — planar R'G'B' → encoded planar RGB, the
    counterpart of ``tonemap_planes_pallas`` itself (kernel entry
    ``tonemap_planes_launch``; plain version
    :func:`tonemap_planes_reference`).

A CUDA tensor launches the kernel (or raises), a CPU tensor takes the plain
version. The kernel computes no curve constant: :func:`curve_constants`
does, once per launch on the host. Every other function here is plain torch
on the caller's device.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .color import (BT2020_TO_BT709, PQ_PEAK_NITS, YCBCR_BT2020, _f32,
                    bt1886_oetf, hlg_to_linear, normalize_full,
                    normalize_limited, pq_eotf, srgb_oetf, ycbcr_to_rgb)
from .tonemap import (TONEMAPPERS, apply_tonemap, bt2390_knee, hable_norm,
                      mobius_coeffs, reinhard_gain, tm_bt2390, tm_clip,
                      tm_hable, tm_mobius, tm_reinhard)

_BAYER4 = (np.array([[0, 8, 2, 10],
                     [12, 4, 14, 6],
                     [3, 11, 1, 9],
                     [15, 7, 13, 5]], np.float32) + 0.5) / 16.0


def _bayer_tile(h: int, w: int, device) -> torch.Tensor:
    tile = torch.as_tensor(_BAYER4, device=device)
    return tile.repeat(-(-h // 4), -(-w // 4))[:h, :w]


def _resize2d(x: torch.Tensor, h: int, w: int, method: str = "linear"):
    """``jax.image.resize`` on a 2-D plane: half-pixel centres, and
    antialiased (triangle filter widened by the scale) when shrinking."""
    if tuple(x.shape) == (h, w):
        return x
    x4 = x[None, None]
    if method == "nearest":
        out = F.interpolate(x4, size=(h, w), mode="nearest-exact")
    else:
        shrink = h < x.shape[0] or w < x.shape[1]
        out = F.interpolate(x4, size=(h, w), mode="bilinear",
                            align_corners=False, antialias=shrink)
    return out[0, 0]


def plane_tensor(plane: np.ndarray, device=None) -> torch.Tensor:
    """uint16 numpy plane → tensor on ``device`` holding the same bits as
    int16 (CUDA supports few uint16 ops); :func:`p010_unpack` takes it."""
    arr = np.ascontiguousarray(plane, dtype=np.uint16).view(np.int16)
    t = torch.from_numpy(arr)
    if device is not None and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device) if device is not None else t


def _codes(plane) -> torch.Tensor:
    """P010 plane (10-bit code in the high bits of each 16-bit word, as
    uint16 numpy or a :func:`plane_tensor`) → int32 codes."""
    t = plane if isinstance(plane, torch.Tensor) else plane_tensor(plane)
    return (t.to(torch.int32) & 0xFFFF) >> 6


def p010_unpack(y_u16, uv_u16, full_range: bool = False,
                chroma_upsample: str = "linear"):
    """P010 planes → normalized Y (0..1), Cb/Cr (-0.5..0.5) at luma size.

    ``y_u16``: [H, W] uint16 with 10-bit codes in the high bits;
    ``uv_u16``: [H/2, W/2, 2] interleaved CbCr. ``chroma_upsample``:
    "linear" or "nearest" (the blockier 420 decode look)."""
    y_code = _codes(y_u16).to(torch.float32)
    uv_code = _codes(uv_u16).to(torch.float32)
    norm = normalize_full if full_range else normalize_limited
    y = norm(y_code, bits=10, chroma=False)
    cb = norm(uv_code[..., 0], bits=10, chroma=True)
    cr = norm(uv_code[..., 1], bits=10, chroma=True)
    h, w = y.shape
    method = "nearest" if chroma_upsample == "nearest" else "linear"
    return y, _resize2d(cb, h, w, method), _resize2d(cr, h, w, method)


def map_gamut_709(rgb709, mode: str = "clip"):
    """Bring out-of-gamut BT.709 values in range (cfg.hdr_sdr_gamut_mapping):
    clip | relative | perceptual | saturation."""
    rgb = torch.clamp(rgb709, min=0.0)
    if mode == "relative":
        m = rgb.amax(dim=-1, keepdim=True)
        return rgb / torch.clamp(m, min=1.0)
    if mode == "perceptual":
        yl = (0.2126 * rgb[..., 0:1] + 0.7152 * rgb[..., 1:2]
              + 0.0722 * rgb[..., 2:3])
        m = rgb.amax(dim=-1, keepdim=True)
        t = torch.clamp((m - 1.0) / torch.clamp(m - yl, min=1e-5), 0.0, 1.0)
        return torch.clamp(rgb + t * (yl - rgb), 0.0, 1.0)
    if mode == "saturation":
        knee = 0.75
        soft = knee + (1.0 - knee) * torch.tanh((rgb - knee) / (1.0 - knee))
        return torch.where(rgb <= knee, rgb, soft)
    return torch.clamp(rgb, max=1.0)  # clip


def recover_contrast(mapped_lin, pre_lin, amount: float):
    """Restore high-frequency luma detail crushed by tone-map compression
    (cfg.hdr_sdr_contrast_recovery): scale the mapped image by the pre-map
    local detail ratio."""
    if amount <= 0.0:
        return mapped_lin
    y_pre = (0.2627 * pre_lin[..., 0] + 0.6780 * pre_lin[..., 1]
             + 0.0593 * pre_lin[..., 2])
    h, w = y_pre.shape
    ch, cw = max(1, h // 8), max(1, w // 8)
    low = _resize2d(_resize2d(y_pre, ch, cw), h, w)
    detail = torch.clamp((y_pre + 1e-4) / (low + 1e-4), 0.5, 2.0)
    return mapped_lin * (detail ** float(amount))[..., None]


def hdr_rgb_prime_to_linear(rgb_prime, transfer: str = "pq",
                            sdr_nits: float = 100.0,
                            src_peak_nits: float = 1000.0):
    """Non-linear HDR R'G'B' (0..1) → linear RGB in SDR-peak units."""
    if transfer == "hlg":
        lin = hlg_to_linear(rgb_prime, peak_nits=src_peak_nits)
        return lin * (src_peak_nits / sdr_nits)
    return pq_eotf(rgb_prime) * PQ_PEAK_NITS / sdr_nits


def _to_709(rgb2020):
    m = torch.as_tensor(BT2020_TO_BT709, device=rgb2020.device)
    return torch.einsum("...c,dc->...d", rgb2020, m)


def _quantize_bgr(encoded, dither: bool):
    """Encoded RGB ×255 ``[H, W, 3]`` → (dithered) rounded uint8 BGR."""
    if dither:
        h, w = encoded.shape[-3], encoded.shape[-2]
        encoded = encoded + (_bayer_tile(h, w, encoded.device) - 0.5)[..., None]
    u8 = torch.clamp(torch.round(encoded), 0, 255).to(torch.uint8)
    return u8.flip(-1)  # RGB → BGR


def sdr_encode(rgb709_lin, dither: bool = True, oetf: str = "srgb"):
    """Linear BT.709 RGB (0..1) → dithered uint8 BGR. ``oetf``: "srgb" or
    "gamma22" (pure 2.2 power)."""
    lin = torch.clamp(rgb709_lin, 0.0, 1.0)
    if oetf == "gamma22":
        encoded = bt1886_oetf(lin, gamma=2.2) * 255.0
    else:
        encoded = srgb_oetf(lin) * 255.0
    return _quantize_bgr(encoded, dither)


def hdr_to_sdr_core(rgb2020_lin, src_peak_nits: float = 1000.0,
                    sdr_nits: float = 100.0, algo: str = "bt.2390",
                    desat: float = 0.25, param: Optional[float] = None):
    """Linear BT.2020 RGB (SDR-peak units) → linear BT.709 RGB (0..1)."""
    peak = max(1.0 + 1e-3, float(src_peak_nits) / float(sdr_nits))
    mapped = apply_tonemap(rgb2020_lin, peak, algo=algo, desat=desat,
                           param=param, sdr_nits=sdr_nits)
    return torch.clamp(_to_709(mapped), 0.0, 1.0)


def detect_peak_nits(rgb_prime_pq, floor_nits: float = 203.0,
                     quantile: float = 0.999):
    """Scene peak luminance (nits) from PQ-coded R'G'B': a high quantile of
    the per-pixel max channel, floored at HDR reference white."""
    peak_code = quantile_linear(rgb_prime_pq.amax(dim=-1), quantile)
    nits = pq_eotf(peak_code) * PQ_PEAK_NITS
    return torch.clamp(nits, min=floor_nits)


def quantile_linear(x, q):
    """``jnp.quantile(x, q)`` over all of ``x`` (its default linear
    estimator, computed as it does in float32): ``q`` a float or a 1-D
    tensor of quantiles. Sort + interpolation, since ``torch.quantile``
    refuses inputs over 2²⁴ elements."""
    v = torch.sort(x.reshape(-1)).values
    n = v.shape[0]
    q = torch.as_tensor(q, dtype=torch.float32, device=v.device)
    pos = q * float(np.float32(n) - np.float32(1))
    low = torch.floor(pos)
    high_w = pos - low
    lo = torch.clamp(low, 0, n - 1).long()
    hi = torch.clamp(torch.ceil(pos), 0, n - 1).long()
    return v[lo] * (1.0 - high_w) + v[hi] * high_w


def p010_rgb_prime(y_u16, uv_u16, full_range: bool = False,
                   chroma_upsample: str = "linear"):
    """P010 planes → BT.2020 R'G'B' ``[H, W, 3]`` float32, clamped to 0..1."""
    y, cb, cr = p010_unpack(y_u16, uv_u16, full_range, chroma_upsample)
    return torch.clamp(ycbcr_to_rgb(y, cb, cr, YCBCR_BT2020), 0.0, 1.0)


def p010_to_sdr_bgr(y_u16, uv_u16, full_range: bool = False,
                    transfer: str = "pq", src_peak_nits: float = 1000.0,
                    sdr_nits: float = 100.0, algo: str = "bt.2390",
                    desat: float = 0.25, param: Optional[float] = None,
                    dither: bool = True, peak_detect: bool = False,
                    chroma_upsample: str = "linear", oetf: str = "srgb",
                    contrast_recovery: float = 0.0, gamut: str = "clip"):
    """Full P010 HDR frame → SDR BGR uint8, every option of the chain
    (counterpart of ``p010_to_sdr_bgr_jnp``)."""
    rgb_prime = p010_rgb_prime(y_u16, uv_u16, full_range, chroma_upsample)
    if peak_detect and transfer == "pq":
        peak_nits = detect_peak_nits(rgb_prime)
        lin = pq_eotf(rgb_prime) * PQ_PEAK_NITS / sdr_nits
        peak = torch.clamp(peak_nits / sdr_nits, min=1.0 + 1e-3)
    else:
        lin = hdr_rgb_prime_to_linear(rgb_prime, transfer, sdr_nits,
                                      src_peak_nits)
        peak = max(1.0 + 1e-3, float(src_peak_nits) / float(sdr_nits))
    mapped = apply_tonemap(lin, peak, algo=algo, desat=desat, param=param,
                           sdr_nits=sdr_nits)
    mapped = recover_contrast(mapped, lin, contrast_recovery)
    return sdr_encode(map_gamut_709(_to_709(mapped), gamut), dither, oetf)




# ---------------------------------------------------------------------------
# The plain-PQ per-pixel chain: plain versions and the hand-written kernels
# ---------------------------------------------------------------------------

_ALGO_CODES = {tm_clip: 0, tm_reinhard: 1, tm_mobius: 2, tm_hable: 3,
               tm_bt2390: 4}


def _tonemap_rgb(rgb_prime, src_peak_nits: float, sdr_nits: float,
                 algo: str, desat: float, param: Optional[float]):
    """The chain on R'G'B' ``[..., 3]``: PQ EOTF → tone-map → BT.2020→709 →
    clip → sRGB OETF. Returns encoded RGB in 0..1."""
    peak = max(1.0 + 1e-3, float(src_peak_nits) / float(sdr_nits))
    lin = pq_eotf(rgb_prime) * (PQ_PEAK_NITS / sdr_nits)
    mapped = apply_tonemap(lin, peak, algo=algo, desat=desat, param=param,
                           sdr_nits=sdr_nits)
    return srgb_oetf(torch.clamp(_to_709(mapped), 0.0, 1.0))


def tonemap_planes_reference(rgb_prime_planar, src_peak_nits: float = 1000.0,
                             sdr_nits: float = 100.0, algo: str = "bt.2390",
                             desat: float = 0.25,
                             param: Optional[float] = None):
    """Plain PyTorch version of the planar entry on R'G'B' ``[3, H, W]``
    float32. Returns encoded planar RGB in 0..1."""
    rgb = rgb_prime_planar.to(torch.float32).permute(1, 2, 0)
    out = _tonemap_rgb(rgb, src_peak_nits, sdr_nits, algo, desat, param)
    return out.permute(2, 0, 1).contiguous()


def hdr_to_sdr_bgr_reference(y_u16, uv_u16, full_range: bool = False,
                             src_peak_nits: float = 1000.0,
                             sdr_nits: float = 100.0, algo: str = "bt.2390",
                             desat: float = 0.25,
                             param: Optional[float] = None,
                             dither: bool = True):
    """Plain PyTorch version of the fused entry: P010 planes → uint8 BGR
    ``[H, W, 3]`` through the plain-PQ chain, ×255, Bayer dither, round."""
    rgb_prime = p010_rgb_prime(y_u16, uv_u16, full_range)
    encoded = _tonemap_rgb(rgb_prime, src_peak_nits, sdr_nits, algo, desat,
                           param)
    return _quantize_bgr(encoded * 255.0, dither)


# --- constants of a launch, on the host --------------------------------------

_F32 = np.float32


def curve_constants(algo: str, peak: float, sdr_nits: float = 100.0,
                    param: Optional[float] = None) -> dict:
    """The constants the curve ``algo`` computes for source/SDR peak ratio
    ``peak``, from the helpers the torch curves call (``kernels/tonemap.py``,
    on CPU float32 scalars), as numpy float32, plus the PQ scale
    ``10000/sdr_nits`` and its inverse. The CUDA kernel takes them by value
    and computes none of them."""
    fn = TONEMAPPERS.get(algo, tm_bt2390)
    k = {"peak_c": torch.clamp(_f32(peak), min=1.0 + 1e-6),
         "lin_scale": PQ_PEAK_NITS / sdr_nits,
         "inv_lin_scale": sdr_nits / PQ_PEAK_NITS}
    if fn is tm_reinhard:
        k["reinhard_gain"] = reinhard_gain(peak)
    elif fn is tm_mobius:
        k.update(zip(("mob_j", "mob_a", "mob_b", "mob_scale"),
                     mobius_coeffs(peak, 0.3 if param is None else param)))
    elif fn is tm_hable:
        k["hable_norm"] = hable_norm(peak)
    elif fn is tm_bt2390:
        k.update(zip(("peak_c", "src_max_pq", "max_lum", "ks"),
                     bt2390_knee(peak, sdr_nits)))
    return {name: _F32(float(v)) for name, v in k.items()}


_PARAM_FLOATS = ("lin_scale", "inv_lin_scale", "peak_c", "reinhard_gain",
                 "mob_j", "mob_a", "mob_b", "mob_scale", "hable_inv_norm",
                 "src_max_pq", "inv_src_max_pq", "max_lum", "ks",
                 "inv_knee_span", "desat", "inv_peak_m1", "y_off", "y_scale",
                 "c_off", "c_scale")


class _KernelParams(ctypes.Structure):
    """``KernelParams`` of ``csrc/tonemap.cu``, field for field."""
    _fields_ = ([("algo", ctypes.c_int32), ("dither", ctypes.c_int32)]
                + [(name, ctypes.c_float) for name in _PARAM_FLOATS]
                + [("gamut", ctypes.c_float * 9), ("ycc", ctypes.c_float * 9)])


@functools.lru_cache(maxsize=64)
def _kernel_params(algo: str, src_peak_nits: float, sdr_nits: float,
                   desat: float, param: Optional[float],
                   full_range: bool = False,
                   dither: bool = False) -> _KernelParams:
    """Everything a launch needs besides its tensors, computed once on the
    host: the curve's constants, the reciprocals the kernel multiplies by,
    the P010 normalisation and the two matrices."""
    f = _F32
    one, tiny = f(1.0), f(1e-6)
    peak = max(1.0 + 1e-3, float(src_peak_nits) / float(sdr_nits))
    vals = curve_constants(algo, peak, sdr_nits, param)
    if "hable_norm" in vals:
        vals["hable_inv_norm"] = one / np.maximum(vals["hable_norm"], tiny)
    if "src_max_pq" in vals:
        vals["inv_src_max_pq"] = one / vals["src_max_pq"]
        vals["inv_knee_span"] = one / np.maximum(one - vals["ks"], tiny)
    vals["desat"] = f(desat or 0.0)
    vals["inv_peak_m1"] = one / np.maximum(f(peak) - one, tiny)
    # value = (code - off) * scale (color.normalize_full / normalize_limited;
    # chroma then takes off 0.5)
    if full_range:
        vals.update(y_off=0.0, c_off=0.0, y_scale=1.0 / 1023.0,
                    c_scale=1.0 / 1023.0)
    else:
        vals.update(y_off=64.0, c_off=64.0, y_scale=1.0 / 876.0,
                    c_scale=1.0 / 896.0)
    p = _KernelParams()
    p.algo = _ALGO_CODES[TONEMAPPERS.get(algo, tm_bt2390)]
    p.dither = int(bool(dither))
    for name in _PARAM_FLOATS:
        setattr(p, name, float(f(vals.get(name, 0.0))))
    p.gamut[:] = [float(v) for v in BT2020_TO_BT709.reshape(-1)]
    ycc = np.linalg.inv(YCBCR_BT2020).astype(np.float32)  # as ycbcr_to_rgb
    p.ycc[:] = [float(v) for v in ycc.reshape(-1)]
    return p


# --- launches ----------------------------------------------------------------

class _LaunchCounter:
    """Launches of one kernel entry; ``chip_smoke.py`` zeroes it before a
    path and reads it after, to show the path went through the kernel."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


TONEMAP_LAUNCHES = _LaunchCounter()
HDR_TO_SDR_LAUNCHES = _LaunchCounter()


@functools.lru_cache(maxsize=None)
def _tonemap_lib():
    from . import build

    lib = build.load("tonemap")
    params = ctypes.POINTER(_KernelParams)
    lib.tonemap_planes_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        params, ctypes.c_void_p]
    lib.hdr_to_sdr_bgr_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, params, ctypes.c_void_p]
    lib.tonemap_planes_launch.restype = ctypes.c_int
    lib.hdr_to_sdr_bgr_launch.restype = ctypes.c_int
    return lib


def _on_host(x) -> bool:
    return not isinstance(x, torch.Tensor) or x.device.type == "cpu"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def tonemap_planes_cuda(rgb_prime_planar: torch.Tensor,
                        src_peak_nits: float = 1000.0,
                        sdr_nits: float = 100.0, algo: str = "bt.2390",
                        desat: float = 0.25, param: Optional[float] = None):
    """Launch the planar entry of ``csrc/tonemap.cu`` on a CUDA
    ``[3, H, W]`` float32 contiguous tensor, on the current stream. Raises
    on any other input, on a failed build and on a refused launch."""
    x = rgb_prime_planar
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("tonemap_planes_cuda needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"tonemap_planes_cuda needs float32, got {x.dtype}")
    if x.dim() != 3 or x.shape[0] != 3:
        raise ValueError(f"tonemap_planes_cuda needs [3, H, W], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("tonemap_planes_cuda needs a contiguous tensor")
    lib = _tonemap_lib()
    p = _kernel_params(algo, src_peak_nits, sdr_nits, desat, param)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.tonemap_planes_launch(x.data_ptr(), out.data_ptr(),
                                        x.shape[1], x.shape[2],
                                        ctypes.byref(p), _stream(x))
    if err != 0:
        raise RuntimeError(f"tonemap_planes kernel launch failed: "
                           f"cudaError {err}")
    TONEMAP_LAUNCHES.add()
    return out


def tonemap_planes(rgb_prime_planar: torch.Tensor,
                   src_peak_nits: float = 1000.0, sdr_nits: float = 100.0,
                   algo: str = "bt.2390", desat: float = 0.25,
                   param: Optional[float] = None):
    """PQ→tonemap→gamut→OETF on planar R'G'B' ``[3, H, W]`` float32: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if _on_host(rgb_prime_planar):
        return tonemap_planes_reference(rgb_prime_planar, src_peak_nits,
                                        sdr_nits, algo, desat, param)
    return tonemap_planes_cuda(rgb_prime_planar, src_peak_nits, sdr_nits,
                               algo, desat, param)


def _check_p010_cuda(y, uv) -> None:
    for name, t in (("Y", y), ("CbCr", uv)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"hdr_to_sdr_bgr_cuda needs CUDA tensors "
                             f"({name} plane)")
        if t.dtype != torch.int16:
            raise ValueError(f"hdr_to_sdr_bgr_cuda needs int16 P010 planes "
                             f"(plane_tensor), got {t.dtype} for {name}")
        if not t.is_contiguous():
            raise ValueError(f"hdr_to_sdr_bgr_cuda needs a contiguous "
                             f"{name} plane")
    if y.dim() != 2:
        raise ValueError(f"hdr_to_sdr_bgr_cuda needs Y as [H, W], got "
                         f"{tuple(y.shape)}")
    h, w = y.shape
    if h == 0 or w == 0 or h % 2 or w % 2:
        raise ValueError(f"hdr_to_sdr_bgr_cuda needs an even, non-empty "
                         f"height and width (4:2:0), got {h}x{w}")
    if tuple(uv.shape) != (h // 2, w // 2, 2):
        raise ValueError(f"hdr_to_sdr_bgr_cuda needs CbCr as [H/2, W/2, 2] "
                         f"= {[h // 2, w // 2, 2]}, got {list(uv.shape)}")
    if uv.device != y.device:
        raise ValueError("hdr_to_sdr_bgr_cuda needs both planes on one "
                         "device")


def hdr_to_sdr_bgr_cuda(y_u16: torch.Tensor, uv_u16: torch.Tensor,
                        full_range: bool = False,
                        src_peak_nits: float = 1000.0,
                        sdr_nits: float = 100.0, algo: str = "bt.2390",
                        desat: float = 0.25, param: Optional[float] = None,
                        dither: bool = True) -> torch.Tensor:
    """Launch the fused entry of ``csrc/tonemap.cu``: CUDA int16 P010 planes
    (:func:`plane_tensor`) → uint8 BGR ``[H, W, 3]``, one kernel and no
    other device work. Raises on any other input, on a failed build and on
    a refused launch."""
    _check_p010_cuda(y_u16, uv_u16)
    lib = _tonemap_lib()
    p = _kernel_params(algo, src_peak_nits, sdr_nits, desat, param,
                       bool(full_range), bool(dither))
    h, w = y_u16.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y_u16.device)
    with torch.cuda.device(y_u16.device):
        err = lib.hdr_to_sdr_bgr_launch(y_u16.data_ptr(), uv_u16.data_ptr(),
                                        out.data_ptr(), h, w,
                                        ctypes.byref(p), _stream(y_u16))
    if err != 0:
        raise RuntimeError(f"hdr_to_sdr_bgr kernel launch failed: "
                           f"cudaError {err}")
    HDR_TO_SDR_LAUNCHES.add()
    return out


def hdr_to_sdr_bgr(y_u16, uv_u16, full_range: bool = False,
                   transfer: str = "pq", src_peak_nits: float = 1000.0,
                   sdr_nits: float = 100.0, algo: str = "bt.2390",
                   desat: float = 0.25, param: Optional[float] = None,
                   dither: bool = True):
    """P010 planes → SDR BGR uint8 for the PLAIN tone-map configuration (no
    peak-detect/contrast-recovery/gamut-map): one launch of the fused kernel
    for CUDA planes, the plain version for host ones; HLG sources take the
    general chain."""
    if transfer != "pq":
        return p010_to_sdr_bgr(y_u16, uv_u16, full_range, transfer,
                               src_peak_nits, sdr_nits, algo, desat, param,
                               dither)
    fn = hdr_to_sdr_bgr_reference if _on_host(y_u16) else hdr_to_sdr_bgr_cuda
    return fn(y_u16, uv_u16, full_range, src_peak_nits, sdr_nits, algo,
              desat, param, dither)
