"""Torch port of the HDR tone-map family held to the JAX package.

Same seeded numpy inputs through both packages, fp32 on both sides. The JAX
side of the TPU kernel runs as tests/test_hdr_kernels.py runs it:
``tonemap_planes_pallas(..., interpret=True)``. Tolerances: atol 2e-3 on
float planes (the kernel's bound; transcendental rounding differs between
XLA and torch by ~1e-4), ≤ 1 LSB on uint8 BGR (one rounding step).
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.hdr import stills as JS  # noqa: E402
from person_capture_tpu.kernels import color as JC  # noqa: E402
from person_capture_tpu.kernels import hdr as JH  # noqa: E402
from person_capture_tpu.kernels import tonemap as JT  # noqa: E402
from person_capture_tpu_torch.config import SessionConfig  # noqa: E402
from person_capture_tpu_torch.hdr import stills as TS  # noqa: E402
from person_capture_tpu_torch.kernels import color as TC  # noqa: E402
from person_capture_tpu_torch.kernels import hdr as TH  # noqa: E402
from person_capture_tpu_torch.kernels import tonemap as TT  # noqa: E402

ATOL = 2e-3
ALGOS = ["clip", "reinhard", "mobius", "hable", "bt.2390", "auto", "spline",
         "unknown-name"]


def _p010(h=32, w=64, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(64, 941, (h, w)).astype(np.uint16) << 6
    uv = rng.integers(64, 961, (h // 2, w // 2, 2)).astype(np.uint16) << 6
    return y, uv


def test_pq_transfer_functions():
    x = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    np.testing.assert_allclose(TC.pq_eotf(torch.from_numpy(x)).numpy(),
                               np.asarray(JC.pq_eotf(jnp.asarray(x))),
                               atol=ATOL)
    np.testing.assert_allclose(TC.pq_inv_eotf(torch.from_numpy(x)).numpy(),
                               np.asarray(JC.pq_inv_eotf(jnp.asarray(x))),
                               atol=ATOL)
    for name in ("srgb_oetf", "srgb_eotf", "bt709_oetf", "bt1886_oetf",
                 "hlg_oetf_inv"):
        np.testing.assert_allclose(
            getattr(TC, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(JC, name)(jnp.asarray(x))), atol=ATOL)


def test_ycbcr_round_trip_to_bgr_u8():
    rng = np.random.default_rng(6)
    y = rng.uniform(0, 1, (8, 12)).astype(np.float32)
    cb, cr = rng.uniform(-0.5, 0.5, (2, 8, 12)).astype(np.float32)
    for m in (JC.YCBCR_BT2020, JC.YCBCR_BT709):
        want = np.asarray(JC.ycbcr_to_bgr_u8(jnp.asarray(y), jnp.asarray(cb),
                                             jnp.asarray(cr), m)).astype(int)
        got = TC.ycbcr_to_bgr_u8(torch.from_numpy(y), torch.from_numpy(cb),
                                 torch.from_numpy(cr), m).numpy().astype(int)
        assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("desat", [0.0, 0.25])
@pytest.mark.parametrize("algo", ["clip", "reinhard", "mobius", "hable",
                                  "bt.2390"])
def test_tonemap_curves(algo, desat):
    rng = np.random.default_rng(3)
    rgb = rng.uniform(0.0, 12.0, (256, 3)).astype(np.float32)
    want = np.asarray(JT.apply_tonemap(jnp.asarray(rgb), 10.0, algo=algo,
                                       desat=desat, param=0.4))
    got = TT.apply_tonemap(torch.from_numpy(rgb), 10.0, algo=algo,
                           desat=desat, param=0.4).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("desat", [0.0, 0.25])
@pytest.mark.parametrize("algo", ALGOS)
def test_tonemap_planes_reference_matches_pallas(algo, desat):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (3, 24, 100)).astype(np.float32)
    want = np.asarray(JH.tonemap_planes_pallas(
        jnp.asarray(x), 1000.0, 100.0, algo, desat, 0.4, interpret=True))
    got = TH.tonemap_planes_reference(torch.from_numpy(x), 1000.0, 100.0,
                                      algo, desat, 0.4).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tonemap_planes_dispatch_on_cpu():
    """A CPU tensor takes the plain version; the CUDA wrapper refuses
    anything but a CUDA tensor (no quiet fallback either way)."""
    x = torch.rand(3, 8, 16, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(TH.tonemap_planes(x).numpy(),
                                  TH.tonemap_planes_reference(x).numpy())
    with pytest.raises(ValueError, match="CUDA tensor"):
        TH.tonemap_planes_cuda(x)


@pytest.mark.parametrize("kw", [
    {}, {"dither": False}, {"algo": "mobius", "param": 0.4},
    {"transfer": "hlg"}, {"full_range": True, "algo": "hable"},
    {"full_range": True, "dither": False},
    {"full_range": True, "algo": "reinhard", "desat": 0.0},
    {"algo": "clip", "dither": False, "desat": 0.0},
])
def test_hdr_to_sdr_bgr(kw):
    """The plain version of the fused kernel (what a host tensor takes)
    against the JAX package's Pallas path in interpret mode."""
    y, uv = _p010(seed=2)
    want = np.asarray(JH.hdr_to_sdr_bgr(jnp.asarray(y), jnp.asarray(uv),
                                        use_pallas=True, **kw)).astype(int)
    got = TH.hdr_to_sdr_bgr(y, uv, **kw).numpy().astype(int)
    assert got.shape == want.shape == (32, 64, 3)
    assert np.abs(got - want).max() <= 1
    if kw.get("transfer", "pq") == "pq":
        ref = TH.hdr_to_sdr_bgr_reference(y, uv, **kw).numpy()
        np.testing.assert_array_equal(ref, got)


def _jax_curve_constants(algo, peak, sdr_nits, param):
    """The constants in the float32 steps of the JAX package's
    kernels/tonemap.py, on its own primitives."""
    f32 = jnp.float32
    pk = jnp.maximum(jnp.asarray(peak, f32), 1.0 + 1e-6)
    if algo == "reinhard":
        return {"reinhard_gain": (peak + 1.0) / peak}
    if algo == "mobius":
        j = f32(param)
        a = -j * j * (pk - 1.0) / jnp.maximum(j * j - 2.0 * j + pk, 1e-6)
        b = (j * j - 2.0 * j * pk + pk) / jnp.maximum(pk - 1.0, 1e-6)
        return {"mob_j": j, "mob_a": a, "mob_b": b,
                "mob_scale": (b * b + 2.0 * b * j + j * j) / (b - a)}
    if algo == "hable":
        return {"hable_norm": JT._hable_partial(jnp.asarray(peak, f32))}
    if algo == "bt.2390":
        src_max_pq = JC.pq_inv_eotf(pk * sdr_nits / 10000.0)
        max_lum = JC.pq_inv_eotf(f32(sdr_nits) / 10000.0) / src_max_pq
        return {"peak_c": pk, "src_max_pq": src_max_pq, "max_lum": max_lum,
                "ks": 1.5 * max_lum - 0.5}
    return {"peak_c": pk}


def _torch_curve_constants(algo, peak, sdr_nits, param):
    """The same constants from the helpers the port's torch curves use."""
    if algo == "reinhard":
        return {"reinhard_gain": TT.reinhard_gain(peak)}
    if algo == "mobius":
        return dict(zip(("mob_j", "mob_a", "mob_b", "mob_scale"),
                        TT.mobius_coeffs(peak, param)))
    if algo == "hable":
        return {"hable_norm": TT.hable_norm(peak)}
    if algo == "bt.2390":
        return dict(zip(("peak_c", "src_max_pq", "max_lum", "ks"),
                        TT.bt2390_knee(peak, sdr_nits)))
    return {"peak_c": torch.clamp(TC._f32(peak), min=1.0 + 1e-6)}


@pytest.mark.parametrize("peak", [1.001, 10.0, 40.0])
@pytest.mark.parametrize("algo,param", [
    ("clip", None), ("reinhard", None), ("mobius", 0.3), ("mobius", 0.4),
    ("hable", None), ("bt.2390", None)])
def test_curve_constants(algo, param, peak):
    """The kernel's host constants against the port's torch curves and the
    JAX package's, rel 1e-6, float32 on every side."""
    got = TH.curve_constants(algo, peak, 100.0, param)
    assert got["lin_scale"] == np.float32(100.0)
    assert got["inv_lin_scale"] == np.float32(0.01)
    torch_k = _torch_curve_constants(algo, peak, 100.0, param)
    jax_k = _jax_curve_constants(algo, peak, 100.0, param)
    assert set(torch_k) == set(jax_k)
    for name in torch_k:
        want_t = np.float32(torch_k[name])
        want_j = np.float32(jax_k[name])
        assert got[name].dtype == np.float32, name
        np.testing.assert_allclose(got[name], want_t, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(want_t, want_j, rtol=1e-6, err_msg=name)


def test_kernel_params_follow_the_curve_and_range():
    """The struct a launch passes: the curve's code, its reciprocals, and
    the P010 normalisation of color.normalize_limited / normalize_full."""
    p = TH._kernel_params("auto", 1000.0, 100.0, 0.25, None, False, True)
    k = TH.curve_constants("bt.2390", 10.0, 100.0)
    assert (p.algo, p.dither) == (4, 1)
    np.testing.assert_allclose(p.inv_src_max_pq, 1.0 / k["src_max_pq"],
                               rtol=1e-6)
    np.testing.assert_allclose(p.inv_knee_span, 1.0 / (1.0 - k["ks"]),
                               rtol=1e-6)
    np.testing.assert_allclose(p.inv_peak_m1, 1.0 / 9.0, rtol=1e-6)
    codes = np.array([64.0, 512.0, 940.0], np.float32)
    for full in (False, True):
        q = TH._kernel_params("hable", 1000.0, 100.0, 0.0, None, full, False)
        assert (q.algo, q.dither, q.desat) == (3, 0, 0.0)
        for chroma, off, scale in ((False, q.y_off, q.y_scale),
                                   (True, q.c_off, q.c_scale)):
            norm = TC.normalize_full if full else TC.normalize_limited
            want = norm(torch.from_numpy(codes), bits=10,
                        chroma=chroma).numpy()
            got = (codes - off) * np.float32(scale) - (0.5 if chroma else 0.0)
            np.testing.assert_allclose(got, want, atol=1e-6)


def test_hdr_to_sdr_bgr_dispatch_on_cpu():
    """Host planes take the plain version; the CUDA wrapper refuses
    anything but CUDA int16 planes (no quiet fallback either way)."""
    y, uv = _p010(h=8, w=12, seed=7)
    yt = TH.plane_tensor(y)
    uvt = TH.plane_tensor(uv)
    np.testing.assert_array_equal(TH.hdr_to_sdr_bgr(yt, uvt).numpy(),
                                  TH.hdr_to_sdr_bgr_reference(y, uv).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        TH.hdr_to_sdr_bgr_cuda(yt, uvt)


@pytest.mark.parametrize("kw", [
    {}, {"peak_detect": True}, {"contrast_recovery": 0.3},
    {"gamut": "perceptual"}, {"gamut": "relative"}, {"gamut": "saturation"},
    {"chroma_upsample": "nearest", "oetf": "gamma22", "full_range": True},
])
def test_p010_to_sdr_bgr(kw):
    y, uv = _p010(h=48, w=80, seed=4)
    want = np.asarray(JH.p010_to_sdr_bgr_jnp(jnp.asarray(y), jnp.asarray(uv),
                                             **kw)).astype(int)
    got = TH.p010_to_sdr_bgr(y, uv, **kw).numpy().astype(int)
    assert np.abs(got - want).max() <= 1


def _fast_cfg(cls):
    cfg = cls()
    cfg.device = "cpu"
    cfg.hdr_sdr_quality = "fast"
    cfg.hdr_sdr_contrast_recovery = 0.0
    return cfg


def test_stills_render_fast_params():
    from person_capture_tpu.config import SessionConfig as JCfg

    y, uv = _p010(h=96, w=128, seed=5)
    crop = (13, 7, 101, 90)
    jp = JS.HdrExportParams.from_cfg(_fast_cfg(JCfg))
    tp = TS.HdrExportParams.from_cfg(_fast_cfg(SessionConfig))
    want = JS.render_sdr_crop_from_p010(y, uv, crop, jp).astype(int)
    got = TS.render_sdr_crop_from_p010(y, uv, crop, tp).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_stills_render_peak_detect_through_the_plain_chain():
    """With peak-detect on, the port renders the measured peak through the
    fused chain; the JAX package takes its jnp peak-detect chain. Same
    stills (the preview renders this way)."""
    from person_capture_tpu.config import SessionConfig as JCfg

    y, uv = _p010(h=64, w=96, seed=8)
    crop = (6, 4, 90, 60)
    jp = JS.HdrExportParams.from_cfg(_fast_cfg(JCfg))
    tp = TS.HdrExportParams.from_cfg(_fast_cfg(SessionConfig))
    for p in (jp, tp):
        p.peak_detect = True
        p.dither = True
    want = JS.render_sdr_crop_from_p010(y, uv, crop, jp).astype(int)
    got = TS.render_sdr_crop_from_p010(y, uv, crop, tp).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
