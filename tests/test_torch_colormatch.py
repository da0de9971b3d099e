"""Colour match, cleanup and the madvr_like still render of the torch port
against the JAX package, on the CPU.

The JAX side runs op by op (called directly, or under ``jax.disable_jit``
for the jitted still render), where each op rounds as IEEE float32 does, as
torch's do. Tolerances: quantiles, LUT and gains rtol 1e-6 (the same sort
and interpolation); every uint8 image ≤ 1 LSB; the despeckle mask
identical.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.hdr import stills as JS  # noqa: E402
from person_capture_tpu.kernels import cleanup as JCL  # noqa: E402
from person_capture_tpu.kernels import colormatch as JCM  # noqa: E402
from person_capture_tpu_torch.config import SessionConfig  # noqa: E402
from person_capture_tpu_torch.hdr import stills as TS  # noqa: E402
from person_capture_tpu_torch.kernels import cleanup as TCL  # noqa: E402
from person_capture_tpu_torch.kernels import colormatch as TCM  # noqa: E402
from person_capture_tpu_torch.kernels.hdr import quantile_linear  # noqa: E402
from person_capture_tpu_torch.video.synthetic import (  # noqa: E402
    FacePlacement, draw_person, p010_from_pq_bgr, pq_code_bgr)


def _scene(h=96, w=128, seed=0):
    """Noisy graded background, a drawn person, a saturated patch and a few
    isolated saturated pixels in the dark: BGR uint8."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(10, 200, w)[None, :, None] * np.ones((h, 1, 3))
    img = np.clip(ramp * np.array([0.8, 1.0, 1.1])
                  + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
    s = h / 96.0
    draw_person(img, FacePlacement(0, 0, (int(70 * s), int(8 * s),
                                          int(86 * s), int(26 * s))))
    img[int(60 * s):int(80 * s), int(8 * s):int(30 * s)] = (230, 40, 200)
    img[:int(20 * s), :int(40 * s)] //= 6           # a deep shadow ...
    for y, x in rng.integers(2, int(18 * s), (6, 2)):
        img[y, x] = (255, 20, 40)                    # ... with speckles
    return img


def _ref_render(img):
    """A differently-rendered reference: gamma-lifted, warmer."""
    x = img.astype(np.float32) / 255.0
    x = x ** 0.8 * np.array([0.9, 1.0, 1.12])
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _le1(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1, (d.max(), (d > 0).mean())


def test_quantile_lut_and_interp():
    rng = np.random.default_rng(1)
    x = rng.normal(size=200_001).astype(np.float32)
    qs = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    np.testing.assert_allclose(quantile_linear(_t(x), _t(qs)).numpy(),
                               np.asarray(jnp.quantile(jnp.asarray(x), qs)),
                               rtol=1e-6)
    clean, ref = rng.uniform(0, 1, (2, 64, 80)).astype(np.float32) ** [[[1]],
                                                                       [[2]]]
    xs, ys = TCM.fit_quantile_lut(_t(clean), _t(ref))
    jxs, jys = JCM.fit_quantile_lut(jnp.asarray(clean), jnp.asarray(ref))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-6)
    # interp clamps to the end values outside the nodes
    probe = np.concatenate([np.array([-1.0, 2.0], np.float32),
                            clean.reshape(-1)])
    np.testing.assert_allclose(
        TCM.apply_lut(_t(probe), xs, ys).numpy(),
        np.asarray(JCM.apply_lut(jnp.asarray(probe), jxs, jys)), atol=1e-6)


@pytest.mark.parametrize("n_sel", [0, 100, 300])
def test_masked_percentile_and_side_gains(n_sel):
    """Unselected values sort to +inf; a side with under 256 selected
    pixels falls back to the all-pixel gain."""
    rng = np.random.default_rng(2)
    c = -rng.uniform(0.01, 0.2, 4096).astype(np.float32)
    c[:n_sel] = rng.uniform(0.01, 0.2, n_sel)
    r = c * 1.3
    sel = c > 1.0 / 255.0
    got, n = TCM._masked_percentile(_t(c), _t(sel), 0.75)
    want, wn = JCM._masked_percentile(jnp.asarray(c), jnp.asarray(sel), 0.75)
    assert int(n) == int(wn) == n_sel
    if n_sel:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    else:
        assert not np.isfinite(float(got)) and not np.isfinite(float(want))
    gp, gn = TCM.fit_chroma_side_gains(_t(c), _t(r))
    wp, wn_ = JCM.fit_chroma_side_gains(jnp.asarray(c), jnp.asarray(r))
    np.testing.assert_allclose([float(gp), float(gn)],
                               [float(wp), float(wn_)], rtol=1e-6)
    if n_sel < 256:   # the positive side took the all-pixel fallback
        fb = float(np.quantile(np.abs(r), 0.75) / np.quantile(np.abs(c),
                                                              0.75))
        np.testing.assert_allclose(float(gp), fb, rtol=1e-4)


def test_side_gains_below_1024_pixels_are_one():
    c = np.full((20, 30), 0.1, np.float32)
    gp, gn = TCM.fit_chroma_side_gains(_t(c), _t(c * 2))
    assert float(gp) == float(gn) == 1.0


@pytest.mark.parametrize("ref_kind,lowfreq", [
    ("full", 0.0), ("reduced", 0.0), ("reduced", 0.5), ("small", 0.0)])
def test_color_match_bgr(ref_kind, lowfreq):
    """Full-size and strided (reduced) statistics references, the
    low-frequency residual, and a plane under 1024 pixels (gains of 1)."""
    clean = _scene()
    ref = _ref_render(clean)
    if ref_kind == "reduced":
        ref = ref[::3, ::3]
    elif ref_kind == "small":
        clean, ref = clean[:24, :40], ref[:24, :40]
    want = JCM.color_match_bgr(jnp.asarray(clean), jnp.asarray(ref),
                               lowfreq=lowfreq)
    got = TCM.color_match_bgr(_t(clean), _t(ref), lowfreq=lowfreq)
    assert got.dtype == torch.uint8 and got.shape == clean.shape
    assert np.abs(got.numpy().astype(int) - clean).max() > 3   # it moved
    _le1(got.numpy(), want)


def test_median_and_shift():
    x = np.random.default_rng(3).normal(size=(2, 9, 11)).astype(np.float32)
    for dy, dx in ((1, 0), (-2, 1), (0, -1), (2, 2)):
        np.testing.assert_array_equal(
            TCL._shift2d(_t(x), dy, dx).numpy(),
            np.asarray(JCL._shift2d(jnp.asarray(x), dy, dx)))
    np.testing.assert_array_equal(
        TCL.neighborhood_median3(_t(x)).numpy(),
        np.asarray(JCL.neighborhood_median3(jnp.asarray(x))))


def test_despeckle():
    img = _scene()
    want, wmask = JCL.despeckle_bgr(jnp.asarray(img))
    got, mask = TCL.despeckle_bgr(_t(img))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert mask.sum() >= 3                       # the planted speckles
    _le1(got.numpy(), want)


def test_shadow_deblob_and_guide_cleanup():
    img = _scene()
    _le1(TCL.shadow_deblob_bgr(_t(img), strength=0.7).numpy(),
         JCL.shadow_deblob_bgr(jnp.asarray(img), strength=0.7))
    guide = _ref_render(img)[::2, ::2]          # reduced: upsampled inside
    got = TCL.guide_cleanup_bgr(_t(img), _t(guide))
    want = JCL.guide_cleanup_bgr(jnp.asarray(img), jnp.asarray(guide))
    assert got.dtype == torch.uint8 and got.shape == img.shape
    _le1(got.numpy(), want)


def test_ref_subsample_step():
    for shape, side in (((1080, 1920), 960), ((100, 80), 960),
                        ((1081, 1921), 480), ((64, 64), 0)):
        assert TS._ref_subsample_step(shape, side) == \
            JS._ref_subsample_step(shape, side)


def _planes(h=192, w=256, seed=0):
    return p010_from_pq_bgr(pq_code_bgr(_scene(h, w, seed)))


def _params(quality, **extra):
    from person_capture_tpu.config import SessionConfig as JCfg

    jc, tc = JCfg(), SessionConfig()
    tc.device = "cpu"
    for c in (jc, tc):
        c.hdr_sdr_quality = quality
        for k, v in extra.items():
            setattr(c, k, v)
    return JS.HdrExportParams.from_cfg(jc), TS.HdrExportParams.from_cfg(tc)


def _jax_render(*args):
    with jax.disable_jit():
        return JS.render_sdr_crop_from_p010(*args)


@pytest.mark.parametrize("quality,extra,crop", [
    ("madvr_like", {}, (10, 6, 230, 190)),          # padded to 192×256
    ("madvr_like", {}, (0, 0, 256, 192)),
    ("balanced", {}, (10, 6, 230, 190)),
    ("madvr_like", {"hdr_wic_yuv444_color_match_lowfreq": 0.5,
                    "wic_shadow_deblob_strength": 0.5,
                    "hdr_wic_yuv444_guide_cleanup": True},
     (4, 2, 200, 150)),
])
def test_still_render(quality, extra, crop):
    """The whole madvr_like / balanced render (peak detect, contrast
    recovery, statistics reference, colour match, cleanup) against the JAX
    package's ``submit_sdr_crop_render``."""
    jp, tp = _params(quality, **extra)
    jp.ref_max_side = tp.ref_max_side = min(jp.ref_max_side, 96)
    y, uv = _planes()
    want = _jax_render(y, uv, crop, jp)
    got = TS.render_sdr_crop_from_p010(y, uv, crop, tp)
    assert got.shape == want.shape
    _le1(got, want)


def test_still_render_external_reference():
    """``reference_bgr`` replaces the internal statistics render; the
    post-stages keep their order. (A crop the bucket pads is left out: the
    JAX package's external path fails on it with a NameError.)"""
    jp, tp = _params("madvr_like", wic_shadow_deblob_strength=0.4,
                     hdr_wic_yuv444_guide_cleanup=True)
    y, uv = _planes()
    crop = (0, 0, 256, 192)
    ref = _ref_render(_scene())[::2, ::2]
    want = _jax_render(y, uv, crop, jp, ref)
    got = TS.render_sdr_crop_from_p010(y, uv, crop, tp, ref)
    _le1(got, want)
    assert np.abs(got.astype(int)
                  - TS.render_sdr_crop_from_p010(y, uv, crop, tp)).max() > 1
    # a padded crop: the reference is padded by the same fraction
    out = TS.render_sdr_crop_from_p010(y, uv, (10, 6, 230, 190), tp, ref)
    assert out.shape == (184, 220, 3)
