"""Torch port of the HDR preview held to the JAX package.

``tonemap_preview_frame`` on the same seeded P010 planes through both
packages (≤ 1 LSB: one rounding step of the 8-bit output), and the port's
``Engine`` with ``on_preview`` on an HDR source, modelled on
tests/test_preview.py: previews come from a dedicated P010 source through
the tone-map, equal to ``tonemap_preview_frame`` on their planes; a render
error fails the run; only missing planes fall back to the analysis frame.
The engine runs take the port's ``OracleBackend`` (numpy ground truth):
it stands in for the face models, which play no part here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from person_capture_tpu import hdr_preview as JP  # noqa: E402
from person_capture_tpu_torch import hdr_preview as TP  # noqa: E402
from person_capture_tpu_torch.config import SessionConfig  # noqa: E402
from person_capture_tpu_torch.core.bank import RefBank  # noqa: E402
from person_capture_tpu_torch.hdr.exporter import ArrayP010Source  # noqa: E402
from person_capture_tpu_torch.pipeline.backends import \
    OracleBackend  # noqa: E402
from person_capture_tpu_torch.pipeline.engine import Engine  # noqa: E402
from person_capture_tpu_torch.video.synthetic import \
    generate_video  # noqa: E402


def _p010(h, w, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(64, 941, (h, w)).astype(np.uint16) << 6
    uv = rng.integers(64, 961, (h // 2, w // 2, 2)).astype(np.uint16) << 6
    return y, uv


def test_passthrough_is_unavailable():
    assert TP.hdr_passthrough_available() is JP.hdr_passthrough_available()


@pytest.mark.parametrize("kw", [
    {"max_dim": 0}, {"max_dim": 64}, {"max_dim": 0, "tonemap": "hable"},
    {"max_dim": 0, "full_range": True, "sdr_nits": 203.0},
])
def test_tonemap_preview_frame_matches_jax(kw):
    y, uv = _p010(96, 128, seed=11)
    want = JP.tonemap_preview_frame(y, uv, **kw).astype(int)
    got = TP.tonemap_preview_frame(y, uv, device="cpu", **kw).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def _engine_run(tmp_path, monkeypatch, planes):
    sv = generate_video(str(tmp_path / "v.mp4"), width=160, height=120,
                        fps=30.0, total_frames=60, segments=[(5, 55, 0)])
    monkeypatch.setenv("PERSON_CAPTURE_FORCE_HDR", "1")
    made = []

    def factory(video, width, height, fps):
        src = ArrayP010Source(planes, width, height)
        made.append(src)
        return src

    backend = OracleBackend(sv)
    cfg = SessionConfig()
    cfg.device = "cpu"
    cfg.video = sv.path
    cfg.out_dir = str(tmp_path / "out")
    cfg.prescan_enable = False
    cfg.curate_enable = False
    cfg.frame_stride = 2
    cfg.tpu_batch_frames = 8
    cfg.min_gap_sec = 0.3
    cfg.min_box_pixels = 50
    cfg.face_quality_min = 0.0
    cfg.min_sharpness = 0.0
    cfg.preview_every = 5
    cfg.preview_fps_cap = 0
    cfg.preview_max_dim = 100
    cfg.hdr_sdr_quality = "fast"
    cfg.hdr_sdr_contrast_recovery = 0.0

    bank = RefBank(cap=8)
    bank.seed([backend.identity_feat(0)])
    previews = []
    eng = Engine(cfg, backend,
                 on_preview=lambda img, i: previews.append((i, img)),
                 hdr_source_factory=factory)
    return eng.run(bank=bank), previews, made


def _frame_planes(n=60, h=120, w=160):
    planes = {}
    for i in range(n):
        y = np.full((h, w), (300 + 5 * i) << 6, np.uint16)
        uv = np.full((h // 2, w // 2, 2), 512 << 6, np.uint16)
        planes[i] = (y, uv)
    return planes


def test_engine_hdr_preview_pump(tmp_path, monkeypatch):
    planes = _frame_planes()
    res, previews, made = _engine_run(tmp_path, monkeypatch, planes)
    assert res.ok, res.error
    assert previews, "HDR run emitted no previews"
    # one source for the exporter, one for the preview pump
    assert len(made) == 2
    idx, img = previews[0]
    assert max(img.shape[:2]) <= 100
    expect = TP.tonemap_preview_frame(planes[idx][0], planes[idx][1],
                                      max_dim=100, device="cpu")
    np.testing.assert_array_equal(img, expect)


def test_pump_render_error_fails_the_run(tmp_path, monkeypatch):
    """A render that raises (a kernel that does not build or launch) ends
    the run with that error; no analysis frame is shown in its place."""
    def broken(*args, **kwargs):
        raise RuntimeError("tone-map kernel launch failed: cudaError 98")

    monkeypatch.setattr(TP, "tonemap_preview_frame", broken)
    res, previews, _ = _engine_run(tmp_path, monkeypatch, _frame_planes())
    assert not res.ok
    assert "cudaError 98" in str(res.error)
    assert previews == []


def test_pump_shows_the_analysis_frame_without_planes(tmp_path, monkeypatch):
    """Planes the source does not have: the downscaled analysis frame."""
    res, previews, made = _engine_run(tmp_path, monkeypatch, {})
    assert res.ok, res.error
    assert previews and len(made) == 2
    for _, img in previews:
        assert img.shape == (75, 100, 3)  # 160x120 analysis frame, max 100
