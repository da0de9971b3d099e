"""HDR speckle diagnostics: the port's ``hdr/diagnostics.py`` against the
JAX package's on the same P010 crops, and the port's CLI with
``--set hdr_speckle_diag=true``.

Tolerances: the same report keys; the same ``speckle_pixels`` per variant;
every plane statistic and every diff within 1 LSB (the renders agree
within 1 LSB, as the stills do); the variant PNGs within 1 LSB.
"""

import csv
import json
import os

import cv2
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from person_capture_tpu.hdr.diagnostics import \
    run_speckle_diagnostics as jax_diag  # noqa: E402
from person_capture_tpu_torch.hdr.diagnostics import (  # noqa: E402
    DIAG_VARIANTS, run_speckle_diagnostics)
from person_capture_tpu_torch.hdr.stills import HdrExportParams  # noqa: E402


def _noisy(h=96, w=128, seed=0):
    """The JAX package's diagnostics fixture: mid-grey codes with chroma
    noise."""
    rng = np.random.default_rng(seed)
    y = (rng.integers(200, 800, (h, w)).astype(np.uint16) << 6)
    uv = np.full((h // 2, w // 2, 2), 512 << 6, np.uint16)
    uv[..., 1] += (rng.integers(-60, 60, uv.shape[:2]) << 6).astype(np.uint16)
    return y, uv


def _speckled(h=96, w=128, seed=1):
    """Dark codes with isolated bright, saturated chroma pixels: speckles
    for ``detect_speckles`` to count."""
    rng = np.random.default_rng(seed)
    y = (rng.integers(64, 200, (h, w)).astype(np.uint16) << 6)
    uv = np.full((h // 2, w // 2, 2), 512 << 6, np.uint16)
    ys, xs = rng.integers(2, h // 2 - 2, 40), rng.integers(2, w // 2 - 2, 40)
    uv[ys, xs, 0] = 960 << 6
    uv[ys, xs, 1] = 100 << 6
    y[2 * ys, 2 * xs] = 700 << 6
    return y, uv


def _within_lsb(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _within_lsb(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert got == want, path
    elif not path.endswith("wall_s"):
        assert abs(float(got) - float(want)) <= 1.0, (path, got, want)


@pytest.mark.parametrize("planes,crop", [(_noisy, (8, 8, 72, 72)),
                                         (_speckled, (4, 6, 120, 90))],
                         ids=["noisy", "speckled"])
def test_report_matches_jax(tmp_path, planes, crop):
    y, uv = planes()
    want = jax_diag(y, uv, crop, str(tmp_path / "jax"))
    got = run_speckle_diagnostics(y, uv, crop, str(tmp_path / "torch"),
                                  HdrExportParams(device="cpu"))
    assert set(got["variants"]) == {v["name"] for v in DIAG_VARIANTS}
    for name, v in want["variants"].items():
        assert got["variants"][name]["speckle_pixels"] == \
            v["speckle_pixels"], name
    if planes is _speckled:
        assert want["variants"]["bt2390_limited"]["speckle_pixels"] > 0
    _within_lsb(got, want)
    with open(tmp_path / "torch" / "speckle_diag.json") as fh:
        assert json.load(fh)["crop"] == list(crop)
    for v in DIAG_VARIANTS:
        a = cv2.imread(str(tmp_path / "torch" / f"diag_{v['name']}.png"))
        b = cv2.imread(str(tmp_path / "jax" / f"diag_{v['name']}.png"))
        assert a is not None and a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_cli_run_writes_one_report_per_still(tmp_path, monkeypatch):
    """The port's CLI with ``hdr_speckle_diag=true`` on a small PQ fixture
    with an in-memory P010 source at the analysis size: no refusal, one
    ``speckle_diag.json`` (5 variants) per still."""
    from person_capture_tpu_torch import main as M
    from person_capture_tpu_torch.hdr.exporter import ArrayP010Source
    from person_capture_tpu_torch.video.synthetic import (
        FacePlacement, draw_face, generate_video, p010_from_pq_bgr,
        write_pq_video)

    w, h, n = 160, 120, 40
    sdr, vid = str(tmp_path / "sdr.mp4"), str(tmp_path / "vid.mp4")
    generate_video(sdr, width=w, height=h, fps=30, total_frames=n,
                   segments=[(5, 18, 0), (24, 34, 0)], moving=True, seed=1)
    write_pq_video(sdr, vid)
    ref = np.full((200, 200, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (40, 40, 160, 160)))
    cv2.imwrite(str(tmp_path / "ref.png"), ref)
    planes = {}
    cap = cv2.VideoCapture(vid)
    for i in range(n):
        ok, frame = cap.read()
        assert ok
        planes[i] = p010_from_pq_bgr(frame)
    cap.release()

    monkeypatch.setenv("PERSON_CAPTURE_FORCE_HDR", "1")
    out = tmp_path / "out"
    argv = ["--video", vid, "--ref", str(tmp_path / "ref.png"),
            "--out", str(out), "--batch", "8", "--det-size", "160",
            "--prescan", "--device", "cpu", "--compute-dtype", "float32"]
    for s in ("prescan_cache_mode=off", "face_fullframe_imgsz=320",
              "compose_detect_person_for_face=false", "curate_enable=false",
              "hdr_sdr_quality=fast", "hdr_sdr_contrast_recovery=0",
              "hdr_speckle_diag=true"):
        argv += ["--set", s]
    ap = M.build_parser()
    args = ap.parse_args(argv)
    cfg = M.build_config(args, ap)
    eng = M.make_engine(cfg, M.build_runtime(cfg, args, ap),
                        status=lambda *a, **k: None)
    eng.hdr_source_factory = lambda *a: ArrayP010Source(planes, w, h)
    res = eng.run()
    assert res.ok, res.error
    with open(out / "index.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert rows
    diag = out / "hdr_speckle_diag"
    reports = sorted(os.listdir(diag))
    assert reports == sorted(os.path.splitext(r["crop_path"])[0]
                             for r in rows)
    for name in reports:
        with open(diag / name / "speckle_diag.json") as fh:
            report = json.load(fh)
        assert len(report["variants"]) == len(DIAG_VARIANTS) == 5
