"""The bundled preset and the verify recipe's rotated twin through both CLIs.

- ``--preset presets/solidpreset_tpu.json`` (three ratios, pre-scan stride
  24 at width 416, ``min_gap_sec`` 1.5, colour-matched full-resolution
  stills) on ``test_torch_slice``'s body fixture, with its in-memory P010
  source: the same ``index.csv`` frames, crop boxes and ratios, and every
  still within 1 LSB of the JAX render run op by op (``jax.disable_jit``,
  as ``test_torch_slice`` explains). Curation is off here
  (``test_torch_slice_curate`` holds it), and ``--batch 8`` overrides the
  preset's 128, as a flag typed beside ``--preset`` does in both CLIs: the
  batch width changes no decision, and 128-frame batches of the JAX
  package's unoptimised CPU programs would cost minutes. The card runs the
  preset's own batch (``chip_smoke.py`` phase 18(c)).
- The rotated twin of the recipe (``np.rot90(frame, 3)`` of every frame of
  ``test_torch_slice``'s SDR fixture, written as a portrait video): the
  same frames and crop boxes in both CLIs, and the frames of the port's
  upright run.

Both run ``build_config`` → ``build_runtime`` → ``make_engine`` → ``run``
on the CPU in fp32 with the bundled weights.
"""

import csv
import json
import os

import cv2
import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu import main as JM  # noqa: E402
from person_capture_tpu.hdr.exporter import \
    ArrayP010Source as JArraySource  # noqa: E402
from person_capture_tpu_torch import main as TM  # noqa: E402
from person_capture_tpu_torch.hdr.exporter import \
    ArrayP010Source as TArraySource  # noqa: E402
from test_torch_slice import DET, H, W, _float32_default, \
    _make_fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = os.path.join(REPO, "presets", "solidpreset_tpu.json")
RATIOS = ("1:1", "2:3", "3:4")
KEYS = ("frame", "x1", "y1", "x2", "y2", "ratio")
BODY_DET = 2 * DET
TWIN_SETS = ("curate_enable=false", "compose_detect_person_for_face=false")


def _index(out) -> list:
    with open(os.path.join(out, "index.csv")) as fh:
        return list(csv.DictReader(fh))


def _cli(M, argv, hook=None):
    """``build_config`` → ``build_runtime`` → ``make_engine`` → ``run``;
    ``hook(engine)`` before the run. Returns the config."""
    ap = M.build_parser()
    args = ap.parse_args(argv)
    cfg = M.build_config(args, ap)
    eng = M.make_engine(cfg, M.build_runtime(cfg, args, ap),
                        status=lambda *a, **k: None)
    if hook is not None:
        hook(eng)
    res = eng.run()
    assert res.ok, res.error
    return cfg


def _preset_argv(d, out):
    return ["--video", str(d / "vid.mp4"), "--ref", str(d / "ref.png"),
            "--out", str(out), "--preset", PRESET, "--batch", "8",
            "--det-size", str(BODY_DET), "--device", "cpu",
            "--compute-dtype", "float32",
            "--set", "prescan_cache_mode=off",
            "--set", f"face_fullframe_imgsz={2 * BODY_DET}",
            "--set", "curate_enable=false"]


@pytest.fixture(scope="module")
def preset_runs(tmp_path_factory):
    """The preset through both CLIs on the body fixture: ``(jax config,
    jax dir, torch config, torch dir, truth spans)``."""
    from person_capture_tpu.hdr import stills as JS
    from person_capture_tpu.pipeline import backends as JB
    from person_capture_tpu_torch.pipeline import backends as TB

    d, sv, planes = _make_fixture(tmp_path_factory.mktemp("preset"),
                                  face_px=24, w=2 * W, h=2 * H)
    jitted = JS._get_render_fn

    def op_by_op(params):
        fn = jitted(params)

        def run(*a):
            with jax.disable_jit():
                return fn(*a)

        return run

    def p010(source_cls):
        def hook(eng):
            eng.hdr_source_factory = lambda video, *_: source_cls(
                planes, 4 * W, 4 * H)
        return hook

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PERSON_CAPTURE_FORCE_HDR", "1")
        mp.setattr(JS, "_get_render_fn", op_by_op)
        _float32_default(mp, JB.YoloPersonBackend, jnp.float32)
        _float32_default(mp, TB.YoloPersonBackend, torch.float32)
        jcfg = _cli(JM, _preset_argv(d, d / "jax"), p010(JArraySource))
        tcfg = _cli(TM, _preset_argv(d, d / "torch"), p010(TArraySource))
    return jcfg, d / "jax", tcfg, d / "torch", sv.identity_spans(0)


def test_preset_reaches_both_configs(preset_runs):
    """Every field the preset names reaches both configs, but the batch
    and curation this run overrides."""
    jcfg, _, tcfg, _, _ = preset_runs
    with open(PRESET) as fh:
        preset = json.load(fh)
    overridden = {"tpu_batch_frames": 8, "curate_enable": False,
                  "tpu_compute_dtype": "float32"}
    for key, value in preset.items():
        want = overridden.get(key, value)
        assert getattr(jcfg, key) == getattr(tcfg, key) == want, key


def test_preset_frames_and_boxes_match_jax(preset_runs):
    _, jdir, _, tdir, truth = preset_runs
    want, got = _index(jdir), _index(tdir)
    assert [[r[k] for k in KEYS] for r in got] == \
        [[r[k] for k in KEYS] for r in want]
    frames = [int(r["frame"]) for r in got]
    assert frames and all(any(s <= f <= e for s, e in truth)
                          for f in frames)


def test_preset_crops_keep_their_ratio(preset_runs):
    """Every crop is one of the preset's ratios within 1 px, in both CLIs
    (``test_preset_frames_and_boxes_match_jax`` holds the choices
    equal)."""
    _, jdir, _, tdir, _ = preset_runs
    for out in (jdir, tdir):
        rows = _index(out)
        assert rows
        for r in rows:
            assert r["ratio"] in RATIOS
            rw, rh = (float(v) for v in r["ratio"].split(":"))
            w = int(r["x2"]) - int(r["x1"])
            h = int(r["y2"]) - int(r["y1"])
            assert min(abs(w - h * rw / rh), abs(h - w * rh / rw)) <= 1.0


def test_preset_stills_within_one_lsb(preset_runs):
    _, jdir, _, tdir, _ = preset_runs
    rows = list(zip(_index(tdir), _index(jdir)))
    assert rows
    for gr, wr in rows:
        a = cv2.imread(str(tdir / "crops" / gr["crop_path"]))
        b = cv2.imread(str(jdir / "crops" / wr["crop_path"]))
        assert a is not None and b is not None and a.shape == b.shape
        # full resolution: the still is cut from the 2× P010 source
        assert a.shape[0] >= 2 * (int(gr["y2"]) - int(gr["y1"])) - 4
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _rotate(src: str, dst: str) -> str:
    cap = cv2.VideoCapture(src)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(dst, cv2.VideoWriter_fourcc(*"mp4v"),
                             cap.get(cv2.CAP_PROP_FPS), (h, w))
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        writer.write(np.ascontiguousarray(np.rot90(frame, 3)))
    writer.release()
    cap.release()
    return dst


def _twin_argv(d, video, out):
    argv = ["--video", video, "--ref", str(d / "ref.png"), "--out",
            str(out), "--batch", "8", "--det-size", str(DET), "--prescan",
            "--device", "cpu", "--compute-dtype", "float32",
            "--set", "prescan_cache_mode=off",
            "--set", f"face_fullframe_imgsz={2 * DET}"]
    for s in TWIN_SETS:
        argv += ["--set", s]
    return argv


@pytest.fixture(scope="module")
def twin_runs(tmp_path_factory):
    """The rotated twin through both CLIs and the upright SDR video through
    the port's: ``{name: index rows}`` and the truth spans."""
    d, sv, _ = _make_fixture(tmp_path_factory.mktemp("twin"))
    upright = str(d / "sdr.mp4")
    rotated = _rotate(upright, str(d / "rot.mp4"))
    cap = cv2.VideoCapture(rotated)
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (H, W)
    cap.release()
    rows = {}
    for name, M, video in (("jax", JM, rotated), ("torch", TM, rotated),
                           ("upright", TM, upright)):
        _cli(M, _twin_argv(d, video, d / name))
        rows[name] = _index(d / name)
    return rows, sv.identity_spans(0)


def test_rotated_twin_matches_jax(twin_runs):
    rows, truth = twin_runs
    keys = ("frame", "x1", "y1", "x2", "y2")
    assert [[r[k] for k in keys] for r in rows["torch"]] == \
        [[r[k] for k in keys] for r in rows["jax"]]
    frames = [int(r["frame"]) for r in rows["torch"]]
    assert all(any(s <= f <= e for f in frames) for s, e in truth)


def test_rotated_twin_matches_upright(twin_runs):
    rows, _ = twin_runs
    assert [r["frame"] for r in rows["torch"]] == \
        [r["frame"] for r in rows["upright"]]
