"""The slice's new paths through both CLIs: the JAX package's pipeline and
the torch port's on ``test_torch_slice``'s fixtures must pick the same
frames — at the CLI defaults with curation on (and the same curated
``dataset_out/``), with ReID (``--match-mode either``, bundled
``clip_reid_s``), with the CLIP-face embedder (``use_arcface=false``), and
with the YOLOv8-face detector.

Both run ``build_config`` → ``build_runtime`` → ``make_engine`` → ``run``
on the CPU in fp32 with the bundled weights, on the fixtures' SDR video:
the crops are then cut from the same decoded frames in both packages, so
the curator sees the same pool. ReID towers and person detectors default
to bf16 whatever ``--compute-dtype`` says; these runs hold them in fp32.
The CLIP-face tower starts at random init in both packages, each from its
own generator; the port's takes the JAX backend's variables through the
``runtime_hook``. Tolerance: identical ``index.csv`` frames and crop boxes,
identical ``dataset_out/`` file lists.

Each mode's pair of runs is made once, on first use, and its outputs are
checked by the tests below one property at a time. The four modes stay in
one file, run one after another: two such files on two workers at once
slow each other down more than they gain, since each JAX run already
keeps the CPU's cores busy.
"""

import csv
import os

import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu import main as JM  # noqa: E402
from person_capture_tpu.pipeline import backends as JB  # noqa: E402
from person_capture_tpu_torch import main as TM  # noqa: E402
from person_capture_tpu_torch.pipeline import backends as TB  # noqa: E402
from test_torch_slice import (DET, H, W, _float32_default,  # noqa: E402
                              _make_fixture)

BODY_DET = 2 * DET
KEYS = ("frame", "x1", "y1", "x2", "y2")
EITHER = ("--match-mode", "either")
MODES = ("defaults", "reid_either", "clip_face", "yolov8_face")
CURATING = ("defaults", "reid_either")
IMAGE_EXTS = (".png", ".jpg")


def _argv(d, out, sets, extra, det):
    argv = ["--video", str(d / "sdr.mp4"), "--ref", str(d / "ref.png"),
            "--out", str(out), "--batch", "8", "--det-size", str(det),
            "--prescan", "--device", "cpu", "--compute-dtype", "float32",
            "--set", "prescan_cache_mode=off",
            "--set", f"face_fullframe_imgsz={2 * det}", *extra]
    for s in sets:
        argv += ["--set", s]
    return argv


def _config(M, d, out, sets=(), extra=(), det=DET):
    ap = M.build_parser()
    args = ap.parse_args(_argv(d, out, sets, extra, det))
    return ap, args, M.build_config(args, ap)


def _run(M, d, out, sets=(), extra=(), runtime_hook=None, det=DET,
         runtime=None):
    """One CLI run → ``(index rows, dataset_out/ files or None, crops)``;
    ``runtime`` reuses backends built for another run of the same models
    (as a sweep over videos does)."""
    ap, args, cfg = _config(M, d, out, sets, extra, det)
    if runtime is None:
        runtime = M.build_runtime(cfg, args, ap)
    elif runtime["reid"] is not None:
        cfg.disable_reid = False       # what build_runtime sets for ReID
    if runtime_hook is not None:
        runtime_hook(runtime)
    res = M.make_engine(cfg, runtime, status=lambda *a, **k: None).run()
    assert res.ok, res.error
    with open(os.path.join(out, "index.csv")) as fh:
        rows = [[r[k] for k in KEYS] for r in csv.DictReader(fh)]
    curated = os.path.join(out, "dataset_out")
    files = sorted(os.listdir(curated)) if os.path.isdir(curated) else None
    return rows, files, sorted(os.listdir(os.path.join(out, "crops")))


def _defaults(body_fixture, jax_runtime, d):
    """The command a user types: curation on, so the run ends with the
    curator over its crops."""
    src, sv, _ = body_fixture
    with pytest.MonkeyPatch.context() as mp:
        _float32_default(mp, TB.YoloPersonBackend, torch.float32)
        want = _run(JM, src, d / "jax", det=BODY_DET,
                    runtime={**jax_runtime, "reid": None})
        got = _run(TM, src, d / "torch", det=BODY_DET)
    return dict(want=want, got=got, sv=sv)


def _reid_either(body_fixture, jax_runtime, d):
    """``--match-mode either`` builds the person detector and the bundled
    ReID tower, and the curator describes the pool with that tower."""
    src, sv, _ = body_fixture
    seen = {"calls": []}

    def spy(runtime):
        reid = runtime["reid"]
        seen.update(dtype=reid.dtype, embed_dim=reid.embed_dim)
        extract = reid.extract

        def counted(crops):
            seen["calls"].append(len(crops))
            return extract(crops)

        reid.extract = counted

    want = _run(JM, src, d / "jax", extra=EITHER, det=BODY_DET,
                runtime=jax_runtime)
    with pytest.MonkeyPatch.context() as mp:
        _float32_default(mp, TB.YoloPersonBackend, torch.float32)
        _float32_default(mp, TB.ClipReidBackend, torch.float32)
        got = _run(TM, src, d / "torch", extra=EITHER, runtime_hook=spy,
                   det=BODY_DET)
    return dict(want=want, got=got, sv=sv, reid=seen)


def _clip_face(fixture, d):
    """``use_arcface=false``: a CLIP tower embeds the face chips; the port's
    primary and full-frame backends take the JAX backend's variables."""
    from person_capture_tpu_torch.models.bridge import load_clip

    src, sv, _ = fixture
    sets = ("use_arcface=false", "clip_face_backbone=clip_tiny",
            "curate_enable=false", "compose_detect_person_for_face=false")
    seen = {}

    def keep_vars(runtime):
        seen["vars"] = runtime["inner_face"].clip_vars
        seen["jax_embed_dim"] = runtime["inner_face"].embed_dim

    def bridge(runtime):
        face = runtime["inner_face"]
        seen.update(embed_dim=face.embed_dim,
                    clip=face.clip_model is not None,
                    arcface=face.arcface_model is not None)
        load_clip(face.clip_model, seen["vars"])
        lazy = runtime["fullframe"]
        build = lazy._factory

        def bridged():
            b = build()
            load_clip(b.clip_model, seen["vars"])
            return b

        object.__setattr__(lazy, "_factory", bridged)

    want = _run(JM, src, d / "jax", sets, runtime_hook=keep_vars)
    got = _run(TM, src, d / "torch", sets, runtime_hook=bridge)
    return dict(want=want, got=got, sv=sv, face=seen)


def _yolov8_face(fixture, d):
    """``--face-model yolov8n-face``: the bundled YOLOv8-face weights in the
    face backend, with the ±45/±135° probes of the recovery ladder."""
    src, sv, _ = fixture
    sets = ("curate_enable=false", "compose_detect_person_for_face=false")
    extra = ("--face-model", "yolov8n-face", "--face-det-conf", "0.3")
    return dict(want=_run(JM, src, d / "jax", sets, extra),
                got=_run(TM, src, d / "torch", sets, extra), sv=sv)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return _make_fixture(tmp_path_factory.mktemp("curate_slice"))


@pytest.fixture(scope="module")
def body_fixture(tmp_path_factory):
    return _make_fixture(tmp_path_factory.mktemp("curate_defaults"),
                         face_px=24, w=2 * W, h=2 * H)


@pytest.fixture(scope="module")
def jax_body_runtime(body_fixture, tmp_path_factory):
    """The JAX package's runtime for ``--match-mode either`` on the body
    fixture, built once: the defaults run takes the same backends without
    the ReID tower (the runtime ``build_runtime`` returns at the defaults,
    whose programs then need no second compile)."""
    d = body_fixture[0]
    ap, args, cfg = _config(JM, d, tmp_path_factory.mktemp("unused"),
                            extra=EITHER, det=BODY_DET)
    with pytest.MonkeyPatch.context() as mp:
        _float32_default(mp, JB.YoloPersonBackend, jnp.float32)
        _float32_default(mp, JB.ClipReidBackend, jnp.float32)
        return JM.build_runtime(cfg, args, ap)


@pytest.fixture(scope="module")
def runs(fixture, body_fixture, jax_body_runtime, tmp_path_factory):
    """``runs(mode)``: both CLIs' outputs for one mode, made on first use."""
    made = {}
    makers = {
        "defaults": lambda d: _defaults(body_fixture, jax_body_runtime, d),
        "reid_either": lambda d: _reid_either(body_fixture, jax_body_runtime,
                                              d),
        "clip_face": lambda d: _clip_face(fixture, d),
        "yolov8_face": lambda d: _yolov8_face(fixture, d)}

    def get(mode):
        if mode not in made:
            made[mode] = makers[mode](tmp_path_factory.mktemp(mode))
        return made[mode]

    return get


@pytest.mark.parametrize("mode", MODES)
def test_index_frames_match_jax(runs, mode):
    r = runs(mode)
    assert [row[0] for row in r["got"][0]] == [row[0] for row in r["want"][0]]


@pytest.mark.parametrize("mode", MODES)
def test_crop_boxes_match_jax(runs, mode):
    r = runs(mode)
    assert r["got"][0] == r["want"][0]


@pytest.mark.parametrize("mode", MODES)
def test_hits_inside_truth(runs, mode):
    r = runs(mode)
    truth = r["sv"].identity_spans(0)
    frames = [int(row[0]) for row in r["got"][0]]
    assert frames and all(any(s <= f <= e for s, e in truth)
                          for f in frames)


@pytest.mark.parametrize("mode", CURATING)
def test_dataset_out_matches_jax(runs, mode):
    r = runs(mode)
    assert r["got"][1] is not None and r["got"][1] == r["want"][1]


@pytest.mark.parametrize("mode", CURATING)
def test_dataset_out_is_a_curated_set(runs, mode):
    """metrics.json, selection_debug.csv and 1 to min(200, crops) images,
    each one of the run's crops."""
    rows, files, crops = runs(mode)["got"]
    assert "metrics.json" in files and "selection_debug.csv" in files
    picked = [f for f in files if f.endswith(IMAGE_EXTS)]
    assert 1 <= len(picked) <= min(200, len(rows))
    assert set(picked) <= set(crops)


def test_reid_tower_embeds_in_the_run(runs):
    """The bundled clip_reid_s tower, held in fp32, embeds crops during the
    ``--match-mode either`` run."""
    reid = runs("reid_either")["reid"]
    assert reid["dtype"] == torch.float32 and reid["embed_dim"] == 128
    assert reid["calls"], "the ReID tower was never called"


def test_clip_face_embeds_with_the_clip_tower(runs):
    face = runs("clip_face")["face"]
    assert face["embed_dim"] == face["jax_embed_dim"] == 16
    assert face["clip"] and not face["arcface"]
