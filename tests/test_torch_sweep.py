"""The port's batch-serving sweep (``person_capture_tpu_torch/sweep.py``)
and ``utils/device.py`` against the JAX package's.

Both sweeps run once over a 2-video corpus (128×128, 32 frames) with the
bundled ``scrfd_tiny`` + ``arcface_synth`` on the CPU: each video's
``index.csv`` frames and the summary counts must be the same, and the
port builds its runtime once. The host logic (corpus helpers, shards,
resume markers and the config fingerprint, watch mode, the settle guard,
backend retries and their backoff, the heartbeat, ``classify_error`` with
the CUDA runtime's strings) runs on stub runtimes through both sweeps as
parametrised cases, with the same expectations for each.
"""

import csv
import json
import os
import threading
import time
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import person_capture_tpu.main as JM  # noqa: E402
import person_capture_tpu_torch.main as TM  # noqa: E402
from person_capture_tpu import sweep as JSW  # noqa: E402
from person_capture_tpu.utils import device as JD  # noqa: E402
from person_capture_tpu_torch import sweep as TSW  # noqa: E402
from person_capture_tpu_torch.utils import device as TD  # noqa: E402
from person_capture_tpu_torch.video.synthetic import (  # noqa: E402
    FacePlacement, draw_face, generate_video)

SIDES = {"jax": (JSW, JM), "torch": (TSW, TM)}
TRUTH = {"one.mp4": (6, 22), "two.mp4": (10, 26)}
ARGS = ["--face-model", "scrfd_tiny", "--det-size", "128", "--batch", "8",
        "--compute-dtype", "float32", "--device", "cpu",
        "--set", "prescan_enable=false", "--set", "curate_enable=false",
        "--set", "prescan_cache_mode=off",
        "--set", "compose_detect_person_for_face=false"]


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """Both sweeps over one corpus; the port's twice (the second resumes)."""
    d = tmp_path_factory.mktemp("sweep")
    corpus = d / "corpus"
    corpus.mkdir()
    for name, span in TRUTH.items():
        generate_video(str(corpus / name), width=128, height=128, fps=30.0,
                       total_frames=32, segments=[(*span, 0)], moving=False)
    ref = np.full((128, 128, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (34, 30, 94, 90)))
    cv2.imwrite(str(d / "ref.png"), ref)
    builds = []
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        build = TM.build_runtime

        def counted(*a, **k):
            builds.append(1)
            return build(*a, **k)

        mp.setattr(TM, "build_runtime", counted)
        for side, (SW, _) in SIDES.items():
            root = str(d / f"out_{side}")
            argv = ["--videos", str(corpus), "--ref", str(d / "ref.png"),
                    "--out", root] + ARGS
            out[side] = (SW.main(argv), root, _summary(root))
        again = TSW.main(argv)
    return dict(out=out, builds=len(builds), again=again)


def _summary(root):
    with open(os.path.join(root, "sweep_summary.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("video", sorted(TRUTH))
def test_sweep_index_frames_match_jax(swept, video):
    frames = {}
    for side, (rc, root, _) in swept["out"].items():
        assert rc == 0
        stem = os.path.splitext(video)[0]
        with open(os.path.join(root, stem, "index.csv")) as fh:
            frames[side] = [int(r["frame"]) for r in csv.DictReader(fh)]
    assert frames["torch"] == frames["jax"]
    lo, hi = TRUTH[video]
    assert frames["torch"] and all(lo <= f <= hi for f in frames["torch"])


def test_sweep_summary_counts_match_jax(swept):
    keys = ("corpus", "processed", "failed", "resumed", "failed_video",
            "failed_backend")
    got, want = (swept["out"][s][2] for s in ("torch", "jax"))
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert [(r["hits"], r["spans"], r["ok"]) for r in got["results"]] == \
        [(r["hits"], r["spans"], r["ok"]) for r in want["results"]]


def test_sweep_builds_runtime_once_and_resumes(swept):
    assert swept["builds"] == 1       # the resumed run builds nothing
    assert swept["again"] == 0
    s = _summary(swept["out"]["torch"][1])
    assert s["resumed"] == s["processed"] == 2 and s["failed"] == 0


# ---------------------------------------------------------------------------
# host logic on stub runtimes, through both sweeps
# ---------------------------------------------------------------------------

def _stub(monkeypatch, M, errors=(), log=None):
    """Instant engines: the i-th run of a video fails with ``errors[i]``
    (leaving a crop behind, as a partial run would), then succeeds."""
    monkeypatch.setattr(M, "build_runtime", lambda cfg, args, ap: {})
    attempts = {}

    def make_engine(cfg_v, runtime, status=None, **kw):
        def run():
            i = attempts.get(cfg_v.video, 0)
            attempts[cfg_v.video] = i + 1
            if log is not None:
                log.append(cfg_v.video)
            crops = os.path.join(cfg_v.out_dir, "crops")
            os.makedirs(crops, exist_ok=True)
            with open(os.path.join(crops, f"attempt{i}.jpg"), "wb") as fh:
                fh.write(b"x")
            if i < len(errors):
                return SimpleNamespace(ok=False, error=errors[i], spans=[],
                                       mainpass=None)
            return SimpleNamespace(ok=True, error=None, spans=[(0, 1)],
                                   mainpass=SimpleNamespace(hits=[1, 2]))

        return SimpleNamespace(run=run)

    monkeypatch.setattr(M, "make_engine", make_engine)


def _corpus(tmp_path, names=("v.mp4",), age=60.0):
    corpus = tmp_path / "c"
    corpus.mkdir(exist_ok=True)
    old = time.time() - age
    for n in names:
        (corpus / n).write_bytes(b"x")
        os.utime(corpus / n, (old, old))
    ref = tmp_path / "ref.png"
    ref.write_bytes(b"x")
    return corpus, ref


def _base(tmp_path, corpus, ref):
    return ["--videos", str(corpus), "--ref", str(ref),
            "--out", str(tmp_path / "out"), "--device", "cpu"]


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("errors,retries_left,ok,kind,runs,probes", [
    (["XlaRuntimeError: FAILED_PRECONDITION: x", "RPC stream UNAVAILABLE"],
     3, True, None, 3, 2),
    (["FAILED_PRECONDITION"] * 10, 2, False, "backend", 3, 2),
    (["could not open video container"] * 5, 3, False, "video", 1, 0),
], ids=["retries_until_ok", "budget_exhausts", "video_never_retries"])
def test_backend_retries(tmp_path, monkeypatch, side, errors, retries_left,
                         ok, kind, runs, probes):
    SW, M = SIDES[side]
    corpus, ref = _corpus(tmp_path)
    log, probed = [], []
    _stub(monkeypatch, M, errors, log)
    monkeypatch.setattr(SW, "_probe_and_wait", lambda st: probed.append(1))
    rc = SW.main(_base(tmp_path, corpus, ref)
                 + ["--backend-max-retries", str(retries_left)])
    assert rc == (0 if ok else 1)
    assert len(log) == runs and len(probed) == probes
    r = _summary(str(tmp_path / "out"))["results"][0]
    assert r["ok"] is ok and r["error_kind"] == kind
    if ok:   # the aborted attempts' outputs were wiped
        assert sorted(os.listdir(os.path.join(r["out_dir"], "crops"))) == \
            [f"attempt{runs - 1}.jpg"]


@pytest.mark.parametrize("error", [
    "RuntimeError: CUDA error: device-side assert triggered",
    "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2 GiB",
    "RuntimeError: CUDA error: no kernel image is available for execution",
    "RuntimeError: CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm",
])
def test_cuda_failures_retry_then_record_backend(tmp_path, monkeypatch,
                                                 error):
    """A sticky CUDA error fails every in-process retry (the context stays
    poisoned): the video is recorded ``error_kind=backend`` once
    ``--backend-max-retries`` is used up."""
    corpus, ref = _corpus(tmp_path)
    log, probed = [], []
    _stub(monkeypatch, TM, [error] * 10, log)
    monkeypatch.setattr(TSW, "_probe_and_wait", lambda st: probed.append(1))
    rc = TSW.main(_base(tmp_path, corpus, ref)
                  + ["--backend-max-retries", "2"])
    assert rc == 1 and len(log) == 3 and len(probed) == 2
    s = _summary(str(tmp_path / "out"))
    assert s["failed_backend"] == 1 and s["failed_video"] == 0
    assert s["results"][0]["retries"] == 2


@pytest.mark.parametrize("side", SIDES)
def test_resume_and_fingerprint(tmp_path, monkeypatch, side):
    """A restarted sweep skips completed videos; ``--no-resume`` redoes
    them; a decision-transparent setting keeps the markers, a threshold
    change reprocesses."""
    SW, M = SIDES[side]
    corpus, ref = _corpus(tmp_path, ("a.mp4", "b.mp4"))
    log = []
    _stub(monkeypatch, M, (), log)
    base = _base(tmp_path, corpus, ref)
    assert SW.main(base) == 0 and len(log) == 2
    assert SW.main(base) == 0 and len(log) == 2
    assert _summary(str(tmp_path / "out"))["resumed"] == 2
    assert SW.main(base + ["--set", "tpu_decode_workers=3"]) == 0
    assert len(log) == 2
    assert SW.main(base + ["--face-thresh", "0.2"]) == 0 and len(log) == 4
    assert SW.main(base + ["--face-thresh", "0.2", "--no-resume"]) == 0
    assert len(log) == 6


@pytest.mark.parametrize("side", SIDES)
def test_continue_on_error_and_shards(tmp_path, monkeypatch, side):
    SW, M = SIDES[side]
    corpus, ref = _corpus(tmp_path, ("a.mp4", "b.mp4", "c.mp4"))
    monkeypatch.setattr(M, "build_runtime", lambda cfg, args, ap: {})

    def make_engine(cfg_v, runtime, status=None, **kw):
        bad = cfg_v.video.endswith("a.mp4")
        return SimpleNamespace(run=lambda: SimpleNamespace(
            ok=not bad, error="decode failed" if bad else None,
            spans=[(0, 1)], mainpass=SimpleNamespace(hits=[1])))

    monkeypatch.setattr(M, "make_engine", make_engine)
    base = _base(tmp_path, corpus, ref)
    assert SW.main(base) == 1
    assert _summary(str(tmp_path / "out"))["processed"] == 1
    assert SW.main(base + ["--continue-on-error", "--no-resume"]) == 1
    s = _summary(str(tmp_path / "out"))
    assert s["processed"] == 3 and s["failed"] == 1
    assert SW.main(base + ["--shard", "1/2", "--no-resume"]) == 0
    s = _summary(str(tmp_path / "out"))
    assert s["shard"] == "1/2" and [os.path.basename(r["video"])
                                    for r in s["results"]] == ["b.mp4"]


@pytest.mark.parametrize("side", SIDES)
def test_watch_picks_up_new_files_and_settles(tmp_path, monkeypatch, side):
    """Watch mode processes a settled arrival, defers a fresh file until it
    settles, and exits on idle; the heartbeat ends ``exited``."""
    SW, M = SIDES[side]
    corpus, ref = _corpus(tmp_path, ("a.mp4",))
    (corpus / "fresh.mp4").write_bytes(b"x")          # mtime now: deferred
    log = []
    _stub(monkeypatch, M, (), log)
    rc = {}
    th = threading.Thread(target=lambda: rc.update(rc=SW.main(
        _base(tmp_path, corpus, ref) + ["--watch", "0.3",
                                        "--watch-max-idle", "5"])))
    th.start()
    deadline = time.time() + 30
    while not log and time.time() < deadline:
        time.sleep(0.05)
    old = time.time() - 60
    (corpus / "b.mp4").write_bytes(b"x")
    os.utime(corpus / "b.mp4", (old, old))
    th.join(timeout=60)
    assert not th.is_alive() and rc["rc"] == 0
    assert sorted(os.path.basename(p) for p in log) == \
        ["a.mp4", "b.mp4", "fresh.mp4"]
    assert log[0].endswith("a.mp4")
    with open(tmp_path / "out" / "sweep_status.json") as fh:
        assert json.load(fh)["phase"] == "exited"


@pytest.mark.parametrize("side", SIDES)
def test_heartbeat_during_outage_probe(tmp_path, monkeypatch, side):
    SW, M = SIDES[side]
    corpus, ref = _corpus(tmp_path)
    _stub(monkeypatch, M, ["FAILED_PRECONDITION"])
    phases = []

    def probe(status):
        with open(tmp_path / "out" / "sweep_status.json") as fh:
            phases.append(json.load(fh)["phase"])
        status("device probe ok")

    monkeypatch.setattr(SW, "_probe_and_wait", probe)
    assert SW.main(_base(tmp_path, corpus, ref)) == 0
    assert phases and "outage" in phases[0]


@pytest.mark.parametrize("side", SIDES)
def test_sweep_rejects_video_flag(tmp_path, side):
    with pytest.raises(SystemExit):
        SIDES[side][0].main(["--videos", "x", "--video", "y", "--ref", "r",
                             "--out", str(tmp_path)])


@pytest.mark.parametrize("helper", ["expand", "shard_stable", "shard_slice",
                                    "out_dirs", "parse_shard"])
def test_corpus_helpers_match_jax(tmp_path, helper):
    d = tmp_path / "corpus"
    d.mkdir()
    for name in ("b.mp4", "a.mkv", "notes.txt", "C.MOV"):
        (d / name).write_bytes(b"x")
    vids = [str(tmp_path / f"v{i}.mp4") for i in range(11)]

    def run(SW):
        if helper == "expand":
            return SW.expand_videos([str(d), f"{d / 'b.mp4'};{d / 'a.mkv'}",
                                     str(d / "*.mp4")])
        if helper.startswith("shard"):
            return [SW.shard_select(vids, i, 3, stable=helper.endswith(
                "stable")) for i in range(3)]
        if helper == "out_dirs":
            return SW._unique_out_dirs(str(tmp_path), ["a/v.mp4", "b/v.mp4",
                                                       "c/w.mp4"])
        return [SW.parse_shard(s) for s in ("", "2/5", "0/1")]

    assert run(TSW) == run(JSW)


@pytest.mark.parametrize("text,kind", [
    ("XlaRuntimeError: FAILED_PRECONDITION: device in bad state", "backend"),
    ("RPC stream closed: UNAVAILABLE", "backend"),
    ("grpc channel reset by peer", "backend"),
    ("FileNotFoundError: no such video", "video"),
    ("cv2 could not decode frame 17", "video"),
    (None, "video"),
    ("", "video"),
    ("torch.OutOfMemoryError: CUDA out of memory.", "backend"),
    ("RuntimeError: CUDA error: device-side assert triggered", "backend"),
    ("RuntimeError: CUDA error: an illegal memory access was encountered",
     "backend"),
    ("cudaErrorLaunchFailure: unspecified launch failure", "backend"),
    ("RuntimeError: CUBLAS_STATUS_ALLOC_FAILED", "backend"),
    ("RuntimeError: cuDNN error: CUDNN_STATUS_INTERNAL_ERROR", "backend"),
    ("RuntimeError: no CUDA device is available", "backend"),
    ("RuntimeError: no kernel image is available for execution on the "
     "device", "backend"),
    ("ValueError: bad crop box", "video"),
])
def test_classify_error(text, kind):
    assert TD.classify_error(text) == kind
    if text is None or "CUDA" not in text and "cuda" not in text \
            and "CUBLAS" not in text and "kernel image" not in text:
        assert JD.classify_error(text) == kind     # the JAX vocabulary


def test_wait_for_device_backoff_and_deadline(monkeypatch):
    calls, sleeps = [], []
    monkeypatch.setattr(TD.time, "sleep", lambda s: sleeps.append(s))
    seq = iter([False, False, True])
    assert TD.wait_for_device(deadline_s=None, sleep_s=2.0,
                              probe=lambda b: (calls.append(b),
                                               next(seq))[1]) is True
    assert len(calls) == 3 and sleeps == [2.0, 4.0]
    assert all(b == TD._PROBE_BUDGET_S for b in calls)
    t = {"now": 0.0}
    monkeypatch.setattr(TD.time, "time", lambda: t["now"])
    monkeypatch.setattr(TD.time, "sleep",
                        lambda s: t.__setitem__("now", t["now"] + s))

    def never(budget):
        t["now"] += 100.0
        return False

    assert TD.wait_for_device(deadline_s=150.0, sleep_s=2.0,
                              probe=never) is False


def test_probe_device_once_on_the_cpu():
    """The probe runs in a subprocess on the device asked for: the CPU
    answers; ``cuda`` without a card does not."""
    import torch

    assert TD.probe_device_once(timeout_s=120.0, platform="cpu") is True
    if not torch.cuda.is_available():
        assert TD.probe_device_once(timeout_s=120.0) is False
