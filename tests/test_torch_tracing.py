"""The port's own tracing: ``utils/timing.StepTimer``'s stages as
``torch.profiler`` ranges and its counters, the spans of a whole engine run
on the engine thread alone, and the benchmark's readers of them.

The engine run is one tiny SDR clip through the port's CLI runtime on the
CPU (bundled weights, one face slot, batch 4, every fourth frame, the
person detector at det 128, one torch thread), made twice per module: with
``tpu_profile`` under a CPU profiler, and without it. No JAX runs here.
"""

import csv
import json
import os
import threading

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from port_bench.probe import summed_stages  # noqa: E402
from port_bench.run import Bench  # noqa: E402
from port_bench.trace import Trace  # noqa: E402
from person_capture_tpu_torch.utils.timing import (  # noqa: E402
    NULL_TIMER, StepTimer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_METRICS = ("detect.device_s_per_video", "embed.device_s_per_video",
               "person.device_s_per_video", "nms.host_ms_per_frame",
               "prescan.refine_ms_per_frame",
               "main.rescue_ms_per_frame", "save.wait_ms_per_frame",
               "engine.fixed_s_per_video")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the Tier-1 command runs
    6 workers on the machine's cores, and these tiny CPU runs gain
    nothing from more threads but contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn, path):
    """Run ``fn`` under a CPU profiler; the threads of its ranges by name,
    read from the exported Chrome trace as the benchmark reads it."""
    from port_bench.trace import read
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    names = {}
    for name, _, _, tid in read(str(path)).ranges:
        names.setdefault(name, set()).add(tid)
    return out, names


# ---- StepTimer ------------------------------------------------------------

def test_stages_are_ranges_only_while_a_profiler_records(monkeypatch,
                                                         tmp_path):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    timer = StepTimer()
    with timer("outside"):
        pass
    assert opened == []

    def body():
        with timer("inside"):
            with timer("inner"):
                pass
        with NULL_TIMER("null"):
            pass

    _, names = _profiled(body, tmp_path / "trace.json")
    assert opened == ["inside", "inner"]
    assert "inside" in names and "inner" in names and "null" not in names
    assert set(timer.summary()) == {"outside", "inside", "inner"}


def test_null_timer_records_nothing():
    NULL_TIMER.count("embed.chips", 3)
    with NULL_TIMER("stage"):
        pass
    assert NULL_TIMER.summary() == {} and NULL_TIMER.counters() == {}
    assert NULL_TIMER.report() == ""
    assert not hasattr(NULL_TIMER, "add") and not hasattr(StepTimer, "add")


def test_counters_add_up_apart_from_the_stages():
    timer = StepTimer()
    timer.count("embed.chips", 1024)
    timer.count("embed.chips", np.int64(8))
    timer.count("embed.chips_kept", np.bool_(True))
    with timer("main.decode"):
        pass
    with timer("main.decode"):
        pass
    assert timer.counters() == {"embed.chips": 1032, "embed.chips_kept": 1}
    s = timer.summary()
    assert set(s) == {"main.decode"}
    assert set(s["main.decode"]) == {"total_s", "count", "mean_ms"}
    assert s["main.decode"]["count"] == 2
    assert summed_stages([s, s]) == {"main.decode":
                                     2 * s["main.decode"]["total_s"]}
    assert "embed.chips" in timer.report()


def test_other_threads_record_nothing(tmp_path):
    timer = StepTimer()

    def worker():
        with timer("save.encode"):
            pass
        timer.count("embed.chips", 5)

    def body():
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()

    _, names = _profiled(body, tmp_path / "trace.json")
    assert "save.encode" not in names
    assert timer.summary() == {} and timer.counters() == {}


# ---- the face backend's counters -----------------------------------------

@pytest.fixture(scope="module")
def tiny_face():
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models import yolov8 as YV
    from person_capture_tpu_torch.pipeline.backends import (
        ScrfdArcFaceBackend, YoloPersonBackend)

    # a threshold below every score: every frame has faces to keep
    face = ScrfdArcFaceBackend(SD.TINY, AF.TINY, det_size=64, max_faces=4,
                               score_thresh=-1.0, embed_slots=3,
                               dtype=torch.float32, device="cpu")
    person = YoloPersonBackend(YV.TINY, det_size=64, max_det=4,
                               dtype=torch.float32, device="cpu")
    return face, person


def test_embed_counters_count_chips_and_kept_slots(tiny_face):
    face, person = tiny_face
    frames = np.random.default_rng(0).integers(0, 255, (3, 48, 64, 3),
                                               np.uint8)
    valid = np.array([True, True, False])
    timer = StepTimer()
    face.timer = person.timer = timer
    seen = []
    encode = face._encode
    face._encode = lambda chips: seen.append(int(chips.shape[0])) \
        or encode(chips)
    try:
        masks = [face.submit_batch(frames, valid)()["mask"],
                 face.extract_batch(frames[:1], np.ones(1, bool))["mask"],
                 face.submit_wire_with_person(person, frames,
                                              valid)()[0]["mask"]]
    finally:
        face.timer = person.timer = NULL_TIMER
        del face._encode
    c = timer.counters()
    # b·k slots offered a call (k = embed_slots), padding frames included
    assert c["embed.slots"] == (3 + 1 + 3) * 3
    # the tower runs the kept slots of valid frames, padded to a bucket
    assert c["embed.chips"] == sum(seen)
    assert c.get("embed.calls_skipped", 0) == 3 - len(seen)
    kept = sum(int(m.sum()) for m in masks)
    assert c["embed.chips_kept"] == kept
    assert 0 < kept <= (2 + 1 + 2) * 3
    assert not masks[0][2].any() and not masks[2][2].any()
    for stage in ("face.upload", "face.convert", "face.detect", "face.nms",
                  "face.align", "face.embed", "face.encode", "person.detect"):
        assert stage in timer.summary(), stage


def test_tower_span_is_innermost_in_the_benchmarks_wrap(tiny_face, tmp_path):
    """The benchmark wraps ``_encode`` in its ``pb.embed`` range: the
    port's ``face.encode`` opens inside it, so an idle gap in the tower
    call carries the port's name, and the wrap still sees every chip."""
    from port_bench.probe import EMBED_RANGE, Probe
    from port_bench.trace import read
    from torch.profiler import ProfilerActivity, profile

    face, _ = tiny_face
    frames = np.zeros((2, 48, 64, 3), np.uint8)
    probe = Probe([face], trace=True)
    seen = []
    wrapped = face._encode
    face._encode = lambda chips: seen.append(int(chips.shape[0])) \
        or wrapped(chips)
    timer = StepTimer()
    face.timer = timer
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            face.extract_batch(frames, np.ones(2, bool))
    finally:
        face.timer = NULL_TIMER
        del face._encode
        probe.close()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ranges = read(path).ranges
    outer = [(a, b) for n, a, b, _ in ranges if n == EMBED_RANGE]
    inner = [(a, b) for n, a, b, _ in ranges if n == "face.encode"]
    assert len(outer) == len(inner) == 1
    assert outer[0][0] <= inner[0][0] and inner[0][1] <= outer[0][1]
    assert seen == [2 * 3] == [timer.counters()["embed.chips"]]


# ---- a whole engine run ---------------------------------------------------

def _fixture(d):
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face,
                                                          generate_video)

    generate_video(str(d / "vid.mp4"), width=160, height=120, fps=30,
                   total_frames=40, segments=[(5, 18, 0), (24, 34, 0)],
                   moving=True, seed=1)
    ref = np.full((200, 200, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (40, 40, 160, 160)))
    cv2.imwrite(str(d / "ref.png"), ref)


def _config(d, out, profile: bool):
    from person_capture_tpu_torch import main as M

    argv = ["--video", str(d / "vid.mp4"), "--ref", str(d / "ref.png"),
            "--out", str(out), "--batch", "4", "--det-size", "128",
            "--prescan", "--device", "cpu", "--compute-dtype", "float32",
            "--set", "prescan_cache_mode=off",
            "--set", "face_fullframe_imgsz=256", "--set", "tpu_max_faces=1",
            "--set", "frame_stride=4", "--set", "prescan_refine_stride_min=4",
            "--set", f"tpu_profile={str(profile).lower()}"]
    ap = M.build_parser()
    args = ap.parse_args(argv)
    return M, ap, args, M.build_config(args, ap)


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """The clip run with ``tpu_profile`` under a CPU profiler, then without
    it, on one runtime; the first run's spy counts of the tower's chips and
    of the fetched kept slots."""
    d = tmp_path_factory.mktemp("tracing")
    _fixture(d)
    M, ap, args, cfg = _config(d, d / "on", True)
    runtime = M.build_runtime(cfg, args, ap)
    runtime["person"].det_size = 128
    inner = runtime["inner_face"]
    spy = {"chips": 0, "kept": 0}
    encode, submit = inner._encode, inner.submit_batch
    combined = inner.submit_wire_with_person

    def encoded(chips):
        spy["chips"] += int(chips.shape[0])
        return encode(chips)

    def fetched(fetch, face_of=lambda out: out):
        def fetch_and_count():
            out = fetch()
            spy["kept"] += int(face_of(out)["mask"].sum())
            return out
        return fetch_and_count

    inner._encode = encoded
    inner.submit_batch = lambda *a, **k: fetched(submit(*a, **k))
    inner.submit_wire_with_person = lambda *a, **k: fetched(
        combined(*a, **k), lambda out: out[0])
    eng = M.make_engine(cfg, runtime, status=lambda *a, **k: None)
    res, names = _profiled(eng.run, d / "trace.json")
    assert res.ok, res.error
    del inner._encode, inner.submit_batch, inner.submit_wire_with_person
    _, _, _, cfg_off = _config(d, d / "off", False)
    eng_off = M.make_engine(cfg_off, runtime, status=lambda *a, **k: None)
    res_off = eng_off.run()
    assert res_off.ok, res_off.error
    return {"dir": d, "engine": eng, "names": names, "spy": spy,
            "runtime": runtime, "engine_off": eng_off,
            "thread": threading.get_ident()}


def test_engine_run_opens_the_port_spans(engine_runs):
    names = engine_runs["names"]
    for span in ("engine.run", "prescan.phase", "main.phase", "curate.phase",
                 "face.detect", "face.embed", "face.encode", "face.nms",
                 "prescan.refine",
                 "prescan.refine_decode", "prescan.refine_fetch",
                 "save.drain", "person.detect", "engine.seed_bank",
                 "engine.open", "main.roi_rescue", "main.fullframe_rescue",
                 "curate.describe", "curate.write", "prescan.decode",
                 "main.device_fetch"):
        assert span in names, span
    stages = engine_runs["engine"]._timer.summary()
    assert all(n in names for n in stages)


def test_spans_open_on_the_engine_thread_alone(engine_runs):
    """The saver's workers and the decode pool open no span: every stage
    range is on the thread that called ``Engine.run``."""
    names = engine_runs["names"]
    stages = engine_runs["engine"]._timer.summary()
    threads = set().union(*(names[n] for n in stages))
    assert len(threads) == 1, {n: names[n] for n in stages}


def test_engine_counts_every_chip_the_tower_embeds(engine_runs):
    c = engine_runs["engine"]._timer.counters()
    spy = engine_runs["spy"]
    assert c["embed.chips"] == spy["chips"] > 0
    assert c["embed.chips_kept"] == spy["kept"]
    assert 0 < c["embed.chips_kept"] <= c["embed.chips"]


def test_engine_gives_the_backends_their_timer_back(engine_runs):
    rt = engine_runs["runtime"]
    for b in (rt["inner_face"], rt["person"], rt["fullframe"]):
        assert b.timer is NULL_TIMER
    assert engine_runs["engine_off"]._timer is None


def _files(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            if f in ("metrics.json", "metrics_v2.json"):
                continue                      # they hold the curator's wall
            with open(p, "rb") as fh:
                # the curator's debug table names each crop by its path
                out[os.path.relpath(p, root)] = fh.read().replace(
                    str(root).encode(), b"OUT")
    return out


def test_outputs_do_not_depend_on_the_profile(engine_runs):
    d = engine_runs["dir"]
    on, off = _files(d / "on"), _files(d / "off")
    assert on == off
    with open(d / "on" / "index.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert rows and "dataset_out/selection_debug.csv" in on
    for name in ("metrics.json", "metrics_v2.json"):
        with open(d / "on" / "dataset_out" / name) as a, \
                open(d / "off" / "dataset_out" / name) as b:
            ja, jb = json.load(a), json.load(b)
        ja.pop("wall_s"), jb.pop("wall_s")
        assert ja == jb, name


def test_status_stream_reports_stages_and_counters(engine_runs):
    report = engine_runs["engine"]._timer.report()
    for line in ("engine.run", "curate.phase", "embed.chips_kept"):
        assert line in report, line


# ---- the benchmark's readers ----------------------------------------------

def _ctx(**kw):
    ctx = {"config": {}, "timed": [], "timed_s": 0.0, "frames": 0,
           "stages": {}, "curate_s": [], "det_frames": {},
           "kept": {}, "person_frames": 0, "trace": None,
           "device_name": "cpu"}
    ctx.update(kw)
    return ctx


@pytest.fixture(scope="module")
def bench():
    return Bench.load(os.path.join(REPO, "BENCHMARK.json"))


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_finds_nothing_without_its_spans(bench, name):
    entry = next(m for m in bench.manifest["per_layer"] if m["name"] == name)
    assert entry["moves"] == "src_fps" and "workloads" not in entry
    read = bench.reader(name)
    assert read(_ctx()) is None
    parent = _ctx(timed=[1, 2], frames=900, timed_s=20.0,
                  stages={"main.decode": 1.0, "prescan.decode": 1.0},
                  trace=Trace(window_s=1.0, busy_s=0.5))
    assert read(parent) is None


def _trace():
    """Ranges on thread 1: face.detect [0, 10] holding face.nms [4, 6],
    face.embed [20, 30], person.detect [40, 50]; one kernel launched in
    each (and one outside them all), µs."""
    tr = Trace(window_s=1.0, busy_s=0.5)
    tr.ranges += [("face.detect", 0.0, 10.0, 1), ("face.nms", 4.0, 6.0, 1),
                  ("face.embed", 20.0, 30.0, 1),
                  ("person.detect", 40.0, 50.0, 1)]
    tr.launches.update({1: (5.0, 1), 2: (25.0, 1), 3: (45.0, 1),
                        4: (60.0, 1), 5: (25.0, 2)})
    tr.device += [("conv", 100.0, 1100.0, 1), ("gemm", 1200.0, 4200.0, 2),
                  ("yolo", 4300.0, 4800.0, 3), ("copy", 5000.0, 9000.0, 4),
                  ("other thread", 9000.0, 9900.0, 5)]
    return tr


@pytest.mark.parametrize("name,want", [
    ("detect.device_s_per_video", 1e-3),
    ("embed.device_s_per_video", 3e-3),
    ("person.device_s_per_video", 5e-4)])
def test_device_time_readers(bench, name, want):
    assert bench.reader(name)(_ctx(trace=_trace())) == pytest.approx(want)


def test_span_readers(bench):
    stages = {"face.nms": 0.9, "prescan.refine": 1.8, "main.roi_rescue": 0.3,
              "main.fullframe_rescue": 0.06, "save.drain": 0.45,
              "save.put_wait": 0.09, "engine.run": 30.0,
              "prescan.phase": 12.0, "main.phase": 9.0, "curate.phase": 3.0}
    ctx = _ctx(timed=[1, 2, 3], frames=2700, stages=stages)
    want = {"nms.host_ms_per_frame": 900 / 2700,
            "prescan.refine_ms_per_frame": 1800 / 2700,
            "main.rescue_ms_per_frame": 360 / 2700,
            "save.wait_ms_per_frame": 540 / 2700,
            "engine.fixed_s_per_video": 2.0}
    for name, value in want.items():
        assert bench.reader(name)(ctx) == pytest.approx(value), name
    # a run with no main pass: the rescues read 0
    ctx = _ctx(timed=[1], frames=900,
               stages={"main.fullframe_rescue": 0.0, "save.drain": 0.01,
                       "engine.run": 5.0, "prescan.phase": 4.0})
    assert bench.reader("main.rescue_ms_per_frame")(ctx) == 0.0
    assert bench.reader("engine.fixed_s_per_video")(ctx) == 1.0
