"""BENCHMARK.json against the contract's form, and the harness finding
configurations, mixes and metrics by name."""

import json
import os
import re

import pytest

from port_bench.run import Bench

from .conftest import PKG, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units(manifest):
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[kind]]
        assert len(names) == len(set(names)), kind
        assert all(NAME.match(n) for n in names), names
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200


def test_bounds_and_length(manifest):
    assert 1 <= manifest["run_seconds"] <= 51
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


def test_every_cell_reports_what_its_metrics_move(manifest):
    bench = Bench(manifest)
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for cell in manifest["workloads"]:
        reported = {m["name"] for m in manifest["end_to_end"]
                    if bench.reports(m, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in manifest["per_layer"] if bench.reports(m, cell)]
        assert layers, cell["name"]
        for m in layers:
            assert m["moves"] in e2e and m["moves"] in reported


def test_files_are_found_by_name(manifest):
    bench = Bench(manifest)
    assert manifest["paths"] == ["port_bench"]
    for c in manifest["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert bench.config(c["name"])["name"] == c["name"]
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        bench.config(w["config"])
        assert bench.traffic(w["traffic"])["frames"] > 0
    for m in manifest["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_readers_find_nothing_in_an_empty_run(manifest):
    """A reader with nothing to read returns None, never 0."""
    bench = Bench(manifest)
    conf = bench.config(manifest["workloads"][0]["config"])
    ctx = {"config": conf, "timed": [], "timed_s": 0.0, "frames": 0,
           "stages": {}, "curate_s": [], "det_frames": {}, "kept": {},
           "person_frames": 0, "trace": None, "device_name": "cpu"}
    for m in manifest["per_layer"]:
        assert bench.reader(m["name"])(ctx) is None, m["name"]


def test_a_mix_is_added_as_a_file(tmp_path, manifest):
    """A new traffic mix and a cell that uses it need no edit of any file
    that is there: the harness finds the mix by its name."""
    import shutil

    from port_bench import traffic

    base = tmp_path / "bench"
    shutil.copytree(PKG, base, ignore=shutil.ignore_patterns("tests",
                                                             "__pycache__"))
    before = {p: (base / p).read_bytes() for p in
              ("configs/scrfd_arcface_yolov8n.json",
               "traffic/sdr1080_dense.json")}
    mix = json.loads((base / "traffic/sdr1080_dense.json").read_text())
    mix["cast"][0]["spans"] = [200, 120]
    mix["gaps"] = [24, 48, 28]
    (base / "traffic/sdr1080_twospans.json").write_text(json.dumps(mix))
    m = dict(manifest, workloads=manifest["workloads"] + [
        {"name": "arcface.sdr1080_twospans",
         "config": "scrfd_arcface_yolov8n", "traffic": "sdr1080_twospans",
         "chips": 1, "why": "two long spans"}])
    bench = Bench(m, str(base))
    cell = bench.cell("arcface.sdr1080_twospans")
    got = bench.traffic(cell["traffic"])
    segs, _ = traffic.schedule(got, 2**31 + 5)
    assert sorted(e - s + 1 for s, e, i, _ in segs if i == 0) == [120, 200]
    assert all((base / p).read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("name", ["scrfd_arcface_yolov8n",
                                  "scrfd_clipface_vitl14"])
def test_config_limits_cover_every_number(name):
    from port_bench.check import GAPS
    from port_bench.run import EXACT

    with open(os.path.join(PKG, "configs", f"{name}.json")) as fh:
        conf = json.load(fh)
    limits = conf["check"]["limits"]
    layer = {f"{g}_gap{m}" for g in GAPS for m in ("", "_med")}
    assert set(EXACT) <= set(limits) <= set(EXACT) | layer
    assert all(limits[k] == 0 for k in EXACT)
    # every layer the cells name has a number compared
    assert {k.split("_gap")[0].split("_")[0] for k in limits
            if k not in EXACT} >= {"face", "embed", "person"}
    assert os.path.isfile(os.path.join(ROOT, conf["preset"]))


def _clip_ctx(trace, kept):
    with open(os.path.join(PKG, "configs", "scrfd_clipface_vitl14.json")) as fh:
        conf = json.load(fh)
    return {"config": conf, "trace": trace, "kept": kept,
            "device_name": "NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("case", ["no_range", "no_kernel"])
def test_embed_roofline_stops_a_run_it_cannot_read(manifest, case):
    """The tower's range missing, or kept chips with no kernel time in it,
    stops the run instead of leaving the metric out."""
    from port_bench.probe import EMBED_RANGE
    from port_bench.run import Bench
    from port_bench.trace import Trace

    tr = Trace(window_s=1.0, busy_s=0.5)
    if case == "no_kernel":
        tr.ranges.append((EMBED_RANGE, 0.0, 10.0, 1))
    with pytest.raises(RuntimeError):
        Bench(manifest).reader("embed_roofline")(_clip_ctx(tr, {0: 64}))


def test_embed_roofline_reads_the_range(manifest):
    from port_bench.flops import embedder_flops
    from port_bench.peaks import peak_flops
    from port_bench.probe import EMBED_RANGE
    from port_bench.run import Bench
    from port_bench.trace import Trace

    tr = Trace(window_s=1.0, busy_s=0.5)
    tr.ranges += [(EMBED_RANGE, 0.0, 10.0, 1), ("other", 20.0, 30.0, 1)]
    tr.launches.update({1: (5.0, 1), 2: (25.0, 1)})
    tr.device += [("gemm", 100.0, 2100.0, 1), ("other", 0.0, 9e6, 2)]
    ctx = _clip_ctx(tr, {0: 64})
    want = 100.0 * 64 * embedder_flops(ctx["config"]["embedder"]) \
        / (2e-3 * peak_flops(ctx["device_name"], "bfloat16"))
    assert Bench(manifest).reader("embed_roofline")(ctx) == \
        pytest.approx(want)
