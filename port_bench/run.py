"""The benchmark of the torch port: one run of one cell.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``port_bench/configs/<name>.json``) and a traffic
mix (``port_bench/traffic/<name>.json``); per-layer metrics are readers in
``port_bench/metrics/<name>.py``, and each model of a configuration comes
from the family its section names (``port_bench/families/<kind>.py``).

Set-up (``setup_s``): the cell's clip and a shorter warm-up clip of the
same kind from ``--seed`` under ``TMPDIR``, the port's runtime built once
by ``main.build_config`` and ``build_runtime`` from the bundled preset and
the configuration's settings, then the warm-up clip run through the same
path. The window runs ``main.make_engine(cfg, runtime).run()`` on the
clip, one video after another, each into a fresh directory that is checked
and deleted; it closes at the end of the video running when ``--seconds``
have passed. Then the port is freed, and what the window produced is
compared with the plain reference (``check.py``). A traced run
(``--trace 1``) traces its first video and times at least one more, from
which the host-clock readings and ``model.mfu`` come.

The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import copy
import csv
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from .families import ROLES, config_args, family_of

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "person_capture_tpu")
WEIGHTS_DIR = os.path.join(ROOT, "person_capture_tpu", "weights")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port may not load,
    compared whole (``person_capture_tpu_torch`` is not
    ``person_capture_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Bench:
    """``BENCHMARK.json`` and the files it names, found by name under
    ``base`` (``configs/``, ``traffic/``, ``metrics/``)."""

    def __init__(self, manifest: Dict, base: str = PKG):
        self.manifest, self.base = manifest, base

    @classmethod
    def load(cls, path: str = os.path.join(ROOT, "BENCHMARK.json"),
             base: str = PKG) -> "Bench":
        with open(path) as fh:
            return cls(json.load(fh), base)

    def _json(self, kind: str, name: str) -> Dict:
        with open(os.path.join(self.base, kind, f"{name}.json")) as fh:
            return json.load(fh)

    def cell(self, name: str) -> Dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def reports(self, metric: Dict, cell: Dict) -> bool:
        """Whether ``cell`` reports ``metric``."""
        if "workloads" in metric:
            return cell["name"] in metric["workloads"]
        if metric in self.manifest["end_to_end"]:
            return True
        moved = next(m for m in self.manifest["end_to_end"]
                     if m["name"] == metric["moves"])
        return self.reports(moved, cell)

    def reader(self, name: str):
        path = os.path.join(self.base, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"port_bench_metric_{len(name)}_{abs(hash(name))}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def load_weights(conf: Dict, device) -> Dict:
    """The weights of each role as flax variable trees, the same the port
    and the reference are given: a bundled ``.npz``, or a tree that the
    role's family draws from a seed."""
    from .reference.weights import load_npz

    out = {}
    for role in ROLES:
        spec = conf[role]["weights"]
        source, _, arg = spec.partition(":")
        if source == "bundled":
            out[role] = load_npz(os.path.join(WEIGHTS_DIR, arg))
        elif source == "seeded":
            fam = family_of(conf[role], role)
            if not hasattr(fam, "seeded"):
                raise ValueError(f"{role} weights {spec!r}: the family "
                                 f"{fam.__name__} draws no seeded weights")
            out[role] = fam.seeded(conf[role]["arch"], int(arg), device)
        else:
            raise ValueError(f"{role} weights {spec!r}: bundled:<file> or "
                             f"seeded:<seed>")
    return out


def _agree(conf: Dict, cfg, runtime) -> None:
    """The port's runtime is the configuration file's: the same widths and
    settings, or the run stops."""
    face, person = runtime["inner_face"], runtime["person"]
    det, emb, per = conf["detector"], conf["embedder"], conf["person"]
    pairs = {}
    for role in ROLES:
        model = family_of(conf[role], role).port_model(runtime)
        pairs[f"{role} arch"] = (
            None if model is None else dataclasses.asdict(model.cfg),
            config_args(conf[role]["arch"]))
    pairs.update({
        "det_size": (face.det_size, det["det_size"]),
        "score_thresh": (face.score_thresh, det["score_thresh"]),
        "max_faces": (face.max_faces, det["max_faces"]),
        "bank_dedup_cos": (cfg.prescan_diversity_dedup_cos,
                           emb["bank_dedup_cos"]),
        "embed_slots": (face.embed_slots, 0),
        "wire": (face.transfer_format, det["wire"]),
        "analysis_width": (cfg.tpu_mainpass_analysis_max_w,
                           det["analysis_width"]),
        "person det_size": (getattr(person, "det_size", None),
                            per["det_size"]),
        "person conf": (getattr(person, "conf", None), per["conf"]),
        "person max_det": (getattr(person, "max_det", None), per["max_det"]),
        "dtype": (str(face.dtype).replace("torch.", ""), conf["dtype"]),
    })
    bad = {}
    for k, (got, want) in pairs.items():
        same = (isinstance(got, dict) and all(got.get(x) == y for x, y
                                              in want.items())
                if isinstance(want, dict) else got == want)
        if not same:
            bad[k] = (got, want)
    if bad:
        raise ValueError(f"the port's runtime is not the configuration "
                         f"file's: {bad}")


def _rows(out_dir: str) -> List[Dict]:
    path = os.path.join(out_dir, "index.csv")
    if not os.path.isfile(path):
        return []
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _missing(out_dir: str, rows: List[Dict], curate: bool) -> int:
    """Crops of ``index.csv`` that are absent or empty, and the curated
    set's metrics when there were crops to curate."""
    n = 0
    for r in rows:
        p = os.path.join(out_dir, "crops", r["crop_path"])
        n += not (os.path.isfile(p) and os.path.getsize(p) > 0)
    if curate and rows:
        n += not os.path.isfile(os.path.join(out_dir, "dataset_out",
                                             "metrics.json"))
    return n


def _bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def one_video(M, cfg0, runtime, probe, video: str, out_dir: str) -> Dict:
    """One video through ``make_engine(cfg, runtime).run()``; its outputs
    checked, measured and deleted."""
    cfg = copy.deepcopy(cfg0)
    cfg.video, cfg.out_dir = video, out_dir
    eng = M.make_engine(cfg, runtime, status=lambda *a, **k: None)
    probe.attach(eng)
    try:
        res = eng.run()
        ok, error = bool(res.ok), res.error
    except Exception as e:                      # a failed video, counted
        ok, error = False, repr(e)
    rows = _rows(out_dir)
    out = {"ok": ok, "error": error, "rows": rows,
           "outputs_missing": _missing(out_dir, rows, cfg.curate_enable),
           "stages": eng._timer.summary() if eng._timer else {},
           "counters": getattr(eng._timer, "counters", dict)(),
           "bytes": _bytes(out_dir)}
    shutil.rmtree(out_dir, ignore_errors=True)
    return out


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _decode(path: str, wanted, size) -> Dict[int, np.ndarray]:
    """Frames ``wanted`` of the clip, decoded in order and resized to the
    analysis ``size`` (w, h) as the main pass does."""
    import cv2

    wanted, out = set(int(f) for f in wanted), {}
    cap = cv2.VideoCapture(path)
    try:
        f = 0
        while wanted - out.keys():
            ok, frame = cap.read()
            if not ok:
                break
            if f in wanted:
                out[f] = frame if (frame.shape[1], frame.shape[0]) == size \
                    else cv2.resize(frame, size, interpolation=cv2.INTER_AREA)
            f += 1
    finally:
        cap.release()
    return out


def analysis_size(w: int, h: int, max_w: int):
    """The main pass's analysis frame (even sides) of a ``w``×``h``
    source."""
    if not max_w or w <= max_w:
        return w, h
    aw = max_w - max_w % 2
    ah = max(2, int(round(h * aw / w)))
    return aw, ah - ah % 2


def _stack(batches, key: str) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([b[key][k][b["valid"]] for b in batches])
            for k in batches[0][key]}


def identity_distances(got: Dict, idxs, clip, size, bank) -> Dict:
    """The port's face distances to its bank, split by the identity the
    clip drew there: the target's largest and the others' smallest."""
    from .check import _fd, match

    sx, sy = clip.width / size[0], clip.height / size[1]
    target, other = [0.0], [9.0]
    for n, f in enumerate(idxs):
        truth = clip.truth.get(int(f), [])
        if not truth:
            continue
        boxes = np.array([b for _, b in truth]) / np.array([sx, sy, sx, sy])
        m = got["mask"][n]
        for i, j in match(got["boxes"][n][m], boxes):
            fd = _fd(got["feats"][n][m][i], bank)
            if truth[j][0] == 0:
                target.append(fd)
            else:
                other.append(fd)
    return {"fd_target_max": max(target), "fd_other_min": min(other)}


def verify(conf: Dict, weights: Dict, clip, ref_path: str, probe, videos,
           seed: int, device, control: bool = False) -> Dict:
    """The numbers of the comparison (and, with ``control``, the
    control's layer numbers, the reference in fp8 in the port's place)."""
    import cv2

    from .check import compare_layers, hit_numbers
    from .reference.pipeline import Reference

    det = conf["detector"]
    size = analysis_size(clip.width, clip.height, det["analysis_width"])
    rng = np.random.default_rng((int(seed) * 7919 + 17) % 2**63)
    k = min(int(conf["check"]["sample_batches"]), len(probe.batches))
    picks = sorted(rng.choice(len(probe.batches), size=k, replace=False)) \
        if k else []
    sample = [probe.batches[i] for i in picks]
    hits = {int(r["frame"]) for v in videos for r in v["rows"]}
    frames_idx = sorted({int(f) for b in sample for f in b["idxs"][b["valid"]]}
                        | hits)
    decoded = _decode(clip.path, frames_idx, size)
    photo = cv2.imread(ref_path, cv2.IMREAD_COLOR)
    ref = Reference(conf, weights, device)
    numbers: Dict = {"batches_compared": len(sample)}
    layer_frames = None
    if sample:
        idxs = np.concatenate([b["idxs"][b["valid"]] for b in sample])
        shapes = {b["shape"] for b in sample}
        if shapes != {(size[1], size[0])}:
            raise ValueError(f"the port analysed frames of {shapes}, the "
                             f"reference {size}")
        layer_frames = np.stack([decoded[int(f)] for f in idxs])
        ref_faces = ref.faces(layer_frames)
        ref_persons = ref.persons(layer_frames)
        ref_bank = ref.bank(photo)
        got = _stack(sample, "faces")
        numbers.update(compare_layers(
            got, _stack(sample, "persons"), probe.bank, ref_faces,
            ref_persons, ref_bank, det["score_thresh"],
            conf["person"]["conf"]))
        numbers.update(identity_distances(got, idxs, clip, size,
                                          probe.bank))
    hit_list = sorted(hits)
    at = {}
    if hit_list:
        got = ref.faces(np.stack([decoded[f] for f in hit_list]))
        at = {f: {k: v[i] for k, v in got.items()}
              for i, f in enumerate(hit_list)}
    scale = np.array([clip.width / size[0], clip.height / size[1]])
    numbers.update(hit_numbers(videos, clip, at, scale))
    del ref
    if control and layer_frames is not None:
        low = Reference(conf, weights, device, precision="fp8")
        numbers["control"] = compare_layers(
            low.faces(layer_frames), low.persons(layer_frames),
            low.bank(photo), ref_faces, ref_persons, ref_bank,
            det["score_thresh"], conf["person"]["conf"])
    return numbers


def window_context(conf: Dict, videos: List[Dict], trace: bool,
                   frames: int, probe, traced, device_name: str) -> Dict:
    """What the per-layer readers read (``ctx``) of a window's ``videos``
    of ``frames`` source frames each. The traced video runs slower under
    the profiler: the host-clock readings, the port's stages and counters
    and the FLOPs of ``model.mfu`` come from the videos after it
    (``timed``); ``kept`` holds the kept face slots of every video, the
    traced one as video 0."""
    from .probe import summed_counters, summed_stages

    timed = list(range(int(trace), len(videos)))
    return {"config": conf, "timed": timed,
            "timed_s": sum(videos[i]["seconds"] for i in timed),
            "frames": frames * sum(videos[i]["ok"] for i in timed),
            "stages": summed_stages(videos[i]["stages"] for i in timed),
            "counters": summed_counters(videos[i]["counters"]
                                        for i in timed),
            "curate_s": [probe.curate_s[i] for i in timed
                         if i in probe.curate_s],
            "det_frames": dict(sum((probe.det_frames[i] for i in timed),
                                   Counter())),
            "kept": dict(probe.kept),
            "person_frames": sum(probe.person_frames[i] for i in timed),
            "trace": traced, "device_name": device_name}


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", faults=(),
             control: bool = False) -> Dict:
    import torch

    from . import traffic
    from .probe import Probe
    from .trace import profiled

    t_setup = time.perf_counter()
    cell = bench.cell(workload)
    conf, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    limits = conf["check"]["limits"]
    cuda = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="port_bench-")
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            made = pool.submit(traffic.make_clip,
                               os.path.join(tmp, "clip.mp4"), mix, seed)
            warm = pool.submit(traffic.make_clip,
                               os.path.join(tmp, "warm.mp4"), mix, seed + 1,
                               int(mix["warmup_frames"]))
            clip, warm = made.result(), warm.result()
        ref_path = traffic.make_ref(os.path.join(tmp, "ref.png"))
        log(f"clips: {time.perf_counter() - t0:.3f} s for {clip.frames} + "
            f"{warm.frames} frames at {clip.width}x{clip.height}, "
            f"{os.path.getsize(clip.path) + os.path.getsize(warm.path)} "
            f"bytes")

        from person_capture_tpu_torch import main as M

        sets = list(conf["sets"]) + [f"tpu_compute_dtype={conf['dtype']}"]
        if trace:
            sets.append("tpu_profile=true")
        argv = ["--video", warm.path, "--ref", ref_path, "--out",
                os.path.join(tmp, "warm"), "--device", device,
                "--preset", os.path.join(ROOT, conf["preset"])]
        for s in sets:
            argv += ["--set", s]
        ap = M.build_parser()
        args = ap.parse_args(argv)
        cfg = M.build_config(args, ap)
        runtime = M.build_runtime(cfg, args, ap)
        faces = [runtime["inner_face"]]
        if runtime["fullframe"] is not None:
            faces.append(runtime["fullframe"]._get())
        weights = load_weights(conf, device)
        for role in ROLES:
            family_of(conf[role], role).load_port(faces, weights[role])
        _agree(conf, cfg, runtime)
        probe = Probe(faces, trace=trace, faults=faults)
        w = one_video(M, cfg, runtime, probe, warm.path,
                      os.path.join(tmp, "warm"))
        if not w["ok"]:
            raise RuntimeError(f"the warm-up video failed: {w['error']}")
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        log(f"setup: {setup_s:.3f} s")

        for counts in (probe.det_frames, probe.kept, probe.person_frames,
                       probe.curate_s):
            counts.clear()
        probe.record = True
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        videos, traced = [], {}
        t_start = time.perf_counter()
        with probe.phases():
            while True:
                probe.video = len(videos)
                out_dir = os.path.join(tmp, f"v{len(videos)}")
                t0 = time.perf_counter()
                if trace and not videos:
                    with profiled(os.path.join(tmp, "trace.json"), traced):
                        v = one_video(M, cfg, runtime, probe, clip.path,
                                      out_dir)
                    traced["trace"].window_s = time.perf_counter() - t0
                else:
                    v = one_video(M, cfg, runtime, probe, clip.path, out_dir)
                v["seconds"] = time.perf_counter() - t0
                videos.append(v)
                # a traced run times at least one video after the traced one
                if time.perf_counter() - t_start >= seconds and \
                        len(videos) > int(trace):
                    break
        window_s = time.perf_counter() - t_start
        mem = int(torch.cuda.max_memory_allocated()) if cuda else 0
        probe.record = False
        found = forbidden_modules()
        failed = sum(not v["ok"] for v in videos)
        for v in videos:
            if not v["ok"]:
                log(f"video failed: {v['error']}")
        log(f"window: {window_s:.3f} s, {len(videos)} videos, "
            f"{failed} failed; writes per video (bytes): "
            f"{[v['bytes'] for v in videos]}")

        ctx = window_context(conf, videos, trace, clip.frames, probe,
                             traced.get("trace"),
                             torch.cuda.get_device_name(0) if cuda
                             else "cpu")
        probe.close()
        del runtime, faces
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers = verify(conf, weights, clip, ref_path, probe, videos, seed,
                         device, control=control)
        log(f"reference: {time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    numbers["forbidden_modules"] = len(found)
    numbers["counts"] = {k: ctx[k] for k in ("det_frames", "kept",
                                             "person_frames", "curate_s")}
    numbers["video_s"] = [v["seconds"] for v in videos]
    if found:
        log(f"loaded in the window: {found}")
    missing = [k for k in EXACT if k not in limits]
    if missing and not control:
        raise ValueError(f"configuration {conf['name']!r} has no limit for "
                         f"{missing}")
    # a number the run could not produce (no batch to compare) fails
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    correct = bool(videos) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": len(videos), "failed": failed}
    if trace:
        metrics = {}
        for m in bench.manifest["per_layer"]:
            if bench.reports(m, cell):
                value = bench.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"src_fps": clip.frames * (len(videos) - failed) / window_s,
               "device_mem_gib": mem / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.manifest["end_to_end"]
                   if bench.reports(m, cell)}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": ctx["device_name"], "count": 1,
                        "memory_peak_bytes": mem,
                        "power_limit": _power_limit() if cuda else "none"}
    if trace and ctx["trace"] is not None:
        tr = ctx["trace"]
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["numbers"] = numbers
    result["checks"] = checks
    return result


# the exact numbers every configuration compares (limit 0); the layer
# numbers it compares are the other keys of its ``check.limits``
EXACT = ("videos_failed", "outputs_missing", "hits_off_target",
         "spans_missed", "forbidden_modules", "face_missed", "person_missed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench.load()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" found")
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found or result["numbers"]["forbidden_modules"]:
        log(f"modules the port may not load were loaded: {found}")
        return 3
    result.pop("numbers")
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
