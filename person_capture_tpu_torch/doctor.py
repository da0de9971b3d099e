"""Environment + accelerator diagnostics: ``python -m person_capture_tpu_torch.doctor``.

One command answers "is this host/card/link healthy, and what throughput
should I expect?" before a long run is launched or after a depressed
capture — the operational questions that on the reference are scattered
across its launcher env checks (start_person_capture.bat), CUDA/ORT
provider logs (person_capture/face_embedder.py session setup) and manual
nvidia-smi runs. Sections:

  host     cores / RAM / cv2 / external decode binaries
  weights  every bundled checkpoint the zoo resolves with "auto"
  cache    the cache dir ``tpu_compile_cache_dir`` resolves to: path,
           writable, entries
  decode   measured cv2 1080p decode rate (the usual e2e bound)
  device   subprocess matmul probe (hang-proof: a wedged in-process CUDA
           initialisation cannot be interrupted; utils/device.py), then
           in-process round trip + upload/download bandwidth at the real
           wire shapes and the implied main-pass LINK ceiling

Exit code 0 = healthy, 1 = a section failed (device down, weights
missing, cache unwritable). ``--json`` prints ONE machine-readable JSON
document on stdout (status lines go to stderr). ``--device cpu`` checks
the CPU instead of the card.

Copied from ``person_capture_tpu/doctor.py``; ``check_device`` measures
the same quantities with torch on ``cuda`` (or the device given).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np


def _say(msg: str, json_mode: bool) -> None:
    print(msg, file=sys.stderr if json_mode else sys.stdout, flush=True)


def check_host() -> Dict:
    import cv2

    mem_gb = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    mem_gb = round(int(line.split()[1]) / 1e6, 1)
                    break
    except OSError:
        pass
    import shutil

    return {
        "cores": os.cpu_count(),
        "mem_gb": mem_gb,
        "cv2": cv2.__version__,
        "ffmpeg": shutil.which("ffmpeg"),
        "ffprobe": shutil.which("ffprobe"),
    }


def check_weights() -> Dict:
    """Every model the zoo's "auto" spec resolves from the bundle."""
    from .models.zoo import bundled_weights_path

    names = ["scrfd_2.5g", "yolov8n", "yolov8n_face", "arcface_synth",
             "clip_reid_s"]
    out: Dict[str, Optional[str]] = {}
    for n in names:
        p = bundled_weights_path(n)
        out[n] = p if (p and os.path.exists(p)) else None
    out["ok"] = all(out[n] for n in names)
    return out


def check_cache(cache_dir: str = "auto") -> Dict:
    """``cache_dir`` mirrors ``tpu_compile_cache_dir`` so doctor diagnoses
    the directory the REAL run will use, not just the default location
    (pass the same value you give the CLI via --set)."""
    from .main import resolve_compile_cache_dir

    class _Cfg:
        tpu_compile_cache_dir = cache_dir or "auto"

    d = resolve_compile_cache_dir(_Cfg())
    info: Dict = {"dir": d or None, "writable": False, "entries": 0}
    if not d:
        return info
    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, ".doctor_probe")
        with open(probe, "w") as f:
            f.write("x")
        os.remove(probe)
        info["writable"] = True
        info["entries"] = sum(1 for f in os.listdir(d)
                              if not f.startswith("."))
    except OSError as e:
        info["error"] = str(e)
    return info


def check_sweep(out_root: str, stale_after_s: float = 600.0) -> Dict:
    """Read a sweep daemon's heartbeat (OUT_ROOT/sweep_status.json +
    sweep_summary.json): is it alive, what is it doing, how stale is the
    last update? The heartbeat refreshes through engine phases, progress
    ticks, idle polls AND backend-outage probes (sweep.py), so a stale
    timestamp really does mean a dead or wedged daemon."""
    status_path = os.path.join(out_root, "sweep_status.json")
    info: Dict = {"root": out_root, "found": False}
    try:
        with open(status_path) as fh:
            st = json.load(fh)
    except (OSError, ValueError) as e:
        info["error"] = f"{type(e).__name__}: {e}"
        return info
    info["found"] = True
    age = max(0.0, time.time() - float(st.get("updated", 0.0)))
    info.update(phase=st.get("phase"), video=st.get("video"),
                progress=st.get("progress"),
                processed=st.get("processed"), failed=st.get("failed"),
                age_s=round(age, 1))
    exited = st.get("phase") == "exited"
    info["alive"] = bool(exited or age < float(stale_after_s))
    if not info["alive"]:
        info["error"] = (f"heartbeat is {age:.0f}s old (> "
                         f"{stale_after_s:.0f}s) and phase is not "
                         f"'exited' — daemon dead or wedged")
    try:
        with open(os.path.join(out_root, "sweep_summary.json")) as fh:
            summary = json.load(fh)
        info["summary"] = {k: summary.get(k) for k in
                           ("corpus", "processed", "failed", "resumed",
                            "failed_backend", "failed_video")}
    except (OSError, ValueError):
        pass
    return info


def check_decode(seconds: float = 3.0, width: int = 1920,
                 height: int = 1080) -> Dict:
    """Encode a short synthetic clip (1080p by default), measure cv2
    decode f/s — the usual prescan-e2e bound on thin hosts
    (BASELINE.md)."""
    import tempfile

    import cv2

    from .video.synthetic import generate_video

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "probe.mp4")
        n = max(48, int(seconds * 24))
        generate_video(path, width=width, height=height, fps=24,
                       total_frames=n, segments=[(0, n - 1, 0)],
                       moving=True, seed=0)
        cap = cv2.VideoCapture(path)
        got = 0
        t0 = time.perf_counter()
        while True:
            ok, _ = cap.read()
            if not ok:
                break
            got += 1
        dt = time.perf_counter() - t0
        cap.release()
    fps = got / dt if dt > 0 else 0.0
    return {"frames": got, "width": width, "height": height,
            "decode_fps": round(fps, 1),
            "x_realtime_at_24fps": round(fps / 24.0, 2)}


def _timed_median(fn: Callable[[], None], reps: int) -> float:
    ts: List[float] = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def check_device(probe_budget_s: float = 120.0, reps: int = 5,
                 platform: str = "") -> Dict:
    """Subprocess probe first (hang-proof), then the in-process link floor
    on ``torch.device(platform or "cuda")``: a pinned-cpu doctor probes
    and measures the CPU, never a dead card."""
    from .utils.device import probe_device_once

    info: Dict = {"ok": False}
    t0 = time.perf_counter()
    if not probe_device_once(timeout_s=probe_budget_s, platform=platform):
        info["error"] = (f"subprocess matmul probe failed within "
                         f"{probe_budget_s:.0f}s — device down or hung")
        return info
    info["probe_s"] = round(time.perf_counter() - t0, 1)

    import torch

    dev = torch.device(platform or "cuda")
    cuda = dev.type == "cuda"
    info["platform"] = dev.type
    info["device"] = torch.cuda.get_device_name(dev) if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    float((torch.ones((8, 8), device=dev) @ torch.ones((8, 8),
                                                      device=dev))[0, 0])
    info["handshake_s"] = round(time.perf_counter() - t0, 1)

    one = torch.ones((8, 8), device=dev)
    float((one @ one).sum())  # warm
    rtt = _timed_median(lambda: float((one @ one).sum()), reps)
    info["rtt_ms"] = round(rtt * 1e3, 1)

    # upload at the real main-pass wire shape: batch 16 w640 i420, from
    # pageable host memory (torch.tensor always copies)
    wire = np.random.default_rng(0).integers(0, 255, (16, 540, 640),
                                             np.uint8)

    def upload():
        torch.tensor(wire, device=dev)
        sync()

    upload()  # warm
    up = _timed_median(upload, reps)
    info["upload_mb_s"] = round(wire.nbytes / 1e6 / up, 1)

    # download at the HDR-still shape (8.3 MB bgr)
    still = torch.zeros((1440, 1920, 3), dtype=torch.uint8, device=dev)
    still.to("cpu", copy=True)  # warm
    dn = _timed_median(lambda: still.to("cpu", copy=True), reps)
    info["download_mb_s"] = round(1440 * 1920 * 3 / 1e6 / dn, 1)

    # implied LINK ceiling for the main pass at the defaults (batch 16 @
    # stride 2 covers 1.33 s of 24 fps video per 5.5 MB upload)
    covered_s = 16 * 2 / 24.0
    floor = max(wire.nbytes / 1e6 / max(info["upload_mb_s"], 1e-6), rtt)
    info["mainpass_link_ceiling_x"] = round(covered_s / floor, 2)
    info["ok"] = True
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m person_capture_tpu_torch.doctor",
        description="host / weights / cache / decode / device+link "
                    "diagnostics")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON document on stdout")
    ap.add_argument("--skip-device", action="store_true",
                    help="host-only checks (no backend touch)")
    ap.add_argument("--skip-decode", action="store_true",
                    help="skip the 1080p decode measurement")
    ap.add_argument("--device", default="",
                    help="the device to check (cuda unless given, e.g. "
                         "cpu)")
    ap.add_argument("--sweep-root", default="",
                    help="also diagnose a sweep daemon's heartbeat "
                         "(OUT_ROOT of a --watch sweep): liveness, "
                         "current phase/video, summary counts")
    ap.add_argument("--cache-dir", default="auto",
                    help="diagnose THIS cache location (same values as "
                         "tpu_compile_cache_dir: auto | off | an explicit "
                         "dir); default checks the auto location")
    ap.add_argument("--probe-budget", type=float, default=120.0,
                    help="subprocess device-probe budget in seconds")
    args = ap.parse_args(argv)

    report: Dict = {}
    ok = True

    _say("[doctor] host…", args.json)
    report["host"] = check_host()

    _say("[doctor] bundled weights…", args.json)
    report["weights"] = check_weights()
    ok &= bool(report["weights"]["ok"])

    _say("[doctor] compile cache…", args.json)
    report["cache"] = check_cache(args.cache_dir)
    ok &= bool(report["cache"]["writable"] or report["cache"]["dir"] is None)

    if args.sweep_root:
        _say("[doctor] sweep daemon heartbeat…", args.json)
        report["sweep"] = check_sweep(args.sweep_root)
        ok &= bool(report["sweep"].get("alive"))

    if not args.skip_decode:
        _say("[doctor] cv2 1080p decode rate…", args.json)
        report["decode"] = check_decode()

    if not args.skip_device:
        _say("[doctor] device probe…", args.json)
        report["device"] = check_device(probe_budget_s=args.probe_budget,
                                        platform=args.device)
        ok &= bool(report["device"]["ok"])

    report["ok"] = bool(ok)
    if args.json:
        print(json.dumps(report))
    else:
        print(json.dumps(report, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
