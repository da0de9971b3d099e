"""Batch serving CLI — process a corpus of videos against one reference set.

    python -m person_capture_tpu_torch.sweep --videos DIR_OR_GLOB_OR_FILE \
        --ref REF.png --out OUT_ROOT [every main.py flag] \
        [--shard i/N] [--continue-on-error]

New architecture (no reference analogue: the reference processes ONE video
per GUI run and rebuilds its TRT/ORT sessions each time,
person_capture/gui_app.py:4490-4515). Here the model backends build ONCE;
every video then streams through the same device-resident models, so the
fleet pays per-video only decode + inference:

- weights load and upload once per model family;
- the hand-written kernels are built once per checkout and loaded once per
  process;
- the recovery ladder's adaptive rotation state is per-video (a fresh
  ``RecoveringFaceBackend`` wraps the shared inner backend per run), so a
  sweep run of video V is decision-identical to a solo run of V;
- the prescan cache is content-addressed (pipeline/cache.py), so
  re-sweeping a grown corpus skips every video already scanned.

Scaling: a FLEET of hosts partitions the corpus with ``--shard i/N``
(deterministic round-robin over the sorted video list) — embarrassingly
parallel, no coordinator needed.

Outputs: ``OUT_ROOT/<video-stem>/`` per video (crops + index.csv, same
schema as the single-video CLI) plus ``OUT_ROOT/sweep_summary.json``.

Copied from ``person_capture_tpu/sweep.py``, over the port's ``main`` and
``utils/device``.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import sys
import time

VIDEO_EXTS = (".mp4", ".m4v", ".mov", ".mkv", ".webm", ".avi", ".ts",
              ".m2ts", ".wmv")


def expand_videos(specs) -> list:
    """Each spec may be a directory (scanned non-recursively for video
    extensions), a glob pattern, or a file path. Returns a sorted,
    deduplicated list; order is deterministic so --shard partitions are
    stable across hosts."""
    out = []
    for spec in specs:
        for part in str(spec).split(";"):
            if not part:
                continue
            if os.path.isdir(part):
                out.extend(os.path.join(part, f)
                           for f in sorted(os.listdir(part))
                           if f.lower().endswith(VIDEO_EXTS))
            elif any(ch in part for ch in "*?["):
                out.extend(p for p in glob.glob(part)
                           if p.lower().endswith(VIDEO_EXTS)
                           and os.path.isfile(p))
            else:
                out.append(part)
    seen = set()
    uniq = []
    for p in sorted(out):
        key = os.path.abspath(p)
        if key not in seen:
            seen.add(key)
            uniq.append(p)
    return uniq


def parse_shard(spec: str):
    """"i/N" → (i, N) with 0 <= i < N."""
    if not spec:
        return 0, 1
    try:
        i_s, n_s = spec.split("/")
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise SystemExit(f"--shard {spec!r}: expected i/N (e.g. 0/4)")
    if n <= 0 or not 0 <= i < n:
        raise SystemExit(f"--shard {spec!r}: need 0 <= i < N")
    return i, n


def shard_select(videos, shard_i: int, shard_n: int,
                 stable: bool = False) -> list:
    """The i-th of N disjoint corpus partitions.

    One-shot sweeps slice the sorted list (`videos[i::N]`, perfectly
    balanced). Watch mode needs `stable=True`: partition by a hash of the
    absolute path, so files added later never REASSIGN existing videos
    between fleet members (slicing parity shifts when a new name sorts
    early — two watchers would then both think they own some file)."""
    if shard_n <= 1:
        return list(videos)
    if not stable:
        return list(videos[shard_i::shard_n])
    import zlib

    return [v for v in videos
            if zlib.crc32(os.path.abspath(v).encode()) % shard_n == shard_i]


def _out_dir_for(root: str, video: str, used: set) -> str:
    """Per-video output subdir from the file stem; same-stem collisions
    get a numeric suffix (stable because videos process in sorted order)."""
    stem = os.path.splitext(os.path.basename(video))[0] or "video"
    cand, k = stem, 2
    while cand in used:
        cand = f"{stem}_{k}"
        k += 1
    used.add(cand)
    return os.path.join(root, cand)


def _unique_out_dirs(root: str, videos) -> list:
    used: set = set()
    return [_out_dir_for(root, v, used) for v in videos]


def _load_done_markers(root: str) -> dict:
    """abspath(video) -> (subdir name, done.json record) for every
    completed per-video dir under ``root``.

    Restart resume for the serving daemon: a successful video writes
    ``<out_dir>/done.json``; a RESTARTED sweep (crash, host reboot,
    deploy) consults these markers instead of re-burning the whole
    corpus. Failed videos never get a marker, so they retry on restart.
    Markers are consulted per-video AS the corpus is walked, so a shared
    out_root (fleet layout) never leaks another shard's completions into
    this shard's summary."""
    found: dict = {}
    try:
        names = os.listdir(root)
    except OSError:
        return found
    for name in sorted(names):
        p = os.path.join(root, name, "done.json")
        try:
            with open(p) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            continue
        v = rec.get("video")
        if v:
            found[os.path.abspath(v)] = (name, rec)
    return found


# Fields excluded from the resume fingerprint: per-video by construction,
# or operational/perf knobs that are decision-transparent by design (the
# pipeline's batching/worker counts never change which crops are saved —
# CI-tested decision equivalence). Everything else — refs, thresholds,
# model choices, compose weights — invalidates old outputs on change.
_FINGERPRINT_EXCLUDE = frozenset({
    "video", "out_dir",
    "tpu_profile", "tpu_jax_profile_dir", "tpu_compile_cache_dir",
    "tpu_pipeline_depth", "tpu_decode_workers", "tpu_save_workers",
    "tpu_resize_workers", "tpu_mesh", "tpu_seek_sampling",
    "tpu_hdr_pipeline_depth",
    # device cpu/cuda is decision-equivalent by design (the CPU tests hold
    # the card runs to the CPU runs by decisions), and outage-mode
    # --device cpu outputs must resume cleanly once the card returns
    "device",
    "log_interval_sec", "preview_every",
    "async_save", "async_save_wait", "save_fsync",
})


def config_fingerprint(cfg) -> str:
    """Short stable hash of every decision-affecting config field.

    Stored in each done.json so a restarted sweep with different
    --ref/thresholds reprocesses instead of silently keeping outputs
    produced under the old settings as "ok, resumed"."""
    import hashlib
    from dataclasses import asdict

    d = {k: v for k, v in asdict(cfg).items()
         if k not in _FINGERPRINT_EXCLUDE}
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def build_sweep_parser():
    from .main import build_parser

    ap = build_parser(require_video=False)
    ap.prog = "person_capture_tpu_torch.sweep"
    ap.add_argument("--videos", action="append", required=True,
                    help="video corpus: directory, glob, or file; "
                         "repeatable and/or ';'-separated")
    ap.add_argument("--shard", default="",
                    help="i/N — process the i-th of N deterministic "
                         "partitions of the corpus (fleet scaling across "
                         "hosts without a coordinator)")
    ap.add_argument("--continue-on-error", action="store_true",
                    help="keep sweeping after a per-video failure "
                         "(recorded in sweep_summary.json)")
    ap.add_argument("--watch", type=float, default=0.0,
                    help="serving daemon: after the initial pass, re-scan "
                         "the corpus every N seconds and process new "
                         "arrivals (files younger than one poll interval "
                         "wait a poll so half-copied files are never "
                         "read). Sharding becomes path-hash based so a "
                         "growing corpus never reassigns videos between "
                         "fleet members. 0 = one-shot")
    ap.add_argument("--watch-max-idle", type=int, default=0,
                    help="exit after N consecutive empty polls "
                         "(0 = watch forever)")
    ap.add_argument("--backend-max-retries", type=int, default=3,
                    help="per-video retry budget for BACKEND-classified "
                         "failures (device/RPC errors). Each retry first "
                         "probes the accelerator in a subprocess and backs "
                         "off until it answers, so an outage stalls the "
                         "sweep instead of draining the corpus; a video "
                         "that still fails on a healthy device after N "
                         "retries is recorded failed (error_kind=backend) "
                         "and skipped")
    ap.add_argument("--no-resume", action="store_true",
                    help="reprocess videos whose output dir already has a "
                         "done.json completion marker (default: a "
                         "restarted sweep/daemon skips them — failures "
                         "never write a marker, so they always retry)")
    return ap


# patch points for tests / alternative probes ---------------------------
def _probe_and_wait(status) -> None:
    """Block until the accelerator answers a trivial matmul (no deadline:
    a serving daemon must stall through an outage, never consume corpus
    entries against a dead backend)."""
    from .utils.device import wait_for_device

    wait_for_device(deadline_s=None, status=status)


def main(argv=None) -> int:
    ap = build_sweep_parser()
    args = ap.parse_args(argv)
    if args.video:
        ap.error("--video is not a sweep flag; pass the corpus via "
                 "--videos")

    from .main import (build_config, build_runtime, make_engine,
                       maybe_enable_compile_cache, maybe_init_multihost,
                       maybe_pin_platform)

    cfg = build_config(args, ap)
    maybe_pin_platform(cfg)
    maybe_enable_compile_cache(cfg)
    out_root = maybe_init_multihost(args, args.out)

    shard_i, shard_n = parse_shard(args.shard)
    watch = max(0.0, float(args.watch))
    videos = expand_videos(args.videos)
    if not videos and not watch:
        print("no videos matched --videos", file=sys.stderr)
        return 1

    runtime_box = {}

    def get_runtime():
        # lazy: a watcher on an initially-empty corpus must not pay the
        # model build until the first video arrives
        if "rt" not in runtime_box:
            runtime_box["rt"] = build_runtime(cfg, args, ap)
        return runtime_box["rt"]

    results = []
    used_names: set = set()
    seen: set = set()
    t_sweep = time.perf_counter()
    failed = 0
    failed_kinds = {"video": 0, "backend": 0}
    corpus_size = 0
    summary_path = os.path.join(out_root, "sweep_summary.json")
    backend_max_retries = max(0, int(args.backend_max_retries))

    cfg_fp = config_fingerprint(cfg)
    done_markers = {} if args.no_resume else _load_done_markers(out_root)
    # reserve every completed dir's name up front so a same-stem NEW video
    # never collides with a resumed video's output directory
    for _dname, _rec in done_markers.values():
        used_names.add(_dname)

    from .utils.device import classify_error

    def write_summary():
        summary = {
            "corpus": corpus_size, "shard": f"{shard_i}/{shard_n}",
            "watch_sec": watch,
            "processed": len(results), "failed": failed,
            "resumed": sum(1 for r in results if r.get("resumed")),
            "failed_video": failed_kinds["video"],
            "failed_backend": failed_kinds["backend"],
            "wall_s": round(time.perf_counter() - t_sweep, 2),
            "results": results,
        }
        os.makedirs(out_root, exist_ok=True)
        with open(summary_path, "w") as fh:
            json.dump(summary, fh, indent=2)

    # serving-daemon heartbeat: OUT_ROOT/sweep_status.json, rewritten
    # atomically at phase changes and throttled progress ticks so fleet
    # monitors can read liveness + current work without scraping stdout
    # (the reference surfaces this through Qt status/progress signals,
    # gui_app.py:3532-3539; a headless daemon needs a file). The restart
    # story never reads it — done.json markers own resume.
    status_path = os.path.join(out_root, "sweep_status.json")
    hb_last = [0.0]

    def heartbeat(video: str, phase: str, progress: float,
                  retries: int = 0, force: bool = False) -> None:
        now = time.time()
        if not force and now - hb_last[0] < 5.0:
            return
        hb_last[0] = now
        try:
            os.makedirs(out_root, exist_ok=True)
            tmp = status_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"video": video, "phase": phase,
                           "progress": round(float(progress), 4),
                           "retries": retries,
                           "processed": len(results), "failed": failed,
                           "updated": now}, fh)
            os.replace(tmp, status_path)
        except OSError:
            pass                            # monitoring must never fail a run

    def _run_once(video: str, out_dir: str, retries: int = 0):
        vname = os.path.basename(video)

        def on_status(m, _v=vname):
            print(f"[pc:{_v}] {m}")
            heartbeat(video, str(m)[:120], -1.0, retries, force=True)

        def on_progress(p, _v=video):
            heartbeat(_v, "running", p, retries)

        try:
            eng = make_engine(cfg_for(video, out_dir), get_runtime(),
                              status=on_status, progress=on_progress)
            res = eng.run()
            ok, err = res.ok, res.error
            hits = len(res.mainpass.hits) if (ok and res.mainpass) else 0
            spans = len(res.spans) if ok else 0
        except Exception as e:             # never lose the rest of a fleet
            ok, hits, spans = False, 0, 0
            err = f"{type(e).__name__}: {e}"
        return ok, err, hits, spans

    def cfg_for(video: str, out_dir: str):
        cfg_v = copy.deepcopy(cfg)
        cfg_v.video = video
        cfg_v.out_dir = out_dir
        return cfg_v

    def process_one(video: str, out_dir=None) -> bool:
        """Run one video, retrying BACKEND-classified failures after the
        accelerator answers a health probe (an outage stalls the sweep; it
        never burns corpus entries). Video-classified
        failures (bad file, decode error) fail immediately: a healthy
        retry would not fix them."""
        nonlocal failed
        if out_dir is None:
            out_dir = _out_dir_for(out_root, video, used_names)
        t0 = time.perf_counter()
        print(f"[sweep] {video} -> {out_dir}")
        retries = 0
        while True:
            ok, err, hits, spans = _run_once(video, out_dir, retries)
            if ok:
                kind = None
                break
            kind = classify_error(err)
            if kind != "backend" or retries >= backend_max_retries:
                break
            retries += 1
            print(f"[sweep] backend failure on {video} (retry {retries}/"
                  f"{backend_max_retries}): {str(err).splitlines()[0][:200]}",
                  file=sys.stderr)
            # the aborted attempt may have saved crops before dying; wipe
            # the per-video dir so the retry's index.csv matches its crop
            # folder exactly (orphan crops would contaminate an ok result)
            import shutil
            shutil.rmtree(out_dir, ignore_errors=True)
            # block until the device answers; re-probe even right after a
            # failure. Heartbeat through the probe loop too: a long outage
            # otherwise reads as a dead daemon on the monitor (stale
            # timestamp) when it is deliberately stalling.
            heartbeat(video, "backend outage — probing device", -1.0,
                      retries, force=True)

            def _probe_status(m, _v=video, _r=retries):
                print(f"[sweep] {m}", file=sys.stderr)
                heartbeat(_v, f"outage probe: {str(m)[:100]}", -1.0, _r,
                          force=True)

            _probe_and_wait(_probe_status)
        wall = time.perf_counter() - t0
        if ok:
            # completion marker: a RESTARTED sweep seeds its seen-set from
            # these (failures write none, so they retry after a restart)
            try:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(out_dir, "done.json"), "w") as fh:
                    json.dump({"video": os.path.abspath(video),
                               "hits": hits, "spans": spans,
                               "wall_s": round(wall, 2),
                               "config": cfg_fp}, fh)
            except OSError:
                pass
        results.append({"video": video, "out_dir": out_dir, "ok": bool(ok),
                        "error": None if ok else str(err),
                        "error_kind": kind,
                        "retries": retries,
                        "hits": hits, "spans": spans,
                        "wall_s": round(wall, 2)})
        if ok:
            print(f"[sweep] done: {hits} hits, {spans} span(s), "
                  f"{wall:.1f}s"
                  + (f" (after {retries} backend retr"
                     f"{'y' if retries == 1 else 'ies'})" if retries else ""))
        else:
            failed += 1
            failed_kinds[kind] += 1
            print(f"[sweep] FAILED [{kind}] ({wall:.1f}s): {err}",
                  file=sys.stderr)
        write_summary()
        return bool(ok)

    idle_polls = 0
    first_pass = True
    while True:
        videos = expand_videos(args.videos)
        corpus_size = len(videos)
        mine = shard_select(videos, shard_i, shard_n, stable=watch > 0)
        if watch > 0:
            # settle guard: a file younger than one poll interval may
            # still be mid-copy — it gets picked up on the next poll
            now = time.time()

            def settled(v: str) -> bool:
                try:
                    return now - os.path.getmtime(v) >= watch
                except OSError:      # deleted between scan and stat
                    return False

            mine = [v for v in mine if settled(v)]
        fresh = [v for v in mine if os.path.abspath(v) not in seen]
        if first_pass:
            print(f"[sweep] corpus {len(videos)} video(s); shard "
                  f"{shard_i}/{shard_n} -> {len(mine)} here"
                  + (f"; watching every {watch:g}s" if watch else ""))
            first_pass = False
        aborted = False
        for video in fresh:
            vkey = os.path.abspath(video)
            seen.add(vkey)
            marker = done_markers.get(vkey)
            stale_dir = None
            if marker is not None:
                dname, rec = marker
                old_fp = rec.get("config")
                if old_fp is not None and old_fp != cfg_fp:
                    print(f"[sweep] resume: {video} was completed under a "
                          f"DIFFERENT config ({old_fp} != {cfg_fp}) — "
                          f"reprocessing", file=sys.stderr)
                    # reuse the marker's dir (wiped): a suffixed fresh dir
                    # would leave the stale outputs AND stale marker behind
                    stale_dir = os.path.join(out_root, dname)
                    import shutil
                    shutil.rmtree(stale_dir, ignore_errors=True)
                else:
                    # record the AS-GIVEN corpus path (not the marker's
                    # absolute form) so results[].video keeps one form
                    # across restarts — fleet monitors join on it
                    results.append({
                        "video": video,
                        "out_dir": os.path.join(out_root, dname),
                        "ok": True, "error": None, "error_kind": None,
                        "retries": 0, "hits": rec.get("hits", 0),
                        "spans": rec.get("spans", 0),
                        "wall_s": rec.get("wall_s", 0.0),
                        "resumed": True})
                    print(f"[sweep] resume: {video} already complete "
                          f"(--no-resume to redo)")
                    write_summary()
                    continue
            if not process_one(video, out_dir=stale_dir) \
                    and not args.continue_on_error:
                aborted = True
                break
        if aborted or not watch:
            break
        idle_polls = 0 if fresh else idle_polls + 1
        heartbeat("", "idle", 1.0, force=True)
        if args.watch_max_idle and idle_polls >= int(args.watch_max_idle):
            print(f"[sweep] {idle_polls} idle poll(s) — exiting watch")
            break
        try:
            time.sleep(watch)
        except KeyboardInterrupt:
            break

    write_summary()
    heartbeat("", "exited", 1.0, force=True)
    done = len(results) - failed
    print(f"[sweep] {done}/{len(results)} ok in "
          f"{round(time.perf_counter() - t_sweep, 2)}s; "
          f"summary: {summary_path}")
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
