"""Smoke run of the torch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero without printing a result:

1. device   — ``nvidia-smi`` name and power limit, device name and compute
              capability (must be 9.0);
2. build    — compiles ``person_capture_tpu_torch/csrc/*.cu`` (one ``nvcc``
              per source, all started together, with ``-Xptxas -v``, whose
              register and spill lines it prints) and times it;
3. kernel   — both entries of the tone-map kernel against their plain
              PyTorch versions on the card at 3840×2160: the planar entry on
              seeded ``[3, 2160, 3840]`` planes for every curve with desat 0
              and 0.25 (max abs ≤ 2e-3), the fused P010→BGR entry on seeded
              P010 planes for every curve × desat × dither (≤ 1 LSB, and at
              most ``DIFFER_LIMIT`` of the pixels differing at all: a wrong
              dither, Bayer tile or rounding moves 12 to 90 % of them by
              one step); then, in turns, the times of the fused
              entry, of the unfused composition it replaced
              (``p010_unpack`` → ``ycbcr_to_rgb`` → planar entry →
              quantize) and of the plain version;
4. pipeline — the CLI face-identity pipeline (``build_config`` →
              ``build_runtime`` → ``make_engine`` → ``run``) at the CLI
              defaults (det 640, batch 64, ``--prescan``), SCRFD-2.5G and
              ArcFace SYNTH_R18 from the bundled weights in bf16, on a
              640×480 PQ-coded synthetic video with full-resolution HDR
              stills rendered from 2560×1920 P010 planes; hits must land in
              the truth spans, one valid still per hit, and every still must
              go through the fused entry;
5. preview  — the same run with ``on_preview`` (as a GUI drives it): the
              HDR preview pump renders 2560×1920 frames, dithered, through
              the fused entry; one preview is held to the plain chain;
6. main_path_shape — both entries against their plain versions once more
              at the tone-map shape of the first still, every configuration
              of phase 3 for the fused entry, and the same three timings;
7. defaults — the CLI at its defaults with only ``--set
              curate_enable=false`` (and the harness's cache and profile
              settings): YOLOv8n person detection from the bundled weights
              in the combined face+person program, madvr_like stills with
              contrast recovery 0.30 (colour match, despeckle). The fixture
              of phase 4 with a person drawn under a 48-px face (the largest
              the bundled person weights find at det 640; at the fixture's
              own 120 px they score under 0.1). Hits in the truth spans, one
              valid still per hit, the combined program dispatched once per
              main-pass batch, person boxes on most hit frames, at least one
              crop composed around a person box; fused tone-map launches
              (0 expected: contrast recovery routes the stills to the
              general chain); then, in turns, the combined program against
              the face-only program on one batch of 64 analysis frames, and
              the madvr_like render against the ``fast`` fused render at the
              first still's shape;
8. curate   — the CLI defaults whole: phase 7's fixture and settings with
              curation on (no ``--set`` but the harness's cache and profile
              settings). The run ends with the curator over its crops:
              ``dataset_out/`` must hold metrics.json, selection_debug.csv
              and 1 to min(200, crops) images, each one of the run's crops;
              prints the curator's wall time, pool, selection and the
              describe batches it dispatched;
9. reid     — the same with ``--match-mode either`` and the bundled
              clip_reid_s tower: hits in the truth spans, the tower called
              on the main pass, the curator given it as its CLIP backend;
              then a ViT-L-14 tower at a seeded random init embeds 16 of the
              run's person crops in bf16 and in fp32 (cosine ≥ 0.99 per
              crop), and the device time of a 16-crop batch of ViT-L-14
              (bf16 and fp32) and clip_reid_s, in turns;
10. yolo_face — ``--face-model yolov8n-face`` (bundled weights, the
              ±45/±135° probes on) on phase 4's fixture, curation off: hits
              in the truth spans, every span hit;
11. diag    — phase 4's fixture and settings with ``--set
              hdr_speckle_diag=true``: one ``speckle_diag.json`` with 5
              variants per still, at least 6 fused launches per still (the
              still and its 5 variant renders), and the first still's
              variant renders (its PNGs and statistics) against the plain
              render of the same crop on the CPU, ≤ 1 LSB in at most
              ``DIFFER_LIMIT`` of the pixels;
12. onnx    — the port's ``tools/onnx_export`` writes SCRFD-2.5G (det 640)
              and ArcFace from the bundled weights; phase 4's fixture with
              ``--scrfd-weights x.onnx --arcface-weights y.onnx`` and the
              full-frame rescue off (the graph's shapes are det 640's): in
              fp32
              the hit frames of the native ``.npz`` run in fp32, in bf16 hits
              in the truth spans and every span hit; then the 64-frame
              face step, ONNX against native (bf16), in turns;
13. sweep   — ``python -m person_capture_tpu_torch.sweep`` at the CLI
              defaults (curation on) over 3 videos (phase 8's fixture and
              two of the same generator with other seeds and spans, HDR
              stills from ``_P010FromVideo`` as in phases 4-10),
              ``--yolo`` a ``.pt`` state dict written from the bundled
              YOLOv8n weights and ``--arcface-weights`` a converted ``src/``
              dump of the bundled ArcFace: the runtime built once, video
              1's hits those of phase 8, every hit in its video's truth
              spans, processed 3 and failed 0, then a second invocation
              resumes all 3; seconds per video; ``doctor --json`` reports
              the card.

Phases 8 to 13 reach no hand-written kernel beyond the tone-map: the CLIP
tower, the curator's pHash and MMR, the ONNX interpreter, the loaders, the
sweep and the doctor are torch ops and host code, as they are XLA ops and
host code in the JAX package. Each phase's tone-map launches are counted
from 0 just before its run and printed in the ``kernels`` line.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM bandwidth,
# and the special-function units' rate — 16 MUFU results per clock per SM,
# 132 SMs, 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
MUFU_OPS_PER_S = 16 * 132 * 1.98e9

ALGOS = ("clip", "reinhard", "mobius", "hable", "bt.2390")
# largest share of pixels in which the fused entry may differ from its plain
# version, by one step: the MUFU pow against accurate powf moves a value
# across a rounding edge in about 0.2 % of the pixels (0.75 % for a preview
# against the general peak-detect chain); a dropped dither, a transposed
# Bayer tile or truncation moves 12 to 90 % of them
DIFFER_LIMIT = 0.02
TRUTH_SEGMENTS = [(20, 60, 0), (90, 120, 0)]
HDR_W, HDR_H = 2560, 1920


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 11, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``inner``
    back-to-back calls (so the host's per-call work hides behind the
    device's), divided by ``inner``; the median of ``reps`` such runs, after
    warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def wall_ms(fn, reps: int = 11, warmup: int = 3) -> float:
    """Host time of one call of ``fn`` up to a device synchronise (a step
    as its caller waits for it, host work included): the median of
    ``reps`` calls after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def in_turns(fns: dict, timer=cuda_ms) -> dict:
    """Times of several versions of one function, measured in turns
    (A, B, C, C, B, A): each name gets the mean of its two readings, and
    the readings themselves under ``<name>_runs``."""
    order = list(fns) + list(fns)[::-1]
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(timer(fns[name]))
    out = {name: statistics.mean(r) for name, r in runs.items()}
    out.update({f"{name}_runs": r for name, r in runs.items()})
    return out


def needed_pows_per_px(rgb_prime) -> float:
    """Mean pow evaluations per pixel that the main configuration (bt.2390,
    desat 0.25) needs on these R'G'B' values ``[..., 3]``: 2 per channel for
    the PQ EOTF; 4 (PQ inverse and PQ EOTF) for the curve on the max
    channel, and on each channel where the desat weight is not zero (max
    channel above 1), each only at or above the curve's knee (below it the
    curve is the identity); 1 per channel for the sRGB OETF above its linear
    segment. At most 25."""
    import torch

    from person_capture_tpu_torch.kernels import hdr as H
    from person_capture_tpu_torch.kernels.color import pq_eotf, pq_inv_eotf

    sdr = MAIN["sdr_nits"]
    k = H.curve_constants(MAIN["algo"], MAIN["src_peak_nits"] / sdr, sdr)
    lin = pq_eotf(rgb_prime) * (10000.0 / sdr)
    lum = lin.amax(dim=-1)

    def above_knee(x):
        x = torch.clamp(x, 0.0, float(k["peak_c"])) * (sdr / 10000.0)
        return pq_inv_eotf(x) / float(k["src_max_pq"]) >= float(k["ks"])

    pows = 6.0 + 4.0 * above_knee(lum).float()
    pows += 4.0 * (above_knee(lin) & (lum > 1.0)[..., None]).sum(-1)
    enc_in = H.hdr_to_sdr_core(lin, MAIN["src_peak_nits"], sdr, MAIN["algo"],
                               MAIN["desat"], MAIN["param"])
    pows += (enc_in > 0.0031308).sum(-1)
    return float(pows.mean())


def tonemap_bound_ms(px: int, pows_per_px: float, bytes_per_px: float):
    """Least time for the tone-map on ``px`` pixels: the larger of the
    bytes the entry must move (planar: 12 B read and 12 written per pixel;
    fused: 2 B of Y, 1 of chroma, 3 of BGR) over HBM bandwidth and the MUFU
    work the data needs (each pow = one log2 + one exp2) over the MUFU
    rate."""
    bytes_ms = bytes_per_px * px / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * pows_per_px * px / MUFU_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def planar_bound(x) -> dict:
    pows = needed_pows_per_px(x.permute(1, 2, 0))
    bound_ms, bound_by = tonemap_bound_ms(x.shape[1] * x.shape[2], pows,
                                          24.0)
    return dict(bound_ms=bound_ms, bound_by=bound_by, pows_per_px=pows)


def fused_bound(y, uv) -> dict:
    from person_capture_tpu_torch.kernels.hdr import p010_rgb_prime

    pows = needed_pows_per_px(p010_rgb_prime(y, uv, False))
    bound_ms, bound_by = tonemap_bound_ms(y.numel(), pows, 6.0)
    return dict(bound_ms=bound_ms, bound_by=bound_by, pows_per_px=pows)


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    emit(phase="device", nvidia_smi=smi,
         name=torch.cuda.get_device_name(0), capability=list(cap),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    require(tuple(cap) == (9, 0), f"compute capability {cap} is not 9.0")
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from person_capture_tpu_torch.kernels import build

    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    emit(phase="build", sources=names, seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p) for p in libs],
         ptxas={name: build.ptxas_report(name) for name in names})


def _planes(shape, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).cuda()


def _p010(h: int, w: int, seed: int):
    """Seeded P010 planes over the whole 10-bit code range, on the card."""
    import numpy as np

    from person_capture_tpu_torch.kernels.hdr import plane_tensor

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1024, (h, w)).astype(np.uint16) << 6
    uv = rng.integers(0, 1024, (h // 2, w // 2, 2)).astype(np.uint16) << 6
    return plane_tensor(y, "cuda"), plane_tensor(uv, "cuda")


# the main path's configuration: "auto" (bt.2390), desat 0.25, mobius param
# 0.4 (SessionConfig defaults); the stills' "fast" preset renders undithered
MAIN = dict(src_peak_nits=1000.0, sdr_nits=100.0, algo="auto", desat=0.25,
            param=0.4)


def planar_vs_plain(x):
    """Planar entry against its plain version, every curve and desat."""
    import torch

    from person_capture_tpu_torch.kernels import hdr as H

    errs = {}
    for algo in ALGOS:
        for desat in (0.0, 0.25):
            got = H.tonemap_planes(x, 1000.0, 100.0, algo, desat, 0.4)
            want = H.tonemap_planes_reference(x, 1000.0, 100.0, algo, desat,
                                              0.4)
            torch.cuda.synchronize()
            errs[f"{algo}/{desat}"] = float((got - want).abs().max())
    return errs


def differ(got, want):
    """Largest difference of two uint8 BGR images in 8-bit steps, and the
    share of pixels that differ in any channel."""
    d = (got.int() - want.int()).abs()
    return int(d.max()), float((d.amax(dim=-1) > 0).float().mean())


def check_fused(y, uv, phase: str):
    """Fused entry against its plain version, every curve × desat × dither:
    prints the largest difference and the share of differing pixels of each
    configuration, then requires ≤ 1 step and ≤ ``DIFFER_LIMIT``."""
    import torch

    from person_capture_tpu_torch.kernels import hdr as H

    lsb, share = {}, {}
    for algo in ALGOS:
        for desat in (0.0, 0.25):
            for dither in (False, True):
                args = (False, 1000.0, 100.0, algo, desat, 0.4, dither)
                got = H.hdr_to_sdr_bgr_cuda(y, uv, *args)
                want = H.hdr_to_sdr_bgr_reference(y, uv, *args)
                torch.cuda.synchronize()
                key = f"{algo}/{desat}/{int(dither)}"
                lsb[key], share[key] = differ(got, want)
    emit(phase=phase, shape=list(y.shape), fused_max_lsb=lsb,
         fused_differing_share=share)
    max_lsb, max_share = max(lsb.values()), max(share.values())
    require(max_lsb <= 1, f"fused entry vs plain at {tuple(y.shape)} "
            f"differs by {max_lsb} LSB")
    require(max_share <= DIFFER_LIMIT, f"fused entry vs plain at "
            f"{tuple(y.shape)} differs in {max_share:.4%} of the pixels")
    return max_lsb, max_share


def unfused(y, uv):
    """The render as it was before the fused entry, from public functions:
    P010 unpack, Y'CbCr → R'G'B', the planar entry, quantize (undithered)."""
    import torch

    from person_capture_tpu_torch.kernels import hdr as H
    from person_capture_tpu_torch.kernels.color import (YCBCR_BT2020,
                                                        ycbcr_to_rgb)

    yy, cb, cr = H.p010_unpack(y, uv)
    rgb = torch.clamp(ycbcr_to_rgb(yy, cb, cr, YCBCR_BT2020), 0.0, 1.0)
    enc = H.tonemap_planes_cuda(rgb.permute(2, 0, 1).contiguous(),
                                MAIN["src_peak_nits"], MAIN["sdr_nits"],
                                MAIN["algo"], MAIN["desat"], MAIN["param"])
    enc = enc.permute(1, 2, 0) * 255.0
    return torch.clamp(torch.round(enc), 0, 255).to(torch.uint8).flip(-1)


def fused_timings(y, uv) -> dict:
    """Fused entry, the unfused composition and the plain version on the
    same planes, in turns; the unfused render is held to the plain one."""
    import torch

    from person_capture_tpu_torch.kernels import hdr as H

    want = H.hdr_to_sdr_bgr_reference(y, uv, dither=False, **MAIN)
    lsb = int((unfused(y, uv).int() - want.int()).abs().max())
    require(lsb <= 1, f"unfused composition vs plain: {lsb} LSB")
    torch.cuda.synchronize()
    return in_turns({
        "ms": lambda: H.hdr_to_sdr_bgr_cuda(y, uv, dither=False, **MAIN),
        "unfused_ms": lambda: unfused(y, uv),
        "plain_ms": lambda: H.hdr_to_sdr_bgr_reference(y, uv, dither=False,
                                                       **MAIN)})


def phase_kernel():
    from person_capture_tpu_torch.kernels import hdr as H

    h, w = 2160, 3840
    x = _planes((3, h, w), seed=0)
    errs = planar_vs_plain(x)
    max_err = max(errs.values())
    require(max_err <= 2e-3, f"planar entry vs plain max abs {max_err}")
    planar = in_turns({
        "ms": lambda: H.tonemap_planes_cuda(x, **MAIN),
        "plain_ms": lambda: H.tonemap_planes_reference(x, **MAIN)})
    planar.update(shape=[3, h, w], max_abs_err=max_err, **planar_bound(x))
    del x

    y, uv = _p010(h, w, seed=1)
    max_lsb, max_share = check_fused(y, uv, "kernel_fused_check")
    fused = fused_timings(y, uv)
    fused.update(shape=[h, w, 3], max_lsb=max_lsb,
                 max_differing_share=max_share, **fused_bound(y, uv))
    emit(phase="kernel", planar=planar, planar_max_abs_err=errs,
         fused=fused)
    return planar, fused


class _P010FromVideo:
    """HDR plane source for the pipeline run (``get_planes``/``release`` of
    ArrayP010Source): decodes frame ``i`` of the PQ-coded fixture and builds
    4× P010 planes from it on request."""

    def __init__(self, path: str):
        import threading

        import cv2

        self._lock = threading.Lock()  # saver workers call concurrently
        self._cap = cv2.VideoCapture(path)
        self._pos = 0
        self.width, self.height = HDR_W, HDR_H

    def get_planes(self, frame_idx: int):
        import cv2

        from person_capture_tpu_torch.video.synthetic import p010_from_pq_bgr

        with self._lock:
            if frame_idx != self._pos:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, int(frame_idx))
            ok, frame = self._cap.read()
            self._pos = int(frame_idx) + 1
        if not ok:
            return None
        return p010_from_pq_bgr(frame, HDR_W, HDR_H)

    def release(self):
        with self._lock:
            self._cap.release()


def make_fixture(work: str, seed: int = 1, segments=TRUTH_SEGMENTS, **body):
    """The verify recipe's fixture, re-coded as PQ: (video, ref, truth).
    ``body``: ``generate_video``'s ``draw_body`` and ``face_px``; another
    ``seed`` and ``segments`` give another video of the same kind."""
    import cv2
    import numpy as np

    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face,
                                                          generate_video,
                                                          write_pq_video)

    os.makedirs(work, exist_ok=True)
    sdr = os.path.join(work, "sdr.mp4")
    vid = os.path.join(work, "vid.mp4")
    sv = generate_video(sdr, width=640, height=480, fps=30,
                        total_frames=150, segments=list(segments),
                        moving=True, seed=seed, **body)
    write_pq_video(sdr, vid)
    ref = np.full((200, 200, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (40, 40, 160, 160)))
    ref_path = os.path.join(work, "ref.png")
    cv2.imwrite(ref_path, ref)
    return vid, ref_path, sv.identity_spans(0)


# the settings of phases 4 and 5 (the first slices'), and of phase 7
SLICE_SETS = ("compose_detect_person_for_face=false", "curate_enable=false",
              "hdr_sdr_quality=fast", "hdr_sdr_contrast_recovery=0")
DEFAULT_SETS = ("curate_enable=false",)
# the largest face under which the bundled person weights find a drawn
# person at det 640 (trained on faces of 10-48 px at 256)
DEFAULT_FACE_PX = 48


def cli_config(vid: str, ref_path: str, out: str, sets=SLICE_SETS,
               flags=()):
    from person_capture_tpu_torch import main as M

    argv = ["--video", vid, "--ref", ref_path, "--out", out, "--prescan",
            *flags, "--set", "prescan_cache_mode=off",
            # host-side per-stage wall times (utils/timing.StepTimer)
            "--set", "tpu_profile=true"]
    for setting in sets:
        argv += ["--set", setting]
    ap = M.build_parser()
    args = ap.parse_args(argv)
    return ap, args, M.build_config(args, ap)


def reset_launches() -> None:
    from person_capture_tpu_torch.kernels import hdr as H

    H.TONEMAP_LAUNCHES.reset()
    H.HDR_TO_SDR_LAUNCHES.reset()


def read_launches() -> dict:
    from person_capture_tpu_torch.kernels import hdr as H

    return {"hdr_to_sdr_bgr": H.HDR_TO_SDR_LAUNCHES.count,
            "tonemap_planes": H.TONEMAP_LAUNCHES.count}


def check_stills(out: str, truth) -> list:
    """Hits inside the truth spans, every span hit, one valid still per hit
    at the HDR source's resolution; returns the index rows."""
    import csv

    import cv2

    from person_capture_tpu_torch.hdr.stills import validate_sdr_export

    with open(os.path.join(out, "index.csv")) as fh:
        rows = list(csv.DictReader(fh))
    hits = [int(r["frame"]) for r in rows]
    require(bool(hits), "no hits")
    outside = [f for f in hits if not any(s <= f <= e for s, e in truth)]
    require(not outside, f"hits outside truth spans {truth}: {outside}")
    require(all(any(s <= f <= e for f in hits) for s, e in truth),
            f"not every truth span {truth} has a hit: {hits}")
    for r in rows:
        path = os.path.join(out, "crops", r["crop_path"])
        ok, why = validate_sdr_export(path)
        require(path.endswith(".png") and ok, f"bad still {path}: {why}")
        sh, sw = cv2.imread(path).shape[:2]
        require(abs(sh - 4 * (int(r["y2"]) - int(r["y1"]))) <= 4
                and abs(sw - 4 * (int(r["x2"]) - int(r["x1"]))) <= 4,
                f"still {path} ({sw}x{sh}) is not at the HDR source's "
                f"resolution")
    return rows


def run_cli(work: str, name: str, fixture, sets, flags=(), hook=None):
    """One CLI run through ``build_runtime`` → ``make_engine`` → ``run``
    with HDR stills from ``_P010FromVideo``, the tone-map counts set to 0
    just before the run and read just after; requires the run to succeed
    with hits and stills as :func:`check_stills` does. ``hook(runtime,
    engine)`` runs before the run."""
    from person_capture_tpu_torch import main as M

    vid, ref_path, truth = fixture
    out = os.path.join(work, f"out_{name}")
    ap, args, cfg = cli_config(vid, ref_path, out, sets, flags)
    t0 = time.perf_counter()
    runtime = M.build_runtime(cfg, args, ap)
    eng = M.make_engine(cfg, runtime, status=lambda m: None)
    eng.hdr_source_factory = lambda video, w, h, fps: _P010FromVideo(video)
    if hook is not None:
        hook(runtime, eng)
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    require(res.ok, f"{name} run failed: {res.error}")
    rows = check_stills(out, truth)
    return dict(out=out, cfg=cfg, runtime=runtime, engine=eng, result=res,
                rows=rows, hit_frames=[int(r["frame"]) for r in rows],
                launches=launches, setup_seconds=setup_s, seconds=run_s)


def phase_pipeline(work: str):
    fixture = make_fixture(work)
    os.environ["PERSON_CAPTURE_FORCE_HDR"] = "1"
    run = run_cli(work, "pipeline", fixture, SLICE_SETS)
    rows, launches = run["rows"], run["launches"]
    stills = len(rows)
    require(launches["hdr_to_sdr_bgr"] >= stills,
            f"{launches['hdr_to_sdr_bgr']} fused launches for {stills} "
            f"stills")
    emit(phase="pipeline", truth_spans=fixture[2], hits=len(rows),
         hit_frames=run["hit_frames"], stills=stills, launches=launches,
         setup_seconds=run["setup_seconds"], seconds=run["seconds"],
         source_frames_per_s=150 / run["seconds"],
         prescan_spans=run["result"].spans,
         stages=run["engine"]._timer.summary())
    return rows, launches, (*fixture, run["runtime"])


def phase_preview(work: str, fixture):
    """The same run with ``on_preview``, as a GUI drives the engine: the
    pump renders 2560×1920 P010 frames (dithered) through the fused entry
    and downscales them to ``preview_max_dim`` (1280×960); a preview of any
    other shape is an analysis frame (640×480)."""
    import threading

    import numpy as np
    import torch

    from person_capture_tpu_torch import main as M
    from person_capture_tpu_torch.hdr.stills import (HdrExportParams,
                                                     render_sdr_crop_from_p010)
    from person_capture_tpu_torch.hdr_preview import tonemap_preview_frame
    from person_capture_tpu_torch.kernels.hdr import (p010_to_sdr_bgr,
                                                      plane_tensor)
    from person_capture_tpu_torch.video.probe import color_range_full

    vid, ref_path, truth, runtime = fixture
    out = os.path.join(work, "out_preview")
    _, _, cfg = cli_config(vid, ref_path, out)
    lock = threading.Lock()
    seen = {"previews": 0, "rendered": 0, "first": None}
    scale = min(1.0, cfg.preview_max_dim / max(HDR_W, HDR_H))
    rendered_shape = (round(HDR_H * scale), round(HDR_W * scale), 3)

    def on_preview(img, idx):
        with lock:
            seen["previews"] += 1
            if img.shape == rendered_shape:
                seen["rendered"] += 1
                if seen["first"] is None:
                    seen["first"] = (idx, img.copy())

    eng = M.make_engine(cfg, runtime, status=lambda m: None,
                        on_preview=on_preview)
    eng.hdr_source_factory = lambda video, w, h, fps: _P010FromVideo(video)
    reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    require(res.ok, f"engine run with previews failed: {res.error}")
    stills = len(check_stills(out, truth))
    require(seen["rendered"] >= 1, f"no HDR preview rendered by the pump "
            f"({seen['previews']} previews)")
    require(launches["hdr_to_sdr_bgr"] >= stills + seen["rendered"],
            f"{launches['hdr_to_sdr_bgr']} fused launches for {stills} "
            f"stills and {seen['rendered']} rendered previews")

    # the first rendered preview: again through the port (bit for bit), and
    # its full-resolution render against the plain peak-detect chain
    idx, img = seen["first"]
    src = _P010FromVideo(vid)
    y, uv = src.get_planes(idx)
    src.release()
    full_range = color_range_full(vid)
    again = tonemap_preview_frame(y, uv, max_dim=int(cfg.preview_max_dim),
                                  sdr_nits=cfg.sdr_nits,
                                  tonemap=cfg.hdr_sdr_tonemap,
                                  full_range=full_range, device="cuda")
    require(np.array_equal(again, img),
            "the pump's preview differs from tonemap_preview_frame")
    p = HdrExportParams(tonemap=cfg.hdr_sdr_tonemap, sdr_nits=cfg.sdr_nits,
                        full_range=full_range, color_match=False,
                        speckle_cleanup=False, dither=True, device="cuda")
    got = render_sdr_crop_from_p010(y, uv, (0, 0, HDR_W, HDR_H), p)
    want = p010_to_sdr_bgr(
        plane_tensor(y, "cuda"), plane_tensor(uv, "cuda"), full_range,
        "pq", p.src_peak_nits, p.sdr_nits, p.tonemap, p.desat, p.tm_param,
        dither=True, peak_detect=True).cpu().numpy()
    lsb, share = differ(torch.from_numpy(got), torch.from_numpy(want))
    require(lsb <= 1 and share <= DIFFER_LIMIT, f"preview render vs plain "
            f"chain: {lsb} LSB, {share:.4%} of the pixels differ")
    emit(phase="preview", previews=seen["previews"],
         rendered_previews=seen["rendered"], stills=stills,
         launches=launches, seconds=run_s, checked_frame=idx,
         checked_shape=list(got.shape), max_lsb=lsb, differing_share=share)
    return seen["rendered"]


def phase_main_path_shape(rows):
    """Both entries against their plain versions once more at the tone-map
    shape of the first still (its crop mapped to the 2560×1920 source,
    legalized and padded as the export does), and the fused entry's
    timings there."""
    import numpy as np

    from person_capture_tpu_torch.hdr.stills import (
        HdrExportParams, bucketed_crop_arrays, scale_crop_xyxy_to_source)

    r = rows[0]
    crop = scale_crop_xyxy_to_source(
        [float(r[k]) for k in ("x1", "y1", "x2", "y2")], (640, 480),
        (HDR_W, HDR_H))
    y = np.zeros((HDR_H, HDR_W), np.uint16)
    uv = np.zeros((HDR_H // 2, HDR_W // 2, 2), np.uint16)
    # the export pads the crop to its shape bucket before the render
    h, w = bucketed_crop_arrays(y, uv, crop, HdrExportParams())[0].shape
    x = _planes((3, h, w), seed=2)
    errs = planar_vs_plain(x)
    err = max(errs.values())
    require(err <= 2e-3, f"planar entry vs plain at {(3, h, w)}: {err}")
    del x
    yd, uvd = _p010(h, w, seed=3)
    max_lsb, max_share = check_fused(yd, uvd, "main_path_shape_fused_check")
    fused = fused_timings(yd, uvd)
    fused.update(shape=[h, w, 3], max_lsb=max_lsb,
                 max_differing_share=max_share, **fused_bound(yd, uvd))
    emit(phase="main_path_shape", planar_shape=[3, h, w],
         planar_max_abs_err=err, fused=fused)
    return err, fused


def _watch_defaults_run(face, composed: list, dispatches: list,
                        persons: dict):
    """Spies for phase 7: each call of the face backend's combined entry
    (one per main-pass batch) and the frames whose person half holds a box;
    each composed crop and whether a person box shaped it."""
    from person_capture_tpu_torch.core import compose_profiles as CP

    submit = face.submit_wire_with_person

    def combined(person, frames, valid, frame_idxs=None):
        dispatches.append(len(frames))
        fetch = submit(person, frames, valid, frame_idxs)
        valid = list(valid)

        def fetch_and_read():
            out_face, out_person = fetch()
            for slot, idx in enumerate(frame_idxs):
                if valid[slot]:
                    persons[int(idx)] = int(out_person["mask"][slot].sum())
            return out_face, out_person

        return fetch_and_read

    compose = CP.compose_dataset_crop

    def composed_crop(*a, **kw):
        composed.append(kw.get("subject_box") is not None)
        return compose(*a, **kw)

    face.submit_wire_with_person = combined
    CP.compose_dataset_crop = composed_crop

    def restore():
        del face.submit_wire_with_person
        CP.compose_dataset_crop = compose

    return restore


def phase_defaults(work: str) -> dict:
    """Phase 7: the CLI defaults with curation off (see the module
    docstring)."""
    import copy

    import cv2
    import numpy as np
    import torch

    from person_capture_tpu_torch.hdr.stills import (
        HdrExportParams, render_sdr_crop_from_p010, scale_crop_xyxy_to_source)
    from person_capture_tpu_torch.video.probe import color_range_full

    fixture = make_fixture(os.path.join(work, "defaults"), draw_body=True,
                           face_px=DEFAULT_FACE_PX)
    vid, ref_path, truth = fixture
    composed, dispatches, persons, restores = [], [], {}, []

    def hook(runtime, eng):
        require(runtime["person"] is not None,
                "the defaults built no person detector")
        restores.append(_watch_defaults_run(runtime["inner_face"], composed,
                                            dispatches, persons))

    try:
        run = run_cli(work, "defaults", fixture, DEFAULT_SETS, hook=hook)
    finally:
        for restore in restores:
            restore()
    face, person = run["runtime"]["inner_face"], run["runtime"]["person"]
    cfg, rows, hits = run["cfg"], run["rows"], run["hit_frames"]
    stages = run["engine"]._timer.summary()
    batches = stages["main.submit"]["count"]
    require(batches > 0 and len(dispatches) == batches,
            f"{len(dispatches)} combined dispatches for {batches} main-pass "
            f"batches")
    share = float(np.mean([persons.get(f, 0) > 0 for f in hits]))
    require(share >= 0.5, f"person boxes on only {share:.0%} of the hit "
            f"frames")
    around = sum(composed)
    require(around >= 1, f"no crop of {len(composed)} composed around a "
            f"person box")

    # one step on 64 analysis frames: combined program against face only
    cap = cv2.VideoCapture(vid)
    cap.set(cv2.CAP_PROP_POS_FRAMES, TRUTH_SEGMENTS[0][0])
    frames = np.stack([cap.read()[1] for _ in range(64)])
    cap.release()
    valid = np.ones(64, bool)
    idxs = np.arange(64) + TRUTH_SEGMENTS[0][0]
    step = in_turns({
        "combined_ms": lambda: face.submit_wire_with_person(
            person, frames, valid, idxs)(),
        "face_only_ms": lambda: face.submit_batch(frames, valid, idxs)()},
        timer=wall_ms)

    # the first still: madvr_like against the fast fused render, and the
    # madvr_like render on the card against the same render on the CPU
    r = rows[0]
    src = _P010FromVideo(vid)
    y, uv = src.get_planes(int(r["frame"]))
    src.release()
    crop = scale_crop_xyxy_to_source(
        [float(r[k]) for k in ("x1", "y1", "x2", "y2")], (640, 480),
        (HDR_W, HDR_H))
    full_range = color_range_full(vid)
    madvr = HdrExportParams.from_cfg(cfg, "pq", full_range)
    fast_cfg = copy.copy(cfg)
    fast_cfg.hdr_sdr_quality = "fast"
    fast_cfg.hdr_sdr_contrast_recovery = 0.0
    fast = HdrExportParams.from_cfg(fast_cfg, "pq", full_range)
    require(madvr.color_match and madvr.speckle_cleanup
            and madvr.contrast_recovery > 0, "the defaults are not madvr_like")
    got = render_sdr_crop_from_p010(y, uv, crop, madvr)
    on_cpu = render_sdr_crop_from_p010(
        y, uv, crop, HdrExportParams(**{**madvr.__dict__, "device": "cpu"}))
    lsb, differ_share = differ(torch.from_numpy(got), torch.from_numpy(on_cpu))
    # a one-step rounding difference of the clean tone-map (GPU against CPU
    # pow) can become two after the colour match's LUT
    require(lsb <= 2 and differ_share <= DIFFER_LIMIT, f"madvr_like still "
            f"on the card vs the CPU: {lsb} LSB, {differ_share:.4%} differ")
    renders = in_turns({
        "madvr_like_ms": lambda: render_sdr_crop_from_p010(y, uv, crop,
                                                           madvr),
        "fast_ms": lambda: render_sdr_crop_from_p010(y, uv, crop, fast)},
        timer=wall_ms)
    emit(phase="defaults", truth_spans=truth, hits=len(hits),
         hit_frames=hits, stills=len(rows), main_batches=batches,
         combined_dispatches=len(dispatches),
         person_box_share_of_hit_frames=share,
         crops_composed=len(composed), crops_around_person_box=around,
         launches=run["launches"],
         launches_note="0 expected: contrast recovery 0.30 routes the "
                       "stills to the general torch chain, as in the JAX "
                       "package",
         setup_seconds=run["setup_seconds"], seconds=run["seconds"],
         source_frames_per_s=150 / run["seconds"],
         prescan_spans=run["result"].spans,
         stages=stages, step_batch=64, step=step,
         still_shape=list(got.shape), still=renders,
         madvr_card_vs_cpu_max_lsb=lsb,
         madvr_card_vs_cpu_differing_share=differ_share)
    return run["launches"], fixture


def watch_curator(seen: dict):
    """Spy on ``Curator.describe``: counts the describe batches it submits
    to the face backend, keeps the CLIP backend it was given, and sets
    ``seen["curating"]`` while it runs. Returns the function that undoes
    it."""
    from person_capture_tpu_torch.curator import core as CC

    describe = CC.Curator.describe
    seen.update(describe_batches=0, curating=False, clip_backend="unset")

    class Counted:
        def __init__(self, face):
            self.face = face

        def submit_batch(self, frames, valid, frame_idxs=None):
            seen["describe_batches"] += 1
            return self.face.submit_batch(frames, valid, frame_idxs)

    def spied(self, paths, fps_hint=30.0):
        face, self.face = self.face, Counted(self.face)
        seen.update(clip_backend=self.clip, curating=True)
        try:
            return describe(self, paths, fps_hint)
        finally:
            self.face = face
            seen["curating"] = False

    CC.Curator.describe = spied
    return lambda: setattr(CC.Curator, "describe", describe)


IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp")


def check_curation(out: str) -> dict:
    """``dataset_out/`` holds metrics.json, selection_debug.csv and 1 to
    min(200, crops) images, each one of the run's crops; returns the
    curator's metrics with the selected names."""
    ds = os.path.join(out, "dataset_out")
    require(os.path.isdir(ds), "no dataset_out/ after a run with curation")
    files = os.listdir(ds)
    require("metrics.json" in files and "selection_debug.csv" in files,
            f"dataset_out/ lacks metrics.json or selection_debug.csv: "
            f"{sorted(files)}")
    picked = sorted(f for f in files if f.lower().endswith(IMAGE_EXTS))
    crops = {f for f in os.listdir(os.path.join(out, "crops"))
             if f.lower().endswith(IMAGE_EXTS)}
    require(1 <= len(picked) <= min(200, len(crops)),
            f"{len(picked)} images selected from {len(crops)} crops")
    stray = sorted(set(picked) - crops)
    require(not stray, f"selected files that are not crops: {stray}")
    with open(os.path.join(ds, "metrics.json")) as fh:
        metrics = json.load(fh)
    return dict(metrics, crops=len(crops), selected_files=picked)


def phase_curate(work: str, fixture) -> tuple:
    """Phase 8: the CLI defaults whole — phase 7's fixture and settings with
    curation on."""
    seen = {}
    restore = watch_curator(seen)
    try:
        run = run_cli(work, "curate", fixture, sets=())
    finally:
        restore()
    cur = check_curation(run["out"])
    require(seen["describe_batches"] >= 1, "the curator dispatched no "
            "describe batch")
    require(seen["clip_backend"] is None, "the curator got a CLIP backend "
            "at the defaults (no ReID match mode)")
    emit(phase="curate", hits=len(run["rows"]), hit_frames=run["hit_frames"],
         stills=len(run["rows"]), crops=cur["crops"], pool=cur["pool"],
         selected=cur["selected"], selected_files=cur["selected_files"],
         scenes=cur["scenes"], categories=cur["categories"],
         curator_wall_s=cur["wall_s"],
         describe_batches=seen["describe_batches"],
         launches=run["launches"], setup_seconds=run["setup_seconds"],
         seconds=run["seconds"], stages=run["engine"]._timer.summary())
    return run["launches"], run["hit_frames"]


def vit_flops(cfg, n: int) -> float:
    """Multiply-adds ×2 of the CLIP tower on ``n`` crops: patch embed, per
    layer qkv / attention / out / MLP, the projection."""
    t = (cfg.image_size // cfg.patch) ** 2 + 1
    w = cfg.width
    per_layer = (2 * t * w * 3 * w + 2 * 2 * t * t * w + 2 * t * w * w
                 + 2 * 2 * t * w * 4 * w)
    embed = 2 * (t - 1) * 3 * cfg.patch ** 2 * w
    return float(n * (embed + cfg.layers * per_layer + 2 * w * cfg.embed_dim))


BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak


def phase_reid(work: str, fixture) -> dict:
    """Phase 9: ``--match-mode either`` with the bundled clip_reid_s on
    phase 7's fixture (curation on), then a ViT-L-14 tower at random init,
    bf16 against fp32 on 16 of the run's person crops, and the device time
    of a 16-crop batch of each tower in turns."""
    import numpy as np
    import torch

    from person_capture_tpu_torch.models import clip_vit as CV
    from person_capture_tpu_torch.pipeline.backends import ClipReidBackend

    seen = {}
    calls = {"seed": 0, "main": 0, "curator": 0, "crops": []}

    def hook(runtime, eng):
        reid = runtime["reid"]
        require(isinstance(reid, ClipReidBackend)
                and reid.embed_dim == CV.REID_S.embed_dim,
                "--match-mode either did not build the bundled ReID tower")
        extract, seed = reid.extract, eng._seed_reid_ref

        def counted(crops):
            key = ("seed" if calls.get("seeding") else
                   "curator" if seen.get("curating") else "main")
            calls[key] += 1
            if key == "main":
                calls["crops"] += [np.array(c) for c in
                                   crops[:16 - len(calls["crops"])]]
            return extract(crops)

        def seeding(paths):
            calls["seeding"] = True
            try:
                return seed(paths)
            finally:
                calls["seeding"] = False

        reid.extract = counted
        eng._seed_reid_ref = seeding

    restore = watch_curator(seen)
    try:
        run = run_cli(work, "reid", fixture, sets=(),
                      flags=("--match-mode", "either"), hook=hook)
    finally:
        restore()
    reid = run["runtime"]["reid"]
    require(calls["main"] >= 1, "the main pass never called the ReID tower")
    require(seen["clip_backend"] is reid, "the curator did not get the ReID "
            "backend as its clip_backend")
    require(calls["curator"] >= 1, "the curator never embedded its pool")
    cur = check_curation(run["out"])

    crops = calls["crops"]
    crops = (crops * 16)[:16]
    big = ClipReidBackend(cfg=CV.VIT_L_14, device="cuda")
    plain = ClipReidBackend(cfg=CV.VIT_L_14, dtype=torch.float32,
                            device="cuda")
    require(big.dtype == torch.bfloat16, "the ReID tower's default dtype "
            "is not bf16")
    cos = (big.extract(crops) * plain.extract(crops)).sum(-1)
    require(float(cos.min()) >= 0.99, f"ViT-L-14 bf16 vs fp32 on the card: "
            f"cosine {cos.min():.5f} < 0.99")

    def device_batch(be):
        x = np.stack([be._preprocess(c) for c in crops]).astype(np.float32)
        return torch.from_numpy(x).cuda()

    x_big, x_small = device_batch(big), device_batch(reid)
    torch.cuda.synchronize()
    times = in_turns({
        "vit_l_14_ms": lambda: CV.encode_images(big.model, x_big),
        "vit_l_14_fp32_ms": lambda: CV.encode_images(plain.model, x_big),
        "reid_s_ms": lambda: CV.encode_images(reid.model, x_small)},
        timer=lambda fn: cuda_ms(fn, reps=5, inner=3, warmup=2))
    flops = {name: vit_flops(cfg, 16)
             for name, cfg in (("vit_l_14", CV.VIT_L_14),
                               ("reid_s", CV.REID_S))}
    emit(phase="reid", hits=len(run["rows"]), hit_frames=run["hit_frames"],
         stills=len(run["rows"]), reid_seed_calls=calls["seed"],
         reid_main_pass_calls=calls["main"],
         reid_curator_calls=calls["curator"], pool=cur["pool"],
         selected=cur["selected"], curator_wall_s=cur["wall_s"],
         describe_batches=seen["describe_batches"],
         vit_l_14_bf16_vs_fp32_cosine=[float(c) for c in cos],
         batch=16, batch_ms=times,
         gflop_per_batch={k: v / 1e9 for k, v in flops.items()},
         bf16_bound_ms={k: v / BF16_OPS_PER_S * 1e3
                        for k, v in flops.items()},
         launches=run["launches"], setup_seconds=run["setup_seconds"],
         seconds=run["seconds"], stages=run["engine"]._timer.summary())
    return run["launches"]


def phase_yolo_face(work: str, fixture) -> dict:
    """Phase 10: ``--face-model yolov8n-face`` (the bundled YOLOv8-face
    weights) on phase 4's fixture, curation off."""
    from person_capture_tpu_torch.models import yolov8 as YV

    run = run_cli(work, "yolo_face", fixture, sets=("curate_enable=false",),
                  flags=("--face-model", "yolov8n-face"))
    face = run["runtime"]["inner_face"]
    require(run["runtime"]["face_cfg"] is YV.YOLOV8N_FACE
            and isinstance(face.scrfd_model, YV.YoloV8),
            "--face-model yolov8n-face did not build the YOLOv8-face "
            "detector")
    probes = run["engine"].backend.policy.affine_probes
    require(probes, "the YOLOv8-face run has no ±45/±135° probes")
    emit(phase="yolo_face", hits=len(run["rows"]),
         hit_frames=run["hit_frames"], stills=len(run["rows"]),
         affine_probes=probes, launches=run["launches"],
         setup_seconds=run["setup_seconds"], seconds=run["seconds"],
         prescan_spans=run["result"].spans,
         stages=run["engine"]._timer.summary())
    return run["launches"]


def phase_diag(work: str, fixture) -> dict:
    """Phase 11: phase 4's fixture and settings with ``--set
    hdr_speckle_diag=true``: one ``speckle_diag.json`` (5 variants) per
    still, and the first still's variant renders against the plain render
    of the same crop (the CPU chain), ≤ 1 LSB in at most ``DIFFER_LIMIT``
    of the pixels."""
    import cv2
    import torch

    from person_capture_tpu_torch.hdr.diagnostics import (DIAG_VARIANTS,
                                                          plane_stats)
    from person_capture_tpu_torch.hdr.stills import (HdrExportParams,
                                                     render_sdr_crop_from_p010)
    from person_capture_tpu_torch.video.probe import color_range_full

    run = run_cli(work, "diag", fixture, SLICE_SETS + (
        "hdr_speckle_diag=true",))
    rows, launches = run["rows"], run["launches"]
    diag = os.path.join(run["out"], "hdr_speckle_diag")
    reports = {}
    for r in rows:
        base = os.path.splitext(r["crop_path"])[0]
        path = os.path.join(diag, base, "speckle_diag.json")
        require(os.path.isfile(path), f"no speckle report for {base}")
        with open(path) as fh:
            reports[base] = json.load(fh)
        require(len(reports[base]["variants"]) == 5,
                f"{base}: {len(reports[base]['variants'])} variants, not 5")
    require(launches["hdr_to_sdr_bgr"] >= 6 * len(rows),
            f"{launches['hdr_to_sdr_bgr']} fused launches for {len(rows)} "
            f"stills with 5 diagnostic renders each")

    first = os.path.splitext(rows[0]["crop_path"])[0]
    crop = reports[first]["crop"]
    src = _P010FromVideo(fixture[0])
    y, uv = src.get_planes(int(rows[0]["frame"]))
    src.release()
    base_params = HdrExportParams.from_cfg(run["cfg"], "pq",
                                           color_range_full(fixture[0]))
    checked = {}
    for var in DIAG_VARIANTS:
        p = HdrExportParams(**{**base_params.__dict__,
                               "tonemap": var["tonemap"],
                               "full_range": var["full_range"],
                               "color_match": False, "speckle_cleanup": False,
                               "dither": False, "device": "cpu"})
        want = render_sdr_crop_from_p010(y, uv, crop, p)
        got = cv2.imread(os.path.join(diag, first,
                                      f"diag_{var['name']}.png"))
        require(got is not None and got.shape == want.shape,
                f"diag_{var['name']}.png missing or of another shape")
        lsb, share = differ(torch.from_numpy(got), torch.from_numpy(want))
        require(lsb <= 1 and share <= DIFFER_LIMIT, f"{var['name']}: "
                f"report render vs plain: {lsb} LSB, {share:.4%} differ")
        stats = reports[first]["variants"][var["name"]]["stats"]
        plain = plane_stats(want)
        gap = max(abs(stats[c][k] - plain[c][k]) for c in plain
                  for k in plain[c])
        require(gap <= 1.0, f"{var['name']}: report statistics vs the plain "
                f"render differ by {gap}")
        checked[var["name"]] = dict(max_lsb=lsb, differing_share=share,
                                    max_stat_gap=gap)
    emit(phase="diag", hits=len(rows), stills=len(rows),
         reports=len(reports), launches=launches,
         launches_per_still=launches["hdr_to_sdr_bgr"] / len(rows),
         first_still=first, crop=crop, first_vs_plain=checked,
         speckle_pixels={k: v["speckle_pixels"] for k, v in
                         reports[first]["variants"].items()},
         diag_wall_s=reports[first]["wall_s"], seconds=run["seconds"])
    return launches


def export_onnx(work: str) -> tuple:
    """SCRFD-2.5G at det 640 and the bundled ArcFace as ONNX graphs, written
    by the port's exporter from the bundled weights."""
    from person_capture_tpu_torch.tools import onnx_export

    paths = []
    for model in ("scrfd_2.5g", "arcface_synth"):
        path = os.path.join(work, f"{model}.onnx")
        require(onnx_export.main(["--model", model, "--out", path,
                                  "--det-size", "640"]) == 0,
                f"onnx_export of {model} failed")
        paths.append(path)
    return tuple(paths)


def phase_onnx(work: str, fixture) -> dict:
    """Phase 12: ONNX weights on phase 4's fixture at det 640. In fp32 the
    same hit frames as the native ``.npz`` weights in fp32; in bf16 every
    hit inside the truth spans and both spans hit; then the 64-frame step,
    ONNX against native (bf16), in turns."""
    import cv2
    import numpy as np

    from person_capture_tpu_torch.models.onnx_zoo import (OnnxArcFaceEncoder,
                                                          OnnxScrfdDetector)

    vid, ref_path, truth, native_runtime = fixture
    scrfd, arcface = export_onnx(work)
    onnx_flags = ("--scrfd-weights", scrfd, "--arcface-weights", arcface)
    fp32 = ("--compute-dtype", "float32")
    # the exported graph has the spatial shapes of det 640, so the
    # full-frame rescue (det 1408) cannot run it: off in all three runs
    sets = SLICE_SETS + ("face_fullframe_when_missed=false",)
    native32 = run_cli(work, "native_fp32", fixture[:3], sets, flags=fp32)
    onnx32 = run_cli(work, "onnx_fp32", fixture[:3], sets,
                     flags=onnx_flags + fp32)
    require(onnx32["hit_frames"] == native32["hit_frames"],
            f"fp32 ONNX hits {onnx32['hit_frames']} != native "
            f"{native32['hit_frames']}")
    run = run_cli(work, "onnx", fixture[:3], sets, flags=onnx_flags)
    face = run["runtime"]["inner_face"]
    require(isinstance(face.scrfd_model, OnnxScrfdDetector)
            and isinstance(face.arcface_model, OnnxArcFaceEncoder),
            "the ONNX run did not build the ONNX adapters")

    cap = cv2.VideoCapture(vid)
    cap.set(cv2.CAP_PROP_POS_FRAMES, TRUTH_SEGMENTS[0][0])
    frames = np.stack([cap.read()[1] for _ in range(64)])
    cap.release()
    valid = np.ones(64, bool)
    idxs = np.arange(64) + TRUTH_SEGMENTS[0][0]
    native = native_runtime["inner_face"]
    step = in_turns({
        "onnx_ms": lambda: face.submit_batch(frames, valid, idxs)(),
        "native_ms": lambda: native.submit_batch(frames, valid, idxs)()},
        timer=wall_ms)
    emit(phase="onnx", onnx_files=[os.path.basename(p) for p in
                                   (scrfd, arcface)],
         fp32_hit_frames=onnx32["hit_frames"],
         native_fp32_hit_frames=native32["hit_frames"],
         bf16_hits=len(run["rows"]), bf16_hit_frames=run["hit_frames"],
         truth_spans=truth, launches=run["launches"],
         seconds={"onnx_bf16": run["seconds"], "onnx_fp32": onnx32["seconds"],
                  "native_fp32": native32["seconds"]},
         step_batch=64, step=step, stages=run["engine"]._timer.summary())
    return run["launches"]


# phase 13's corpus: video 1 is phase 8's; videos 2 and 3 come from the
# same generator with these seeds and truth spans
SWEEP_VIDEOS = ((7, [(10, 50, 0), (96, 130, 0)]),
                (11, [(30, 70, 0), (100, 140, 0)]))


def phase_sweep(work: str, body_fixture, curate_hits) -> dict:
    """Phase 13: the port's sweep at the CLI defaults (curation on) over 3
    videos — phase 8's fixture and two more of the same generator, PQ-coded
    with HDR stills from ``_P010FromVideo`` as in phases 4-10 — with
    ``--yolo`` a ``.pt`` state dict written from the bundled YOLOv8n weights
    and ``--arcface-weights`` a converted ``src/`` dump of the bundled
    ArcFace; then the same sweep again (3 resumed), and ``doctor --json``.
    (The fixture's SDR source is another input: a CPU run of it saves 28
    crops where the PQ-coded video, analysed through the tone-mapped
    reader, saves phase 8's 11.)"""
    import csv

    import torch

    from person_capture_tpu_torch import main as M
    from person_capture_tpu_torch import sweep
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import yolov8 as YV
    from person_capture_tpu_torch.models.loaders import torch_state_dict
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.tools import convert_weights

    root = os.path.join(work, "sweep")
    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus, exist_ok=True)
    truths = {"v1.mp4": body_fixture[2]}
    os.symlink(os.path.abspath(body_fixture[0]),
               os.path.join(corpus, "v1.mp4"))
    for i, (seed, segments) in enumerate(SWEEP_VIDEOS, start=2):
        vid, _, truth = make_fixture(os.path.join(root, f"gen{i}"), seed=seed,
                                     segments=segments, draw_body=True,
                                     face_px=DEFAULT_FACE_PX)
        os.symlink(os.path.abspath(vid), os.path.join(corpus, f"v{i}.mp4"))
        truths[f"v{i}.mp4"] = truth

    yolo_pt = os.path.join(root, "yolov8n.pt")
    torch.save({k: torch.from_numpy(v) for k, v in torch_state_dict(
        "yolov8", resolve_weights("auto", "yolov8n"), YV.YOLOV8N).items()},
        yolo_pt)
    arc_pt = os.path.join(root, "arcface_synth.pt")
    torch.save({k: torch.from_numpy(v) for k, v in torch_state_dict(
        "arcface", resolve_weights("auto", "arcface_synth"),
        AF.SYNTH_R18).items()}, arc_pt)
    arc_src = os.path.join(root, "arcface_synth_src.npz")
    require(convert_weights.main(["--src", arc_pt, "--kind", "arcface",
                                  "--out", arc_src]) == 0,
            "convert_weights failed")

    out = os.path.join(root, "out")
    argv = ["--videos", corpus, "--ref", body_fixture[1], "--out", out,
            "--prescan", "--set", "prescan_cache_mode=off",
            "--set", "tpu_profile=true", "--yolo", yolo_pt,
            "--arcface-weights", arc_src]
    builds = []
    build, make = M.build_runtime, M.make_engine

    def counted(*a, **k):
        builds.append(1)
        return build(*a, **k)

    def with_p010(*a, **k):
        # the HDR planes of phases 4-10, read from the fixture itself, so
        # the run needs no ffmpeg
        eng = make(*a, **k)
        eng.hdr_source_factory = lambda video, w, h, fps: _P010FromVideo(
            video)
        return eng

    def summary():
        with open(os.path.join(out, "sweep_summary.json")) as fh:
            return json.load(fh)

    M.build_runtime, M.make_engine = counted, with_p010
    try:
        reset_launches()
        t0 = time.perf_counter()
        rc = sweep.main(argv)
        sweep_s = time.perf_counter() - t0
        launches = read_launches()
        first = summary()
        again = sweep.main(argv)
        resumed = summary()
    finally:
        M.build_runtime, M.make_engine = build, make
    require(rc == 0 and again == 0, f"sweep exit codes {rc}, {again}")
    require(len(builds) == 1, f"build_runtime called {len(builds)} times")
    require(first["processed"] == 3 and first["failed"] == 0,
            f"sweep: processed {first['processed']}, failed "
            f"{first['failed']}")
    require(resumed["resumed"] == 3 and resumed["processed"] == 3,
            f"second sweep: {resumed['resumed']} resumed of "
            f"{resumed['processed']}")
    hits = {}
    for name, truth in truths.items():
        stem = os.path.splitext(name)[0]
        with open(os.path.join(out, stem, "index.csv")) as fh:
            frames = [int(r["frame"]) for r in csv.DictReader(fh)]
        outside = [f for f in frames if not any(s <= f <= e
                                                for s, e in truth)]
        require(bool(frames) and not outside, f"{name}: hits {frames}, "
                f"outside the truth spans {truth}: {outside}")
        require(os.path.isdir(os.path.join(out, stem, "dataset_out")),
                f"{name}: no dataset_out/ (curation)")
        hits[name] = frames
    require(hits["v1.mp4"] == curate_hits, f"video 1 hits {hits['v1.mp4']} "
            f"!= phase 8's {curate_hits}")

    doc = subprocess.run(
        [sys.executable, "-m", "person_capture_tpu_torch.doctor", "--json",
         "--skip-decode", "--cache-dir", os.path.join(root, "cache"),
         "--sweep-root", out], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    report = json.loads(doc.stdout)
    device = report.get("device", {})
    require(doc.returncode == 0 and device.get("ok")
            and device.get("device") == torch.cuda.get_device_name(0),
            f"doctor --json: rc {doc.returncode}, device {device}")
    emit(phase="sweep", videos=len(truths), truth_spans=truths, hits=hits,
         runtime_builds=len(builds), seconds=sweep_s,
         seconds_per_video={r["video"]: r["wall_s"]
                            for r in first["results"]},
         summary={k: first[k] for k in ("corpus", "processed", "failed")},
         resumed_on_second_run=resumed["resumed"],
         launches=launches, doctor_device=device,
         doctor_sweep=report.get("sweep"))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # fails here, before any phase prints, outside a checkout of the repo
    import person_capture_tpu_torch.main  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    phase_build()
    planar, fused = phase_kernel()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=scratch) as work:
        rows, launches, fixture = phase_pipeline(work)
        phase_preview(work, fixture)
        planar_err, still = phase_main_path_shape(rows)
        defaults_launches, body_fixture = phase_defaults(work)
        curate_launches, curate_hits = phase_curate(work, body_fixture)
        later = {"curate": curate_launches,
                 "reid": phase_reid(work, body_fixture),
                 "yolo_face": phase_yolo_face(work, fixture[:3]),
                 "diag": phase_diag(work, fixture[:3]),
                 "onnx": phase_onnx(work, fixture),
                 "sweep": phase_sweep(work, body_fixture, curate_hits)}
    source = "person_capture_tpu_torch/csrc/tonemap.cu"
    replaces = "person_capture_tpu/kernels/hdr.py:217"

    def later_launches(name):
        return {f"launches_{phase}": counts[name]
                for phase, counts in later.items()}

    print(json.dumps({"kernels": [{
        "name": "hdr_to_sdr_bgr", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["hdr_to_sdr_bgr"],
        "launches_defaults": defaults_launches["hdr_to_sdr_bgr"],
        **later_launches("hdr_to_sdr_bgr"),
        "max_abs_err": max(fused["max_lsb"], still["max_lsb"]),
        "max_abs_err_unit": "8-bit steps",
        "max_differing_share": max(fused["max_differing_share"],
                                   still["max_differing_share"]),
        "pows_per_px": fused["pows_per_px"],
        "ms": fused["ms"], "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
        "library_ms": None, "unfused_ms": fused["unfused_ms"],
        "shape": fused["shape"],
        "still": {k: still[k] for k in ("shape", "ms", "plain_ms",
                                        "unfused_ms", "bound_ms", "bound_by",
                                        "pows_per_px")},
    }, {
        "name": "tonemap_planes", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["tonemap_planes"],
        "launches_defaults": defaults_launches["tonemap_planes"],
        **later_launches("tonemap_planes"),
        "max_abs_err": max(planar["max_abs_err"], planar_err),
        "ms": planar["ms"], "plain_ms": planar["plain_ms"],
        "bound_ms": planar["bound_ms"], "bound_by": planar["bound_by"],
        "pows_per_px": planar["pows_per_px"],
        "library_ms": None, "shape": planar["shape"],
        "note": "counterpart of the public tonemap_planes_pallas; the main "
                "path renders through the fused entry of the same source",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
