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

14. train   — each trainer (``train/*_synth.py``) at its CLI default
              width (SCRFD-2.5G, YOLOv8n and YOLOv8n-face at 256 px and
              batch 32, ArcFace SYNTH_R18 on 112-px chips and CLIP
              clip_reid_s at 96 px, batch 48): three steps on the card with
              TF32 off against three on the CPU (batch 2), losses rel
              ≤ 1e-3; FLOPs of a step (``utils/mfu.program_cost``) and its
              device time on one made batch; 20 steps through ``train()``
              with a checkpoint dir at the torch defaults (ms per step, the
              median after 3 steps, host batch making included), finite
              losses, then a resume at step 20; the ``--out`` file, float16,
              loads strictly through ``bridge.load_*``; MFU against the
              card's TF32 peak. SCRFD-2.5G at ``--dtype bfloat16``, finite
              losses. ``FaceEmbedder`` on a frame of phase 4's fixture
              finds the backend's faces; ``host_align=True`` against the
              fused chain on 8 of its frames (both from BGR): the same
              slots, cosine ≥ 0.99, both timed in turns.

15. gui     — the GUI shell (``gui_app.MainWindow``) under the repo's
              fake Qt (``tests/fake_qt.py``, loaded by path and installed as
              ``PySide6``), its default backend (SCRFD-2.5G and ArcFace
              SYNTH_R18 bundled, det 640, bf16) on the card, phase 4's
              fixture with phase 4's settings typed into the window, run
              through ``on_start``: ``finished(True, "")`` within a time
              limit, hits in the truth spans and every span hit, previews
              through the ``preview`` signal, more fused launches than phase
              4 (the preview pump renders through the fused entry too), and
              a live setting pushed mid-run drained by the engine;
16. mesh    — (a) phase 4 with ``--mesh data:1``: the sharded backend's
              hit frames equal phase 4's; (b) the sharded pre-scan step on
              ``make_mesh("data:2,model:2", devices=[cuda:0] * 4)`` (two
              replicas on the one card, each with its wide layers split in
              two) against the unsharded backend on one 64-frame batch of
              the fixture: masks and slots identical, the same ``best_fd``
              decisions, ``best_fd`` within 2e-2 and boxes within 0.5 px,
              both timed in turns; (c) two processes of the CLI on the one
              card (``PERSON_CAPTURE_SHARE_CARDS=1``) with ``--multihost
              --coordinator 127.0.0.1:<port> --num-processes 2 --mesh
              data:2``: both exit 0 within their time limit, and
              ``out/index.csv`` and ``out/.proc1/index.csv`` hold phase 4's
              frames.
17. sharded — (a) the spatially sharded full-frame detect: SCRFD-2.5G
              (bundled) at det 1408 with H split over ``data:1,model:4`` on
              four entries of the card, against the unsharded
              ``detect_faces`` on 4 canvases (a drawn face inside every
              slab, one across every slab edge), in fp32 (TF32 off) and
              bf16: masks and slots identical, scores within 1e-3 (fp32),
              boxes within 0.5 px, both timed in turns; (b) the sharded
              train step, SCRFD-2.5G at the trainer's defaults (256 px,
              batch 32) on ``data:2,model:2`` over four entries of the
              card, against the unsharded step on the same weights and 3
              batches, TF32 off: losses rel ≤ 1e-3, npos equal, running
              statistics within 1e-3, ms per step of both in turns; (c) a
              model axis across processes: two processes sharing the card
              (``PERSON_CAPTURE_SHARE_CARDS=1``, ``--coordinator``-style
              join), one entry each of ``data:1,model:2``, run the sharded
              pre-scan step (phase 16(b)'s models, det 640, bf16) on 8
              frames of its batch: masks and slots identical on both
              ranks, ``best_fd`` within 2e-2 of the single-process
              ``data:1`` step; ms per step against the same mesh in one
              process; (d) ``dryrun.dryrun_multichip(8, full=True)`` and
              its summary line.
18. user paths — the paths of the CLI that phases 4-17 leave out:
              (a) the verify recipe as users type it: a 320×240 SDR video
              (faces in (20, 60) and (90, 120), seed 1), ``--batch 8
              --det-size 320 --face-det-conf 0.3 --face-thresh 0.9`` at the
              defaults otherwise, read by the plain SDR reader: the frames
              20, 22, …, 60 and 90, 92, …, 120, every crop decoding, no
              tone-map launch; (b) its rotated twin (``np.rot90(frame,
              3)``, portrait): the same frames, with the recovery ladder's
              probes and ``recovered_faces``; (c) ``--preset
              presets/solidpreset_tpu.json`` with no ``--batch`` on phase
              8's fixture, phase 4's and a 10-s shot of phase 8's kind:
              hits and stills as phase 4 checks them, main-pass batches 128
              frames wide, each crop within 1 px of the ratio it chose and
              all three ratios among the runs, ``dataset_out/`` in each and
              a selection from the long shot; (d) the curator CLI alone over
              (c)'s stills on the card and with ``--device cpu`` at once,
              as typed and at the engine's sharpness gate: the same
              selection; (e) phase 4's settings with ``use_arcface=false``
              (ViT-L-14 at its seeded random init) on (a)'s video in bf16
              and fp32 (TF32 off): every aligned chip embedded by the
              tower, 16 of its chips bf16 against fp32 at cosine ≥ 0.99,
              the same frames but those whose fp32 face distance lies
              within 0.01 of the threshold; (f) ``--reid-weights x.pt``
              written from the bundled clip_reid_s: phase 9's frames; a
              ViT-B-32 tower at a seeded init through a ``.pt`` within 1e-5
              of itself, bf16 against fp32 at cosine ≥ 0.99, the 16-crop
              batch times of both in turns; (g) two ``python -m
              person_capture_tpu_torch.sweep --watch --shard i/2``
              processes sharing the card over an SDR corpus that grows
              from two videos to four while they run: each video run by
              the shard ``shard_select(stable=True)`` names, its
              ``index.csv`` decisions those of a one-process sweep, both
              heartbeats ending ``exited`` as the doctor reads them, and
              the doctor's decode rate.

Phases 8 to 18 reach no hand-written kernel beyond the tone-map: the CLIP
tower, the curator's pHash and MMR, the ONNX interpreter, the loaders, the
sweep, the doctor, the train steps, the GUI and the mesh programs are torch
ops and host code, as they are XLA ops and host code in the JAX package.
Each phase's tone-map launches are counted from 0 just before its run and
printed in the ``kernels`` line.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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


def make_fixture(work: str, seed: int = 1, segments=TRUTH_SEGMENTS,
                 frames: int = 150, size=(640, 480), pq: bool = True,
                 **body):
    """The verify recipe's fixture at ``size``, re-coded as PQ unless
    ``pq=False``: (video, ref, truth). ``body``: ``generate_video``'s
    ``draw_body`` and ``face_px``; another ``seed``, ``segments`` and
    ``frames`` give another video of the same kind."""
    import cv2
    import numpy as np

    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face,
                                                          generate_video,
                                                          write_pq_video)

    os.makedirs(work, exist_ok=True)
    sdr = os.path.join(work, "sdr.mp4")
    vid = os.path.join(work, "vid.mp4")
    sv = generate_video(sdr, width=size[0], height=size[1], fps=30,
                        total_frames=frames, segments=list(segments),
                        moving=True, seed=seed, **body)
    if pq:
        write_pq_video(sdr, vid)
    else:
        vid = sdr
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


def check_crops(out: str) -> list:
    """An SDR run's outputs: every crop of ``index.csv`` decodes; returns
    the index rows."""
    import csv

    import cv2

    with open(os.path.join(out, "index.csv")) as fh:
        rows = list(csv.DictReader(fh))
    for r in rows:
        path = os.path.join(out, "crops", r["crop_path"])
        img = cv2.imread(path)
        require(img is not None and img.size > 0, f"crop {path} does not "
                f"decode")
    return rows


def run_cli(work: str, name: str, fixture, sets, flags=(), hook=None,
            hdr: bool = True):
    """One CLI run through ``build_runtime`` → ``make_engine`` → ``run``
    with HDR stills from ``_P010FromVideo``, the tone-map counts set to 0
    just before the run and read just after; requires the run to succeed
    with hits and stills as :func:`check_stills` does. ``hook(runtime,
    engine)`` runs before the run. ``hdr=False``: an SDR source read as
    such (see :func:`sdr_source`), no HDR planes, every crop decoding
    (:func:`check_crops`)."""
    from person_capture_tpu_torch import main as M

    vid, ref_path, truth = fixture
    out = os.path.join(work, f"out_{name}")
    ap, args, cfg = cli_config(vid, ref_path, out, sets, flags)
    t0 = time.perf_counter()
    runtime = M.build_runtime(cfg, args, ap)
    eng = M.make_engine(cfg, runtime, status=lambda m: None)
    if hdr:
        eng.hdr_source_factory = lambda video, w, h, fps: _P010FromVideo(
            video)
    if hook is not None:
        hook(runtime, eng)
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    require(res.ok, f"{name} run failed: {res.error}")
    rows = check_stills(out, truth) if hdr else check_crops(out)
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


def check_curation(out: str, min_selected: int = 1) -> dict:
    """``dataset_out/`` holds metrics.json, selection_debug.csv and
    ``min_selected`` (1) to min(200, crops) images, each one of the run's
    crops; returns the curator's metrics with the selected names."""
    ds = os.path.join(out, "dataset_out")
    require(os.path.isdir(ds), "no dataset_out/ after a run with curation")
    files = os.listdir(ds)
    require("metrics.json" in files and "selection_debug.csv" in files,
            f"dataset_out/ lacks metrics.json or selection_debug.csv: "
            f"{sorted(files)}")
    picked = sorted(f for f in files if f.lower().endswith(IMAGE_EXTS))
    crops = {f for f in os.listdir(os.path.join(out, "crops"))
             if f.lower().endswith(IMAGE_EXTS)}
    require(min_selected <= len(picked) <= min(200, len(crops)),
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
    return dict(launches=run["launches"], hit_frames=run["hit_frames"],
                crops=crops)


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


# phase 14: each trainer at its CLI default width (train/*.py ``main``)
TRAINERS = (
    ("scrfd_synth", dict(cfg_name="scrfd_2.5g", size=256, batch=32),
     "load_scrfd"),
    ("yolo_synth", dict(cfg_name="yolov8n", size=256, batch=32),
     "load_yolov8"),
    ("yolo_face_synth", dict(cfg_name="yolov8n_face", size=256, batch=32),
     "load_yolov8"),
    ("arcface_synth", dict(cfg_name="arcface_synth", batch=48),
     "load_arcface"),
    ("clip_reid_synth", dict(cfg_name="clip_reid_s", batch=48),
     "load_clip"),
)
TRAIN_STEPS = 20
# the card-against-CPU comparison runs a smaller batch: a CPU step of
# YOLOv8n at 256 px takes seconds per image
PARITY_BATCH = 2


def _quiet(fn, *a, **kw):
    """``fn`` with its standard output captured: ``(result, text)``."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def _logged_losses(text: str) -> list:
    import re

    return [float(v) for v in re.findall(r" loss=([-+0-9.eE]+|nan|inf)",
                                          text)]


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in fp32 without TF32 (matmuls have it off in
    this script): the card held to the CPU."""
    import torch

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def train_parity(mod, kw) -> dict:
    """Three steps on the card (TF32 off) against three on the CPU, from
    the same init and batches."""
    losses = {}
    with _no_tf32():
        for dev in ("cpu", "cuda"):
            run = mod.setup(**{**kw, "batch": PARITY_BATCH}, steps=3,
                            device=dev)
            losses[dev] = [float(run.step(i)["loss"]) for i in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))
    return {"losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
            "max_rel": rel}


def train_device_step(mod, kw, dtype_name: str = "float32") -> dict:
    """FLOPs of one step (forward and backward, ``utils/mfu.
    program_cost``) and its device time on one made batch, back to back
    (``cuda_ms``), at the torch defaults (TF32 convolutions in fp32)."""
    from person_capture_tpu_torch.utils.mfu import program_cost

    run = mod.setup(**kw, steps=TRAIN_STEPS, dtype_name=dtype_name,
                    device="cuda")
    args = run.batch(0)

    def fwd_bwd():
        with run.state.autocast():
            loss, _ = run.loss_fn(*args)
        loss.backward()

    flops = program_cost(fwd_bwd)["flops"]
    ms = cuda_ms(lambda: run.state.step(run.loss_fn, *args), reps=5,
                 inner=5, warmup=2)
    return {"flops": flops, "ms": ms}


def phase_train(work: str, fixture) -> dict:
    """Phase 14: the synthetic-weight trainers at their CLI defaults, the
    facades and ``host_align``; reaches no hand-written kernel."""
    import importlib

    import numpy as np
    import torch

    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import bridge
    from person_capture_tpu_torch.models import clip_vit as CV
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models import yolov8 as YV
    from person_capture_tpu_torch.tools.weights import load_npz_variables
    from person_capture_tpu_torch.train.ckpt import list_checkpoints
    from person_capture_tpu_torch.utils.mfu import chip_peak_tflops

    t_phase = time.perf_counter()
    reset_launches()
    peak_tf32 = chip_peak_tflops("cuda", torch.float32)
    peak_bf16 = chip_peak_tflops("cuda", torch.bfloat16)
    fresh = {"scrfd_synth": lambda c: SD.SCRFD(SD.CONFIGS[c]),
             "yolo_synth": lambda c: YV.YoloV8(YV.CONFIGS[c]),
             "yolo_face_synth": lambda c: YV.YoloV8(YV.CONFIGS[c]),
             "arcface_synth": lambda c: AF.IResNet(AF.CONFIGS[c]),
             "clip_reid_synth": lambda c: CV.ClipViT(CV.CONFIGS[c])}
    trainers = {}
    for name, kw, loader in TRAINERS:
        mod = importlib.import_module(f"person_capture_tpu_torch.train.{name}")
        parity = train_parity(mod, kw)
        require(parity["max_rel"] <= 1e-3,
                f"{name}: card against CPU losses {parity}")
        dev = train_device_step(mod, kw)
        ck = os.path.join(work, f"ck_{name}")
        out = os.path.join(work, f"{name}.npz")
        common = dict(kw, seed=0, log_every=1, eval_every=0, ckpt_dir=ck,
                      device="cuda")
        t0 = time.perf_counter()
        (_, final), text = _quiet(
            mod.train, steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS // 2,
            out=out, **common)
        wall_s = time.perf_counter() - t0
        losses = _logged_losses(text)
        require(len(losses) == TRAIN_STEPS
                and all(np.isfinite(v) for v in losses),
                f"{name}: losses {losses}")
        (_, _), text = _quiet(mod.train, steps=TRAIN_STEPS + 2,
                              ckpt_every=1, **common)
        resumed = _logged_losses(text)
        require(f"(step {TRAIN_STEPS})" in text and len(resumed) == 2
                and all(np.isfinite(v) for v in resumed),
                f"{name}: no resume at step {TRAIN_STEPS}: {text[-400:]}")
        require([s for s, _ in list_checkpoints(ck)]
                == [TRAIN_STEPS + 1, TRAIN_STEPS + 2],
                f"{name}: checkpoints {list_checkpoints(ck)}")
        weights = load_npz_variables(out)
        require(all(v.dtype == np.float16 for v in
                    _flat_values(weights)), f"{name}: not float16")
        getattr(bridge, loader)(fresh[name](kw["cfg_name"]), _f32(weights))
        ms = final["ms_per_step"]
        trainers[name] = {
            **kw, "parity": parity,
            "losses_first_last": [losses[0], losses[-1]],
            "ms_per_step": ms, "device_ms_per_step": dev["ms"],
            "flops_per_step": dev["flops"],
            "tflops": dev["flops"] / ms / 1e9,
            "device_tflops": dev["flops"] / dev["ms"] / 1e9,
            "mfu": dev["flops"] / ms / 1e9 / peak_tf32 if peak_tf32
            else None,
            "device_mfu": dev["flops"] / dev["ms"] / 1e9 / peak_tf32
            if peak_tf32 else None,
            "train_wall_s": wall_s, "eval": {k: v for k, v in final.items()
                                             if k != "ms_per_step"}}
    # bf16: SCRFD-2.5G at its defaults, fp32 parameters under autocast
    mod = importlib.import_module("person_capture_tpu_torch.train."
                                  "scrfd_synth")
    kw = TRAINERS[0][1]
    (_, final), text = _quiet(mod.train, steps=6, seed=0, log_every=1,
                              eval_every=0, dtype_name="bfloat16",
                              device="cuda", **kw)
    bf16_losses = _logged_losses(text)
    require(len(bf16_losses) == 6 and all(np.isfinite(v)
                                           for v in bf16_losses),
            f"bf16 losses {bf16_losses}")
    bf16_dev = train_device_step(mod, kw, "bfloat16")
    facades = phase_train_facades(fixture)
    launches = read_launches()
    emit(phase="train", peak_tflops={"tf32": peak_tf32, "bf16": peak_bf16},
         mfu_peak="tf32 (fp32 runs: cuDNN convolutions in TF32, torch's "
                  "default)", trainers=trainers,
         scrfd_bf16={"losses": bf16_losses, "ms_per_step":
                     final["ms_per_step"], "device_ms_per_step":
                     bf16_dev["ms"], "flops_per_step": bf16_dev["flops"],
                     "device_mfu": bf16_dev["flops"] / bf16_dev["ms"] / 1e9
                     / peak_bf16 if peak_bf16 else None},
         facades=facades, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches


def _flat_values(tree):
    from person_capture_tpu_torch.tools.weights import flatten_tree

    return list(flatten_tree(tree).values())


def _f32(tree):
    from person_capture_tpu_torch.tools.weights import (flatten_tree,
                                                        unflatten_tree)

    return unflatten_tree({k: v.astype("float32")
                           for k, v in flatten_tree(tree).items()})


def phase_train_facades(fixture) -> dict:
    """``FaceEmbedder`` on a frame of phase 4's fixture against its
    backend's ``extract_batch``; ``host_align=True`` against the fused
    chain on 8 of its frames (both from BGR, the wire format aside), and
    both timed in turns."""
    import cv2
    import numpy as np

    from person_capture_tpu_torch.face_embedder import FaceEmbedder
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.pipeline.backends import \
        ScrfdArcFaceBackend

    vid, _ref, truth = fixture[:3]
    sdr = os.path.join(os.path.dirname(vid), "sdr.mp4")
    want = [f for s, e in truth for f in range(s, e + 1, 8)][:8]
    cap = cv2.VideoCapture(sdr)
    frames, i = [], 0
    while len(frames) < len(want):
        ok, frame = cap.read()
        require(ok, f"could not read frame {i} of {sdr}")
        if i in want:
            frames.append(frame)
        i += 1
    cap.release()
    frames = np.stack(frames)
    arc_w = resolve_weights("auto", "arcface_synth")
    fe = FaceEmbedder(ctx="cuda", arcface_model="arcface_synth",
                      arcface_weights=arc_w)
    faces = fe.extract(frames[0])
    direct = fe._backend.inner.extract_batch(frames[:1], np.ones(1, bool))
    boxes = direct["boxes"][0][direct["mask"][0]].astype(np.int32)
    require(len(faces) >= 1 and sorted(map(tuple, boxes.tolist()))
            == sorted(tuple(f["bbox"].tolist()) for f in faces),
            f"FaceEmbedder faces {[f['bbox'] for f in faces]} != the "
            f"backend's {boxes}")
    kw = dict(scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
              arcface_weights=arc_w, device="cuda")
    host = ScrfdArcFaceBackend(SD.SCRFD_2_5G, AF.SYNTH_R18, host_align=True,
                               **kw)
    fused = ScrfdArcFaceBackend(SD.SCRFD_2_5G, AF.SYNTH_R18,
                                transfer_format="bgr", **kw)
    valid = np.ones(len(frames), bool)
    a = host.submit_batch(frames, valid)()
    b = fused.extract_batch(frames, valid)
    m = a["mask"]
    require(m.any() and (b["mask"] == m).all(),
            f"host_align slots {m.sum(1)} != fused {b['mask'].sum(1)}")
    fa, fb = a["feats"][m].astype(np.float64), b["feats"][m].astype(
        np.float64)
    cos = (fa * fb).sum(-1) / (np.linalg.norm(fa, axis=-1)
                               * np.linalg.norm(fb, axis=-1))
    require(cos.min() >= 0.99, f"host_align vs fused cosine {cos.min()}")
    times = in_turns({"host_align": lambda: host.extract_batch(frames, valid),
                      "fused": lambda: fused.extract_batch(frames, valid)},
                     timer=lambda f: wall_ms(f, reps=5, warmup=2))
    return {"face_embedder_faces": len(faces), "frames": want,
            "host_align_faces": int(m.sum()),
            "host_align_vs_fused_min_cosine": float(cos.min()),
            "batch_ms": times}


# phase 15: the settings of phase 4's CLI run, typed into the window — the
# Capture tab's quick controls and the generated All-settings fields
GUI_QUICK = {"ratio": "2:3", "face_thresh": 0.32, "min_gap": 0.0,
             "frame_stride": 2}
GUI_FIELDS = {"compose_detect_person_for_face": False,
              "hdr_sdr_quality": "fast", "hdr_sdr_contrast_recovery": 0.0,
              "prescan_cache_mode": "off", "tpu_batch_frames": 64}
GUI_TIMEOUT_S = 300


def load_fake_qt():
    """``tests/fake_qt.py`` by file path, installed as ``PySide6``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fake_qt.py")
    spec = importlib.util.spec_from_file_location("fake_qt", path)
    fake_qt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake_qt)
    fake_qt.install()
    return fake_qt


def _set_widget(widget, value):
    if isinstance(value, bool):
        widget.setChecked(value)
    elif isinstance(value, (int, float)):
        widget.setValue(value)
    else:
        widget.setText(value)


def phase_gui(work: str, fixture, phase4_launches: dict, phase4_frames):
    """Phase 15: the window with its default backend on the card, driven
    through ``on_start`` on phase 4's fixture."""
    import threading
    from functools import partial

    load_fake_qt()
    from person_capture_tpu_torch import gui_app
    from person_capture_tpu_torch.pipeline.engine import Engine

    vid, ref_path, truth = fixture[:3]
    out = os.path.join(work, "out_gui")
    seen = {"finished": [], "previews": 0, "pushed_running": False}
    lock = threading.Lock()
    running, finished = threading.Event(), threading.Event()

    class Bridge(gui_app.EngineBridge):
        """The window's bridge with the harness's listeners on its
        ``finished`` and ``preview`` signals."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.finished.connect(self._on_finished)
            self.preview.connect(self._on_preview)
            self.status.connect(lambda m: running.set())

        def _on_finished(self, ok, err):
            seen["finished"].append((ok, err))
            finished.set()

        def _on_preview(self, img, idx):
            with lock:
                seen["previews"] += 1

    # the HDR stills read P010 planes from the fixture, as in phase 4
    bridge_cls, engine_cls = gui_app.EngineBridge, gui_app.Engine
    gui_app.EngineBridge = Bridge
    gui_app.Engine = partial(
        Engine, hdr_source_factory=lambda video, w, h, fps:
        _P010FromVideo(video))
    try:
        t0 = time.perf_counter()
        win = gui_app.MainWindow()
        win.video_edit.setText(vid)
        win.ref_list.addItem(ref_path)
        win.out_edit.setText(out)
        win.ratio_edit.setText(GUI_QUICK["ratio"])
        win.face_thresh.setValue(GUI_QUICK["face_thresh"])
        win.min_gap.setValue(GUI_QUICK["min_gap"])
        win.frame_stride.setValue(GUI_QUICK["frame_stride"])
        win.prescan_enable.setChecked(True)
        win.curate_enable.setChecked(False)
        for name, value in GUI_FIELDS.items():
            _set_widget(win._field_widgets[name][0], value)
        setup_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        win.on_start()
        require(win.cfg.device == "cuda", f"device {win.cfg.device}")
        # a LIVE key pushed from the settings tab once the engine reports
        # its first status: it polls its command queue between the
        # pre-scan's batches and the main pass's frames
        if running.wait(GUI_TIMEOUT_S):
            seen["pushed_running"] = win.bridge._thread.is_alive()
            win._field_widgets["preview_every"][0].setValue(2)
        require(finished.wait(GUI_TIMEOUT_S),
                f"the GUI run did not finish within {GUI_TIMEOUT_S} s")
        run_s = time.perf_counter() - t0
        win.bridge._thread.join(timeout=60)
        launches = read_launches()
    finally:
        gui_app.EngineBridge, gui_app.Engine = bridge_cls, engine_cls
    require(seen["finished"] == [(True, "")],
            f"finished signals {seen['finished']}")
    rows = check_stills(out, truth)
    frames = [int(r["frame"]) for r in rows]
    eng = win.bridge._engine
    require(seen["previews"] >= 1, "no preview through the preview signal")
    require(launches["hdr_to_sdr_bgr"] > phase4_launches["hdr_to_sdr_bgr"],
            f"{launches['hdr_to_sdr_bgr']} fused launches, not more than "
            f"phase 4's {phase4_launches['hdr_to_sdr_bgr']}")
    require(seen["pushed_running"] and eng._cmd_q.empty()
            and eng.cfg.preview_every == 2,
            "the live push did not reach the running engine")
    emit(phase="gui", hits=len(rows), hit_frames=frames,
         same_frames_as_phase4=frames == phase4_frames,
         previews=seen["previews"], launches=launches,
         live_push_while_running=seen["pushed_running"],
         setup_seconds=setup_s, seconds=run_s)
    return launches


MESH_CHILD_TIMEOUT_S = 300


def start_processes(logdir: str, specs, env=None):
    """One ``python <args>`` process per ``(name, args)`` of ``specs`` in
    the repo's root, its output to the file ``logdir/<name>.log``: a child
    blocked on a full pipe would stall the others in the collectives.
    Returns ``[(name, process, log path)]``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ if env is None else env, PYTHONUNBUFFERED="1")
    os.makedirs(logdir, exist_ok=True)
    started = []
    for name, args in specs:
        log = os.path.join(logdir, f"{name}.log")
        with open(log, "w") as fh:
            p = subprocess.Popen([sys.executable, *args], cwd=here, env=env,
                                 stdout=fh, stderr=subprocess.STDOUT,
                                 text=True)
        started.append((name, p, log))
    return started


def finish_processes(started, timeout_s: float = MESH_CHILD_TIMEOUT_S):
    """Wait for each process of :func:`start_processes` within
    ``timeout_s`` in all; each must exit 0. Returns ``{name: (its last
    "child" JSON line, its output)}``; every process still running is
    killed."""
    done = {}
    deadline = time.monotonic() + timeout_s
    try:
        for name, p, log in started:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"check failed: {name} ran past "
                                   f"{timeout_s:.0f} s")
            with open(log) as fh:
                text = fh.read()
            require(p.returncode == 0, f"{name} exited {p.returncode}:\n"
                    f"{text[-3000:]}")
            child = [ln for ln in text.splitlines() if '"child"' in ln]
            done[name] = (json.loads(child[-1]), text)
    finally:
        for _, p, _ in started:
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def start_children(logdir: str, entry: str, argvs):
    """One process per ``argvs`` entry running ``chip_smoke.<entry>(argv)``
    on the one card (``PERSON_CAPTURE_SHARE_CARDS=1``: they share it on
    purpose)."""
    code = (f"import sys, chip_smoke; "
            f"sys.exit(chip_smoke.{entry}(sys.argv[1:]))")
    return start_processes(
        logdir, [(f"{entry}{i}", ["-c", code, *argv])
                 for i, argv in enumerate(argvs)],
        env=dict(os.environ, PERSON_CAPTURE_SHARE_CARDS="1"))


def finish_children(started) -> list:
    """The ``"child"`` JSON line of each process of
    :func:`start_children`, as :func:`finish_processes` checks them."""
    return [child for child, _ in finish_processes(started).values()]


def cli_child(argv) -> int:
    """One process of phase 16(c): the CLI's own sequence (``build_config``
    → ``maybe_init_multihost`` → ``build_runtime`` → ``make_engine`` →
    ``run``) with phase 4's P010 source for the stills; prints its fused
    launches and hits as one JSON line."""
    from person_capture_tpu_torch import main as M

    ap = M.build_parser()
    args = ap.parse_args(argv)
    cfg = M.build_config(args, ap)
    M.maybe_pin_platform(cfg)
    cfg.out_dir = M.maybe_init_multihost(args, cfg.out_dir)
    t0 = time.perf_counter()
    eng = M.make_engine(cfg, M.build_runtime(cfg, args, ap),
                        status=lambda m: None)
    eng.hdr_source_factory = lambda video, w, h, fps: _P010FromVideo(video)
    reset_launches()
    res = eng.run()
    emit(child=True, ok=res.ok, error=res.error, out=cfg.out_dir,
         launches=read_launches(), seconds=time.perf_counter() - t0)
    return 0 if res.ok else 1


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _index_frames(out: str) -> list:
    import csv

    with open(os.path.join(out, "index.csv")) as fh:
        return [int(r["frame"]) for r in csv.DictReader(fh)]


def fixture_batch(fixture, n: int, single: bool = False):
    """``n`` frames of the fixture's SDR video (every other one from the
    start), the bundled SCRFD-2.5G and ArcFace weights, and a one-row bank
    from the reference's face (embedded by the unsharded bf16 backend,
    which ``single=True`` returns too)."""
    import cv2
    import numpy as np
    import torch

    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.pipeline.backends import (
        ScrfdArcFaceBackend, extract_single_image)

    vid, ref_path = fixture[:2]
    cap = cv2.VideoCapture(os.path.join(os.path.dirname(vid), "sdr.mp4"))
    frames = []
    while len(frames) < n:
        ok, frame = cap.read()
        require(ok, "the fixture ran out of frames")
        if int(cap.get(cv2.CAP_PROP_POS_FRAMES) - 1) % 2 == 0:
            frames.append(frame)
    cap.release()
    frames = np.stack(frames)
    weights = dict(scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
                   arcface_weights=resolve_weights("auto", "arcface_synth"))
    backend = ScrfdArcFaceBackend(arcface_cfg=AF.SYNTH_R18, det_size=640,
                                  dtype=torch.bfloat16, device="cuda",
                                  transfer_format="bgr", **weights)
    ref = extract_single_image(backend, cv2.imread(ref_path))
    require(ref["mask"][0].any(), "no face in the reference")
    bank = ref["feats"][0][ref["mask"][0]][:1].astype(np.float32)
    out = (frames, weights, bank, np.ones(1, bool))
    return out + (backend,) if single else out


def sharded_vs_unsharded(fixture) -> dict:
    """Phase 16(b): the sharded step on four mesh entries of one card (two
    replicas, each split in two) against the unsharded backend on one
    64-frame batch of the fixture."""
    import numpy as np
    import torch

    from person_capture_tpu_torch.core.bank import fd_min_batch
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.parallel.mesh import (
        build_sharded_prescan_step, make_mesh)

    frames, weights, bank, bank_mask, single = fixture_batch(fixture, 64,
                                                             single=True)
    mesh = make_mesh("data:2,model:2", devices=[torch.device("cuda", 0)] * 4)
    run = build_sharded_prescan_step(
        mesh, arcface_cfg=AF.SYNTH_R18, det_size=640, max_faces=8,
        dtype=torch.bfloat16, scrfd_vars=weights["scrfd_weights"],
        arcface_vars=weights["arcface_weights"])
    got = {k: v.cpu().numpy() for k, v in
           run(frames, bank, bank_mask, score_thresh=0.5).items()}
    want = single.extract_batch(frames, np.ones(64, bool))
    _, best = fd_min_batch(torch.from_numpy(want["feats"]),
                           torch.from_numpy(want["mask"]),
                           torch.from_numpy(bank), torch.from_numpy(bank_mask))
    best = best.numpy()
    m = want["mask"]
    require(np.array_equal(got["mask"], m),
            f"masks differ in {int((got['mask'] != m).sum())} slots")
    require(m.any(), "no face in the batch")
    thresh = GUI_QUICK["face_thresh"]
    require(np.array_equal(got["best_fd"] < thresh, best < thresh),
            "best_fd decisions differ")
    fd_err = float(np.abs(got["best_fd"] - best).max())
    box_err = float(np.abs(got["boxes"][m] - want["boxes"][m]).max())
    require(fd_err <= 2e-2, f"best_fd differs by {fd_err}")
    require(box_err <= 0.5, f"boxes differ by {box_err} px")
    times = in_turns({
        "sharded": lambda: run(frames, bank, bank_mask, 0.5),
        "unsharded": lambda: single.extract_batch(frames,
                                                  np.ones(64, bool))},
        timer=partial_wall_ms)
    return dict(faces=int(m.sum()), frames_with_face=int(m.any(1).sum()),
                matches=int((best < thresh).sum()), best_fd_max_err=fd_err,
                box_max_err_px=box_err, replicas=len(run.replicas),
                column_parallel_layers=sum(
                    type(mod).__name__ == "ColumnParallel"
                    for mod in run.replicas[0].scrfd_model.modules()),
                batch_ms=times)


def partial_wall_ms(fn):
    return wall_ms(fn, reps=5, warmup=2)


def phase_mesh(work: str, fixture, phase4_frames) -> dict:
    """Phase 16: the inference mesh and a 2-process run on the one card."""
    t0 = time.perf_counter()
    run = run_cli(work, "mesh", fixture[:3], SLICE_SETS,
                  flags=("--mesh", "data:1"))
    mesh_s = time.perf_counter() - t0
    require(run["hit_frames"] == phase4_frames,
            f"--mesh data:1 frames {run['hit_frames']} != phase 4's")
    require(type(run["runtime"]["inner_face"]).__name__
            == "ShardedScrfdArcFaceBackend", "the mesh run was not sharded")

    t0 = time.perf_counter()
    step = sharded_vs_unsharded(fixture)
    step_s = time.perf_counter() - t0

    vid, ref_path = fixture[:2]
    out = os.path.join(work, "out_multihost")
    port = _free_port()
    argv = ["--video", vid, "--ref", ref_path, "--out", out, "--prescan",
            "--mesh", "data:2", "--multihost", "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", "2",
            "--set", "prescan_cache_mode=off"]
    for setting in SLICE_SETS:
        argv += ["--set", setting]
    t0 = time.perf_counter()
    children = finish_children(start_children(
        os.path.join(work, "logs"), "cli_child",
        [argv + ["--process-id", str(i)] for i in range(2)]))
    multi_s = time.perf_counter() - t0
    primary = _index_frames(out)
    secondary = _index_frames(os.path.join(out, ".proc1"))
    require(primary == secondary,
            f"ranks differ: {primary} != {secondary}")
    require(primary == phase4_frames,
            f"2-process frames {primary} != phase 4's {phase4_frames}")
    emit(phase="mesh", data1_hit_frames=run["hit_frames"],
         data1_launches=run["launches"], data1_seconds=mesh_s,
         data1_run_seconds=run["seconds"], step=step, step_seconds=step_s,
         multihost_hit_frames=primary,
         multihost_launches=[c["launches"] for c in children],
         multihost_run_seconds=[c["seconds"] for c in children],
         multihost_seconds=multi_s)
    return run["launches"], [c["launches"] for c in children]


# phase 17(a): the full-frame rescue's canvas (face_fullframe_imgsz's
# default) split in four slabs of 352 rows
SPATIAL_SIZE, SPATIAL_SLABS = 1408, 4


def spatial_canvases():
    """Four det-1408 canvases, background 70: canvas i holds one drawn face
    of 80-160 px inside slab i and one across the edge below slab
    ``i % 3``, so every slab holds a face and every edge cuts one."""
    import numpy as np

    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face)

    size, slabs = SPATIAL_SIZE, SPATIAL_SLABS
    h = size // slabs
    rng = np.random.default_rng(17)
    canvases = np.full((slabs, size, size, 3), 70, np.uint8)
    for i in range(slabs):
        s = float(rng.uniform(80, 160))
        x = float(rng.uniform(16, size / 2 - s))
        y = i * h + float(rng.uniform(8, h - 1.1 * s - 8))
        draw_face(canvases[i], FacePlacement(0, 0, (x, y, x + s,
                                                    y + 1.1 * s)))
        edge = h * (i % (slabs - 1) + 1)
        s = float(rng.uniform(80, 160))
        x = float(rng.uniform(size / 2, size - s - 16))
        draw_face(canvases[i], FacePlacement(0, 1, (
            x, edge - 0.55 * s, x + s, edge + 0.55 * s)))
    return canvases.astype(np.float32)


def spatial_vs_unsharded() -> dict:
    """Phase 17(a): SCRFD-2.5G (bundled) at det 1408 with H split over
    ``data:1,model:4`` on four entries of the card, against the unsharded
    ``detect_faces`` on the same 4 canvases: in fp32 (TF32 off) and in
    bf16 the same masks and slots, scores within 1e-3 (fp32) and the same
    decisions (bf16), boxes within 0.5 px; both timed in turns."""
    import numpy as np
    import torch

    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models.bridge import load_scrfd
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.parallel.mesh import (
        build_sharded_fullframe_detect, make_mesh)

    weights = resolve_weights("auto", "scrfd_2.5g")
    canvases = spatial_canvases()
    ones = np.ones(len(canvases), np.float32)
    mesh = make_mesh(f"data:1,model:{SPATIAL_SLABS}",
                     devices=[torch.device("cuda", 0)] * SPATIAL_SLABS)
    host = torch.from_numpy(canvases)
    out, times = {}, {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        run = build_sharded_fullframe_detect(
            mesh, det_size=SPATIAL_SIZE, max_faces=8, dtype=dtype,
            scrfd_vars=weights)
        single = load_scrfd(SD.SCRFD(SD.SCRFD_2_5G), weights).eval().to(
            device="cuda", dtype=dtype)

        def unsharded():
            return SD.detect_faces(single, host.cuda(),
                                   torch.ones(len(canvases)), 0.5, 8)

        with _no_tf32() if dtype == torch.float32 else \
                contextlib.nullcontext():
            got = {k: v.cpu().numpy() for k, v in
                   run(canvases, ones, 0.5).items()}
            want = {k: v.cpu().numpy() for k, v in unsharded().items()}
            times[name] = in_turns({
                "sharded": lambda: run(canvases, ones, 0.5),
                "unsharded": unsharded}, timer=partial_wall_ms)
        m = want["mask"]
        require(np.array_equal(got["mask"], m),
                f"{name}: masks differ in {int((got['mask'] != m).sum())} "
                "slots")
        require(int(m.sum()) >= 2 * len(canvases),
                f"{name}: {int(m.sum())} faces found, drawn "
                f"{2 * len(canvases)}")
        score_err = float(np.abs(got["scores"][m] - want["scores"][m]).max())
        box_err = float(np.abs(got["boxes"][m] - want["boxes"][m]).max())
        if name == "fp32":
            require(score_err <= 1e-3, f"fp32 scores differ by {score_err}")
        require(box_err <= 0.5, f"{name}: boxes differ by {box_err} px")
        out[name] = {"faces": int(m.sum()), "score_max_err": score_err,
                     "box_max_err_px": box_err, "batch_ms": times[name]}
    return out


def train_vs_unsharded() -> dict:
    """Phase 17(b): SCRFD-2.5G at the trainer's defaults (256 px, batch 32)
    on ``data:2,model:2`` over four entries of the card against the
    unsharded step (the master's copy, ``make_loss_fn``, the same AdamW),
    3 steps on ``step_rng(0, i)``'s batches with TF32 off, each unsharded
    step from the weights and statistics the sharded one started from
    (after an AdamW step the two runs part: Adam moves a weight whose
    gradient is rounding noise by up to lr): losses rel ≤ 1e-3, npos
    equal, running statistics within 1e-3 of each leaf's largest entry;
    ms per step of both, in turns."""
    import copy

    import torch

    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.parallel.mesh import (
        build_sharded_train_step, make_mesh)
    from person_capture_tpu_torch.train.ckpt import step_rng
    from person_capture_tpu_torch.train.loop import to_device
    from person_capture_tpu_torch.train.scenes import sample_batch
    from person_capture_tpu_torch.train.scrfd_synth import (build_targets,
                                                            make_loss_fn)

    cfg, size, batch = SD.SCRFD_2_5G, 256, 32
    card = torch.device("cuda", 0)
    step, state, model = build_sharded_train_step(
        make_mesh("data:2,model:2", devices=[card] * 4), scrfd_cfg=cfg,
        size=size)
    twin = copy.deepcopy(model)
    opt = torch.optim.AdamW(twin.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    loss_fn = make_loss_fn(twin)
    batches = []
    for i in range(3):
        d = sample_batch(step_rng(0, i), batch, size)
        batches.append((d["images"], build_targets(
            d["boxes"], d["kps"], d["gt_mask"], size, cfg.strides,
            cfg.num_anchors)))

    def twin_step(images, targets):
        opt.zero_grad(set_to_none=True)
        loss, aux = loss_fn(to_device(images, card),
                            to_device(targets, card))
        loss.backward()
        opt.step()
        return loss.detach(), aux["npos"]

    rows = []
    with _no_tf32():
        for images, targets in batches:
            start = copy.deepcopy(model.state_dict())
            state, metrics = step(state, images, targets)
            twin.load_state_dict(start)
            loss, npos = twin_step(images, targets)
            stats = max(float((a - b).abs().max() / b.abs().max())
                        for (n, a), b in zip(model.named_buffers(),
                                             twin.buffers())
                        if n.endswith(("running_mean", "running_var")))
            rows.append({"loss": float(metrics["loss"]),
                         "unsharded_loss": float(loss),
                         "npos": int(metrics["npos"]),
                         "unsharded_npos": int(npos), "stats_rel": stats})
        images, targets = batches[0]
        ms = in_turns({"sharded": lambda: step(state, images, targets),
                       "unsharded": lambda: twin_step(images, targets)},
                      timer=partial_wall_ms)
    for r in rows:
        rel = abs(r["loss"] - r["unsharded_loss"]) / abs(r["unsharded_loss"])
        require(rel <= 1e-3, f"losses {r['loss']} and {r['unsharded_loss']}")
        require(r["npos"] == r["unsharded_npos"], f"npos {r}")
        require(r["stats_rel"] <= 1e-3, f"running statistics {r}")
    return {"steps": rows, "step_ms": ms}


def step_child(argv) -> int:
    """One process of phase 17(c): the sharded pre-scan step on
    ``data:1,model:2`` with one mesh entry in each of two processes that
    share the card; writes its outputs and prints its ms per step."""
    import numpy as np
    import torch

    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.parallel import multihost as MH
    from person_capture_tpu_torch.parallel.mesh import (
        build_sharded_prescan_step, make_mesh)

    rank, port, inputs, out = int(argv[0]), argv[1], argv[2], argv[3]
    MH.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                  process_id=rank)
    data = np.load(inputs)
    mesh = make_mesh("data:1,model:2")
    require(mesh.owners.tolist() == [[0, 1]],
            f"the model axis does not span the processes: {mesh.owners}")
    run = build_sharded_prescan_step(
        mesh, arcface_cfg=AF.SYNTH_R18, det_size=640, max_faces=8,
        dtype=torch.bfloat16,
        scrfd_vars=resolve_weights("auto", "scrfd_2.5g"),
        arcface_vars=resolve_weights("auto", "arcface_synth"))
    args = (data["frames"], data["bank"], data["bank_mask"], 0.5)
    got = {k: v.cpu().numpy() for k, v in run(*args).items()}
    np.savez(out, **got)
    emit(child=True, rank=rank, step_ms=wall_ms(lambda: run(*args), reps=5,
                                                 warmup=2))
    return 0


def across_processes(work: str, fixture) -> dict:
    """Phase 17(c): two processes sharing the card, each one entry of a
    ``data:1,model:2`` mesh, run the sharded pre-scan step (SCRFD-2.5G and
    ArcFace SYNTH_R18 bundled, det 640, bf16) on 8 frames of phase 16's
    batch (inside the first truth span), every split layer's slices
    all-gathered through the host (gloo); held to the single-process
    ``data:1`` step: masks and slots identical on both ranks, ``best_fd``
    within 2e-2; ms per step against the same mesh in one process."""
    import numpy as np
    import torch

    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.parallel.mesh import (
        build_sharded_prescan_step, make_mesh)

    frames, weights, bank, bank_mask = fixture_batch(fixture, 64)
    frames = frames[10:18]        # video frames 20-34: the first truth span
    inputs = os.path.join(work, "across_inputs.npz")
    np.savez(inputs, frames=frames, bank=bank, bank_mask=bank_mask)
    port = _free_port()
    outs = [os.path.join(work, f"across_{i}.npz") for i in range(2)]
    started = start_children(os.path.join(work, "logs"), "step_child",
                             [[str(i), str(port), inputs, outs[i]]
                              for i in range(2)])
    try:
        # the same mesh in this process, while the children start
        card = torch.device("cuda", 0)
        args = (frames, bank, bank_mask, 0.5)
        step = {}
        for spec, n in (("data:1", 1), ("data:1,model:2", 2)):
            step[spec] = build_sharded_prescan_step(
                make_mesh(spec, devices=[card] * n),
                arcface_cfg=AF.SYNTH_R18, det_size=640, max_faces=8,
                dtype=torch.bfloat16, scrfd_vars=weights["scrfd_weights"],
                arcface_vars=weights["arcface_weights"])
        want = {k: v.cpu().numpy() for k, v in step["data:1"](*args).items()}
        in_process_ms = wall_ms(lambda: step["data:1,model:2"](*args),
                                reps=5, warmup=2)
    finally:
        children = finish_children(started)
    m = want["mask"]
    require(m.any(), "no face in the 8 frames")
    errs = []
    for i, path in enumerate(outs):
        got = dict(np.load(path))
        require(np.array_equal(got["mask"], m),
                f"rank {i}: masks differ in {int((got['mask'] != m).sum())} "
                "slots")
        errs.append(float(np.abs(got["best_fd"] - want["best_fd"]).max()))
        require(errs[-1] <= 2e-2, f"rank {i}: best_fd differs by {errs[-1]}")
    across_ms = [c["step_ms"] for c in children]
    return {"faces": int(m.sum()), "best_fd_max_err": errs,
            "step_ms_across_processes": across_ms,
            "step_ms_in_process": in_process_ms,
            "ratio": max(across_ms) / in_process_ms}


def phase_sharded(work: str, fixture) -> dict:
    """Phase 17: the spatially sharded full-frame detect, the sharded train
    step, a model axis across two processes, and the dryrun."""
    from person_capture_tpu_torch.dryrun import dryrun_multichip

    reset_launches()
    result, seconds = {}, {}
    for name, fn in (("spatial", spatial_vs_unsharded),
                     ("train", train_vs_unsharded),
                     ("across", lambda: across_processes(work, fixture)),
                     ("dryrun", lambda: _quiet(dryrun_multichip, 8,
                                               full=True)[0])):
        t0 = time.perf_counter()
        result[name] = fn()
        seconds[name] = time.perf_counter() - t0
    launches = read_launches()
    emit(phase="sharded", **result, seconds=seconds)
    return launches


# phase 18: the verify recipe (README, the port's section) as its users
# type it: an SDR 320×240 video, its flags, and the frames it must find
RECIPE_FLAGS = ("--batch", "8", "--det-size", "320", "--face-det-conf", "0.3",
                "--face-thresh", "0.9")
RECIPE_FRAMES = list(range(20, 61, 2)) + list(range(90, 121, 2))
PRESET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "presets",
                      "solidpreset_tpu.json")
PRESET_RATIOS = ("1:1", "2:3", "3:4")
# 18(c)'s long shot: one span the preset's 1.5-s gap samples six times
PRESET_LONG = dict(frames=300, segments=[(20, 280, 0)], seed=3)
VIT_B_32_SEED = 5
# 18(g): four short SDR videos (seed, truth spans), two in the corpus from
# the start and two dropped in while both watchers run
WATCH_VIDEOS = ((21, [(8, 40, 0)]), (22, [(20, 52, 0)]),
                (23, [(4, 30, 0)]), (24, [(30, 56, 0)]))
WATCH_FRAMES = 60
WATCH_POLL_S = 0.5
WATCH_MAX_IDLE = 10
# the flags of every 18(g) sweep: the recipe's, curation off
WATCH_FLAGS = ("--prescan", *RECIPE_FLAGS, "--set", "curate_enable=false",
               "--set", "prescan_cache_mode=off")
INDEX_DECISIONS = ("frame", "x1", "y1", "x2", "y2", "crop_path", "ratio")
# a frame whose fp32 face distance lies this near the threshold may fall
# on either side of it in bf16
NEAR_THRESHOLD = 0.01


def rotate_video(src: str, dst: str) -> str:
    """The recipe's rotated twin: ``np.rot90(frame, 3)`` of every frame,
    written as an H×W (portrait) video."""
    import cv2
    import numpy as np

    cap = cv2.VideoCapture(src)
    w, h = (int(cap.get(p)) for p in (cv2.CAP_PROP_FRAME_WIDTH,
                                      cv2.CAP_PROP_FRAME_HEIGHT))
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


@contextlib.contextmanager
def sdr_source():
    """Phases 4-17 force the HDR path (``PERSON_CAPTURE_FORCE_HDR``); inside
    this an SDR video is probed and read as SDR."""
    forced = os.environ.pop("PERSON_CAPTURE_FORCE_HDR", None)
    try:
        yield
    finally:
        if forced is not None:
            os.environ["PERSON_CAPTURE_FORCE_HDR"] = forced


def watch_reader(seen: dict):
    """Spy on ``open_analysis_reader``: the ``hdr`` flag the engine passes
    and the reader class it gets, per call. Returns the undo."""
    from person_capture_tpu_torch.video import reader as R

    opened = R.open_analysis_reader
    seen["readers"] = []

    def spied(*a, **kw):
        r = opened(*a, **kw)
        seen["readers"].append([bool(kw.get("hdr")), type(r).__name__])
        return r

    R.open_analysis_reader = spied
    return lambda: setattr(R, "open_analysis_reader", opened)


def watch_ladder(seen: dict):
    """Spy on the recovery ladder: frames it saw after the 0° pass, those
    that came back empty, and the variants it probed by kind. Returns the
    undo."""
    import numpy as np

    from person_capture_tpu_torch.pipeline import recovery as RC

    make, recover = RC._make_variant, RC.RecoveringFaceBackend._recover
    seen.update(ladder_frames=0, ladder_empty=0, probes={})

    def made(frame, kind, param):
        seen["probes"][kind] = seen["probes"].get(kind, 0) + 1
        return make(frame, kind, param)

    def recovering(self, frames, valid, out):
        valid = np.asarray(valid, bool)
        seen["ladder_frames"] += int(valid.sum())
        seen["ladder_empty"] += int((valid & ~out["mask"].any(1)).sum())
        return recover(self, frames, valid, out)

    RC._make_variant = made
    RC.RecoveringFaceBackend._recover = recovering

    def restore():
        RC._make_variant = make
        RC.RecoveringFaceBackend._recover = recover

    return restore


def stage_split(stages: dict) -> dict:
    """Phase 4's split of a run's ``StepTimer`` stages: seconds per timed
    host stage, largest first."""
    return dict(sorted(((k, v["total_s"]) for k, v in stages.items()),
                       key=lambda kv: -kv[1]))


def recipe_run(work: str, name: str, fixture) -> dict:
    """One SDR run of the verify recipe: its flags at the CLI defaults (no
    ``--set`` but the harness's cache and profile settings), read through
    the plain reader, with the ladder watched."""
    seen = {}
    restores = [watch_reader(seen), watch_ladder(seen)]
    try:
        with sdr_source():
            run = run_cli(work, name, fixture, sets=(), flags=RECIPE_FLAGS,
                          hdr=False)
    finally:
        for restore in restores:
            restore()
    require(seen["readers"] and not any(hdr for hdr, _ in seen["readers"]),
            f"{name}: the SDR video was not read as SDR: {seen['readers']}")
    require(run["hit_frames"] == RECIPE_FRAMES, f"{name}: hits "
            f"{run['hit_frames']} != the recipe's {RECIPE_FRAMES}")
    require(not any(run["launches"].values()), f"{name}: tone-map launches "
            f"{run['launches']} on an SDR source")
    require(seen["ladder_frames"] > 0 and seen["probes"], f"{name}: the "
            f"recovery ladder saw no frame or probed nothing")
    ladder = run["engine"].backend
    stages = run["engine"]._timer.summary()
    rot = seen["probes"].get("rot", 0)
    emit(phase=name, hits=len(run["rows"]), hit_frames=run["hit_frames"],
         crops=len(run["rows"]), readers=seen["readers"],
         launches=run["launches"], setup_seconds=run["setup_seconds"],
         seconds=run["seconds"], source_frames_per_s=150 / run["seconds"],
         prescan_spans=run["result"].spans,
         recovered_faces=ladder.recovered_faces,
         ladder_frames=seen["ladder_frames"],
         ladder_empty_frames=seen["ladder_empty"], probes=seen["probes"],
         rotation_probes_per_frame=rot / max(1, seen["ladder_frames"]),
         stage_seconds=stage_split(stages), stages=stages)
    return run


def phase_sdr(work: str):
    """18(a) the recipe's SDR drive and 18(b) its rotated twin."""
    # the recipe's fixture as SKILL.md writes it: SDR, 320×240
    fixture = make_fixture(os.path.join(work, "sdr"), size=(320, 240),
                           pq=False)
    rotated = (rotate_video(fixture[0], os.path.join(work, "sdr",
                                                     "rot.mp4")),
               *fixture[1:])
    upright = recipe_run(work, "sdr_verify", fixture)
    twin = recipe_run(work, "rotated", rotated)
    return fixture, upright["launches"], twin["launches"]


def preset_run(work: str, name: str, fixture) -> dict:
    """One run of the bundled preset on a PQ fixture with its P010
    source: hits and stills as :func:`check_stills`, the face backend's
    main-pass batches 128 frames wide, each crop within 1 px of the ratio
    it chose, ``dataset_out/`` by :func:`check_curation`."""
    import numpy as np

    composed, dispatches, persons, restores = [], [], {}, []

    def hook(runtime, eng):
        restores.append(_watch_defaults_run(runtime["inner_face"], composed,
                                            dispatches, persons))

    try:
        run = run_cli(work, name, fixture, sets=(),
                      flags=("--preset", PRESET), hook=hook)
    finally:
        for restore in restores:
            restore()
    cfg, rows = run["cfg"], run["rows"]
    with open(PRESET) as fh:
        preset = json.load(fh)
    require(cfg.tpu_batch_frames == preset["tpu_batch_frames"] == 128
            and cfg.ratio == ",".join(PRESET_RATIOS),
            f"{name}: the preset did not set batch and ratios: "
            f"{cfg.tpu_batch_frames}, {cfg.ratio}")
    stages = run["engine"]._timer.summary()
    batches = stages["main.submit"]["count"]
    require(batches > 0 and len(dispatches) == batches
            and set(dispatches) == {128}, f"{name}: main-pass batches "
            f"{dispatches} for {batches} submits: not 128 frames wide")
    by_ratio = {}
    for r in rows:
        w = int(r["x2"]) - int(r["x1"])
        h = int(r["y2"]) - int(r["y1"])
        rw, rh = (float(v) for v in r["ratio"].split(":"))
        off = min(abs(w - h * rw / rh), abs(h - w * rh / rw))
        require(r["ratio"] in PRESET_RATIOS and off <= 1.0,
                f"{name}: crop {r['crop_path']} {w}x{h} is {off:.2f} px off "
                f"its ratio {r['ratio']}")
        by_ratio[r["ratio"]] = by_ratio.get(r["ratio"], 0) + 1
    # a run that keeps a few crops may see the curator's gates drop them
    # all: phase_preset requires a selection from the long shot
    cur = check_curation(run["out"], min_selected=0)
    main_s = sum(stages[k]["total_s"] for k in ("main.submit",
                                                "main.device_fetch"))
    emit(phase=name, preset=os.path.relpath(PRESET), hits=len(rows),
         hit_frames=run["hit_frames"], stills=len(rows),
         crops_per_ratio=by_ratio, main_batches=batches,
         main_batch_frames=dispatches,
         person_box_share_of_hit_frames=float(np.mean(
             [persons.get(f, 0) > 0 for f in run["hit_frames"]])),
         main_ms_per_batch=main_s / batches * 1e3, pool=cur["pool"],
         selected=cur["selected"], selected_files=cur["selected_files"],
         curator_wall_s=cur["wall_s"], launches=run["launches"],
         setup_seconds=run["setup_seconds"], seconds=run["seconds"],
         stage_seconds=stage_split(stages), stages=stages)
    return dict(launches=run["launches"], out=run["out"], ratios=by_ratio,
                selected=cur["selected"])


def phase_preset(work: str, body_fixture, face_fixture):
    """18(c): ``--preset presets/solidpreset_tpu.json`` (no ``--batch``:
    the preset sets it) on phase 8's fixture, a person under a 48-px face;
    on phase 4's, a 120-px face alone; and on a 10-s shot of phase 8's
    kind with the person in view throughout (:data:`PRESET_LONG`). With
    ``min_gap_sec`` 1.5 the first two keep the first hit of each span,
    which the curator's gates drop in both packages (no face found in the
    still, or face distance over 0.45, and sharpness under 0.10); the long
    shot gives the curator stills from inside the span. The composer
    frames the person in 1:1 or 2:3 and the close face in 3:4, so the runs
    hold all three ratios."""
    long_fixture = make_fixture(os.path.join(work, "preset_long"),
                                draw_body=True, face_px=DEFAULT_FACE_PX,
                                **PRESET_LONG)
    runs = {name: preset_run(work, name, fx) for name, fx in
            (("preset_person", body_fixture), ("preset_face", face_fixture),
             ("preset_long", long_fixture))}
    ratios = set().union(*(r["ratios"] for r in runs.values()))
    require(ratios == set(PRESET_RATIOS), f"crops per ratio "
            f"{ {n: r['ratios'] for n, r in runs.items()} }: not every ratio "
            f"of {PRESET_RATIOS}")
    require(runs["preset_long"]["selected"] >= 1, "the curator selected no "
            "still of the long shot")
    return (sum_launches(r["launches"] for r in runs.values()),
            [r["out"] for r in runs.values()])


# runs ``python -m <module> <args>`` (runpy, as ``-m`` does) and prints the
# process's tone-map launches as a "child" JSON line when it exits
# (0 where the process never imported the kernels' module)
MODULE_CHILD = (
    "import atexit, json, runpy, sys\n"
    "def launches():\n"
    "    H = sys.modules.get('person_capture_tpu_torch.kernels.hdr')\n"
    "    return {'hdr_to_sdr_bgr': H.HDR_TO_SDR_LAUNCHES.count if H else 0,\n"
    "            'tonemap_planes': H.TONEMAP_LAUNCHES.count if H else 0}\n"
    "atexit.register(lambda: print(json.dumps({'child': True, 'launches': "
    "launches()}), flush=True))\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


def start_modules(logdir: str, specs, env=None):
    """One process per ``(name, module, argv)`` of ``specs`` running the
    module as ``python -m`` would (:data:`MODULE_CHILD`)."""
    return start_processes(logdir, [
        (name, ["-c", MODULE_CHILD, module, *argv])
        for name, module, argv in specs], env)


def sum_launches(counts) -> dict:
    counts = list(counts)
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_curator_cli(work: str, preset_outs, ref_path: str):
    """18(d): ``python -m person_capture_tpu_torch.curator`` alone over
    18(c)'s stills (all runs' in one pool), on the card (its default
    device) and with ``--device cpu``, all at once: the same selection.
    Twice on each device: as typed, with the reference CLI's
    ``--sharp-min 0.10``, which drops every still of these fixtures (their
    P010 planes are the analysis frame upscaled 4×, so their sharpness
    reads about 0.02), and with ``--sharp-min 0``, the gate of the
    engine's own curation, where the selection must not be empty."""
    import shutil

    pool = os.path.join(work, "curator_pool")
    os.makedirs(pool)
    for out in preset_outs:
        tag = os.path.basename(out)
        for f in os.listdir(os.path.join(out, "crops")):
            if f.lower().endswith(IMAGE_EXTS):
                shutil.copy(os.path.join(out, "crops", f),
                            os.path.join(pool, f"{tag}_{f}"))
    gates = {"typed": [], "engine_gate": ["--sharp-min", "0"]}
    devices = {"cuda": [], "cpu": ["--device", "cpu"]}
    outs = {(g, d): os.path.join(work, f"curator_cli_{g}_{d}")
            for g in gates for d in devices}
    t0 = time.perf_counter()
    done = finish_processes(start_modules(os.path.join(work, "logs"), [
        (f"curator_{g}_{d}", "person_capture_tpu_torch.curator",
         ["--pool", pool, "--ref", ref_path, "--out", out, *gates[g],
          *devices[d]]) for (g, d), out in outs.items()]))
    seconds = time.perf_counter() - t0
    picked, metrics = {}, {}
    for (g, d), out in outs.items():
        files = sorted(os.listdir(out))
        require("metrics.json" in files and "selection_debug.csv" in files,
                f"curator CLI ({g}, {d}): {files}")
        picked[g, d] = [f for f in files if f.lower().endswith(IMAGE_EXTS)]
        with open(os.path.join(out, "metrics.json")) as fh:
            metrics[g, d] = json.load(fh)
    for g in gates:
        require(picked[g, "cuda"] == picked[g, "cpu"], f"curator CLI ({g}) "
                f"on the card selected {picked[g, 'cuda']}, on the CPU "
                f"{picked[g, 'cpu']}")
    require(picked["engine_gate", "cuda"], "the curator CLI selected "
            "nothing at the engine's gate")
    launches = sum_launches(c["launches"] for c, _ in done.values())
    emit(phase="curator_cli", pool=len(os.listdir(pool)),
         selected={g: picked[g, "cuda"] for g in gates},
         card_wall_s={g: metrics[g, "cuda"]["wall_s"] for g in gates},
         cpu_wall_s={g: metrics[g, "cpu"]["wall_s"] for g in gates},
         launches=launches, seconds=seconds)
    return launches


def watch_clip_face(seen: dict, runtime, eng):
    """Spies for 18(e) on the primary face backend: every chip its fused
    chain aligns and every chip its CLIP tower embeds (the first 16 with a
    face kept), each frame's faces after the ladder, and the bank."""
    import threading

    from person_capture_tpu_torch.ops import align as AL

    face = runtime["inner_face"]
    inside = threading.local()
    seen.update(aligned=0, embedded=0, tower_calls=0, chips=[], faces={},
                face=face)
    fused, encode, align = face._fused_bgr, face._encode, AL.align_chips
    submit, seed = eng.backend.submit_batch, eng.seed_bank

    def fused_bgr(frames, valid=None):
        inside.on = True
        try:
            return fused(frames, valid)
        finally:
            inside.on = False

    def encoded(chips):
        if getattr(inside, "on", False):
            seen["tower_calls"] += 1
            seen["embedded"] += int(chips.shape[0])
        return encode(chips)

    def aligned(frames, kps, valid, *a, **kw):
        chips = align(frames, kps, valid, *a, **kw)
        if getattr(inside, "on", False):
            seen["aligned"] += int(chips.shape[0] * chips.shape[1])
            keep = chips[valid.bool()][:16 - len(seen["chips"])]
            seen["chips"] += [c.float().clone() for c in keep]
        return chips

    def recorded(frames, valid, frame_idxs=None):
        fetch = submit(frames, valid, frame_idxs)

        def fetched():
            out = fetch()
            for slot, idx in enumerate(frame_idxs if frame_idxs is not None
                                       else ()):
                if valid[slot]:
                    m = out["mask"][slot]
                    seen["faces"][int(idx)] = out["feats"][slot][m].copy()
            return out

        return fetched

    def seeded(paths):
        seen["bank"] = seed(paths)
        return seen["bank"]

    face._fused_bgr, face._encode = fused_bgr, encoded
    AL.align_chips = aligned
    eng.backend.submit_batch, eng.seed_bank = recorded, seeded

    def restore():
        del face._fused_bgr
        face._encode = encode
        AL.align_chips = align

    return restore


def frame_face_distance(seen: dict, frame: int):
    """The least face distance of ``frame``'s faces to the run's bank, as
    the main pass computes it; None where the frame had no face."""
    import numpy as np

    feats = seen["faces"].get(frame)
    bank = seen["bank"].matrix()
    if feats is None or not len(feats) or bank is None:
        return None
    v = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True),
                           1e-6)
    return float(1.0 - (v @ bank.T).max())


def phase_clip_face(work: str, sdr_fixture):
    """18(e): phase 4's settings with ``use_arcface=false`` (ViT-L-14 at
    the port's seeded random init) on 18(a)'s SDR fixture, bf16 and
    ``--compute-dtype float32`` (TF32 off)."""
    import torch

    from person_capture_tpu_torch.models import clip_vit as CV

    sets = SLICE_SETS + ("use_arcface=false",)
    runs, seen = {}, {}
    for dtype in ("bfloat16", "float32"):
        seen[dtype], restores = {}, []

        def hook(runtime, eng, s=seen[dtype]):
            face = runtime["inner_face"]
            require(face.arcface_model is None
                    and face.clip_model.cfg is CV.VIT_L_14,
                    "use_arcface=false did not build the ViT-L-14 face "
                    "tower")
            restores.append(watch_clip_face(s, runtime, eng))

        try:
            with sdr_source(), _no_tf32():
                runs[dtype] = run_cli(work, f"clip_face_{dtype}",
                                      sdr_fixture, sets,
                                      flags=("--compute-dtype", dtype),
                                      hook=hook, hdr=False)
        finally:
            for restore in restores:
                restore()
        s = seen[dtype]
        # the tower embeds the kept slots of valid frames, padded to a
        # bucket: never more chips than the chain aligned
        require(s["tower_calls"] >= 1
                and 0 < s["embedded"] <= s["aligned"],
                f"{dtype}: the CLIP tower embedded {s['embedded']} of "
                f"{s['aligned']} aligned chips in {s['tower_calls']} calls")
    bf16, fp32 = (seen[d]["face"] for d in ("bfloat16", "float32"))
    require(bf16.dtype == torch.bfloat16 and fp32.dtype == torch.float32,
            "the CLIP-face runs did not run in bf16 and fp32")
    chips = seen["bfloat16"]["chips"]
    require(len(chips) == 16, f"{len(chips)} face chips from the run")
    chips = torch.stack(chips)
    with _no_tf32():
        cos = (CV.encode_images(bf16.clip_model, chips)
               * CV.encode_images(fp32.clip_model, chips)).sum(-1)
    require(float(cos.min()) >= 0.99, f"ViT-L-14 face chips bf16 vs fp32: "
            f"cosine {float(cos.min()):.5f} < 0.99")
    thresh = float(runs["float32"]["cfg"].face_thresh)
    frames = {d: runs[d]["hit_frames"] for d in runs}
    near, parted = {}, []
    for f in sorted(set(frames["bfloat16"]) ^ set(frames["float32"])):
        fd = frame_face_distance(seen["float32"], f)
        if fd is not None and abs(fd - thresh) <= NEAR_THRESHOLD:
            near[f] = fd
        else:
            parted.append((f, fd))
    require(not parted, f"bf16 and fp32 CLIP-face runs part on frames "
            f"(frame, fp32 face distance) {parted}, threshold {thresh}")
    emit(phase="clip_face", hit_frames=frames,
         near_threshold_frames=near, face_thresh=thresh,
         chips_aligned={d: seen[d]["aligned"] for d in seen},
         chips_embedded={d: seen[d]["embedded"] for d in seen},
         tower_calls={d: seen[d]["tower_calls"] for d in seen},
         bf16_vs_fp32_cosine=[float(c) for c in cos],
         launches={d: runs[d]["launches"] for d in runs},
         seconds={d: runs[d]["seconds"] for d in runs},
         stage_seconds={d: stage_split(runs[d]["engine"]._timer.summary())
                        for d in runs})
    return sum_launches(runs[d]["launches"] for d in runs)


def phase_reid_pt(work: str, body_fixture, reid: dict):
    """18(f): ReID towers from open_clip ``.pt`` state dicts: the bundled
    clip_reid_s through ``--reid-weights`` on phase 9's run, and a ViT-B-32
    tower at a seeded init, tower against tower."""
    import numpy as np
    import torch

    from person_capture_tpu_torch import main as M
    from person_capture_tpu_torch.models import clip_vit as CV
    from person_capture_tpu_torch.models.bridge import flax_variables
    from person_capture_tpu_torch.models.loaders import torch_state_dict
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.pipeline.backends import ClipReidBackend

    def save(variables, cfg, path):
        torch.save({k: torch.from_numpy(v) for k, v in torch_state_dict(
            "clip", variables, cfg).items()}, path)
        return path

    reid_s = save(resolve_weights("auto", "clip_reid_s"), CV.REID_S,
                  os.path.join(work, "clip_reid_s.pt"))
    calls = []

    def hook(runtime, eng):
        tower = runtime["reid"]
        require(isinstance(tower, ClipReidBackend)
                and tower.model.cfg is CV.REID_S, "--reid-weights x.pt did "
                "not build the clip_reid_s tower")
        extract = tower.extract
        tower.extract = lambda crops: calls.append(len(crops)) or extract(
            crops)

    run = run_cli(work, "reid_pt", body_fixture, sets=(), hook=hook,
                  flags=("--match-mode", "either", "--set",
                         "reid_backbone=clip_reid_s", "--reid-weights",
                         reid_s))
    require(calls, "the .pt ReID tower was never called")
    require(run["hit_frames"] == reid["hit_frames"], f"the .pt clip_reid_s "
            f"run's hits {run['hit_frames']} != phase 9's "
            f"{reid['hit_frames']}")

    crops = reid["crops"]
    seeded = ClipReidBackend(cfg=CV.VIT_B_32, dtype=torch.float32,
                             seed=VIT_B_32_SEED, device="cuda")
    path = save(flax_variables(seeded.model), CV.VIT_B_32,
                os.path.join(work, "vit_b_32.pt"))
    cfg, weights = M.resolve_reid("ViT-B-32", path)
    require(cfg is CV.VIT_B_32, f"resolve_reid gave {cfg.name}")
    loaded = ClipReidBackend(cfg=cfg, weights=weights, dtype=torch.float32,
                             device="cuda")
    half = ClipReidBackend(cfg=cfg, weights=weights, device="cuda")
    with _no_tf32():
        want = seeded.extract(crops)
        got = loaded.extract(crops)
        cos = (half.extract(crops) * got).sum(-1)
    gap = float(np.abs(got - want).max())
    require(gap <= 1e-5, f"ViT-B-32 from .pt vs its seeded tower: {gap}")
    require(float(cos.min()) >= 0.99, f"ViT-B-32 bf16 vs fp32: cosine "
            f"{float(cos.min()):.5f} < 0.99")
    x = torch.from_numpy(np.stack([loaded._preprocess(c) for c in crops])
                         .astype(np.float32)).cuda()
    times = in_turns({
        "vit_b_32_ms": lambda: CV.encode_images(half.model, x),
        "vit_b_32_fp32_ms": lambda: CV.encode_images(loaded.model, x)},
        timer=lambda fn: cuda_ms(fn, reps=5, inner=3, warmup=2))
    flops = vit_flops(CV.VIT_B_32, len(crops))
    emit(phase="reid_pt", hit_frames=run["hit_frames"],
         reid_pt_calls=len(calls), launches=run["launches"],
         seconds=run["seconds"], vit_b_32_pt_vs_seeded_max_abs=gap,
         vit_b_32_bf16_vs_fp32_cosine=[float(c) for c in cos],
         batch=len(crops), batch_ms=times, gflop_per_batch=flops / 1e9,
         bf16_bound_ms=flops / BF16_OPS_PER_S * 1e3)
    return run["launches"]


def _index_rows(out: str) -> list:
    import csv

    with open(os.path.join(out, "index.csv")) as fh:
        return [[r[k] for k in INDEX_DECISIONS] for r in csv.DictReader(fh)]


def watch_corpus_names(corpus: str) -> list:
    """Four video names for 18(g) such that each shard owns one of the
    first two and one of the last two under ``shard_select(stable=True)``
    (a hash of the absolute path)."""
    from person_capture_tpu_torch.sweep import shard_select

    def owner(name):
        path = os.path.join(corpus, name)
        return 0 if shard_select([path], 0, 2, stable=True) else 1

    free = (f"w{k:02d}.mp4" for k in range(100))
    names = []
    for _ in range(2):
        want = {0: None, 1: None}
        while None in want.values():
            name = next(free)
            if want[owner(name)] is None:
                want[owner(name)] = name
        names += [want[0], want[1]]
    return names


def _wait_for_lines(started, text: str, timeout_s: float = 120.0) -> None:
    """Until every process's log holds ``text``; a process that exits
    first, or the time limit, fails the phase."""
    deadline = time.monotonic() + timeout_s
    waiting = list(started)
    while waiting:
        for item in list(waiting):
            name, p, log = item
            with open(log) as fh:
                if text in fh.read():
                    waiting.remove(item)
                    continue
            require(p.poll() is None, f"{name} exited {p.returncode} before "
                    f"printing {text!r}")
        require(time.monotonic() < deadline, f"no {text!r} from "
                f"{[n for n, _, _ in waiting]} in {timeout_s:.0f} s")
        time.sleep(0.1)


def phase_watch(work: str, ref_path: str):
    """18(g): two ``sweep --watch --shard i/2`` processes sharing the card
    over an SDR corpus that grows while they run, each video against a
    one-process sweep of the whole corpus; the doctor on each heartbeat."""
    from person_capture_tpu_torch import sweep
    from person_capture_tpu_torch.video.synthetic import generate_video

    root = os.path.join(work, "watch")
    corpus, staging = (os.path.join(root, d) for d in ("corpus", "staging"))
    os.makedirs(corpus)
    os.makedirs(staging)
    names = watch_corpus_names(corpus)
    truths = {}
    for name, (seed, segments) in zip(names, WATCH_VIDEOS):
        sv = generate_video(os.path.join(staging, name), width=320,
                            height=240, fps=30, total_frames=WATCH_FRAMES,
                            segments=segments, moving=True, seed=seed)
        truths[name] = sv.identity_spans(0)
    for name in names[:2]:
        os.replace(os.path.join(staging, name), os.path.join(corpus, name))
    env = {k: v for k, v in os.environ.items()
           if k != "PERSON_CAPTURE_FORCE_HDR"}
    env["PERSON_CAPTURE_SHARE_CARDS"] = "1"
    outs = [os.path.join(root, f"shard{i}") for i in range(2)]
    t0 = time.perf_counter()
    started = start_modules(os.path.join(root, "logs"), [
        (f"watch{i}", "person_capture_tpu_torch.sweep",
         ["--videos", corpus, "--ref", ref_path, "--out", outs[i],
          "--watch", str(WATCH_POLL_S), "--watch-max-idle",
          str(WATCH_MAX_IDLE), "--shard", f"{i}/2", *WATCH_FLAGS])
        for i in range(2)], env=env)
    try:
        _wait_for_lines(started, "[sweep] corpus")
        for name in names[2:]:
            os.replace(os.path.join(staging, name),
                       os.path.join(corpus, name))
    except BaseException:
        finish_processes(started, timeout_s=1)
        raise
    done = finish_processes(started)
    watch_s = time.perf_counter() - t0

    paths = [os.path.join(corpus, n) for n in names]
    ran = {}
    for i, out in enumerate(outs):
        with open(os.path.join(out, "sweep_summary.json")) as fh:
            summary = json.load(fh)
        got = sorted(os.path.basename(r["video"]) for r in summary["results"]
                     if r["ok"])
        want = sorted(os.path.basename(p) for p in
                      sweep.shard_select(paths, i, 2, stable=True))
        require(got == want and summary["failed"] == 0,
                f"shard {i}/2 ran {got} (failed {summary['failed']}), "
                f"shard_select gives {want}")
        with open(os.path.join(out, "sweep_status.json")) as fh:
            phase = json.load(fh)["phase"]
        require(phase == "exited", f"shard {i}/2 heartbeat ends {phase!r}")
        ran.update({n: i for n in got})
    require(sorted(ran) == sorted(names), f"videos run {sorted(ran)} of "
            f"{names}")

    plain = os.path.join(root, "plain")
    reset_launches()
    t0 = time.perf_counter()
    with sdr_source():
        rc = sweep.main(["--videos", corpus, "--ref", ref_path, "--out",
                         plain, *WATCH_FLAGS])
    plain_s = time.perf_counter() - t0
    plain_launches = read_launches()
    require(rc == 0, f"the one-process sweep exited {rc}")
    hits = {}
    for name, shard in ran.items():
        stem = os.path.splitext(name)[0]
        got = _index_rows(os.path.join(outs[shard], stem))
        want = _index_rows(os.path.join(plain, stem))
        require(got == want, f"{name}: shard {shard}'s index.csv {got} != "
                f"the one-process sweep's {want}")
        hits[name] = [int(r[0]) for r in got]
        truth = truths[name]
        require(hits[name] and all(any(s <= f <= e for s, e in truth)
                                   for f in hits[name]),
                f"{name}: hits {hits[name]} outside the truth {truth}")

    cache = os.path.join(root, "cache")
    docs = start_modules(os.path.join(root, "logs"), [
        (f"doctor{i}", "person_capture_tpu_torch.doctor",
         ["--json", "--skip-device", "--cache-dir", cache, "--sweep-root",
          out] + (["--skip-decode"] if i else []))
        for i, out in enumerate(outs)])
    reports = []
    for name, (_, text) in finish_processes(docs).items():
        report = json.loads([ln for ln in text.splitlines()
                             if ln.startswith("{") and '"host"' in ln][-1])
        heartbeat = report.get("sweep", {})
        require(report["ok"] and heartbeat.get("found")
                and heartbeat.get("phase") == "exited",
                f"{name}: sweep heartbeat {heartbeat}")
        reports.append(report)
    decode = reports[0].get("decode", {})
    require(decode.get("decode_fps", 0) > 0, f"doctor decode: {decode}")
    launches = sum_launches([c["launches"] for c, _ in done.values()]
                            + [plain_launches])
    emit(phase="watch", videos=names, first=names[:2], dropped=names[2:],
         shard_of=ran, hits=hits, truth_spans=truths,
         watch_seconds=watch_s, plain_sweep_seconds=plain_s,
         heartbeats=[r["sweep"] for r in reports], doctor_decode=decode,
         launches=launches)
    return launches


def phase_user_paths(work: str, face_fixture, body_fixture,
                     reid: dict) -> dict:
    """Phase 18: (a)-(g), each sub-phase's tone-map launches."""
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(work, *a)
        seconds[name] = time.perf_counter() - t0
        return out

    launches = {}
    sdr, launches["sdr_verify"], launches["rotated"] = timed(
        "sdr_and_rotated", phase_sdr)
    launches["preset"], preset_outs = timed("preset", phase_preset,
                                            body_fixture, face_fixture)
    launches["curator_cli"] = timed("curator_cli", phase_curator_cli,
                                    preset_outs, body_fixture[1])
    launches["clip_face"] = timed("clip_face", phase_clip_face, sdr)
    launches["reid_pt"] = timed("reid_pt", phase_reid_pt, body_fixture, reid)
    launches["watch"] = timed("watch", phase_watch, sdr[1])
    emit(phase="user_paths", seconds=seconds,
         total_seconds=sum(seconds.values()), launches=launches)
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
        phase4_frames = [int(r["frame"]) for r in rows]
        phase_preview(work, fixture)
        planar_err, still = phase_main_path_shape(rows)
        defaults_launches, body_fixture = phase_defaults(work)
        curate_launches, curate_hits = phase_curate(work, body_fixture)
        reid = phase_reid(work, body_fixture)
        later = {"curate": curate_launches, "reid": reid["launches"],
                 "yolo_face": phase_yolo_face(work, fixture[:3]),
                 "diag": phase_diag(work, fixture[:3]),
                 "onnx": phase_onnx(work, fixture),
                 "sweep": phase_sweep(work, body_fixture, curate_hits),
                 "train": phase_train(work, fixture),
                 "gui": phase_gui(work, fixture, launches, phase4_frames)}
        later["mesh"], mesh_processes = phase_mesh(work, fixture,
                                                   phase4_frames)
        later["sharded"] = phase_sharded(work, fixture)
        later.update(phase_user_paths(work, fixture[:3], body_fixture,
                                      reid))
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
        "launches_mesh_processes": [c["hdr_to_sdr_bgr"]
                                    for c in mesh_processes],
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
        "launches_mesh_processes": [c["tonemap_planes"]
                                    for c in mesh_processes],
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
