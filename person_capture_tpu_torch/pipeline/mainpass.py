"""Span-gated main pass: identity decision + crop composition + export.

TPU-first restructuring of the reference's hot loop
(person_capture/gui_app.py:4372-8111). Frames inside keep-spans decode into
fixed-size batches; fused device programs yield faces+embeddings (and
optionally YOLO person boxes + ReID embeddings) for the whole batch; the
sequential identity/lock/save logic replays on host in frame order.

Decision semantics mirror the reference:
  * match modes either | both | face_only | reid_only with degradation when
    a reference signal is missing (gui_app.py:6380-6399);
  * ``skip_yolo_when_faceonly`` skips the person path when a face is visible
    (gui_app.py:6225-6227);
  * ``drop_reid_if_any_face_match`` discards ReID-only candidates once any
    face matched (gui_app.py:6401-6411);
  * ``require_face_if_visible`` hard-rejects candidates whose visible face
    does not match (gui_app.py:6417-6437);
  * global-face fallback when the person path yields nothing
    (gui_app.py:7521+);
  * temporal lock with IoU gate, lock thresholds and miss timeout;
  * ``min_gap_sec`` save cadence, sharpness/min-size gates, side guard.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SessionConfig
from ..core.bank import RefBank
from ..core.compose import choose_best_ratio, enforce_scale_and_margins
from ..core.geometry import (box_iou, crop_img, detect_black_borders,
                             parse_ratio_list)
from ..core.scoring import calc_sharpness, combine_scores
from .backends import pad_batch, submit_faces_and_persons
from .saver import AsyncSaver, SaveItem


@dataclass
class Hit:
    frame: int
    time_secs: float
    score: float
    face_dist: Optional[float]
    reid_dist: Optional[float]
    crop: Tuple[int, int, int, int]
    path: str
    sharpness: float
    ratio: Optional[str]


@dataclass
class Candidate:
    det_box: Tuple[float, float, float, float]
    face_box: Optional[Tuple[float, float, float, float]]
    fd: Optional[float]
    rd: Optional[float]
    quality: float
    score: float
    # True when det_box is a real YOLO person detection (then it may act as
    # the compose subject box; face-derived boxes may not)
    subject_from_person: bool = False
    face_feat: Optional[np.ndarray] = None
    reid_feat: Optional[np.ndarray] = None
    # lock-carry candidates reuse the lock box without a fresh sighting;
    # they must not refresh the lock (else the carry self-perpetuates past
    # the faceless_persist_frames window)
    carried: bool = False


@dataclass
class LockState:
    hits: int = 0
    locked: bool = False
    last_face_box: Optional[Tuple[float, float, float, float]] = None
    last_det_box: Optional[Tuple[float, float, float, float]] = None
    last_seen_frame: int = -1
    misses: int = 0
    # EMA of the locked subject's ReID feature (reference `locked_reid` +
    # `lock_momentum`, gui_app.py:7495-7512)
    reid_feat: Optional[np.ndarray] = None

    def update_reid(self, feat: Optional[np.ndarray],
                    momentum: float) -> None:
        if feat is None:
            return
        feat = np.asarray(feat, np.float32)
        feat = feat / max(float(np.linalg.norm(feat)), 1e-6)
        if self.reid_feat is None:
            self.reid_feat = feat
        else:
            m = float(np.clip(momentum, 0.0, 1.0))
            mixed = m * self.reid_feat + (1.0 - m) * feat
            self.reid_feat = mixed / max(float(np.linalg.norm(mixed)), 1e-6)

    def clear(self) -> None:
        self.locked = False
        self.hits = 0
        self.last_face_box = None
        self.reid_feat = None

    def register_hit(self, face_box, frame_idx: int, lock_after_hits: int,
                     det_box=None):
        self.hits += 1
        if face_box is not None:
            self.last_face_box = tuple(face_box)
        if det_box is not None:
            self.last_det_box = tuple(det_box)
        self.last_seen_frame = frame_idx
        self.misses = 0
        if self.hits >= max(1, lock_after_hits):
            self.locked = True

    def register_miss(self, max_misses: int):
        self.misses += 1
        if self.locked and self.misses > max(1, max_misses):
            self.locked = False
            self.hits = 0
            self.last_face_box = None


@dataclass
class MainPassResult:
    hits: List[Hit] = field(default_factory=list)
    frames_processed: int = 0
    frames_decoded: int = 0
    wall_s: float = 0.0


def _center_in_box(face_box, person_box) -> bool:
    fx = 0.5 * (face_box[0] + face_box[2])
    fy = 0.5 * (face_box[1] + face_box[3])
    return (person_box[0] <= fx <= person_box[2]
            and person_box[1] <= fy <= person_box[3])


def run_main_pass(reader, backend, cfg: SessionConfig, bank: RefBank,
                  spans: Sequence[Tuple[int, int]], saver: AsyncSaver,
                  meta=None, batch_size: Optional[int] = None,
                  person_backend=None, reid_backend=None,
                  fullframe_backend=None,
                  ref_reid_feat: Optional[np.ndarray] = None,
                  keyframes: Optional[Sequence[int]] = None,
                  hdr_exporter=None,
                  progress: Optional[Callable[[float], None]] = None,
                  on_preview: Optional[Callable[[np.ndarray, int], None]] = None,
                  should_stop: Optional[Callable[[], bool]] = None,
                  seek_request: Optional[Callable[[], Optional[int]]] = None,
                  preview_hdr_source=None,
                  on_hit: Optional[Callable] = None,
                  timer=None) -> MainPassResult:
    from ..utils.timing import NULL_TIMER

    timer = timer or NULL_TIMER
    t0 = time.perf_counter()
    meta = meta or reader.meta()
    fps = meta.fps or 30.0
    res = MainPassResult()
    if not spans:
        res.wall_s = time.perf_counter() - t0
        return res

    stride = max(1, int(cfg.frame_stride))
    batch = int(batch_size or cfg.tpu_batch_frames)
    ratios = [f"{int(w) if w == int(w) else w}:{int(h) if h == int(h) else h}"
              for (w, h) in parse_ratio_list(cfg.ratio)]
    crops_dir = os.path.join(cfg.out_dir, "crops")
    os.makedirs(crops_dir, exist_ok=True)

    # match_mode/disable_reid are LIVE keys (engine.update_cfg): evaluate
    # per use instead of snapshotting at entry, or mid-run changes no-op
    def _use_reid() -> bool:
        return (reid_backend is not None and ref_reid_feat is not None
                and not cfg.disable_reid and cfg.match_mode != "face_only")

    def _use_person() -> bool:
        return person_backend is not None and (
            cfg.match_mode != "face_only" or not cfg.skip_yolo_when_faceonly
            or cfg.compose_detect_person_for_face)

    if ref_reid_feat is not None:
        ref_reid_feat = np.asarray(ref_reid_feat, np.float32)
        ref_reid_feat = ref_reid_feat / max(np.linalg.norm(ref_reid_feat), 1e-6)

    lock = LockState()
    last_save_t = -1e9
    bank_mat = bank.matrix()
    # hard-negative face embeddings (suppress_negatives/neg_tolerance/
    # max_negatives: the reference exposes these as LIVE GUI knobs,
    # gui_app.py:5432-5434/14407-14408, without wiring them into its loop;
    # here they get the behavior the knobs describe, default-off)
    negatives: List[np.ndarray] = []

    def _refresh_bank_mat() -> None:
        nonlocal bank_mat
        bank_mat = bank.matrix()

    pend: List[Tuple[int, np.ndarray]] = []
    prev_frame: List[Optional[np.ndarray]] = [None]
    preview_state = {"count": 0, "last_t": -1e9}

    # debug_dump is a LIVE key: decide per record and open the file on
    # first need, so toggling it mid-run takes effect
    debug_state: Dict = {"fh": None}

    def _dump(rec: Dict) -> None:
        if not cfg.debug_dump:
            return
        import json as _json

        if debug_state["fh"] is None:
            debug_dir = os.path.join(cfg.out_dir, cfg.debug_dir or "debug")
            os.makedirs(debug_dir, exist_ok=True)
            debug_state["fh"] = open(
                os.path.join(debug_dir, "debug.jsonl"), "w")
        debug_state["fh"].write(_json.dumps(rec) + "\n")

    def _downscaled(img: np.ndarray) -> np.ndarray:
        md = int(cfg.preview_max_dim or 0)
        h, w = img.shape[:2]
        if md and max(h, w) > md:
            try:
                import cv2
                img = cv2.resize(img, (int(round(w * md / max(h, w))),
                                       int(round(h * md / max(h, w)))),
                                 interpolation=cv2.INTER_AREA)
            except ImportError:
                pass
        return img

    # HDR preview pump thread (reference runs its P010 preview reader on a
    # dedicated thread, gui_app.py:13290-13481 + video_io.py:841-921): the
    # analysis hot loop only posts the latest requested frame; plane
    # drain/seek + the device tone-map render happen here. A busy pump
    # drops intermediate requests (newest wins); planes unavailable ⇒ fall
    # back to the (pre-downscaled) analysis frame. The source is DEDICATED
    # — never the exporter's pipe, which the saver thread owns. Any other
    # failure in the pump (a render error: a kernel that does not build or
    # launch) ends the pump and is recorded in pump_state["error"]; the main
    # pass re-raises it, so the run fails instead of showing analysis frames.
    pump_state: Dict = {"req": None, "thread": None, "stop": None,
                        "error": None}
    if preview_hdr_source is not None and on_preview is not None:
        import threading as _threading

        pump_evt = _threading.Event()
        pump_stop = _threading.Event()
        pump_lock = _threading.Lock()

        def _pump_loop():
            from ..hdr_preview import tonemap_preview_frame

            while not pump_stop.is_set():
                if not pump_evt.wait(timeout=0.2):
                    continue
                pump_evt.clear()
                with pump_lock:
                    req, pump_state["req"] = pump_state["req"], None
                if req is None:
                    continue
                idx, fallback = req
                try:
                    planes = preview_hdr_source.get_planes(idx)
                except Exception:
                    planes = None
                img = fallback
                if planes is not None:
                    p = hdr_exporter.params if hdr_exporter is not None \
                        else None
                    img = tonemap_preview_frame(
                        planes[0], planes[1],
                        max_dim=int(cfg.preview_max_dim or 0) or 1280,
                        sdr_nits=p.sdr_nits if p else 100.0,
                        tonemap=p.tonemap if p else "bt.2390",
                        full_range=p.full_range if p else False,
                        device=p.device if p else cfg.device)
                on_preview(img, idx)

        def _pump():
            try:
                _pump_loop()
            except BaseException as e:  # noqa: BLE001 — re-raised by the main pass
                pump_state["error"] = e

        pump_state["thread"] = _threading.Thread(
            target=_pump, name="pc.hdrpreview", daemon=True)
        pump_state["stop"] = pump_stop
        pump_state["evt"] = pump_evt
        pump_state["lock"] = pump_lock
        pump_state["thread"].start()

    def _maybe_preview(frame_idx: int, frame: np.ndarray) -> None:
        """Throttled preview emission (reference `_emit_preview_bgr`,
        gui_app.py:13434-13481): every `preview_every` processed frames,
        capped at `preview_fps_cap` wall-fps, downscaled to
        `preview_max_dim`."""
        if on_preview is None:
            return
        preview_state["count"] += 1
        if cfg.preview_every > 1 \
                and preview_state["count"] % cfg.preview_every != 0:
            return
        now = time.monotonic()
        if cfg.preview_fps_cap > 0 \
                and now - preview_state["last_t"] < 1.0 / cfg.preview_fps_cap:
            return
        preview_state["last_t"] = now
        if pump_state["error"] is not None:
            raise pump_state["error"]
        if pump_state["thread"] is not None:
            with pump_state["lock"]:
                pump_state["req"] = (frame_idx, _downscaled(frame))
            pump_state["evt"].set()
            return
        on_preview(_downscaled(frame), frame_idx)

    def _stop_preview_pump():
        """Stop and join the pump; returns the error that ended it, if
        any."""
        if pump_state["thread"] is not None:
            pump_state["stop"].set()
            pump_state["evt"].set()
            pump_state["thread"].join(timeout=5)
            pump_state["thread"] = None
        return pump_state["error"]

    # software pipeline (depth = cfg.tpu_pipeline_depth, default 4): later
    # batches' face and person programs are submitted before earlier
    # results are fetched, hiding the device round trips (the ReID tower
    # runs synchronously inside the resolve step). Resolution is
    # submission-ordered, so hits are depth-independent.
    inflight: List[Tuple] = []
    pipe_depth = max(1, int(getattr(cfg, "tpu_pipeline_depth", 1) or 1))

    rescue_queue: List[Tuple[int, np.ndarray]] = []
    ff_queue: List[Tuple[int, np.ndarray]] = []
    ff_batch = min(batch, 8)  # high-res program: keep the canvas batch small
    ff_counter = [0]

    def _associate_person(fb, persons, frame_idx: int, W: int, H: int):
        """Owning-person association for a matched face (reference
        gui_app.py:5920-5938): faces at/below the assoc face-height cap
        always try, cadence frames always try; the owner is the scored
        pick (core/geometry.find_person_box_for_face). Returns
        (det_box, subject_from_person)."""
        if bool(cfg.compose_detect_person_for_face) and persons:
            assoc_max = max(0.0, min(0.60, float(
                cfg.compose_person_assoc_max_face_frac)))
            cadence = max(1, int(cfg.compose_person_detect_cadence))
            face_h_frac = (fb[3] - fb[1]) / max(1.0, float(H))
            if ((assoc_max > 0.0 and face_h_frac <= assoc_max)
                    or int(frame_idx) % cadence == 0):
                from ..core.geometry import find_person_box_for_face

                det_box = find_person_box_for_face(fb, persons, W, H)
                if det_box is not None:
                    return det_box, True
        return _det_box_from_face(fb, W, H), False

    def _fullframe_rescue():
        """High-imgsz full-frame re-probe for frames that produced no
        candidate (reference full-frame face short-circuit at cadence with
        `face_fullframe_imgsz` 1408, gui_app.py:6030-6219). The dedicated
        backend letterboxes the original frame onto its larger canvas, so
        small faces keep several× more pixels than the main det_size."""
        nonlocal last_save_t
        if not ff_queue or fullframe_backend is None:
            return
        # chunk through the WHOLE queue: the cadence guarantee means every
        # queued frame gets its high-res probe (the reference probes each
        # cadence frame individually; dropping queue overflow would
        # permanently miss small-face frames)
        while ff_queue:
            items = ff_queue[:ff_batch]
            del ff_queue[:ff_batch]
            frames, idxs, valid, n = pad_batch(
                [f for (_, f, _) in items], ff_batch,
                idxs=[i for (i, _, _) in items])
            out = fullframe_backend.extract_batch(frames, valid, idxs)
            for slot, (frame_idx, frame, persons) in enumerate(items):
                mask = out["mask"][slot]
                if not mask.any():
                    continue
                fds = [(j, _face_fd(out["feats"][slot][j]))
                       for j in np.flatnonzero(mask)]
                j, fd = min(fds, key=lambda t: t[1])
                if fd > float(cfg.face_thresh):
                    continue
                fb = tuple(float(v) for v in out["boxes"][slot][j])
                q = float(out["quality"][slot][j])
                # associate the recovered face with a person box from its
                # own frame (reference rescue-path association,
                # gui_app.py:6135)
                db, from_person = _associate_person(
                    fb, persons, frame_idx, frame.shape[1], frame.shape[0])
                cand = Candidate(db, fb, fd, None, q, fd,
                                 subject_from_person=from_person,
                                 face_feat=out["feats"][slot][j])
                if frame_idx >= int(lock.last_seen_frame):
                    # never move the lock BACKWARD onto a stale frame: a
                    # newer in-batch sighting already positioned it
                    lock.register_hit(fb, frame_idx, cfg.lock_after_hits,
                                      det_box=cand.det_box)
                t = frame_idx / fps
                if t - last_save_t >= float(cfg.min_gap_sec):
                    if _compose_and_save(frame_idx, frame, cand, t):
                        last_save_t = t

    def _roi_rescue():
        """Re-probe miss-while-locked frames on a native-resolution crop
        around the last locked face (reference lock-face ROI probe,
        gui_app.py:5796-6028). The crop is resized back to the frame shape
        so the device program is reused without recompiling; coordinates
        map back through the crop transform. Runs as ONE extra batch after
        the main batch instead of per-frame."""
        import cv2

        if not rescue_queue:
            return
        if lock.last_face_box is None:
            # lock lost mid-batch: the queued frames' ROI no longer exists.
            # DROP them (don't retain ~0.5-1 GB of batch views, and never
            # probe stale frames against a future lock's ROI).
            rescue_queue.clear()
            return
        fb = lock.last_face_box
        fw = max(8.0, fb[2] - fb[0])
        fh = max(8.0, fb[3] - fb[1])
        nonlocal last_save_t
        pad = float(cfg.lock_face_roi_pad)
        items = rescue_queue[:batch]
        rescue_queue.clear()
        h, w = items[0][1].shape[:2]
        rx1 = max(0, int(fb[0] - pad * fw))
        ry1 = max(0, int(fb[1] - pad * fh))
        rx2 = min(w, int(fb[2] + pad * fw))
        ry2 = min(h, int(fb[3] + pad * fh))
        if rx2 - rx1 < 16 or ry2 - ry1 < 16:
            return
        tw, th = w, h
        if analysis_max_w and w > analysis_max_w:
            # reuse the analysis-shape program (no extra compile, small
            # upload) when tpu_mainpass_analysis_max_w is active
            tw = analysis_max_w - (analysis_max_w % 2)
            th = max(2, int(round(h * tw / w)))
            th -= th % 2
        sx = (rx2 - rx1) / tw
        sy = (ry2 - ry1) / th
        crops = np.stack([
            cv2.resize(frame[ry1:ry2, rx1:rx2], (tw, th),
                       interpolation=cv2.INTER_LINEAR)
            for _, frame, _ in items])
        crops, _, valid, n = pad_batch(list(crops), batch)
        out = backend.extract_batch(crops, valid)
        for slot, (frame_idx, frame, persons) in enumerate(items):
            mask = out["mask"][slot]
            if not mask.any():
                continue
            fds = [(j, _face_fd(out["feats"][slot][j]))
                   for j in np.flatnonzero(mask)]
            j, fd = min(fds, key=lambda t: t[1])
            if fd > float(cfg.lock_face_thresh):
                continue
            # map ROI coords back to frame space
            bx = out["boxes"][slot][j]
            face_box = (rx1 + bx[0] * sx, ry1 + bx[1] * sy,
                        rx1 + bx[2] * sx, ry1 + bx[3] * sy)
            q = float(out["quality"][slot][j])
            # associate with a person box from the frame's own detections
            # (reference lock-ROI path association, gui_app.py:5938)
            db, from_person = _associate_person(
                face_box, persons, frame_idx, frame.shape[1],
                frame.shape[0])
            cand = Candidate(db, face_box, fd, None, q, fd,
                             subject_from_person=from_person)
            if frame_idx >= int(lock.last_seen_frame):
                # never regress the lock onto an older frame's position
                lock.register_hit(face_box, frame_idx, cfg.lock_after_hits,
                                  det_box=cand.det_box)
            t = frame_idx / fps
            if t - last_save_t >= float(cfg.min_gap_sec):
                if _compose_and_save(frame_idx, frame, cand, t):
                    last_save_t = t

    def _resolve(entry):
        fetch, frames, idxs, valid, n, a_scale = entry
        with timer("main.device_fetch"):
            out, person_out = fetch()
        if a_scale != (1.0, 1.0):
            # analysis ran on host-downscaled frames: map detector coords
            # back to full reader resolution (crops/locks/compose all work
            # in full-res frame space). x and y factors differ when the
            # even-dim rounding lands differently per axis.
            sx, sy = a_scale
            box_s = np.asarray([sx, sy, sx, sy], np.float32)
            kp_s = np.asarray([sx, sy], np.float32)
            out = dict(out)
            out["boxes"] = np.asarray(out["boxes"]) * box_s
            out["kps"] = np.asarray(out["kps"]) * kp_s
            if person_out is not None:
                person_out = dict(person_out)
                person_out["boxes"] = (np.asarray(person_out["boxes"])
                                       * box_s)
        reid_map: Dict[Tuple[int, int], np.ndarray] = {}
        if _use_reid() and person_out is not None:
            with timer("main.reid"):
                crops, keys = [], []
                for slot in range(n):
                    for k in np.flatnonzero(person_out["mask"][slot]):
                        x1, y1, x2, y2 = (int(v) for v in
                                          person_out["boxes"][slot][k])
                        h, w = frames[slot].shape[:2]
                        x1, y1 = max(0, x1), max(0, y1)
                        x2, y2 = min(w - 1, x2), min(h - 1, y2)
                        if x2 <= x1 + 2 or y2 <= y1 + 2:
                            continue
                        crops.append(frames[slot][y1:y2, x1:x2])
                        keys.append((slot, int(k)))
                if crops:
                    feats = reid_backend.extract(crops)
                    reid_map = {k: feats[i] for i, k in enumerate(keys)}
        with timer("main.host_replay"):
            for slot in range(n):
                _process_frame(int(idxs[slot]), frames[slot], out,
                               person_out, reid_map, slot)
        if cfg.lock_face_roi_enable:
            with timer("main.roi_rescue"):
                _roi_rescue()
        with timer("main.fullframe_rescue"):
            _fullframe_rescue()

    analysis_max_w = int(getattr(cfg, "tpu_mainpass_analysis_max_w", 0) or 0)

    # analysis-resize pool: downscale frames on worker threads AS THEY
    # ARRIVE from the reader instead of serially inside flush() — on
    # multi-core hosts the per-frame cv2.resize (the bulk of main.submit
    # in profiles) then overlaps decode + the submit RPC. Per-frame
    # resize is deterministic, so results are worker-count-independent.
    # 1 worker (this image's auto on 1 core) stays fully inline.
    _rw = int(getattr(cfg, "tpu_resize_workers", 0) or 0)
    if _rw <= 0:
        from ..video.decodepool import auto_decode_workers
        _rw = auto_decode_workers()
    resize_pool = None
    if analysis_max_w and _rw > 1:
        from concurrent.futures import ThreadPoolExecutor
        resize_pool = ThreadPoolExecutor(max_workers=_rw,
                                         thread_name_prefix="pc.resize")
    pend_small: List = []      # futures, in lockstep with pend

    def _small_dims(w: int, h: int) -> Tuple[int, int]:
        aw = analysis_max_w - (analysis_max_w % 2)
        ah = max(2, int(round(h * aw / w)))
        return aw, ah - (ah % 2)   # even dims for the i420 wire

    def _submit_resize(frame: np.ndarray) -> None:
        if resize_pool is None:
            return
        if frame.shape[1] <= analysis_max_w:
            pend_small.append(None)
            return
        import cv2

        aw, ah = _small_dims(frame.shape[1], frame.shape[0])
        pend_small.append(resize_pool.submit(
            cv2.resize, frame, (aw, ah), interpolation=cv2.INTER_AREA))

    def _analysis_frames(frames: List[np.ndarray]):
        """Optionally downscale the batch on host before upload
        (tpu_mainpass_analysis_max_w): detection/embedding run on the
        smaller frames while crops save from full resolution; returns the
        submitted batch (stacked) + per-axis (sx, sy) factors mapping its
        coords back to full res (they differ slightly when even-dim
        rounding lands differently per axis). Takes the frame LIST so the
        full-res frames are never stacked (a batch-16 1080p stack is
        ~100 MB of pure memcpy on the submit path)."""
        h, w = frames[0].shape[0], frames[0].shape[1]
        if not analysis_max_w or w <= analysis_max_w:
            return np.stack(frames), (1.0, 1.0)
        import cv2

        aw = analysis_max_w - (analysis_max_w % 2)
        ah = max(2, int(round(h * aw / w)))
        ah -= ah % 2                       # even dims for the i420 wire
        small = np.stack([cv2.resize(f, (aw, ah),
                                     interpolation=cv2.INTER_AREA)
                          for f in frames])
        return small, (w / float(aw), h / float(ah))

    # last face_det_conf pushed to the backend — the run-start value until
    # the user live-edits it (comparing against the START value would make
    # a revert back to the initial threshold stick at the intermediate one)
    conf_state = [float(getattr(cfg, "face_det_conf", 0.0) or 0.0)]

    def flush(drain: bool = True):
        # face_det_conf is LIVE: propagate a mid-run change to the backend
        # threshold (only when actually changed — tests construct backends
        # with explicit thresholds that must not be clobbered)
        conf = float(getattr(cfg, "face_det_conf", 0.0) or 0.0)
        if conf != conf_state[0] and conf > 0.0 \
                and getattr(backend, "score_thresh", None) is not None:
            backend.score_thresh = conf
            conf_state[0] = conf
        if pend:
            # pad by repeating the last frame REFERENCE (no full-res stack:
            # host replay indexes the list per slot; only the analysis-size
            # batch is ever materialized contiguously)
            n = len(pend)
            frames = [f for (_, f) in pend]
            idxs = [i for (i, _) in pend]
            if n < batch:
                frames = frames + [frames[-1]] * (batch - n)
                idxs = idxs + [idxs[-1]] * (batch - n)
            valid = np.zeros((batch,), bool)
            valid[:n] = True
            with timer("main.submit"):
                with timer("main.submit_resize"):
                    smalls = pend_small[:n]
                    if smalls and all(s is not None for s in smalls):
                        # pre-resized on the pool as frames arrived: only
                        # the gather (usually already done) + stack remain
                        sm = [s.result() for s in smalls]
                        if n < batch:
                            sm = sm + [sm[-1]] * (batch - n)
                        h, w = frames[0].shape[0], frames[0].shape[1]
                        aw, ah = _small_dims(w, h)
                        a_frames = np.stack(sm)
                        a_scale = (w / float(aw), h / float(ah))
                    else:
                        a_frames, a_scale = _analysis_frames(frames)
                _dispatch(frames, idxs, valid, n, a_frames, a_scale)
            pend.clear()
            pend_small.clear()
        while inflight and (drain or len(inflight) > pipe_depth):
            _resolve(inflight.pop(0))

    def _dispatch(frames, idxs, valid, n, a_frames, a_scale):
        # one fetch per batch for faces and persons: the combined step (one
        # upload, one chain of ops, one download) wherever both backends
        # have it, which submit_faces_and_persons decides
        with timer("main.submit_dispatch"):
            fetch = submit_faces_and_persons(
                backend, person_backend if _use_person() else None,
                a_frames, valid, idxs)
        inflight.append((fetch, frames, idxs, valid, n, a_scale))

    def _face_fd(feat) -> float:
        if bank_mat is None:
            # empty bank: reid_only/both degradation (line ~660 accepts on
            # reid alone) must not crash on the first detected face
            return 9.0
        v = feat / max(np.linalg.norm(feat), 1e-6)
        return 1.0 - float(np.max(bank_mat @ v))

    def _process_frame(frame_idx: int, frame: np.ndarray, out: Dict,
                       person_out: Optional[Dict],
                       reid_map: Dict, slot: int):
        decision = _process_frame_inner(frame_idx, frame, out, person_out,
                                        reid_map, slot)
        persons = []
        if person_out is not None:
            pm = person_out["mask"][slot]
            persons = [tuple(float(v) for v in person_out["boxes"][slot][k])
                       for k in np.flatnonzero(pm)]
        if (decision == "no_candidate" and lock.locked
                and cfg.lock_face_roi_enable
                and lock.last_face_box is not None):
            rescue_queue.append((frame_idx, frame, persons))
        elif (decision == "no_candidate" and fullframe_backend is not None
              and cfg.face_fullframe_when_missed):
            # high-res re-probe at cadence (face_fullframe_cadence). The
            # reference probes every cadence frame that produced no
            # candidate (gui_app.py:6038-6046) — including frames where a
            # face WAS detected but embedded/matched badly at the main det
            # size, the prime small-blurry-face recall case
            ff_counter[0] += 1
            if ff_counter[0] % max(1, int(cfg.face_fullframe_cadence)) == 0:
                ff_queue.append((frame_idx, frame, persons))
        if cfg.debug_dump:
            n_faces = int(out["mask"][slot].sum())
            n_persons = int(person_out["mask"][slot].sum()) \
                if person_out is not None else 0
            _dump({"frame": frame_idx, "faces": n_faces,
                   "persons": n_persons, "locked": lock.locked,
                   "decision": decision})

    def _process_frame_inner(frame_idx: int, frame: np.ndarray, out: Dict,
                             person_out: Optional[Dict],
                             reid_map: Dict, slot: int) -> str:
        nonlocal last_save_t
        res.frames_processed += 1
        _maybe_preview(frame_idx, frame)
        H, W = frame.shape[:2]

        # lock loss timeout (reference gui_app.py:8007-8010): the lock dies
        # after max(2*faceless_persist, 6*stride) frames without a sighting
        if lock.locked and lock.last_seen_frame >= 0:
            lose_after = max(int(cfg.faceless_persist_frames) * 2, stride * 6)
            if frame_idx - lock.last_seen_frame > lose_after:
                lock.clear()

        fmask = out["mask"][slot]
        face_list = []  # (box, fd, quality, feat)
        for j in np.flatnonzero(fmask):
            feat = out["feats"][slot][j]
            fd = _face_fd(feat)
            if cfg.suppress_negatives and negatives:
                v = feat / max(np.linalg.norm(feat), 1e-6)
                neg_d = min(1.0 - float(np.dot(n, v)) for n in negatives)
                if neg_d <= float(cfg.neg_tolerance):
                    continue  # known hard negative — suppress this face
            face_list.append((tuple(float(v) for v in out["boxes"][slot][j]),
                              fd, float(out["quality"][slot][j]), feat))
            # learn hard negatives: clearly-other-identity faces
            if (cfg.suppress_negatives
                    and fd >= cfg.face_thresh + float(cfg.neg_tolerance)
                    and len(negatives) < int(cfg.max_negatives)):
                v = feat / max(np.linalg.norm(feat), 1e-6)
                if not negatives or all(
                        1.0 - float(np.dot(n, v)) > float(cfg.neg_tolerance)
                        for n in negatives):
                    negatives.append(v.astype(np.float32))
        any_face_match = any(fd <= cfg.face_thresh
                             for _, fd, _, _ in face_list)
        # frame-global face visibility for the face-first policy (reference
        # gui_app.py:6325-6331: quality-filtered count or raw detection)
        if cfg.face_visible_uses_quality:
            any_face_visible = any(q >= cfg.face_quality_min
                                   for _, _, q, _ in face_list)
        else:
            any_face_visible = bool(face_list)

        candidates: List[Candidate] = []
        mode = cfg.match_mode
        # Missing-reference degradation (reference gui_app.py:6381-6385): a
        # run without a face bank degrades both/face_only to reid_only; a run
        # without a ReID signal (no backend, disabled, or no ref feature)
        # degrades both/reid_only to face_only.
        eff_mode = mode
        if bank_mat is None and eff_mode in ("both", "face_only"):
            eff_mode = "reid_only"
        if (not _use_reid() or ref_reid_feat is None) \
                and eff_mode in ("both", "reid_only"):
            eff_mode = "face_only"
        persons = []
        if person_out is not None:
            pmask = person_out["mask"][slot]
            persons = [tuple(float(v) for v in person_out["boxes"][slot][k])
                       for k in np.flatnonzero(pmask)]

        skip_person_eval = (mode == "face_only"
                            and cfg.skip_yolo_when_faceonly and face_list)

        if persons and not skip_person_eval:
            pmask_idx = np.flatnonzero(person_out["mask"][slot])
            for ki, pbox in zip(pmask_idx, persons):
                # area/aspect gates (reference gui_app.py:6246-6258)
                area = (pbox[2] - pbox[0]) * (pbox[3] - pbox[1])
                if area < cfg.min_box_pixels:
                    continue
                in_faces = [(b, fd, q, ft) for (b, fd, q, ft) in face_list
                            if _center_in_box(b, pbox)]
                fb, fd, q, fft = (None, None, 0.0, None)
                if in_faces:
                    fb, fd, q, fft = min(in_faces, key=lambda t: t[1])
                rd = None
                feat = reid_map.get((slot, int(ki)))
                if feat is not None:
                    rd = 1.0 - float(np.dot(feat, ref_reid_feat))
                face_ok = fd is not None and fd <= cfg.face_thresh
                reid_ok = rd is not None and rd <= cfg.reid_thresh
                if eff_mode == "face_only":
                    accept = face_ok
                elif eff_mode == "reid_only":
                    accept = reid_ok
                elif eff_mode == "both":
                    # per-candidate degradation (gui_app.py:6388-6393): a
                    # candidate missing one signal is judged on the other
                    if fd is None and rd is not None:
                        accept = reid_ok
                    elif rd is None and fd is not None:
                        accept = face_ok
                    else:
                        accept = face_ok and reid_ok
                else:  # either
                    accept = face_ok or reid_ok
                # 'either'/'reid_only' explicitly allow ReID acceptance while
                # other faces are visible (gui_app.py:6402)
                if (cfg.drop_reid_if_any_face_match
                        and eff_mode not in ("either", "reid_only")
                        and any_face_match and not face_ok and accept):
                    accept = False
                # face-first policy (reference gui_app.py:6415-6436): in
                # both/face_only, when ANY face is visible in the frame a
                # candidate only survives with its OWN matched face — no
                # face in the crop, an absurdly low-quality face, or a
                # failing face identity all hard-drop it. 'either' and
                # 'reid_only' are exempt by design (revised policy: don't
                # overrule a solid ReID match with a gate triggered by a
                # face elsewhere in the frame).
                if (cfg.require_face_if_visible and any_face_visible
                        and bank_mat is not None
                        and eff_mode in ("both", "face_only")):
                    qfail = fb is None
                    if fb is not None and q < float(getattr(
                            cfg, "face_quality_floor_absurd", 15.0)):
                        qfail = True
                    if fb is not None and not face_ok:
                        qfail = True
                    if qfail:
                        accept = False
                if not accept:
                    continue
                score = combine_scores(fd, rd, cfg.combine)
                candidates.append(Candidate(pbox, fb, fd, rd, q,
                                            score if score is not None else 9.0,
                                            subject_from_person=True,
                                            face_feat=fft,
                                            reid_feat=reid_map.get(
                                                (slot, int(ki)))))

        # global-face fallback / face_only short path: only in effective modes
        # where a face match alone may accept (both/reid_only degrade to
        # face_only above when the ReID reference signal is missing entirely)
        face_may_accept = eff_mode in ("face_only", "either")
        if not candidates and face_list and face_may_accept:
            ordered = sorted(face_list, key=lambda t: t[1])
            fb, fd, q, fft = ordered[0]
            # face ambiguity margin between two DISTINCT faces (reference
            # gui_app.py:7797: `face_margin_min` on the top-2 fd gap)
            if (len(ordered) > 1 and cfg.face_margin_min > 0
                    and (ordered[1][1] - fd) < float(cfg.face_margin_min)
                    and box_iou(ordered[1][0], fb) < 0.5
                    and ordered[1][1] <= cfg.face_thresh):
                lock.register_miss(cfg.lock_face_roi_max_misses)
                # keep the motion-gate reference frame fresh on this early
                # return too, or the next faceless fallback diffs against a
                # frame from 2+ strides back
                prev_frame[0] = frame
                return "ambiguous_face"
            if fd <= cfg.face_thresh:
                # body-aware compose association (reference
                # gui_app.py:5920-5938): faces at or below the assoc
                # face-height cap ALWAYS try to bind an owning person box
                # (true close-ups stay face-anchored), and cadence frames
                # associate regardless; the owning box is the reference's
                # scored pick, not first-containment
                det_box, from_person = _associate_person(fb, persons,
                                                         frame_idx, W, H)
                score = combine_scores(fd, None, cfg.combine)
                candidates.append(Candidate(det_box, fb, fd, None, q,
                                            score if score is not None else 9.0,
                                            subject_from_person=from_person,
                                            face_feat=fft))

        # faceless fallback: while locked, a person box may be accepted via
        # ReID distance or IoU continuity with motion/area/drift gates
        # (reference: gui_app.py:7645-7769)
        if (not candidates and lock.locked and cfg.allow_faceless_when_locked
                and persons and lock.last_det_box is not None):
            diag = math.hypot(W, H)
            frame_area = float(W * H)
            best_fb = None
            pmask_idx2 = (np.flatnonzero(person_out["mask"][slot])
                          if person_out is not None else [])
            for ki, pbox in zip(pmask_idx2, persons):
                area_frac = ((pbox[2] - pbox[0]) * (pbox[3] - pbox[1])
                             / frame_area)
                if not (cfg.faceless_min_area_frac <= area_frac
                        <= cfg.faceless_max_area_frac):
                    continue
                lcx = 0.5 * (lock.last_det_box[0] + lock.last_det_box[2])
                lcy = 0.5 * (lock.last_det_box[1] + lock.last_det_box[3])
                pcx = 0.5 * (pbox[0] + pbox[2])
                pcy = 0.5 * (pbox[1] + pbox[3])
                if math.hypot(pcx - lcx, pcy - lcy) \
                        > cfg.faceless_center_max_frac * diag:
                    continue
                iou = box_iou(pbox, lock.last_det_box)
                rd = None
                feat = reid_map.get((slot, int(ki)))
                if feat is not None and ref_reid_feat is not None:
                    rd = 1.0 - float(np.dot(feat, ref_reid_feat))
                # the lock's EMA'd ReID feature also validates continuity
                # (reference locked_feat path, gui_app.py:7660)
                rd_lock = None
                if feat is not None and lock.reid_feat is not None:
                    rd_lock = 1.0 - float(np.dot(feat, lock.reid_feat))
                ok = (iou >= cfg.faceless_iou_min
                      or (rd is not None and rd <= cfg.faceless_reid_thresh)
                      or (rd_lock is not None
                          and rd_lock <= float(cfg.lock_reid_thresh)))
                if not ok:
                    continue
                if cfg.faceless_min_motion_frac > 0 and prev_frame[0] is not None:
                    x1i, y1i = max(0, int(pbox[0])), max(0, int(pbox[1]))
                    x2i, y2i = min(W, int(pbox[2])), min(H, int(pbox[3]))
                    if x2i > x1i and y2i > y1i:
                        roi_a = frame[y1i:y2i, x1i:x2i].astype(np.int16)
                        roi_b = prev_frame[0][y1i:y2i, x1i:x2i].astype(np.int16)
                        if roi_a.shape == roi_b.shape:
                            moving = (np.abs(roi_a - roi_b).max(axis=-1)
                                      > 12).mean()
                            if moving < cfg.faceless_min_motion_frac:
                                continue
                cand = Candidate(pbox, None, None, rd, 0.0,
                                 rd if rd is not None else 1.0 - iou,
                                 subject_from_person=True, reid_feat=feat)
                if best_fb is None or cand.score < best_fb.score:
                    best_fb = cand
            if best_fb is not None:
                candidates.append(best_fb)

        # last-resort lock carry (reference gui_app.py:7719-7730): within
        # `faceless_persist_frames` of the last sighting, reuse the lock's
        # subject box verbatim. Off by default (0 disables, like the
        # reference's "disable carry to avoid background crops").
        persist = int(cfg.faceless_persist_frames)
        if (not candidates and persist > 0 and mode != "face_only"
                and lock.last_det_box is not None
                and lock.last_seen_frame >= 0
                and frame_idx - lock.last_seen_frame <= persist):
            lb = (max(0.0, lock.last_det_box[0]),
                  max(0.0, lock.last_det_box[1]),
                  min(float(W), lock.last_det_box[2]),
                  min(float(H), lock.last_det_box[3]))
            if lb[2] > lb[0] + 2 and lb[3] > lb[1] + 2:
                candidates.append(Candidate(lb, None, None, None, 0.0, 8.0,
                                            subject_from_person=True,
                                            carried=True))

        prev_frame[0] = frame

        if not candidates:
            lock.register_miss(cfg.lock_face_roi_max_misses)
            return "no_candidate"

        if cfg.prefer_face_when_available:
            # candidates with a visible matched face outrank faceless ones
            # regardless of raw score (reference prefer_face knob)
            candidates.sort(key=lambda c: (c.face_box is None, c.score))
        else:
            candidates.sort(key=lambda c: c.score)
        best = candidates[0]
        # ambiguity margin between distinct identities (gui_app.py:7788+)
        if len(candidates) > 1 and cfg.score_margin > 0:
            second = candidates[1]
            if (second.score - best.score) < cfg.score_margin \
                    and box_iou(best.det_box, second.det_box) < 0.5:
                lock.register_miss(cfg.lock_face_roi_max_misses)
                return "ambiguous"

        # lock IoU gate
        if (lock.locked and lock.last_face_box is not None
                and best.face_box is not None):
            iou = box_iou(best.face_box, lock.last_face_box)
            if iou < float(cfg.iou_gate) and (
                    best.fd is None or best.fd > float(cfg.lock_face_thresh)):
                lock.register_miss(cfg.lock_face_roi_max_misses)
                return "iou_gate"

        if not best.carried:
            lock.register_hit(best.face_box, frame_idx, cfg.lock_after_hits,
                              det_box=best.det_box)
            lock.update_reid(best.reid_feat, cfg.lock_momentum)

        # optional runtime bank growth (reference gui_app.py:7460: accepted
        # face embeddings keep enriching the reference bank mid-run)
        if (cfg.learn_bank_runtime and best.face_feat is not None
                and best.fd is not None and best.fd <= cfg.prescan_fd_add
                and best.quality >= cfg.face_quality_min):
            action, _ = bank.update(np.asarray(best.face_feat, np.float32),
                                    float(best.quality))
            if action in ("added", "replaced"):
                _refresh_bank_mat()

        t = frame_idx / fps
        if t - last_save_t < float(cfg.min_gap_sec):
            return "min_gap"

        saved = _compose_and_save(frame_idx, frame, best, t)
        if not cfg.only_best:
            # save every accepted candidate (reference only_best=False)
            for k, cand in enumerate(candidates[1:], start=1):
                if _compose_and_save(frame_idx, frame, cand, t,
                                     suffix=f"_p{k}"):
                    saved = True
        if saved:
            last_save_t = t
        return "saved" if saved else "compose_rejected"

    def _compose_and_save(frame_idx: int, frame: np.ndarray, best: Candidate,
                          t: float, suffix: str = "") -> bool:
        with timer("main.compose_save"):
            return _compose_and_save_inner(frame_idx, frame, best, t, suffix)

    def _compose_and_save_inner(frame_idx: int, frame: np.ndarray,
                                best: Candidate, t: float,
                                suffix: str = "") -> bool:
        H, W = frame.shape[:2]
        work = frame
        off_x = off_y = 0
        if cfg.auto_crop_borders:
            # border_scan_frac bounds the scan depth (reference
            # gui_app.py:3368: fraction of min(W, H))
            scan = max(8, int(float(cfg.border_scan_frac) * min(H, W))) \
                if cfg.border_scan_frac > 0 else None
            with timer("main.save_borders"):
                bx1, by1, bx2, by2 = detect_black_borders(
                    frame, thr=int(cfg.border_threshold), max_scan=scan)
            if (bx1, by1) != (0, 0) or (bx2, by2) != (W, H):
                work = frame[by1:by2, bx1:bx2]
                off_x, off_y = bx1, by1
        wh, ww = work.shape[:2]
        fb = None
        anchor = None
        if best.face_box is not None:
            fb = (best.face_box[0] - off_x, best.face_box[1] - off_y,
                  best.face_box[2] - off_x, best.face_box[3] - off_y)
            anchor = (0.5 * (fb[0] + fb[2]), 0.5 * (fb[1] + fb[3]))
        det_box = (best.det_box[0] - off_x, best.det_box[1] - off_y,
                   best.det_box[2] - off_x, best.det_box[3] - off_y)
        if cfg.compose_crop_enable:
            from ..core.compose_profiles import (compose_dataset_crop,
                                                 prefer_lower_face_crop_y)
            from ..core.geometry import face_head_proxy_box

            subj = det_box if best.subject_from_person else None
            with timer("main.save_compose"):
                crop, ratio, profile = compose_dataset_crop(
                    cfg, det_box, ratios, (0, 0, ww, wh), subject_box=subj,
                    face_box=fb, frame_idx=frame_idx)
            head = face_head_proxy_box(fb, ww, wh,
                                       cfg.crop_head_side_pad_frac,
                                       cfg.crop_head_top_pad_frac,
                                       cfg.crop_head_bottom_pad_frac) \
                if fb is not None else None
            crop = prefer_lower_face_crop_y(crop, fb, head, (0, 0, ww, wh),
                                            profile)
            if cfg.smart_crop_enable:
                from ..core.smartcrop import smart_crop_box

                with timer("main.save_smartcrop"):
                    crop = smart_crop_box(
                        work, crop, fb, steps=cfg.smart_crop_steps,
                        side_search_frac=cfg.smart_crop_side_search_frac,
                        use_grad=cfg.smart_crop_use_grad)
            if fb is not None:
                # final containment repair: translate the fixed-size crop so
                # the detected face stays fully visible (reference save-path
                # repair chain, gui_app.py:6711-6750)
                from ..core.geometry import shift_crop_to_include_box

                crop = shift_crop_to_include_box(crop, fb, (0, 0, ww, wh),
                                                 margin_px=1.0)
        else:
            crop, ratio, _ = choose_best_ratio(det_box, ratios, ww, wh, cfg,
                                               anchor=anchor, face_box=fb)
            crop = enforce_scale_and_margins(crop, ratio or ratios[0], ww, wh,
                                             cfg, face_box=fb, anchor=anchor)
        x1, y1, x2, y2 = crop
        if (x2 - x1) * (y2 - y1) < int(cfg.min_box_pixels):
            return False
        if cfg.side_guard_drop_enable and fb is not None:
            fw = max(1.0, fb[2] - fb[0])
            want = (cfg.crop_face_side_margin_frac * fw
                    * cfg.side_guard_drop_factor)
            left, right = fb[0] - x1, x2 - fb[2]
            face_at_edge = fb[0] <= 1.0 or fb[2] >= ww - 1.0
            if min(left, right) < want and not face_at_edge:
                return False
        img = crop_img(work, crop)
        if img.size == 0:
            return False
        with timer("main.save_sharpness"):
            sharp = calc_sharpness(img)
        if cfg.min_sharpness > 0 and sharp < cfg.min_sharpness:
            return False

        path = os.path.join(crops_dir, f"f{frame_idx:08d}{suffix}.jpg")
        render_begin = None
        render_finish = None
        cancel_ev = None
        if hdr_exporter is not None and cfg.hdr_screencap_fullres:
            # full-resolution HDR→SDR still re-rendered from the source
            # planes on the saver thread (reference: gui_app.py:7233-7312)
            # as a TWO-PHASE item: the saver dispatches the next device
            # render before PNG-encoding the previous one (depth-1 export
            # pipelining). The cancel event lets the saver abandon a render
            # that blows the hdr_export_timeout_sec budget (gui_app.py:
            # 7320-7332).
            import threading as _threading

            path = hdr_exporter.out_path_for(path)
            crop_frame_coords = (x1 + off_x, y1 + off_y,
                                 x2 + off_x, y2 + off_y)
            cancel_ev = _threading.Event()
            render_begin = (lambda fi=frame_idx, cc=crop_frame_coords,
                            ev=cancel_ev:
                            hdr_exporter.begin(fi, cc, (W, H), cancel=ev))
            render_finish = (lambda pending, p, ev=cancel_ev:
                             hdr_exporter.finish(pending, p, cancel=ev))
        row = [frame_idx, f"{t:.3f}",
               f"{best.score:.4f}",
               f"{best.fd:.4f}" if best.fd is not None else "",
               f"{best.rd:.4f}" if best.rd is not None else "",
               x1 + off_x, y1 + off_y, x2 + off_x, y2 + off_y,
               os.path.basename(path), f"{sharp:.4f}", ratio or ""]
        saver.submit(SaveItem(img=img, path=path, csv_row=row,
                              render_begin=render_begin,
                              render_finish=render_finish,
                              cancel_event=cancel_ev))
        if cfg.async_save_wait:
            # synchronous ack (reference wait_for_save, gui_app.py:7278):
            # block until the saver drained this item
            saver.wait_empty()
        if cfg.save_annot:
            _save_annot(frame_idx, frame, best, (x1 + off_x, y1 + off_y,
                                                 x2 + off_x, y2 + off_y))
        hit = Hit(frame_idx, t, best.score, best.fd, best.rd,
                  (x1 + off_x, y1 + off_y, x2 + off_x, y2 + off_y),
                  path, sharp, ratio)
        res.hits.append(hit)
        if on_hit is not None:
            # live hit feed (reference emits each hit as it saves,
            # gui_app.py:7983-7993 hit_q relay) — not a burst at the end
            try:
                on_hit(hit)
            except Exception:  # noqa: BLE001 — a UI callback must not kill the run
                pass
        return True

    def _save_annot(frame_idx: int, frame: np.ndarray, best: Candidate,
                    crop):
        """Annotated full frame (reference main.py:330-343): person box
        green, crop blue, face red, score text."""
        try:
            import cv2
        except ImportError:
            return
        annot_dir = os.path.join(cfg.out_dir, "annot")
        os.makedirs(annot_dir, exist_ok=True)
        vis = frame.copy()
        d = tuple(int(v) for v in best.det_box)
        cv2.rectangle(vis, d[:2], d[2:], (0, 255, 0), 2)
        cv2.rectangle(vis, crop[:2], crop[2:], (255, 0, 0), 2)
        if best.face_box is not None:
            f = tuple(int(v) for v in best.face_box)
            cv2.rectangle(vis, f[:2], f[2:], (0, 0, 255), 2)
        # overlay gates (reference overlay_scores / overlay_face_fd knobs)
        text = []
        if cfg.overlay_scores:
            rd_s = f"{best.rd:.3f}" if best.rd is not None else "-1"
            text.append(f"score={best.score:.3f} rd={rd_s}")
        if cfg.overlay_face_fd:
            text.append(f"fd={best.fd:.3f}" if best.fd is not None
                        else "fd=-1")
        if text:
            cv2.putText(vis, " ".join(text), (15, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2)
        saver.submit(SaveItem(
            img=vis, path=os.path.join(annot_dir, f"f{frame_idx:08d}.jpg")))

    # ---- span-gated decode loop ---------------------------------------
    from ..video.reader import smart_seek

    from ..core.spans import span_index_for

    def _poll_seek() -> Optional[int]:
        if seek_request is None:
            return None
        return seek_request()

    try:
        si = 0
        start_override: Optional[int] = None
        while si < len(spans):
            s, e = spans[si]
            if should_stop is not None and should_stop():
                break
            target = max(s, start_override) if start_override is not None else s
            start_override = None
            with timer("main.seek"):
                idx = smart_seek(reader, target, keyframes, cfg.seek_fast,
                                 cfg.seek_max_grabs, fps)
            if idx > e:
                si += 1
                continue
            # seek_fast caps the forward grabs after a keyframe landing, so
            # smart_seek can stop SHORT of the span start — skip the rest, or
            # frames pre-scan excluded would be analyzed (and saveable)
            with timer("main.seek"):
                while idx < target:
                    skipped = reader.skip(target - idx)
                    if skipped <= 0:
                        break
                    idx += skipped
            seek_jump = False
            while idx <= e:
                if should_stop is not None and should_stop():
                    break
                seek_to = _poll_seek()
                if seek_to is not None:
                    # interactive seek (reference seek_frame command): flush in
                    # order, then resume at the span containing/after the target
                    flush()
                    if int(cfg.seek_preview_peek_every) > 0:
                        # peek preview at the seek landing (reference decodes a
                        # peek every N frames while scrubbing; keyframe seeks
                        # land instantly so one peek per landing suffices)
                        preview_state["count"] = -1  # next frame emits
                        preview_state["last_t"] = -1e9
                    nsi = span_index_for(int(seek_to), spans)
                    if nsi is None:
                        si = len(spans)
                    else:
                        si = nsi
                        start_override = int(seek_to)
                    seek_jump = True
                    break
                with timer("main.decode"):
                    frame = reader.read()
                if frame is None:
                    break
                res.frames_decoded += 1
                pend.append((idx, frame))
                _submit_resize(frame)
                if len(pend) == batch:
                    flush(drain=False)
                    if progress is not None and meta.total_frames > 0:
                        progress(min(1.0, idx / meta.total_frames))
                # frame_stride is LIVE (engine.update_cfg): re-read per
                # iteration and keep a prefetch wrapper's speculation in
                # step (a mismatch costs one resync, then it realigns)
                new_stride = max(1, int(cfg.frame_stride))
                if new_stride != stride:
                    stride = new_stride
                    if getattr(reader, "stride", None) is not None:
                        reader.stride = stride
                with timer("main.skip"):
                    skipped = reader.skip(stride - 1)
                idx += 1 + skipped
                if skipped < stride - 1:
                    break
            if seek_jump:
                continue
            flush()
            si += 1
        flush()
    finally:
        # the pump thread polls preview_hdr_source, which the
        # engine releases right after this returns: stop it on
        # EVERY exit path (a device error mid-run otherwise
        # leaves an orphaned thread racing a closed pipe)
        pump_error = _stop_preview_pump()
        if resize_pool is not None:
            resize_pool.shutdown(wait=False, cancel_futures=True)
        if debug_state["fh"] is not None:
            debug_state["fh"].close()
    if pump_error is not None:
        raise pump_error
    res.wall_s = time.perf_counter() - t0
    return res


def _det_box_from_face(fb, frame_w: int, frame_h: int):
    """Approximate a subject box from a face box when no person detector ran
    (face_only without YOLO): head + torso extent below the face."""
    fx1, fy1, fx2, fy2 = fb
    fw = max(1.0, fx2 - fx1)
    fh = max(1.0, fy2 - fy1)
    x1 = max(0.0, fx1 - 1.2 * fw)
    x2 = min(float(frame_w), fx2 + 1.2 * fw)
    y1 = max(0.0, fy1 - 1.0 * fh)
    y2 = min(float(frame_h), fy2 + 4.0 * fh)
    return (x1, y1, x2, y2)
