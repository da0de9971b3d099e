"""Batched face-recovery ladder: rotation / scale-TTA / edge-pad probes.

The reference escalates per frame inside ``FaceEmbedder.extract``: empty 0°
pass → multi-scale TTA (0.75/0.60/1.25) → edge replicate-pad probe → rotated
90/270/180 probes with coordinate remap and cross-rotation NMS
(person_capture/face_embedder.py:2251-2443), with adaptive gating by no-face
streak (489-497) and a round-robin rotation period in pre-scan fast mode
(1224-1236).

TPU-first redesign: escalation never changes the compiled program. A
:class:`RecoveringFaceBackend` wraps any FaceBatchBackend; after the 0°
batch resolves, frames whose slots came back empty are re-queued as
*variants* (rotated / scaled / edge-padded copies on the same canvas) packed
into at most ``max_extra_batches`` additional fixed-shape device calls.
Detections are remapped to original frame coordinates by each variant's
affine, merged per slot with host NMS, and written back into the batch
output — transparent to the pre-scan/main-pass drivers and to their ordered
replay. Rotated variants also fix the *embedding*: the aligned chip is cut
from the rotated (upright-face) frame, so ArcFace sees what it was trained
on, exactly like the reference's rotated re-detect.

Wired config keys: ``rot_adaptive``, ``rot_every_n``,
``rot_after_hit_frames``, ``prescan_rot_probe_period``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TTA_SCALES = (0.75, 0.60, 1.25)  # reference face_embedder.py:2253-2283
EDGE_PAD_FRAC = 0.125            # reference edge replicate-pad probe
ROTATION_KS = (1, 3, 2)          # np.rot90 k: 90° CCW, 90° CW, 180°
AFFINE_DEGS = (45, -45, 135, -135)  # YOLO-face backend extra probes
                                    # (reference face_embedder.py:1935-2036)


def _variant_rot(frame: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate by k*90° CCW. Returns (image, remap M[2,3]) with
    ``(x, y) = M @ (xr, yr, 1)`` mapping variant coords → original coords.
    Non-square frames change shape under k=1/3; the caller letterboxes every
    variant back onto the original canvas, so we fold the fit-scale in."""
    h, w = frame.shape[:2]
    img = np.ascontiguousarray(np.rot90(frame, k))
    if k == 1:    # R[i,j] = F[j, W-1-i]  →  x = W-1-yr, y = xr
        m = np.array([[0.0, -1.0, w - 1.0], [1.0, 0.0, 0.0]], np.float64)
    elif k == 3:  # R[i,j] = F[H-1-j, i]  →  x = yr, y = H-1-xr
        m = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, h - 1.0]], np.float64)
    else:         # 180°: x = W-1-xr, y = H-1-yr
        m = np.array([[-1.0, 0.0, w - 1.0], [0.0, -1.0, h - 1.0]], np.float64)
    return img, m


def _fit_to_canvas(img: np.ndarray, h: int, w: int,
                   m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Scale-to-fit ``img`` top-left onto an (h, w) canvas, composing the
    fit into the remap matrix."""
    import cv2

    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img, m
    s = min(h / ih, w / iw)
    nh, nw = max(1, int(round(ih * s))), max(1, int(round(iw * s)))
    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA
                         if s < 1.0 else cv2.INTER_LINEAR)
    canvas = np.zeros((h, w, img.shape[2]), img.dtype)
    canvas[:nh, :nw] = resized
    fit = np.array([[1.0 / s, 0.0, 0.0], [0.0, 1.0 / s, 0.0]], np.float64)
    return canvas, _compose(m, fit)


def _compose(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """(outer ∘ inner) for 2x3 affines: apply inner first."""
    m = np.zeros((2, 3), np.float64)
    m[:, :2] = outer[:, :2] @ inner[:, :2]
    m[:, 2] = outer[:, :2] @ inner[:, 2] + outer[:, 2]
    return m


def make_rotation_variant(frame: np.ndarray, k: int):
    img, m = _variant_rot(frame, k)
    return _fit_to_canvas(img, frame.shape[0], frame.shape[1], m)


def make_scale_variant(frame: np.ndarray, scale: float):
    """scale<1: shrink onto the canvas (catches too-large faces).
    scale>1: upscale and center-crop (catches too-small central faces)."""
    import cv2

    h, w = frame.shape[:2]
    if scale <= 1.0:
        nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
        resized = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_AREA)
        canvas = np.zeros_like(frame)
        canvas[:nh, :nw] = resized
        m = np.array([[1.0 / scale, 0, 0], [0, 1.0 / scale, 0]], np.float64)
        return canvas, m
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_LINEAR)
    oy, ox = (nh - h) // 2, (nw - w) // 2
    canvas = resized[oy:oy + h, ox:ox + w]
    m = np.array([[1.0 / scale, 0, ox / scale],
                  [0, 1.0 / scale, oy / scale]], np.float64)
    return np.ascontiguousarray(canvas), m


def make_zoom_rot_variant(frame: np.ndarray, box_xyxy, k: int,
                          pad: float = 0.75):
    """Heavy re-detect variant (reference rotated probe→heavy pass,
    face_embedder.py:2363-2433 with prescan_heavy_90/180 imgsz): crop the
    original frame around a probe hit, rotate upright, scale-fill the
    canvas — the face gets several× more pixels without changing the
    compiled shape."""
    h, w = frame.shape[:2]
    x1, y1, x2, y2 = box_xyxy
    bw, bh = max(8.0, x2 - x1), max(8.0, y2 - y1)
    cx1 = int(max(0, x1 - pad * bw))
    cy1 = int(max(0, y1 - pad * bh))
    cx2 = int(min(w, x2 + pad * bw))
    cy2 = int(min(h, y2 + pad * bh))
    if cx2 - cx1 < 8 or cy2 - cy1 < 8:
        return None
    crop = np.ascontiguousarray(frame[cy1:cy2, cx1:cx2])
    off = np.array([[1.0, 0.0, cx1], [0.0, 1.0, cy1]], np.float64)
    if k:
        img, m = _variant_rot(crop, k)
        m = _compose(off, m)
    else:
        img, m = crop, off
    return _fit_to_canvas(img, h, w, m)


def make_affine_variant(frame: np.ndarray, deg: float):
    """Rotate by an arbitrary angle about the center, scaled so the whole
    frame stays on the canvas (replicate border) — the reference's
    YOLO-face-backend ±45/±135° probes (face_embedder.py:1935-2036)."""
    import cv2

    h, w = frame.shape[:2]
    rad = np.deg2rad(deg)
    c, s = abs(np.cos(rad)), abs(np.sin(rad))
    scale = min(w / (w * c + h * s), h / (h * c + w * s))
    mat = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), float(deg), scale)
    img = cv2.warpAffine(frame, mat, (w, h),
                         flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REPLICATE)
    # remap = inverse affine (variant coords → original coords)
    inv = cv2.invertAffineTransform(mat)
    return img, np.asarray(inv, np.float64)


def make_edgepad_variant(frame: np.ndarray, frac: float = EDGE_PAD_FRAC):
    """Replicate-pad all borders then resize back to the canvas — recovers
    faces clipped at frame edges (reference face_embedder.py:2288-2315)."""
    import cv2

    h, w = frame.shape[:2]
    p = max(2, int(round(frac * min(h, w))))
    padded = cv2.copyMakeBorder(frame, p, p, p, p, cv2.BORDER_REPLICATE)
    resized = cv2.resize(padded, (w, h), interpolation=cv2.INTER_AREA)
    sx, sy = (w + 2 * p) / w, (h + 2 * p) / h
    m = np.array([[sx, 0, -p], [0, sy, -p]], np.float64)
    return resized, m


def apply_remap_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """pts [..., 2] variant coords → original coords."""
    return pts @ m[:, :2].T + m[:, 2]


def apply_remap_boxes(m: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """xyxy boxes through the affine (axis swaps/flips re-sorted)."""
    c1 = apply_remap_points(m, boxes[..., 0:2])
    c2 = apply_remap_points(m, boxes[..., 2:4])
    lo = np.minimum(c1, c2)
    hi = np.maximum(c1, c2)
    return np.concatenate([lo, hi], axis=-1)


def nms_host(boxes: np.ndarray, scores: np.ndarray,
             iou_thresh: float = 0.4) -> List[int]:
    """Greedy NMS on host (cross-rotation merge; small candidate counts)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    for i in order:
        bi = boxes[i]
        ok = True
        for j in keep:
            bj = boxes[j]
            ix = max(0.0, min(bi[2], bj[2]) - max(bi[0], bj[0]))
            iy = max(0.0, min(bi[3], bj[3]) - max(bi[1], bj[1]))
            inter = ix * iy
            ua = ((bi[2] - bi[0]) * (bi[3] - bi[1])
                  + (bj[2] - bj[0]) * (bj[3] - bj[1]) - inter)
            if inter / max(ua, 1e-9) > iou_thresh:
                ok = False
                break
        if ok:
            keep.append(int(i))
    return keep


class RecoveryPolicy:
    """Decides which variants to probe for each empty frame, in sample
    order. Sequential state (no-face streak, sticky rotation, round-robin
    counter) mirrors the reference's adaptive gating."""

    def __init__(self, rot_adaptive: bool = True, rot_every_n: int = 12,
                 rot_after_hit_frames: int = 8,
                 prescan_rot_probe_period: int = 3,
                 use_scale_tta: bool = True, use_edge_pad: bool = True,
                 affine_probes: bool = False):
        self.rot_adaptive = bool(rot_adaptive)
        self.rot_every_n = max(1, int(rot_every_n))
        self.rot_after_hit_frames = max(0, int(rot_after_hit_frames))
        self.rr_period = max(1, int(prescan_rot_probe_period))
        self.use_scale_tta = bool(use_scale_tta)
        self.use_edge_pad = bool(use_edge_pad)
        # ±45/±135° extra probes — enabled for the YOLOv8-face backend like
        # the reference (SCRFD handles these via its rotated crops instead)
        self.affine_probes = bool(affine_probes)
        self.prescan_fast = False
        self.heavy = False       # zoomed re-detect after rotated hits
        self.streak = 0          # consecutive no-face frames
        self.empty_count = 0     # total no-face frames seen
        self.sticky_rot: Optional[int] = None
        self.sticky_left = 0
        self._rr = 0

    def set_prescan_fast(self, fast: bool) -> None:
        self.prescan_fast = bool(fast)

    @classmethod
    def from_config(cls, cfg) -> "RecoveryPolicy":
        p = cls(rot_adaptive=getattr(cfg, "rot_adaptive", True),
                rot_every_n=getattr(cfg, "rot_every_n", 12),
                rot_after_hit_frames=getattr(cfg, "rot_after_hit_frames", 8),
                prescan_rot_probe_period=getattr(
                    cfg, "prescan_rot_probe_period", 3))
        # heavy zoomed re-detect after a rotated probe hit
        # (prescan_heavy_90/prescan_heavy_180 imgsz caps; >0 enables — the
        # zoom keeps the compiled canvas, so the cap itself is moot)
        p.heavy = (int(getattr(cfg, "prescan_heavy_90", 0)) > 0
                   or int(getattr(cfg, "prescan_heavy_180", 0)) > 0)
        return p

    def note_hit(self, rotation_k: Optional[int]) -> None:
        self.streak = 0
        if rotation_k is not None and self.rot_after_hit_frames:
            self.sticky_rot = rotation_k
            self.sticky_left = self.rot_after_hit_frames
        elif self.sticky_left > 0:
            self._decay_sticky()

    def _decay_sticky(self) -> None:
        """Sticky rotation is a FRAME budget: it decays on every frame it
        is probed (hit or empty) and re-arms only on a fresh rotated hit —
        otherwise a subject leaving the scene would leave the extra probe
        variant active for the rest of the no-face stretch."""
        self.sticky_left -= 1
        if self.sticky_left <= 0:
            self.sticky_left = 0
            self.sticky_rot = None

    def variants_for_empty(self) -> List[Tuple[str, float | int]]:
        """Called once per empty frame in sample order; returns the variant
        specs (kind, param) to probe."""
        self.streak += 1
        self.empty_count += 1
        out: List[Tuple[str, float | int]] = []
        if self.prescan_fast:
            # sticky rotation from a recent rotated hit probes every empty
            # sample (1 variant); otherwise round-robin one rotation every
            # rr_period-th empty sample
            if self.sticky_rot is not None:
                out.append(("rot", self.sticky_rot))
                self._decay_sticky()
            elif self.empty_count % self.rr_period == 0:
                out.append(("rot", ROTATION_KS[self._rr % len(ROTATION_KS)]))
                self._rr += 1
            return out
        if self.use_scale_tta:
            out.extend(("scale", s) for s in TTA_SCALES)
        if self.use_edge_pad:
            out.append(("pad", EDGE_PAD_FRAC))
        if self.sticky_rot is not None:
            out.append(("rot", self.sticky_rot))
            self._decay_sticky()
        elif self.rot_adaptive:
            if self.streak >= self.rot_every_n:
                out.extend(("rot", k) for k in ROTATION_KS)
                if self.affine_probes:
                    out.extend(("affine", d) for d in AFFINE_DEGS)
                self.streak = 0
        elif self.empty_count % self.rot_every_n == 0:
            out.extend(("rot", k) for k in ROTATION_KS)
            if self.affine_probes:
                out.extend(("affine", d) for d in AFFINE_DEGS)
        return out


def _make_variant(frame: np.ndarray, kind: str, param):
    if kind == "rot":
        return make_rotation_variant(frame, int(param))
    if kind == "scale":
        return make_scale_variant(frame, float(param))
    if kind == "affine":
        return make_affine_variant(frame, float(param))
    return make_edgepad_variant(frame, float(param))


class RecoveringFaceBackend:
    """Wrap a FaceBatchBackend with the batched recovery ladder.

    Same extract_batch/submit_batch protocol, and the inner backend's
    combined face+person step where it has one; recovery resolves inside
    the batch's fetcher so drivers (prescan/mainpass ordered replay) need
    no changes. At most ``max_extra_batches`` additional device calls per
    original batch.
    """

    def __init__(self, inner, policy: Optional[RecoveryPolicy] = None,
                 max_extra_batches: int = 2, nms_iou: float = 0.4):
        self.inner = inner
        self.policy = policy or RecoveryPolicy()
        self.max_extra_batches = int(max_extra_batches)
        self.nms_iou = float(nms_iou)
        self.recovered_faces = 0    # observability: hits found by the ladder
        # bound only over an inner with a combined step (the sharded has none)
        if hasattr(inner, "submit_wire_with_person"):
            self.submit_wire_with_person = self._submit_wire_with_person

    # facade passthroughs
    @property
    def det_size(self):
        return getattr(self.inner, "det_size", 640)

    @property
    def max_faces(self):
        return self.inner.max_faces

    @property
    def embed_dim(self):
        return self.inner.embed_dim

    @property
    def score_thresh(self):
        return getattr(self.inner, "score_thresh", 0.5)

    @score_thresh.setter
    def score_thresh(self, v):
        self.inner.score_thresh = v

    @property
    def timer(self):
        return self.inner.timer

    @timer.setter
    def timer(self, t):
        self.inner.timer = t

    def set_prescan_fast(self, fast: bool) -> None:
        self.policy.set_prescan_fast(fast)

    def submit_batch(self, frames, valid, frame_idxs=None):
        frames = np.asarray(frames)
        valid = np.asarray(valid).copy()
        fetch0 = self.inner.submit_batch(frames, valid, frame_idxs)
        # no defensive copy: both pipeline drivers np.stack a FRESH batch
        # per submit and never mutate it afterwards (a copy here cost a
        # full-batch memcpy — ~150 MB at batch 128 × 832 px — per submit
        # on the 1-core host hot path)
        kept = frames

        def fetch():
            out = fetch0()
            return self._recover(kept, valid, out)

        return fetch

    def _submit_wire_with_person(self, person, frames, valid,
                                 frame_idxs=None):
        """Combined single-dispatch wire program (host frames in): the
        recovery ladder applies to the FACE half only (person boxes pass
        through). Host frames are kept for the recovery re-probe."""
        frames = np.asarray(frames)
        valid = np.asarray(valid).copy()
        fetch0 = self.inner.submit_wire_with_person(person, frames, valid,
                                                    frame_idxs)

        def fetch():
            out, person_out = fetch0()
            out = self._recover(frames, valid, out)
            return out, person_out

        return fetch

    def extract_batch(self, frames, valid, frame_idxs=None):
        return self.submit_batch(frames, valid, frame_idxs)()

    # ------------------------------------------------------------------

    def _recover(self, frames: np.ndarray, valid: np.ndarray,
                 out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if frames.ndim != 4 or frames.shape[-1] != 3:
            # backend consumed a non-BGR wire format upstream; recovery
            # operates on the decoded frames the drivers hand us, so this
            # path only triggers for custom callers — skip gracefully
            return out
        b = frames.shape[0]
        empty = [i for i in range(b)
                 if valid[i] and not out["mask"][i].any()]
        tasks: List[Tuple[int, str, float | int]] = []
        for i in range(b):
            if not valid[i]:
                continue
            if i in empty:
                for kind, param in self.policy.variants_for_empty():
                    tasks.append((i, kind, param))
            else:
                self.policy.note_hit(None)
        if not tasks:
            return out
        tasks = tasks[: b * self.max_extra_batches]

        cand: Dict[int, List[dict]] = {}
        for start in range(0, len(tasks), b):
            chunk = tasks[start:start + b]
            imgs, remaps = [], []
            for (slot, kind, param) in chunk:
                img, m = _make_variant(frames[slot], kind, param)
                imgs.append(img)
                remaps.append(m)
            from .backends import pad_batch

            vframes, _, vvalid, _ = pad_batch(imgs, b)
            vout = self.inner.extract_batch(vframes, vvalid)
            for vi, (slot, kind, param) in enumerate(chunk):
                m = remaps[vi]
                for j in np.flatnonzero(vout["mask"][vi]):
                    cand.setdefault(slot, []).append({
                        "box": apply_remap_boxes(m, vout["boxes"][vi, j]),
                        "kps": apply_remap_points(m, vout["kps"][vi, j]),
                        "score": float(vout["scores"][vi, j]),
                        "feat": vout["feats"][vi, j],
                        "quality": float(vout["quality"][vi, j]),
                        "rot": int(param) if kind == "rot" else None,
                    })

        # heavy phase: zoomed upright re-detect of small rotated hits
        # (reference probe→heavy escalation, face_embedder.py:2363-2433)
        if self.policy.heavy and cand:
            self._heavy_refine(frames, cand)

        for slot, cands in cand.items():
            boxes = np.stack([c["box"] for c in cands])
            scores = np.asarray([c["score"] for c in cands])
            keep = nms_host(boxes, scores, self.nms_iou)[: self.max_faces]
            for oi, ci in enumerate(keep):
                c = cands[ci]
                out["boxes"][slot, oi] = c["box"]
                out["kps"][slot, oi] = c["kps"]
                out["scores"][slot, oi] = c["score"]
                out["feats"][slot, oi] = c["feat"]
                out["quality"][slot, oi] = c["quality"]
                out["mask"][slot, oi] = True
            if keep:
                self.recovered_faces += len(keep)
                self.policy.note_hit(cands[keep[0]]["rot"])
        return out

    def _heavy_refine(self, frames: np.ndarray,
                      cand: Dict[int, List[dict]]) -> None:
        """One extra fixed-shape batch re-detecting small rotated hits on a
        zoomed upright crop; better detections replace the probe's."""
        b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        small = 0.35 * min(h, w)
        tasks = []
        for slot, cands in cand.items():
            best = max(cands, key=lambda c: c["score"])
            if best["rot"] is None:
                continue
            bw = best["box"][2] - best["box"][0]
            bh = best["box"][3] - best["box"][1]
            if max(bw, bh) >= small:
                continue
            made = make_zoom_rot_variant(frames[slot], best["box"],
                                         int(best["rot"]))
            if made is not None:
                tasks.append((slot, made))
        if not tasks:
            return
        tasks = tasks[:b]
        from .backends import pad_batch

        vframes, _, vvalid, _ = pad_batch(
            [img for (_, (img, _m)) in tasks], b)
        vout = self.inner.extract_batch(vframes, vvalid)
        for vi, (slot, (_img, m)) in enumerate(tasks):
            js = np.flatnonzero(vout["mask"][vi])
            if not js.size:
                continue
            j = js[np.argmax(vout["scores"][vi][js])]
            best = max(cand[slot], key=lambda c: c["score"])
            if float(vout["scores"][vi, j]) >= best["score"] - 0.05:
                cand[slot] = [{
                    "box": apply_remap_boxes(m, vout["boxes"][vi, j]),
                    "kps": apply_remap_points(m, vout["kps"][vi, j]),
                    "score": float(vout["scores"][vi, j]),
                    "feat": vout["feats"][vi, j],
                    "quality": float(vout["quality"][vi, j]),
                    "rot": best["rot"],
                }]
