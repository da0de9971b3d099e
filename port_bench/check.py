"""The comparison that decides ``correct``.

The port's outputs are judged against the plain float32 reference
(``reference/``) and the clip's ground truth:

* layer by layer, on main-pass batches drawn from the seed among those the
  window recorded: each face the port's combined step returned (box, five
  points, score, embedding and its distance to the port's bank) against
  the face the reference finds on the same source frames (its own decode,
  analysis resize, I420 wire, bank of the same photo), and each YOLOv8n
  person likewise;
* decision by decision, on every video of the window: each ``index.csv``
  row's frame holds the target and its crop box holds the target's face,
  every span of the target has a row, every crop and the curated set were
  written.

Each number has a limit in the configuration file (``check.limits``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

MARGIN = 0.1   # a detection this far above its threshold must be found


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = lambda t: (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter,
                              1e-9)


def match(boxes_a, boxes_b, thresh: float = 0.5):
    """Greedy one-to-one pairs ``(i, j)`` by IoU ≥ ``thresh``."""
    if not len(boxes_a) or not len(boxes_b):
        return []
    m = iou(boxes_a, boxes_b)
    pairs = []
    while True:
        i, j = np.unravel_index(np.argmax(m), m.shape)
        if m[i, j] < thresh:
            return pairs
        pairs.append((int(i), int(j)))
        m[i, :] = -1.0
        m[:, j] = -1.0


def _fd(feat: np.ndarray, bank: Optional[np.ndarray]) -> float:
    if bank is None:
        return 9.0
    v = feat / max(float(np.linalg.norm(feat)), 1e-6)
    return 1.0 - float(np.max(bank @ v))


GAPS = ("face_score", "face_box_px", "embed", "fd", "person_score",
        "person_box_px")


def compare_layers(got_faces: Dict, got_persons: Dict, got_bank,
                   ref_faces: Dict, ref_persons: Dict, ref_bank,
                   face_thresh: float, person_thresh: float) -> Dict:
    """The layer numbers of one side (the port's outputs, or the control's)
    against the reference's, over frames ``[N]`` of both: for each matched
    face its score gap, its box and five points' largest gap in pixels,
    its embedding's ``1 - cos`` to the reference's and its distance to the
    bank's gap; for each matched person its score and box gaps. Each as
    ``<name>_gap`` (the widest) and ``<name>_gap_med`` (the median), and
    the clear detections one side lacks (``face_missed``,
    ``person_missed``)."""
    gaps = {k: [] for k in GAPS}
    out = {"face_missed": 0, "person_missed": 0, "faces": 0, "persons": 0}
    for n in range(len(ref_faces["mask"])):
        gm, rm = got_faces["mask"][n], ref_faces["mask"][n]
        gb, rb = got_faces["boxes"][n][gm], ref_faces["boxes"][n][rm]
        gs, rs = got_faces["scores"][n][gm], ref_faces["scores"][n][rm]
        gk, rk = got_faces["kps"][n][gm], ref_faces["kps"][n][rm]
        gf, rf = got_faces["feats"][n][gm], ref_faces["feats"][n][rm]
        pairs = match(gb, rb)
        out["faces"] += len(rb)
        for i, j in pairs:
            gaps["face_score"].append(abs(float(gs[i] - rs[j])))
            gaps["face_box_px"].append(max(float(np.abs(gb[i] - rb[j]).max()),
                                           float(np.abs(gk[i] - rk[j]).max())))
            a = gf[i] / max(float(np.linalg.norm(gf[i])), 1e-6)
            b = rf[j] / max(float(np.linalg.norm(rf[j])), 1e-6)
            gaps["embed"].append(1.0 - float(a @ b))
            gaps["fd"].append(abs(_fd(gf[i], got_bank) - _fd(rf[j], ref_bank)))
        out["face_missed"] += _unmatched(gs, rs, pairs, face_thresh)
        gm, rm = got_persons["mask"][n], ref_persons["mask"][n]
        gb, rb = got_persons["boxes"][n][gm], ref_persons["boxes"][n][rm]
        gs, rs = got_persons["scores"][n][gm], ref_persons["scores"][n][rm]
        pairs = match(gb, rb)
        out["persons"] += len(rb)
        for i, j in pairs:
            gaps["person_score"].append(abs(float(gs[i] - rs[j])))
            gaps["person_box_px"].append(float(np.abs(gb[i] - rb[j]).max()))
        out["person_missed"] += _unmatched(gs, rs, pairs, person_thresh)
    for k, v in gaps.items():
        out[f"{k}_gap"] = max(v) if v else 0.0
        out[f"{k}_gap_med"] = float(np.median(v)) if v else 0.0
    return out


def _unmatched(got_scores, ref_scores, pairs, thresh: float) -> int:
    """Clear detections (``MARGIN`` above the threshold) of either side
    that the other side lacks."""
    gi = {i for i, _ in pairs}
    rj = {j for _, j in pairs}
    return (sum(1 for i, s in enumerate(got_scores)
                if i not in gi and s >= thresh + MARGIN)
            + sum(1 for j, s in enumerate(ref_scores)
                  if j not in rj and s >= thresh + MARGIN))


def hit_numbers(videos: List[Dict], clip, ref_faces_at: Dict[int, Dict],
                scale) -> Dict:
    """Decisions of every video of the window: ``videos`` hold each one's
    ``rows`` (``index.csv``), ``ok`` and ``outputs_missing``.
    ``ref_faces_at[frame]``: the reference's faces on that frame (analysis
    coordinates; ``scale`` maps them to the source's)."""
    spans = clip.spans(0)
    out = {"videos_failed": 0, "outputs_missing": 0, "hits_off_target": 0,
           "spans_missed": 0, "hits": 0}
    for v in videos:
        if not v["ok"]:
            out["videos_failed"] += 1
            continue
        out["outputs_missing"] += v["outputs_missing"]
        frames = []
        for r in v["rows"]:
            f = int(r["frame"])
            frames.append(f)
            out["hits"] += 1
            truth = clip.box(f, 0)
            crop = np.array([float(r[k]) for k in ("x1", "y1", "x2", "y2")])
            if truth is None or _inside(np.asarray(truth), crop) < 0.9:
                out["hits_off_target"] += 1
                continue
            ref = ref_faces_at.get(f)
            boxes = (ref["boxes"][ref["mask"]] * np.r_[scale, scale]
                     if ref is not None else np.zeros((0, 4)))
            if not match(np.asarray(truth, float)[None], boxes):
                out["hits_off_target"] += 1
        out["spans_missed"] += sum(
            1 for s, e in spans if not any(s <= f <= e for f in frames))
    return out


def _inside(box: np.ndarray, crop: np.ndarray) -> float:
    """Share of ``box``'s area inside ``crop``."""
    w = max(0.0, min(box[2], crop[2]) - max(box[0], crop[0]))
    h = max(0.0, min(box[3], crop[3]) - max(box[1], crop[1]))
    area = max((box[2] - box[0]) * (box[3] - box[1]), 1e-9)
    return w * h / area


