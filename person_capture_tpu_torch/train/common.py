"""Shared trainer helpers.

The three detector trainers (scrfd_synth, yolo_synth, yolo_face_synth)
evaluate with the same greedy IoU matching of detections against synthetic
ground truth; it lives here once so a matcher fix applies everywhere.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _iou_xyxy(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / max(ua, 1e-9)


def match_detections(boxes: np.ndarray, mask: np.ndarray,
                     gt_boxes: np.ndarray, gt_mask: np.ndarray,
                     iou_thresh: float = 0.5,
                     kps: Optional[np.ndarray] = None,
                     gt_kps: Optional[np.ndarray] = None,
                     ) -> Tuple[int, int, int, List[float]]:
    """Greedy one-to-one IoU matching over a whole batch.

    ``boxes [B, N, 4]`` + ``mask [B, N]`` detections vs ``gt_boxes
    [B, M, 4]`` + ``gt_mask [B, M]`` truth. Returns ``(tp, fp, fn,
    kps_errs)``; when ``kps``/``gt_kps`` are given, each matched detection
    contributes a keypoint error normalized by the truth box width.
    """
    tp = fp = fn = 0
    errs: List[float] = []
    for i in range(boxes.shape[0]):
        gts = gt_boxes[i][gt_mask[i]]
        gk = gt_kps[i][gt_mask[i]] if gt_kps is not None else None
        used = np.zeros(len(gts), bool)
        for j in np.flatnonzero(mask[i]):
            best, best_iou = -1, 0.0
            for gi, gt in enumerate(gts):
                if used[gi]:
                    continue
                iou = _iou_xyxy(boxes[i, j], gt)
                if iou > best_iou:
                    best, best_iou = gi, iou
            if best >= 0 and best_iou >= iou_thresh:
                used[best] = True
                tp += 1
                if gk is not None and kps is not None:
                    scale = max(gts[best][2] - gts[best][0], 1.0)
                    errs.append(float(np.linalg.norm(
                        kps[i, j] - gk[best], axis=-1).mean() / scale))
            else:
                fp += 1
        fn += int((~used).sum())
    return tp, fp, fn, errs
