"""Randomized synthetic face scenes (host-side numpy/cv2).

Renders the same face schema as video/synthetic.py:draw_face — a filled
ellipse with five darker landmark dots at the canonical 5-pt layout — but
with fully randomized colors/sizes/positions, plus hard negatives
(dot-free ellipses, ellipse-free dot clusters, rectangles, lines) so a
detector trained on these scenes must key on the full face pattern.

Scenes are upright by design: rotated faces are *not* in the training
distribution, which keeps the rotation-recovery ladder
(pipeline/recovery.py; reference face_embedder.py:2363-2433) a genuinely
testable behavior — a 90°-rotated face is invisible to the 0° pass and is
only found after coordinate remap.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

MAX_GT = 4

# canonical 5-pt layout inside the face box (video/synthetic.py:29-39)
_KP_LAYOUT = np.array([
    [0.30, 0.35], [0.70, 0.35], [0.50, 0.55], [0.35, 0.75], [0.65, 0.75],
], np.float32)


def kps_from_box(box: np.ndarray) -> np.ndarray:
    x1, y1, x2, y2 = box
    wh = np.array([x2 - x1, y2 - y1], np.float32)
    return np.array([x1, y1], np.float32) + _KP_LAYOUT * wh


def _rand_face_color(rng) -> Tuple[int, int, int]:
    while True:
        c = rng.integers(40, 256, 3)
        if int(c.sum()) >= 220:
            return tuple(int(v) for v in c)


def _draw_face(img, box, color, rng) -> None:
    x1, y1, x2, y2 = (int(round(v)) for v in box)
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    ax, ay = max(2, (x2 - x1) // 2), max(2, (y2 - y1) // 2)
    cv2.ellipse(img, (cx, cy), (ax, ay), 0, 0, 360, color, -1)
    dot = tuple(int(v) for v in rng.integers(0, 45, 3))
    r = max(1, ax // 8)
    for px, py in kps_from_box(np.asarray(box, np.float32)):
        cv2.circle(img, (int(px), int(py)), r, dot, -1)


def _draw_distractors(img, rng, n: int) -> None:
    h, w = img.shape[:2]
    for _ in range(n):
        kind = rng.integers(0, 4)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
        s = int(rng.integers(6, max(8, min(h, w) // 3)))
        if kind == 0:  # dot-free ellipse (face body without landmarks)
            cv2.ellipse(img, (cx, cy), (s, int(s * rng.uniform(0.7, 1.4))),
                        0, 0, 360, color, -1)
        elif kind == 1:  # rectangle
            cv2.rectangle(img, (cx - s, cy - s), (cx + s, cy + s), color, -1)
        elif kind == 2:  # ellipse-free dot cluster
            dot = tuple(int(v) for v in rng.integers(0, 45, 3))
            for dx, dy in _KP_LAYOUT * (2 * s) - s:
                cv2.circle(img, (cx + int(dx), cy + int(dy)),
                           max(1, s // 8), dot, -1)
        else:  # line
            x2, y2 = int(rng.integers(0, w)), int(rng.integers(0, h))
            cv2.line(img, (cx, cy), (x2, y2), color, max(1, s // 6))


def _boxes_overlap(b, others, thresh: float = 0.25) -> bool:
    for o in others:
        ix = max(0.0, min(b[2], o[2]) - max(b[0], o[0]))
        iy = max(0.0, min(b[3], o[3]) - max(b[1], o[1]))
        inter = ix * iy
        a = (b[2] - b[0]) * (b[3] - b[1])
        if inter > thresh * a:
            return True
    return False


def sample_scene(rng, size: int = 256, min_face: int = 14,
                 max_face: int = 200) -> Dict[str, np.ndarray]:
    """One training scene: image [S,S,3] u8 BGR + padded GT arrays."""
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 required for scene generation")
    base = int(rng.integers(20, 120))
    img = np.full((size, size, 3), base, np.uint8)
    img += rng.integers(0, 18, (size, size, 3), dtype=np.uint8)
    if rng.random() < 0.5:  # horizontal or vertical luminance gradient
        g = np.linspace(0, rng.integers(10, 70), size, dtype=np.float32)
        axis = 1 if rng.random() < 0.5 else 0
        grad = g[None, :, None] if axis else g[:, None, None]
        img = np.clip(img.astype(np.float32) + grad, 0, 255).astype(np.uint8)
    _draw_distractors(img, rng, int(rng.integers(0, 6)))

    n_faces = int(rng.choice([0, 1, 1, 2, 2, 3], p=[0.12, 0.3, 0.3, 0.12,
                                                    0.1, 0.06]))
    boxes = np.zeros((MAX_GT, 4), np.float32)
    kps = np.zeros((MAX_GT, 5, 2), np.float32)
    mask = np.zeros((MAX_GT,), bool)
    placed = []
    for j in range(n_faces):
        for _ in range(12):  # rejection-sample a non-overlapping placement
            fw = float(np.exp(rng.uniform(np.log(min_face),
                                          np.log(min(max_face, size * 0.8)))))
            fh = fw * rng.uniform(0.8, 1.25)
            cx = rng.uniform(fw * 0.3, size - fw * 0.3)
            cy = rng.uniform(fh * 0.3, size - fh * 0.3)
            box = np.array([cx - fw / 2, cy - fh / 2,
                            cx + fw / 2, cy + fh / 2], np.float32)
            if not _boxes_overlap(box, placed):
                break
        else:
            continue
        placed.append(box)
        _draw_face(img, box, _rand_face_color(rng), rng)
        clipped = np.clip(box, 0, size - 1)
        boxes[j] = clipped
        kps[j] = kps_from_box(box)
        mask[j] = True

    if rng.random() < 0.25:
        k = int(rng.choice([3, 5]))
        img = cv2.GaussianBlur(img, (k, k), 0)
    return {"image": img, "boxes": boxes, "kps": kps, "gt_mask": mask}


def sample_batch(rng, batch: int, size: int = 256, **kw):
    scenes = [sample_scene(rng, size, **kw) for _ in range(batch)]
    return {
        "images": np.stack([s["image"] for s in scenes]),
        "boxes": np.stack([s["boxes"] for s in scenes]),
        "kps": np.stack([s["kps"] for s in scenes]),
        "gt_mask": np.stack([s["gt_mask"] for s in scenes]),
    }


def _draw_person(img, face_box, rng) -> np.ndarray:
    """Schematic person for detector training: torso + legs + face head
    (video/synthetic.py:draw_person layout). Returns the person gt box."""
    from ..video.synthetic import FacePlacement, draw_person

    h, w = img.shape[:2]
    clothing = tuple(int(v) for v in rng.integers(40, 220, 3))
    draw_person(img, FacePlacement(0, int(rng.integers(0, 4)),
                                   tuple(face_box)), clothing=clothing)
    from ..video.synthetic import person_box_for_face

    return np.asarray(person_box_for_face(face_box, w, h), np.float32)


def sample_person_scene(rng, size: int = 256, min_face: int = 10,
                        max_face: int = 48) -> Dict[str, np.ndarray]:
    """Scene with 0-3 schematic persons; gt boxes are PERSON extents."""
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 required for scene generation")
    base = int(rng.integers(20, 120))
    img = np.full((size, size, 3), base, np.uint8)
    img += rng.integers(0, 18, (size, size, 3), dtype=np.uint8)
    _draw_distractors(img, rng, int(rng.integers(0, 5)))
    n = int(rng.choice([0, 1, 1, 2, 2, 3], p=[0.12, 0.3, 0.3, 0.12,
                                              0.1, 0.06]))
    boxes = np.zeros((MAX_GT, 4), np.float32)
    mask = np.zeros((MAX_GT,), bool)
    placed = []
    # the body extends ~4.2 face-heights below the head plus placement
    # margin: cap the face size so a whole person fits the canvas
    max_face = min(max_face, size / 5.6)
    min_face = min(min_face, max_face * 0.8)
    for j in range(n):
        for _ in range(12):
            fw = float(np.exp(rng.uniform(np.log(min_face),
                                          np.log(max_face))))
            fh = fw * rng.uniform(0.9, 1.15)
            # head near the top so the body fits below
            cx = rng.uniform(fw * 1.6, size - fw * 1.6)
            cy = rng.uniform(fh * 0.8, size - fh * 4.0)
            fbox = np.array([cx - fw / 2, cy - fh / 2,
                             cx + fw / 2, cy + fh / 2], np.float32)
            pbox = np.asarray(
                [max(0, fbox[0] - fw), max(0, fbox[1] - 0.2 * fh),
                 min(size, fbox[2] + fw), min(size, fbox[3] + 4.2 * fh)],
                np.float32)
            if not _boxes_overlap(pbox, placed):
                break
        else:
            continue
        placed.append(pbox)
        boxes[j] = _draw_person(img, fbox, rng)
        mask[j] = True
    if rng.random() < 0.25:
        k = int(rng.choice([3, 5]))
        img = cv2.GaussianBlur(img, (k, k), 0)
    return {"image": img, "boxes": boxes, "gt_mask": mask}


def sample_person_batch(rng, batch: int, size: int = 256, **kw):
    scenes = [sample_person_scene(rng, size, **kw) for _ in range(batch)]
    return {
        "images": np.stack([s["image"] for s in scenes]),
        "boxes": np.stack([s["boxes"] for s in scenes]),
        "gt_mask": np.stack([s["gt_mask"] for s in scenes]),
    }
