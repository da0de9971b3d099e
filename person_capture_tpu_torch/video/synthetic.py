"""Synthetic video + ground-truth generation for tests and benchmarks.

The reference ships no test assets; we generate deterministic videos with
known "face" placements (per-identity colored patterns with 5 landmark dots)
plus a ground-truth table, so pipeline logic (spans, bank growth, locks,
compose, export) is testable end-to-end without trained weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclass
class FacePlacement:
    frame: int
    identity: int
    box: Tuple[float, float, float, float]  # xyxy in frame coords

    @property
    def kps(self) -> np.ndarray:
        """Synthetic 5-point landmarks laid out like a face inside the box."""
        x1, y1, x2, y2 = self.box
        w, h = x2 - x1, y2 - y1
        return np.array([
            [x1 + 0.30 * w, y1 + 0.35 * h],
            [x1 + 0.70 * w, y1 + 0.35 * h],
            [x1 + 0.50 * w, y1 + 0.55 * h],
            [x1 + 0.35 * w, y1 + 0.75 * h],
            [x1 + 0.65 * w, y1 + 0.75 * h],
        ], np.float32)


@dataclass
class SyntheticVideo:
    path: str
    width: int
    height: int
    fps: float
    total_frames: int
    # frame -> list of placements
    truth: Dict[int, List[FacePlacement]] = field(default_factory=dict)

    def identity_spans(self, identity: int) -> List[Tuple[int, int]]:
        """Ground-truth contiguous frame spans where the identity appears."""
        frames = sorted(f for f, pls in self.truth.items()
                        if any(p.identity == identity for p in pls))
        spans: List[Tuple[int, int]] = []
        for f in frames:
            if spans and f == spans[-1][1] + 1:
                spans[-1] = (spans[-1][0], f)
            else:
                spans.append((f, f))
        return spans


_ID_COLORS = [(60, 180, 240), (200, 90, 60), (80, 220, 90), (180, 60, 200)]


def draw_face(img: np.ndarray, pl: FacePlacement) -> None:
    """Render a synthetic face: filled ellipse in an identity color with
    darker landmark dots (enough texture for quality metrics)."""
    x1, y1, x2, y2 = (int(round(v)) for v in pl.box)
    color = _ID_COLORS[pl.identity % len(_ID_COLORS)]
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    ax, ay = max(2, (x2 - x1) // 2), max(2, (y2 - y1) // 2)
    if cv2 is not None:
        cv2.ellipse(img, (cx, cy), (ax, ay), 0, 0, 360, color, -1)
        for px, py in pl.kps:
            cv2.circle(img, (int(px), int(py)), max(1, ax // 8), (20, 20, 20), -1)
    else:  # numpy fallback
        img[max(0, y1):y2, max(0, x1):x2] = color


def person_box_for_face(box, width: int, height: int):
    """Deterministic body extent below a face box (matches the rendering
    of draw_person and OraclePersonBackend's inflation)."""
    x1, y1, x2, y2 = box
    fw, fh = x2 - x1, y2 - y1
    return (max(0.0, x1 - fw), max(0.0, y1 - 0.2 * fh),
            min(float(width), x2 + fw), min(float(height), y2 + 4.2 * fh))


def draw_person(img: np.ndarray, pl: FacePlacement,
                clothing=None) -> None:
    """Render a schematic person: torso + legs below the face, then the
    face on top (so the face pattern stays detector-visible)."""
    if cv2 is None:
        draw_face(img, pl)
        return
    x1, y1, x2, y2 = pl.box
    fw, fh = x2 - x1, y2 - y1
    h, w = img.shape[:2]
    clothing = clothing or tuple(
        int(v) for v in np.random.default_rng(pl.identity + 7)
        .integers(40, 220, 3))
    dark = tuple(max(0, c - 60) for c in clothing)
    # torso
    tx1, ty1 = int(x1 - 0.35 * fw), int(y2)
    tx2, ty2 = int(x2 + 0.35 * fw), int(min(h, y2 + 2.4 * fh))
    cv2.rectangle(img, (tx1, ty1), (tx2, ty2), clothing, -1)
    # legs
    ly2 = int(min(h, y2 + 4.2 * fh))
    mid = (tx1 + tx2) // 2
    cv2.rectangle(img, (tx1 + 2, ty2), (mid - 2, ly2), dark, -1)
    cv2.rectangle(img, (mid + 2, ty2), (tx2 - 2, ly2), dark, -1)
    draw_face(img, pl)


def generate_video(path: str, width: int = 320, height: int = 240,
                   fps: float = 30.0, total_frames: int = 120,
                   segments: Optional[Sequence[Tuple[int, int, int]]] = None,
                   moving: bool = True, seed: int = 0,
                   draw_body: bool = False,
                   fourcc: str = "mp4v", face_px: int = 0) -> SyntheticVideo:
    """Write an mp4 with faces present in the given ``(start, end, identity)``
    frame segments (inclusive), plus background noise.

    A segment may carry two optional trailing fields:
    ``(start, end, identity, x_frac, body)`` — a fixed horizontal center
    (overrides ``moving``) and a per-segment body-rendering flag — so tests
    can stage two concurrent non-overlapping persons.

    ``face_px``: face width in pixels (default a quarter of the shorter
    side). The bundled YOLOv8n person weights were trained on faces of
    10–48 px on a 256 canvas and find a drawn person at det 640 only with a
    face of at most about 48 px there (a tenth of a 640×480 frame).
    """
    if cv2 is None:
        raise RuntimeError("cv2 required to generate synthetic videos")
    if segments is None:
        segments = [(20, 60, 0), (90, 110, 0)]
    rng = np.random.default_rng(seed)
    sv = SyntheticVideo(path, width, height, fps, total_frames)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc),
                             fps, (width, height))
    if not writer.isOpened():
        raise IOError(f"cannot open writer: {path}")
    base = rng.integers(30, 70, (height, width, 3), dtype=np.uint8)
    fw = int(face_px) or min(width, height) // 4
    for f in range(total_frames):
        img = base.copy()
        # light noise so frames differ
        noise = rng.integers(0, 12, (height, width, 1), dtype=np.uint8)
        img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
        for seg in segments:
            s, e, ident = seg[0], seg[1], seg[2]
            x_frac = seg[3] if len(seg) > 3 else None
            body = bool(seg[4]) if len(seg) > 4 else draw_body
            if s <= f <= e:
                if x_frac is not None:
                    cx, cy = width * float(x_frac), height * 0.5
                elif moving:
                    t = (f - s) / max(1, e - s)
                    cx = width * (0.3 + 0.4 * t)
                    cy = height * 0.5
                else:
                    cx, cy = width * 0.5, height * 0.5
                box = (cx - fw / 2, cy - fw / 2, cx + fw / 2, cy + fw / 2)
                pl = FacePlacement(f, ident, box)
                if body:
                    draw_person(img, pl)
                else:
                    draw_face(img, pl)
                sv.truth.setdefault(f, []).append(pl)
        writer.write(img)
    writer.release()
    return sv


# ---------------------------------------------------------------------------
# HDR fixtures: the same scenes coded as PQ, and their P010 planes
# ---------------------------------------------------------------------------

def pq_code_bgr(bgr: np.ndarray, peak_nits: float = 4000.0) -> np.ndarray:
    """SDR BGR uint8 → PQ-coded BGR uint8: sRGB-decoded linear light with
    white at ``peak_nits``, re-encoded with the ST 2084 inverse EOTF (what an
    HDR source's 8-bit decode holds)."""
    e = bgr.astype(np.float64) / 255.0
    lin = np.where(e <= 0.04045, e / 12.92, ((e + 0.055) / 1.055) ** 2.4)
    y = np.clip(lin * peak_nits / 10000.0, 0.0, 1.0)
    m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
    c1, c2, c3 = 3424.0 / 4096.0, 2413.0 / 4096.0 * 32.0, 2392.0 / 4096.0 * 32.0
    p = y ** m1
    code = ((c1 + c2 * p) / (1.0 + c3 * p)) ** m2
    return np.clip(np.round(code * 255.0), 0, 255).astype(np.uint8)


def write_pq_video(src_path: str, dst_path: str,
                   peak_nits: float = 4000.0) -> None:
    """Re-encode an SDR fixture video frame by frame as PQ-coded content
    (same size, rate and frame count)."""
    cap = cv2.VideoCapture(src_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(dst_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open writer: {dst_path}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            writer.write(pq_code_bgr(frame, peak_nits))
    finally:
        cap.release()
        writer.release()


def p010_from_pq_bgr(bgr_codes: np.ndarray, width: int = 0, height: int = 0):
    """PQ-coded BGR uint8 (optionally resized to ``width``×``height``) →
    P010 planes ``(y [H, W], uv [H/2, W/2, 2])`` uint16: BT.2020
    non-constant-luminance YCbCr, limited range, 10-bit codes in the high
    bits, 2×2-averaged chroma."""
    if width and height and (width, height) != (bgr_codes.shape[1],
                                                bgr_codes.shape[0]):
        bgr_codes = cv2.resize(bgr_codes, (width, height),
                               interpolation=cv2.INTER_LINEAR)
    rgb = bgr_codes[..., ::-1].astype(np.float32) / 255.0
    kr, kb = 0.2627, 0.0593
    y = kr * rgb[..., 0] + (1.0 - kr - kb) * rgb[..., 1] + kb * rgb[..., 2]
    cb = (rgb[..., 2] - y) / (2.0 * (1.0 - kb))
    cr = (rgb[..., 0] - y) / (2.0 * (1.0 - kr))
    h, w = y.shape
    cb = cb.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    cr = cr.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    y10 = np.clip(np.round(64.0 + 876.0 * y), 0, 1023)
    c10 = np.clip(np.round(512.0 + 896.0 * np.stack([cb, cr], -1)), 0, 1023)
    return ((y10.astype(np.uint16) << 6),
            (c10.astype(np.uint16) << 6))
