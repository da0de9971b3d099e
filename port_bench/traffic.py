"""The one generator of the benchmark's clips.

A traffic mix is a JSON file of parameters (``traffic/<name>.json``); this
module turns it and a seed into an MP4 clip, its ground truth and the
reference photo. It copies the drawing of the port's
``video/synthetic.generate_video`` (an identity-coloured ellipse with five
landmark dots over a schematic body), and makes the background noise
cheaply at any size: a few noisy planes made once and cycled.

Every seed gets the same set of span lengths; the seed permutes them and
places them, unless the mix fixes the layout, and chooses the lanes the
identities walk in.

Mix keys: ``width``, ``height``, ``fps``, ``frames``, ``face_px``,
``noise_planes``, ``warmup_frames``, ``fixed_layout`` (optional: every
track's spans and the mix's ``gaps`` in the mix's order, and the places
the mix leaves open drawn from this number, ``true`` being 1, so that
every seed gets the same layout) and ``cast``, a list of tracks, each
``{"identity": i, "spans": [frames, ...], "place": how}`` where ``how`` is
``"target"`` (the spans in the seed's order; between and around them the
mix's ``gaps`` in the seed's order, or gaps the seed draws where the mix
gives none), ``"beside"`` (``"share"`` of each target span, at its start
or its end as the seed says), ``"rest"`` (the part of each target span
that the ``"beside"`` track leaves) or ``"free"`` (anywhere, never over
another free track's span).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

_ID_COLORS = [(60, 180, 240), (200, 90, 60), (80, 220, 90), (180, 60, 200)]


def face_kps(box) -> np.ndarray:
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    return np.array([[x1 + 0.30 * w, y1 + 0.35 * h],
                     [x1 + 0.70 * w, y1 + 0.35 * h],
                     [x1 + 0.50 * w, y1 + 0.55 * h],
                     [x1 + 0.35 * w, y1 + 0.75 * h],
                     [x1 + 0.65 * w, y1 + 0.75 * h]], np.float32)


def draw_face(img: np.ndarray, identity: int, box) -> None:
    import cv2

    x1, y1, x2, y2 = (int(round(v)) for v in box)
    color = _ID_COLORS[identity % len(_ID_COLORS)]
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    ax, ay = max(2, (x2 - x1) // 2), max(2, (y2 - y1) // 2)
    cv2.ellipse(img, (cx, cy), (ax, ay), 0, 0, 360, color, -1)
    for px, py in face_kps(box):
        cv2.circle(img, (int(px), int(py)), max(1, ax // 8), (20, 20, 20),
                   -1)


def draw_person(img: np.ndarray, identity: int, box) -> None:
    import cv2

    x1, y1, x2, y2 = box
    fw, fh = x2 - x1, y2 - y1
    h = img.shape[0]
    clothing = tuple(int(v) for v in np.random.default_rng(identity + 7)
                     .integers(40, 220, 3))
    dark = tuple(max(0, c - 60) for c in clothing)
    tx1, ty1 = int(x1 - 0.35 * fw), int(y2)
    tx2, ty2 = int(x2 + 0.35 * fw), int(min(h, y2 + 2.4 * fh))
    cv2.rectangle(img, (tx1, ty1), (tx2, ty2), clothing, -1)
    ly2 = int(min(h, y2 + 4.2 * fh))
    mid = (tx1 + tx2) // 2
    cv2.rectangle(img, (tx1 + 2, ty2), (mid - 2, ly2), dark, -1)
    cv2.rectangle(img, (mid + 2, ty2), (tx2 - 2, ly2), dark, -1)
    draw_face(img, identity, box)


@dataclass
class Clip:
    path: str
    width: int
    height: int
    fps: float
    frames: int
    # frame -> [(identity, face box xyxy)]
    truth: Dict[int, List[Tuple[int, Tuple[float, ...]]]] = field(
        default_factory=dict)

    def spans(self, identity: int = 0) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for f in sorted(f for f, pl in self.truth.items()
                        if any(i == identity for i, _ in pl)):
            if out and f == out[-1][1] + 1:
                out[-1] = (out[-1][0], f)
            else:
                out.append((f, f))
        return out

    def box(self, frame: int, identity: int = 0):
        for i, b in self.truth.get(frame, ()):
            if i == identity:
                return b
        return None


def _gaps(rng, total: int, parts: int, least: int) -> List[int]:
    """``parts`` gaps of at least ``least`` frames summing to ``total``."""
    spare = total - parts * least
    if spare < 0:
        raise ValueError(f"mix does not fit: {total} gap frames for "
                         f"{parts} gaps of at least {least}")
    cuts = np.sort(rng.integers(0, spare + 1, parts - 1))
    return [least + int(d) for d in np.diff(np.r_[0, cuts, spare])]


def schedule(mix: Dict, seed: int, frames: int = 0):
    """The segments ``(start, end, identity, lane)`` (inclusive) of a clip
    of ``frames`` (the mix's own unless given; span lengths scale with it).
    """
    frames = int(frames or mix["frames"])
    scale = frames / float(mix["frames"])
    rng = np.random.default_rng(int(seed) % 2**63)
    cast = mix["cast"]
    fixed = mix.get("fixed_layout", False) is not False
    # a fixed layout draws its places from the mix's own number, the same
    # for every seed; the seed still picks the lanes and the sides
    lay = np.random.default_rng(int(mix["fixed_layout"])) if fixed else rng
    lanes = list(rng.permutation(len(cast)))
    segs, target, free, beside = [], [], [], []
    for track, lane in zip(cast, lanes):
        ident, how = int(track["identity"]), track["place"]
        lens = [max(8, int(round(n * scale))) for n in track["spans"]]
        if not fixed:
            lens = [lens[i] for i in rng.permutation(len(lens))]
        if how == "target" and "gaps" in mix:
            gaps = [max(1, int(round(g * scale))) for g in mix["gaps"]]
            # rounding at another length may overshoot by a frame or two
            gaps[gaps.index(max(gaps))] -= max(
                0, sum(gaps) + sum(lens) - frames)
            if not fixed:
                gaps = [gaps[i] for i in rng.permutation(len(gaps))]
            if len(gaps) != len(lens) + 1 or min(gaps) < 0:
                raise ValueError("mix does not fit: gaps and spans")
        elif how == "target":
            least = max(2, int(round(mix.get("least_gap", 15) * scale)))
            gaps = _gaps(lay, frames - sum(lens), len(lens) + 1, least)
        if how == "target":
            at = gaps[0]
            for n, g in zip(lens, gaps[1:]):
                target.append((at, at + n - 1))
                at += n + g
            spans = list(target)
        elif how == "beside":
            share = float(track["share"])
            for s, e in target:
                n = max(1, int(round((e - s + 1) * share)))
                beside.append((s, s + n - 1) if rng.integers(0, 2)
                              else (e - n + 1, e))
            spans = list(beside)
        elif how == "rest":
            spans = [(e0 + 1, e) if s0 == s else (s, s0 - 1)
                     for (s, e), (s0, e0) in zip(target, beside)]
        elif how == "free":
            spans = []
            for n in lens:
                for _ in range(10000):
                    s = int(lay.integers(0, frames - n + 1))
                    if all(s + n - 1 < a or s > b for a, b in free):
                        break
                else:
                    raise ValueError(f"mix does not fit: no room for a "
                                     f"free span of {n} frames")
                free.append((s, s + n - 1))
                spans.append((s, s + n - 1))
        else:
            raise ValueError(f"unknown placement {how!r}")
        segs += [(s, e, ident, int(lane)) for s, e in spans]
    return segs, len(cast)


def make_clip(path: str, mix: Dict, seed: int, frames: int = 0,
              parts: int = 8) -> Clip:
    """Write the clip of ``mix`` and ``seed`` to ``path`` (MP4, mp4v) and
    return it with its ground truth. The clip is encoded in ``parts``
    runs of frames on as many threads and joined (``mp4cat``); each part
    starts on a keyframe, so the bytes depend on ``parts`` and nothing
    else."""
    import cv2

    from .mp4cat import join

    w, h, fps = int(mix["width"]), int(mix["height"]), float(mix["fps"])
    frames = int(frames or mix["frames"])
    segs, lanes = schedule(mix, seed, frames)
    rng = np.random.default_rng((int(seed) + 1) % 2**63)
    base = rng.integers(30, 70, (h, w, 3), dtype=np.uint8)
    planes = [np.clip(base.astype(np.int16)
                      + rng.integers(0, 12, (h, w, 1), dtype=np.int16),
                      0, 255).astype(np.uint8)
              for _ in range(int(mix.get("noise_planes", 8)))]
    fw = float(mix["face_px"])
    clip = Clip(path, w, h, fps, frames)
    for f in range(frames):
        for s, e, ident, lane in segs:
            if s <= f <= e:
                sway = 0.03 * math.sin(2.0 * math.pi * (f - s) / 90.0)
                cx, cy = w * ((lane + 0.5) / lanes + sway), h * 0.3
                clip.truth.setdefault(f, []).append(
                    (ident, (cx - fw / 2, cy - fw / 2, cx + fw / 2,
                             cy + fw / 2)))

    # parts start on whole seconds: each part's clock is set there
    step = int(round(fps))
    cuts = [min(frames, k * frames // parts // step * step)
            for k in range(parts)] + [frames]
    cuts = sorted(set(cuts))

    def encode(k: int) -> str:
        part = f"{path}.part{k}.mp4"
        writer = cv2.VideoWriter(part, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (w, h))
        if not writer.isOpened():
            raise IOError(f"cannot open a video writer at {part}")
        try:
            for f in range(cuts[k], cuts[k + 1]):
                img = planes[f % len(planes)].copy()
                for ident, box in clip.truth.get(f, ()):
                    draw_person(img, ident, box)
                writer.write(img)
        finally:
            writer.release()
        return part

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(cuts) - 1) as pool:
        names = list(pool.map(encode, range(len(cuts) - 1)))
    try:
        join(names, path, [c // step for c in cuts[:-1]])
    finally:
        for name in names:
            os.remove(name)
    return clip


def make_ref(path: str) -> str:
    """The reference photo: the target's face on a plain 200×200 field."""
    import cv2

    img = np.full((200, 200, 3), 60, np.uint8)
    draw_face(img, 0, (40, 40, 160, 160))
    if not cv2.imwrite(path, img):
        raise IOError(f"cannot write {path}")
    return path
