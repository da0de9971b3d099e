"""The clip generator: one clip per seed, the same set of span lengths
for every seed, and joined parts that decode and seek as one video."""

import json
import os

import numpy as np
import pytest

from port_bench import traffic

from .conftest import PKG


def _mix(name):
    with open(os.path.join(PKG, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def test_schedule_is_the_seeds():
    mix = _mix("sdr1080_dense")
    big = 2**31 + 12345
    assert traffic.schedule(mix, big) == traffic.schedule(mix, big)
    assert traffic.schedule(mix, big) != traffic.schedule(mix, big + 1)


def test_every_seed_gets_the_same_work():
    for name in ("sdr1080_dense", "sdr1080_sparse"):
        mix = _mix(name)
        seen = set()
        for seed in (1, 2**31 + 1, 2**40 + 7):
            segs, _ = traffic.schedule(mix, seed)
            lengths = tuple(sorted((i, e - s + 1) for s, e, i, _ in segs))
            seen.add(lengths)
            assert all(0 <= s <= e < mix["frames"] for s, e, _, _ in segs)
        assert len(seen) == 1, name


def test_clip_is_deterministic_and_whole(tmp_path):
    import cv2

    mix = dict(_mix("sdr1080_dense"), width=320, height=240, face_px=40)
    a = traffic.make_clip(str(tmp_path / "a.mp4"), mix, 2**31 + 9, 120)
    b = traffic.make_clip(str(tmp_path / "b.mp4"), mix, 2**31 + 9, 120)
    c = traffic.make_clip(str(tmp_path / "c.mp4"), mix, 2**31 + 10, 120)
    data = [open(p, "rb").read() for p in (a.path, b.path, c.path)]
    assert data[0] == data[1] and data[0] != data[2]
    assert a.truth == b.truth and a.spans(0)
    cap = cv2.VideoCapture(a.path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 120
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    assert len(frames) == 120
    cap.set(cv2.CAP_PROP_POS_FRAMES, 75)       # past the parts' seams
    ok, f = cap.read()
    assert ok and np.array_equal(f, frames[75])
    cap.release()
    assert not [p for p in os.listdir(tmp_path) if ".part" in p]


@pytest.mark.parametrize("name", ["sdr1080_dense", "sdr1080_sparse"])
def test_fixed_layout_places_everyone_alike(name):
    """A mix that fixes its layout puts every identity at the same frames
    for every seed; the seed still moves the lanes."""
    mix = _mix(name)
    assert mix["fixed_layout"] is not False
    spans, lanes = set(), set()
    for seed in (1, 2**31 + 1, 2**40 + 7, 5):
        segs, _ = traffic.schedule(mix, seed)
        spans.add(tuple(sorted((s, e, i) for s, e, i, _ in segs
                               if name.endswith("sparse") or i == 0)))
        lanes.add(tuple(sorted((i, lane) for _, _, i, lane in segs)))
    assert len(spans) == 1 and len(lanes) > 1
