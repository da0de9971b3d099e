"""The comparison fails what it must: the control (the reference in
float8 in the port's place) and the faults a cell can have, planted in
the timed path of a whole run.

The control runs the real configurations' models on frames of the cell's
own mix at the analysis size, few of them, so that the CPU holds it; on
the card ``python -m port_bench.calibrate`` reads it at the cell's size.
"""

import json
import os

import numpy as np
import pytest

from port_bench.check import compare_layers
from port_bench.reference.pipeline import Reference
from port_bench.run import EXACT, analysis_size, load_weights, run_cell

from .conftest import PKG


def _frames(tmp_path, mix, seed, n):
    import cv2

    from port_bench import traffic

    clip = traffic.make_clip(str(tmp_path / "c.mp4"), mix, seed, 60)
    cap = cv2.VideoCapture(clip.path)
    size = analysis_size(clip.width, clip.height, 640)
    frames, f = [], 0
    while len(frames) < n:
        ok, img = cap.read()
        assert ok
        if clip.truth.get(f):
            frames.append(cv2.resize(img, size, interpolation=cv2.INTER_AREA))
        f += 1
    return np.stack(frames)


def _layers(conf, weights, frames, photo):
    ref = Reference(conf, weights, "cpu")
    low = Reference(conf, weights, "cpu", precision="fp8")
    return compare_layers(low.faces(frames), low.persons(frames),
                          low.bank(photo), ref.faces(frames),
                          ref.persons(frames), ref.bank(photo),
                          conf["detector"]["score_thresh"],
                          conf["person"]["conf"])


def _conf(name):
    with open(os.path.join(PKG, "configs", f"{name}.json")) as fh:
        return json.load(fh)


def _photo(tmp_path):
    import cv2

    from port_bench import traffic

    return cv2.imread(traffic.make_ref(str(tmp_path / "ref.png")))


@pytest.mark.parametrize("seed", [2**31 + 3, 2**31 + 4, 2**31 + 5])
def test_control_fails_arcface(tmp_path, seed):
    conf = _conf("scrfd_arcface_yolov8n")
    with open(os.path.join(PKG, "traffic", "sdr1080_dense.json")) as fh:
        mix = json.load(fh)
    frames = _frames(tmp_path, mix, seed, 6)
    got = _layers(conf, load_weights(conf, "cpu"), frames, _photo(tmp_path))
    limits = conf["check"]["limits"]
    assert any(got[k] > limits[k] for k in got if k in limits), got


@pytest.mark.cuda
def test_control_fails_clipface(tmp_path, cuda):
    conf = _conf("scrfd_clipface_vitl14")
    with open(os.path.join(PKG, "traffic", "sdr1080_dense.json")) as fh:
        mix = json.load(fh)
    frames = _frames(tmp_path, mix, 2**31 + 3, 16)
    weights = load_weights(conf, cuda)
    ref = Reference(conf, weights, cuda)
    low = Reference(conf, weights, cuda, precision="fp8")
    photo = _photo(tmp_path)
    got = compare_layers(low.faces(frames), low.persons(frames),
                         low.bank(photo), ref.faces(frames),
                         ref.persons(frames), ref.bank(photo),
                         conf["detector"]["score_thresh"],
                         conf["person"]["conf"])
    limits = conf["check"]["limits"]
    assert any(got[k] > limits[k] for k in got if k in limits), got


def _run(tiny, faults=()):
    with open(os.path.join(PKG, "configs", "scrfd_arcface_yolov8n.json")) as fh:
        limits = json.load(fh)["check"]["limits"]
    path = os.path.join(tiny.base, "configs", "tiny_arc.json")
    with open(path) as fh:
        conf = json.load(fh)
    conf["check"]["limits"] = limits
    with open(path, "w") as fh:
        json.dump(conf, fh)
    return run_cell(tiny, "tiny.arc", 2**31 + 21, 0.0, False, device="cpu",
                    faults=faults)


def test_sound_run_is_correct(tiny):
    res = _run(tiny)
    assert set(EXACT) <= set(res["checks"])
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["alter", "half"])
def test_fault_is_not_correct(tiny, fault):
    """``alter``: an answer altered where it is produced (an embedding of
    each main-pass batch); ``half``: half of each batch left out."""
    res = _run(tiny, (fault,))
    assert not res["correct"], res["checks"]


def test_traced_run_reads_the_videos_after_the_traced_one(tiny):
    """A traced run times at least one video after the traced one, and
    its host-clock readings come from those."""
    res = run_cell(tiny, "tiny.arc", 2**31 + 22, 0.0, True, device="cpu")
    assert res["attempted"] >= 2 and res["correct"], res["checks"]
    assert {"decode.ms_per_frame", "main.host_ms_per_frame",
            "curate.s_per_video"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0
