"""Shared fixtures of the benchmark's own tests (run from the repo root:
``python -m pytest port_bench/tests -q``)."""

import json
import os
import shutil

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


@pytest.fixture
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_bench(tmp_path, frames: int = 90):
    """A copy of the benchmark's files with one CPU-sized cell: the
    ArcFace configuration in float32 with 16-frame batches and no
    full-frame rescue, on a 320×240 mix of ``frames`` frames."""
    from port_bench.run import Bench

    base = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(PKG, d), base / d)
    with open(os.path.join(PKG, "configs", "scrfd_arcface_yolov8n.json")) as fh:
        conf = json.load(fh)
    conf.update(name="tiny_arc", dtype="float32",
                sets=conf["sets"] + ["tpu_batch_frames=16",
                                     "face_fullframe_when_missed=false"])
    (base / "configs" / "tiny_arc.json").write_text(json.dumps(conf))
    mix = {"width": 320, "height": 240, "fps": 30, "frames": frames,
           "face_px": 40, "noise_planes": 4, "least_gap": 10,
           "warmup_frames": 45,
           "cast": [{"identity": 0, "place": "target", "spans": [30, 24]},
                    {"identity": 1, "place": "beside", "share": 0.5,
                     "spans": []},
                    {"identity": 2, "place": "free", "spans": [15]}]}
    (base / "traffic" / "tiny.json").write_text(json.dumps(mix))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        m = json.load(fh)
    m["workloads"] = [{"name": "tiny.arc", "config": "tiny_arc",
                       "traffic": "tiny", "chips": 1, "why": "CPU test"}]
    m["per_layer"] = [p for p in m["per_layer"] if "workloads" not in p]
    return Bench(m, str(base))


@pytest.fixture
def tiny(tmp_path):
    return tiny_bench(tmp_path)
