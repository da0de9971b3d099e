"""``flops.py`` against ``torch.utils.flop_counter`` on the reference
models at small sizes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops
from port_bench.reference import arcface as AF
from port_bench.reference import clip_vit as CV
from port_bench.reference import scrfd as SD
from port_bench.reference import yolov8 as YV


def counted(model, x) -> int:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return counter.get_total_flops()


def _arch(cfg):
    import dataclasses

    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("size", [64, 96])
def test_detector(size):
    cfg = SD.TINY
    det = {"arch": _arch(cfg)}
    want = counted(SD.SCRFD(cfg).eval(), torch.randn(1, 3, size, size))
    assert flops.detector_flops(det, size) == want


def test_person():
    cfg = YV.TINY
    per = {"arch": _arch(cfg), "det_size": 64}
    want = counted(YV.YoloV8(cfg).eval(), torch.randn(1, 3, 64, 64))
    assert flops.person_flops(per) == want


def test_arcface():
    cfg = AF.TINY
    want = counted(AF.IResNet(cfg).eval(), torch.randn(1, 3, 112, 112))
    assert flops.embedder_flops({"kind": "arcface",
                                 "arch": _arch(cfg)}) == want


def test_clip():
    cfg = CV.TINY
    s = cfg.image_size
    want = counted(CV.ClipViT(cfg).eval(), torch.randn(1, s, s, 3))
    assert flops.embedder_flops({"kind": "clip", "arch": _arch(cfg)}) == want


def test_published_sizes():
    """ViT-L/14 at 224 px: about 162 GFLOP a chip (81 GMAC)."""
    vit = _arch(CV.VIT_L_14)
    assert 155e9 < flops.clip_flops(vit) < 170e9
