"""YOLOv8 as the person detector (``reference/yolov8.py``), with bundled
weights that the port reads from the same ``.npz`` itself."""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.flops import layer_flops
from port_bench.reference import yolov8 as YV
from port_bench.reference.weights import load_yolov8 as load_reference

from . import config_args

detect_persons = YV.detect_persons


def reference(arch: Dict) -> YV.YoloV8:
    return YV.YoloV8(YV.YoloConfig(**config_args(arch)))


def port_model(runtime):
    person = runtime["person"]
    return None if person is None else person.model


def load_port(backends, tree) -> None:
    """The port loads the bundled file itself."""


def flops(arch: Dict, size: int) -> int:
    return layer_flops(reference(arch), torch.empty(1, 3, size, size))
