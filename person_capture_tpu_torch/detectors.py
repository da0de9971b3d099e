"""Reference-compatible ``PersonDetector`` facade (torch).

Counterpart of ``person_capture_tpu/detectors.py``: API parity with
person_capture/detectors.py:271-296 — ``detect(frame, conf)`` returns
``[{"xyxy": [...], "conf": c, "cls": 0}]`` for person only — implemented
over the batched YOLO backend on the card (``device="cpu"`` to run on the
CPU). Use the batched ``pipeline.backends.YoloPersonBackend`` directly in
new code; this facade exists so reference call-sites port unchanged (at
1-frame batch cost).
"""

from __future__ import annotations

from typing import List

import numpy as np


class PersonDetector:
    def __init__(self, model_name: str = "yolov8n.pt", device: str = "cuda",
                 det_size: int = 640, weights=None, backend=None):
        self.model_name = model_name
        self.device = device
        if backend is not None:
            self._backend = backend
        else:
            from .models import yolov8 as Y
            from .pipeline.backends import YoloPersonBackend

            cfg_name = model_name.replace(".pt", "")
            cfg = Y.CONFIGS.get(cfg_name, Y.YOLOV8N)
            if weights is None:
                from .models.zoo import resolve_weights

                weights = resolve_weights("auto", cfg.name)
            self._backend = YoloPersonBackend(cfg=cfg, det_size=det_size,
                                             weights=weights, device=device)

    def detect(self, frame: np.ndarray, conf: float = 0.35) -> List[dict]:
        """Person (class 0) detections for one BGR frame."""
        if frame is None or frame.size == 0:
            return []
        self._backend.conf = float(conf)
        out = self._backend.detect_batch(frame[None],
                                         np.ones(1, bool))
        results = []
        for k in np.flatnonzero(out["mask"][0]):
            results.append({"xyxy": [float(v) for v in out["boxes"][0][k]],
                            "conf": float(out["scores"][0][k]), "cls": 0})
        return results
