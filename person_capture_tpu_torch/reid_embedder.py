"""Reference-compatible ``ReIDEmbedder`` facade (torch).

Counterpart of ``person_capture_tpu/reid_embedder.py``.

API parity with person_capture/reid_embedder.py:10-57 — ``extract(bgr_list)``
returns a list of L2-normalized float32 embeddings — over the batched CLIP
ViT backend on the card (``device="cpu"`` runs it on the CPU).
"""

from __future__ import annotations

from typing import List

import numpy as np


class ReIDEmbedder:
    def __init__(self, model_name: str = "ViT-L-14",
                 pretrained: str = "laion2b_s32b_b82k", device: str = "cuda",
                 backend=None, weights=None, progress=None):
        self.device = device
        if backend is not None:
            self._backend = backend
        elif weights is not None:
            from .models import clip_vit as CV
            from .pipeline.backends import ClipReidBackend

            self._backend = ClipReidBackend(
                cfg=CV.CONFIGS.get(model_name, CV.VIT_L_14), weights=weights,
                device=device)
        else:
            # no explicit weights: zoo resolution (bundled trained compact
            # tower when present — main.resolve_reid), never a silent
            # random-init ViT-L
            from .main import resolve_reid
            from .pipeline.backends import ClipReidBackend

            reid_cfg, reid_w = resolve_reid(model_name, "auto")
            self._backend = ClipReidBackend(cfg=reid_cfg, weights=reid_w,
                                            device=device)

    def extract(self, bgr_list) -> List[np.ndarray]:
        if not bgr_list:
            return []
        crops = [b for b in bgr_list if b is not None and b.size > 0]
        if not crops:
            return []
        feats = self._backend.extract(crops)
        return [f for f in feats]
