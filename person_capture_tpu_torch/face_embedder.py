"""Reference-compatible ``FaceEmbedder`` facade (torch).

Counterpart of ``person_capture_tpu/face_embedder.py``.

API parity with person_capture/face_embedder.py — ``extract(bgr)`` returns
faces sorted by (quality, area) desc as dicts with keys ``bbox`` (int32
xyxy), ``feat`` (L2-normalized), ``quality``; ``best_face(faces)`` picks by
(quality, area). Implemented over the SCRFD+ArcFace backend on the card
(``ctx="cpu"`` runs it on the CPU),
wrapped in the batched recovery ladder (pipeline/recovery.py — rotation /
scale-TTA / edge-pad probes matching face_embedder.py:2251-2443);
``set_prescan_fast`` / ``set_prescan_hint`` / ``configure_rotation_strategy``
drive the ladder's policy like the reference's runtime hints
(face_embedder.py:1224-1272).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class FaceEmbedder:
    def __init__(self, ctx: str = "cuda", det_size: str | int = 640,
                 providers=None, backend=None, scrfd_weights=None,
                 arcface_weights=None, face_model: str = "scrfd_2.5g",
                 arcface_model: str = "w600k_r50", recovery: bool = True):
        from .pipeline.recovery import RecoveringFaceBackend, RecoveryPolicy

        self.ctx = ctx
        if backend is None:
            from .models import arcface as AF
            from .models import scrfd as SD
            from .models.zoo import resolve_weights
            from .pipeline.backends import ScrfdArcFaceBackend

            if scrfd_weights is None:
                scrfd_weights = resolve_weights("auto", face_model)
            backend = ScrfdArcFaceBackend(
                scrfd_cfg=SD.CONFIGS.get(face_model, SD.SCRFD_2_5G),
                arcface_cfg=AF.CONFIGS.get(arcface_model, AF.W600K_R50),
                det_size=int(det_size),
                scrfd_weights=scrfd_weights,
                arcface_weights=arcface_weights, device=ctx)
        if recovery and not isinstance(backend, RecoveringFaceBackend):
            backend = RecoveringFaceBackend(backend, RecoveryPolicy())
        self._backend = backend
        self._prescan_fast = False

    # ---- reference runtime hints (tuning surface parity) -----------------
    def set_prescan_fast(self, enabled: bool, rr_mode: str = "rr") -> None:
        """Pre-scan fast mode: the ladder drops scale-TTA and probes one
        rotation per round-robin period (reference face_embedder.py:
        1224-1236)."""
        self._prescan_fast = bool(enabled)
        if hasattr(self._backend, "set_prescan_fast"):
            self._backend.set_prescan_fast(bool(enabled))

    def set_prescan_hint(self, rot_probe_period: int | None = None,
                         **kw) -> None:
        policy = getattr(self._backend, "policy", None)
        if policy is not None and rot_probe_period:
            policy.rr_period = max(1, int(rot_probe_period))

    def configure_rotation_strategy(self, adaptive: bool | None = None,
                                    every_n: int | None = None,
                                    after_hit_frames: int | None = None,
                                    **kw) -> None:
        policy = getattr(self._backend, "policy", None)
        if policy is None:
            return
        if adaptive is not None:
            policy.rot_adaptive = bool(adaptive)
        if every_n:
            policy.rot_every_n = max(1, int(every_n))
        if after_hit_frames is not None:
            policy.rot_after_hit_frames = max(0, int(after_hit_frames))

    # ---- main API --------------------------------------------------------
    def extract(self, bgr: np.ndarray) -> List[dict]:
        if bgr is None or bgr.size == 0:
            return []
        out = self._backend.extract_batch(bgr[None], np.ones(1, bool))
        faces = []
        for j in np.flatnonzero(out["mask"][0]):
            faces.append({
                "bbox": np.asarray(out["boxes"][0][j], np.int32),
                "kps": np.asarray(out["kps"][0][j], np.float32),
                "feat": np.asarray(out["feats"][0][j], np.float32),
                "quality": float(out["quality"][0][j]),
            })
        faces.sort(key=lambda f: (
            f["quality"],
            (f["bbox"][2] - f["bbox"][0]) * (f["bbox"][3] - f["bbox"][1])),
            reverse=True)
        return faces

    @staticmethod
    def best_face(faces) -> Optional[dict]:
        if not faces:
            return None
        return max(faces, key=lambda f: (
            f["quality"],
            (f["bbox"][2] - f["bbox"][0]) * (f["bbox"][3] - f["bbox"][1])))
