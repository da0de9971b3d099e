"""The plain reference of the face and person chain, in float32.

What the port's combined step computes for one batch of analysis frames,
written as separate plain steps on frozen copies of the models: the host's
I420 wire (``cv2.COLOR_BGR2YUV_I420``) and its BT.601 conversion back,
letterbox, the face detector (SCRFD) with its NMS into slots, the 5-point
chip warp, the embedder (IResNet ArcFace or a CLIP ViT tower), and the
person detector (YOLOv8). Each model comes from the family its
configuration section names (``port_bench/families/``). It also builds
the bank of the reference photo (the photo and its mirror) as the engine
seeds it. TF32 is off while it runs.

``precision="fp8"`` is the control: every convolution and dense layer
takes its weights and its input rounded to float8 e4m3 (per tensor, scaled
to the format's range), the step below the bfloat16 the configurations
state.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..families import ROLES, family_of
from .align import align_chips
from .preprocess import letterbox_topleft

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale, back in its
    dtype."""
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-12)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def lower_to_fp8(model: nn.Module) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                m.weight.copy_(fp8_round(m.weight))
            m.register_forward_pre_hook(
                lambda mod, args: (fp8_round(args[0]), *args[1:]))
    return model


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def i420_round_trip(frames: np.ndarray) -> np.ndarray:
    """BGR uint8 ``[B, H, W, 3]`` → the I420 planes the host sends."""
    import cv2

    return np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
                     for f in frames])


def i420_to_bgr(planes: torch.Tensor) -> torch.Tensor:
    b, h15, w = planes.shape
    h = (h15 * 2) // 3
    y = planes[:, :h, :].float()
    chroma = planes[:, h:, :].reshape(b, 2, h // 2, w // 2).float()
    chroma = F.interpolate(chroma, size=(h, w), mode="bilinear",
                           align_corners=False) - 128.0
    u, v = chroma[:, 0], chroma[:, 1]
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    bl = y + 1.772 * u
    return torch.clamp(torch.stack([bl, g, r], dim=-1), 0.0, 255.0)


def chip_quality(chips: torch.Tensor) -> torch.Tensor:
    bgr = chips.float()
    gray = 0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]
    g = torch.clamp(torch.floor(gray + 0.5), 0.0, 255.0)
    up = torch.cat([g[..., 1:2, :], g[..., :-1, :]], dim=-2)
    down = torch.cat([g[..., 1:, :], g[..., -2:-1, :]], dim=-2)
    left = torch.cat([g[..., :, 1:2], g[..., :, :-1]], dim=-1)
    right = torch.cat([g[..., :, 1:], g[..., :, -2:-1]], dim=-1)
    resp = up + down + left + right - 4.0 * g
    return ((resp - resp.mean(dim=(-1, -2), keepdim=True)) ** 2).mean(
        dim=(-1, -2))


class Reference:
    """The chain of one configuration file (``cfg``: its ``detector``,
    ``embedder`` and ``person`` sections) on ``device``.

    ``weights``: flax variable trees by role (``detector``, ``embedder``,
    ``person``), the same the port is given.
    """

    def __init__(self, cfg: Dict, weights: Dict, device,
                 precision: str = "fp32", block: int = 16):
        self.device = torch.device(device)
        self.block = int(block)
        det, emb, per = cfg["detector"], cfg["embedder"], cfg["person"]
        self.det_size = int(det["det_size"])
        self.score_thresh = float(det["score_thresh"])
        self.max_faces = int(det["max_faces"])
        self.person_size = int(per["det_size"])
        self.person_conf = float(per["conf"])
        self.person_max = int(per["max_det"])
        self.dedup_cos = float(emb["bank_dedup_cos"])
        families = [family_of(cfg[role], role) for role in ROLES]
        self.models = []
        for role, fam in zip(ROLES, families):
            m = fam.reference(cfg[role]["arch"])
            fam.load_reference(m, weights[role])
            m = m.eval().to(self.device, torch.float32)
            if precision == "fp8":
                lower_to_fp8(m)
            elif precision != "fp32":
                raise ValueError(f"unknown precision {precision!r}")
            self.models.append(m)
        self.detector, self.embedder, self.person = self.models
        self._det, self._emb, self._per = families

    @torch.no_grad()
    def _wire(self, part: np.ndarray) -> torch.Tensor:
        """BGR uint8 frames as the port receives them: through the I420
        wire, back to float32 BGR on the device."""
        return i420_to_bgr(torch.from_numpy(i420_round_trip(part)).to(
            self.device))

    def faces(self, frames: np.ndarray) -> Dict:
        """Faces of BGR uint8 frames ``[B, H, W, 3]`` in frame
        coordinates: boxes, kps, scores, mask, and feats (zero where the
        slot is empty), numpy."""
        outs = []
        with no_tf32():
            for at in range(0, len(frames), self.block):
                bgr = self._wire(frames[at:at + self.block])
                padded, scale = letterbox_topleft(bgr, self.det_size)
                scales = torch.full((bgr.shape[0],), scale,
                                    dtype=torch.float32, device=self.device)
                det = self._det.detect_faces(self.detector, padded, scales,
                                             self.score_thresh,
                                             self.max_faces)
                mask = det["mask"]
                chips = align_chips(bgr, det["kps"], mask)
                feats = torch.zeros((*mask.shape,
                                     self._emb.dim(self.embedder)),
                                    device=self.device)
                if mask.any():
                    feats[mask] = self._emb.encode(self.embedder,
                                                   chips[mask])
                quality = torch.where(mask, chip_quality(chips),
                                      torch.zeros((), device=self.device))
                outs.append({**{k: v.float().cpu().numpy()
                                for k, v in det.items() if k != "mask"},
                             "mask": mask.cpu().numpy(),
                             "feats": feats.cpu().numpy(),
                             "quality": quality.cpu().numpy()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    @torch.no_grad()
    def persons(self, frames: np.ndarray) -> Dict:
        """YOLOv8 persons of BGR uint8 frames: boxes, scores, mask."""
        outs = []
        with no_tf32():
            for at in range(0, len(frames), self.block):
                bgr = self._wire(frames[at:at + self.block])
                padded, scale = letterbox_topleft(bgr, self.person_size)
                scales = torch.full((bgr.shape[0],), scale,
                                    dtype=torch.float32, device=self.device)
                det = self._per.detect_persons(
                    self.person, padded, scales, self.person_conf,
                    self.person_max, clip_hw=tuple(bgr.shape[1:3]))
                outs.append({k: v.float().cpu().numpy() if k != "mask"
                             else v.cpu().numpy() for k, v in det.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def bank(self, photo: np.ndarray) -> Optional[np.ndarray]:
        """The bank of a reference photo as the engine seeds it: the photo
        and its mirror, each on a zero canvas of the detector's size (twice
        that when the photo is larger), its best-quality face's embedding.
        A face as close to a row as ``bank_dedup_cos`` is not added, as
        the bank drops it. Rows L2-normalised, ``[n, D]``; None when no face
        is found."""
        import cv2

        det = self.det_size
        canvas = det * 2 if max(photo.shape[:2]) > det else det
        rows = []
        for img in (photo, photo[:, ::-1].copy()):
            s = min(1.0, canvas / max(img.shape[0], img.shape[1]))
            if s < 1.0:
                img = cv2.resize(img, (int(round(img.shape[1] * s)),
                                       int(round(img.shape[0] * s))),
                                 interpolation=cv2.INTER_AREA)
            arr = np.zeros((1, canvas, canvas, 3), np.uint8)
            arr[0, :img.shape[0], :img.shape[1]] = img
            saved, self.det_size = self.det_size, canvas
            try:
                out = self.faces(arr)
            finally:
                self.det_size = saved
            mask = out["mask"][0]
            if not mask.any():
                continue
            j = int(np.argmax(np.where(mask, out["quality"][0], -1.0)))
            v = out["feats"][0][j]
            v = v / max(float(np.linalg.norm(v)), 1e-6)
            if all(float(r @ v) < self.dedup_cos for r in rows):
                rows.append(v)
        return np.stack(rows) if rows else None

