"""Checkpoint-exact ONNX model adapters (SCRFD / ArcFace) in torch.

The reference ships its face stack as ONNX files and runs them through
onnxruntime+TensorRT (person_capture/face_embedder.py:55-83, 967-1197).
When a user provides those same files (e.g. scrfd_2.5g_bnkps.onnx,
w600k_r50.onnx), these adapters execute the *exact* graph through
tools/onnx_exec — no architecture re-mapping — and expose the callables the
face backend consumes (pipeline/backends.py), so ``--scrfd-weights
path.onnx`` is a drop-in for the bundled weights.

Decode parity: insightface's SCRFD python decode multiplies raw ltrb/kps
distances by the stride and adds anchor centers (grouped-by-kind output
order score*3, bbox*3, kps*3); the adapter reuses the selection tail of
models/scrfd.select_detections, so NMS and slot order are the native
path's.

Counterpart of ``person_capture_tpu/models/onnx_zoo.py``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..tools.onnx_exec import OnnxModule, load_onnx_module

__all__ = ["OnnxScrfdDetector", "OnnxArcFaceEncoder", "detect_faces_onnx",
           "is_onnx_path"]


def is_onnx_path(spec: Any) -> bool:
    return isinstance(spec, str) and spec.lower().endswith(".onnx")


class OnnxScrfdDetector:
    """``detector(padded_bgr, det_scales, score_thresh) -> dict`` running an
    insightface SCRFD ONNX graph on ``[B, S, S, 3]`` float BGR letterboxed
    frames; the same output as :func:`.scrfd.detect_faces`. Weights are cast
    to ``dtype`` (when given) and live on ``device``."""

    def __init__(self, path: str, det_size: int, max_faces: int = 8,
                 strides: Sequence[int] = (8, 16, 32), nms_iou: float = 0.4,
                 max_candidates: int = 256, dtype=None,
                 require_kps: bool = True, device=None):
        self.module: OnnxModule = load_onnx_module(path)
        n_out = len(self.module.output_names)
        if n_out not in (6, 9):
            raise ValueError(
                f"{path}: expected 6 (boxes) or 9 (boxes+kps) outputs in "
                f"grouped-by-kind SCRFD order, got {n_out} "
                f"({self.module.output_names})")
        self.use_kps = n_out == 9
        if require_kps and not self.use_kps:
            # the face pipeline aligns chips from the 5-pt landmarks; a
            # bbox-only graph would emit all-zero kps and every "aligned"
            # chip would silently be the same wrong frame region. The
            # reference likewise requires *_bnkps models
            # (face_embedder.py:55-65 download mirrors).
            raise ValueError(
                f"{path}: SCRFD graph has no landmark outputs (6 outputs, "
                f"boxes only). The alignment pipeline needs a *_bnkps "
                f"model; pass require_kps=False only for bbox-only use.")
        self.det_size = int(det_size)
        self.max_faces = int(max_faces)
        self.strides = tuple(int(s) for s in strides)
        self.nms_iou = float(nms_iou)
        self.max_candidates = int(max_candidates)
        self.dtype = dtype
        self.params = self.module.device_params(device or "cuda", dtype)

    @torch.no_grad()
    def __call__(self, padded_bgr, det_scales, score_thresh):
        from ..ops.preprocess import normalize_scrfd
        from .layers import distance2bbox, distance2kps, make_anchor_centers
        from .scrfd import select_detections

        x = normalize_scrfd(padded_bgr)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)                   # ONNX graphs are NCHW
        outs = self.module(self.params, x)
        n_levels = len(self.strides)
        scores_raw = outs[0:n_levels]
        bbox_raw = outs[n_levels:2 * n_levels]
        kps_raw = outs[2 * n_levels:3 * n_levels] if self.use_kps else None

        batch = padded_bgr.shape[0]
        level_scores, level_boxes, level_kps = [], [], []
        for i, stride in enumerate(self.strides):
            side = self.det_size // stride
            hwa = int(np.prod(tuple(scores_raw[i].shape))) // batch
            num_anchors = hwa // (side * side)
            centers = make_anchor_centers(side, side, stride, num_anchors,
                                          x.device)
            s = scores_raw[i].float().reshape(batch, hwa)
            d = bbox_raw[i].float().reshape(batch, hwa, 4)
            level_scores.append(s)
            level_boxes.append(distance2bbox(centers[None], d, float(stride)))
            if self.use_kps:
                o = kps_raw[i].float().reshape(batch, hwa, 10)
                level_kps.append(distance2kps(centers[None], o,
                                              float(stride)))
            else:
                level_kps.append(torch.zeros((batch, hwa, 5, 2),
                                             device=x.device))
        return select_detections(level_scores, level_boxes, level_kps,
                                 det_scales, score_thresh, self.max_faces,
                                 self.nms_iou, self.max_candidates)


def detect_faces_onnx(detector: OnnxScrfdDetector, frames_bgr, det_scales,
                      score_thresh: float = 0.5, max_faces=None):
    """:func:`.scrfd.detect_faces`'s signature over an ONNX detector (whose
    slot count was fixed when it was built)."""
    return detector(frames_bgr, det_scales, score_thresh)


def _infer_embed_dim(module: OnnxModule, default: int = 512) -> int:
    """Embedding width from the params feeding the output node
    (BatchNormalization scale / Gemm weight), falling back to `default`."""
    producers = {o: n for n in module.graph.nodes for o in n.outputs}
    name = module.graph.output_names[0]
    for _ in range(4):                       # walk through trailing glue ops
        node = producers.get(name)
        if node is None:
            break
        all_params = {**module.params, **module.constants}
        if node.op_type == "BatchNormalization" and node.inputs[1] in all_params:
            return int(all_params[node.inputs[1]].shape[0])
        if node.op_type == "Gemm" and node.inputs[1] in all_params:
            w = all_params[node.inputs[1]]
            return int(w.shape[0] if int(node.attrs.get("transB", 0))
                       else w.shape[1])
        if node.op_type in ("Identity", "Flatten", "Reshape", "Relu"):
            name = node.inputs[0]
            continue
        break
    return default


class OnnxArcFaceEncoder:
    """``encoder(chips_bgr) -> [N, D] L2-normalized`` float32, running an
    ArcFace ONNX graph (w600k_r50.onnx-style: [N,3,112,112] → [N,D]) on
    ``[N, 112, 112, 3]`` BGR chips; the same output as
    :func:`.arcface.encode_chips`."""

    def __init__(self, path: str, flip_tta: bool = False, dtype=None,
                 device=None):
        self.module: OnnxModule = load_onnx_module(path)
        self.flip_tta = bool(flip_tta)
        self.embed_dim = _infer_embed_dim(self.module)
        self.dtype = dtype
        self.params = self.module.device_params(device or "cuda", dtype)

    @torch.no_grad()
    def __call__(self, chips_bgr):
        from ..ops.preprocess import normalize_arcface

        x = normalize_arcface(chips_bgr)
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.flip_tta:
            x = torch.cat([x, x.flip(2)], dim=0)
        emb = self.module(self.params, x.permute(0, 3, 1, 2))
        if isinstance(emb, tuple):
            emb = emb[0]
        emb = emb.float()
        if self.flip_tta:
            n = emb.shape[0] // 2
            emb = emb[:n] + emb[n:]
        norm = torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                           min=1e-10)
        return emb / norm
