"""SCRFD face detector in torch (NCHW, fixed-shape, fused decode).

Counterpart of ``person_capture_tpu/models/scrfd.py``: anchor-based 3-level
FPN with 2 anchors/location, per-level sigmoid scores, ltrb stride-unit box
distances and 5-point landmark offsets, per-level top-k, cross-level NMS
into fixed slots. Same architecture and configurations; the parameters load
from the JAX package's checkpoints through :mod:`.bridge`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (ConvBN, ResBasicBlock, distance2bbox, distance2kps,
                     make_anchor_centers, upsample2x)
from .nms import nms_select, stable_topk
from .preprocess import normalize_scrfd

GN_EPS = 1e-6  # flax.linen.GroupNorm's default


@dataclass(frozen=True)
class SCRFDConfig:
    name: str = "scrfd_2.5g"
    stem: int = 32
    stage_channels: Tuple[int, ...] = (32, 64, 128, 256)   # strides 4,8,16,32
    stage_blocks: Tuple[int, ...] = (2, 2, 2, 2)
    fpn_channels: int = 64
    head_stacks: int = 2
    num_anchors: int = 2
    strides: Tuple[int, ...] = (8, 16, 32)
    # detection-time settings
    max_candidates: int = 256     # per level pre-NMS top-k
    max_faces: int = 32           # post-NMS output slots
    nms_iou: float = 0.4


TINY = SCRFDConfig(name="scrfd_tiny", stem=8, stage_channels=(8, 16, 24, 32),
                   stage_blocks=(1, 1, 1, 1), fpn_channels=16, head_stacks=1,
                   max_candidates=64, max_faces=8)

SCRFD_2_5G = SCRFDConfig(name="scrfd_2.5g")

SCRFD_10G = SCRFDConfig(name="scrfd_10g", stem=64,
                        stage_channels=(64, 128, 256, 512),
                        stage_blocks=(3, 4, 6, 3), fpn_channels=128,
                        head_stacks=3)

CONFIGS = {c.name: c for c in (TINY, SCRFD_2_5G, SCRFD_10G)}


class Backbone(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        self.stem = ConvBN(3, cfg.stem, 3, 2)
        blocks = []
        cin = cfg.stem
        self.stage_ends = []
        for ch, nblocks in zip(cfg.stage_channels, cfg.stage_blocks):
            for bi in range(nblocks):
                blocks.append(ResBasicBlock(cin, ch, 2 if bi == 0 else 1))
                cin = ch
            self.stage_ends.append(len(blocks) - 1)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                feats.append(x)  # strides 4, 8, 16, 32
        return feats[1], feats[2], feats[3]


class PAFPN(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        ch = cfg.fpn_channels
        c3, c4, c5 = cfg.stage_channels[1:]
        # creation order of the flax module (ConvBN_0..9)
        self.lat5 = ConvBN(c5, ch, 1, act=False)
        self.lat4 = ConvBN(c4, ch, 1, act=False)
        self.lat3 = ConvBN(c3, ch, 1, act=False)
        self.smooth3 = ConvBN(ch, ch, 3)
        self.smooth4 = ConvBN(ch, ch, 3)
        self.smooth5 = ConvBN(ch, ch, 3)
        self.down3 = ConvBN(ch, ch, 3, 2, act=False)
        self.down4 = ConvBN(ch, ch, 3, 2, act=False)
        self.out4 = ConvBN(ch, ch, 3)
        self.out5 = ConvBN(ch, ch, 3)

    def forward(self, c3, c4, c5):
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + upsample2x(p5)
        p3 = self.lat3(c3) + upsample2x(p4)
        p3 = self.smooth3(p3)
        p4 = self.smooth4(p4)
        p5 = self.smooth5(p5)
        n4 = p4 + self.down3(p3)
        n5 = p5 + self.down4(n4)
        return p3, self.out4(n4), self.out5(n5)


class Head(nn.Module):
    """Shared detection head applied per level: stacked convs + GroupNorm,
    then cls/bbox/kps projections."""

    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        ch, a = cfg.fpn_channels, cfg.num_anchors
        self.convs = nn.ModuleList(nn.Conv2d(ch, ch, 3, 1, 1, bias=False)
                                   for _ in range(cfg.head_stacks))
        self.norms = nn.ModuleList(nn.GroupNorm(min(16, ch), ch, eps=GN_EPS)
                                   for _ in range(cfg.head_stacks))
        self.cls = nn.Conv2d(ch, a, 3, 1, 1)
        self.bbox = nn.Conv2d(ch, 4 * a, 3, 1, 1)
        self.kps = nn.Conv2d(ch, 10 * a, 3, 1, 1)

    def forward(self, x):
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        return self.cls(x), self.bbox(x), self.kps(x)


class SCRFD(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.fpn = PAFPN(cfg)
        self.head = Head(cfg)

    def forward(self, x):
        """x: normalized ``[B, 3, S, S]`` (RGB). Returns per-level raw maps
        ``(cls, bbox, kps)`` in NCHW."""
        p3, p4, p5 = self.fpn(*self.backbone(x))
        return [self.head(p) for p in (p3, p4, p5)]


def check_det_size(cfg: SCRFDConfig, size: int) -> None:
    deepest = max(cfg.strides)
    if size % deepest:
        # the PAFPN adds upsample2x(p5) to p4: any other size fails later
        # as an opaque shape mismatch
        raise ValueError(
            f"SCRFD det size must be a multiple of {deepest}, got {size} "
            f"(adjust --det-size / face_fullframe_imgsz)")


def decode_level(cls_map, bbox_map, kps_map, stride: int, num_anchors: int):
    """Flatten one level's raw NCHW maps to per-anchor (scores, boxes, kps)
    in letterboxed-image pixels, in the flax model's (h, w, anchor) order."""
    b, _, h, w = cls_map.shape
    a = num_anchors

    def nhwc(t):
        return t.float().permute(0, 2, 3, 1)

    scores = torch.sigmoid(nhwc(cls_map)).reshape(b, h * w * a)
    dists = nhwc(bbox_map).reshape(b, h * w * a, 4)
    offs = nhwc(kps_map).reshape(b, h * w * a, 10)
    centers = make_anchor_centers(h, w, stride, a, cls_map.device)[None]
    return (scores, distance2bbox(centers, dists, float(stride)),
            distance2kps(centers, offs, float(stride)))


def select_detections(level_scores, level_boxes, level_kps, det_scales,
                      score_thresh, max_faces: int, nms_iou: float,
                      max_candidates: int):
    """Per-level top-k → concat → NMS → fixed-slot output, mapped back to
    original-frame coordinates (``det_scales`` ``[B]``)."""
    all_scores, all_boxes, all_kps = [], [], []
    for s, bx, kp in zip(level_scores, level_boxes, level_kps):
        k = min(max_candidates, s.shape[1])
        top_s, top_i = stable_topk(s, k)
        all_scores.append(top_s)
        all_boxes.append(torch.gather(bx, 1, top_i[..., None].expand(-1, -1, 4)))
        all_kps.append(torch.gather(
            kp, 1, top_i[..., None, None].expand(-1, -1, 5, 2)))
    scores = torch.cat(all_scores, 1)
    boxes = torch.cat(all_boxes, 1)
    kps = torch.cat(all_kps, 1)
    valid = scores >= score_thresh

    idx, mask = nms_select(boxes, scores, valid, max_faces, nms_iou)
    s_out = torch.gather(scores, 1, idx)
    b_out = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    k_out = torch.gather(kps, 1, idx[..., None, None].expand(-1, -1, 5, 2))
    inv = 1.0 / torch.clamp(torch.as_tensor(det_scales, dtype=torch.float32,
                                            device=scores.device), min=1e-9)
    return {"boxes": b_out * inv[:, None, None],
            "kps": k_out * inv[:, None, None, None],
            "scores": s_out, "mask": mask}


@torch.no_grad()
def detect_faces(model: SCRFD, frames_bgr, det_scales,
                 score_thresh: float = 0.5, max_faces: int | None = None):
    """Fused SCRFD detection over a pre-letterboxed batch.

    Args:
      frames_bgr: ``[B, S, S, 3]`` float32 BGR, already letterboxed top-left
        (the JAX package's layout).
      det_scales: ``[B]`` letterbox scales (output coords divided by these).
    Returns dict with fixed shapes: boxes ``[B, F, 4]`` (original-frame
    coords), kps ``[B, F, 5, 2]``, scores ``[B, F]``, mask ``[B, F]``.
    """
    dtype = next(model.parameters()).dtype
    x = normalize_scrfd(frames_bgr).permute(0, 3, 1, 2).to(dtype)
    return detections_from_levels(model.cfg, model(x), det_scales,
                                  score_thresh, max_faces)


def detections_from_levels(cfg: SCRFDConfig, levels, det_scales,
                           score_thresh: float = 0.5,
                           max_faces: int | None = None):
    """The fixed-slot detections of :func:`detect_faces` from the model's
    per-level raw maps ``[(cls, bbox, kps), ...]`` (NCHW)."""
    max_faces = int(max_faces or cfg.max_faces)
    level_scores, level_boxes, level_kps = [], [], []
    for (cls_map, bbox_map, kps_map), stride in zip(levels, cfg.strides):
        s, bx, kp = decode_level(cls_map, bbox_map, kps_map, stride,
                                 cfg.num_anchors)
        level_scores.append(s)
        level_boxes.append(bx)
        level_kps.append(kp)
    return select_detections(level_scores, level_boxes, level_kps,
                             det_scales, score_thresh, max_faces,
                             cfg.nms_iou, cfg.max_candidates)
