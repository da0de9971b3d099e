"""YOLOv8 detector in torch (NCHW, fixed-shape, fused decode).

Counterpart of ``person_capture_tpu/models/yolov8.py``: CSP backbone with
C2f blocks + SPPF, PAN neck, decoupled per-level heads with DFL box
regression, sigmoid class scores and an optional pose-style keypoint head
(the YOLOv8-face configurations), per-level top-k, NMS into fixed slots.
Same architecture and configurations; the parameters load from the JAX
package's checkpoints through :mod:`.bridge`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, upsample2x
from .nms import nms_select, stable_topk
from .preprocess import normalize_yolo

BN_EPS = 1e-3  # the flax model's BatchNorm epsilon (ultralytics' value)
BN_MOMENTUM = 0.03  # torch's 1 − the flax model's 0.97


@dataclass(frozen=True)
class YoloConfig:
    name: str = "yolov8n"
    width: Tuple[int, ...] = (16, 32, 64, 128, 256)   # stem + 4 stages
    depth: Tuple[int, ...] = (1, 2, 2, 1)             # C2f bottleneck counts
    reg_max: int = 16
    num_classes: int = 80
    strides: Tuple[int, ...] = (8, 16, 32)
    max_candidates: int = 256
    max_det: int = 40
    nms_iou: float = 0.45
    # (n_points, n_dims) pose-style keypoint head; (0, 0) = detection only.
    # YOLOv8-face = nc=1 + kpt_shape=(5, 3)
    kpt_shape: Tuple[int, int] = (0, 0)


TINY = YoloConfig(name="yolo_tiny", width=(8, 8, 16, 24, 32),
                  depth=(1, 1, 1, 1), max_candidates=64, max_det=8)
YOLOV8N = YoloConfig(name="yolov8n")
YOLOV8S = YoloConfig(name="yolov8s", width=(32, 64, 128, 256, 512))
TINY_FACE = YoloConfig(name="yolo_face_tiny", width=(8, 8, 16, 24, 32),
                       depth=(1, 1, 1, 1), num_classes=1, kpt_shape=(5, 3),
                       max_candidates=64, max_det=8)
YOLOV8N_FACE = YoloConfig(name="yolov8n_face", num_classes=1,
                          kpt_shape=(5, 3))

CONFIGS = {c.name: c for c in (TINY, YOLOV8N, YOLOV8S, TINY_FACE,
                               YOLOV8N_FACE)}


class ConvSiLU(nn.Module):
    """Conv (no bias) → BatchNorm (eps 1e-3, momentum 0.03) → SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, channels: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvSiLU(channels, channels, 3)
        self.cv2 = ConvSiLU(channels, channels, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (YOLOv8's core block)."""

    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__()
        self.c = cout // 2
        self.cv1 = ConvSiLU(cin, cout, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, shortcut)
                               for _ in range(n))
        self.cv2 = ConvSiLU(cout - self.c + (1 + n) * self.c, cout, 1)

    def forward(self, x):
        y = self.cv1(x)
        outs = [y[:, :self.c], y[:, self.c:]]
        h = outs[1]
        for block in self.m:
            h = block(h)
            outs.append(h)
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        c = cout // 2
        self.cv1 = ConvSiLU(cin, c, 1)
        # max_pool(..., padding="SAME") pads with -inf, as MaxPool2d does
        self.pool = nn.MaxPool2d(5, 1, 2)
        self.cv2 = ConvSiLU(4 * c, cout, 1)

    def forward(self, x):
        y = self.cv1(x)
        p1 = self.pool(y)
        p2 = self.pool(p1)
        p3 = self.pool(p2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


def _branch(cin: int, mid: int, cout: int) -> nn.Sequential:
    return nn.Sequential(ConvSiLU(cin, mid, 3), ConvSiLU(mid, mid, 3),
                         nn.Conv2d(mid, cout, 1))


class Head(nn.Module):
    """One level's decoupled head: box (DFL bins), class and, for pose
    configurations, keypoint branches."""

    def __init__(self, cfg: YoloConfig, ch: int):
        super().__init__()
        w2 = cfg.width[2]
        # ultralytics Detect/Pose channel formulas (the flax model's)
        c2 = max(16, w2 // 4, 4 * cfg.reg_max)
        c3 = max(w2, min(cfg.num_classes, 100))
        nk = cfg.kpt_shape[0] * cfg.kpt_shape[1]
        self.box = _branch(ch, c2, 4 * cfg.reg_max)
        self.cls = _branch(ch, c3, cfg.num_classes)
        self.kps = _branch(ch, max(w2 // 4, nk), nk) if nk else None

    def forward(self, x):
        if self.kps is None:
            return self.box(x), self.cls(x)
        return self.box(x), self.cls(x), self.kps(x)


class YoloV8(nn.Module):
    def __init__(self, cfg: YoloConfig):
        super().__init__()
        self.cfg = cfg
        w0, w1, w2, w3, w4 = cfg.width
        d1, d2, d3, d4 = cfg.depth
        # backbone
        self.stem = ConvSiLU(3, w0, 3, 2)          # /2
        self.down1 = ConvSiLU(w0, w1, 3, 2)        # /4
        self.stage1 = C2f(w1, w1, d1)
        self.down2 = ConvSiLU(w1, w2, 3, 2)        # /8
        self.stage2 = C2f(w2, w2, d2)
        self.down3 = ConvSiLU(w2, w3, 3, 2)        # /16
        self.stage3 = C2f(w3, w3, d3)
        self.down4 = ConvSiLU(w3, w4, 3, 2)        # /32
        self.stage4 = C2f(w4, w4, d4)
        self.sppf = SPPF(w4, w4)
        # PAN neck
        self.top4 = C2f(w4 + w3, w3, d1, shortcut=False)
        self.top3 = C2f(w3 + w2, w2, d1, shortcut=False)
        self.bottom_down4 = ConvSiLU(w2, w2, 3, 2)
        self.bottom4 = C2f(w2 + w3, w3, d1, shortcut=False)
        self.bottom_down5 = ConvSiLU(w3, w3, 3, 2)
        self.bottom5 = C2f(w3 + w4, w4, d1, shortcut=False)
        self.heads = nn.ModuleList(Head(cfg, ch) for ch in (w2, w3, w4))

    def forward(self, x):
        """x: normalized ``[B, 3, S, S]`` (RGB). Returns per level the raw
        NCHW maps ``(box, cls)``, or ``(box, cls, kps)`` for a pose head."""
        x = self.stage1(self.down1(self.stem(x)))
        p3 = self.stage2(self.down2(x))
        p4 = self.stage3(self.down3(p3))
        p5 = self.sppf(self.stage4(self.down4(p4)))
        u4 = self.top4(torch.cat([upsample2x(p5), p4], dim=1))
        u3 = self.top3(torch.cat([upsample2x(u4), p3], dim=1))
        d4 = self.bottom4(torch.cat([self.bottom_down4(u3), u4], dim=1))
        d5 = self.bottom5(torch.cat([self.bottom_down5(d4), p5], dim=1))
        return [head(f) for head, f in zip(self.heads, (u3, d4, d5))]


def check_det_size(cfg: YoloConfig, size: int) -> None:
    deepest = max(cfg.strides)
    if size % deepest:
        # the PAN adds across stride-8/16/32 levels: any other size fails
        # later as an opaque shape mismatch
        raise ValueError(
            f"YOLOv8 det size must be a multiple of {deepest}, got {size} "
            f"(adjust --det-size / yolo_imgsz)")


def _nhwc_flat(t, b: int, hw: int, *tail):
    return t.float().permute(0, 2, 3, 1).reshape(b, hw, *tail)


def decode_level(box_map, cls_map, stride: int, reg_max: int):
    """DFL decode of one level's raw NCHW maps: softmax over reg_max bins →
    expected ltrb distance in stride units from the cell centre (+0.5
    offset). Returns boxes ``[B, HW, 4]`` and sigmoid scores ``[B, HW, C]``
    in the flax model's row-major (h, w) order."""
    b, _, h, w = box_map.shape
    probs = torch.softmax(_nhwc_flat(box_map, b, h * w, 4, reg_max), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=box_map.device)
    d = (probs * bins).sum(-1) * stride                 # [B, HW, 4] ltrb
    ys = (torch.arange(h, dtype=torch.float32, device=box_map.device)
          + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=box_map.device)
          + 0.5) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    cx = gx.reshape(-1)[None]
    cy = gy.reshape(-1)[None]
    boxes = torch.stack([cx - d[..., 0], cy - d[..., 1],
                         cx + d[..., 2], cy + d[..., 3]], -1)
    scores = torch.sigmoid(_nhwc_flat(cls_map, b, h * w, -1))
    return boxes, scores


def decode_kpts_level(kps_map, stride: int, n_pts: int, n_dims: int):
    """Ultralytics pose decode of one level's raw NCHW map: per cell
    ``x = (tx*2 + grid_x)*stride``. Returns ``[B, HW, n_pts, 2]`` plus
    sigmoid visibility ``[B, HW, n_pts]``."""
    b, _, h, w = kps_map.shape
    t = _nhwc_flat(kps_map, b, h * w, n_pts, n_dims)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=kps_map.device),
        torch.arange(w, dtype=torch.float32, device=kps_map.device),
        indexing="ij")
    cx = gx.reshape(-1)[None, :, None]
    cy = gy.reshape(-1)[None, :, None]
    px = (t[..., 0] * 2.0 + cx) * stride
    py = (t[..., 1] * 2.0 + cy) * stride
    pts = torch.stack([px, py], dim=-1)
    vis = torch.sigmoid(t[..., 2]) if n_dims >= 3 else torch.ones_like(px)
    return pts, vis


def _levels(model: YoloV8, frames_bgr):
    dtype = next(model.parameters()).dtype
    x = normalize_yolo(frames_bgr).permute(0, 3, 1, 2).to(dtype)
    return model(x.contiguous())


@torch.no_grad()
def detect_faces_yolo(model: YoloV8, frames_bgr, det_scales,
                      score_thresh: float = 0.35,
                      max_faces: int | None = None):
    """YOLOv8-face detection over a letterboxed ``[B, S, S, 3]`` batch, with
    the output contract of :func:`.scrfd.detect_faces`: boxes ``[B, F, 4]``,
    kps ``[B, F, 5, 2]``, scores, mask (original-frame coordinates)."""
    from .scrfd import select_detections

    cfg = model.cfg
    assert cfg.kpt_shape[0] == 5, "face model needs a 5-point kpt head"
    max_faces = int(max_faces or cfg.max_det)
    level_scores, level_boxes, level_kps = [], [], []
    for (box_map, cls_map, kps_map), stride in zip(_levels(model, frames_bgr),
                                                   cfg.strides):
        boxes, scores = decode_level(box_map, cls_map, stride, cfg.reg_max)
        pts, _ = decode_kpts_level(kps_map, stride, *cfg.kpt_shape)
        level_scores.append(scores[..., 0])
        level_boxes.append(boxes)
        level_kps.append(pts)
    return select_detections(level_scores, level_boxes, level_kps,
                             det_scales, score_thresh, max_faces,
                             cfg.nms_iou, cfg.max_candidates)


@torch.no_grad()
def detect_persons(model: YoloV8, frames_bgr, det_scales, conf: float = 0.35,
                   max_det: int | None = None,
                   clip_hw: Tuple[int, int] | None = None):
    """Fused person detection over a letterboxed ``[B, S, S, 3]`` batch.

    Returns dict: boxes ``[B, K, 4]`` (original coords), scores ``[B, K]``,
    mask ``[B, K]`` — person (class 0) only. ``clip_hw`` (source frame
    height/width) clamps boxes to the frame, as the reference's ultralytics
    ``scale_boxes`` does.
    """
    cfg = model.cfg
    max_det = int(max_det or cfg.max_det)
    all_boxes, all_scores = [], []
    for (box_map, cls_map), stride in zip(_levels(model, frames_bgr),
                                          cfg.strides):
        boxes, scores = decode_level(box_map, cls_map, stride, cfg.reg_max)
        person = scores[..., 0]
        # lax.top_k's order: equal scores keep the lower index first
        top_s, top_i = stable_topk(person, min(cfg.max_candidates,
                                               person.shape[1]))
        all_scores.append(top_s)
        all_boxes.append(torch.gather(boxes, 1,
                                      top_i[..., None].expand(-1, -1, 4)))
    scores = torch.cat(all_scores, 1)
    boxes = torch.cat(all_boxes, 1)
    valid = scores >= conf

    idx, mask = nms_select(boxes, scores, valid, max_det, cfg.nms_iou)
    s_out = torch.gather(scores, 1, idx)
    b_out = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    inv = 1.0 / torch.clamp(torch.as_tensor(det_scales, dtype=torch.float32,
                                            device=scores.device), min=1e-9)
    b_out = b_out * inv[:, None, None]
    if clip_hw is not None:
        h, w = clip_hw
        lim = torch.tensor([w, h, w, h], dtype=torch.float32,
                           device=b_out.device)
        b_out = torch.clamp(b_out, min=torch.zeros_like(lim), max=lim)
    return {"boxes": b_out, "scores": s_out, "mask": mask}
