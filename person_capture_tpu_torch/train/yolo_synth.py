"""Train the YOLOv8 person detector on synthetic person scenes (torch).

Counterpart of ``person_capture_tpu/train/yolo_synth.py``, the recipe of
train/scrfd_synth.py adapted to the YOLOv8 head (models/yolov8.py):
anchor-free one-point-per-cell assignment with center sampling and FCOS
level ranges, distribution-focal-loss (DFL) on the per-side bin
distributions the DFL decode expects, focal loss on the 80-class sigmoid
scores (person = class 0; the class count stays at 80 so real ultralytics
checkpoints keep mapping 1:1). Target building is the JAX trainer's numpy
code unchanged; the loss and the step are torch (train/loop.py).

CLI:
    python -m person_capture_tpu_torch.train.yolo_synth \
        --cfg yolov8n --size 256 --batch 32 --steps 1500 \
        --out yolov8n_synth.npz
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from .scenes import sample_person_batch

LEVEL_HI = (64.0, 128.0, 1e9)


def build_targets(boxes: np.ndarray, gt_mask: np.ndarray, size: int,
                  strides: Sequence[int] = (8, 16, 32),
                  reg_max: int = 16, center_radius: float = 1.5,
                  kps: np.ndarray = None
                  ) -> List[Dict[str, np.ndarray]]:
    """Per-level dense targets. Cell centers at (i+0.5)*stride (matching
    models/yolov8.decode_level). Returns per level: ``labels [B, L]``,
    ``box_t [B, L, 4]`` ltrb in stride units (clipped to the DFL bin
    range), ``pos [B, L]``; with ``kps [B, G, 5, 2]`` given, also
    ``kps_t [B, L, 5, 2]`` in the pose-decode parameterization
    ``t = ((p - center)/stride + 0.5) / 2`` (models/yolov8.
    decode_kpts_level inverts this)."""
    b, g = gt_mask.shape
    gx1, gy1, gx2, gy2 = (boxes[..., i] for i in range(4))
    gcx, gcy = (gx1 + gx2) / 2, (gy1 + gy2) / 2
    areas = np.where(gt_mask, (gx2 - gx1) * (gy2 - gy1), np.inf)
    maxdim = np.maximum(gx2 - gx1, gy2 - gy1)
    out = []
    for li, s in enumerate(strides):
        lo = 0.0 if li == 0 else LEVEL_HI[li - 1]
        hi = LEVEL_HI[li]
        n = size // s
        ys, xs = np.meshgrid((np.arange(n) + 0.5) * s,
                             (np.arange(n) + 0.5) * s, indexing="ij")
        cx = xs.reshape(-1).astype(np.float32)
        cy = ys.reshape(-1).astype(np.float32)
        l = cx[None, :, None] - gx1[:, None, :]
        t = cy[None, :, None] - gy1[:, None, :]
        r = gx2[:, None, :] - cx[None, :, None]
        btm = gy2[:, None, :] - cy[None, :, None]
        ltrb = np.stack([l, t, r, btm], -1)
        inside = ltrb.min(-1) > 0.01
        maxd = ltrb.max(-1)
        in_range = (maxd > lo) & (maxd <= hi)
        in_center = ((np.abs(cx[None, :, None] - gcx[:, None, :])
                      <= center_radius * s)
                     & (np.abs(cy[None, :, None] - gcy[:, None, :])
                        <= center_radius * s))
        cand = inside & in_range & in_center & gt_mask[:, None, :]
        cost = np.where(cand, areas[:, None, :], np.inf)
        g_best = cost.argmin(-1)
        pos = cand.any(-1)

        gt_level = (maxdim > lo) & (maxdim <= hi) & gt_mask
        has_pos = np.zeros((b, g), bool)
        bi = np.arange(b)[:, None]
        np.logical_or.at(has_pos, (np.repeat(bi, pos.shape[1], 1)[pos],
                                   g_best[pos]), True)
        need = gt_level & ~has_pos
        if need.any():
            d2 = ((cx[None, :, None] - gcx[:, None, :]) ** 2
                  + (cy[None, :, None] - gcy[:, None, :]) ** 2)
            nearest = d2.argmin(1)
            for bb, gg in zip(*np.nonzero(need)):
                loc = nearest[bb, gg]
                pos[bb, loc] = True
                g_best[bb, loc] = gg

        box_t = np.take_along_axis(
            ltrb, g_best[:, :, None, None].repeat(4, -1), 2)[:, :, 0] / s
        box_t = np.clip(box_t, 0.0, reg_max - 1 - 1e-3)
        level = {
            "labels": pos.astype(np.float32),
            "box_t": box_t.astype(np.float32),
            "pos": pos,
        }
        if kps is not None:
            bi_full = np.arange(b)[:, None]
            kp_sel = kps[bi_full, g_best]                 # [B, L, 5, 2]
            center = np.stack([cx, cy], -1)[None, :, None, :]
            level["kps_t"] = (((kp_sel - center) / s + 0.5) / 2.0
                              ).astype(np.float32)
        out.append(level)
    return out



def nhwc(t, b: int, *tail):
    """A level's raw NCHW map in flax's NHWC ``(h, w)`` order, fp32: before
    the DFL ``[.., 4, reg_max]`` reshape, as the JAX loss sees it."""
    return t.float().permute(0, 2, 3, 1).reshape(b, -1, *tail)


def make_loss_fn(model):
    """``loss_fn(images_u8, targets) -> (loss, aux)``, the JAX
    ``make_loss_fn``'s loss on device tensors."""
    from ..ops.preprocess import normalize_yolo
    from .loop import (dfl_loss, nchw, sigmoid_binary_cross_entropy,
                       sigmoid_focal_loss)

    reg_max = model.cfg.reg_max

    def loss_fn(images_u8, targets):
        x = nchw(normalize_yolo(images_u8.float()))
        levels = model(x)
        total_pos = sum(t["pos"].sum() for t in targets)
        denom = torch.clamp(total_pos.float(), min=1.0)
        cls_loss = box_loss = 0.0
        for (box_map, cls_map), t in zip(levels, targets):
            bsz = cls_map.shape[0]
            logits = nhwc(cls_map, bsz, cls_map.shape[1])
            focal = sigmoid_focal_loss(logits[..., 0], t["labels"],
                                       alpha=0.25, gamma=2.0)
            # non-person classes trained to 0 (weak weight keeps them dead)
            rest = logits[..., 1:]
            bg = sigmoid_binary_cross_entropy(
                rest, torch.zeros_like(rest)).mean(-1)
            cls_loss = cls_loss + focal.sum() + 0.02 * bg.sum()
            boxl = nhwc(box_map, bsz, 4, reg_max)
            posf = t["pos"].float()
            box_loss = box_loss + (dfl_loss(boxl, t["box_t"], reg_max)
                                   * posf).sum()
        loss = (cls_loss + 1.5 * box_loss) / denom
        return loss, {"cls": cls_loss / denom, "box": box_loss / denom,
                      "npos": total_pos}

    return loss_fn


def evaluate(model, rng, size: int, batches: int = 4, batch: int = 16,
             conf: float = 0.35) -> Dict[str, float]:
    from ..models.yolov8 import detect_persons
    from .common import match_detections
    from .loop import eval_mode

    dev = next(model.parameters()).device
    tp = fp = fn = 0
    for _ in range(batches):
        data = sample_person_batch(rng, batch, size)
        with eval_mode(model), torch.no_grad():
            det = detect_persons(
                model, torch.from_numpy(data["images"].astype(np.float32))
                .to(dev), torch.ones(batch), conf)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        btp, bfp, bfn, _ = match_detections(
            det["boxes"], det["mask"], data["boxes"], data["gt_mask"],
            iou_thresh=0.5)
        tp += btp
        fp += bfp
        fn += bfn
    return {"recall": tp / max(tp + fn, 1),
            "precision": tp / max(tp + fp, 1)}


def init_model(cfg, seed: int):
    """A fresh YOLOv8 with flax's initialisers and the class prior of the
    flax head (bias −4.6 on every class conv)."""
    from ..models.yolov8 import YoloV8
    from .loop import init_like_flax

    model = init_like_flax(YoloV8(cfg), seed)
    with torch.no_grad():
        for head in model.heads:
            head.cls[2].bias.fill_(-4.6)
    return model


def setup(cfg_name: str = "yolov8n", size: int = 256, batch: int = 32,
          steps: int = 1500, lr: float = 2e-3, seed: int = 0,
          dtype_name: str = "float32", device: str = "cuda"):
    """As :func:`.scrfd_synth.setup`, on person scenes."""
    from ..models import yolov8 as Y
    from .ckpt import step_rng
    from .loop import Run, TrainState, resolve_device, to_device

    dev = resolve_device(device)
    cfg = Y.CONFIGS[cfg_name]
    Y.check_det_size(cfg, size)
    model = init_model(cfg, seed)
    ts = TrainState(model, lr, steps, 1e-4, dev, dtype_name)

    def batch_at(i):
        data = sample_person_batch(step_rng(seed, i), batch, size)
        targets = build_targets(data["boxes"], data["gt_mask"], size,
                                cfg.strides, cfg.reg_max)
        return to_device(data["images"], dev), to_device(targets, dev)

    return Run(ts, make_loss_fn(model), batch_at)


def train(cfg_name: str = "yolov8n", size: int = 256, batch: int = 32,
          steps: int = 1500, lr: float = 2e-3, seed: int = 0,
          out: str = "", log_every: int = 50, eval_every: int = 250,
          dtype_name: str = "float32", ckpt_dir: str = "",
          ckpt_every: int = 0, device: str = "cuda"):
    """As :func:`.scrfd_synth.train`: returns ``(variables, final)``."""
    from ..models.bridge import flax_variables
    from .loop import median_ms, save_f16_npz

    run = setup(cfg_name, size, batch, steps, lr, seed, dtype_name, device)
    model = run.state.model
    start_step = run.state.resume(ckpt_dir)

    eval_rng = np.random.default_rng(seed + 10_000)
    t0 = time.time()
    for i in range(start_step, steps):
        metrics = run.step(i)
        if (i + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i + 1}/{steps} loss={m['loss']:.4f} "
                  f"cls={m['cls']:.4f} box={m['box']:.4f} "
                  f"npos={m['npos']:.0f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if eval_every and (i + 1) % eval_every == 0:
            ev = evaluate(model, eval_rng, size)
            print(f"  eval: recall={ev['recall']:.3f} "
                  f"precision={ev['precision']:.3f}", flush=True)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            run.state.save(ckpt_dir, i + 1)

    step_ms = run.state.step_ms()
    final = evaluate(model, eval_rng, size)
    print(f"final eval: {final}", flush=True)
    final["ms_per_step"] = median_ms(step_ms)
    variables = flax_variables(model)
    if out:
        save_f16_npz(out, variables)
    return variables, final


def main(argv=None) -> int:
    from .loop import add_common_flags

    ap = argparse.ArgumentParser(prog="yolo_synth")
    ap.add_argument("--cfg", default="yolov8n")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    add_common_flags(ap, steps=1500, lr=2e-3)
    args = ap.parse_args(argv)
    train(args.cfg, args.size, args.batch, args.steps, args.lr, args.seed,
          args.out, dtype_name=args.dtype, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
