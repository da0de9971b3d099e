"""Train the YOLOv8-face detector (5-point landmarks) on synthetic scenes
(torch).

Counterpart of ``person_capture_tpu/train/yolo_face_synth.py``: the same
synthetic face scenes as train/scrfd_synth.py, DFL box loss + focal
single-class score + L1 landmark regression in the pose-decode
parameterization + visibility BCE, for the YOLOv8 keypoint head
(models/yolov8.py). Targets come from :func:`.yolo_synth.build_targets`.

CLI:
    python -m person_capture_tpu_torch.train.yolo_face_synth \
        --cfg yolov8n_face --size 256 --batch 32 --steps 1500 \
        --out yolov8n_face_synth.npz
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from .scenes import sample_batch
from .yolo_synth import build_targets, init_model, nhwc


def make_loss_fn(model):
    """``loss_fn(images_u8, targets) -> (loss, aux)``, the JAX
    ``make_loss_fn``'s loss on device tensors."""
    from ..ops.preprocess import normalize_yolo
    from .loop import (dfl_loss, nchw, sigmoid_binary_cross_entropy,
                       sigmoid_focal_loss)

    reg_max = model.cfg.reg_max
    n_pts, n_dims = model.cfg.kpt_shape

    def loss_fn(images_u8, targets):
        x = nchw(normalize_yolo(images_u8.float()))
        levels = model(x)
        total_pos = sum(t["pos"].sum() for t in targets)
        denom = torch.clamp(total_pos.float(), min=1.0)
        cls_loss = box_loss = kps_loss = 0.0
        for (box_map, cls_map, kps_map), t in zip(levels, targets):
            bsz = cls_map.shape[0]
            logits = nhwc(cls_map, bsz)
            cls_loss = cls_loss + sigmoid_focal_loss(
                logits, t["labels"], alpha=0.25, gamma=2.0).sum()
            boxl = nhwc(box_map, bsz, 4, reg_max)
            posf = t["pos"].float()
            box_loss = box_loss + (dfl_loss(boxl, t["box_t"], reg_max)
                                   * posf).sum()
            kpl = nhwc(kps_map, bsz, n_pts, n_dims)
            l1 = (kpl[..., :2] - t["kps_t"]).abs().mean((-1, -2))
            kps_loss = kps_loss + (l1 * posf).sum()
            if n_dims >= 3:
                # synthetic landmarks are always visible → target 1
                vis_bce = sigmoid_binary_cross_entropy(
                    kpl[..., 2], torch.ones_like(kpl[..., 2])).mean(-1)
                kps_loss = kps_loss + 0.2 * (vis_bce * posf).sum()
        loss = (cls_loss + 1.5 * box_loss + 4.0 * kps_loss) / denom
        return loss, {"cls": cls_loss / denom, "box": box_loss / denom,
                      "kps": kps_loss / denom, "npos": total_pos}

    return loss_fn


def evaluate(model, rng, size: int, batches: int = 4, batch: int = 16,
             conf: float = 0.35) -> Dict[str, float]:
    from ..models.yolov8 import detect_faces_yolo
    from .common import match_detections
    from .loop import eval_mode

    dev = next(model.parameters()).device
    tp = fp = fn = 0
    kp_err = []
    for _ in range(batches):
        data = sample_batch(rng, batch, size)
        with eval_mode(model), torch.no_grad():
            det = detect_faces_yolo(
                model, torch.from_numpy(data["images"].astype(np.float32))
                .to(dev), torch.ones(batch), conf)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        btp, bfp, bfn, errs = match_detections(
            det["boxes"], det["mask"], data["boxes"], data["gt_mask"],
            iou_thresh=0.5, kps=det["kps"], gt_kps=data["kps"])
        tp += btp
        fp += bfp
        fn += bfn
        kp_err.extend(errs)
    return {"recall": tp / max(tp + fn, 1),
            "precision": tp / max(tp + fp, 1),
            "kps_err": float(np.mean(kp_err)) if kp_err else 9.0}


def setup(cfg_name: str = "yolov8n_face", size: int = 256,
          batch: int = 32, steps: int = 1500, lr: float = 2e-3,
          seed: int = 0, dtype_name: str = "float32",
          device: str = "cuda"):
    """As :func:`.scrfd_synth.setup`, for the keypoint head."""
    from ..models import yolov8 as Y
    from .ckpt import step_rng
    from .loop import Run, TrainState, resolve_device, to_device

    dev = resolve_device(device)
    cfg = Y.CONFIGS[cfg_name]
    if not cfg.kpt_shape[0]:
        raise ValueError(f"{cfg_name} has no keypoint head")
    Y.check_det_size(cfg, size)
    model = init_model(cfg, seed)
    ts = TrainState(model, lr, steps, 1e-4, dev, dtype_name)

    def batch_at(i):
        data = sample_batch(step_rng(seed, i), batch, size)
        targets = build_targets(data["boxes"], data["gt_mask"], size,
                                cfg.strides, cfg.reg_max, kps=data["kps"])
        return to_device(data["images"], dev), to_device(targets, dev)

    return Run(ts, make_loss_fn(model), batch_at)


def train(cfg_name: str = "yolov8n_face", size: int = 256, batch: int = 32,
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
                  f"kps={m['kps']:.4f} npos={m['npos']:.0f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if eval_every and (i + 1) % eval_every == 0:
            ev = evaluate(model, eval_rng, size)
            print(f"  eval: recall={ev['recall']:.3f} "
                  f"precision={ev['precision']:.3f} "
                  f"kps_err={ev['kps_err']:.4f}", flush=True)
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

    ap = argparse.ArgumentParser(prog="yolo_face_synth")
    ap.add_argument("--cfg", default="yolov8n_face")
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
