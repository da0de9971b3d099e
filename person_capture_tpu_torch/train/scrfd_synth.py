"""Train the SCRFD face detector on synthetic scenes (torch).

Counterpart of ``person_capture_tpu/train/scrfd_synth.py``: FCOS/SCRFD-style
anchor-free center-sampled assignment over the 3 FPN levels, focal loss on
the per-anchor sigmoid scores, smooth-L1 on stride-normalized ltrb box
distances and 5-pt landmark offsets — matching the decode semantics the
inference path implements (models/layers.py:distance2bbox/distance2kps).
Target building is the JAX trainer's numpy code unchanged; the loss and
the step are torch (train/loop.py), on the card unless ``--device cpu``.

CLI:
    python -m person_capture_tpu_torch.train.scrfd_synth \
        --cfg scrfd_2.5g --size 256 --batch 32 --steps 1500 \
        --out scrfd_2.5g_synth.npz
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .scenes import sample_batch

LEVEL_HI = (64.0, 128.0, 1e9)  # FCOS ranges on max ltrb distance (pixels)


# ---------------------------------------------------------------- targets

def build_targets(boxes: np.ndarray, kps: np.ndarray, gt_mask: np.ndarray,
                  size: int, strides: Sequence[int] = (8, 16, 32),
                  num_anchors: int = 2, center_radius: float = 1.5
                  ) -> List[Dict[str, np.ndarray]]:
    """Per-level dense targets for a batch of scenes.

    Anchor order matches models/scrfd.decode_level: row-major (y, x) grid,
    ``num_anchors`` consecutive slots per location.

    Returns per level: ``labels [B, L]`` float {0,1}, ``box_t [B, L, 4]``
    ltrb in stride units, ``kps_t [B, L, 10]`` offsets in stride units,
    ``pos [B, L]`` bool — L = (size/s)^2 * num_anchors.
    """
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
        ys, xs = np.meshgrid(np.arange(n) * s, np.arange(n) * s,
                             indexing="ij")
        cx = xs.reshape(-1).astype(np.float32)  # [L0] locations (no anchors)
        cy = ys.reshape(-1).astype(np.float32)
        l = cx[None, :, None] - gx1[:, None, :]          # [B, L0, G]
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
        g_best = cost.argmin(-1)                          # [B, L0]
        pos = cand.any(-1)

        # rescue: a GT whose scale belongs to this level but that captured
        # no location (sub-grid faces / lost argmin) gets its nearest center
        gt_level = (maxdim > lo) & (maxdim <= hi) & gt_mask
        has_pos = np.zeros((b, g), bool)
        bi = np.arange(b)[:, None]
        np.logical_or.at(has_pos, (np.repeat(bi, pos.shape[1], 1)[pos],
                                   g_best[pos]), True)
        need = gt_level & ~has_pos
        if need.any():
            d2 = ((cx[None, :, None] - gcx[:, None, :]) ** 2
                  + (cy[None, :, None] - gcy[:, None, :]) ** 2)
            nearest = d2.argmin(1)                        # [B, G]
            for bb, gg in zip(*np.nonzero(need)):
                loc = nearest[bb, gg]
                pos[bb, loc] = True
                g_best[bb, loc] = gg

        sel = g_best                                      # [B, L0]
        box_t = np.take_along_axis(
            ltrb, sel[:, :, None, None].repeat(4, -1), 2)[:, :, 0] / s
        kp_sel = kps[bi, sel]                             # [B, L0, 5, 2]
        kp_off = (kp_sel - np.stack([cx, cy], -1)[None, :, None, :]) / s
        kps_t = kp_off.reshape(b, -1, 10)

        a = num_anchors
        out.append({
            "labels": np.repeat(pos.astype(np.float32), a, 1),
            "box_t": np.repeat(box_t.astype(np.float32), a, 1),
            "kps_t": np.repeat(kps_t.astype(np.float32), a, 1),
            "pos": np.repeat(pos, a, 1),
        })
    return out


# ----------------------------------------------------------------- losses

def make_loss_fn(model):
    """``loss_fn(images_u8, targets, total_pos=None) -> (loss, aux)`` on
    device tensors, the JAX ``make_loss_fn``'s loss: the raw NCHW maps are
    taken to flax's NHWC ``(h, w, anchor)`` order before they meet the
    targets. ``total_pos``: the positive anchors of a larger batch that
    this one is a part of (the sharded step's global batch), which then
    normalise the loss in place of this batch's own."""
    from ..ops.preprocess import normalize_scrfd
    from .loop import huber_loss, nchw, sigmoid_focal_loss

    def nhwc(t, b, *tail):
        return t.float().permute(0, 2, 3, 1).reshape(b, -1, *tail)

    def loss_fn(images_u8, targets, total_pos=None):
        x = nchw(normalize_scrfd(images_u8.float()))
        levels = model(x)
        if total_pos is None:
            total_pos = sum(t["pos"].sum() for t in targets)
        denom = torch.clamp(torch.as_tensor(total_pos).float(), min=1.0)
        cls_loss = box_loss = kps_loss = 0.0
        for (cls_map, bbox_map, kps_map), t in zip(levels, targets):
            bsz = cls_map.shape[0]
            logits = nhwc(cls_map, bsz)
            dists = nhwc(bbox_map, bsz, 4)
            offs = nhwc(kps_map, bsz, 10)
            cls_loss = cls_loss + sigmoid_focal_loss(
                logits, t["labels"], alpha=0.25, gamma=2.0).sum()
            posf = t["pos"].float()
            box_loss = box_loss + (huber_loss(dists, t["box_t"], 1.0)
                                   .mean(-1) * posf).sum()
            kps_loss = kps_loss + (huber_loss(offs, t["kps_t"], 1.0)
                                   .mean(-1) * posf).sum()
        loss = (cls_loss + 2.0 * box_loss + 0.4 * kps_loss) / denom
        aux = {"cls": cls_loss / denom, "box": box_loss / denom,
               "kps": kps_loss / denom, "npos": total_pos}
        return loss, aux

    return loss_fn


# ------------------------------------------------------------------- eval

def evaluate(model, rng, size: int, batches: int = 4, batch: int = 16,
             score_thresh: float = 0.5,
             iou_thresh: float = 0.5) -> Dict[str, float]:
    """Recall / precision / kps error on held-out scenes."""
    from ..models.scrfd import detect_faces
    from .common import match_detections
    from .loop import eval_mode

    dev = next(model.parameters()).device
    tp = fp = fn = 0
    kp_err: List[float] = []
    for _ in range(batches):
        data = sample_batch(rng, batch, size)
        with eval_mode(model):
            det = detect_faces(
                model, torch.from_numpy(data["images"].astype(np.float32))
                .to(dev), torch.ones(batch), score_thresh)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        btp, bfp, bfn, errs = match_detections(
            det["boxes"], det["mask"], data["boxes"], data["gt_mask"],
            iou_thresh=iou_thresh, kps=det["kps"], gt_kps=data["kps"])
        tp += btp
        fp += bfp
        fn += bfn
        kp_err.extend(errs)
    return {
        "recall": tp / max(tp + fn, 1),
        "precision": tp / max(tp + fp, 1),
        "kps_err": float(np.mean(kp_err)) if kp_err else 9.0,
    }


# ------------------------------------------------------------------ train

def init_model(cfg, seed: int):
    """A fresh SCRFD with flax's initialisers and the class prior of the
    flax head (bias −4.6, ~1 %)."""
    from ..models.scrfd import SCRFD
    from .loop import init_like_flax

    model = init_like_flax(SCRFD(cfg), seed)
    with torch.no_grad():
        model.head.cls.bias.fill_(-4.6)
    return model


def setup(cfg_name: str = "scrfd_2.5g", size: int = 256, batch: int = 32,
          steps: int = 1500, lr: float = 2e-3, seed: int = 0,
          dtype_name: str = "float32", device: str = "cuda"):
    """The model from flax's initialisers, its AdamW state and the batches
    of ``step_rng(seed, i)`` with their targets (:class:`.loop.Run`)."""
    from ..models import scrfd as SD
    from .ckpt import step_rng
    from .loop import Run, TrainState, resolve_device, to_device

    dev = resolve_device(device)
    cfg = SD.CONFIGS[cfg_name]
    SD.check_det_size(cfg, size)
    model = init_model(cfg, seed)
    ts = TrainState(model, lr, steps, 1e-4, dev, dtype_name)

    def batch_at(i):
        data = sample_batch(step_rng(seed, i), batch, size)
        targets = build_targets(data["boxes"], data["kps"], data["gt_mask"],
                                size, cfg.strides, cfg.num_anchors)
        return to_device(data["images"], dev), to_device(targets, dev)

    return Run(ts, make_loss_fn(model), batch_at)


def train(cfg_name: str = "scrfd_2.5g", size: int = 256, batch: int = 32,
          steps: int = 1500, lr: float = 2e-3, seed: int = 0,
          out: str = "", log_every: int = 50, eval_every: int = 250,
          dtype_name: str = "float32", ckpt_dir: str = "",
          ckpt_every: int = 0, device: str = "cuda"
          ) -> Tuple[dict, Dict[str, float]]:
    """Train, checkpoint/resume, evaluate and (with ``out``) write the
    flax-named float16 ``.npz``. Returns ``(variables, final)``: the flax
    variables (numpy float32) and the final eval, with ``ms_per_step``
    (median device time per step after 3 warm-up steps) added."""
    from ..models.bridge import flax_variables
    from .loop import median_ms, save_f16_npz

    run = setup(cfg_name, size, batch, steps, lr, seed, dtype_name, device)
    model = run.state.model
    # checkpoint/resume: the full train state (params + bn stats +
    # optimizer + schedule); the per-step data rng keeps the sample stream
    # identical to the uninterrupted run
    start_step = run.state.resume(ckpt_dir)

    eval_rng = np.random.default_rng(seed + 10_000)
    t0 = time.time()
    for i in range(start_step, steps):
        metrics = run.step(i)
        if (i + 1) % log_every == 0:
            # reading metrics syncs the device; do it rarely
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i + 1}/{steps} loss={m['loss']:.4f} "
                  f"cls={m['cls']:.4f} box={m['box']:.4f} "
                  f"kps={m['kps']:.4f} npos={m['npos']:.0f} "
                  f"({(time.time() - t0):.0f}s)", flush=True)
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

    ap = argparse.ArgumentParser(prog="scrfd_synth")
    ap.add_argument("--cfg", default="scrfd_2.5g")
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
