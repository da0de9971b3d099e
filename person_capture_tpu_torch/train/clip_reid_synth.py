"""Train the CLIP ReID tower on synthetic person identities (torch).

Counterpart of ``person_capture_tpu/train/clip_reid_synth.py``: a compact
tower trained on synthetic persons (video/synthetic.py:draw_person schema:
torso + legs + face head), where identity = clothing/leg/face colors and
body build, and the nuisance factors are crop framing, scale, partial
visibility, brightness, noise, blur and occlusion. The margin-softmax head
mirrors train/arcface_synth.py; evaluation is verification on HELD-OUT
identities. The crop renderer is the JAX trainer's numpy/cv2 code
unchanged; the loss and the step are torch.

CLI:
    python -m person_capture_tpu_torch.train.clip_reid_synth \
        --steps 1200 --out clip_reid_s_synth.npz
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def make_identities(rng, n: int) -> Dict[str, np.ndarray]:
    """Identity factor table for schematic persons."""
    return {
        "clothing": rng.integers(40, 220, (n, 3)).astype(np.int32),
        "leg_drop": rng.integers(30, 90, n).astype(np.int32),
        "face": np.clip(rng.integers(40, 256, (n, 3)) + 30, 0,
                        255).astype(np.int32),
        "build": rng.uniform(0.25, 0.45, n).astype(np.float32),  # torso pad
        "torso_len": rng.uniform(2.0, 2.8, n).astype(np.float32),
    }


def render_person_crop(rng, ident: Dict[str, np.ndarray], idx: int,
                       size: int) -> np.ndarray:
    """One augmented person crop, preprocessed exactly like the production
    path (shortest side → ``size``, center crop — ClipReidBackend.extract)."""
    fw = float(rng.uniform(14, 26))
    fh = fw * float(rng.uniform(0.9, 1.15))
    build = float(ident["build"][idx])
    tlen = float(ident["torso_len"][idx])
    # canvas big enough for head + torso + legs with jittered margins
    ph = int(fh * (1.0 + tlen + 1.9) + rng.uniform(8, 26))
    pw = int(fw * (1.0 + 2 * build) + rng.uniform(10, 28))
    img = np.full((ph, pw, 3), int(rng.integers(15, 115)), np.uint8)
    img += rng.integers(0, 16, (ph, pw, 3), dtype=np.uint8)

    x1 = pw / 2 - fw / 2 + float(rng.uniform(-3, 3))
    y1 = float(rng.uniform(1, 6))
    x2, y2 = x1 + fw, y1 + fh
    clothing = tuple(int(v) for v in ident["clothing"][idx])
    drop = int(ident["leg_drop"][idx])
    dark = tuple(max(0, c - drop) for c in clothing)
    # torso + legs (video/synthetic.py:draw_person geometry, identity build)
    tx1, ty1 = int(x1 - build * fw), int(y2)
    tx2, ty2 = int(x2 + build * fw), int(min(ph, y2 + tlen * fh))
    cv2.rectangle(img, (tx1, ty1), (tx2, ty2), clothing, -1)
    ly2 = int(min(ph, y2 + (tlen + 1.8) * fh))
    mid = (tx1 + tx2) // 2
    cv2.rectangle(img, (tx1 + 1, ty2), (mid - 1, ly2), dark, -1)
    cv2.rectangle(img, (mid + 1, ty2), (tx2 - 1, ly2), dark, -1)
    # face head
    face = tuple(int(v) for v in ident["face"][idx])
    cx, cy = int((x1 + x2) / 2), int((y1 + y2) / 2)
    cv2.ellipse(img, (cx, cy), (max(2, int(fw / 2)), max(2, int(fh / 2))),
                0, 0, 360, face, -1)

    # nuisance: framing jitter (sloppy person boxes), partial visibility
    jy0 = int(rng.uniform(0, 0.12) * ph)
    jy1 = ph - int(rng.uniform(0, 0.25) * ph)
    jx0 = int(rng.uniform(0, 0.15) * pw)
    jx1 = pw - int(rng.uniform(0, 0.15) * pw)
    img = img[jy0:max(jy0 + 24, jy1), jx0:max(jx0 + 16, jx1)]
    if rng.random() < 0.25:  # occluder
        h, w = img.shape[:2]
        ox, oy = int(rng.integers(0, w)), int(rng.integers(0, h))
        s = int(rng.integers(4, max(6, w // 3)))
        cv2.rectangle(img, (ox, oy), (ox + s, oy + s),
                      tuple(int(v) for v in rng.integers(0, 256, 3)), -1)
    gain = float(rng.uniform(0.7, 1.3))
    bias = float(rng.uniform(-18, 18))
    img = np.clip(img.astype(np.float32) * gain + bias, 0, 255)
    img += rng.normal(0, 4, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if rng.random() < 0.3:
        img = cv2.GaussianBlur(img, (3, 3), 0)

    # production ingest: shortest side → size, center crop (backends.py)
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nw, nh = max(size, int(w * scale)), max(size, int(h * scale))
    img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC)
    y0 = int(round((nh - size) / 2.0))
    x0 = int(round((nw - size) / 2.0))
    return img[y0:y0 + size, x0:x0 + size]


def sample_crop_batch(rng, ident, batch: int, size: int):
    n = len(ident["build"])
    labels = rng.integers(0, n, batch)
    crops = np.stack([render_person_crop(rng, ident, int(k), size)
                      for k in labels])
    return crops, labels.astype(np.int32)



def make_loss_fn(model, num_classes: int, margin: float = 0.25,
                 scale: float = 20.0):
    """``loss_fn(wclass, crops_u8, labels) -> (loss, aux)``: the loss of
    the JAX ``make_train_step``."""
    from ..ops.preprocess import normalize_clip
    from .loop import margin_logits, nchw, softmax_cross_entropy

    def loss_fn(wclass, crops_u8, labels):
        # an NHWC view of contiguous NCHW memory: the tower's patch conv
        # then runs on contiguous NCHW (train/loop.nchw)
        x = nchw(normalize_clip(crops_u8.float())).permute(0, 2, 3, 1)
        logits, onehot = margin_logits(model(x), wclass, labels,
                                       num_classes, margin, scale)
        loss = softmax_cross_entropy(logits, onehot).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"acc": acc}

    return loss_fn


def evaluate(model, rng, n_ident: int = 20,
             crops_per: int = 6) -> Dict[str, float]:
    """Verification on held-out identities: intra/inter cosine separation
    and the equal-error threshold on cosine DISTANCE (the pipeline's rd)."""
    from ..models.clip_vit import encode_images
    from .arcface_synth import separation

    dev = next(model.parameters()).device
    size = model.cfg.image_size
    ident = make_identities(rng, n_ident)
    feats = []
    for i in range(n_ident):
        crops = np.stack([render_person_crop(rng, ident, i, size)
                          for _ in range(crops_per)])
        feats.append(encode_images(model, torch.from_numpy(crops).to(dev))
                     .cpu().numpy())
    return separation(feats, crops_per, "rd_threshold")


def setup(cfg_name: str = "clip_reid_s", batch: int = 48,
          steps: int = 1200, lr: float = 1e-3, seed: int = 0,
          num_ident: int = 256, dtype_name: str = "float32",
          device: str = "cuda"):
    """As :func:`.arcface_synth.setup`, for the CLIP tower on person
    crops."""
    from ..models import clip_vit as CV
    from .arcface_synth import init_wclass
    from .ckpt import step_rng
    from .loop import Run, TrainState, resolve_device, to_device

    dev = resolve_device(device)
    cfg = CV.CONFIGS[cfg_name]
    model = CV.random_init(CV.ClipViT(cfg),
                           torch.Generator().manual_seed(int(seed)))
    rng = np.random.default_rng(seed)
    ident = make_identities(rng, num_ident)
    ts = TrainState(model, lr, steps, 5e-5, dev, dtype_name,
                    extra={"wclass": init_wclass(rng, num_ident,
                                                 cfg.embed_dim)})

    def batch_at(i):
        crops, labels = sample_crop_batch(step_rng(seed, i), ident, batch,
                                          cfg.image_size)
        return (ts.extra["wclass"], to_device(crops, dev),
                to_device(labels, dev))

    return Run(ts, make_loss_fn(model, num_ident), batch_at)


def train(cfg_name: str = "clip_reid_s", batch: int = 48,
          steps: int = 1200, lr: float = 1e-3, seed: int = 0,
          num_ident: int = 256, out: str = "", log_every: int = 50,
          eval_every: int = 300, dtype_name: str = "float32",
          ckpt_dir: str = "", ckpt_every: int = 0, device: str = "cuda"):
    """As :func:`.scrfd_synth.train`: returns ``(variables, final)``."""
    from ..models.bridge import flax_variables
    from .loop import median_ms, save_f16_npz

    run = setup(cfg_name, batch, steps, lr, seed, num_ident, dtype_name,
                device)
    model = run.state.model
    start_step = run.state.resume(ckpt_dir)

    eval_rng = np.random.default_rng(seed + 77)
    t0 = time.time()
    for i in range(start_step, steps):
        metrics = run.step(i)
        if (i + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i + 1}/{steps} loss={m['loss']:.4f} "
                  f"acc={m['acc']:.3f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if eval_every and (i + 1) % eval_every == 0:
            print(f"  eval: {evaluate(model, eval_rng)}", flush=True)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            run.state.save(ckpt_dir, i + 1)

    step_ms = run.state.step_ms()
    final = evaluate(model, eval_rng)
    print(f"final eval: {final}", flush=True)
    final["ms_per_step"] = median_ms(step_ms)
    variables = flax_variables(model)
    if out:
        save_f16_npz(out, variables)
    return variables, final


def main(argv=None) -> int:
    from .loop import add_common_flags

    ap = argparse.ArgumentParser(prog="clip_reid_synth")
    ap.add_argument("--cfg", default="clip_reid_s")
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--idents", type=int, default=256)
    add_common_flags(ap, steps=1200, lr=1e-3)
    args = ap.parse_args(argv)
    train(args.cfg, args.batch, args.steps, args.lr, args.seed,
          args.idents, args.out, dtype_name=args.dtype,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
