"""Train the face embedder on synthetic identities (ArcFace margin loss,
torch).

Counterpart of ``person_capture_tpu/train/arcface_synth.py``. Identities
are parameterized renderings (face color, dot color, ellipse aspect); chips
are augmented with shift/scale/rotation/brightness/noise/blur so the
embedding keys on identity factors, not nuisance ones. The margin head is
the additive angular margin on normalized logits; the embedding path is the
production one (models/arcface.encode_chips). The chip renderer is the JAX
trainer's numpy/cv2 code unchanged; the loss and the step are torch.

CLI:
    python -m person_capture_tpu_torch.train.arcface_synth \
        --cfg arcface_synth --steps 1500 --out arcface_synth.npz
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

CHIP = 112


def make_identities(rng, n: int) -> Dict[str, np.ndarray]:
    """Identity factor table: face color, dot color, aspect."""
    colors = rng.integers(40, 256, (n, 3))
    keep = colors.sum(1) >= 220
    colors[~keep] += 60
    return {
        "color": np.clip(colors, 0, 255).astype(np.int32),
        "dot": rng.integers(0, 60, (n, 3)).astype(np.int32),
        "aspect": rng.uniform(0.85, 1.2, n).astype(np.float32),
    }


def render_chip(rng, ident: Dict[str, np.ndarray], idx: int) -> np.ndarray:
    """One augmented 112×112 BGR chip of identity ``idx``."""
    from .scenes import kps_from_box

    img = np.full((CHIP, CHIP, 3), int(rng.integers(15, 110)), np.uint8)
    img += rng.integers(0, 16, (CHIP, CHIP, 3), dtype=np.uint8)
    s = float(rng.uniform(0.70, 1.00)) * CHIP
    cx = CHIP / 2 + float(rng.uniform(-6, 6))
    cy = CHIP / 2 + float(rng.uniform(-6, 6))
    a = float(ident["aspect"][idx])
    fw, fh = s, s * a
    box = np.array([cx - fw / 2, cy - fh / 2, cx + fw / 2, cy + fh / 2],
                   np.float32)
    color = tuple(int(v) for v in ident["color"][idx])
    dot = tuple(int(v) for v in ident["dot"][idx])
    x1, y1, x2, y2 = (int(round(v)) for v in box)
    ax, ay = max(2, (x2 - x1) // 2), max(2, (y2 - y1) // 2)
    cv2.ellipse(img, (int(cx), int(cy)), (ax, ay), 0, 0, 360, color, -1)
    for px, py in kps_from_box(box):
        cv2.circle(img, (int(px), int(py)), max(1, ax // 8), dot, -1)
    # nuisance augmentation
    if rng.random() < 0.5:
        ang = float(rng.uniform(-12, 12))
        m = cv2.getRotationMatrix2D((CHIP / 2, CHIP / 2), ang, 1.0)
        img = cv2.warpAffine(img, m, (CHIP, CHIP),
                             borderMode=cv2.BORDER_REFLECT)
    if rng.random() < 0.4:
        img = cv2.GaussianBlur(img, (3, 3), 0)
    gain = float(rng.uniform(0.7, 1.3))
    bias = float(rng.uniform(-20, 20))
    img = np.clip(img.astype(np.float32) * gain + bias, 0, 255)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def sample_chip_batch(rng, ident, batch: int):
    n = len(ident["aspect"])
    labels = rng.integers(0, n, batch)
    chips = np.stack([render_chip(rng, ident, int(k)) for k in labels])
    return chips, labels.astype(np.int32)



def make_loss_fn(model, num_classes: int, margin: float = 0.3,
                 scale: float = 24.0):
    """``loss_fn(wclass, chips_u8, labels) -> (loss, aux)``: the loss of
    the JAX ``make_train_step``, softmax cross entropy over the margin
    logits of the normalized embeddings against ``wclass``."""
    from ..ops.preprocess import normalize_arcface
    from .loop import margin_logits, nchw, softmax_cross_entropy

    def loss_fn(wclass, chips_u8, labels):
        emb = model(nchw(normalize_arcface(chips_u8.float())))
        logits, onehot = margin_logits(emb, wclass, labels, num_classes,
                                       margin, scale)
        loss = softmax_cross_entropy(logits, onehot).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"acc": acc}

    return loss_fn


def evaluate(model, rng, n_ident: int = 24,
             chips_per: int = 6) -> Dict[str, float]:
    """Intra vs inter identity cosine separation on held-out identities."""
    from ..models.arcface import encode_chips
    from .loop import eval_mode

    dev = next(model.parameters()).device
    ident = make_identities(rng, n_ident)
    feats = []
    for i in range(n_ident):
        chips = np.stack([render_chip(rng, ident, i)
                          for _ in range(chips_per)])
        with eval_mode(model):
            feats.append(encode_chips(model, torch.from_numpy(chips).to(dev),
                                      flip_tta=False).cpu().numpy())
    return separation(feats, chips_per, "fd_threshold")


def separation(feats, per: int, threshold_name: str) -> Dict[str, float]:
    """Intra/inter cosine means and the equal-error threshold on cosine
    DISTANCE (1 - cos), as the pipeline's fd/rd, over per-identity
    embedding blocks."""
    n_ident = len(feats)
    intra, inter = [], []
    for i in range(n_ident):
        f = feats[i]
        sims = f @ f.T
        iu = np.triu_indices(per, 1)
        intra.extend(sims[iu].tolist())
        for j in range(i + 1, n_ident):
            inter.extend((f @ feats[j].T).reshape(-1).tolist())
    intra = np.asarray(intra)
    inter = np.asarray(inter)
    thresholds = np.linspace(0.0, 1.0, 201)
    best_t, best_err = 0.5, 1.0
    for t in thresholds:
        far = float((1.0 - inter <= t).mean())   # impostors accepted
        frr = float((1.0 - intra > t).mean())    # genuine rejected
        err = max(far, frr)
        if err < best_err:
            best_err, best_t = err, float(t)
    return {"intra_cos": float(intra.mean()),
            "inter_cos": float(inter.mean()),
            "eer": best_err, threshold_name: best_t}


def init_wclass(rng, num_ident: int, embed_dim: int) -> np.ndarray:
    """The class centres the JAX trainer draws, after the identities."""
    return (rng.normal(size=(num_ident, embed_dim)) * 0.05
            ).astype(np.float32)


def setup(cfg_name: str = "arcface_synth", batch: int = 48,
          steps: int = 1500, lr: float = 1e-3, seed: int = 0,
          num_ident: int = 256, dtype_name: str = "float32",
          device: str = "cuda"):
    """As :func:`.scrfd_synth.setup`: the iResNet, the identity table and
    ``wclass`` drawn as the JAX trainer draws them, and chip batches."""
    from ..models import arcface as AF
    from .ckpt import step_rng
    from .loop import Run, TrainState, init_like_flax, resolve_device, \
        to_device

    dev = resolve_device(device)
    cfg = AF.CONFIGS[cfg_name]
    model = init_like_flax(AF.IResNet(cfg), seed)
    rng = np.random.default_rng(seed)
    ident = make_identities(rng, num_ident)
    ts = TrainState(model, lr, steps, 5e-5, dev, dtype_name,
                    extra={"wclass": init_wclass(rng, num_ident,
                                                 cfg.embed_dim)})

    def batch_at(i):
        chips, labels = sample_chip_batch(step_rng(seed, i), ident, batch)
        return (ts.extra["wclass"], to_device(chips, dev),
                to_device(labels, dev))

    return Run(ts, make_loss_fn(model, num_ident), batch_at)


def train(cfg_name: str = "arcface_synth", batch: int = 48,
          steps: int = 1500, lr: float = 1e-3, seed: int = 0,
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

    ap = argparse.ArgumentParser(prog="arcface_synth")
    ap.add_argument("--cfg", default="arcface_synth")
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--idents", type=int, default=256)
    add_common_flags(ap, steps=1500, lr=1e-3)
    args = ap.parse_args(argv)
    train(args.cfg, args.batch, args.steps, args.lr, args.seed,
          args.idents, args.out, dtype_name=args.dtype,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
