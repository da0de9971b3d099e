"""What the five torch trainers share: optax's losses and schedule, flax's
default initialisers, and the train state (AdamW, schedule, checkpoints,
step timing).

The JAX trainers build one jitted step from ``optax.adamw`` over
``warmup_cosine_decay_schedule`` and the flax module's ``apply``; the
definitions here hold the torch step to the same numbers:

* ``optax.adamw`` is torch's ``AdamW``: both decay every parameter (BN and
  GN scale and bias, PReLU alpha, ``wclass``) by ``lr·wd·p`` from the
  parameter before the update, and divide the bias-corrected first moment
  by ``sqrt(v̂) + eps``;
* the schedule is a ``LambdaLR`` whose factor at count ``c`` is
  :func:`warmup_cosine` at ``c`` over the peak: count 0 (the first update)
  has lr 0, as optax's;
* ``--dtype bfloat16`` computes in bf16 under ``torch.autocast`` with fp32
  parameters, as flax's ``dtype=`` does; losses are taken in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------------ device


def resolve_device(name: str = "cuda") -> torch.device:
    """``cuda`` (the default) or ``cpu``; ``cuda`` without a card raises:
    a trainer never moves to the CPU unasked."""
    name = str(name or "cuda").lower()
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: the trainers run on 'cuda' or "
                         f"'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    return torch.device(name)


def add_common_flags(ap, steps: int, lr: float) -> None:
    """The flags every trainer's ``main`` shares with its JAX counterpart;
    ``--device`` stands where the JAX trainers have ``--platform``."""
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--lr", type=float, default=lr)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) "
                         "or on the CPU")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint dir; resumes automatically from the "
                         "latest step when present")
    ap.add_argument("--ckpt-every", type=int, default=250)


# ------------------------------------------------------------ optax parts


def warmup_cosine(count: int, peak: float, steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps=
    min(100, steps // 10 + 1), decay_steps=steps, end_value=0.02·peak)``
    at update ``count`` (0 for the first update)."""
    warmup = min(100, steps // 10 + 1)
    if count < warmup:
        return peak * count / warmup
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"{steps} steps leave no decay after {warmup} "
                         f"warm-up steps")
    t = min(count - warmup, decay)
    alpha = 0.02
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay))
                   + alpha)


def sigmoid_binary_cross_entropy(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * \
        F.logsigmoid(-logits)


def sigmoid_focal_loss(logits, labels, alpha: Optional[float] = None,
                       gamma: float = 2.0):
    """``optax.sigmoid_focal_loss``, with its log-space focal weight:
    ``exp(γ · log((1−y)·p + y·(1−p)))`` through a weighted logsumexp whose
    max ignores zero weights, as ``jax.scipy.special.logsumexp``'s."""
    labels = labels.to(logits.dtype)
    ce = sigmoid_binary_cross_entropy(logits, labels)
    a = torch.stack([F.logsigmoid(logits), F.logsigmoid(-logits)], -1)
    b = torch.stack([1 - labels, labels], -1)
    amax = torch.where(b != 0, a, torch.full_like(a, -math.inf)) \
        .amax(-1, keepdim=True).detach()
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    log_1m_pt = torch.log((b * torch.exp(a - amax)).sum(-1).abs()) + \
        amax[..., 0]
    loss = ce * torch.exp(gamma * log_1m_pt)
    if alpha is None:
        return loss
    return (alpha * labels + (1.0 - alpha) * (1.0 - labels)) * loss


def huber_loss(predictions, targets, delta: float = 1.0):
    """``optax.huber_loss``: 0.5·x² inside δ, δ·(|x| − δ/2) outside."""
    abs_errors = (predictions - targets).abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_errors - quadratic)


def softmax_cross_entropy(logits, onehot):
    """``optax.softmax_cross_entropy``."""
    return -(onehot * torch.log_softmax(logits, -1)).sum(-1)


def dfl_loss(box_logits, target, reg_max: int):
    """Distribution focal loss: CE toward the two bins bracketing the
    continuous ltrb target (per side); ``box_logits [N, 4, reg_max]``,
    ``target [N, 4]`` in ``[0, reg_max − 1)``."""
    tl = torch.floor(target)
    wl = tl + 1.0 - target
    wr = target - tl
    logp = torch.log_softmax(box_logits, -1)
    il = tl.long()
    ir = torch.clamp(il + 1, max=reg_max - 1)
    ll = torch.gather(logp, -1, il[..., None])[..., 0]
    lr = torch.gather(logp, -1, ir[..., None])[..., 0]
    return -(wl * ll + wr * lr).mean(-1)


def margin_logits(emb, wclass, labels, num_classes: int, margin: float,
                  scale: float):
    """The ArcFace additive-angular-margin logits of the JAX trainers:
    normalised embeddings against normalised class centres, ``cos(θ + m)``
    on the true class. Returns ``(logits, onehot)``."""
    emb = emb.float()
    emb = emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                            min=1e-10)
    w = wclass / torch.clamp(torch.linalg.norm(wclass, dim=-1, keepdim=True),
                             min=1e-10)
    cos = emb @ w.T
    theta = torch.arccos(torch.clamp(cos, -1 + 1e-6, 1 - 1e-6))
    onehot = F.one_hot(labels.long(), num_classes).float()
    logits = scale * torch.where(onehot > 0, torch.cos(theta + margin), cos)
    return logits, onehot


def nchw(x):
    """NHWC → contiguous NCHW for a training forward (the backward of a
    CPU convolution over a channels-last view aborts the process in the
    torch 2.13 CPU build)."""
    return x.permute(0, 3, 1, 2).contiguous()


# ------------------------------------------------------------ flax's init


def init_like_flax(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Weights drawn from a seeded generator with flax's default
    initialisers: LeCun-normal kernels (truncated at ±2σ, variance
    1/fan-in), zero biases, unit norm scales, PReLU alpha 0.25. (The JAX
    package draws other numbers from its PRNG key.)"""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() > 1:
                std = (1.0 / p[0].numel()) ** 0.5 / .87962566103423978
                p.copy_(torch.nn.init.trunc_normal_(
                    torch.empty(p.shape), std=std, a=-2 * std, b=2 * std,
                    generator=g))
            elif leaf == "bias":
                p.zero_()
            elif leaf == "alpha":
                p.fill_(0.25)
            else:
                p.fill_(1.0)
    return model


# ------------------------------------------------------------ train state


def to_device(obj, device: torch.device):
    """numpy arrays (nested in lists and dicts) → tensors on ``device``,
    through pinned memory on the card so the copy does not block the
    host."""
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    t = torch.from_numpy(np.ascontiguousarray(obj))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class TrainState:
    """A model and its extra tensors (``wclass``) under AdamW and the
    warm-up cosine schedule; :meth:`step` runs one update from a loss
    function, :meth:`save`/:meth:`resume` checkpoint the whole state, and
    the device time between the starts of consecutive steps is kept for
    :meth:`step_ms`."""

    def __init__(self, model: torch.nn.Module, lr: float, steps: int,
                 weight_decay: float, device: torch.device,
                 dtype_name: str = "float32",
                 extra: Optional[Dict[str, torch.Tensor]] = None):
        self.model = model.to(device).train()
        self.device = device
        self.extra = {k: torch.nn.Parameter(torch.as_tensor(
            v, dtype=torch.float32).to(device)) for k, v in
            (extra or {}).items()}
        params = list(self.model.parameters()) + list(self.extra.values())
        self.opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda c: warmup_cosine(c, lr, steps) / lr)
        self.bf16 = dtype_name == "bfloat16"
        self._marks = []

    def autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.bf16)

    def step(self, loss_fn, *args) -> Dict[str, torch.Tensor]:
        """One update: ``loss_fn(*args) -> (loss, metrics)`` forward under
        the compute dtype, backward, AdamW, schedule. Returns the metrics
        with ``loss`` as device tensors (reading them syncs)."""
        self._mark()
        self.opt.zero_grad(set_to_none=True)
        with self.autocast():
            loss, metrics = loss_fn(*args)
        loss.backward()
        self.opt.step()
        self.sched.step()
        return {"loss": loss.detach(),
                **{k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}}

    def _mark(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def step_ms(self) -> list:
        """Milliseconds between the starts of consecutive steps, on the
        card's clock (events recorded on the stream as each step starts),
        so the host's batch making counts where the card waits for it."""
        self._mark()
        marks = self._marks
        if self.device.type == "cuda":
            marks[-1].synchronize()
            out = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            out = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        marks.pop()
        return out

    # ---- checkpoints ----------------------------------------------------
    def state(self) -> dict:
        return {"model": self.model.state_dict(),
                "opt": self.opt.state_dict(),
                "sched": self.sched.state_dict(),
                "extra": {k: v.detach() for k, v in self.extra.items()}}

    def save(self, ckpt_dir: str, step: int) -> str:
        from .ckpt import save_checkpoint

        return save_checkpoint(ckpt_dir, step, self.state())

    def resume(self, ckpt_dir: str) -> int:
        """Restore the latest checkpoint in ``ckpt_dir`` (if any) and
        return the step to continue from."""
        from .ckpt import latest_checkpoint, restore_checkpoint

        latest = latest_checkpoint(ckpt_dir) if ckpt_dir else None
        if latest is None:
            return 0
        ck_step, ck_path = latest
        st = restore_checkpoint(ck_path, self.state(),
                                map_location=self.device)
        self.model.load_state_dict(st["model"])
        with torch.no_grad():
            for k, v in st["extra"].items():
                self.extra[k].copy_(v)
        self.opt.load_state_dict(st["opt"])
        self.sched.load_state_dict(st["sched"])
        # the next update's lr from this run's schedule at the restored
        # count, as optax reads it (the run may have more steps in all)
        for group, base, lam in zip(self.opt.param_groups,
                                    self.sched.base_lrs,
                                    self.sched.lr_lambdas):
            group["lr"] = base * lam(self.sched.last_epoch)
        print(f"resumed from {ck_path} (step {ck_step})", flush=True)
        return ck_step


@dataclasses.dataclass
class Run:
    """A trainer set up for steps: its train state, its loss function and
    ``batch(i)``, step ``i``'s loss arguments on the device (from
    ``step_rng(seed, i)``)."""
    state: TrainState
    loss_fn: Callable
    batch: Callable[[int], tuple]

    def step(self, i: int) -> Dict[str, torch.Tensor]:
        return self.state.step(self.loss_fn, *self.batch(i))


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """``model.eval()`` inside the block, back to training after."""
    model.eval()
    try:
        yield model
    finally:
        model.train()


def median_ms(step_ms: Iterable[float], warmup: int = 3) -> float:
    """Median of the per-step times after ``warmup`` steps (all of them
    when there are no more)."""
    ms = list(step_ms)
    return float(statistics.median(ms[warmup:] or ms)) if ms else 0.0


def save_f16_npz(out: str, variables: dict) -> None:
    """``variables`` (flax layout) as the JAX trainers write them: every
    float32 leaf as float16, the rest as is."""
    from ..tools.weights import flatten_tree, save_npz_variables, \
        unflatten_tree

    flat = {k: (v.astype(np.float16) if v.dtype == np.float32 else v)
            for k, v in flatten_tree(variables).items()}
    save_npz_variables(out, unflatten_tree(flat))
    print(f"saved {out}")
