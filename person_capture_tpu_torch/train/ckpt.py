"""Training checkpoint/resume for the in-repo trainers.

Counterpart of ``person_capture_tpu/train/ckpt.py`` with the same names and
retention (the latest two). Each checkpoint is a ``step_%08d`` directory
holding one ``state.pt``: the model's ``state_dict``, the optimizer's and
the scheduler's, and any extra tensor of the train state (ArcFace's
``wclass``), written with ``torch.save`` to a temporary name and renamed
once complete, so an interrupted save leaves no half-written entry.

Data-stream alignment on resume is the trainer's job: trainers seed a
PER-STEP rng (``step_rng``) so the sample stream is stateless and a
resumed run consumes exactly the batches the interrupted run would have.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional, Tuple

import numpy as np

_STATE = "state.pt"


def step_rng(seed: int, step: int) -> np.random.Generator:
    """Stateless per-step data rng: resume at step k sees the same batch
    the uninterrupted run saw at step k."""
    return np.random.default_rng((int(seed) + 1) * 1_000_003 + int(step))


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Write the full train state (a dict of ``state_dict``s and tensors)
    for ``step``; keeps the latest two."""
    import torch

    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    for _old_step, old_path in list_checkpoints(ckpt_dir)[:-2]:
        shutil.rmtree(old_path, ignore_errors=True)
    return path


def list_checkpoints(ckpt_dir: str):
    """[(step, path)] ascending; only completed checkpoints."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        p = os.path.join(ckpt_dir, name)
        if m and os.path.isfile(os.path.join(p, _STATE)):
            out.append((int(m.group(1)), p))
    out.sort()
    return out


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    cks = list_checkpoints(ckpt_dir)
    return cks[-1] if cks else None


def restore_checkpoint(path: str, template_state=None, map_location=None):
    """Read the train state written by :func:`save_checkpoint`. The
    caller loads each ``state_dict`` into its fresh-init counterpart
    (``template_state``, when given, names the keys that must be there)."""
    import torch

    state = torch.load(os.path.join(os.path.abspath(path), _STATE),
                       map_location=map_location, weights_only=True)
    missing = sorted(set(template_state or ()) - set(state))
    if missing:
        raise KeyError(f"checkpoint {path!r} lacks {missing}")
    return state
