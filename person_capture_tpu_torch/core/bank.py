"""Streaming reference-bank of identity embeddings.

The bank is a fixed-capacity set of L2-normalized 512-D ArcFace vectors.
Slot 0 is the anchor (first user-provided reference). New candidate vectors
are deduped against the bank, then admitted by a weighted score of
anchor-closeness, diversity and chip quality; once full, a candidate replaces
the worst-scoring member only if it beats it by a margin.

Behavior-compatible with the reference ``_stream_ref_bank_update``
(person_capture/gui_app.py:922-986) and ``_fd_min`` (gui_app.py:661-676).
On-device, the pre-scan program consumes the bank as a padded ``[cap, D]``
matrix + valid mask so distance-vs-bank is one masked matmul.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

FD_NONE = 9.0


def fd_min(feat: Optional[np.ndarray], bank: Optional[np.ndarray]) -> float:
    """Min cosine distance of ``feat`` vs every bank row (9.0 if either side
    is missing)."""
    if feat is None or bank is None:
        return FD_NONE
    v = np.asarray(feat, dtype=np.float32).reshape(-1)
    v = v / max(float(np.linalg.norm(v)), 1e-6)
    b = np.asarray(bank, dtype=np.float32)
    if b.ndim == 1:
        return 1.0 - float(np.dot(v, b))
    if b.size == 0:
        return FD_NONE
    sims = b @ v
    if sims.size == 0:
        return FD_NONE
    return 1.0 - float(np.max(sims))


@dataclass
class RefBank:
    cap: int = 64
    dedup_cos: float = 0.968
    replace_margin: float = 0.010
    weights: Tuple[float, float, float] = (0.70, 0.25, 0.05)  # anchor, div, quality
    vectors: List[np.ndarray] = field(default_factory=list)
    # embedding width used by padded() BEFORE any vector is seeded; the
    # bundled synthetic ArcFace is 256-D while real w600k/glintr100
    # checkpoints are 512-D, so callers warming a jitted program against an
    # empty bank must set this to their backend's embed_dim
    dim: Optional[int] = None
    # cached matrix() view — fd() runs once per detected face in the
    # prescan replay loop, and rebuilding a [cap, D] vstack per face costs
    # more host time than the distance itself
    _mat: Optional[np.ndarray] = field(default=None, repr=False, compare=False)

    # -- views ----------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.vectors)

    def matrix(self) -> Optional[np.ndarray]:
        if not self.vectors:
            return None
        if self._mat is None or self._mat.shape[0] != len(self.vectors):
            self._mat = np.vstack(self.vectors).astype(np.float32)
        return self._mat

    def padded(self, cap: Optional[int] = None,
               dim: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-shape device view: ``([cap, D] float32, [cap] bool mask)``.
        Rows beyond ``size`` are zero (cos sim 0 → fd 1, never a best match
        thanks to the mask). D comes from the seeded vectors, else ``dim`` /
        ``self.dim`` (512 only as a last-resort classic-ArcFace default —
        wrong for the bundled 256-D synthetic embedder, so set ``dim``)."""
        cap = int(cap or self.cap)
        if self.vectors:
            d = self.vectors[0].shape[-1]
        else:
            d = int(dim or self.dim or 512)
        out = np.zeros((cap, d), np.float32)
        mask = np.zeros((cap,), bool)
        n = min(cap, len(self.vectors))
        if n:
            out[:n] = np.vstack(self.vectors[:n])
            mask[:n] = True
        return out, mask

    # -- updates ---------------------------------------------------------
    def seed(self, vecs) -> int:
        """Add initial reference vectors (normalized), skipping zero-norm."""
        added = 0
        for v in np.atleast_2d(np.asarray(vecs, dtype=np.float32)):
            n = float(np.linalg.norm(v))
            if n > 1e-6 and len(self.vectors) < self.cap:
                self.vectors.append((v / n).astype(np.float32))
                added += 1
        if added:
            self._mat = None
        return added

    def fd(self, feat: Optional[np.ndarray]) -> float:
        return fd_min(feat, self.matrix())

    def update(self, vec_new: Optional[np.ndarray],
               quality_val: float = 0.0) -> Tuple[str, Optional[int]]:
        """Offer a candidate. Returns (action, replaced_index) where action is
        one of 'added' | 'replaced' | 'dup' | 'skip'."""
        if vec_new is None:
            return "skip", None
        v = np.asarray(vec_new, dtype=np.float32).reshape(-1)
        norm = float(np.linalg.norm(v))
        if norm <= 1e-6:
            return "skip", None
        v = v / norm

        if not self.vectors:
            self.vectors.append(v)
            self._mat = None
            return "added", None

        bank = self.matrix()
        sims = bank @ v
        if float(sims.max()) >= self.dedup_cos:
            return "dup", None

        w_anchor, w_div, w_q = self.weights
        anchor = bank[0]
        cos_anchor = float(np.clip(np.dot(anchor, v), -1.0, 1.0))
        # L2 distance between unit vectors, not cosine distance
        fd_anchor = float(np.sqrt(max(0.0, 2.0 - 2.0 * cos_anchor)))
        nn_sim = float(sims.max())
        q_term = float(min(max(quality_val or 0.0, 0.0), 1000.0) / 300.0)
        s_new = w_anchor * (1.0 - fd_anchor) + w_div * (1.0 - nn_sim) + w_q * q_term

        if len(self.vectors) < self.cap:
            self.vectors.append(v)
            self._mat = None
            return "added", None

        # replacement: score existing members without the quality term
        bank_sims = bank @ bank.T
        np.fill_diagonal(bank_sims, -1.0)
        nn_sim_each = bank_sims.max(axis=1)
        cos_anchor_each = np.clip(bank @ anchor, -1.0, 1.0)
        fd_anchor_each = np.sqrt(np.maximum(0.0, 2.0 - 2.0 * cos_anchor_each))
        s_bank = w_anchor * (1.0 - fd_anchor_each) + w_div * (1.0 - nn_sim_each)
        worst = int(np.argmin(s_bank))
        if s_new > float(s_bank[worst]) + self.replace_margin:
            self.vectors[worst] = v
            self._mat = None
            return "replaced", worst
        return "skip", None



def fd_min_batch(feats, feat_mask, bank, bank_mask):
    """Batched masked fd-vs-bank on the device (``fd_min_batch_jnp`` of the
    JAX package).

    Args:
      feats:     ``[B, F, D]`` face embeddings (unnormalized OK).
      feat_mask: ``[B, F]`` bool — which face slots are real.
      bank:      ``[K, D]`` bank matrix (padded), rows L2-normalized.
      bank_mask: ``[K]`` bool — which bank rows are real.
    Returns:
      (per_face_fd ``[B, F]``, best_fd ``[B]``) float32 with FD_NONE
      sentinels for masked entries, matching host :func:`fd_min` semantics.
    """
    import torch

    f = feats.float()
    f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-6)
    sims = torch.einsum("bfd,kd->bfk", f, bank.float())
    sims = torch.where(bank_mask[None, None, :], sims,
                       torch.full((), -float("inf"), device=sims.device))
    fd = 1.0 - torch.amax(sims, dim=-1)
    fd = torch.where(feat_mask & bank_mask.any(), fd,
                     torch.full((), FD_NONE, device=fd.device))
    return fd, torch.amin(fd, dim=-1)
