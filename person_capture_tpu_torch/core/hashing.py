"""DCT perceptual hashing.

Host implementation matches the reference contract (utils.py:121-150):
gray → 32×32 area-resize → orthonormal DCT-II → top-left 8×8 block → bits
where coefficient > median. Batched torch variants (the counterparts of the
JAX package's ``phash_bits_batch_jnp`` and ``phash_hamming_matrix_jnp``) hash
a pool in one call on the device: the DCT is two small matmuls.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@lru_cache(maxsize=4)
def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (same convention as cv2.dct)."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0, :] *= np.sqrt(1.0 / n)
    d[1:, :] *= np.sqrt(2.0 / n)
    return d.astype(np.float32)


def dct2(x: np.ndarray) -> np.ndarray:
    """2-D orthonormal DCT-II via matmuls."""
    n, m = x.shape
    dn, dm = _dct_matrix(n), _dct_matrix(m)
    return dn @ x.astype(np.float32) @ dm.T


def phash_bits(img: np.ndarray, hash_size: int = 8) -> int:
    """64-bit DCT pHash of a BGR (or gray) image; 0 for empty input."""
    if img is None or img.size == 0:
        return 0
    if img.ndim == 3:
        if cv2 is not None:
            gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        else:
            from .geometry import bgr_to_gray
            gray = bgr_to_gray(img)
    else:
        gray = img
    if cv2 is not None:
        gray = cv2.resize(gray, (32, 32), interpolation=cv2.INTER_AREA)
    else:
        gray = _area_resize_32(gray)
    block = dct2(np.float32(gray))[:hash_size, :hash_size]
    median = float(np.median(block))
    return pack_bits(block.reshape(-1) > median)


def phash_similarity(h1: int, h2: int, nbits: int = 64) -> float:
    """1 - normalized Hamming distance, in [0, 1]."""
    total = max(1, int(nbits))
    return 1.0 - (int(h1) ^ int(h2)).bit_count() / float(total)


def _area_resize_32(gray: np.ndarray) -> np.ndarray:
    """Fallback area resize to 32×32 when cv2 is unavailable."""
    h, w = gray.shape
    ys = (np.linspace(0, h, 33)).astype(int)
    xs = (np.linspace(0, w, 33)).astype(int)
    out = np.empty((32, 32), np.float32)
    g = gray.astype(np.float32)
    for i in range(32):
        for j in range(32):
            out[i, j] = g[ys[i]:max(ys[i] + 1, ys[i + 1]),
                          xs[j]:max(xs[j] + 1, xs[j + 1])].mean()
    return out


# ---------------------------------------------------------------------------
# batched device variant
# ---------------------------------------------------------------------------

def phash_bits_batch(gray32_batch):
    """Batched pHash on the tensor's device.

    Args:
      gray32_batch: ``[N, 32, 32]`` float32 tensor (already area-resized
        gray).
    Returns:
      ``[N, 64]`` uint8 bit matrix (bit i set iff DCT coeff > median), bit
      order identical to :func:`phash_bits`. The median of the 64
      coefficients is the mean of the 32nd and 33rd smallest, as
      ``jnp.median`` takes it (``torch.median`` would return the lower).
    """
    import torch

    x = gray32_batch.float()
    d = torch.from_numpy(_dct_matrix(32)).to(x.device)
    coeff = torch.einsum("ij,njk,lk->nil", d, x, d)
    block = coeff[:, :8, :8].reshape(-1, 64)
    s = block.sort(dim=1).values
    median = ((s[:, 31] + s[:, 32]) * 0.5)[:, None]
    return (block > median).to(torch.uint8)


def phash_hamming_matrix(bits_a, bits_b):
    """Pairwise Hamming distance between bit matrices ``[N,64]``/``[M,64]``
    as float32: for {0,1} bits, sum(a!=b) = sum(a) + sum(b) - 2·a@b."""
    a = bits_a.float()
    b = bits_b.float()
    cross = a @ b.T
    return a.sum(1, keepdim=True) + b.sum(1)[None, :] - 2.0 * cross


def pack_bits(bits_row: np.ndarray) -> int:
    """Pack a {0,1} row (bit i at index i) into the int format of
    :func:`phash_bits`."""
    out = 0
    for i, b in enumerate(np.asarray(bits_row).reshape(-1)):
        if b:
            out |= 1 << i
    return int(out)
