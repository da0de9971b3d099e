"""Native host ops: build-on-demand C++ shared object with numpy fallback.

The port's copy of ``person_capture_tpu/native``: the same ``hostops.cpp``,
built with the same ``g++`` flags, so that both packages hash a pool the
same way on one machine. ``lib()`` compiles it on first use into
``build/native/`` beside the package (the file name carries a hash of the
source and flags, so an edited source is rebuilt; each process compiles to
its own temporary file and renames it into place) and returns a ctypes
handle, or None when no toolchain exists. Public wrappers
(:func:`p010_repack`, :func:`hamming_matrix`, :func:`phash64_batch`) fall
back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libpc_hostops-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        cp = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                            capture_output=True, text=True, timeout=120,
                            check=False)
        if cp.returncode != 0 or not os.path.isfile(tmp):
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.isfile(so) and not _build(so):
            return None
        try:
            handle = ctypes.CDLL(so)
        except OSError:
            return None
        handle.pc_p010_repack.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        handle.pc_p010_repack.restype = None
        handle.pc_hamming_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        handle.pc_hamming_matrix.restype = None
        handle.pc_phash_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
        handle.pc_phash_batch.restype = None
        handle.pc_hostops_version.restype = ctypes.c_int
        _lib = handle
        return _lib


def available() -> bool:
    return lib() is not None


def p010_repack(y_strided: np.ndarray, uv_strided: np.ndarray):
    """Strided P010 planes (uint16, possibly padded rows) → contiguous
    (y, uv) uint16 arrays with codes shifted to the low 10 bits."""
    h, w = y_strided.shape[:2]
    handle = lib()
    if handle is None:
        return (y_strided[:, :w] >> 6).astype(np.uint16), \
               (uv_strided.reshape(h // 2, -1)[:, : (w // 2) * 2] >> 6) \
               .astype(np.uint16).reshape(h // 2, w // 2, 2)
    y_src = np.ascontiguousarray(y_strided, np.uint16)
    uv_src = np.ascontiguousarray(uv_strided, np.uint16).reshape(h // 2, -1)
    y_out = np.empty((h, w), np.uint16)
    uv_out = np.empty((h // 2, (w // 2) * 2), np.uint16)
    handle.pc_p010_repack(
        y_src.ctypes.data, y_src.strides[0],
        uv_src.ctypes.data, uv_src.strides[0],
        w, h, y_out.ctypes.data, uv_out.ctypes.data)
    return y_out, uv_out.reshape(h // 2, w // 2, 2)


def hamming_matrix(a, b) -> np.ndarray:
    """Pairwise Hamming distances of two uint64 hash arrays → uint8
    ``[len(a), len(b)]``."""
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    handle = lib()
    if handle is None:
        x = a[:, None] ^ b[None, :]
        return np.unpackbits(x.view(np.uint8).reshape(len(a), len(b), 8),
                             axis=-1).sum(-1).astype(np.uint8)
    out = np.empty((len(a), len(b)), np.uint8)
    handle.pc_hamming_matrix(a.ctypes.data, len(a), b.ctypes.data, len(b),
                             out.ctypes.data)
    return out


def phash64_batch(gray32: np.ndarray, zero_dc: bool = True) -> np.ndarray:
    """Batch 64-bit DCT pHash of ``[N, 32, 32]`` float32 gray images."""
    from ..core.hashing import _dct_matrix

    gray32 = np.ascontiguousarray(gray32, np.float32)
    if gray32.ndim != 3 or gray32.shape[1:] != (32, 32):
        raise ValueError(f"phash64_batch takes [N, 32, 32] images, got "
                         f"{gray32.shape}")
    n = gray32.shape[0]
    handle = lib()
    if handle is None:
        from ..core.hashing import dct2
        out = np.empty(n, np.uint64)
        for i in range(n):
            block = dct2(gray32[i])[:8, :8].copy()
            if zero_dc:
                block[0, 0] = 0.0
            med = np.median(block)
            bits = np.uint64(0)
            flat = block.reshape(-1) > med
            for k, v in enumerate(flat):
                if v:
                    bits |= np.uint64(1) << np.uint64(k)
            out[i] = bits
        return out
    d = np.ascontiguousarray(_dct_matrix(32), np.float32)
    out = np.empty(n, np.uint64)
    handle.pc_phash_batch(gray32.ctypes.data, n, d.ctypes.data,
                          1 if zero_dc else 0, out.ctypes.data)
    return out
