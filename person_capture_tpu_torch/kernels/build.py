"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Builds happen at first use, from the sources in the
checkout, into ``build/torch_kernels/`` beside the package; the file name
carries a hash of the source, so an edited kernel is rebuilt and a stale
library is never loaded. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "person_capture_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _report_path(library: str) -> str:
    return library[:-3] + ".ptxas.txt"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path. The compile also passes ``-Xptxas -v`` (it
    changes no code, so it is not in the hash) and keeps those lines beside
    the library for :func:`ptxas_report`. Safe to call from several
    processes: each compiles to its own temporary files and renames them
    into place."""
    out = library_path(name)
    if os.path.isfile(out) and os.path.isfile(_report_path(out)):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc={proc.returncode}):\n{proc.stderr[-4000:]}")
    report = [line.strip() for line in proc.stderr.splitlines()
              if line.startswith("ptxas info") or "spill" in line]
    with open(f"{tmp}.ptxas", "w") as fh:
        fh.write("\n".join(report) + "\n")
    os.replace(f"{tmp}.ptxas", _report_path(out))
    os.replace(tmp, out)
    return out


def ptxas_report(name: str) -> list:
    """Registers, shared memory and spills of each kernel in
    ``csrc/<name>.cu``: the ``-Xptxas -v`` lines of its library's build."""
    with open(_report_path(build(name))) as fh:
        return fh.read().splitlines()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
