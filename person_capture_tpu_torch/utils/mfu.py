"""FLOP accounting and MFU (model FLOP utilization) for torch programs.

Counterpart of ``person_capture_tpu/utils/mfu.py``, with the same names.
The JAX package reads FLOPs from XLA's cost model of a compiled program;
eager torch has no compiled program, so :func:`program_cost` counts the
FLOPs of one call with ``torch.utils.flop_counter.FlopCounterMode`` (the
matmuls, convolutions and attention products the call dispatches, backward
ones included when the call runs a backward pass), and

    achieved FLOP/s / the card's peak FLOP/s  (= MFU)

for a call timed by :func:`measure_device_seconds`.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional

import torch

# Dense tensor-core peaks (no sparsity) in TFLOP/s, from NVIDIA's H100
# datasheet, by a substring of torch.cuda.get_device_name. SXM (the
# "HBM3" parts) 989 bf16 / 495 TF32; PCIe 756 / 378; NVL 835 / 418.
_PEAK_TFLOPS = (
    ("h100 nvl", {"bfloat16": 835.0, "tf32": 418.0}),
    ("h100 pcie", {"bfloat16": 756.0, "tf32": 378.0}),
    ("h100", {"bfloat16": 989.0, "tf32": 495.0}),
)


def _peak_key(dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16, "bfloat16", "float16"):
        return "bfloat16"
    return "tf32"


def chip_peak_tflops(device=None, dtype=torch.bfloat16) -> Optional[float]:
    """Dense tensor-core peak TFLOP/s of ``device`` for ``dtype`` (bf16 and
    fp16 share one; float32 reads the TF32 peak), matched on the card's
    name; None on the CPU or for a card not in the table."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return peak_for_name(torch.cuda.get_device_name(device), dtype)


def peak_for_name(name: str, dtype=torch.bfloat16) -> Optional[float]:
    """The datasheet lookup of :func:`chip_peak_tflops` on a device name
    such as ``"NVIDIA H100 80GB HBM3"``."""
    name = str(name).lower()
    for sub, peaks in _PEAK_TFLOPS:
        if sub in name:
            return peaks[_peak_key(dtype)]
    return None


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v) for v in obj)
    return 0


def program_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """FLOPs of one call ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them, and
    ``bytes_accessed``: the bytes of the tensors among the arguments and
    the results, each counted once — not the memory traffic of the
    intermediates, which eager torch does not report. The call runs once."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kwargs)
    return {
        "flops": float(counter.get_total_flops()),
        "bytes_accessed": float(_tensor_bytes(args) + _tensor_bytes(kwargs)
                                + _tensor_bytes(out)),
        "optimal_seconds": 0.0,
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_device_seconds(fn: Callable[[], object], n: int = 20,
                           reps: int = 3, device=None) -> float:
    """Median amortized seconds per call of ``fn``: ``n`` calls dispatched
    back to back, then one ``torch.cuda.synchronize()``; the median of
    ``reps`` such runs, after one warm-up call."""
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    fn()
    _sync(device)
    ts = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        ts.append((time.perf_counter() - t0) / n)
    return statistics.median(ts)


def mfu_report(fn: Callable, args: tuple, n: int = 20, reps: int = 3,
               device=None, dtype=torch.bfloat16) -> Dict[str, float]:
    """FLOPs and bytes of one call, measured ms per call, achieved TFLOP/s,
    arithmetic intensity and MFU against the card's ``dtype`` peak
    (``peak_dtype`` says which: ``bfloat16`` or ``tf32``); ``mfu`` is None
    on the CPU."""
    cost = program_cost(fn, *args)
    secs = measure_device_seconds(lambda: fn(*args), n=n, reps=reps,
                                  device=device)
    achieved = cost["flops"] / secs / 1e12 if secs > 0 else 0.0
    peak = chip_peak_tflops(device, dtype)
    return {
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes_accessed"],
        "ms_per_step": round(secs * 1e3, 2),
        "achieved_tflops": round(achieved, 2),
        "arith_intensity_flops_per_byte": round(
            cost["flops"] / cost["bytes_accessed"], 1)
        if cost["bytes_accessed"] else None,
        "peak_tflops": peak,
        "peak_dtype": _peak_key(dtype),
        "mfu": round(achieved / peak, 4) if peak else None,
    }
