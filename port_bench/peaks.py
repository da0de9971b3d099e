"""Published dense peaks of the cards the benchmark knows.

Copied from the port's ``utils/mfu.py``: NVIDIA's H100 datasheet, tensor
cores without sparsity, TFLOP/s, matched on a substring of
``torch.cuda.get_device_name``. The SXM part's rates hold at its full
power limit of 700 W; the result line carries the card's limit beside
them.
"""

from __future__ import annotations

from typing import Optional

PEAK_TFLOPS = (
    ("h100 nvl", {"bfloat16": 835.0, "tf32": 418.0}),
    ("h100 pcie", {"bfloat16": 756.0, "tf32": 378.0}),
    ("h100", {"bfloat16": 989.0, "tf32": 495.0}),
)


def peak_flops(device_name: str, dtype: str = "bfloat16") -> Optional[float]:
    """FLOP/s of ``device_name`` for ``dtype`` (bfloat16 and float16 share
    one; float32 reads the TF32 rate); None for a device not in the
    table."""
    key = "bfloat16" if dtype in ("bfloat16", "float16") else "tf32"
    name = str(device_name).lower()
    for sub, peaks in PEAK_TFLOPS:
        if sub in name:
            return peaks[key] * 1e12
    return None
