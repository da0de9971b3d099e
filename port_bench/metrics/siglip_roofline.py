"""Kernels of a SigLIP face tower (``models/siglip.py``): the FLOPs of the
face chips the traced video needed (slots the detector kept, on valid
frames) over the device time of the kernels launched inside the port's
``face.encode`` ranges (the tower call with its 384-px resize), against
the card's bf16 peak, %.

A traced video with no such range, or with kept chips and no kernel time
in it, means the port routes the tower another way: the run stops rather
than leave the metric out.
"""

from port_bench.flops import embedder_flops
from port_bench.peaks import peak_flops

RANGE = "face.encode"


def read(ctx):
    emb, tr = ctx["config"]["embedder"], ctx["trace"]
    peak = peak_flops(ctx["device_name"], ctx["config"]["dtype"])
    if emb["kind"] != "siglip" or tr is None or peak is None:
        return None
    kept = ctx["kept"].get(0, 0)
    if not tr.has_range(RANGE):
        raise RuntimeError(f"the traced video opened no {RANGE!r} range: "
                           f"the tower is no longer called through the "
                           f"face backend's _encode")
    seconds = tr.kernel_seconds_in(RANGE)
    if seconds <= 0:
        if kept:
            raise RuntimeError(f"{kept} chips kept but no kernel ran inside "
                               f"{RANGE!r}")
        return None
    return 100.0 * kept * embedder_flops(emb) / (seconds * peak)
