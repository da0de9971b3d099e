"""Kernels of a CLIP ViT face tower (``models/clip_vit.py``): the FLOPs of
the face chips the traced video needed (slots the detector kept, on valid
frames) over the device time of the kernels launched inside the
benchmark's range around the tower call, against the card's bf16 peak, %.

The range is opened around the port's ``_encode`` of each face backend. A
traced video with no such range, or with kept chips and no kernel time in
it, means the port routes the tower another way: the run stops rather
than leave the metric out.
"""

from port_bench.flops import embedder_flops
from port_bench.peaks import peak_flops
from port_bench.probe import EMBED_RANGE


def read(ctx):
    emb, tr = ctx["config"]["embedder"], ctx["trace"]
    peak = peak_flops(ctx["device_name"], ctx["config"]["dtype"])
    if emb["kind"] != "clip" or tr is None or peak is None:
        return None
    kept = ctx["kept"].get(0, 0)
    if not tr.has_range(EMBED_RANGE):
        raise RuntimeError(f"the traced video opened no {EMBED_RANGE!r} "
                           f"range: the tower is no longer called through "
                           f"the face backend's _encode")
    seconds = tr.kernel_seconds_in(EMBED_RANGE)
    if seconds <= 0:
        if kept:
            raise RuntimeError(f"{kept} chips kept but no kernel ran inside "
                               f"{EMBED_RANGE!r}")
        return None
    return 100.0 * kept * embedder_flops(emb) / (seconds * peak)
