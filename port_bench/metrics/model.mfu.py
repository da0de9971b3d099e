"""The whole step: the model FLOPs the timed videos' inputs needed (the
face detector on every valid frame it was given, at its canvas; YOLOv8 on
every valid main-pass frame; the embedder on every face slot the detector
kept) over those videos' time at the card's bf16 dense peak, %. The
traced video, slower under the profiler, is left out."""

from port_bench.flops import detector_flops, embedder_flops, person_flops
from port_bench.peaks import peak_flops


def read(ctx):
    conf = ctx["config"]
    peak = peak_flops(ctx["device_name"], conf["dtype"])
    if peak is None or ctx["timed_s"] <= 0:
        return None
    flops = sum(n * detector_flops(conf["detector"], c)
                for c, n in ctx["det_frames"].items())
    flops += ctx["person_frames"] * person_flops(conf["person"])
    flops += sum(ctx["kept"].get(i, 0) for i in ctx["timed"]) \
        * embedder_flops(conf["embedder"])
    return 100.0 * flops / (ctx["timed_s"] * peak)
