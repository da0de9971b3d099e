"""The face embedder's slot fill (``pipeline/backends.py``): of the chips
the port sent through the embedder (counter ``embed.chips``: every slot
of every frame of a batch, padding frames included), the share that held
a kept face on a valid frame (counter ``embed.chips_kept``), %, over the
videos after the traced one."""


def read(ctx):
    c = ctx.get("counters") or {}
    if not c.get("embed.chips") or "embed.chips_kept" not in c:
        return None
    return 100.0 * c["embed.chips_kept"] / c["embed.chips"]
