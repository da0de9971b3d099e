"""The pre-scan's span-edge refinement (``pipeline/prescan.py``
``refine_span_edges``: at most one seek per edge window, a forward walk
that drains to the other edge samples, and its padded device batches):
wall of the port's ``prescan.refine`` stage, ms per source frame of the
videos after the traced one."""


def read(ctx):
    s = ctx["stages"]
    if "prescan.refine" not in s or not ctx["frames"]:
        return None
    return 1e3 * s["prescan.refine"] / ctx["frames"]
