"""The face embedder's attention on the card: device seconds of the
kernels launched inside the port's ``face.attn`` ranges (each attention
call of a CLIP-style tower: q·kᵀ, softmax and ·v, without the
projections) in the traced video. None where the port opens no such
range (an ArcFace embedder, or a port without the span)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.has_range("face.attn"):
        return None
    return tr.kernel_seconds_in("face.attn")
