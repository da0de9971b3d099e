"""Fixed-shape masked NMS, batched over frames.

Counterpart of ``person_capture_tpu/ops/nms.py`` with the same visiting
order, written out explicitly because ``torch.sort``/``torch.topk`` promise
no order among equal scores:

  * the greedy sweep visits candidates as ``jnp.argsort(...)[::-1]`` does —
    descending score, equal scores in DESCENDING index order;
  * the final top-k keeps ``lax.top_k``'s order — descending score, equal
    scores in ASCENDING index order.

Every function takes ``[K]`` inputs for one frame or ``[B, K]`` for a batch.
"""

from __future__ import annotations

import torch


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU of xyxy boxes ``[..., N, 4]`` × ``[..., M, 4]`` →
    ``[..., N, M]``."""
    a = boxes_a.float()
    b = boxes_b.float()
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1, min=0.0) * torch.clamp(iy2 - iy1, min=0.0)

    def area(x):
        return (torch.clamp(x[..., 2] - x[..., 0], min=0.0)
                * torch.clamp(x[..., 3] - x[..., 1], min=0.0))

    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union,
                       torch.zeros((), device=inter.device))


def stable_topk(scores, k: int):
    """``lax.top_k`` over the last dim: the ``k`` largest values, equal
    values in ascending index order."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _batched(fn):
    def wrapper(boxes, scores, valid, *args, **kwargs):
        if scores.dim() == 1:
            out = fn(boxes[None], scores[None], valid[None], *args, **kwargs)
            return tuple(o[0] for o in out) if isinstance(out, tuple) \
                else out[0]
        return fn(boxes, scores, valid, *args, **kwargs)

    wrapper.__doc__ = fn.__doc__
    wrapper.__name__ = fn.__name__
    return wrapper


@_batched
def nms_mask(boxes, scores, valid, iou_thresh: float = 0.45):
    """Greedy NMS keep-mask over fixed-size candidate sets.

    Args: boxes ``[B, K, 4]`` xyxy, scores ``[B, K]``, valid ``[B, K]``;
    suppresses boxes with IoU > thresh vs an already-kept box.
    Returns ``[B, K]`` bool keep mask (subset of ``valid``).
    """
    b, k = scores.shape
    neg_inf = torch.full((), float("-inf"), device=scores.device)
    # stable ascending sort, reversed: equal scores in descending index
    order = torch.sort(torch.where(valid, scores.float(), neg_inf), dim=-1,
                       stable=True).indices.flip(-1)
    sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    svalid = torch.gather(valid, 1, order)
    # invalid candidates sort last and are never kept: sweep only as far as
    # the frame with the most valid candidates
    n = int(valid.sum(-1).max()) if k else 0
    keep_sorted = torch.zeros((b, k), dtype=torch.bool, device=scores.device)
    if n:
        over = iou_matrix(sboxes[:, :n], sboxes[:, :n]) > iou_thresh
        for i in range(n):
            suppressed = (keep_sorted[:, :i] & over[:, i, :i]).any(-1)
            keep_sorted[:, i] = svalid[:, i] & ~suppressed
    keep = torch.zeros_like(keep_sorted)
    keep.scatter_(1, order, keep_sorted)
    return keep


@_batched
def nms_select(boxes, scores, valid, max_out: int, iou_thresh: float = 0.45):
    """NMS then densely pack the top ``max_out`` survivors by score.

    Returns (indices ``[B, max_out]`` into the input slots, mask
    ``[B, max_out]``). Invalid output slots point at index 0 with mask
    False."""
    keep = nms_mask(boxes, scores, valid, iou_thresh)
    neg_inf = torch.full((), float("-inf"), device=scores.device)
    top_scores, idx = stable_topk(torch.where(keep, scores.float(), neg_inf),
                                  max_out)
    mask = torch.isfinite(top_scores)
    return torch.where(mask, idx, torch.zeros_like(idx)), mask
