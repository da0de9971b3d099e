"""Dependency-free ONNX graph executor in torch.

The reference runs its face stack from ONNX checkpoints through
onnxruntime/TensorRT (person_capture/face_embedder.py:967-1197). This
module executes the ONNX graph directly with torch ops: parse with
tools/onnx_lite.parse_onnx, then interpret the node list. It runs the exact
insightface/arcface graphs when their .onnx files are provided
(scrfd_*_bnkps.onnx, w600k_r50.onnx) without the `onnx` package.

Counterpart of ``person_capture_tpu/tools/onnx_exec.py``, with its split:
- Shape-feeding inputs (Reshape shapes, Resize scales/sizes, Slice indices…)
  are constant-folded on the host: any chain of host-constant values
  executes in numpy, so every reshape and resize has a static shape. Float
  weights are explicit tensors (``params``, resident on the device and
  castable to bf16).
- Layout is ONNX-native NCHW inside the graph, as in the file.
- Data-dependent ops (NonZero, NonMaxSuppression, dynamic TopK) are
  rejected with the same error: detection decode/NMS live outside the
  graph (ops/nms.py), exactly as insightface's python decode does.

Where torch's functions differ from the JAX ops the graph semantics come
first: asymmetric and ``auto_pad`` pads are applied with ``F.pad`` before
a convolution or pool, ``Resize`` builds ONNX's own per-axis resample
matrices (not ``F.interpolate``), integer ``Div`` truncates toward zero.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .onnx_lite import OnnxGraph, OnnxNode, _DTYPES, parse_onnx

__all__ = ["OnnxModule", "build_module", "load_onnx_module"]


def _is_host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _tensor(v, like: torch.Tensor) -> torch.Tensor:
    """A host value as a tensor on ``like``'s device. float64 becomes
    float32, as the JAX package's arrays do without 64-bit mode."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=like.device)


def _tensors(vals):
    """Every value of ``vals`` as a tensor on the first tensor's device."""
    like = next(v for v in vals if isinstance(v, torch.Tensor))
    return [_tensor(v, like) for v in vals]


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _s(attr, default: str = "") -> str:
    """Attribute string (stored as bytes) → str."""
    if attr is None:
        return default
    if isinstance(attr, bytes):
        return attr.decode("utf-8")
    return str(attr)


def _ints(v) -> List[int]:
    if v is None:
        return []
    if isinstance(v, np.ndarray):
        return [int(x) for x in v.reshape(-1)]
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)]


# ---------------------------------------------------------------------------
# op implementations: fn(node, vals) -> value | tuple(values)
# vals are the resolved inputs (None for absent optional inputs); a value is
# a host constant (numpy) or a torch tensor
# ---------------------------------------------------------------------------

_OPS: Dict[str, Callable] = {}


def _op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _require_host(node: OnnxNode, val, what: str) -> np.ndarray:
    if not _is_host(val):
        raise ValueError(
            f"{node.op_type} '{node.name}': {what} must be a host constant "
            f"(a static shape); got a device tensor")
    return np.asarray(val)


@_op("Constant")
def _constant(node, vals):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints"):
        if key in node.attrs:
            v = node.attrs[key]
            return v if isinstance(v, np.ndarray) else np.asarray(v)
    raise ValueError(f"Constant '{node.name}' carries no value")


@_op("Identity")
def _identity(node, vals):
    return vals[0]


@_op("Dropout")
def _dropout(node, vals):
    x = vals[0]
    if len(node.outputs) > 1:
        if _is_host(x):
            return x, np.ones(np.shape(x), bool)
        return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return x


@_op("Cast")
def _cast(node, vals):
    code = int(node.attrs["to"])
    dtype = _DTYPES.get(code)
    if dtype is None:
        raise NotImplementedError(
            f"Cast node '{node.name}' targets unsupported ONNX dtype "
            f"code {code}")
    x = vals[0]
    if _is_host(x):
        return np.asarray(x).astype(dtype)
    return x.to(_torch_dtype(dtype))


@_op("Shape")
def _shape(node, vals):
    shape = np.asarray(tuple(vals[0].shape), np.int64)
    start = int(node.attrs.get("start", 0))
    end = node.attrs.get("end")
    return shape[start:None if end is None else int(end)]


@_op("Size")
def _size(node, vals):
    return np.int64(int(np.prod(tuple(vals[0].shape))))


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.take`` on a tensor: the axis is replaced by ``idx``'s shape."""
    out = x.index_select(axis, idx.reshape(-1).long())
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


@_op("Gather")
def _gather(node, vals):
    x, idx = vals
    axis = int(node.attrs.get("axis", 0)) % x.ndim
    dim = x.shape[axis]
    if _is_host(x) and _is_host(idx):
        idx = np.asarray(idx)
        return np.take(x, np.where(idx < 0, idx + dim, idx), axis=axis)
    x, idx = _tensors([x, idx])
    return _take(x, torch.where(idx < 0, idx + dim, idx), axis)


@_op("Squeeze")
def _squeeze(node, vals):
    x = vals[0]
    axes = _ints(node.attrs.get("axes")) if "axes" in node.attrs else (
        _ints(_require_host(node, vals[1], "axes")) if len(vals) > 1
        and vals[1] is not None else [])
    if _is_host(x):
        x = np.asarray(x)
        return np.squeeze(x, axis=tuple(a % x.ndim for a in axes)) \
            if axes else np.squeeze(x)
    if not axes:
        return x.squeeze()
    return x.squeeze(tuple(a % x.ndim for a in axes))


@_op("Unsqueeze")
def _unsqueeze(node, vals):
    x = vals[0]
    axes = _ints(node.attrs.get("axes")) if "axes" in node.attrs else \
        _ints(_require_host(node, vals[1], "axes"))
    if _is_host(x):
        x = np.asarray(x)
    out_rank = x.ndim + len(axes)
    for a in sorted(a % out_rank for a in axes):
        x = np.expand_dims(x, a) if _is_host(x) else x.unsqueeze(a)
    return x


@_op("Concat")
def _concat(node, vals):
    axis = int(node.attrs["axis"])
    if all(_is_host(v) for v in vals):
        return np.concatenate([np.atleast_1d(v) for v in vals], axis=axis)
    parts = _tensors([np.atleast_1d(v) if _is_host(v) else v for v in vals])
    return torch.cat(parts, dim=axis)


@_op("Reshape")
def _reshape(node, vals):
    x = vals[0]
    shape = _ints(_require_host(node, vals[1], "shape"))
    in_shape = tuple(x.shape)
    out = []
    for i, d in enumerate(shape):
        if d == 0 and not int(node.attrs.get("allowzero", 0)):
            out.append(in_shape[i])
        else:
            out.append(d)
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1]))
        out[out.index(-1)] = int(np.prod(in_shape)) // max(known, 1)
    return x.reshape(tuple(out))


@_op("Flatten")
def _flatten(node, vals):
    x = vals[0]
    axis = int(node.attrs.get("axis", 1)) % (x.ndim + 1)
    lead = int(np.prod(tuple(x.shape)[:axis])) if axis else 1
    return x.reshape(lead, -1)


@_op("Transpose")
def _transpose(node, vals):
    x = vals[0]
    perm = _ints(node.attrs.get("perm")) or list(range(x.ndim))[::-1]
    if _is_host(x):
        return np.transpose(x, perm)
    return x.permute(*perm)


@_op("Expand")
def _expand(node, vals):
    x = vals[0]
    shape = tuple(_ints(_require_host(node, vals[1], "shape")))
    target = np.broadcast_shapes(tuple(x.shape), shape)
    if _is_host(x):
        return np.broadcast_to(x, target)
    return x.expand(target)


@_op("Tile")
def _tile(node, vals):
    reps = _ints(_require_host(node, vals[1], "repeats"))
    if _is_host(vals[0]):
        return np.tile(vals[0], reps)
    return vals[0].tile(tuple(reps))


@_op("Slice")
def _slice(node, vals):
    x = vals[0]
    if len(vals) > 1 and vals[1] is not None:          # opset >= 10
        starts = _ints(_require_host(node, vals[1], "starts"))
        ends = _ints(_require_host(node, vals[2], "ends"))
        axes = _ints(_require_host(node, vals[3], "axes")) \
            if len(vals) > 3 and vals[3] is not None else list(range(len(starts)))
        steps = _ints(_require_host(node, vals[4], "steps")) \
            if len(vals) > 4 and vals[4] is not None else [1] * len(starts)
    else:                                               # opset < 10: attrs
        starts = _ints(node.attrs["starts"])
        ends = _ints(node.attrs["ends"])
        axes = _ints(node.attrs.get("axes")) or list(range(len(starts)))
        steps = [1] * len(starts)
    slicers: List[Any] = [slice(None)] * x.ndim
    int64_max = (1 << 63) - 1
    for start, end, axis, step in zip(starts, ends, axes, steps):
        axis = axis % x.ndim
        dim = x.shape[axis]
        if start < 0:
            start += dim
        if end < 0 and end > -int64_max:
            end += dim
        if step > 0:
            start = int(np.clip(start, 0, dim))
            end = int(np.clip(end, 0, dim))
            slicers[axis] = slice(start, end, step)
        else:
            start = int(np.clip(start, 0, dim - 1))
            end = int(np.clip(end, -1, dim - 1))
            slicers[axis] = slice(start, None if end < 0 else end, step)
    if _is_host(x):
        return np.asarray(x)[tuple(slicers)]
    # torch slices take no negative step: gather the indices numpy's slice
    # visits instead
    for axis, sl in enumerate(slicers):
        if sl.step is not None and sl.step != 1:
            idx = np.arange(x.shape[axis])[sl].copy()
            x = x.index_select(axis, torch.as_tensor(idx, device=x.device))
            slicers[axis] = slice(None)
    return x[tuple(slicers)]


@_op("Split")
def _split(node, vals):
    x = vals[0]
    axis = int(node.attrs.get("axis", 0)) % x.ndim
    if "split" in node.attrs:
        sizes = _ints(node.attrs["split"])
    elif len(vals) > 1 and vals[1] is not None:
        sizes = _ints(_require_host(node, vals[1], "split"))
    else:
        # no explicit sizes: ONNX (opset 18) uses ceil(dim/n)-sized chunks
        # with only the LAST chunk smaller for non-divisible dims — e.g.
        # dim 7 into 3 → [3, 3, 1] (not numpy array_split's [3, 2, 2])
        n = len(node.outputs)
        dim = int(x.shape[axis])
        chunk = -(-dim // n)
        sizes = [chunk] * (n - 1) + [dim - chunk * (n - 1)]
        if sizes[-1] <= 0:
            raise NotImplementedError(
                f"Split node '{node.name}': {n} outputs cannot cover "
                f"dim {dim}")
    outs = []
    off = 0
    for sz in sizes:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(off, off + sz)
        outs.append(x[tuple(sl)])
        off += sz
    return tuple(outs)


@_op("Pad")
def _pad(node, vals):
    x = vals[0]
    mode = _s(node.attrs.get("mode"), "constant")
    if "pads" in node.attrs:                            # opset < 11
        pads = _ints(node.attrs["pads"])
        cval = float(node.attrs.get("value", 0.0))
    else:
        pads = _ints(_require_host(node, vals[1], "pads"))
        cval = 0.0
        if len(vals) > 2 and vals[2] is not None:
            c = vals[2]
            cval = float(np.asarray(c).reshape(-1)[0]) if _is_host(c) \
                else float(c.reshape(-1)[0])
    n = x.ndim
    begin, end = pads[:n], pads[n:]
    # negative pads crop
    sl = tuple(slice(max(0, -b), None if e >= 0 else e)
               for b, e in zip(begin, end))
    x = x[sl]
    pos = [(max(0, b), max(0, e)) for b, e in zip(begin, end)]
    if mode not in ("constant", "reflect", "edge"):
        raise KeyError(mode)
    if _is_host(x):
        if mode == "constant":
            return np.pad(x, pos, mode="constant", constant_values=cval)
        return np.pad(x, pos, mode=mode)
    if mode == "constant":
        flat = [p for pair in reversed(pos) for p in pair]
        return F.pad(x, flat, value=cval)
    # reflect / edge on any axis: gather the source index numpy's pad
    # would read for every output position
    for axis, (b, e) in enumerate(pos):
        if b or e:
            idx = np.pad(np.arange(x.shape[axis]), (b, e), mode=mode)
            x = x.index_select(axis, torch.as_tensor(idx, device=x.device))
    return x


@_op("ConstantOfShape")
def _const_of_shape(node, vals):
    shape = tuple(_ints(_require_host(node, vals[0], "shape")))
    value = node.attrs.get("value")
    if value is None:
        return np.zeros(shape, np.float32)
    v = np.asarray(value).reshape(-1)[0]
    return np.full(shape, v, np.asarray(value).dtype)


@_op("Range")
def _range(node, vals):
    start, limit, delta = (_require_host(node, v, "range arg") for v in vals)
    return np.arange(start.item(), limit.item(), delta.item(),
                     dtype=np.asarray(start).dtype)


@_op("Where")
def _where(node, vals):
    if all(_is_host(v) for v in vals):
        return np.where(vals[0], vals[1], vals[2])
    c, a, b = _tensors(vals)
    return torch.where(c.bool(), a, b)


def _binary(fn_np, fn_torch=None):
    def impl(node, vals):
        a, b = vals
        if _is_host(a) and _is_host(b):
            return fn_np(np.asarray(a), np.asarray(b))
        a, b = _tensors([a, b])
        return (fn_torch or fn_np)(a, b)
    return impl


def _div_np(a, b):
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return a / b
    # ONNX integer Div truncates toward zero
    return np.trunc(a / b).astype(np.result_type(a, b))


def _div_torch(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return a / b
    return torch.div(a, b, rounding_mode="trunc")


_OPS["Add"] = _binary(lambda a, b: a + b)
_OPS["Sub"] = _binary(lambda a, b: a - b)
_OPS["Mul"] = _binary(lambda a, b: a * b)
_OPS["Div"] = _binary(_div_np, _div_torch)
_OPS["Pow"] = _binary(lambda a, b: a ** b)
_OPS["Equal"] = _binary(lambda a, b: a == b)
_OPS["Greater"] = _binary(lambda a, b: a > b)
_OPS["Less"] = _binary(lambda a, b: a < b)
_OPS["And"] = _binary(lambda a, b: a & b)
_OPS["Or"] = _binary(lambda a, b: a | b)


@_op("Min", "Max", "Sum", "Mean")
def _variadic(node, vals):
    host = all(_is_host(v) for v in vals)
    vals = [np.asarray(v) for v in vals] if host else _tensors(vals)
    lo, hi = (np.minimum, np.maximum) if host else (torch.minimum,
                                                    torch.maximum)
    out = vals[0]
    for v in vals[1:]:
        if node.op_type == "Min":
            out = lo(out, v)
        elif node.op_type == "Max":
            out = hi(out, v)
        else:
            out = out + v
    if node.op_type == "Mean":
        out = out / len(vals)
    return out


def _unary(np_fn, torch_fn=None):
    def impl(node, vals):
        x = vals[0]
        if _is_host(x):
            return np_fn(np.asarray(x))
        return (torch_fn or np_fn)(x)
    return impl


_OPS["Neg"] = _unary(lambda x: -x)
_OPS["Abs"] = _unary(np.abs, torch.abs)
_OPS["Sqrt"] = _unary(np.sqrt, torch.sqrt)
_OPS["Exp"] = _unary(np.exp, torch.exp)
_OPS["Log"] = _unary(np.log, torch.log)
_OPS["Floor"] = _unary(np.floor, torch.floor)
_OPS["Ceil"] = _unary(np.ceil, torch.ceil)
_OPS["Not"] = _unary(np.logical_not, torch.logical_not)
_OPS["Reciprocal"] = _unary(lambda x: 1.0 / x)
_OPS["Tanh"] = _unary(np.tanh, torch.tanh)


@_op("Sigmoid")
def _sigmoid(node, vals):
    x = vals[0]
    if _is_host(x):
        return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float32)))
    return torch.sigmoid(x)


@_op("Relu")
def _relu(node, vals):
    x = vals[0]
    if _is_host(x):
        return np.maximum(x, 0)
    return torch.clamp_min(x, 0)


@_op("LeakyRelu")
def _leaky_relu(node, vals):
    alpha = float(node.attrs.get("alpha", 0.01))
    x = vals[0]
    if _is_host(x):
        return np.where(x >= 0, x, alpha * x)
    return torch.where(x >= 0, x, alpha * x)


@_op("PRelu")
def _prelu(node, vals):
    x, s = vals
    if s.ndim == 1 and x.ndim >= 2 and s.shape[0] == x.shape[1]:
        # channel vector on an NCHW tensor: align to the C axis
        s = s.reshape((s.shape[0],) + (1,) * (x.ndim - 2))
    if _is_host(x) and _is_host(s):
        return np.where(x >= 0, x, x * s)
    x, s = _tensors([x, s])
    return torch.where(x >= 0, x, x * s)


@_op("Elu")
def _elu(node, vals):
    alpha = float(node.attrs.get("alpha", 1.0))
    x = vals[0]
    if _is_host(x):
        return np.where(x >= 0, x, alpha * (np.exp(x) - 1.0))
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


@_op("HardSigmoid")
def _hard_sigmoid(node, vals):
    alpha = float(node.attrs.get("alpha", 0.2))
    beta = float(node.attrs.get("beta", 0.5))
    x = vals[0]
    if _is_host(x):
        return np.clip(alpha * x + beta, 0.0, 1.0)
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@_op("HardSwish")
def _hard_swish(node, vals):
    x = vals[0]
    if _is_host(x):
        return x * np.clip(x / 6.0 + 0.5, 0.0, 1.0)
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@_op("Softplus")
def _softplus(node, vals):
    x = vals[0]
    if _is_host(x):
        return np.logaddexp(x, 0.0)
    return torch.logaddexp(x, torch.zeros_like(x))


@_op("Clip")
def _clip(node, vals):
    x = vals[0]
    lo = node.attrs.get("min")
    hi = node.attrs.get("max")
    if lo is None and len(vals) > 1 and vals[1] is not None:
        lo = vals[1]
    if hi is None and len(vals) > 2 and vals[2] is not None:
        hi = vals[2]
    if _is_host(x) and all(_is_host(v) for v in (lo, hi) if v is not None):
        if lo is not None:
            x = np.maximum(x, lo)
        if hi is not None:
            x = np.minimum(x, hi)
        return x
    if lo is not None:
        x = torch.maximum(*_tensors([x, lo]))
    if hi is not None:
        x = torch.minimum(*_tensors([x, hi]))
    return x


@_op("Softmax")
def _softmax(node, vals, opset_holder={"opset": 13}):
    x = vals[0]
    opset = opset_holder["opset"]
    if opset >= 13:
        axis = int(node.attrs.get("axis", -1))
        return torch.softmax(x, dim=axis)
    # opset < 13: softmax over the flattened trailing dims from `axis`
    axis = int(node.attrs.get("axis", 1)) % x.ndim
    lead = int(np.prod(tuple(x.shape)[:axis])) if axis else 1
    flat = x.reshape(lead, -1)
    return torch.softmax(flat, dim=-1).reshape(x.shape)


@_op("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd")
def _reduce(node, vals):
    x = vals[0]
    axes = _ints(node.attrs.get("axes")) if "axes" in node.attrs else (
        _ints(_require_host(node, vals[1], "axes"))
        if len(vals) > 1 and vals[1] is not None else [])
    keepdims = bool(int(node.attrs.get("keepdims", 1)))
    if not axes:
        if int(node.attrs.get("noop_with_empty_axes", 0)):
            return x
        axes = list(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if _is_host(x):
        fn = {"ReduceMean": "mean", "ReduceSum": "sum", "ReduceMax": "max",
              "ReduceMin": "min", "ReduceProd": "prod"}[node.op_type]
        return getattr(np, fn)(x, axis=axes, keepdims=keepdims)
    if node.op_type == "ReduceProd":        # torch.prod takes one dim
        for a in sorted(axes, reverse=True):
            x = x.prod(dim=a, keepdim=True)
        return x if keepdims else x.reshape(
            [d for i, d in enumerate(vals[0].shape) if i not in axes])
    fn = {"ReduceMean": torch.mean, "ReduceSum": torch.sum,
          "ReduceMax": torch.amax, "ReduceMin": torch.amin}[node.op_type]
    return fn(x, dim=axes, keepdim=keepdims)


@_op("MatMul")
def _matmul(node, vals):
    if all(_is_host(v) for v in vals):
        return np.matmul(vals[0], vals[1])
    return torch.matmul(*_tensors(vals))


@_op("Gemm")
def _gemm(node, vals):
    alpha = float(node.attrs.get("alpha", 1.0))
    beta = float(node.attrs.get("beta", 1.0))
    present = [v for v in vals if v is not None]
    host = all(_is_host(v) for v in present)
    a, b, *c = [np.asarray(v) for v in present] if host else \
        _tensors(present)
    if int(node.attrs.get("transA", 0)):
        a = a.T
    if int(node.attrs.get("transB", 0)):
        b = b.T
    out = alpha * (np.matmul(a, b) if host else torch.matmul(a, b))
    if c:
        out = out + beta * c[0]
    return out


def _same_pads(auto: str, in_dims, kernel, strides, dilations):
    """``auto_pad`` SAME_UPPER / SAME_LOWER → (begin, end) per axis."""
    pairs = []
    for in_dim, kk, st, dl in zip(in_dims, kernel, strides, dilations):
        k = (kk - 1) * dl + 1
        out_dim = math.ceil(in_dim / st)
        total = max(0, (out_dim - 1) * st + k - in_dim)
        pairs.append((total // 2, total - total // 2) if auto ==
                     "SAME_UPPER" else (total - total // 2, total // 2))
    return pairs


def _conv_pads(node, x_shape, k_shape, strides, dilations) -> List[Tuple[int, int]]:
    spatial = len(x_shape) - 2
    auto = _s(node.attrs.get("auto_pad"), "NOTSET")
    if auto in ("", "NOTSET"):
        pads = _ints(node.attrs.get("pads")) or [0] * (2 * spatial)
        return [(pads[i], pads[i + spatial]) for i in range(spatial)]
    if auto == "VALID":
        return [(0, 0)] * spatial
    return _same_pads(auto, x_shape[2:], k_shape[2:], strides, dilations)


def _pad_spatial(x: torch.Tensor, pairs, value: float = 0.0) -> torch.Tensor:
    """Pad the trailing spatial axes by (begin, end) pairs (negative pads
    crop, as XLA's padding does)."""
    flat = [p for pair in reversed(pairs) for p in pair]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


@_op("Conv")
def _conv(node, vals):
    x, w = vals[0], vals[1]
    if x.ndim != 4:
        raise NotImplementedError(
            f"Conv '{node.name}': only 2-D convolutions supported "
            f"(input rank {x.ndim})")
    x, w = _tensors([x, w])
    spatial = 2
    strides = _ints(node.attrs.get("strides")) or [1] * spatial
    dilations = _ints(node.attrs.get("dilations")) or [1] * spatial
    group = int(node.attrs.get("group", 1))
    pads = _conv_pads(node, tuple(x.shape), tuple(w.shape), strides,
                      dilations)
    # F.conv2d takes only symmetric pads: pad first, as JAX's padding pairs
    out = F.conv2d(_pad_spatial(x, pads), w, stride=strides,
                   dilation=dilations, groups=group)
    if len(vals) > 2 and vals[2] is not None:
        out = out + _tensor(vals[2], out).reshape(1, -1, 1, 1)
    return out


@_op("BatchNormalization")
def _batch_norm(node, vals):
    x, scale, bias, mean, var = _tensors(vals[:5])
    eps = float(node.attrs.get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = scale.reshape(shape) / torch.sqrt(var.reshape(shape) + eps)
    return x * inv + (bias.reshape(shape) - mean.reshape(shape) * inv)


def _pool_prep(node, x):
    spatial = x.ndim - 2
    kernel = _ints(node.attrs["kernel_shape"])
    strides = _ints(node.attrs.get("strides")) or [1] * spatial
    dilations = _ints(node.attrs.get("dilations")) or [1] * spatial
    pads = _ints(node.attrs.get("pads")) or [0] * (2 * spatial)
    pairs = [(pads[i], pads[i + spatial]) for i in range(spatial)]
    auto = _s(node.attrs.get("auto_pad"), "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pairs = _same_pads(auto, tuple(x.shape)[2:], kernel, strides,
                           dilations)
    if int(node.attrs.get("ceil_mode", 0)):
        new_pairs = []
        for i in range(spatial):
            in_dim = x.shape[2 + i] + pairs[i][0] + pairs[i][1]
            k = (kernel[i] - 1) * dilations[i] + 1
            out_ceil = math.ceil(max(0, in_dim - k) / strides[i]) + 1
            need = (out_ceil - 1) * strides[i] + k - in_dim
            new_pairs.append((pairs[i][0], pairs[i][1] + max(0, need)))
        pairs = new_pairs
    return kernel, strides, dilations, pairs


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@_op("MaxPool")
def _max_pool(node, vals):
    x = vals[0]
    kernel, strides, dilations, pairs = _pool_prep(node, x)
    dtype = x.dtype
    if not dtype.is_floating_point:     # max_pool takes floats: exact in f64
        x = x.double()
    # padded cells never win the max: pad with -inf first (F.max_pool's own
    # padding is symmetric and at most half the window)
    x = _pad_spatial(x, pairs, value=-math.inf)
    out = _MAX_POOL[len(kernel)](x, kernel, strides, dilation=dilations)
    return out.to(dtype)


def _window_sum(x, kernel, strides, dilations, pairs):
    """Sum over each pooling window (zeros where padded): a depthwise
    convolution with a kernel of ones."""
    c = x.shape[1]
    ones = torch.ones((c, 1, *kernel), dtype=x.dtype, device=x.device)
    return _CONV[len(kernel)](_pad_spatial(x, pairs), ones, stride=strides,
                              dilation=dilations, groups=c)


@_op("AveragePool")
def _avg_pool(node, vals):
    x = vals[0]
    kernel, strides, dilations, pairs = _pool_prep(node, x)
    sums = _window_sum(x, kernel, strides, dilations, pairs)
    if int(node.attrs.get("count_include_pad", 0)):
        return sums / float(np.prod(kernel))
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = _window_sum(ones, kernel, strides, dilations, pairs)
    return sums / counts


@_op("GlobalAveragePool")
def _global_avg_pool(node, vals):
    x = vals[0]
    return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)


@_op("GlobalMaxPool")
def _global_max_pool(node, vals):
    x = vals[0]
    return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)


def _resize_axis_indices(in_dim: int, out_dim: int, scale: float,
                         coord_mode: str, nearest_mode: str,
                         linear: bool):
    """Source coordinates for one resized axis (ONNX Resize semantics)."""
    x = np.arange(out_dim, dtype=np.float64)
    if coord_mode == "half_pixel":
        src = (x + 0.5) / scale - 0.5
    elif coord_mode == "pytorch_half_pixel":
        src = (x + 0.5) / scale - 0.5 if out_dim > 1 else np.zeros_like(x)
    elif coord_mode == "asymmetric":
        src = x / scale
    elif coord_mode == "align_corners":
        src = x * (in_dim - 1) / max(out_dim - 1, 1)
    elif coord_mode == "tf_half_pixel_for_nn":
        src = (x + 0.5) / scale
    else:
        raise NotImplementedError(f"Resize coord mode {coord_mode!r}")
    if linear:
        lo = np.clip(np.floor(src), 0, in_dim - 1).astype(np.int64)
        hi = np.clip(lo + 1, 0, in_dim - 1)
        w = np.clip(src - lo, 0.0, 1.0).astype(np.float32)
        return lo, hi, w
    if nearest_mode == "floor":
        idx = np.floor(src)
    elif nearest_mode == "ceil":
        idx = np.ceil(src)
    elif nearest_mode == "round_prefer_ceil":
        idx = np.floor(src + 0.5)
    else:  # round_prefer_floor (default)
        idx = np.ceil(src - 0.5)
    return np.clip(idx, 0, in_dim - 1).astype(np.int64), None, None


@_op("Resize", "Upsample")
def _resize(node, vals):
    x = vals[0]
    mode = _s(node.attrs.get("mode"), "nearest")
    if node.op_type == "Upsample":
        coord_mode, nearest_mode = "asymmetric", "floor"
        scales_v = node.attrs.get("scales")
        if scales_v is None and len(vals) > 1:
            scales_v = _require_host(node, vals[1], "scales")
        scales = [float(s) for s in np.asarray(scales_v).reshape(-1)]
        sizes = None
    else:
        coord_mode = _s(node.attrs.get("coordinate_transformation_mode"),
                        "half_pixel")
        nearest_mode = _s(node.attrs.get("nearest_mode"),
                          "round_prefer_floor")
        scales = None
        sizes = None
        if len(vals) == 2 and vals[1] is not None:
            # opset-10 Resize signature: (X, scales) — later opsets move
            # scales to input 2 (input 1 becomes roi). Opset-10 had NO
            # coordinate/nearest attributes and fixed asymmetric+floor
            # semantics (same as Upsample); keeping the opset-11 defaults
            # would shift every resample half a pixel
            scales = [float(s) for s in np.asarray(
                _require_host(node, vals[1], "scales")).reshape(-1)]
            if "coordinate_transformation_mode" not in node.attrs:
                coord_mode = "asymmetric"
            if "nearest_mode" not in node.attrs:
                nearest_mode = "floor"
        if len(vals) > 2 and vals[2] is not None and np.size(
                _require_host(node, vals[2], "scales")):
            scales = [float(s) for s in np.asarray(vals[2]).reshape(-1)]
        if len(vals) > 3 and vals[3] is not None:
            sizes = _ints(_require_host(node, vals[3], "sizes"))
    in_shape = list(x.shape)
    if sizes is not None:
        out_shape = list(sizes)
        scales = [o / i for o, i in zip(out_shape, in_shape)]
    else:
        out_shape = [int(math.floor(i * s))
                     for i, s in zip(in_shape, scales)]
    if mode not in ("nearest", "linear"):
        raise NotImplementedError(f"Resize mode {mode!r}")

    host = _is_host(x)
    out = np.asarray(x) if host else x
    float_path = (out.dtype.kind == "f") if host else out.is_floating_point()
    if float_path and not host:
        # the JAX package resamples by an f32 matrix, which promotes a
        # bf16 input to f32 until the final cast
        out = out.to(torch.promote_types(out.dtype, torch.float32))
    for axis in range(x.ndim):
        if out_shape[axis] == in_shape[axis] and scales[axis] == 1.0:
            continue
        lo, hi, w = _resize_axis_indices(
            in_shape[axis], out_shape[axis], scales[axis],
            coord_mode, nearest_mode, linear=(mode == "linear"))
        n_in, n_out = in_shape[axis], out_shape[axis]
        if float_path:
            # the per-axis interpolation weights as a static [out, in]
            # matrix; the resample is one matmul per axis
            W = np.zeros((n_out, n_in), np.float32)
            if w is None:
                W[np.arange(n_out), lo] = 1.0
            else:
                np.add.at(W, (np.arange(n_out), lo), 1.0 - w)
                np.add.at(W, (np.arange(n_out), hi), w)
            if host:
                out = np.moveaxis(np.tensordot(out, W, axes=[[axis], [1]]),
                                  -1, axis)
            else:
                Wt = torch.as_tensor(W, device=out.device, dtype=out.dtype)
                out = torch.tensordot(out, Wt, dims=([axis], [1]))
                out = torch.movedim(out, -1, axis)
        elif w is None:
            # integer nearest: keep the exact dtype (a float matmul would
            # round large ints)
            out = np.take(out, lo, axis=axis) if host else _take(
                out, torch.as_tensor(lo, device=out.device), axis)
        else:
            bshape = [1] * out.ndim
            bshape[axis] = len(w)
            if host:
                a, b = np.take(out, lo, axis=axis), np.take(out, hi, axis=axis)
                wj = w.reshape(bshape)
            else:
                a = _take(out, torch.as_tensor(lo, device=out.device), axis)
                b = _take(out, torch.as_tensor(hi, device=out.device), axis)
                wj = torch.as_tensor(w, device=out.device).reshape(bshape)
            out = a * (1.0 - wj) + b * wj
    if float_path:
        # Resize preserves T
        out = out.astype(np.asarray(x).dtype) if host else out.to(x.dtype)
    return out


# inputs that must stay host constants (static shapes, never device
# tensors): (op_type, input index)
_HOST_INPUTS = {
    ("Reshape", 1), ("Resize", 1), ("Resize", 2), ("Resize", 3),
    ("Upsample", 1), ("Slice", 1), ("Slice", 2), ("Slice", 3), ("Slice", 4),
    ("Pad", 1), ("Expand", 1), ("ConstantOfShape", 0), ("Tile", 1),
    ("Squeeze", 1), ("Unsqueeze", 1), ("Split", 1),
    ("Range", 0), ("Range", 1), ("Range", 2),
    ("ReduceMean", 1), ("ReduceSum", 1), ("ReduceMax", 1), ("ReduceMin", 1),
    ("ReduceProd", 1), ("Gather", 1),
}


class OnnxModule:
    """Executable ONNX graph: ``module(params, *inputs) -> outputs``.

    ``params`` is the dict of float weights (numpy in :attr:`params`; pass
    them as tensors on the device, moved once and reused); host-constant
    tensors (shapes, indices, scales) stay numpy so every reshape and
    resize has a static shape.
    """

    def __init__(self, graph: OnnxGraph):
        self.graph = graph
        self.input_names = list(graph.input_names)
        self.output_names = list(graph.output_names)
        baked_names = self._baked_names(graph)
        self.constants: Dict[str, np.ndarray] = {
            k: v for k, v in graph.initializers.items() if k in baked_names}
        self.params: Dict[str, np.ndarray] = {
            k: v for k, v in graph.initializers.items()
            if k not in baked_names}
        unknown = sorted({n.op_type for n in graph.nodes} - set(_OPS))
        if unknown:
            raise NotImplementedError(
                f"ONNX ops not supported by the executor: {unknown}")

    @staticmethod
    def _baked_names(graph: OnnxGraph) -> set:
        """Initializers consumed (anywhere) through a host-only input slot,
        plus every non-float initializer (indices/shapes/masks)."""
        baked = {k for k, v in graph.initializers.items()
                 if v.dtype.kind in "iub"}
        for node in graph.nodes:
            for idx, name in enumerate(node.inputs):
                if (node.op_type, idx) in _HOST_INPUTS and \
                        name in graph.initializers:
                    baked.add(name)
        return baked

    def device_params(self, device, dtype=None) -> Dict[str, torch.Tensor]:
        """:attr:`params` as tensors on ``device``, floats cast to
        ``dtype`` when given."""
        out = {}
        for k, v in self.params.items():
            t = torch.from_numpy(np.array(v))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            out[k] = t.to(device)
        return out

    def __call__(self, params: Dict[str, Any], *inputs):
        if len(inputs) != len(self.input_names):
            raise ValueError(
                f"expected {len(self.input_names)} inputs "
                f"({self.input_names}), got {len(inputs)}")
        env: Dict[str, Any] = dict(self.constants)
        env.update(params)
        env.update(zip(self.input_names, inputs))
        opset = self.graph.opset
        for node in self.graph.nodes:
            fn = _OPS[node.op_type]
            vals = [env.get(n) if n else None for n in node.inputs]
            if node.op_type == "Softmax":
                out = fn(node, vals, {"opset": opset})
            else:
                out = fn(node, vals)
            if isinstance(out, tuple):
                for name, v in zip(node.outputs, out):
                    if name:
                        env[name] = v
            else:
                env[node.outputs[0]] = out
        outs = tuple(env[n] for n in self.output_names)
        return outs if len(outs) > 1 else outs[0]


def build_module(graph: OnnxGraph) -> OnnxModule:
    return OnnxModule(graph)


def load_onnx_module(path: str) -> OnnxModule:
    """Parse an .onnx file and return an executable :class:`OnnxModule`."""
    return build_module(parse_onnx(path))
