"""Device mesh and the sharded programs (counterpart of
``person_capture_tpu/parallel/mesh.py``): the pre-scan step, the spatially
sharded full-frame detect and the SCRFD train step.

The frame batch is data-parallel over the mesh's ``data`` axis: each
data-axis replica is a :class:`~..pipeline.backends.ScrfdArcFaceBackend`
on its own device, built from the same weights, and runs its contiguous
rows of the batch on its own CUDA stream. Wide layers (every conv and dense
whose output channels divide the ``model`` axis) split their output
channels over the replica's ``model``-axis devices (:class:`ColumnParallel`):
the input is broadcast, each device computes its slice of the channels, and
the slices are gathered back. That is the placement rule of the JAX
package's ``shard_params_for_tp`` (``kernel.shape[-1] % tp``), and it
computes the same outputs. XLA inserts those collectives for the JAX
package; here every exchange between the devices of a replica's row goes
through one object, :class:`RowComm`: copies between the row's devices in
one process, a gloo subgroup per row across processes.

Across processes (parallel/multihost.py) the mesh lists every process's
devices in rank order. A replica's ``model`` axis may span processes: each
process then computes the whole replica with the column slices of its own
devices, and the slices are all-gathered over the row's subgroup. Under
torchrun each process takes its ``LOCAL_RANK`` share of the host's cards;
two processes that would compute on one card are refused unless
``PERSON_CAPTURE_SHARE_CARDS=1`` asks for it (a test on one card).
"""

from __future__ import annotations

import contextlib
import copy
import os
import re
import socket
import threading
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

DATA, MODEL = "data", "model"
SHARE_CARDS_ENV = "PERSON_CAPTURE_SHARE_CARDS"


def parse_mesh_spec(spec: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Parse ``"data:4,model:2"`` → (("data","model"), (4,2))."""
    names, sizes = [], []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"(\w+):(\d+)", part)
        if not m:
            raise ValueError(f"bad mesh spec element: {part!r}")
        names.append(m.group(1))
        sizes.append(int(m.group(2)))
    return tuple(names), tuple(sizes)


@dataclass
class Mesh:
    """Named axes over an array of ``torch.device``s; ``owners`` holds the
    rank of the process that owns each entry (all 0 in one process)."""

    devices: np.ndarray          # object array of torch.device
    axis_names: Tuple[str, ...]
    owners: np.ndarray           # int array, devices' shape
    _comms: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _along(self, arr: np.ndarray, inner: str = MODEL):
        """``arr`` as ``[replicas, inner]``: the data axis first, the
        ``inner`` axis second, index 0 along every other axis (they
        replicate)."""
        names = self.axis_names
        lead = [names.index(a) for a in (DATA, inner) if a in names]
        rest = [i for i in range(len(names)) if i not in lead]
        arr = np.transpose(arr, lead + rest)[
            (slice(None),) * len(lead) + (0,) * len(rest)]
        if DATA not in names:
            arr = arr[None]
        if inner not in names:
            arr = arr[..., None]
        return arr

    def replica_devices(self) -> np.ndarray:
        """``[replicas, model]`` array of devices: one row per data-axis
        replica, its model-axis devices in order."""
        return self._along(self.devices)

    def replica_owners(self, axis: str = MODEL) -> np.ndarray:
        """The rank that leads each replica: the owner of its first
        ``axis`` device, which hands the replica's rows to the others
        (:func:`.multihost.gather_rows`)."""
        return self._along(self.owners, axis)[:, 0]

    def num_replicas(self) -> int:
        return int(self.shape.get(DATA, 1))

    def local_replicas(self, axis: str = MODEL) -> list:
        """Indices of the replicas this process computes: those in which it
        holds a device of the replica's ``axis`` row."""
        from .multihost import process_index

        owners = self._along(self.owners, axis)
        return [int(r) for r in
                np.flatnonzero((owners == process_index()).any(axis=1))]

    def row_comms(self, axis: str = MODEL) -> list:
        """One :class:`RowComm` per replica over its ``axis`` devices. The
        gloo subgroups of rows that span processes are made on the first
        call, in replica order, so every process must make this call
        (``dist.new_group`` is collective); the sharded builders do."""
        if axis not in self._comms:
            rows = self._along(self.devices, axis)
            owners = self._along(self.owners, axis)
            comms = []
            for devs, own in zip(rows, owners):
                ranks = sorted(set(int(o) for o in own))
                group = None
                if len(ranks) > 1:
                    import torch.distributed as dist

                    group = dist.new_group(ranks, backend="gloo")
                comms.append(RowComm(list(devs), [int(o) for o in own],
                                     group))
            self._comms[axis] = comms
        return self._comms[axis]


class RowComm:
    """The exchange between the devices of one replica's row (its
    ``model``-axis devices, in order), for the column split and the spatial
    split alike.

    Each method takes this process's parts, one per local position
    (``self.local``, in row order). In one process the parts are copied
    between the row's devices; across processes (``group``, a gloo
    subgroup of the row's ranks) each process's parts go through the host
    to the others: gloo takes CPU tensors, and it lets two ranks share one
    card, which NCCL refuses. The owners along a row rise with the
    position (the mesh lists devices in rank order), so the group's rank
    order is the row's order.
    """

    def __init__(self, devices, owners=None, group=None):
        from .multihost import process_index

        self.devices = [torch.device(d) for d in devices]
        me = process_index()
        self.owners = (list(owners) if owners is not None
                       else [me] * len(self.devices))
        self.local = [j for j, o in enumerate(self.owners) if o == me]
        self.home = self.devices[self.local[0]] if self.local else None
        self.group = group

    def everyone(self, parts, dim: int, sizes=None) -> list:
        """Every position's part on ``home``, in row order. ``sizes``: each
        position's extent along ``dim`` (default: that of ``parts[0]`` for
        all), needed only across processes, where each process's parts are
        padded to the largest block and cut back after the all-gather."""
        if self.group is None:
            return [p.to(self.home, non_blocking=True) for p in parts]
        import torch.distributed as dist

        n = len(self.devices)
        sizes = list(sizes) if sizes is not None else [parts[0].shape[dim]] * n
        ranks = sorted(set(self.owners))
        blocks = [[j for j in range(n) if self.owners[j] == r] for r in ranks]
        width = max(sum(sizes[j] for j in b) for b in blocks)
        mine = torch.cat(parts, dim).cpu()
        shape = list(mine.shape)
        shape[dim] = width
        wire = mine.new_zeros(shape)
        wire.narrow(dim, 0, mine.shape[dim]).copy_(mine)
        if wire.dtype == torch.bfloat16:
            # gloo has no bf16; an all-gather only moves the bits
            wire = wire.view(torch.float16)
        got = [torch.empty_like(wire) for _ in ranks]
        dist.all_gather(got, wire, group=self.group)
        # the parts' memory format (a conv's channels-last output), which
        # picks the next layer's kernels as in one process
        fmt = (torch.channels_last if parts[0].dim() == 4
               and not parts[0].is_contiguous()
               and parts[0].is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        out = []
        for block, positions in zip(got, blocks):
            block = block.view(mine.dtype)
            at = 0
            for j in positions:
                out.append(block.narrow(dim, at, sizes[j]).to(self.home)
                           .contiguous(memory_format=fmt))
                at += sizes[j]
        return out

    def all_gather(self, parts, dim: int, sizes=None):
        """The row's parts concatenated along ``dim`` on ``home`` (on every
        process of the row). Differentiable in one process."""
        return torch.cat(self.everyone(parts, dim, sizes), dim)

    def all_reduce(self, parts) -> list:
        """The sum of every part of the row, one copy on each local part's
        device; differentiable (the gradient of each part is the sum of
        the outputs' gradients)."""
        return list(_AllReduce.apply(self, *parts))

    def _sum(self, parts) -> list:
        total = sum(p.to(self.home) for p in parts)
        if self.group is not None:
            import torch.distributed as dist

            host = total.cpu()
            dist.all_reduce(host, group=self.group)
            total = host.to(self.home)
        return [total.to(p.device, copy=True) for p in parts]

    def exchange_rows(self, parts, rows: int, sizes) -> list:
        """Each local slab (``[B, C, h, W]``, split along H over the row,
        ``sizes`` every slab's ``h``) with ``rows`` rows of the slabs above
        and below it added, zeros past the canvas edges: a slab with fewer
        rows (or none) passes on its neighbour's."""
        counts = [min(rows, h) for h in sizes]
        edges = self.everyone(
            [torch.stack([p[:, :, :k], p[:, :, p.shape[2] - k:]])
             for p, k in zip(parts, (counts[j] for j in self.local))],
            3, counts)
        out = []
        for p, j in zip(parts, self.local):
            none = p[:, :, :0]
            above = torch.cat([none] + [e[1].to(p.device) for e in edges[:j]],
                              2)
            below = torch.cat([none] + [e[0].to(p.device)
                                        for e in edges[j + 1:]], 2)
            above = above[:, :, max(0, above.shape[2] - rows):]
            below = below[:, :, :rows]
            out.append(F.pad(torch.cat([above, p, below], 2),
                             (0, 0, rows - above.shape[2],
                              rows - below.shape[2])))
        return out


class _AllReduce(torch.autograd.Function):
    """:meth:`RowComm.all_reduce` as one autograd node over every part, so
    one backward through it sums the gradients without a second meeting."""

    @staticmethod
    def forward(ctx, comm, *parts):
        ctx.comm = comm
        ctx.like = [(p.shape, p.dtype, p.device) for p in parts]
        return tuple(comm._sum(parts))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g if g is not None else torch.zeros(s, dtype=t, device=d)
                 for g, (s, t, d) in zip(grads, ctx.like)]
        return (None, *ctx.comm._sum(grads))


class Lockstep:
    """Lets one thread per local position of a row call a collective of
    :class:`RowComm` as its one caller: each thread leaves its part, one of
    them calls ``fn(parts)`` once all have, and each takes its own
    result."""

    def __init__(self, n: int):
        self._barrier = threading.Barrier(n)
        self._parts = [None] * n
        self._out = None

    def together(self, i: int, x, fn):
        self._parts[i] = x
        if self._barrier.wait() == 0:
            try:
                self._out = fn(list(self._parts))
            except BaseException:
                self._barrier.abort()
                raise
        self._barrier.wait()
        return self._out[i]

    def run(self, fns) -> list:
        """``[fn() for fn in fns]``, each in a thread of its own that meets
        the others through this lockstep; the first failure breaks the
        lockstep (so no thread waits for it) and is raised."""
        if len(fns) == 1:
            return [fns[0]()]
        self._barrier.reset()         # a failed call leaves it broken
        results, errors = [None] * len(fns), [None] * len(fns)

        def work(i):
            try:
                results[i] = fns[i]()
            except BaseException as exc:     # re-raised below
                errors[i] = exc
                self._barrier.abort()

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in range(len(fns))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            raise next((e for e in failed
                        if not isinstance(e, threading.BrokenBarrierError)),
                       failed[0])
        return results


def local_cards() -> list:
    """Indices of the CUDA devices this process computes on: its share of
    the visible cards under torchrun (``LOCAL_RANK`` of
    ``LOCAL_WORLD_SIZE``; a card of its own when there are fewer cards than
    processes on the host), else every visible card."""
    n = torch.cuda.device_count()
    local_rank = os.environ.get("LOCAL_RANK")
    local_size = os.environ.get("LOCAL_WORLD_SIZE")
    if local_rank is None or local_size is None or n == 0:
        return list(range(n))
    if n >= int(local_size):
        per = n // int(local_size)
        return list(range(int(local_rank) * per, (int(local_rank) + 1) * per))
    return [int(local_rank) % n]


def _card_key(i: int) -> str:
    """The physical card behind ``cuda:i`` of this process (host, UUID)."""
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(i).uuid}"


def _refuse_shared_cards(keyed: list) -> None:
    """``keyed[rank]`` holds that process's ``(index, card key)`` pairs:
    raise ``ValueError`` when two processes would compute on one card,
    unless ``PERSON_CAPTURE_SHARE_CARDS=1`` asks for it."""
    if os.environ.get(SHARE_CARDS_ENV) == "1":
        return
    seen = {}
    for rank, mine in enumerate(keyed):
        for _, key in mine:
            if seen.setdefault(key, rank) != rank:
                raise ValueError(
                    f"processes {seen[key]} and {rank} would compute on one "
                    f"card ({key}): give each process its own cards "
                    "(torchrun --nproc_per_node at most the cards of the "
                    "host, or CUDA_VISIBLE_DEVICES), or set "
                    f"{SHARE_CARDS_ENV}=1 to share them on purpose")


def _global_devices(device: str, need: int):
    """``(devices, owners)`` of the whole cluster in rank order. CUDA: each
    process's :func:`local_cards`. CPU: ``ceil(need / processes)`` virtual
    ``cpu`` entries per process (the counterpart of the JAX tests' 8-device
    host platform)."""
    from .multihost import is_multiprocess, process_count

    if torch.device(device).type == "cpu":
        per = -(-max(need, 1) // process_count())
        cards = [[None] * per] * process_count()
    elif not is_multiprocess():
        cards = [local_cards()]
    else:
        import torch.distributed as dist

        keyed = [None] * process_count()
        dist.all_gather_object(keyed,
                               [(i, _card_key(i)) for i in local_cards()])
        _refuse_shared_cards(keyed)
        cards = [[i for i, _ in mine] for mine in keyed]
    devices, owners = [], []
    for rank, mine in enumerate(cards):
        for i in mine:
            devices.append(torch.device("cpu") if i is None
                           else torch.device("cuda", i))
            owners.append(rank)
    return devices, owners


def make_mesh(spec: str = "", devices=None, device: str = "cuda") -> Mesh:
    """Build a Mesh from a spec string; default: all devices on one
    ``data`` axis. ``devices`` (all owned by this process) overrides the
    cluster's list, e.g. ``[cuda:0] * 4`` puts a ``data:2,model:2`` mesh on
    one card; ``device="cpu"`` takes virtual CPU entries."""
    names, sizes = parse_mesh_spec(spec)
    need = int(np.prod(sizes)) if sizes else 0
    if devices is not None:
        from .multihost import process_index

        devices = [torch.device(d) for d in devices]
        owners = [process_index()] * len(devices)
    else:
        devices, owners = _global_devices(device, need)
    if not names:
        names, sizes, need = (DATA,), (len(devices),), len(devices)
    if need > len(devices) or need == 0:
        raise ValueError(f"mesh {spec or 'data:all'} needs {need} "
                         f"devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(sizes), tuple(names),
                np.asarray(owners[:need]).reshape(sizes))


class ColumnParallel(nn.Module):
    """An ``nn.Conv2d`` or ``nn.Linear`` with its output channels split over
    a row of devices (:class:`RowComm`): each device holds one contiguous
    slice of the channels (and, for a grouped conv, the matching groups);
    the input goes to every device, and the slices are all-gathered in row
    order on the row's ``home``. A process holds only the slices of its own
    devices. Same outputs as the layer it wraps."""

    def __init__(self, layer: nn.Module, row: RowComm):
        super().__init__()
        self.row = row
        tp = len(self.row.devices)
        self.conv = isinstance(layer, nn.Conv2d)
        self.split_input = self.conv and layer.groups > 1
        self.shards = nn.ModuleList(
            _column_slice(layer, j, tp).to(self.row.devices[j])
            for j in self.row.local)

    def forward(self, x):
        tp = len(self.row.devices)
        xs = x.chunk(tp, dim=1) if self.split_input else [x] * tp
        outs = [shard(xs[j].to(self.row.devices[j], non_blocking=True))
                for shard, j in zip(self.shards, self.row.local)]
        return self.row.all_gather(outs, dim=1 if self.conv else -1)


def _column_slice(layer: nn.Module, j: int, tp: int) -> nn.Module:
    """Output channels ``[j·n/tp, (j+1)·n/tp)`` of ``layer`` as a layer of
    its own (a grouped conv keeps ``groups/tp`` of its groups)."""
    w = layer.weight
    n = w.shape[0] // tp
    sl = slice(j * n, (j + 1) * n)
    kw = dict(device=w.device, dtype=w.dtype, bias=layer.bias is not None)
    if isinstance(layer, nn.Linear):
        part = nn.Linear(layer.in_features, n, **kw)
    else:
        groups = layer.groups // tp if layer.groups > 1 else 1
        cin = layer.in_channels // tp if layer.groups > 1 else \
            layer.in_channels
        part = nn.Conv2d(cin, n, layer.kernel_size, layer.stride,
                         layer.padding, layer.dilation, groups,
                         padding_mode=layer.padding_mode, **kw)
    with torch.no_grad():
        part.weight.copy_(w[sl])
        if layer.bias is not None:
            part.bias.copy_(layer.bias[sl])
    return part


def _splits(layer: nn.Module, tp: int) -> bool:
    if isinstance(layer, nn.Linear):
        return layer.out_features % tp == 0
    if isinstance(layer, nn.Conv2d):
        return (layer.out_channels % tp == 0
                and (layer.groups == 1 or layer.groups % tp == 0))
    return False


def shard_params_for_tp(module: nn.Module, mesh: Mesh,
                        replica: int = 0) -> nn.Module:
    """Place one replica's module on the mesh: every ``Conv2d`` and
    ``Linear`` whose output channels divide the model-axis size is wrapped
    in :class:`ColumnParallel` over the replica's model-axis row;
    everything else stays on the row's first device of this process
    (``RowComm.home``). Returns ``module``."""
    row = mesh.row_comms()[replica]
    module.to(row.home)
    if len(row.devices) == 1:
        return module
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if _splits(child, len(row.devices)):
                setattr(parent, name, ColumnParallel(child, row))
    return module


def shard_batch(mesh: Mesh, n: int):
    """Row slices of a batch of ``n`` over the data axis: ``data``
    contiguous slices in mesh order (``n`` must divide)."""
    d = mesh.num_replicas()
    if n % d:
        raise ValueError(f"batch {n} does not divide over the "
                         f"'{DATA}' axis of size {d}")
    per = n // d
    return [slice(i * per, (i + 1) * per) for i in range(d)]


OUTPUT_KEYS = ("best_fd", "per_face_fd", "boxes", "kps", "scores", "mask",
               "feats", "quality")


def build_sharded_prescan_step(mesh: Mesh, scrfd_cfg=None, arcface_cfg=None,
                               det_size: int = 640, max_faces: int = 8,
                               dtype=None, seed: int = 0,
                               scrfd_vars=None, arcface_vars=None,
                               use_arcface: bool = True, clip_face_cfg=None,
                               embed_slots: int = 0):
    """Create the pre-scan step over a mesh.

    Step signature: ``(frames_u8 [B,H,W,3], bank [K,D], bank_mask [K],
    score_thresh) -> dict`` of ``best_fd [B]`` and the per-face outputs
    (``per_face_fd``, ``boxes``, ``kps``, ``scores``, ``mask``, ``feats``,
    ``quality``), in row order. Frames split over ``data``; the bank goes
    to every replica; wide layers split over ``model``.

    Each local replica is the single-device face chain
    (``ScrfdArcFaceBackend`` with BGR transfer) on its own device, with the
    same detector, embedder and settings: a ``YoloConfig`` with a 5-point
    head as ``scrfd_cfg`` (YOLOv8-face), ``.onnx`` weights (run by
    models/onnx_zoo, replicated: ONNX tensor names carry no layout to
    split), ``use_arcface=False`` with a CLIP tower, ``embed_slots``.

    Across processes every process gets the whole result (a gloo all-gather
    of the small per-frame outputs, parallel/multihost), as the host replay
    needs; a replica whose model axis spans processes is computed by each
    of them, with its column slices gathered over the row's subgroup.
    ``run.scrfd_vars`` and ``run.arcface_vars`` are the weights as given
    (``None``: the seeded init, the same on every replica).
    """
    from ..core.bank import fd_min_batch
    from ..pipeline.backends import ScrfdArcFaceBackend, unpack_faces
    from .multihost import gather_rows, is_multiprocess, make_global_batch

    rows_of = mesh.row_comms()

    def make_replica(r):
        be = ScrfdArcFaceBackend(
            scrfd_cfg, arcface_cfg, det_size=det_size, max_faces=max_faces,
            dtype=dtype, seed=seed, scrfd_weights=scrfd_vars,
            arcface_weights=arcface_vars, transfer_format="bgr",
            use_arcface=use_arcface, clip_face_cfg=clip_face_cfg,
            embed_slots=embed_slots, device=rows_of[r].home)
        for model in (be.scrfd_model, be.arcface_model, be.clip_model):
            if isinstance(model, nn.Module):     # not an ONNX graph
                shard_params_for_tp(model, mesh, replica=r)
        return be

    replicas = [make_replica(r) for r in mesh.local_replicas()]
    streams = [torch.cuda.Stream(device=be.device)
               if be.device.type == "cuda" else None for be in replicas]

    @torch.inference_mode()
    def replica_step(be, rows_u8, bank, bank_mask, score_thresh):
        be.score_thresh = score_thresh
        out = unpack_faces(be._fused_bgr(be._upload(rows_u8).float()))
        out["per_face_fd"], out["best_fd"] = fd_min_batch(
            out["feats"], out["mask"], be._upload(bank),
            be._upload(bank_mask))
        return out

    def run(frames_u8, bank, bank_mask, score_thresh=0.5):
        frames_u8 = np.asarray(frames_u8)
        per = shard_batch(mesh, frames_u8.shape[0])[0].stop
        # multi-process: only the rows this process's replicas own
        rows = make_global_batch(mesh, frames_u8)
        bank = np.asarray(bank, np.float32)
        bank_mask = np.asarray(bank_mask, bool)
        outs = []
        for i, (be, stream) in enumerate(zip(replicas, streams)):
            with _on(stream):
                outs.append(replica_step(be, rows[i * per:(i + 1) * per],
                                         bank, bank_mask,
                                         float(score_thresh)))
        if not is_multiprocess():
            return _concat_rows(outs, streams)
        local_rows = ({k: v.cpu().numpy()
                       for k, v in _concat_rows(outs, streams).items()}
                      if outs else {})
        return {k: torch.from_numpy(v)
                for k, v in gather_rows(local_rows, mesh).items()}

    run.scrfd_vars = scrfd_vars
    run.arcface_vars = arcface_vars
    run.mesh = mesh
    run.replicas = replicas
    run.embed_dim = _embed_dim(replicas)
    return run


DETECT_KEYS = ("boxes", "kps", "scores", "mask")


def build_sharded_fullframe_detect(mesh: Mesh, scrfd_cfg=None,
                                   det_size: int = 1408, max_faces: int = 8,
                                   dtype=None, seed: int = 0,
                                   scrfd_vars=None,
                                   spatial_axis: str = MODEL):
    """Spatially sharded heavy-canvas SCRFD detection.

    The padded canvas batch ``[B, S, S, 3]`` splits over ``data`` (B), and
    each replica's canvases split along H over ``spatial_axis`` into
    contiguous slabs, one per device; the weights replicate. What XLA
    inserts for the JAX package is explicit here, through the row's
    :class:`RowComm`, with one thread per slab in lockstep:

    * before every conv each slab takes ``kernel // 2`` rows of its
      neighbours (zeros at the canvas edges) and convolves with no vertical
      padding, which gives the global conv's rows when each slab is a whole
      number of the deepest stride's rows (``max(cfg.strides)``: 32);
    * every GroupNorm of the head takes the moments of the whole map,
      summed over the row (a slab's own moments give other scores);
    * upsampling, BatchNorm (eval), 1×1 convs and ReLUs stay per slab;
    * the level maps are gathered along H in slab order on the row's first
      device, where the decode, top-k and NMS run as in ``detect_faces``.

    The canvas splits in rows of 32, as evenly as they go (the first slabs
    take one more; a slab may get none); ``S`` must divide over the axis,
    as the JAX function requires, else ``ValueError``. Across processes a
    replica's row may span them: each process computes its slabs, and
    every process gets the whole result, as the pre-scan step's.

    Returns ``run(padded [B,S,S,3] float32, scales [B], score_thresh)`` →
    dict of ``boxes``, ``kps``, ``scores``, ``mask`` in row order, with
    ``run.spatial``, ``run.mesh`` and ``run.scrfd_vars`` (the weights as
    given; ``None``: the seeded init).
    """
    import functools

    from ..models import scrfd as SD
    from ..models.bridge import load_scrfd
    from ..ops.preprocess import normalize_scrfd
    from ..pipeline.backends import _random_init
    from .multihost import gather_rows, is_multiprocess, make_global_batch

    cfg = scrfd_cfg or SD.SCRFD_2_5G
    dtype = dtype or torch.bfloat16
    det_size = int(det_size)
    SD.check_det_size(cfg, det_size)
    rows_of = mesh.row_comms(spatial_axis)
    tp = len(rows_of[0].devices)
    if det_size % tp:
        raise ValueError(
            f"face_fullframe_imgsz / --det-size {det_size} does not split "
            f"over the '{spatial_axis}' axis of size {tp}: give a det size "
            f"that is a multiple of {tp} (the JAX package refuses it too)")
    grain = max(cfg.strides)
    units = [len(u) for u in np.array_split(np.arange(det_size // grain),
                                            tp)]
    tops = np.cumsum([0] + units) * grain
    model = SD.SCRFD(cfg)
    if scrfd_vars is None:
        _random_init(model, seed)
    else:
        load_scrfd(model, scrfd_vars)
    model = model.eval().to(dtype=dtype)

    replicas = []
    for r in mesh.local_replicas(spatial_axis):
        row = _SpatialRow(rows_of[r], units)
        replicas.append((row, [
            _slab_model(model, row, i, row.comm.devices[j])
            for i, j in enumerate(row.comm.local)]))

    def slab_levels(models, i, j, device, canvas):
        with torch.inference_mode():
            x = torch.from_numpy(canvas[:, tops[j]:tops[j + 1]]).to(device)
            x = normalize_scrfd(x).permute(0, 3, 1, 2).to(dtype)
            return models[i](x)

    def replica_detect(row, models, canvas, scales, score_thresh):
        comm = row.comm
        levels = row.lock.run([
            functools.partial(slab_levels, models, i, j, comm.devices[j],
                              canvas) for i, j in enumerate(comm.local)])
        with torch.inference_mode():
            full = [tuple(comm.all_gather(
                [lv[level][m] for lv in levels], 2,
                row.heights(levels[0][level][m].shape[3])) for m in range(3))
                for level in range(len(cfg.strides))]
            return SD.detections_from_levels(
                cfg, full, torch.from_numpy(scales).to(comm.home),
                score_thresh, max_faces)

    def run(padded, scales, score_thresh=0.5):
        padded = np.asarray(padded, np.float32)
        scales = np.asarray(scales, np.float32)
        if padded.shape[1:] != (det_size, det_size, 3):
            raise ValueError(f"canvases {padded.shape[1:]} are not the "
                             f"det size's ({det_size}, {det_size}, 3)")
        per = shard_batch(mesh, padded.shape[0])[0].stop
        canvases = make_global_batch(mesh, padded, spatial_axis)
        row_scales = make_global_batch(mesh, scales, spatial_axis)
        outs = [replica_detect(row, models, canvases[k * per:(k + 1) * per],
                               row_scales[k * per:(k + 1) * per],
                               float(score_thresh))
                for k, (row, models) in enumerate(replicas)]
        if not is_multiprocess():
            home = outs[0]["boxes"].device
            return {k: torch.cat([o[k].to(home) for o in outs])
                    for k in DETECT_KEYS}
        local_rows = ({k: torch.cat([o[k].cpu() for o in outs]).numpy()
                       for k in DETECT_KEYS} if outs else {})
        return {k: torch.from_numpy(v) for k, v in
                gather_rows(local_rows, mesh, spatial_axis).items()}

    run.scrfd_vars = scrfd_vars
    run.mesh = mesh
    run.spatial = spatial_axis in mesh.axis_names
    return run


class _SpatialRow:
    """One replica's slabs in this process: the row's exchange, the
    lockstep of its slab threads, and each slab's share of the canvas in
    units of the deepest stride's rows."""

    def __init__(self, comm: RowComm, units):
        self.comm = comm
        self.units = list(units)
        self.lock = Lockstep(len(comm.local))

    def heights(self, width: int) -> list:
        """Every slab's rows in a map ``width`` wide (the maps are square:
        a map ``width`` wide has ``width`` rows in all)."""
        total = sum(self.units)
        return [u * width // total for u in self.units]


def _slab_model(model: nn.Module, row: _SpatialRow, i: int, device):
    """A copy of ``model`` on ``device`` that computes local slab ``i`` of
    ``row``: every conv exchanges halo rows, every GroupNorm takes the
    moments of the whole map."""
    slab = copy.deepcopy(model).to(device)
    for parent in list(slab.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Conv2d):
                setattr(parent, name, _HaloConv(child, row, i))
            elif isinstance(child, nn.GroupNorm):
                setattr(parent, name, _SlabGroupNorm(child, row, i))
    return slab


class _HaloConv(nn.Module):
    """A ``Conv2d`` over one slab: its vertical zero padding becomes rows of
    the neighbouring slabs (zeros only past the canvas edges), so the
    slab's output rows are those of the conv over the whole canvas."""

    def __init__(self, conv: nn.Conv2d, row: _SpatialRow, i: int):
        super().__init__()
        self.conv, self.row, self.i = conv, row, i

    def forward(self, x):
        conv = self.conv
        pad = conv.padding[0]
        own = x.shape[2]
        if pad:
            heights = self.row.heights(x.shape[3])
            x = self.row.lock.together(
                self.i, x,
                lambda parts: self.row.comm.exchange_rows(parts, pad,
                                                          heights))
        if own == 0:
            width = (x.shape[3] + 2 * conv.padding[1]
                     - conv.dilation[1] * (conv.kernel_size[1] - 1) - 1) \
                // conv.stride[1] + 1
            return x.new_zeros(x.shape[0], conv.out_channels, 0, width)
        return F.conv2d(x, conv.weight, conv.bias, conv.stride,
                        (0, conv.padding[1]), conv.dilation, conv.groups)


class _SlabGroupNorm(nn.Module):
    """A ``GroupNorm`` over one slab with the moments of the whole map: the
    slabs' sums, then their squared deviations from the mean, summed over
    the row."""

    def __init__(self, norm: nn.GroupNorm, row: _SpatialRow, i: int):
        super().__init__()
        self.norm, self.row, self.i = norm, row, i

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.norm.num_groups
        count = c // g * x.shape[3] ** 2          # the whole square map
        xf = x.float().reshape(b, g, -1)
        mean = self.row.lock.together(
            self.i, xf.sum(-1), self.row.comm.all_reduce)[..., None] / count
        dev = xf - mean
        var = self.row.lock.together(
            self.i, (dev * dev).sum(-1),
            self.row.comm.all_reduce)[..., None] / count
        y = (dev * torch.rsqrt(var + self.norm.eps)).reshape(x.shape)
        w = self.norm.weight.float().view(1, c, 1, 1)
        return (y * w + self.norm.bias.float().view(1, c, 1, 1)).to(x.dtype)


def build_sharded_train_step(mesh: Mesh, scrfd_cfg=None, size: int = 128,
                             lr: float = 1e-3, seed: int = 0, dtype=None):
    """The SCRFD training step over a mesh, equal to the single-device step
    on the global batch.

    The scene batch and its targets split over ``data``, one replica per
    data-axis row, each with its wide layers split over ``model``
    (:class:`ColumnParallel`, autograd through the copies). What XLA's SPMD
    step does implicitly is explicit here: the replicas run in lockstep,
    one thread each, and every BatchNorm takes its training moments over
    the global batch (a differentiable sum over the replicas; the running
    statistics follow flax's rule with the biased variance and the global
    count); the loss's positive-anchor normaliser ``npos`` is the global
    batch's; the replicas' gradients are summed onto one master copy of the
    parameters, which takes one ``optax.adamw`` step (constant ``lr``,
    weight decay 1e-4 on every leaf); the replicas copy the master before
    each step. ``dtype=torch.bfloat16`` computes under autocast.

    One process, as the JAX step (it takes host arrays and builds no global
    batch): a mesh across processes raises ``ValueError``.

    Returns ``(step, state, model)``: ``state`` holds the master ``model``
    and its optimizer, and ``step(state, images_u8 [B,S,S,3], targets) ->
    (state, {"loss", "npos"})``; after a step the master's ``.grad`` hold
    that step's gradients.
    """
    import functools

    from ..models import scrfd as SD
    from ..train.loop import to_device
    from ..train.scrfd_synth import init_model, make_loss_fn
    from .multihost import is_multiprocess

    if is_multiprocess():
        raise ValueError(
            "build_sharded_train_step runs in one process, as the JAX "
            "step does (host arrays, no global batch): give it a mesh of "
            "this process's devices (make_mesh(spec, devices=...))")
    cfg = scrfd_cfg or SD.TINY
    SD.check_det_size(cfg, size)
    rows_of = mesh.row_comms()
    model = init_model(cfg, seed).to(rows_of[0].home).train()
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    # the replicas' first devices, where BatchNorm's moments meet
    across = RowComm([row.home for row in rows_of])
    lock = Lockstep(len(rows_of))
    replicas = []
    for r in range(len(rows_of)):
        rep = shard_params_for_tp(copy.deepcopy(model), mesh, r)
        for parent in list(rep.modules()):
            for name, child in list(parent.named_children()):
                if isinstance(child, nn.BatchNorm2d):
                    setattr(parent, name,
                            _GlobalBatchNorm(child, across, lock, r))
        replicas.append(rep)
    params, buffers = _pieces(replicas, model)
    loss_fns = [make_loss_fn(rep) for rep in replicas]
    bf16 = dtype == torch.bfloat16

    def replica_loss(r, images, targets, total_pos):
        dev = rows_of[r].home
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
            return loss_fns[r](to_device(images, dev),
                               to_device(targets, dev), total_pos)[0]

    def step(state, images_u8, targets):
        model, opt = state["model"], state["opt"]
        images_u8 = np.asarray(images_u8)
        slices = shard_batch(mesh, images_u8.shape[0])
        total_pos = int(sum(np.asarray(t["pos"]).sum() for t in targets))
        home = next(model.parameters()).device
        with torch.no_grad():
            for full, per_replica in params + buffers:
                for parts in per_replica:
                    _scatter(full, parts)
        opt.zero_grad(set_to_none=True)
        for rep in replicas:
            rep.zero_grad(set_to_none=True)
        losses = lock.run([functools.partial(
            replica_loss, r, images_u8[sl],
            [{k: np.asarray(v)[sl] for k, v in t.items()} for t in targets],
            total_pos) for r, sl in enumerate(slices)])
        loss = sum(x.to(home) for x in losses)
        loss.backward()
        with torch.no_grad():
            for full, per_replica in params:
                full.grad = sum(torch.cat([
                    p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in parts]).to(home) for parts in per_replica)
        opt.step()
        with torch.no_grad():
            for full, per_replica in buffers:     # every replica's alike
                full.copy_(per_replica[0][0])
        return state, {"loss": loss.detach(),
                       "npos": torch.tensor(total_pos)}

    state = {"model": model, "opt": opt}
    return step, state, model


def _pieces(replicas, model: nn.Module):
    """``(params, buffers)``: each of the master ``model``'s parameters and
    buffers with, for every replica, the tensors that hold it in row order
    (itself, or the column slices of a :class:`ColumnParallel`)."""

    def holders(rep):
        mine = dict(rep.named_parameters())
        mine.update(rep.named_buffers())

        def parts(name):
            if name in mine:
                return [mine[name]]
            owner, leaf = name.rsplit(".", 1)
            found = []
            while f"{owner}.shards.{len(found)}.{leaf}" in mine:
                found.append(mine[f"{owner}.shards.{len(found)}.{leaf}"])
            return found

        return parts

    each = [holders(rep) for rep in replicas]
    return ([(t, [parts(n) for parts in each])
             for n, t in model.named_parameters()],
            [(t, [parts(n) for parts in each])
             for n, t in model.named_buffers()])


def _scatter(full: torch.Tensor, parts) -> None:
    """Copy ``full`` into its row-order slices ``parts`` (along dim 0)."""
    if len(parts) == 1:
        parts[0].copy_(full)
        return
    at = 0
    for p in parts:
        p.copy_(full[at:at + p.shape[0]])
        at += p.shape[0]


class _GlobalBatchNorm(nn.BatchNorm2d):
    """The training forward of ``models/layers.BatchNorm2d`` over the
    global batch: each replica's sums, then its squared deviations from the
    mean, are summed over the data replicas in lockstep (differentiably),
    so every replica normalises with, and keeps, the statistics of the
    whole batch, by flax's rule (the biased variance). A per-replica
    BatchNorm would give another step. Eval mode is BatchNorm's."""

    def __init__(self, bn: nn.BatchNorm2d, across: RowComm, lock: Lockstep,
                 r: int):
        super().__init__(bn.num_features, eps=bn.eps, momentum=bn.momentum,
                         device=bn.weight.device, dtype=bn.weight.dtype)
        self.load_state_dict(bn.state_dict())
        self.train(bn.training)
        self.across, self.lock, self.r = across, lock, r

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1] * len(self.across.devices)
        reduce = self.across.all_reduce
        xf = x.float()
        mean = self.lock.together(self.r, xf.sum((0, 2, 3)), reduce) / n
        dev = xf - mean.view(1, -1, 1, 1)
        var = self.lock.together(self.r, (dev * dev).sum((0, 2, 3)),
                                 reduce) / n
        y = dev * torch.rsqrt(var + self.eps).view(1, -1, 1, 1)
        y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
        return y.to(x.dtype)


def _embed_dim(replicas) -> int:
    """The replicas' embedding width; a process that owns no replica takes
    it from one that does."""
    from .multihost import is_multiprocess, process_count

    dim = replicas[0].embed_dim if replicas else None
    if is_multiprocess():
        import torch.distributed as dist

        dims = [None] * process_count()
        dist.all_gather_object(dims, dim)
        dim = next(d for d in dims if d)
    return int(dim)


@contextlib.contextmanager
def _on(stream):
    """Run on a replica's CUDA stream, ordered after the work already
    queued on its device (the weights' upload, the last batch's reads).
    The CPU has no stream."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        yield


def _concat_rows(outs, streams) -> dict:
    """Per-replica outputs → one dict in row order on the first replica's
    device, ordered after every replica's stream."""
    home = outs[0]["boxes"].device
    if home.type == "cuda":
        current = torch.cuda.current_stream(home)
        for s in streams:
            current.wait_stream(s)
        for o in outs:
            for v in o.values():
                # the tensors were made on the replica's stream and are
                # read (or copied to ``home``) on its device's current one:
                # keep their blocks until that is done
                v.record_stream(torch.cuda.current_stream(v.device))
    return {k: torch.cat([o[k].to(home) for o in outs], dim=0)
            for k in OUTPUT_KEYS}
