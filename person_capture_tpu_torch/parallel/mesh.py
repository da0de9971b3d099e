"""Device mesh and the sharded pre-scan step (counterpart of
``person_capture_tpu/parallel/mesh.py``).

The frame batch is data-parallel over the mesh's ``data`` axis: each
data-axis replica is a :class:`~..pipeline.backends.ScrfdArcFaceBackend`
on its own device, built from the same weights, and runs its contiguous
rows of the batch on its own CUDA stream. Wide layers (every conv and dense
whose output channels divide the ``model`` axis) split their output
channels over the replica's ``model``-axis devices (:class:`ColumnParallel`):
the input is broadcast, each device computes its slice of the channels, and
the slices are concatenated back on the replica's first device. That is the
placement rule of the JAX package's ``shard_params_for_tp``
(``kernel.shape[-1] % tp``), and it computes the same outputs. XLA inserts
those collectives for the JAX package; here they are explicit copies.

Across processes (parallel/multihost.py) the mesh lists every process's
devices in rank order; a replica's ``model`` axis must lie within one
process. Under torchrun each process takes its ``LOCAL_RANK`` share of the
host's cards; two processes that would compute on one card are refused
unless ``PERSON_CAPTURE_SHARE_CARDS=1`` asks for it (a test on one card).
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

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

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _along(self, arr: np.ndarray):
        """``arr`` as ``[replicas, model]``: the data axis first, the model
        axis second, index 0 along every other axis (they replicate)."""
        names = self.axis_names
        lead = [names.index(a) for a in (DATA, MODEL) if a in names]
        rest = [i for i in range(len(names)) if i not in lead]
        arr = np.transpose(arr, lead + rest)[
            (slice(None),) * len(lead) + (0,) * len(rest)]
        if DATA not in names:
            arr = arr[None]
        if MODEL not in names:
            arr = arr[..., None]
        return arr

    def replica_devices(self) -> np.ndarray:
        """``[replicas, model]`` array of devices: one row per data-axis
        replica, its model-axis devices in order."""
        return self._along(self.devices)

    def replica_owners(self) -> np.ndarray:
        """Owning rank of each replica; ``ValueError`` when a replica's
        model axis spans processes."""
        owners = self._along(self.owners)
        if (owners != owners[:, :1]).any():
            raise ValueError(
                f"mesh {self.shape}: a '{MODEL}' axis that spans "
                "processes is not supported; give the model axis no more "
                "devices than one process sees (--mesh data:N,model:K with "
                "K at most the devices of one process)")
        return owners[:, 0]

    def num_replicas(self) -> int:
        return int(self.shape.get(DATA, 1))

    def local_replicas(self) -> list:
        """Indices of the replicas this process computes (contiguous)."""
        from .multihost import process_index

        owners = self.replica_owners()
        return [int(r) for r in np.flatnonzero(owners == process_index())]


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
    ``devices``: each device holds one contiguous slice of the channels
    (and, for a grouped conv, the matching groups); the input goes to every
    device, and the outputs are concatenated in order on the input's
    device. Same outputs as the layer it wraps."""

    def __init__(self, layer: nn.Module, devices):
        super().__init__()
        tp = len(devices)
        self.devices = list(devices)
        self.conv = isinstance(layer, nn.Conv2d)
        self.split_input = self.conv and layer.groups > 1
        self.shards = nn.ModuleList(
            _column_slice(layer, j, tp).to(dev)
            for j, dev in enumerate(self.devices))

    def forward(self, x):
        home = x.device
        xs = (x.chunk(len(self.shards), dim=1) if self.split_input
              else [x] * len(self.shards))
        outs = [shard(xi.to(dev, non_blocking=True)).to(home,
                                                        non_blocking=True)
                for shard, xi, dev in zip(self.shards, xs, self.devices)]
        return torch.cat(outs, dim=1 if self.conv else -1)


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
    in :class:`ColumnParallel` over the replica's model-axis devices;
    everything else stays on the replica's first device. A model axis that
    spans processes raises ``ValueError``. Returns ``module``."""
    mesh.replica_owners()
    devs = list(mesh.replica_devices()[replica])
    module.to(devs[0])
    if len(devs) == 1:
        return module
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if _splits(child, len(devs)):
                setattr(parent, name, ColumnParallel(child, devs))
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
    needs; ``run.scrfd_vars`` and ``run.arcface_vars`` are the weights as
    given (``None``: the seeded init, the same on every replica).
    """
    from ..core.bank import fd_min_batch
    from ..pipeline.backends import ScrfdArcFaceBackend, unpack_faces
    from .multihost import gather_rows, is_multiprocess, make_global_batch

    def make_replica(r):
        be = ScrfdArcFaceBackend(
            scrfd_cfg, arcface_cfg, det_size=det_size, max_faces=max_faces,
            dtype=dtype, seed=seed, scrfd_weights=scrfd_vars,
            arcface_weights=arcface_vars, transfer_format="bgr",
            use_arcface=use_arcface, clip_face_cfg=clip_face_cfg,
            embed_slots=embed_slots, device=mesh.replica_devices()[r, 0])
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
                for k, v in gather_rows(local_rows).items()}

    run.scrfd_vars = scrfd_vars
    run.arcface_vars = arcface_vars
    run.mesh = mesh
    run.replicas = replicas
    run.embed_dim = _embed_dim(replicas)
    return run


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
