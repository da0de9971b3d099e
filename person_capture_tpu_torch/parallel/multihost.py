"""Multi-process execution on ``torch.distributed`` (counterpart of
``person_capture_tpu/parallel/multihost.py``).

The design is the JAX package's:

- every process runs the SAME program and owns the devices it computes
  on: every card it sees, or under torchrun its ``LOCAL_RANK`` share of
  the host's cards (``parallel/mesh.local_cards``);
- one global mesh (parallel/mesh.py) lists every process's devices in rank
  order; the frame batch splits over its ``data`` axis, and each process
  computes ONLY the rows of the replicas it holds a device of
  (:func:`make_global_batch`). Each process decodes the video itself:
  decode at pre-scan widths is cheap, compute is what scales;
- a replica's ``model`` axis may span processes: each of them computes the
  replica with the column slices (or slabs) of its own devices, exchanged
  over a gloo subgroup of the row (``parallel/mesh.RowComm``);
- the small per-batch outputs (boxes and feats per frame) are all-gathered
  to every process (:func:`gather_rows`), each replica's from the rank of
  its first model-axis device, so the host-side sequential replay — spans,
  locks, bank growth — runs identically on every process. Only the primary
  writes user-visible outputs (:func:`is_primary`).

The collectives run on gloo: gloo also works when two ranks share one card,
which NCCL refuses. The per-batch outputs go to the host anyway; a model
row across processes sends each split layer's output through the host too,
which costs what PERF.md §7 records.

Single-process behavior is unchanged: every helper passes its input through,
so the pipeline code calls these unconditionally.
"""

from __future__ import annotations

import atexit
import os
from typing import List, Optional

import numpy as np

_INITIALIZED = False
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group (idempotent).

    With ``coordinator`` ("host:port"), ``num_processes`` and
    ``process_id`` it joins that cluster; rank 0 hosts the rendezvous on
    that port. With none of them it reads torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (the torch counterpart of
    JAX's pod auto-discovery), and raises ``ValueError`` naming the flags
    when they are not set.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    import torch.distributed as dist

    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        address = coordinator
    else:
        missing = [k for k in TORCHRUN_ENV if not os.environ.get(k)]
        if missing:
            raise ValueError(
                "--multihost without --coordinator reads torchrun's "
                f"{', '.join(TORCHRUN_ENV)}; {', '.join(missing)} not set: "
                "launch with torchrun or pass --coordinator host:port "
                "--num-processes N --process-id I")
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    atexit.register(_shutdown)
    _INITIALIZED = True


def _shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns user-visible side effects (crop/CSV
    writes). The host replay is deterministic on every process, so gating
    the writers is sufficient."""
    return process_index() == 0


def is_multiprocess() -> bool:
    return process_count() > 1


def make_global_batch(mesh, arr: np.ndarray, axis: str = "model"):
    """Host batch (full copy on every process) → the rows this process
    computes.

    Single-process: returns ``arr`` unchanged (every replica is local).
    Multi-process: the contiguous rows of each data-axis replica in which
    this process holds a device of the replica's ``axis`` row
    (``mesh.local_replicas``), in replica order, so no process uploads rows
    it does not compute. A replica whose row spans processes hands its rows
    to each of them."""
    if not is_multiprocess():
        return arr
    arr = np.asarray(arr)
    per = arr.shape[0] // mesh.num_replicas()
    return np.concatenate([arr[:0]] + [arr[r * per:(r + 1) * per]
                                       for r in mesh.local_replicas(axis)])


def gather_rows(rows: dict, mesh=None, axis: str = "model") -> dict:
    """All-gather each process's rows ``{name: np.ndarray [n_p, ...]}``
    (``{}`` from a process that computed none) and concatenate them in rank
    order, so every process holds the full result. With ``mesh``, ``rows``
    are those of :func:`make_global_batch` (each local replica's, in
    order), and a process sends only the replicas it leads
    (``mesh.replica_owners``): a replica computed by several processes
    counts once. Single-process: returns ``rows``."""
    if not is_multiprocess():
        return rows
    import torch.distributed as dist

    if mesh is not None and rows:
        local = mesh.local_replicas(axis)
        per = len(next(iter(rows.values()))) // len(local)
        leaders = mesh.replica_owners(axis)
        keep = np.concatenate([np.arange(0)] + [
            np.arange(i * per, (i + 1) * per) for i, r in enumerate(local)
            if leaders[r] == process_index()])
        rows = {k: v[keep] for k, v in rows.items()} if keep.size else {}
    parts: List[Optional[dict]] = [None] * process_count()
    dist.all_gather_object(parts, rows)
    parts = [p for p in parts if p]     # a process may lead no replica
    return {k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]}
