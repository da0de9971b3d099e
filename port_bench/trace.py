"""A ``torch.profiler`` window and what the benchmark reads from it.

The window is one whole video of the measured window, traced with CPU and
CUDA activity and exported as a Chrome trace. From the device events
(kernels, copies, sets) it takes the busy time (their union), the time
per kernel name and the idle gaps between them, each gap named by the
benchmark's innermost ``record_function`` range open on the host at its
middle; from the launches it attributes kernels to a range
(``kernel_seconds_in``).
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    device: List[Tuple[str, float, float, int]] = field(default_factory=list)
    ranges: List[Tuple[str, float, float, int]] = field(default_factory=list)
    launches: Dict[int, Tuple[float, int]] = field(default_factory=dict)

    def has_range(self, name: str) -> bool:
        return any(n == name for n, _, _, _ in self.ranges)

    def kernel_seconds_in(self, name: str) -> float:
        """Device seconds of the kernels launched inside ranges ``name``."""
        spans = defaultdict(list)
        for n, t0, t1, tid in self.ranges:
            if n == name:
                spans[tid].append((t0, t1))
        total = 0.0
        for kname, t0, t1, corr in self.device:
            launch = self.launches.get(corr)
            if launch is None:
                continue
            ts, tid = launch
            if any(a <= ts <= b for a, b in spans.get(tid, ())):
                total += t1 - t0
        return total * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for kname, t0, t1, _ in self.device:
            by[kname] += (t1 - t0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        ivs = sorted((t0, t1) for _, t0, t1, _ in self.device)
        gaps, end = [], None
        for t0, t1 in ivs:
            if end is not None and t0 > end:
                gaps.append((end, t0))
            end = t1 if end is None else max(end, t1)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:n]:
            mid = 0.5 * (g0 + g1)
            open_ = [(t1 - t0, name) for name, t0, t1, _ in self.ranges
                     if t0 <= mid <= t1]
            name = min(open_)[1] if open_ else "outside the benchmark's ranges"
            out.append([name, (g1 - g0) * 1e-6])
        return out


def _union(ivs) -> float:
    total, end = 0.0, None
    start = None
    for t0, t1 in sorted(ivs):
        if end is None or t0 > end:
            if end is not None:
                total += end - start
            start, end = t0, t1
        else:
            end = max(end, t1)
    if end is not None:
        total += end - start
    return total


@contextlib.contextmanager
def profiled(path: str, out: Dict):
    """Trace the block; on exit ``out["trace"]`` holds its :class:`Trace`
    (``window_s`` is left to the caller's clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    out["trace"] = read(path)
    os.remove(path)


def read(path: str) -> Trace:
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur",
                                                                     0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            tr.device.append((e.get("name", "?"), ts, ts + dur,
                              int(args.get("correlation", -1))))
        elif cat == "user_annotation":
            tr.ranges.append((e.get("name", "?"), ts, ts + dur,
                              e.get("tid", 0)))
        elif cat in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            tr.launches[int(args["correlation"])] = (ts, e.get("tid", 0))
    tr.busy_s = _union([(t0, t1) for _, t0, t1, _ in tr.device]) * 1e-6
    return tr
