"""The traced run's device timeline: ``torch.profiler`` over the measured
window (device activity only), reduced to what the per-layer readers and
the result line need.

Every device operation (kernel, copy, set) becomes ``(name, start, end)``
in wall-clock seconds: kineto stamps its events on the same wall clock as
``time.time()``, which the program's spans use.  Busy time merges
overlapping operations; an idle gap is a stretch with none running, named
by the operation that ends it.
"""

from __future__ import annotations

import collections
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

Op = Tuple[str, float, float]


class DeviceTrace:
    """A device-only profiler; ``ops`` and the window ``t0``..``t1``
    after ``stop``.  Serving starts it before its traffic (a tracer
    started while another thread launches kernels has been seen to miss
    them) and keeps the window's part."""

    def __init__(self, device):
        self.device = device
        self.ops: List[Op] = []
        self.t0 = self.t1 = 0.0
        self.stop_s = 0.0
        self._prof = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.device.type != "cuda":
            acts = [torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.t0 = time.time()

    def stop(self, window: Optional[Tuple[float, float]] = None) -> None:
        """Stop; keep the operations that overlap ``window`` (wall-clock
        seconds; by default from the start to now)."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.time()
        t = time.perf_counter()
        self._prof.stop()
        if window is not None:
            self.t0, self.t1 = window
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.duration_ns() <= 0:
                continue
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            if end > self.t0 and start < self.t1:
                self.ops.append((e.name(), start, end))
        self.ops.sort(key=lambda op: op[1])
        self._prof = None
        self.stop_s = time.perf_counter() - t

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def merged(ops: Sequence[Op], t0: float, t1: float
           ) -> List[Tuple[float, float, str]]:
    """Busy intervals inside [t0, t1], overlaps merged, each with the name
    of the operation that opened it."""
    out: List[List] = []
    for name, s, e in sorted(ops, key=lambda op: op[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, name])
    return [tuple(iv) for iv in out]


def busy_s(ops: Sequence[Op], t0: float, t1: float) -> float:
    return sum(e - s for s, e, _ in merged(ops, t0, t1))


@functools.lru_cache(maxsize=4096)
def short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and its argument list
    (cached: a traced window holds a few hundred names over a million
    operations, and a templated name's argument list runs to hundreds of
    characters)."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name[:width]


def top_ops(ops: Sequence[Op], n: int = 10) -> List[List]:
    """The ``n`` operation names with the most device time, in seconds."""
    tot: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in ops:
        tot[short(name)] += e - s
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]


def idle_gaps(ops: Sequence[Op], t0: float, t1: float, n: int = 10
              ) -> List[List]:
    """Idle seconds summed by the operation that ends each gap ("before
    <op>"; "window end" for the last), the ``n`` largest."""
    tot: Dict[str, float] = collections.defaultdict(float)
    prev = t0
    for s, e, name in merged(ops, t0, t1):
        if s > prev:
            tot["before " + short(name, 80)] += s - prev
        prev = e
    if t1 > prev:
        tot["window end"] += t1 - prev
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]


def named(ops: Sequence[Op], part: str) -> List[Op]:
    """The operations whose name contains ``part``."""
    return [op for op in ops if part in op[0]]


def breakdown(trace: Optional[DeviceTrace]) -> Dict[str, List]:
    if trace is None:
        return {"device_ops": [], "idle_gaps": []}
    return {"device_ops": top_ops(trace.ops),
            "idle_gaps": idle_gaps(trace.ops, trace.t0, trace.t1)}
