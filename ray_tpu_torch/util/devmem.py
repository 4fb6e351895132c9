"""Device-memory accounting: where the card's memory went, by named pool
(port of ``ray_tpu/util/devmem.py``).

The raw totals come from torch's CUDA caching allocator
(``torch.cuda.memory_allocated`` for the live bytes, ``memory_stats`` and
the device's ``total_memory`` for the allocator row), and the *attribution*
comes from a process-local registry of named byte-counting callables that
the owners of big device allocations register themselves::

    devmem.register_pool("kv_pool", lambda: k.nbytes + v.nbytes)

``snapshot()`` joins both: the allocator row, the live bytes, per-pool
bytes and the remainder as ``other``, so the pools always sum to the live
total; plus compile observability (each program's trace count from
``devtools.jitguard`` and the wall clock of the steps that met a new
signature, recorded by the engine via :func:`record_compile`).

The device a snapshot reads follows the port's entry points: the card
unless the caller passes ``device="cpu"``, and no silent fallback (asking
for the card with no CUDA raises).  **On the CPU** torch keeps no allocator
count, so the live bytes there are defined as the bytes the registered
pools attribute: ``other`` is 0 and ``devices`` is empty (as the JAX
package's CPU backend reports no allocator stats).  That rule runs only for
a CPU snapshot; a snapshot of the card always reads the allocator.

``maybe_snapshot()`` reads the card only when this process has already
initialised CUDA, and never initialises it (the JAX version never forces a
jax import).  The port has no runtime yet, so nothing ships snapshots to a
head; ``maybe_snapshot`` is what a reporter would call.  This module
imports nothing of JAX and nothing of ``ray_tpu``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device

_lock = threading.Lock()
_pools: Dict[str, Callable[[], int]] = {}
_compiles: Dict[str, Dict[str, float]] = {}  # program -> {count, wall_s}
_m_pool_bytes = None


def register_pool(name: str, nbytes_fn: Callable[[], int]) -> None:
    """Attribute device bytes to ``name``.  ``nbytes_fn`` is called at
    snapshot time and must be cheap and host-only (no device sync); a
    raising fn reports 0 for that pool rather than failing the snapshot.
    Re-registering replaces (an engine rebuild supersedes its pools)."""
    with _lock:
        _pools[name] = nbytes_fn


def unregister_pool(name: str) -> None:
    with _lock:
        _pools.pop(name, None)


def record_compile(program: str, wall_s: float) -> None:
    """Note one new program signature: ``wall_s`` is the wall clock of the
    step that met it (the engine compares trace counts before and after
    each step, so the measured wall IS the user-visible stall)."""
    with _lock:
        row = _compiles.setdefault(program, {"count": 0, "wall_s": 0.0})
        row["count"] += 1
        row["wall_s"] += float(wall_s)


def compile_stats() -> Dict[str, Dict[str, float]]:
    with _lock:
        return {k: dict(v) for k, v in _compiles.items()}


def _device_stats(dev: torch.device) -> list:
    """The card's allocator row: bytes in use, their peak, and the card's
    total memory as the limit."""
    stats = torch.cuda.memory_stats(dev)
    return [{
        "device": dev.index,
        "platform": "gpu",
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev)
                           .total_memory),
    }]


def _pool_bytes() -> Dict[str, int]:
    with _lock:
        fns = dict(_pools)
    pools: Dict[str, int] = {}
    for name, fn in fns.items():
        try:
            pools[name] = max(0, int(fn()))
        except Exception:
            pools[name] = 0
    return pools


def snapshot(device: DeviceLike = None) -> Dict[str, Any]:
    """One attribution snapshot of ``device`` (the card unless ``"cpu"``).
    Invariant the tests hold on both devices: the ``pools`` values
    (including ``other``) sum to ``live_bytes`` exactly."""
    dev = resolve_device(device)
    pools = _pool_bytes()
    named = sum(pools.values())
    if dev.type == "cpu":
        live, devices = named, []
    else:
        live, devices = int(torch.cuda.memory_allocated(dev)), \
            _device_stats(dev)
    # Attribution is bounded by what is actually live: a stale pool fn
    # (engine torn down mid-snapshot) must not drive "other" negative.
    if named > live:
        scale = live / named if named else 0.0
        pools = {k: int(v * scale) for k, v in pools.items()}
        named = sum(pools.values())
    pools["other"] = live - named
    snap = {
        "time": time.time(),
        "live_bytes": live,
        "pools": pools,
        "devices": devices,
        "compiles": compile_stats(),
    }
    from ..devtools import jitguard

    snap["trace_counts"] = jitguard.counts()
    _set_gauges(pools)
    return snap


def maybe_snapshot() -> Optional[Dict[str, Any]]:
    """A snapshot of the current card IF this process has already
    initialised CUDA (never initialise it: that would create a context in
    every process that only imported the port)."""
    if not torch.cuda.is_initialized():
        return None
    try:
        return snapshot()
    except Exception:
        return None


def _set_gauges(pools: Dict[str, int]) -> None:
    global _m_pool_bytes
    try:
        from .metrics import get_gauge

        if _m_pool_bytes is None:
            _m_pool_bytes = get_gauge(
                "ray_tpu_devmem_pool_bytes",
                "Live device bytes attributed to each named pool",
                tag_keys=("pool",))
        for name, nbytes in pools.items():
            _m_pool_bytes.set(nbytes, tags={"pool": name})
    except Exception:
        pass  # metrics must never fail the snapshot
