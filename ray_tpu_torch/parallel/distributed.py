"""Process-group bootstrap (port of ``ray_tpu/parallel/distributed.py``),
and the launcher that runs one function on spawned ranks.

``initialize_process_group`` joins ``torch.distributed``'s default group:
NCCL on the card, gloo on the CPU, unless ``backend`` says otherwise.  With
no address given, rank 0 publishes one (``host:port`` of a free port) in
the cluster KV and the other ranks read it there, as the JAX package does
for its coordinator; an explicit address is ``host:port`` (TCP) or a URL
such as ``file:///path/store`` (a ``FileStore``).

``spawn_ranks`` starts ``world_size`` processes (the spawn start method:
each imports afresh, so nothing of the parent's state leaks in), joins them
in one group through a ``FileStore`` and returns what each rank's
function returned.  A rank that raises, or ranks that outlast the time
limit, fail the call, and every rank still running is killed.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _published_address(rank: int, group_name: str,
                       timeout_s: float) -> str:
    """Rank 0 picks ``host:port`` and publishes it under
    ``pg:<group_name>:coordinator`` in the cluster KV; the other ranks poll
    for it."""
    from ..core.context import ctx

    if ctx.client is None:
        raise RuntimeError(
            "initialize_process_group needs a cluster connection "
            "(or pass coordinator_address explicitly)"
        )
    key = f"pg:{group_name}:coordinator"
    if rank == 0:
        host = socket.gethostbyname(socket.gethostname())
        address = f"{host}:{_free_port()}"
        ctx.client.kv_put(key, address.encode())
        return address
    deadline = time.monotonic() + timeout_s
    while True:
        raw = ctx.client.kv_get(key)
        if raw is not None:
            return raw.decode()
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"rank {rank}: coordinator address not published")
        time.sleep(0.1)


def initialize_process_group(world_size: int, rank: int, *,
                             group_name: str = "default",
                             coordinator_address: Optional[str] = None,
                             backend: Optional[str] = None,
                             timeout_s: float = 120.0) -> None:
    """Join ``rank`` of ``world_size`` to the default process group.  A
    world of one is a no-op, so the same train loop runs everywhere.
    Without ``coordinator_address`` the ranks meet through the cluster KV,
    keyed by ``group_name`` (call from inside a task or actor)."""
    if world_size <= 1:
        return
    if coordinator_address is None:
        coordinator_address = _published_address(rank, group_name,
                                                 timeout_s)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_group_barrier(group_name: str = "default") -> None:
    """Host-level barrier across the initialized process group."""
    dist.barrier()


def _rank_main(rank: int, world_size: int, store: str, backend: str,
               cuda_device: Optional[int], fn: Callable, args: tuple,
               results) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        if cuda_device is not None:
            torch.cuda.set_device(cuda_device)
        initialize_process_group(world_size, rank,
                                 coordinator_address=f"file://{store}",
                                 backend=backend)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], world_size: int, *args: Any,
                store: str, backend: str = "gloo",
                cuda_device: Optional[int] = None,
                timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned ranks joined in one
    ``backend`` group through the ``FileStore`` at ``store`` (a path that
    does not exist yet); return the results in rank order.  ``fn`` and its
    arguments are pickled: ``fn`` must be importable by the children.
    ``cuda_device``: every rank's current CUDA device."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, store, backend, cuda_device,
                               fn, args, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(out))} of "
                    f"{world_size} did not finish within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(out) == world_size else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    return [out[r] for r in range(world_size)]


__all__ = ["initialize_process_group", "process_group_barrier",
           "spawn_ranks"]
