"""Host-plane collective groups over the cluster KV (port of
``ray_tpu/collective/collective.py``).

API-compatible role with the reference's collective library
(reference: util/collective/collective.py:120 init_collective_group,
:258 allreduce, :298 barrier, :373 broadcast, :423 allgather,
:472 reducescatter, :531/:594 send/recv).  The backend is the control
plane's KV store (the same role Ray's internal KV plays for the pygloo
rendezvous — gloo_collective_group.py:66); payloads are host numpy arrays.
A tensor, on the card or the CPU, is copied to the host first
(``.detach().cpu().numpy()``, the counterpart of ``np.asarray`` on a
device array; bf16, which numpy lacks, widens to fp32), and results are
numpy as in the JAX package.

Intended for *control-plane sized* data: rendezvous, metric reduction, small
weight broadcast.  Bulk tensor traffic belongs on the device plane
(``collective.mesh_ops`` over ``torch.distributed``).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

_groups: Dict[str, "GroupState"] = {}
_POLL_S = 0.002

# -- per-op accounting (gang observability plane) --------------------------
# Process-wide collective time/bytes accumulator: the train session reads
# op_totals() before and after each round to attribute collective wait in
# its round records (util/gangrec.py), without the collective layer knowing
# anything about gangs.  Every op also observes the
# ray_tpu_collective_op_seconds / ray_tpu_collective_bytes_total metrics
# (tagged by op) and emits a propagation-only trace span, so a traced RLHF
# step shows collective time on the critical path.
_op_lock = threading.Lock()
_op_totals = {"ops": 0, "wall_s": 0.0, "bytes": 0}
_op_by_name: Dict[str, Dict[str, Any]] = {}
_m_op_hist = None
_m_op_bytes = None


def op_totals() -> Dict[str, Any]:
    """Process-wide snapshot of collective accounting: total op count,
    wall seconds, and payload bytes since import.  Monotonic — callers
    diff two snapshots to attribute a window."""
    with _op_lock:
        return dict(_op_totals)


def op_stats() -> Dict[str, Dict[str, Any]]:
    """Per-op breakdown: ``{op: {calls, wall_s, bytes, last_seq}}``."""
    with _op_lock:
        return {k: dict(v) for k, v in _op_by_name.items()}


def _host(value) -> np.ndarray:
    """``value`` as a host numpy array: a tensor is detached and copied off
    its device (bf16 widened to fp32); anything else goes through
    ``np.asarray``.  torch is touched only when handed a tensor."""
    if type(value).__module__.split(".")[0] == "torch":
        import torch

        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(value)


def _nbytes(value) -> int:
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    try:
        return int(np.asarray(value).nbytes)
    except Exception:
        return 0


def _observe_op(op: str, wall: float, nbytes: int, seq: int) -> None:
    global _m_op_hist, _m_op_bytes
    try:
        from ..util.metrics import get_counter, get_histogram

        if _m_op_hist is None:
            _m_op_hist = get_histogram(
                "ray_tpu_collective_op_seconds",
                "Wall time of one host-plane collective op, by op",
                tag_keys=("op",))
            _m_op_bytes = get_counter(
                "ray_tpu_collective_bytes_total",
                "Payload bytes moved through host-plane collectives, by op",
                tag_keys=("op",))
        _m_op_hist.observe(wall, {"op": op})
        if nbytes:
            _m_op_bytes.inc(nbytes, {"op": op})
    except Exception:
        pass  # metrics must never fail a collective
    with _op_lock:
        _op_totals["ops"] += 1
        _op_totals["wall_s"] += wall
        _op_totals["bytes"] += nbytes
        s = _op_by_name.setdefault(
            op, {"calls": 0, "wall_s": 0.0, "bytes": 0, "last_seq": 0})
        s["calls"] += 1
        s["wall_s"] += wall
        s["bytes"] += nbytes
        s["last_seq"] = max(s["last_seq"], seq)


@contextlib.contextmanager
def _op(g: "GroupState", op: str, tag: str, nbytes: int):
    """Time one collective op: per-op metrics + process accumulator +
    (when the caller is traced) a propagation-only child span — untraced
    callers pay only the clock reads."""
    from ..util import tracing

    t0 = time.perf_counter()
    with tracing.trace_if_active(
            f"collective:{op}", group=g.name, rank=g.rank,
            world=g.world_size, bytes=nbytes):
        yield
    _observe_op(op, time.perf_counter() - t0, nbytes, g.seqs.get(tag, 0))


class GroupState:
    def __init__(self, world_size: int, rank: int, name: str, gen: int):
        self.world_size = world_size
        self.rank = rank
        self.name = name
        # Incarnation generation: re-creating a group with the same name
        # (elastic restart) gets a fresh generation, so no op can ever read
        # a previous incarnation's KV keys.
        self.gen = gen
        # Per-tag op counters: collectives stay aligned because every rank
        # calls the same collectives in the same order; p2p counters are
        # per (src, dst, tag) so asymmetric send/recv patterns can't
        # desynchronize the rendezvous keys.
        self.seqs: Dict[str, int] = {}

    @property
    def ns(self) -> str:
        return f"col:{self.name}:g{self.gen}"

    def next_seq(self, tag: str) -> int:
        self.seqs[tag] = self.seqs.get(tag, 0) + 1
        return self.seqs[tag]


def _client():
    from ..core.context import ctx

    if ctx.client is None:
        raise RuntimeError("collective ops need an initialized cluster "
                           "(call ray_tpu_torch.init() / run inside a worker)")
    return ctx.client


def _group(name: str) -> GroupState:
    g = _groups.get(name)
    if g is None:
        raise ValueError(f"collective group {name!r} not initialized here")
    return g


def _del_prefix(prefix: str) -> None:
    c = _client()
    for k in c.kv_keys(prefix):
        c.kv_del(k)


def _rendezvous_generation(world_size: int, rank: int, name: str,
                           timeout: float) -> int:
    """Agree on a fresh incarnation generation for (re-)initialized groups.

    Elastic restarts re-create groups under the same name after the previous
    gang died; without a fresh namespace, barrier/allreduce would consume the
    dead incarnation's KV keys.  Protocol (incarnations are sequential —
    the old gang is gone before the new one initializes):

    - rank 0 deletes stale hello keys, bumps the integer generation, purges
      any keys under the new namespace, then welcomes each joiner by its
      process-unique uuid with the new generation.
    - other ranks repeatedly post a uuid-keyed hello and poll for their own
      welcome; the uuid guarantees the welcome they read is from *this*
      incarnation's rank 0.
    """
    c = _client()
    hello_prefix = f"col:{name}:hello:"
    deadline = time.monotonic() + timeout
    if rank == 0:
        _del_prefix(hello_prefix)
        _del_prefix(f"col:{name}:welcome:")  # unconsumed stale welcomes
        raw = c.kv_get(f"col:{name}:gen")
        gen = (int(raw) if raw else 0) + 1
        _del_prefix(f"col:{name}:g{gen}:")
        c.kv_put(f"col:{name}:gen", str(gen).encode())
        seen: Dict[int, None] = {}
        welcomed: set = set()
        while len(seen) < world_size - 1:
            for k in c.kv_keys(hello_prefix):
                _, _, _, r_str, uuid = k.split(":", 4)
                # Welcome each uuid exactly once: the joiner deletes the key
                # on read, and re-putting it would leak it forever.
                if uuid not in welcomed:
                    welcomed.add(uuid)
                    c.kv_put(f"col:{name}:welcome:{uuid}",
                             str(gen).encode())
                seen[int(r_str)] = None
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective init: only {len(seen) + 1}/{world_size} "
                    f"ranks arrived for group {name!r}"
                )
            time.sleep(_POLL_S)
        return gen
    uuid = os.urandom(8).hex()
    welcome_key = f"col:{name}:welcome:{uuid}"
    while True:
        # Repost each round: rank 0 deletes hello keys posted before its
        # purge; reposting guarantees eventual delivery.
        c.kv_put(hello_prefix + f"{rank}:{uuid}", b"1")
        raw = c.kv_get(welcome_key)
        if raw is not None:
            c.kv_del(welcome_key)
            return int(raw)
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"collective init: rank {rank} saw no rank 0 for {name!r}"
            )
        time.sleep(_POLL_S * 10)


def init_collective_group(
    world_size: int, rank: int, *, group_name: str = "default",
    backend: str = "kv", timeout: float = 120.0,
) -> None:
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    if ":" in group_name:
        # ':' is the KV namespace separator — a name containing it would
        # misparse in the hello-key split during rendezvous.
        raise ValueError(f"collective group name must not contain ':': {group_name!r}")
    if world_size == 1:
        _groups[group_name] = GroupState(1, 0, group_name, 0)
        return
    gen = _rendezvous_generation(world_size, rank, group_name, timeout)
    _groups[group_name] = GroupState(world_size, rank, group_name, gen)
    barrier(group_name)  # rendezvous: everyone must arrive


def create_collective_group(
    actors: List[Any], world_size: int, ranks: List[int],
    *, group_name: str = "default",
) -> None:
    """Declarative variant: install the group on a list of actor handles
    (each actor must expose `_init_collective(world, rank, name)` or be a
    framework-managed worker)."""
    import ray_tpu_torch

    refs = [
        a._init_collective.remote(world_size, r, group_name)
        for a, r in zip(actors, ranks)
    ]
    ray_tpu_torch.get(refs)


def destroy_collective_group(group_name: str = "default") -> None:
    g = _groups.get(group_name)
    if g is None:
        return
    # All ranks barrier so rank 0's sweep can't race in-flight ops; if some
    # peer never calls destroy the barrier times out and the sweep proceeds
    # (the next incarnation uses a fresh namespace regardless).
    if g.world_size > 1:
        try:
            barrier(group_name, timeout=5.0)
        except Exception:
            pass
    _groups.pop(group_name, None)
    c = _client()
    if g.rank != 0:
        # Ack that this rank is done reading the namespace; rank 0 must not
        # sweep barrier keys a peer hasn't consumed yet (that would stall
        # every peer's destroy for the full barrier timeout).
        try:
            c.kv_put(f"{g.ns}:dack:{g.rank}", b"1")
        except Exception:
            pass
        return
    try:
        if g.world_size > 1:
            deadline = time.monotonic() + 5.0
            want = {f"{g.ns}:dack:{r}" for r in range(1, g.world_size)}
            while time.monotonic() < deadline:
                if want <= set(c.kv_keys(f"{g.ns}:dack:")):
                    break
                time.sleep(_POLL_S)
        _del_prefix(g.ns + ":")
        _del_prefix(f"col:{g.name}:hello:")
    except Exception:
        pass


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_world_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


# ---------------------------------------------------------------- internals


def _post(key: str, value) -> None:
    _client().kv_put(key, pickle.dumps(value, protocol=5))


def _wait_key(key: str, timeout: float) -> Any:
    c = _client()
    deadline = time.monotonic() + timeout
    while True:
        raw = c.kv_get(key)
        if raw is not None:
            return pickle.loads(raw)
        if time.monotonic() > deadline:
            raise TimeoutError(f"collective op timed out waiting for {key}")
        time.sleep(_POLL_S)


def _tree_children(rank: int, world: int) -> List[int]:
    return [c for c in (2 * rank + 1, 2 * rank + 2) if c < world]


def _tree_parent(rank: int) -> int:
    return (rank - 1) // 2


def _tree_exchange(g: GroupState, tag: str, value, combine, timeout: float):
    """Binary-tree reduce to rank 0, then a tree broadcast of the result.

    Each rank performs O(1) KV puts (its reduce contribution up + its relay
    down) and waits on O(1) keys (<=2 children + 1 parent), so a whole
    collective costs O(world) KV operations at O(log world) depth — vs the
    flat _gather_all pattern where every rank reads every other rank's key
    (O(world^2) reads).  `combine` must be associative; combine order is
    deterministic per tree shape, so every rank computes bit-identical
    results for fp payloads.
    """
    seq = g.next_seq(tag)
    base = f"{g.ns}:{tag}:{seq}"
    acc = value
    for c in _tree_children(g.rank, g.world_size):
        acc = combine(acc, _wait_key(f"{base}:up:{c}", timeout))
    if g.rank == 0:
        result = acc
        if g.world_size > 1:
            _post(f"{base}:dn:0", result)
    else:
        _post(f"{base}:up:{g.rank}", acc)
        result = _wait_key(f"{base}:dn:{_tree_parent(g.rank)}", timeout)
        if _tree_children(g.rank, g.world_size):
            _post(f"{base}:dn:{g.rank}", result)
    # Lazy cleanup of the keys THIS rank posted two ops ago (op N+1's
    # up/down waves guarantee every consumer has read them).
    if seq > 2:
        c = _client()
        old = f"{g.ns}:{tag}:{seq - 2}"
        if g.rank != 0:
            c.kv_del(f"{old}:up:{g.rank}")
        if g.rank == 0 or _tree_children(g.rank, g.world_size):
            c.kv_del(f"{old}:dn:{g.rank}")
    return result


# --------------------------------------------------------------------- ops


_COMBINE = {"sum": np.add, "mean": np.add,
            "max": np.maximum, "min": np.minimum}


def allreduce(tensor: np.ndarray, *, group_name: str = "default",
              op: str = "sum", timeout: float = 60.0) -> np.ndarray:
    combine = _COMBINE.get(op)
    if combine is None:
        raise ValueError(f"unsupported op {op!r}")
    g = _group(group_name)
    arr = _host(tensor)
    with _op(g, "allreduce", "ar", _nbytes(arr)):
        out = np.asarray(_tree_exchange(g, "ar", arr, combine, timeout))
    if op == "mean":
        out = out / g.world_size
    return out


def allgather(tensor: np.ndarray, *, group_name: str = "default",
              timeout: float = 60.0) -> List[np.ndarray]:
    g = _group(group_name)
    arr = _host(tensor)
    with _op(g, "allgather", "ag", _nbytes(arr)):
        merged = _tree_exchange(
            g, "ag", {g.rank: arr}, lambda a, b: {**a, **b}, timeout,
        )
    return [np.asarray(merged[r]) for r in range(g.world_size)]


def reducescatter(tensor: np.ndarray, *, group_name: str = "default",
                  op: str = "sum", timeout: float = 60.0) -> np.ndarray:
    from ..util import tracing

    g = _group(group_name)
    # Span-only wrapper: the wire cost IS the inner allreduce, which does
    # the metric/accumulator accounting — wrapping it in _op() too would
    # double-count the wall into the session's collective attribution.
    with tracing.trace_if_active("collective:reducescatter",
                                 group=g.name, rank=g.rank):
        reduced = allreduce(_host(tensor), group_name=group_name, op=op,
                            timeout=timeout)
    chunks = np.array_split(reduced, g.world_size, axis=0)
    return chunks[g.rank]


def broadcast(tensor: Optional[np.ndarray], *, group_name: str = "default",
              root: int = 0, timeout: float = 60.0) -> np.ndarray:
    g = _group(group_name)
    seq = g.next_seq(f"bc{root}")
    key = f"{g.ns}:bc{root}:{seq}"
    if g.rank == root:
        arr = _host(tensor)
        with _op(g, "broadcast", f"bc{root}", _nbytes(arr)):
            _post(key, arr)
        if seq > 2:  # lazy cleanup of an op every rank has long consumed
            _client().kv_del(f"{g.ns}:bc{root}:{seq - 2}")
        return arr
    with _op(g, "broadcast", f"bc{root}", 0):
        out = np.asarray(_wait_key(key, timeout))
    return out


def barrier(group_name: str = "default", timeout: float = 60.0) -> None:
    g = _group(group_name)
    with _op(g, "barrier", "bar", 0):
        _tree_exchange(g, "bar", None, lambda a, b: None, timeout)


def send(tensor: np.ndarray, dst_rank: int, *, group_name: str = "default",
         tag: int = 0) -> None:
    g = _group(group_name)
    chan = f"p2p:{g.rank}->{dst_rank}:{tag}"
    seq = g.next_seq(chan)
    arr = _host(tensor)
    with _op(g, "send", chan, _nbytes(arr)):
        _post(f"{g.ns}:{chan}:{seq}", arr)


def recv(src_rank: int, *, group_name: str = "default", tag: int = 0,
         timeout: float = 60.0) -> np.ndarray:
    g = _group(group_name)
    chan = f"p2p:{src_rank}->{g.rank}:{tag}"
    seq = g.next_seq(chan)
    key = f"{g.ns}:{chan}:{seq}"
    with _op(g, "recv", chan, 0):
        value = np.asarray(_wait_key(key, timeout))
    _client().kv_del(key)  # sole reader: safe to clean eagerly
    return value
