"""Compiled DAGs: static actor graphs over shm channels.

Role-equivalent to the reference's accelerated DAGs
(reference: python/ray/dag/dag_node.py:162 experimental_compile ->
compiled_dag_node.py:498 CompiledDAG with per-actor execution loops
do_exec_tasks:95 and shared-memory channels; execution schedules from
dag/dag_node_operation.py): after compile, an execution moves data
actor-to-actor through preallocated shm channels with zero control-plane
round trips.  The port's own copy of ``ray_tpu/dag/compiled.py``: channel
payloads go through the port's ``core/serialization``, so a CUDA tensor
crosses an edge as a CPU tensor (the runtime's stated deviation) and the
next stage moves it to its own card.  A payload larger than the default
8-MiB ``channel_capacity`` (a [1, 2048, 4096] bf16 activation is 16 MiB)
needs a larger one at compile time.

Graph surface (single-node; all channel endpoints share /dev/shm):
- multi-upstream nodes (diamond joins): ``d.f.bind(b_out, c_out)`` calls
  ``d.f(b_val, c_val)`` once both inputs arrive;
- fan-out: one producer feeding several consumers gets one SPSC channel
  per consumer edge;
- multi-output DAGs: ``MultiOutputNode([x, y]).experimental_compile()``
  returns ``[x_val, y_val]`` per execution;
- overlapped (pipelined) execution: ``execute_async`` returns a future
  and lets successive executions occupy different stages concurrently —
  the per-actor loops + one-slot channels form the execution schedule
  (each stage holds at most one unread value, so depth = #stages).

    with InputNode() as inp:
        b = left.go.bind(inp)
        c = right.go.bind(inp)
        out = join.merge.bind(b, c)
    dag = out.experimental_compile()
    result = dag.execute(batch)       # -> value (synchronous)
    dag.teardown()
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ..core import serialization
from .channel import ShmChannel


class DagNode:
    def __init__(self, upstreams: List["DagNode"]):
        self.upstreams = list(upstreams)

    # Back-compat alias: linear chains used .upstream
    @property
    def upstream(self) -> Optional["DagNode"]:
        return self.upstreams[0] if self.upstreams else None

    def experimental_compile(self, channel_capacity: int = 8 * 1024 * 1024):
        return CompiledDAG([self], channel_capacity)


class InputNode(DagNode):
    """The DAG's input placeholder (reference: dag/input_node.py)."""

    def __init__(self):
        super().__init__([])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ClassMethodNode(DagNode):
    def __init__(self, actor, method_name: str,
                 upstreams: List[DagNode]):
        super().__init__(upstreams)
        self.actor = actor
        self.method_name = method_name


class MultiOutputNode(DagNode):
    """Bundle several graph nodes as the DAG's outputs; execute() returns
    their values as a list (reference: dag/output_node.py)."""

    def __init__(self, outputs: List[DagNode]):
        super().__init__(list(outputs))
        if not outputs:
            raise ValueError("MultiOutputNode needs at least one output")


def bind(actor_method, *args: DagNode) -> ClassMethodNode:
    """`actor.method.bind(node, ...)` — wires one graph step; multiple
    upstream nodes arrive as positional args of the method call."""
    if not args or not all(isinstance(a, DagNode) for a in args):
        raise TypeError("bind() takes upstream DagNode arguments")
    return ClassMethodNode(
        actor_method._handle, actor_method._name, list(args)
    )


class _DagError:
    def __init__(self, error: BaseException):
        self.error = error


class DagFuture:
    """Handle for one pipelined execution (reference: compiled DAG refs)."""

    def __init__(self, dag: "CompiledDAG"):
        self._dag = dag
        self._done = False
        self._value: Any = None

    def result(self, timeout: float = 60.0) -> Any:
        # Outputs are SPSC-ordered: resolving future N drains executions
        # 0..N's outputs in submission order.
        return self._dag._resolve_until(self, timeout)


class CompiledDAG:
    def __init__(self, outputs: List[DagNode], channel_capacity: int):
        if len(outputs) == 1 and isinstance(outputs[0], MultiOutputNode):
            self._multi_output = True
            outputs = outputs[0].upstreams
        else:
            self._multi_output = False
        for out in outputs:
            if not isinstance(out, ClassMethodNode):
                raise ValueError("DAG outputs must be bound actor methods")

        # ---- collect the graph (DFS over upstreams) ----
        nodes: List[DagNode] = []
        seen: set = set()

        def visit(n: DagNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            for up in n.upstreams:
                visit(up)
            nodes.append(n)

        for out in outputs:
            visit(out)
        steps = [n for n in nodes if isinstance(n, ClassMethodNode)]
        inputs = [n for n in nodes if isinstance(n, InputNode)]
        if len(inputs) != 1:
            raise ValueError("DAG must use exactly one InputNode")
        if len(steps) + 1 != len(nodes):
            raise ValueError("DAG nodes must be bound actor methods")
        self._input = inputs[0]
        self._steps = steps

        # ---- one SPSC channel per edge ----
        token = uuid.uuid4().hex[:12]
        self._edge_paths: Dict[Tuple[int, int, int], str] = {}
        self._all_channels: List[ShmChannel] = []
        self._chan_by_path: Dict[str, ShmChannel] = {}

        def edge_path(producer: DagNode, consumer_id: int,
                      slot: int) -> str:
            key = (id(producer), consumer_id, slot)
            p = f"/dev/shm/rtpt-dag-{token}-{len(self._edge_paths)}"
            self._edge_paths[key] = p
            ch = ShmChannel(p, channel_capacity, create=True)
            self._all_channels.append(ch)
            self._chan_by_path[p] = ch
            return p

        # Consumer-side wiring: per step, one input path per upstream slot.
        step_in_paths: Dict[int, List[str]] = {}
        # Driver-fed edges (InputNode consumers).
        self._input_paths: List[str] = []
        for step in steps:
            ins = []
            for slot, up in enumerate(step.upstreams):
                p = edge_path(up, id(step), slot)
                if isinstance(up, InputNode):
                    self._input_paths.append(p)
                ins.append(p)
            step_in_paths[id(step)] = ins
        # Driver-read output edges.
        self._output_paths: List[str] = [
            edge_path(out, -1, i) for i, out in enumerate(outputs)
        ]
        # Producer-side wiring: every edge whose producer is this step.
        step_out_paths: Dict[int, List[str]] = {id(s): [] for s in steps}
        for (pid, _cid, _slot), path in self._edge_paths.items():
            if pid in step_out_paths:
                step_out_paths[pid].append(path)

        # ---- per-actor execution loops (reference: do_exec_tasks) ----
        self._loop_refs = [
            step.actor.__rt_dag_exec_loop__.remote(
                step.method_name,
                step_in_paths[id(step)],
                step_out_paths[id(step)],
            )
            for step in steps
        ]
        # The DAG synchronizes over shm channels, never the control plane:
        # batched submissions must flush now or the exec loops never start.
        from ..core.context import ctx

        ctx.client._flush_submit_batch()
        # Driver endpoints reuse the creator attachments — one fd/mmap per
        # edge, closed exactly once in teardown.
        self._in_channels = [self._chan_by_path[p]
                             for p in self._input_paths]
        self._out_channels = [self._chan_by_path[p]
                              for p in self._output_paths]
        # Separate submit/drain locks: result() must be able to drain
        # outputs (relieving channel backpressure) while another thread is
        # blocked in execute_async's write — one shared lock would deadlock
        # pipelining beyond the channel depth.
        self._submit_lock = threading.Lock()
        self._drain_lock = threading.Lock()
        self._torn_down = False
        self._broken: Optional[str] = None
        self._pending: deque = deque()  # DagFutures in submission order

    # ---- execution ----

    def _check_usable(self):
        if self._torn_down:
            raise RuntimeError("DAG was torn down")
        if self._broken:
            raise RuntimeError(
                f"DAG is desynchronized ({self._broken}); tear it down and "
                "recompile")

    def _read_outputs(self, timeout: float):
        values = []
        for i, ch in enumerate(self._out_channels):
            try:
                view = ch.read_bytes(timeout=timeout)
            except Exception:
                # The execution was already submitted: its unread output(s)
                # would mispair with the next future.  Poison the DAG (this
                # covers the single-output i == 0 case too — the late value
                # still lands in the channel eventually).
                self._broken = "output read failed/timed out"
                raise
            try:
                values.append(serialization.unpack(bytes(view)))
            finally:
                view.release()
                ch.done_reading()
        for v in values:
            if isinstance(v, _DagError):
                raise v.error
        return values if self._multi_output else values[0]

    def execute_async(self, value: Any, timeout: float = 60.0) -> DagFuture:
        """Submit one execution without waiting for its result — successive
        submissions overlap across pipeline stages (each stage's channel
        buffers one value, so a S-stage chain runs S executions
        concurrently; reference: compiled DAG overlapped execution
        schedules, dag_node_operation.py).  When the pipeline is full the
        write blocks until a result() drains an output (possible from
        another thread: submit and drain take separate locks)."""
        with self._submit_lock:
            self._check_usable()
            blob = serialization.pack(value)
            for i, ch in enumerate(self._in_channels):
                try:
                    ch.write_bytes(blob, timeout=timeout)
                except Exception:
                    if i > 0:
                        # Some input edges got this execution, others
                        # didn't: joins would pair mismatched executions.
                        self._broken = "partial input write"
                    raise
            fut = DagFuture(self)
            self._pending.append(fut)
            return fut

    def _resolve_until(self, fut: DagFuture, timeout: float):
        # Bound the lock acquisition by the caller's timeout too: another
        # thread may hold _drain_lock blocked inside a channel read, and a
        # result(timeout) must not wait past its deadline for the lock
        # (it re-checks _done first — the holder may have resolved us).
        # Lock-wait time counts against the same deadline as the drain.
        deadline = (time.monotonic() + timeout) if timeout >= 0 else None
        if not self._drain_lock.acquire(
                timeout=timeout if timeout >= 0 else -1):
            if fut._done:
                if isinstance(fut._value, BaseException):
                    raise fut._value
                return fut._value
            raise TimeoutError(
                f"result not available within {timeout}s "
                "(another thread is draining the DAG)")
        try:
            remaining = (max(deadline - time.monotonic(), 0.0)
                         if deadline is not None else timeout)
            if remaining <= 0.0 and not fut._done:
                # The lock wait consumed the whole budget.  Raise to THIS
                # caller without starting a drain: a zero-budget channel
                # read would time out and poison the (healthy) DAG.
                raise TimeoutError(
                    f"result not available within {timeout}s "
                    "(deadline spent waiting for the drain lock)")
            return self._resolve_locked(fut, remaining)
        finally:
            self._drain_lock.release()

    def _resolve_locked(self, fut: DagFuture, timeout: float):
        while not fut._done:
            if self._broken or self._torn_down:
                # Poisoned/closed: channels may be desynchronized or
                # unlinked — fail pending futures instead of draining
                # mispaired (or freed) values.
                why = ("DAG was torn down" if self._torn_down
                       else f"DAG is desynchronized ({self._broken})")
                while self._pending:
                    h = self._pending.popleft()
                    if not h._done:
                        h._value = RuntimeError(why)
                        h._done = True
                if not fut._done:
                    fut._value = RuntimeError(why)
                    fut._done = True
                break
            if not self._pending:
                raise RuntimeError("future already resolved")
            head = self._pending.popleft()
            try:
                head._value = self._read_outputs(timeout)
            except BaseException as e:  # noqa: BLE001
                head._value = e
            head._done = True
        if isinstance(fut._value, BaseException):
            raise fut._value
        return fut._value

    def execute(self, value: Any, timeout: float = 60.0) -> Any:
        return self.execute_async(value, timeout).result(timeout)

    def teardown(self):
        with self._submit_lock, self._drain_lock:
            if self._torn_down:
                return
            self._torn_down = True
            # Fail still-pending futures now: after this the channels are
            # closed and unlinked, so a later result() must raise cleanly.
            while self._pending:
                h = self._pending.popleft()
                if not h._done:
                    h._value = RuntimeError("DAG was torn down")
                    h._done = True
            for ch in self._in_channels:
                ch.close_writer()
            try:
                ray_tpu_torch.get(self._loop_refs, timeout=30)
            except Exception:
                pass
            for ch in self._all_channels:
                ch.close(unlink=True)


def _dag_exec_loop(self, method_name: str, in_paths, out_paths):
    """Injected actor method: the per-actor compiled-DAG execution loop —
    read one value from every input edge, apply the method, publish the
    result on every output edge (fan-out = one SPSC channel per consumer).
    Errors (and upstream errors) forward downstream instead of calling the
    method, so the driver sees the root cause."""
    if isinstance(in_paths, str):   # pre-graph linear form
        in_paths = [in_paths]
    if isinstance(out_paths, str):
        out_paths = [out_paths]
    ins = [ShmChannel(p) for p in in_paths]
    outs = [ShmChannel(p) for p in out_paths]
    method = getattr(self, method_name)
    try:
        while True:
            values = []
            closed = False
            for ch in ins:
                try:
                    view = ch.read_bytes(timeout=3600.0)
                except EOFError:
                    closed = True
                    break
                try:
                    values.append(serialization.unpack(bytes(view)))
                finally:
                    view.release()
                    ch.done_reading()
            if closed:
                for out in outs:
                    out.close_writer()
                return "closed"
            upstream_err = next(
                (v for v in values if isinstance(v, _DagError)), None)
            if upstream_err is not None:
                result = upstream_err
            else:
                try:
                    result = method(*values)
                except BaseException as e:  # noqa: BLE001 — to the driver
                    result = _DagError(e)
            blob = serialization.pack(result)
            for out in outs:
                out.write_bytes(blob)
    finally:
        for ch in ins:
            ch.close()
        for ch in outs:
            ch.close()


def enable_compiled_dags(actor_class):
    """Class decorator: make an actor class usable in compiled DAGs (adds
    the exec-loop method; bind via `actor.method.bind(node, ...)`)."""
    actor_class._cls.__rt_dag_exec_loop__ = _dag_exec_loop
    return actor_class
