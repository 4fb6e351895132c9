"""ray_tpu_torch.workflow: durable workflows on top of tasks.

Role-equivalent to the reference's workflow library
(reference: python/ray/workflow/api.py:123 run/:177 run_async,
workflow_executor.py, workflow_storage.py — steps execute as tasks, every
step's result is persisted, and re-running the same workflow_id resumes from
the last completed step instead of recomputing).

    a = workflow.step(load)(path)
    b = workflow.step(transform)(a)
    result = workflow.run(b, workflow_id="etl-1")   # crash-safe

The port's own copy of ``ray_tpu/workflow/__init__.py``.  A step runs as a
plain task, as in the JAX package; a step reaches the card by submitting a
``num_gpus=1`` task from inside itself.  Storage defaults to
``ray_tpu_torch_workflows`` under the temp dir (``core/config.tmp_root``).
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.core.config import tmp_root

DEFAULT_STORAGE = tmp_root("workflows")


class StepNode:
    """One step: a function applied to values and/or upstream steps."""

    def __init__(self, fn: Callable, args: tuple, kwargs: dict):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = getattr(fn, "__name__", "step")

    def _upstream(self) -> List["StepNode"]:
        ups = [a for a in self.args if isinstance(a, StepNode)]
        ups += [v for v in self.kwargs.values() if isinstance(v, StepNode)]
        return ups


def step(fn: Callable) -> Callable[..., StepNode]:
    """Wrap a function so calls build workflow steps (reference:
    the DAG-node binding layer of workflow.run).  A step that RETURNS a
    StepNode continues into that sub-DAG: the sub-steps execute (and
    checkpoint) inside the same workflow, and their result becomes the
    step's result — dynamic workflows (reference: workflow.continuation,
    workflow_executor.py handles steps that return DAGs)."""

    def make(*args, **kwargs) -> StepNode:
        return StepNode(fn, args, kwargs)

    make.__name__ = getattr(fn, "__name__", "step")
    return make


class EventStepNode(StepNode):
    """A step that completes when an external event arrives (reference:
    python/ray/workflow/event_listener.py:11 EventListener.poll_for_event,
    http_event_provider.py).  The poll function runs driver-side on a
    cadence; a non-None return IS the event payload, checkpointed like any
    step result — resume never re-waits for a received event."""

    def __init__(self, poll_fn: Callable, args: tuple, kwargs: dict,
                 poll_interval_s: float = 0.2,
                 timeout_s: Optional[float] = None):
        super().__init__(poll_fn, args, kwargs)
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s
        self.name = f"event_{self.name}"


def wait_for_event(poll_fn: Callable, *args,
                   poll_interval_s: float = 0.2,
                   timeout_s: Optional[float] = None,
                   **kwargs) -> EventStepNode:
    """Build an event-listener step: the workflow blocks here until
    poll_fn(*args, **kwargs) returns non-None (the event payload).
    Upstream StepNodes in args resolve first, like any step."""
    return EventStepNode(poll_fn, args, kwargs, poll_interval_s, timeout_s)


def kv_event(key: str, *, poll_interval_s: float = 0.2,
             timeout_s: Optional[float] = None) -> EventStepNode:
    """Event = a cluster-KV key appearing.  The KV table rides the head
    snapshot, so the signal survives head restarts; the received payload
    is checkpointed in workflow storage (reference: the KV/HTTP event
    providers commit events durably before the workflow advances)."""

    def poll_kv():
        from ray_tpu_torch.core.context import ctx

        raw = ctx.client.kv_get(key)
        return None if raw is None else raw

    poll_kv.__name__ = f"kv[{key}]"
    return wait_for_event(poll_kv, poll_interval_s=poll_interval_s,
                          timeout_s=timeout_s)


class _Storage:
    """File-per-step result store (reference: workflow_storage.py)."""

    def __init__(self, workflow_id: str, base: Optional[str]):
        self.dir = os.path.join(base or DEFAULT_STORAGE, workflow_id)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step_id: str) -> str:
        return os.path.join(self.dir, f"{step_id}.pkl")

    def has(self, step_id: str) -> bool:
        return os.path.exists(self._path(step_id))

    def load(self, step_id: str) -> Any:
        with open(self._path(step_id), "rb") as f:
            return pickle.load(f)

    def save(self, step_id: str, value: Any):
        tmp = self._path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(value, f)
        os.replace(tmp, self._path(step_id))


def _topo_order(root: StepNode) -> List[StepNode]:
    order: List[StepNode] = []
    seen: set = set()

    def visit(node: StepNode):
        if id(node) in seen:
            return
        seen.add(id(node))
        for up in node._upstream():
            visit(up)
        order.append(node)

    visit(root)
    return order


def run(node: StepNode, *, workflow_id: str,
        storage: Optional[str] = None, _prefix: str = "") -> Any:
    """Execute the workflow durably: each step runs as a cluster task, its
    result persists before the next step starts, and a re-run with the same
    workflow_id skips completed steps (reference: api.py:123 run +
    workflow_state_from_storage.py resume).

    Event steps (EventStepNode) poll driver-side until their event
    arrives; steps returning StepNodes continue into the returned sub-DAG
    (checkpointed under the parent step's id namespace)."""
    import time

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    store = _Storage(workflow_id, storage)
    order = _topo_order(node)
    # Deterministic step ids: topological index + function name (stable for
    # the same DAG shape across runs — the resume key).  Sub-DAG steps get
    # the parent step's id as a dotted prefix.  Ids become FILENAMES in
    # _Storage, so path separators in step names (e.g. a kv_event key like
    # "jobs/123/done") must be sanitized out.
    ids = {
        id(n): f"{_prefix}{i:03d}_{n.name}".replace(os.sep, ".").replace(
            "/", ".")
        for i, n in enumerate(order)
    }
    results: Dict[int, Any] = {}
    remaining = [n for n in order]
    inflight: Dict[Any, StepNode] = {}  # ref -> node
    # Ready event steps being polled: node -> first-poll time.
    polling: Dict[int, float] = {}
    first_error: Optional[BaseException] = None

    def finish(n: StepNode, value: Any):
        nonlocal first_error
        if isinstance(value, StepNode):
            if first_error is not None:
                # A sibling already failed: launching a whole sub-DAG now
                # would delay error propagation with fresh cluster work.
                # The unexecuted continuation isn't checkpointed, so a
                # resume re-runs the parent and continues normally.
                return
            # Dynamic continuation: execute the returned sub-DAG in the
            # same workflow; ITS result is this step's durable result.
            try:
                value = run(value, workflow_id=workflow_id,
                            storage=storage,
                            _prefix=ids[id(n)].replace("/", ".") + ".")
            except BaseException as e:  # noqa: BLE001
                if first_error is None:
                    first_error = e
                return
        store.save(ids[id(n)], value)
        results[id(n)] = value

    while remaining or inflight or polling:
        # Launch every step whose upstreams are resolved: independent
        # branches run concurrently (reference: workflow_executor.py runs
        # all ready tasks).
        still_waiting: List[StepNode] = []
        for n in remaining:
            if first_error is not None:
                still_waiting.append(n)
                continue
            sid = ids[id(n)]
            if store.has(sid):
                results[id(n)] = store.load(sid)
                continue
            if not all(id(u) in results for u in n._upstream()):
                still_waiting.append(n)
                continue
            if isinstance(n, EventStepNode):
                polling.setdefault(id(n), time.monotonic())
                still_waiting.append(n)
                continue
            args = tuple(
                results[id(a)] if isinstance(a, StepNode) else a
                for a in n.args
            )
            kwargs = {
                k: results[id(v)] if isinstance(v, StepNode) else v
                for k, v in n.kwargs.items()
            }
            ref = ray_tpu_torch.remote(n.fn).remote(*args, **kwargs)
            inflight[ref] = n
        remaining = still_waiting

        # Poll ready event steps once per loop turn (driver-side — the
        # listener is control-plane work, not a cluster task).
        min_interval = None
        for n in list(remaining):
            if id(n) not in polling or first_error is not None:
                continue
            args = tuple(
                results[id(a)] if isinstance(a, StepNode) else a
                for a in n.args
            )
            kwargs = {
                k: results[id(v)] if isinstance(v, StepNode) else v
                for k, v in n.kwargs.items()
            }
            try:
                event = n.fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001
                if first_error is None:
                    first_error = e
                polling.pop(id(n), None)
                remaining.remove(n)
                continue
            if event is not None:
                polling.pop(id(n), None)
                remaining.remove(n)
                finish(n, event)
            elif (n.timeout_s is not None
                    and time.monotonic() - polling[id(n)] > n.timeout_s):
                polling.pop(id(n), None)
                remaining.remove(n)
                if first_error is None:
                    first_error = TimeoutError(
                        f"event step {ids[id(n)]} saw no event within "
                        f"{n.timeout_s}s")
            else:
                min_interval = (n.poll_interval_s if min_interval is None
                                else min(min_interval, n.poll_interval_s))

        if not inflight:
            if polling and first_error is None:
                time.sleep(min_interval or 0.2)
                continue
            if first_error is not None:
                raise first_error
            continue
        ready, _ = ray_tpu_torch.wait(
            list(inflight), num_returns=1,
            timeout=min_interval if min_interval is not None else 3600)
        for ref in ready:
            n = inflight.pop(ref)
            try:
                value = ray_tpu_torch.get(ref)
            except BaseException as e:  # noqa: BLE001 — raised after drain
                if first_error is None:
                    first_error = e
                continue
            finish(n, value)
    if first_error is not None:
        raise first_error
    return results[id(node)]


class WorkflowRun:
    def __init__(self, thread: threading.Thread, box: dict):
        self._thread = thread
        self._box = box

    def result(self, timeout: Optional[float] = None) -> Any:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("workflow still running")
        if "error" in self._box:
            raise self._box["error"]
        return self._box["value"]


def run_async(node: StepNode, *, workflow_id: str,
              storage: Optional[str] = None) -> WorkflowRun:
    """(reference: api.py:177 run_async)"""
    box: dict = {}

    def go():
        try:
            box["value"] = run(node, workflow_id=workflow_id, storage=storage)
        except BaseException as e:  # noqa: BLE001 — delivered via result()
            box["error"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    return WorkflowRun(t, box)


def list_workflows(storage: Optional[str] = None) -> List[str]:
    base = storage or DEFAULT_STORAGE
    try:
        return sorted(os.listdir(base))
    except FileNotFoundError:
        return []


def delete(workflow_id: str, storage: Optional[str] = None):
    import shutil

    shutil.rmtree(os.path.join(storage or DEFAULT_STORAGE, workflow_id),
                  ignore_errors=True)
