"""DeploymentHandle: route requests to replicas (port of
``ray_tpu/serve/handle.py``, unchanged).

Role-equivalent to the reference's DeploymentHandle -> Router ->
PowerOfTwoChoicesReplicaScheduler chain
(reference: serve/handle.py:729 .remote, _private/router.py:560
assign_request, replica_scheduler/pow_2_scheduler.py:51): two random
replicas are compared by queue pressure and the less-loaded one gets the
request.  The routing table refreshes from the controller when its version
changes (the long-poll analog, reference: _private/long_poll.py).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch

# Replica-death retry budget: total attempts a request gets when its replica
# dies underneath it (rolling update, crash) before the error surfaces.
# Shared by the unary path (DeploymentResponse.result) and the streaming
# path (DeploymentResponseGenerator, pre-first-item only — a mid-stream
# replica death is stateful and must surface).  Every consumed retry counts
# into ``ray_tpu_serve_replica_retries_total`` (tagged by path).
REPLICA_RETRY_BUDGET = 3

# How long a request waits for a routable replica, first pick and retries
# alike: a replacement may still be starting, and the port's controller
# lists no replica until its first ping lands (it does not wait for one in
# its loop).
REPLICA_WAIT_S = 30.0


def _replica_retry_policy():
    """Re-route pacing after a replica death: the unified jittered-doubling
    curve (core/deadline.py), starting where the old hand-rolled ramp did
    (200 ms) and capped at 1 s — a rolling update replaces a replica well
    within the budget, so longer waits only add tail latency."""
    from ..core.deadline import BackoffPolicy

    return BackoffPolicy(base_s=0.2, multiplier=2.0, cap_s=1.0)


def _count_replica_retry(path: str) -> None:
    from ..util.metrics import get_counter

    try:
        get_counter(
            "ray_tpu_serve_replica_retries_total",
            "Requests re-routed after a replica death",
            tag_keys=("path",),
        ).inc(1, tags={"path": path})
    except Exception:
        pass  # metrics must never fail a request


class DeploymentResponse:
    """Future-like result of handle.remote() (reference: serve/handle.py
    DeploymentResponse).  A replica dying under the request (rolling
    update, crash) re-routes it once the routing table refreshes
    (reference: the router retries failed replicas)."""

    def __init__(self, ref, done_cb=None, retry=None,
                 stall_timeout_s: Optional[float] = None, eject=None):
        self._ref = ref
        self._done_cb = done_cb
        self._retry = retry
        # Gray-failure knob (handle.options(stall_timeout_s=...)): a
        # replica holding the request past this many seconds is treated as
        # stalled — ejected from the p2c set and the request re-routed,
        # within the same REPLICA_RETRY_BUDGET that covers death.
        self._stall_timeout_s = stall_timeout_s
        self._eject = eject

    def result(self, timeout: float = 60.0):
        from ..exceptions import (ActorDiedError, GetTimeoutError,
                                  WorkerCrashedError)

        from ..core.deadline import Deadline

        deadline = Deadline.after(timeout)
        backoff = _replica_retry_policy()
        try:
            for attempt in range(REPLICA_RETRY_BUDGET):
                last = attempt == REPLICA_RETRY_BUDGET - 1
                get_timeout = timeout
                if self._stall_timeout_s is not None:
                    get_timeout = min(self._stall_timeout_s,
                                      max(0.0, deadline.remaining()))
                try:
                    return ray_tpu_torch.get(self._ref, timeout=get_timeout)
                except (ActorDiedError, WorkerCrashedError):
                    if self._retry is None or last:
                        raise
                    _count_replica_retry("unary")
                    backoff.sleep(attempt + 1, deadline)
                    self._ref = self._retry()
                except GetTimeoutError:
                    # Stalled replica (accepts, never answers): eject it
                    # from the p2c set and re-route — unless the stall
                    # knob is off (then the timeout is the caller's own)
                    # or the overall deadline is spent anyway.
                    if (self._stall_timeout_s is None or self._retry is None
                            or last
                            or deadline.remaining()
                            <= self._stall_timeout_s):
                        raise
                    if self._eject is not None:
                        self._eject()
                    _count_replica_retry("stall")
                    self._ref = self._retry()
        finally:
            if self._done_cb is not None:
                self._done_cb()
                self._done_cb = None

    @property
    def ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment call's items (reference:
    serve/handle.py DeploymentResponseGenerator over an
    ObjectRefGenerator).  Buffering is consumer-side one-item-at-a-time;
    produced-but-unconsumed items wait in the object store (spill-bounded),
    never in this process.  The REPLICA_RETRY_BUDGET applies only BEFORE
    the first item is yielded (the request is still stateless then); a
    mid-stream replica death is stateful and surfaces to the caller."""

    def __init__(self, ref_gen, done_cb=None, retry=None):
        self._gen = ref_gen
        self._done_cb = done_cb
        self._retry = retry

    def _release(self):
        if self._done_cb is not None:
            cb, self._done_cb = self._done_cb, None
            cb()

    def cancel(self) -> None:
        """Stop the replica-side generator (reference: serve's streaming
        requests cancel the underlying task when the client disconnects).
        The replica raises TaskCancelledError inside the user generator,
        so engine-backed deployments free pages mid-flight.  Idempotent;
        also releases this handle's outstanding-load count."""
        try:
            self._gen.cancel()
        except Exception:  # noqa: BLE001 — cancel must never raise at
            pass           # teardown (task may already be finished)
        self._release()

    def __iter__(self):
        from ..exceptions import ActorDiedError, WorkerCrashedError

        try:
            yielded = False
            attempt = 0
            backoff = _replica_retry_policy()
            while True:
                try:
                    for ref in self._gen:
                        yield ray_tpu_torch.get(ref)
                        yielded = True
                    return
                except (ActorDiedError, WorkerCrashedError):
                    attempt += 1
                    if (yielded or self._retry is None
                            or attempt >= REPLICA_RETRY_BUDGET):
                        raise
                    _count_replica_retry("streaming")
                    backoff.sleep(attempt)
                    self._gen = self._retry()
        finally:
            self._release()

    def __del__(self):
        # A stream created but never iterated must still release its
        # replica's outstanding-load count, or p2c routing skews away from
        # that replica until the next routing-table version bump.
        try:
            self._release()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class DeploymentHandle:
    def __init__(self, deployment_name: str, method: str = "__call__",
                 multiplexed_model_id: str = "", stream: bool = False,
                 stall_timeout_s: Optional[float] = None):
        self.deployment_name = deployment_name
        self.method = method
        self.multiplexed_model_id = multiplexed_model_id
        self.stream = stream
        # Opt-in stalled-replica detection: a unary request unanswered for
        # this long ejects its replica from the p2c set and re-routes
        # (None = off; a replica can legitimately be slow).
        self.stall_timeout_s = stall_timeout_s
        self._replicas: List[Any] = []
        self._replica_ids: List[int] = []
        self._version = -1
        self._last_refresh = 0.0
        self._local_load: Dict[int, int] = {}  # replica idx -> outstanding
        self._ejected: Dict[int, float] = {}   # replica idx -> lift time
        self._lock = threading.Lock()

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                stall_timeout_s: Optional[float] = None
                ) -> "DeploymentHandle":
        """(reference: serve/handle.py .options — method_name,
        multiplexed_model_id, stream and stall_timeout_s are the supported
        knobs here; stream=True makes .remote() return a
        DeploymentResponseGenerator over a generator deployment's
        items)."""
        return DeploymentHandle(
            self.deployment_name,
            method_name if method_name is not None else self.method,
            multiplexed_model_id if multiplexed_model_id is not None
            else self.multiplexed_model_id,
            stream if stream is not None else self.stream,
            stall_timeout_s if stall_timeout_s is not None
            else self.stall_timeout_s,
        )

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        with self._lock:
            if not force and self._replicas and now - self._last_refresh < 1.0:
                return
        from .controller import get_or_create_controller

        controller = get_or_create_controller()
        table = ray_tpu_torch.get(controller.routing_table.remote(), timeout=30)
        with self._lock:
            if table["version"] != self._version:
                self._replicas = table["deployments"].get(
                    self.deployment_name, []
                )
                self._replica_ids = table.get("replica_ids", {}).get(
                    self.deployment_name, []
                )
                self._version = table["version"]
                self._local_load = {i: 0 for i in range(len(self._replicas))}
                # Indexes shifted with the table: stale ejections would
                # punish whichever replica inherited the slot.
                self._ejected = {}
            self._last_refresh = now

    def _pick(self) -> int:
        """Power-of-two-choices on the handle's local outstanding counts
        (the client-side view of queue pressure).  Multiplexed requests get
        rendezvous-hash affinity over the controller's STABLE replica ids
        instead: a model id sticks to one replica so repeated requests hit
        its warm LRU, and adding/removing a replica remaps only the models
        that must move (modulus hashing over list positions reshuffled
        nearly every model on any scale event, stranding every warm
        cache)."""
        n = len(self._replicas)
        now = time.monotonic()
        if self._ejected:
            for i in [i for i, lift in self._ejected.items() if now >= lift]:
                self._ejected.pop(i, None)  # lift: the next pick re-probes
        if n == 1:
            return 0
        if self.multiplexed_model_id:
            from .multiplex import pick_replica_for_model

            ids = self._replica_ids if len(self._replica_ids) == n \
                else list(range(n))
            return pick_replica_for_model(self.multiplexed_model_id, ids)
        # Stalled replicas sit out of the candidate set until their lift
        # time — unless everything is ejected, in which case degrading to
        # the full set beats refusing the request.
        avail = [i for i in range(n) if i not in self._ejected] \
            if self._ejected else list(range(n))
        if not avail:
            avail = list(range(n))
        if len(avail) == 1:
            return avail[0]
        i, j = random.sample(avail, 2)
        return i if self._local_load.get(i, 0) <= self._local_load.get(j, 0) \
            else j

    def _acquire(self, release: Optional[int] = None, force: bool = False):
        """Wait up to ``REPLICA_WAIT_S`` for a routable replica, pick one
        and count the request against it; a retry moves its count off
        ``release``, the replica it leaves.  Returns ``(index, handle)``."""
        deadline = time.monotonic() + REPLICA_WAIT_S
        while True:
            self._refresh(force=force)
            with self._lock:
                if self._replicas:
                    if release in self._local_load:
                        self._local_load[release] = max(
                            0, self._local_load[release] - 1)
                    idx = self._pick()
                    self._local_load[idx] = self._local_load.get(idx, 0) + 1
                    return idx, self._replicas[idx]
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"deployment {self.deployment_name!r} has no running "
                    "replicas"
                )
            time.sleep(0.1)
            force = True

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        idx, replica = self._acquire()
        state = {"idx": idx}

        def done():
            with self._lock:
                i = state["idx"]
                if i in self._local_load:
                    self._local_load[i] = max(0, self._local_load[i] - 1)

        def submit(rep):
            if self.stream:
                return rep.handle_request_streaming.options(
                    num_returns="streaming"
                ).remote(self.method, args, kwargs,
                         model_id=self.multiplexed_model_id)
            return rep.handle_request.remote(
                self.method, args, kwargs,
                model_id=self.multiplexed_model_id,
            )

        # Routing span: parents the replica's execution span to the
        # ingress trace and records which replica the p2c pick chose; the
        # replica queue-wait then reads off the trace as the gap between
        # this span and the execution span.  Propagation-only — an
        # untraced caller (no ingress span, no user trace) pays nothing;
        # roots come from the ingress or an explicit tracing.trace().
        from ..util import tracing

        with tracing.trace_if_active(f"handle:{self.deployment_name}",
                                     stream=self.stream) as hspan:
            try:
                ref = submit(replica)
            except Exception:
                done()
                # Replica likely died: force-refresh and retry once.
                state["idx"], replica = self._acquire(force=True)
                ref = submit(replica)
            # Late attr: the FINAL pick — the in-span retry may have
            # re-routed off a dead replica, and the trace must name the
            # replica that actually got the request.
            hspan["attrs"] = {"replica": state["idx"]}

        def retry():
            state["idx"], rep = self._acquire(release=state["idx"],
                                              force=True)
            return submit(rep)

        if self.stream:
            return DeploymentResponseGenerator(ref, done, retry)

        def eject():
            with self._lock:
                lift = time.monotonic() + max(
                    5.0, 2.0 * (self.stall_timeout_s or 0.0))
                self._ejected[state["idx"]] = lift

        return DeploymentResponse(ref, done, retry,
                                  stall_timeout_s=self.stall_timeout_s,
                                  eject=eject)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.method,
                 self.multiplexed_model_id, self.stream,
                 self.stall_timeout_s))
