"""Autoscaler v2 shape: instance lifecycle manager + versioned storage.

Role-equivalent to the reference's autoscaler v2 core (reference:
python/ray/autoscaler/v2/instance_manager/instance_manager.py:29
InstanceManager.update_instance_manager_state — the only mutating entry
point, driven by the reconciler; instance_storage.py — versioned store
with status-transition validation; common.py InstanceUtil).  With two
NodeProviders (local hosts, GPU slices) the lifecycle bookkeeping moves
out of the reconciler into this layer: every provider node is an
Instance with an auditable status history, and the Autoscaler mutates
the fleet only through update() calls.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Status machine (reference: instance.proto Instance.Status).  Transitions
# not listed here are bugs, not races.
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RUNNING = "RAY_RUNNING"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"
ALLOCATION_FAILED = "ALLOCATION_FAILED"

_VALID_TRANSITIONS = {
    QUEUED: {REQUESTED},
    REQUESTED: {ALLOCATED, ALLOCATION_FAILED},
    ALLOCATED: {RUNNING, TERMINATING},
    RUNNING: {TERMINATING},
    TERMINATING: {TERMINATED},
    ALLOCATION_FAILED: set(),
    TERMINATED: set(),
}

# Terminal rows kept for status history before eviction (the reference GCs
# terminated instances; unbounded retention would pin provider handles).
_TERMINAL_KEEP = 128


@dataclasses.dataclass
class Instance:
    instance_id: str
    status: str = QUEUED
    # Provider-side handle once allocated (slice handle / node handle).
    handle: Any = None
    # [(status, unix_ts), ...] — the audit trail surfaced by status APIs
    # (reference: InstanceUtil.get_status_transition_times).
    history: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)

    def __post_init__(self):
        if not self.history:
            self.history = [(self.status, time.time())]


class InstanceStorage:
    """Versioned instance table (reference: instance_storage.py — every
    batch update bumps the store version; readers see (instances,
    version) snapshots and writers pass their expected version for
    optimistic concurrency)."""

    def __init__(self):
        self._instances: Dict[str, Instance] = {}
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def get_instances(self) -> Tuple[Dict[str, Instance], int]:
        return dict(self._instances), self._version

    def batch_update(self, upserts: List[Instance],
                     expected_version: Optional[int] = None) -> bool:
        if (expected_version is not None
                and expected_version != self._version):
            return False  # caller raced another writer: re-read and retry
        for inst in upserts:
            self._instances[inst.instance_id] = inst
        self._version += 1
        return True

    def evict(self, instance_id: str) -> None:
        self._instances.pop(instance_id, None)
        self._version += 1


class InstanceManager:
    """The only mutating surface over the instance table (reference:
    instance_manager.py:29 — the reconciler calls
    update_instance_manager_state with launch requests + terminations;
    the manager drives the NodeProvider and records transitions)."""

    def __init__(self, provider):
        self.provider = provider
        self.storage = InstanceStorage()
        self._seq = itertools.count(1)

    # -- internals -----------------------------------------------------------

    def _transition(self, inst: Instance, status: str):
        allowed = _VALID_TRANSITIONS[inst.status]
        if status not in allowed:
            raise ValueError(
                f"invalid instance transition {inst.status} -> {status} "
                f"for {inst.instance_id}")
        inst.status = status
        inst.history.append((status, time.time()))

    # -- reconciler API ------------------------------------------------------

    def update(self, *, launch: int = 0,
               terminate: Optional[List[str]] = None) -> List[str]:
        """One reconcile mutation: launch N new instances and/or terminate
        the given instance ids.  Returns the newly launched instance ids.
        Provider failures mark the instance ALLOCATION_FAILED instead of
        raising — the reconciler's next tick sees the failure in the
        table (reference: the v2 reconciler reads failures from storage,
        never from exceptions)."""
        launched: List[str] = []
        for _ in range(launch):
            iid = f"inst-{next(self._seq)}"
            inst = Instance(iid)
            self._transition(inst, REQUESTED)
            try:
                handle = self.provider.create_node()
            except Exception:
                logger.exception("instance %s allocation failed", iid)
                self._transition(inst, ALLOCATION_FAILED)
                self._commit([inst])
                continue
            inst.handle = handle
            self._transition(inst, ALLOCATED)
            self._transition(inst, RUNNING)
            self._commit([inst])
            launched.append(iid)
        for iid in terminate or []:
            instances, _ = self.storage.get_instances()
            inst = instances.get(iid)
            if inst is None or inst.status not in (ALLOCATED, RUNNING,
                                                   TERMINATING):
                continue
            if inst.status != TERMINATING:
                self._transition(inst, TERMINATING)
                self._commit([inst])
            try:
                self.provider.terminate_node(inst.handle)
            except Exception:
                # Stays TERMINATING: the reconciler's next tick retries
                # (marking TERMINATED here would zombie a still-billing
                # node the provider failed to release).
                logger.exception("instance %s terminate failed; will "
                                 "retry", iid)
                continue
            self._transition(inst, TERMINATED)
            inst.handle = None  # release: terminal rows must not pin nodes
            self._commit([inst])
        self._gc()
        return launched

    def _commit(self, upserts: List[Instance]):
        """Versioned write with the optimistic-concurrency handshake the
        storage exposes (single-writer today, so a rejection means a bug
        — surface it instead of silently dropping the upsert)."""
        _, version = self.storage.get_instances()
        if not self.storage.batch_update(upserts,
                                         expected_version=version):
            raise RuntimeError(
                "instance storage version raced; concurrent writer?")

    def _gc(self):
        """Evict the oldest terminal rows beyond the bounded history."""
        instances, _ = self.storage.get_instances()
        terminal = sorted(
            (i for i in instances.values()
             if i.status in (TERMINATED, ALLOCATION_FAILED)),
            key=lambda i: i.history[-1][1],
        )
        excess = len(terminal) - _TERMINAL_KEEP
        if excess > 0:
            for inst in terminal[:excess]:
                self.storage.evict(inst.instance_id)

    # -- read side -----------------------------------------------------------

    def running(self) -> Dict[str, Instance]:
        instances, _ = self.storage.get_instances()
        return {i: inst for i, inst in instances.items()
                if inst.status == RUNNING}

    def instance_of_handle(self, handle) -> Optional[Instance]:
        instances, _ = self.storage.get_instances()
        for inst in instances.values():
            if inst.handle is handle:
                return inst
        return None

    def get_state(self) -> List[dict]:
        """Serializable fleet view for status APIs/dashboards."""
        instances, version = self.storage.get_instances()
        return [{
            "instance_id": inst.instance_id,
            "status": inst.status,
            "history": [
                {"status": s, "ts": ts} for s, ts in inst.history
            ],
            "node_ids": (self.provider.node_ids_of(inst.handle)
                         if inst.handle is not None else []),
            "version": version,
        } for inst in instances.values()]
