"""Cluster resource scheduler: nodes, resource accounting, scheduling policies,
placement groups.

Role-equivalent to the reference's two-level scheduler
(reference: src/ray/raylet/scheduling/cluster_task_manager.h:42,
cluster_resource_scheduler.h:44, policy/hybrid_scheduling_policy.h:50,
policy/bundle_scheduling_policy.h).  GPUs are a first-class resource
("GPU") with a per-node pool of concrete card IDs (the port's counterpart
of ``ray_tpu/core/scheduler.py``'s TPU chip pool), and placement groups
support gang reservations so SPMD jobs get all-or-nothing worker groups.

Pure in-memory logic — the control plane (head.py) drives it from its event
loop; no IO here, so it is unit-testable in isolation.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

from .ids import NodeID, PlacementGroupID

ResourceDict = Dict[str, float]

_EPS = 1e-9


def _fits(avail: ResourceDict, req: ResourceDict) -> bool:
    return all(avail.get(k, 0.0) + _EPS >= v for k, v in req.items())


def _sub(avail: ResourceDict, req: ResourceDict) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


def _add(avail: ResourceDict, req: ResourceDict) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) + v


class PlacementStrategy(str, enum.Enum):
    PACK = "PACK"
    SPREAD = "SPREAD"
    STRICT_PACK = "STRICT_PACK"
    STRICT_SPREAD = "STRICT_SPREAD"


@dataclasses.dataclass
class SchedulingStrategy:
    """Union of the reference's scheduling strategies
    (reference: python/ray/util/scheduling_strategies.py)."""

    kind: str = "default"  # default | spread | node_affinity | placement_group
    node_id: Optional[NodeID] = None
    soft: bool = False
    pg_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1

    @staticmethod
    def default() -> "SchedulingStrategy":
        return SchedulingStrategy()


@dataclasses.dataclass
class NodeState:
    node_id: NodeID
    total: ResourceDict
    available: ResourceDict
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    alive: bool = True
    # Announced preemption (SIGTERM with a grace window): the node is still
    # up — running work may finish and checkpoint — but no NEW leases or
    # bundle reservations land on it (reference: ray.util.state node DRAINING
    # via DrainNode; autoscaler v2 drains before terminating).
    draining: bool = False
    # Free GPU IDs on this host.  The float "GPU" resource governs
    # *admission*; this pool assigns the concrete device indices a granted
    # task may see (CUDA_VISIBLE_DEVICES isolation, accelerators.py).
    gpu_free: List[int] = dataclasses.field(default_factory=list)
    # Execution slots leased out to clients for direct (head-bypassing)
    # task submission.  Their resources are held in `available` like any
    # running task's; this count keeps the load visible to introspection
    # and the autoscaler even though the per-task traffic never transits
    # the head (reference: raylet worker leases are resources in use).
    leased_slots: int = 0

    @property
    def schedulable(self) -> bool:
        """Eligible for NEW placements (alive and not being drained)."""
        return self.alive and not self.draining

    def utilization(self) -> float:
        worst = 0.0
        for k, tot in self.total.items():
            if tot <= 0:
                continue
            used = tot - self.available.get(k, 0.0)
            worst = max(worst, used / tot)
        return worst


@dataclasses.dataclass
class Bundle:
    resources: ResourceDict
    node_id: Optional[NodeID] = None  # where reserved
    available: ResourceDict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PlacementGroup:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    strategy: PlacementStrategy
    created: bool = False
    name: str = ""


class ClusterScheduler:
    """Resource bookkeeping + node selection for tasks, actors, and bundles."""

    def __init__(self, spread_threshold: float = 0.5):
        self.nodes: Dict[NodeID, NodeState] = {}
        self.placement_groups: Dict[PlacementGroupID, PlacementGroup] = {}
        self.spread_threshold = spread_threshold
        self._spread_rr = 0  # round-robin cursor for SPREAD strategy

    # -- node membership ------------------------------------------------------

    def add_node(
        self,
        node_id: NodeID,
        resources: ResourceDict,
        labels: Optional[Dict[str, str]] = None,
    ) -> NodeState:
        node = NodeState(
            node_id=node_id,
            total=dict(resources),
            available=dict(resources),
            labels=labels or {},
            gpu_free=list(range(int(resources.get("GPU", 0)))),
        )
        self.nodes[node_id] = node
        return node

    # -- GPU-ID pool ----------------------------------------------------------

    def allocate_gpus(self, node_id: NodeID, n: int) -> Optional[List[int]]:
        """Assign ``n`` concrete GPU IDs on a node whose float "GPU"
        resources were already acquired.  Returns None when the pool is
        short (a blocked or retiring holder's process still holds the
        cards) — the dispatcher then refuses to dispatch and the task
        waits for a real card (head._dispatch)."""
        node = self.nodes.get(node_id)
        if node is None or len(node.gpu_free) < n:
            return None
        gpus = node.gpu_free[:n]
        del node.gpu_free[:n]
        return gpus

    def free_gpus(self, node_id: NodeID, gpus: List[int]) -> None:
        node = self.nodes.get(node_id)
        if node is not None:
            node.gpu_free.extend(g for g in gpus if g not in node.gpu_free)
            node.gpu_free.sort()

    def lease_slot(self, node_id: NodeID, resources: ResourceDict) -> bool:
        """Reserve one direct-submission execution slot on a node (the
        lease-table analog of a task acquire).  Draining/dead nodes never
        grant: a lease outliving the node would hand the client a doomed
        endpoint."""
        node = self.nodes.get(node_id)
        if node is None or not node.schedulable:
            return False
        if not _fits(node.available, resources):
            return False
        _sub(node.available, resources)
        node.leased_slots += 1
        return True

    def release_slot(self, node_id: NodeID, resources: ResourceDict) -> None:
        node = self.nodes.get(node_id)
        if node is not None:
            _add(node.available, resources)
            node.leased_slots = max(0, node.leased_slots - 1)

    def mark_draining(self, node_id: NodeID) -> bool:
        """Announced preemption: stop NEW placements on the node while its
        grace window runs.  Running work (and its resources) is untouched —
        the node-death path reclaims everything when the daemon exits."""
        node = self.nodes.get(node_id)
        if node is None:
            return False
        node.draining = True
        return True

    def remove_node(self, node_id: NodeID) -> List[PlacementGroupID]:
        """Drop a node.  Returns ids of placement groups that lost bundles
        (the control plane retries `reschedule_lost_bundles` for them —
        reference: gcs_placement_group_scheduler.h reschedules bundles on
        node death)."""
        node = self.nodes.pop(node_id, None)
        if node is None:
            return []
        damaged: List[PlacementGroupID] = []
        for pg in self.placement_groups.values():
            for b in pg.bundles:
                if b.node_id == node_id:
                    b.node_id = None  # bundle lost; pg needs reschedule
                    if pg.pg_id not in damaged:
                        damaged.append(pg.pg_id)
        return damaged

    def reschedule_lost_bundles(self, pg_id: PlacementGroupID) -> bool:
        """Re-place bundles whose node died.  Returns True when the PG is
        whole again (all bundles placed); False to retry later.  Placement
        honors the PG strategy: STRICT_SPREAD avoids nodes holding sibling
        bundles, STRICT_PACK co-locates with survivors (or re-packs from
        scratch when every bundle was lost)."""
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return True  # removed meanwhile
        lost = [b for b in pg.bundles if b.node_id is None]
        if not lost:
            return True
        used = {b.node_id for b in pg.bundles if b.node_id is not None}
        placed: List[Tuple[Bundle, NodeID]] = []
        avail = {
            nid: dict(n.available)
            for nid, n in self.nodes.items() if n.schedulable
        }
        for b in lost:
            order = sorted(
                avail,
                key=lambda nid: (self.nodes[nid].utilization(), nid),
            )
            chosen = None
            for nid in order:
                if pg.strategy == PlacementStrategy.STRICT_SPREAD and nid in used:
                    continue
                if (pg.strategy == PlacementStrategy.STRICT_PACK and used
                        and nid not in used):
                    continue
                if _fits(avail[nid], b.resources):
                    chosen = nid
                    break
            if chosen is None:
                return False  # all-or-nothing: retry when resources free up
            _sub(avail[chosen], b.resources)
            used.add(chosen)
            placed.append((b, chosen))
        for b, nid in placed:
            b.node_id = nid
            b.available = dict(b.resources)
            _sub(self.nodes[nid].available, b.resources)
        return True

    # -- task/actor placement -------------------------------------------------

    def pick_node(
        self,
        resources: ResourceDict,
        strategy: SchedulingStrategy | None = None,
    ) -> Optional[NodeID]:
        """Choose a feasible node.  Returns None if nothing fits right now."""
        strategy = strategy or SchedulingStrategy.default()

        if strategy.kind == "placement_group":
            return self._pick_in_pg(resources, strategy)

        if strategy.kind == "node_affinity":
            node = self.nodes.get(strategy.node_id)
            if node and node.schedulable and _fits(node.available, resources):
                return node.node_id
            if strategy.soft:
                return self._pick_hybrid(resources)
            return None

        alive = [n for n in self.nodes.values() if n.schedulable]
        if strategy.kind == "spread":
            # Round-robin over feasible nodes
            # (reference: scheduling/policy/spread_scheduling_policy.h).
            feasible = [n for n in alive if _fits(n.available, resources)]
            if not feasible:
                return None
            feasible.sort(key=lambda n: n.node_id)
            node = feasible[self._spread_rr % len(feasible)]
            self._spread_rr += 1
            return node.node_id

        return self._pick_hybrid(resources)

    def _pick_hybrid(self, resources: ResourceDict) -> Optional[NodeID]:
        """Hybrid policy: prefer packing onto already-utilized nodes while
        below spread_threshold, then prefer the least-utilized node."""
        feasible = [
            n
            for n in self.nodes.values()
            if n.schedulable and _fits(n.available, resources)
        ]
        if not feasible:
            return None

        def score(n: NodeState) -> Tuple:
            u = n.utilization()
            over = u >= self.spread_threshold
            # Below threshold: pack (higher utilization first).  Above: spread
            # (lower utilization first).  Node id breaks ties deterministically.
            return (over, -u if not over else u, n.node_id)

        return min(feasible, key=score).node_id

    def _pick_in_pg(
        self, resources: ResourceDict, strategy: SchedulingStrategy
    ) -> Optional[NodeID]:
        pg = self.placement_groups.get(strategy.pg_id)
        if pg is None or not pg.created:
            return None
        indices = (
            [strategy.bundle_index]
            if strategy.bundle_index >= 0
            else range(len(pg.bundles))
        )
        for i in indices:
            b = pg.bundles[i]
            if b.node_id is None or not _fits(b.available, resources):
                continue
            node = self.nodes.get(b.node_id)
            if node is None or not node.schedulable:
                # Draining/dead host: starting NEW work there would be
                # killed at grace-window end.  The task pends; the bundle
                # re-places via reschedule_lost_bundles when the node dies.
                continue
            return b.node_id
        return None

    def acquire(
        self,
        node_id: NodeID,
        resources: ResourceDict,
        strategy: SchedulingStrategy | None = None,
    ) -> bool:
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return False
        if strategy and strategy.kind == "placement_group":
            pg = self.placement_groups.get(strategy.pg_id)
            if pg is None:
                return False
            indices = (
                [strategy.bundle_index]
                if strategy.bundle_index >= 0
                else range(len(pg.bundles))
            )
            for i in indices:
                b = pg.bundles[i]
                if b.node_id == node_id and _fits(b.available, resources):
                    _sub(b.available, resources)
                    return True
            return False
        if not _fits(node.available, resources):
            return False
        _sub(node.available, resources)
        return True

    def acquire_force(
        self,
        node_id: NodeID,
        resources: ResourceDict,
        strategy: SchedulingStrategy | None = None,
    ) -> None:
        """Acquire without a feasibility check (availability may go negative).

        Used when a worker resumes from a blocked get/wait: its resources were
        released while it was parked so other tasks could run (reference:
        raylet releases CPU for workers blocked in ray.get), and on resume it
        must get them back even if that oversubscribes the node transiently —
        the deficit self-corrects as running tasks finish."""
        if strategy and strategy.kind == "placement_group":
            pg = self.placement_groups.get(strategy.pg_id)
            if pg is not None:
                indices = (
                    [strategy.bundle_index]
                    if strategy.bundle_index >= 0
                    else range(len(pg.bundles))
                )
                for i in indices:
                    b = pg.bundles[i]
                    if b.node_id == node_id:
                        _sub(b.available, resources)
                        return
            return
        node = self.nodes.get(node_id)
        if node is not None:
            _sub(node.available, resources)

    def check_feasible_ever(
        self, bundles: Sequence[ResourceDict], strategy: str
    ) -> bool:
        """Would these bundles fit on an *empty* cluster of the current
        nodes?  Distinguishes 'queue until resources free up' from 'can
        never be satisfied' for placement-group admission."""
        saved = {nid: n.available for nid, n in self.nodes.items()}
        try:
            for n in self.nodes.values():
                n.available = dict(n.total)
            probe = PlacementGroup(
                pg_id=PlacementGroupID.nil(),
                bundles=[Bundle(resources=dict(b)) for b in bundles],
                strategy=PlacementStrategy(strategy),
            )
            return self._place_bundles(probe) is not None
        finally:
            for nid, n in self.nodes.items():
                n.available = saved[nid]

    def release(
        self,
        node_id: NodeID,
        resources: ResourceDict,
        strategy: SchedulingStrategy | None = None,
    ) -> None:
        if strategy and strategy.kind == "placement_group":
            pg = self.placement_groups.get(strategy.pg_id)
            if pg is not None:
                indices = (
                    [strategy.bundle_index]
                    if strategy.bundle_index >= 0
                    else range(len(pg.bundles))
                )
                for i in indices:
                    b = pg.bundles[i]
                    if b.node_id == node_id:
                        _add(b.available, resources)
                        return
            return
        node = self.nodes.get(node_id)
        if node is not None:
            _add(node.available, resources)

    # -- placement groups -----------------------------------------------------

    def create_placement_group(
        self,
        pg_id: PlacementGroupID,
        bundles: Sequence[ResourceDict],
        strategy: str = "PACK",
        name: str = "",
    ) -> bool:
        """Reserve bundle resources.  All-or-nothing: on failure nothing is
        held (the reference runs a 2PC across raylets for this —
        gcs_placement_group_scheduler.h:117; with a single control plane the
        transaction is local but semantics match)."""
        strat = PlacementStrategy(strategy)
        pg = PlacementGroup(
            pg_id=pg_id,
            bundles=[Bundle(resources=dict(b)) for b in bundles],
            strategy=strat,
            name=name,
        )
        placed = self._place_bundles(pg)
        if placed is None:
            return False
        for b, node_id in zip(pg.bundles, placed):
            b.node_id = node_id
            b.available = dict(b.resources)
            _sub(self.nodes[node_id].available, b.resources)
        pg.created = True
        self.placement_groups[pg_id] = pg
        return True

    def _place_bundles(self, pg: PlacementGroup) -> Optional[List[NodeID]]:
        avail = {
            nid: dict(n.available)
            for nid, n in self.nodes.items()
            if n.schedulable
        }
        placed: List[NodeID] = []
        strat = pg.strategy

        if strat in (PlacementStrategy.PACK, PlacementStrategy.STRICT_PACK):
            order = sorted(
                avail, key=lambda nid: -self.nodes[nid].utilization()
            )
            for b in pg.bundles:
                chosen = None
                candidates = [placed[0]] if (
                    strat == PlacementStrategy.STRICT_PACK and placed
                ) else order
                for nid in candidates:
                    if _fits(avail[nid], b.resources):
                        chosen = nid
                        break
                if chosen is None:
                    return None
                _sub(avail[chosen], b.resources)
                placed.append(chosen)
            return placed

        # SPREAD / STRICT_SPREAD
        order = sorted(avail, key=lambda nid: self.nodes[nid].utilization())
        used: set = set()
        for b in pg.bundles:
            chosen = None
            for nid in order:
                if strat == PlacementStrategy.STRICT_SPREAD and nid in used:
                    continue
                if _fits(avail[nid], b.resources):
                    chosen = nid
                    break
            if chosen is None and strat == PlacementStrategy.SPREAD:
                for nid in order:
                    if _fits(avail[nid], b.resources):
                        chosen = nid
                        break
            if chosen is None:
                return None
            _sub(avail[chosen], b.resources)
            used.add(chosen)
            placed.append(chosen)
        return placed

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        pg = self.placement_groups.pop(pg_id, None)
        if pg is None:
            return
        for b in pg.bundles:
            if b.node_id is not None and b.node_id in self.nodes:
                # Return what the bundle still holds plus what tasks gave back.
                _add(self.nodes[b.node_id].available, b.resources)

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "nodes": {
                n.node_id.hex(): {
                    "total": n.total,
                    "available": n.available,
                    "labels": n.labels,
                    "alive": n.alive,
                    "draining": n.draining,
                    "leased_slots": n.leased_slots,
                }
                for n in self.nodes.values()
            },
            "placement_groups": {
                pg.pg_id.hex(): {
                    "strategy": pg.strategy.value,
                    "created": pg.created,
                    "bundles": [
                        {
                            "resources": b.resources,
                            "node": b.node_id.hex() if b.node_id else None,
                        }
                        for b in pg.bundles
                    ],
                }
                for pg in self.placement_groups.values()
            },
        }
