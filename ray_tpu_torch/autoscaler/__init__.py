"""ray_tpu_torch.autoscaler: demand-driven node scaling.

Role-equivalent to the reference's autoscaler
(reference: python/ray/autoscaler/_private/autoscaler.py:172
StandardAutoscaler + monitor.py polling GCS load, NodeProvider plugins;
v2 reconciler autoscaler/v2/instance_manager).  GPU note: a provider node
may be a slice of several GPU hosts that come and go together
(``gce.GpuSliceNodeProvider``); min/max are then slice counts.

The monitor loop reads cluster demand (queued tasks, pending placement
groups) and utilization from the control plane, then asks a NodeProvider to
add or remove nodes.  LocalNodeProvider spawns real node daemons on this
machine (the fake_multi_node analog, genuinely useful for one-host
elasticity and tests).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class NodeProvider:
    """Pluggable node lifecycle (reference: autoscaler/node_provider.py)."""

    def create_node(self) -> object:
        raise NotImplementedError

    def terminate_node(self, handle: object) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[object]:
        raise NotImplementedError

    def node_id_of(self, handle: object) -> str:
        raise NotImplementedError

    def node_ids_of(self, handle: object) -> List[str]:
        """All cluster node ids backing one provider node.  Single-host
        providers return [node_id_of(handle)]; slice providers (one
        provider node = many hosts) override — the reconciler treats the
        provider node as busy if ANY backing node is."""
        return [self.node_id_of(handle)]

    def host_resources(self) -> Optional[Dict[str, float]]:
        """Resource shape of ONE host this provider can add, or None when
        unknown.  The reconciler uses it to ignore demand no amount of
        scaling can satisfy (reference: the autoscaler matches demand
        against available_node_types resource shapes —
        resource_demand_scheduler.py)."""
        return None

    def hosts_per_node(self) -> int:
        """Cluster hosts one provider node contributes (slices > 1)."""
        return 1


class LocalNodeProvider(NodeProvider):
    """Adds node-daemon processes on this machine."""

    def __init__(self, num_cpus: int = 2,
                 resources: Optional[Dict[str, float]] = None,
                 drain_grace_s: Optional[float] = None):
        import os

        from ..cluster_utils import Cluster
        from ..core.config import ADDRESS_ENV

        self.num_cpus = num_cpus
        self.resources = resources
        # Drain grace for nodes this provider creates.  The grace belongs
        # to the NODE (it answers any future SIGTERM, including a real
        # preemption of a backfilled gang host), so the default inherits
        # the daemon's standard window rather than baking in a short one;
        # tests that churn nodes can pass a small value for speed.
        self.drain_grace_s = drain_grace_s
        self._nodes: List[object] = []
        self._cluster = Cluster.attach(os.environ[ADDRESS_ENV])

    def create_node(self):
        handle = self._cluster.add_node(
            num_cpus=self.num_cpus, resources=self.resources,
            drain_grace_s=self.drain_grace_s,
        )
        self._nodes.append(handle)
        return handle

    def terminate_node(self, handle):
        try:
            # wait=False: the reconcile loop must not block on the node's
            # drain cycle (head round-trip + daemon linger); the cluster
            # reaps the daemon opportunistically once it exits.
            self._cluster.remove_node(handle, graceful=True, wait=False)
        except Exception:
            logger.exception("terminate_node failed; keeping handle")
            return
        if handle in self._nodes:
            self._nodes.remove(handle)

    def non_terminated_nodes(self):
        return list(self._nodes)

    def node_id_of(self, handle) -> str:
        return handle.hex

    def host_resources(self) -> Optional[Dict[str, float]]:
        return {"CPU": float(self.num_cpus), **(self.resources or {})}


class Autoscaler:
    """(reference: StandardAutoscaler.update — one reconcile step per tick)"""

    def __init__(
        self,
        provider: NodeProvider,
        *,
        min_nodes: int = 0,
        max_nodes: int = 4,
        idle_timeout_s: float = 10.0,
        poll_interval_s: float = 1.0,
        upscaling_speed: int = 1,
    ):
        from .instance_manager import InstanceManager

        self.provider = provider
        # All fleet mutations go through the instance manager so every
        # node has an auditable lifecycle record (the v2 shape; reference:
        # autoscaler/v2/instance_manager/instance_manager.py:29).
        self.instance_manager = InstanceManager(provider)
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.idle_timeout_s = idle_timeout_s
        self.poll_interval_s = poll_interval_s
        self.upscaling_speed = max(1, upscaling_speed)
        self._idle_since: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observation ---------------------------------------------------------

    def _snapshot(self) -> dict:
        """One state fetch per tick (head message processing is the
        control-plane bound; don't poll per node)."""
        from ray_tpu_torch.core.context import ctx

        return {
            kind: ctx.client.call("list_state", {"kind": kind})["items"]
            for kind in ("tasks", "placement_groups", "nodes", "workers")
        }

    def _demand(self, snap: dict) -> int:
        """Unmet demand: runnable pending tasks (dep-blocked ones can't use
        a new node) plus pending placement groups (reference:
        load_metrics.py resource demand vectors, simplified to counts).

        Demand that no provider node can EVER satisfy is excluded — a
        placement group asking for {"CPU": 64} on a 2-CPU-host provider
        would otherwise pin the cluster at max_nodes forever through the
        never-drain-while-demand guard."""
        pending = sum(
            1 for t in snap["tasks"]
            if t.get("state") == "PENDING" and not t.get("dep_blocked")
        )
        shape = self.provider.host_resources()
        max_hosts = self.max_nodes * max(1, self.provider.hosts_per_node())

        def scalable(pg: dict) -> bool:
            if shape is None:
                return True  # provider shape unknown: assume serviceable
            bundles = [b.get("resources") or {}
                       for b in pg.get("bundles", [])]
            strategy = pg.get("strategy", "PACK")
            if strategy == "STRICT_PACK":
                # All bundles must co-locate on ONE host: their SUM must
                # fit the host shape.
                need: Dict[str, float] = {}
                for b in bundles:
                    for k, v in b.items():
                        need[k] = need.get(k, 0.0) + v
                return all(v <= shape.get(k, 0.0) for k, v in need.items())
            if strategy == "STRICT_SPREAD" and len(bundles) > max_hosts:
                return False  # more distinct nodes than scaling can add
            return all(
                res <= shape.get(k, 0.0)
                for b in bundles
                for k, res in b.items()
            )

        pending_pgs = sum(
            1 for p in snap["placement_groups"]
            if not p.get("created") and scalable(p)
        )
        return pending + pending_pgs

    @staticmethod
    def _node_busy(snap: dict, node_hex: str) -> bool:
        for n in snap["nodes"]:
            if n["node_id"] == node_hex:
                if n.get("draining"):
                    # Already being preempted/terminated: never double-
                    # terminate, and never count it as idle capacity.
                    return True
                total = n.get("resources", {})
                avail = n.get("available", {})
                if any(avail.get(k, 0) < v for k, v in total.items()):
                    return True
        return any(
            w["node_id"] == node_hex and w["state"] in ("leased", "actor")
            for w in snap["workers"]
        )

    # -- reconcile -----------------------------------------------------------

    def update(self):
        """One reconcile step: scale up on unmet demand, scale down idle
        nodes past the timeout.  Decisions are counted into
        ``ray_tpu_autoscaler_decisions_total`` (tagged up/down) and current
        demand into a gauge, so scaling behavior is auditable from the
        metrics history."""
        from ray_tpu_torch.util.metrics import get_counter, get_gauge

        nodes = self.provider.non_terminated_nodes()
        snap = self._snapshot()
        demand = self._demand(snap)
        get_gauge("ray_tpu_autoscaler_demand",
                  "Unmet demand (runnable pending tasks + pending PGs)"
                  ).set(demand)
        decisions = get_counter("ray_tpu_autoscaler_decisions_total",
                                "Autoscaler scale decisions",
                                tag_keys=("action",))
        if demand > 0:
            # Never drain while demand exists — at max_nodes that would
            # churn create/terminate forever.
            if len(nodes) < self.max_nodes:
                launch = min(self.upscaling_speed,
                             self.max_nodes - len(nodes))
                self.instance_manager.update(launch=launch)
                decisions.inc(launch, tags={"action": "scale_up"})
            return
        now = time.monotonic()
        for handle in nodes:
            if len(self.provider.non_terminated_nodes()) <= self.min_nodes:
                break
            key = self.provider.node_id_of(handle)
            # A multi-host provider node (GPU slice) is busy while ANY of
            # its backing nodes is — slices scale atomically.
            if any(self._node_busy(snap, h)
                   for h in self.provider.node_ids_of(handle)):
                self._idle_since.pop(key, None)
                continue
            first_idle = self._idle_since.setdefault(key, now)
            if now - first_idle >= self.idle_timeout_s:
                from .instance_manager import ALLOCATED, RUNNING, TERMINATING

                inst = self.instance_manager.instance_of_handle(handle)
                if inst is not None and inst.status in (
                        ALLOCATED, RUNNING, TERMINATING):
                    self.instance_manager.update(
                        terminate=[inst.instance_id])
                else:
                    # Outside the manager (pre-existing provider state) or
                    # a terminal record whose node the provider still
                    # lists: terminate directly so nothing zombies.
                    self.provider.terminate_node(handle)
                decisions.inc(1, tags={"action": "scale_down"})
                self._idle_since.pop(key, None)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Run the monitor loop on a background thread (reference:
        monitor.py:126 Monitor)."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.update()
                except Exception:
                    logger.exception("autoscaler update failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
