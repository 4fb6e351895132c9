"""GPU-slice node provider: slice-granular scaling through a GCE-shaped API.

Role-equivalent to the reference's GCP provider (reference:
python/ray/autoscaler/_private/gcp/node_provider.py:63 GCPNodeProvider —
create/terminate/list through the cloud API with a state cache).  The
unit of scale is a *slice*: one or more GPU hosts of one machine type
that come up together or not at all, the shape a multi-host training
gang needs (a gang cannot start on half its hosts).  One Autoscaler
"node" = one slice.

``MockGceGpuApi`` implements the Compute Engine instances surface shape
(``compute.instances.bulkInsert`` with ``count == minCount``, the
all-or-none form, then get/delete/list) entirely in memory and records
every call with its payload — the dry-run/test double, playing the role
of the reference's fake_multi_node provider
(fake_multi_node/node_provider.py:237) while keeping the call shapes a
real GCE binding needs.  When backed by a live cluster, each slice's
hosts join as REAL node daemons granting ``{"GPU": cards}``, so tasks and
placement groups asking for cards resolve on them.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List

from . import NodeProvider

logger = logging.getLogger(__name__)

# machine_type -> (hosts per slice, cards per host).  The single-host rows
# are Compute Engine's A3 High machine types (H100 80GB: a3-highgpu-1g,
# -2g, -4g, -8g with 1, 2, 4, 8 cards).  The "-xN" rows are N VMs of that
# type created in one all-or-none bulkInsert (a compact placement group).
SLICE_SHAPES: Dict[str, tuple] = {
    "a3-highgpu-1g": (1, 1),
    "a3-highgpu-2g": (1, 2),
    "a3-highgpu-4g": (1, 4),
    "a3-highgpu-8g": (1, 8),
    "a3-highgpu-4g-x2": (2, 4),
    "a3-highgpu-8g-x2": (2, 8),
    "a3-highgpu-8g-x4": (4, 8),
}


def _base_type(machine_type: str) -> str:
    """The VM machine type of a slice shape ("a3-highgpu-8g-x2" ->
    "a3-highgpu-8g")."""
    base, sep, n = machine_type.rpartition("-x")
    return base if sep and n.isdigit() else machine_type


class MockGceGpuApi:
    """In-memory stand-in for the Compute Engine instances API
    (compute.googleapis.com v1 projects.zones.instances).  Records every
    call with its payload so tests (and dry-runs) can assert exactly what
    a real deployment would send.  A slice is the set of instances one
    ``bulkInsert`` made, addressed by its name prefix (``node_id``)."""

    def __init__(self, *, create_latency_s: float = 0.0):
        self.calls: List[Dict[str, Any]] = []
        self.nodes: Dict[str, Dict[str, Any]] = {}
        self.create_latency_s = create_latency_s
        self._lock = threading.Lock()

    # -- API surface (call shapes mirror the REST resource) ------------------

    def create(self, *, parent: str, node_id: str, machine_type: str,
               image: str) -> dict:
        hosts, cards = SLICE_SHAPES[machine_type]
        with self._lock:
            self.calls.append({
                "method": "compute.instances.bulkInsert",
                "parent": parent, "node_id": node_id,
                "machine_type": _base_type(machine_type),
                "count": hosts, "min_count": hosts,
                "accelerator_count": cards, "image": image,
            })
            if node_id in self.nodes:
                raise ValueError(f"node {node_id} already exists")
            node = {
                "name": f"{parent}/instances/{node_id}",
                "machineType": _base_type(machine_type),
                "status": "PROVISIONING",
                "ready_at": time.monotonic() + self.create_latency_s,
                "instances": [
                    {"name": f"{node_id}-{i}",
                     "networkIP": f"10.0.{len(self.nodes)}.{i}",
                     "guestAccelerators": [{
                         "acceleratorType": "nvidia-h100-80gb",
                         "acceleratorCount": cards}]}
                    for i in range(hosts)
                ],
            }
            self.nodes[node_id] = node
            return node

    def get(self, *, node_id: str) -> dict:
        with self._lock:
            self.calls.append({"method": "compute.instances.get",
                               "node_id": node_id})
            node = dict(self.nodes[node_id])
        if (node["status"] == "PROVISIONING"
                and time.monotonic() >= node["ready_at"]):
            with self._lock:
                self.nodes[node_id]["status"] = node["status"] = "RUNNING"
        return node

    def delete(self, *, node_id: str) -> None:
        with self._lock:
            self.calls.append({
                "method": "compute.instances.delete",
                "node_id": node_id,
            })
            self.nodes.pop(node_id, None)

    def list(self, *, parent: str) -> List[dict]:
        with self._lock:
            self.calls.append({
                "method": "compute.instances.list",
                "parent": parent,
            })
            return [dict(n) for n in self.nodes.values()]


class _SliceHandle:
    """One provisioned slice: the API-side node plus its joined hosts."""

    __slots__ = ("slice_id", "machine_type", "host_handles")

    def __init__(self, slice_id: str, machine_type: str,
                 host_handles: List[Any]):
        self.slice_id = slice_id
        self.machine_type = machine_type
        self.host_handles = host_handles


class GpuSliceNodeProvider(NodeProvider):
    """Scale in whole GPU slices (reference: gcp/node_provider.py:63).
    create_node() provisions ONE slice through the (mock or real) GCE API
    and joins hosts_per_slice node daemons to the cluster, each granting
    ``{"GPU": cards_per_host}``; terminate_node() drains every host, then
    deletes the slice."""

    def __init__(self, api: MockGceGpuApi, *,
                 machine_type: str = "a3-highgpu-8g",
                 parent: str = "projects/test/zones/us-central1-a",
                 image: str = "projects/test/global/images/rt-gpu-base",
                 num_cpus_per_host: int = 2,
                 join_cluster: bool = True):
        if machine_type not in SLICE_SHAPES:
            raise ValueError(
                f"unknown machine_type {machine_type!r}; "
                f"known: {sorted(SLICE_SHAPES)}")
        self.api = api
        self.machine_type = machine_type
        self.parent = parent
        self.image = image
        self.num_cpus_per_host = num_cpus_per_host
        self.hosts_per_slice, self.cards_per_host = (
            SLICE_SHAPES[machine_type])
        self.join_cluster = join_cluster
        self._slices: List[_SliceHandle] = []
        self._seq = 0
        self._cluster = None
        if join_cluster:
            import os

            from ..cluster_utils import Cluster
            from ..core.config import ADDRESS_ENV

            self._cluster = Cluster.attach(os.environ[ADDRESS_ENV])

    # -- NodeProvider ---------------------------------------------------------

    def create_node(self) -> _SliceHandle:
        self._seq += 1
        slice_id = f"rt-slice-{self._seq}"
        self.api.create(
            parent=self.parent, node_id=slice_id,
            machine_type=self.machine_type, image=self.image,
        )
        hosts: List[Any] = []
        if self._cluster is not None:
            # All hosts join or none: a partially-up slice cannot run a
            # multi-host gang, so a failed host join rolls the slice back.
            try:
                for _ in range(self.hosts_per_slice):
                    hosts.append(self._cluster.add_node(
                        num_cpus=self.num_cpus_per_host,
                        resources={
                            "GPU": float(self.cards_per_host),
                            f"gpu-slice-{slice_id}": 1.0,
                        },
                        labels={"gpu-slice": slice_id,
                                "machine-type": self.machine_type},
                    ))
            except Exception:
                for h in hosts:
                    try:
                        self._cluster.remove_node(h, graceful=False)
                    except Exception:
                        pass
                self.api.delete(node_id=slice_id)
                raise
        handle = _SliceHandle(slice_id, self.machine_type, hosts)
        self._slices.append(handle)
        return handle

    def terminate_node(self, handle: _SliceHandle) -> None:
        for h in handle.host_handles:
            try:
                # wait=False: blocking on each host's drain cycle would
                # stall the reconcile thread for hosts_per_slice × the
                # daemon linger; the SIGTERM announces the drain and the
                # cluster reaps the daemons as they exit.
                self._cluster.remove_node(h, graceful=True, wait=False)
            except Exception:
                logger.exception("slice host drain failed")
        self.api.delete(node_id=handle.slice_id)
        if handle in self._slices:
            self._slices.remove(handle)

    def non_terminated_nodes(self) -> List[_SliceHandle]:
        return list(self._slices)

    def node_id_of(self, handle: _SliceHandle) -> str:
        return handle.slice_id

    def host_resources(self) -> Dict[str, float]:
        return {"CPU": float(self.num_cpus_per_host),
                "GPU": float(self.cards_per_host)}

    def hosts_per_node(self) -> int:
        return self.hosts_per_slice

    def node_ids_of(self, handle: _SliceHandle) -> List[str]:
        """Every cluster node hex backing this slice — a slice is busy if
        ANY of its hosts is (the reconciler must not tear down a slice
        whose last host just went idle while another still works)."""
        if not handle.host_handles:
            return [handle.slice_id]
        return [h.hex for h in handle.host_handles]
