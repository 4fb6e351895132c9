"""Autoscaler scenarios run under either package, one process each.

``python tests/_torch_autoscaler_scenarios.py --pkg ray_tpu_torch all``
imports the named package as ``rt``, runs the five scenarios of
``tests/test_autoscaler.py`` in turn (each starts and stops its own
cluster) and prints their results as one JSON line.  The slice provider
differs by name and shape only: the JAX package scales TPU slices through
its TPU-VM API stand-in (``TpuSliceNodeProvider``, ``MockGceTpuApi``,
resource ``"TPU"``), the port GPU slices through its Compute Engine
stand-in (``GpuSliceNodeProvider``, ``MockGceGpuApi``, resource ``"GPU"``);
each scenario picks the shape of the same (hosts, cards a host) in its
package's table, so the two results must be equal.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import _torch_serve_scenarios as serve_sc
from _torch_runtime_scenarios import result

#: (hosts, accelerators a host) -> each package's slice shape.
SHAPES = {
    (2, 4): {"ray_tpu": "v5p-16", "ray_tpu_torch": "a3-highgpu-4g-x2"},
    (1, 4): {"ray_tpu": "v5p-8", "ray_tpu_torch": "a3-highgpu-4g"},
}


def _port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def _slice_api(rt):
    """(api class, provider class, accelerator resource, shape keyword)."""
    gce = importlib.import_module(rt.__name__ + ".autoscaler.gce")
    if _port(rt):
        return (gce.MockGceGpuApi, gce.GpuSliceNodeProvider, "GPU",
                "machine_type")
    return gce.MockGceTpuApi, gce.TpuSliceNodeProvider, "TPU", \
        "accelerator_type"


def _shape_of(rt, shape):
    """(hosts, accelerators a host) of a shape in the package's table."""
    gce = importlib.import_module(rt.__name__ + ".autoscaler.gce")
    table = gce.SLICE_SHAPES if _port(rt) else gce.SLICE_TOPOLOGY
    return list(table[shape])


def _calls(rt, api):
    """The API's calls as [verb, node id, shape]: create/delete/list (the
    port also records ``get``, which the JAX stand-in does not)."""
    out = []
    for c in api.calls:
        verb = c["method"].rsplit(".", 1)[-1]
        verb = {"bulkInsert": "create"}.get(verb, verb)
        if verb == "get":
            continue
        shape = None
        if verb == "create":
            shape = ([c["count"], c["accelerator_count"]] if _port(rt)
                     else _shape_of(rt, c["accelerator_type"]))
        out.append([verb, c.get("node_id"), shape])
    return out


def _histories(manager):
    return sorted([h["status"] for h in s["history"]]
                  for s in manager.get_state())


def _wait(pred, timeout, step=0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def scale_up_then_down(rt):
    from importlib import import_module

    auto = import_module(rt.__name__ + ".autoscaler")
    rt.init(num_cpus=1)
    provider = auto.LocalNodeProvider(num_cpus=2)
    scaler = auto.Autoscaler(provider, min_nodes=0, max_nodes=2,
                             idle_timeout_s=3.0, poll_interval_s=0.5)
    scaler.start()
    out = {}
    try:
        @rt.remote
        def work(i):
            time.sleep(1.0)
            return i

        refs = [work.remote(i) for i in range(6)]
        out["scaled_up"] = _wait(
            lambda: len(provider.non_terminated_nodes()) >= 1, 60)
        out["results"] = sorted(rt.get(refs, timeout=120))
        out["scaled_down"] = _wait(
            lambda: len(provider.non_terminated_nodes()) == 0, 60, 0.5)
        out["nodes_left"] = len(provider.non_terminated_nodes())
        # One or two nodes, by timing: every one went the whole way.
        out["histories"] = sorted({
            ",".join(h) for h in _histories(scaler.instance_manager)})
    finally:
        scaler.stop()
        for h in provider.non_terminated_nodes():
            provider.terminate_node(h)
        rt.shutdown()
    return out


def slice_on_pg_demand(rt):
    from importlib import import_module

    auto = import_module(rt.__name__ + ".autoscaler")
    Api, Provider, acc, kw = _slice_api(rt)
    rt.init(num_cpus=1)
    api = Api()
    provider = Provider(api, **{kw: SHAPES[(2, 4)][rt.__name__]})
    scaler = auto.Autoscaler(provider, min_nodes=0, max_nodes=2,
                             idle_timeout_s=3.0, poll_interval_s=0.5)
    scaler.start()
    out = {"hosts_per_slice": provider.hosts_per_slice}
    pg = None
    try:
        pg = rt.placement_group([{"CPU": 1, acc: 4}] * 2,
                                strategy="STRICT_SPREAD")
        out["pg_ready"] = bool(pg.ready(timeout=90))
        _wait(lambda: bool(provider.non_terminated_nodes()), 10)
        slices = provider.non_terminated_nodes()
        out["slices"] = len(slices)
        out["hosts"] = [len(s.host_handles) for s in slices]
        node = api.get(node_id=slices[0].slice_id)
        out["ready"] = node.get("state", node.get("status")) in (
            "READY", "RUNNING")
        rt.remove_placement_group(pg)
        pg = None
        out["drained"] = _wait(lambda: not provider.non_terminated_nodes(),
                               60, 0.5)
        out["calls"] = _calls(rt, api)
        out["histories"] = _histories(scaler.instance_manager)
    finally:
        scaler.stop()
        if pg is not None:
            try:
                rt.remove_placement_group(pg)
            except Exception:  # noqa: BLE001
                pass
        for h in provider.non_terminated_nodes():
            provider.terminate_node(h)
        rt.shutdown()
    return out


def atomic_rollback(rt):
    Api, Provider, _, kw = _slice_api(rt)
    api = Api()
    provider = Provider(api, join_cluster=False,
                        **{kw: SHAPES[(2, 4)][rt.__name__]})

    class FailingCluster:
        def __init__(self):
            self.added = 0

        def add_node(self, **kw):
            self.added += 1
            if self.added == 2:
                raise RuntimeError("host 2 failed to boot")
            return type("H", (), {"hex": f"h{self.added}"})()

        def remove_node(self, h, graceful=True):
            pass

    provider._cluster = FailingCluster()
    try:
        provider.create_node()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return {"raised": raised, "nodes": len(provider.non_terminated_nodes()),
            "api_nodes": len(api.nodes), "calls": _calls(rt, api)}


def unscalable_demand(rt):
    """A placement group no provider node can ever hold never scales: the
    JAX test's {"CPU": 64} on 2-CPU hosts, and accelerators past a host's
    (8 on a 1-host, 4-a-host slice)."""
    from importlib import import_module

    auto = import_module(rt.__name__ + ".autoscaler")
    Api, Provider, acc, kw = _slice_api(rt)
    rt.init(num_cpus=1)
    out = {}
    try:
        api = Api()
        cases = {
            "cpu": (auto.LocalNodeProvider(num_cpus=2), [{"CPU": 64}]),
            "accel": (Provider(api, **{kw: SHAPES[(1, 4)][rt.__name__]}),
                      [{acc: 8}]),
        }
        for name, (provider, bundles) in cases.items():
            scaler = auto.Autoscaler(provider, min_nodes=0, max_nodes=2,
                                     idle_timeout_s=1.0,
                                     poll_interval_s=0.5)
            pg = rt.placement_group(bundles, strategy="PACK")
            try:
                for _ in range(5):
                    scaler.update()
                    time.sleep(0.2)
                out[name] = [len(provider.non_terminated_nodes()),
                             scaler.instance_manager.get_state()]
            finally:
                rt.remove_placement_group(pg)
        out["calls"] = _calls(rt, api)
    finally:
        rt.shutdown()
    return out


def instance_manager(rt):
    from importlib import import_module

    auto = import_module(rt.__name__ + ".autoscaler")
    im = import_module(rt.__name__ + ".autoscaler.instance_manager")
    rt.init(num_cpus=1)
    out = {}
    try:
        provider = auto.LocalNodeProvider(num_cpus=1)
        mgr = im.InstanceManager(provider)
        (iid,) = mgr.update(launch=1)
        out["running"] = sorted(mgr.running()) == [iid]
        state = {s["instance_id"]: s for s in mgr.get_state()}
        out["launched"] = [[h["status"] for h in state[iid]["history"]],
                           len(state[iid]["node_ids"])]
        v_before = mgr.storage.version
        mgr.update(terminate=[iid])
        instances, version = mgr.storage.get_instances()
        out["terminated"] = [instances[iid].status, version > v_before,
                             len(provider.non_terminated_nodes())]
        out["history"] = [h[0] for h in instances[iid].history]

        class Boom:
            def create_node(self):
                raise RuntimeError("quota")

            def node_ids_of(self, h):
                return []

        mgr2 = im.InstanceManager(Boom())
        launched = mgr2.update(launch=1)
        instances, _ = mgr2.storage.get_instances()
        out["failed"] = [launched, [i.status for i in instances.values()]]
        store = im.InstanceStorage()
        out["optimistic"] = [
            store.batch_update([im.Instance("a")], expected_version=0),
            store.batch_update([im.Instance("b")], expected_version=0),
            store.batch_update([im.Instance("b")],
                               expected_version=store.version)]
        try:
            mgr._transition(im.Instance("x"), "RAY_RUNNING")
            out["invalid"] = None
        except ValueError as e:
            out["invalid"] = str(e)
    finally:
        rt.shutdown()
    return out


SCENARIOS = {f.__name__: f for f in (
    scale_up_then_down, slice_on_pg_demand, atomic_rollback,
    unscalable_demand, instance_manager)}


def run_pair(timeout: float = 300.0):
    """Every scenario under both packages at once (two clusters on one
    host, one process a package; each scenario starts its own cluster, so
    both address variables are dropped): ``(ray_tpu results,
    ray_tpu_torch results)``."""
    jp = serve_sc.run("all", "ray_tpu", script=__file__)
    tp = serve_sc.run("all", "ray_tpu_torch", script=__file__)
    return result(jp, timeout), result(tp, timeout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", required=True, choices=("ray_tpu",
                                                     "ray_tpu_torch"))
    ap.add_argument("name", choices=sorted(SCENARIOS) + ["all"])
    args = ap.parse_args(argv)
    rt = importlib.import_module(args.pkg)
    names = sorted(SCENARIOS) if args.name == "all" else [args.name]
    out = {}
    for name in names:
        t0 = time.time()
        out[name] = SCENARIOS[name](rt)
        print(f"{name}: {time.time() - t0:.1f} s", file=sys.stderr)
    print("SCENARIO_RESULT " + json.dumps(out, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
