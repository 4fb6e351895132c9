"""The port's autoscaler (``ray_tpu_torch/autoscaler/``) against the JAX
package's: the five scenarios of ``tests/test_autoscaler.py`` run under
both packages at once, one subprocess each
(``tests/_torch_autoscaler_scenarios.py``), every test comparing one
piece of the two results: node counts, the cloud API's call sequence (the
slice's shape read through each package's table), the instance
histories, the rollback of a slice whose host failed to join, and demand
no node can hold never scaling.  Then the port alone: the GPU shape table,
what a slice's hosts grant, and the address the providers attach to."""

import pytest

import _torch_autoscaler_scenarios as sc

_results = {}


def _pair():
    if "pair" not in _results:
        try:
            _results["pair"] = sc.run_pair()
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["pair"] = e
    if isinstance(_results["pair"], Exception):
        raise _results["pair"]
    return _results["pair"]


@pytest.mark.parametrize("name", sorted(sc.SCENARIOS))
def test_scenario_matches_jax(name):
    ref, got = _pair()
    assert got[name] == ref[name]


def test_scale_up_then_down():
    _, got = _pair()
    out = got["scale_up_then_down"]
    assert out["scaled_up"] and out["scaled_down"]
    assert out["results"] == list(range(6))
    assert out["nodes_left"] == 0
    assert out["histories"] == [
        "QUEUED,REQUESTED,ALLOCATED,RAY_RUNNING,TERMINATING,TERMINATED"]


def test_slice_scales_whole_on_pg_demand():
    """One pending STRICT_SPREAD group of two 4-card bundles makes one
    create of a 2-host slice, and the idle slice one delete of that id."""
    _, got = _pair()
    out = got["slice_on_pg_demand"]
    assert out["pg_ready"] and out["ready"] and out["drained"]
    assert (out["slices"], out["hosts"], out["hosts_per_slice"]) == (
        1, [2], 2)
    assert out["calls"] == [["create", "rt-slice-1", [2, 4]],
                            ["delete", "rt-slice-1", None]]
    assert out["histories"] == [["QUEUED", "REQUESTED", "ALLOCATED",
                                 "RAY_RUNNING", "TERMINATING",
                                 "TERMINATED"]]


def test_rollback_leaves_no_node():
    _, got = _pair()
    assert got["atomic_rollback"] == {
        "raised": "host 2 failed to boot", "nodes": 0, "api_nodes": 0,
        "calls": [["create", "rt-slice-1", [2, 4]],
                  ["delete", "rt-slice-1", None]]}


def test_unscalable_demand_never_scales():
    _, got = _pair()
    out = got["unscalable_demand"]
    assert out["cpu"] == [0, []] and out["accel"] == [0, []]
    assert out["calls"] == []


def test_instance_manager_lifecycle():
    _, got = _pair()
    out = got["instance_manager"]
    assert out["running"]
    assert out["launched"] == [["QUEUED", "REQUESTED", "ALLOCATED",
                                "RAY_RUNNING"], 1]
    assert out["terminated"] == ["TERMINATED", True, 0]
    assert out["failed"] == [[], ["ALLOCATION_FAILED"]]
    assert out["optimistic"] == [True, False, True]
    assert "invalid instance transition" in out["invalid"]


# -- the port alone -----------------------------------------------------------


def test_gpu_shape_table():
    """A3 High machine types (1, 2, 4, 8 cards a host), and multi-host
    slices of them for the all-or-none rule."""
    from ray_tpu_torch.autoscaler import gce

    for n in (1, 2, 4, 8):
        assert gce.SLICE_SHAPES[f"a3-highgpu-{n}g"] == (1, n)
    multi = {k: v for k, v in gce.SLICE_SHAPES.items() if v[0] > 1}
    assert multi and all(k.split("-x")[0] in gce.SLICE_SHAPES
                         for k in multi)
    assert gce._base_type("a3-highgpu-8g-x2") == "a3-highgpu-8g"
    with pytest.raises(ValueError, match="unknown machine_type"):
        gce.GpuSliceNodeProvider(gce.MockGceGpuApi(), machine_type="v5p-16",
                                 join_cluster=False)


def test_slice_hosts_grant_cards():
    """Each host of a slice joins with ``{"GPU": cards}``, the slice's own
    resource and labels; the API records one bulkInsert of ``count`` VMs
    with ``min_count`` equal (all or none), and ``get`` reads RUNNING."""
    from ray_tpu_torch.autoscaler import gce

    api = gce.MockGceGpuApi()
    provider = gce.GpuSliceNodeProvider(
        api, machine_type="a3-highgpu-8g-x2", join_cluster=False)
    added = []

    class Recorder:
        def add_node(self, **kw):
            added.append(kw)
            return type("H", (), {"hex": f"h{len(added)}"})()

    provider._cluster = Recorder()
    handle = provider.create_node()
    assert provider.host_resources() == {"CPU": 2.0, "GPU": 8.0}
    assert provider.node_ids_of(handle) == ["h1", "h2"]
    assert [kw["resources"] for kw in added] == [
        {"GPU": 8.0, "gpu-slice-rt-slice-1": 1.0}] * 2
    assert added[0]["labels"] == {"gpu-slice": "rt-slice-1",
                                  "machine-type": "a3-highgpu-8g-x2"}
    (create,) = api.calls
    assert create["method"] == "compute.instances.bulkInsert"
    assert (create["machine_type"], create["count"], create["min_count"],
            create["accelerator_count"]) == ("a3-highgpu-8g", 2, 2, 8)
    node = api.get(node_id="rt-slice-1")
    assert node["status"] == "RUNNING"
    assert [i["guestAccelerators"][0]["acceleratorCount"]
            for i in node["instances"]] == [8, 8]


@pytest.mark.parametrize("which", ["local", "slice"])
def test_providers_attach_through_the_port_address(which, monkeypatch):
    """The providers attach to ``RT_TORCH_ADDRESS``; the JAX package's
    ``RT_ADDRESS`` is not read."""
    from ray_tpu_torch import autoscaler, cluster_utils
    from ray_tpu_torch.autoscaler import gce

    seen = []
    monkeypatch.setattr(cluster_utils.Cluster, "attach",
                        classmethod(lambda cls, addr: seen.append(addr)))
    monkeypatch.setenv("RT_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("RT_TORCH_ADDRESS", "127.0.0.1:2")
    if which == "local":
        autoscaler.LocalNodeProvider(num_cpus=1)
    else:
        gce.GpuSliceNodeProvider(gce.MockGceGpuApi())
    assert seen == ["127.0.0.1:2"]
    monkeypatch.delenv("RT_TORCH_ADDRESS")
    with pytest.raises(KeyError, match="RT_TORCH_ADDRESS"):
        autoscaler.LocalNodeProvider(num_cpus=1)
