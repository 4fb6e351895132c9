"""The port's ``data`` against the JAX package's.

The pure parts run here under both packages on the same inputs: blocks,
the logical plan and its rules, the row-carry batcher, and
``device_prefetch`` (the port's with ``device="cpu"``, JAX's on its CPU
device: the same values, pulled and handed over in the same order, one
batch ahead).  Then ``_torch_data_scenarios.dataset`` runs every case of
``tests/test_data.py`` that is not marked slow there under each package
(one process a package, both at once), and each case's result must be
equal.  Every comparison is exact: the same numpy code runs on the same
seeded inputs."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import _torch_data_scenarios as sc
import ray_tpu.data as jd
import ray_tpu_torch.data as td
from ray_tpu.data import iterator as jiter
from ray_tpu.data.block import Block as JBlock
from ray_tpu.data.logical import LogicalOp as JOp
from ray_tpu.data.logical import LogicalPlan as JPlan
from ray_tpu_torch.data import iterator as titer
from ray_tpu_torch.data.block import Block as TBlock
from ray_tpu_torch.data.logical import LogicalOp as TOp
from ray_tpu_torch.data.logical import LogicalPlan as TPlan

_results = {}


def _pair():
    """Both packages' ``dataset`` results, computed once; a failure is
    kept too, so every test reports the one run's error."""
    if "pair" not in _results:
        try:
            ref, got = sc.run_pair(["dataset"])
            _results["pair"] = (ref["dataset"], got["dataset"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["pair"] = e
    if isinstance(_results["pair"], Exception):
        raise _results["pair"]
    return _results["pair"]


# ------------------------------------------------------------ pure parts


def _np(batch):
    return {k: np.asarray(v).tolist() for k, v in batch.items()}


def _block_ops(Block):
    """The block operations of ``tests/test_data.py``'s ``TestBlock``."""
    out = {}
    b = Block.from_items([1, 2, 3])
    out["scalars"] = [b.num_rows, _np(b.to_numpy()), b.schema()]
    b = Block.from_items([{"x": 1, "y": "a"}, {"x": 2, "y": "b"}])
    out["dicts"] = [b.num_rows, _np(b.to_numpy()), b.columns()]
    t = pa.table({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]})
    b = Block.from_arrow(t)
    out["arrow"] = [b.is_arrow, b.num_rows, _np(b.to_numpy()),
                    Block.from_batch(b.to_numpy()).to_arrow().equals(t),
                    b.schema(), b.size_bytes]
    b = Block.from_batch({"x": np.arange(10)})
    s = b.slice(2, 5)
    out["slice_concat_take"] = [
        _np(s.to_numpy()), _np(Block.concat([s, b.slice(0, 2)]).to_numpy()),
        _np(b.take_rows(np.array([9, 0])).to_numpy()),
        [{k: int(v) for k, v in r.items()} for r in b.slice(0, 2).rows()],
        Block.concat([]).num_rows]
    b = Block.from_batch({"img": np.ones((4, 8, 8))})
    try:
        b.to_arrow()
        err = "no error"
    except ValueError as e:
        err = str(e)
    out["tensor"] = [b.num_rows, list(b.slice(1, 3).to_numpy()["img"].shape),
                     b.schema(), err, b.size_bytes]
    try:
        Block.from_batch({"a": np.arange(3), "b": np.arange(2)})
        out["ragged"] = "no error"
    except ValueError as e:
        out["ragged"] = str(e)
    out["pandas"] = Block.from_batch({"a": np.arange(3)}).to_pandas()[
        "a"].tolist()
    return out


@pytest.mark.parametrize("case", ["scalars", "dicts", "arrow",
                                  "slice_concat_take", "tensor", "ragged",
                                  "pandas"])
def test_block_matches_jax(case):
    assert _block_ops(TBlock)[case] == _block_ops(JBlock)[case]


def _plan(Plan, Op):
    """A read with pushdown, then maps that fuse, an exchange and more
    maps: the optimized plan, the rules that fired and both plans'
    descriptions."""
    plan = Plan([Op("read", "ReadParquet", {"files": 3, "columns": None,
                                            "supports_columns": True,
                                            "supports_limit": True})])
    for op in (Op("project", "Project", {"columns": ["a"]}),
               Op("map_batches", "MapBatches(f)"),
               Op("filter", "Filter(g)"), Op("map", "Map(h)"),
               Op("repartition", "Repartition", {"n": 4}),
               Op("flat_map", "FlatMap(k)"), Op("add_column", "AddColumn"),
               Op("limit", "Limit", {"n": 3})):
        plan = plan.appended(op)
    opt, fired = plan.optimize()
    limited, lfired = Plan([Op("read", "ReadCsv", {
        "supports_limit": True}), Op("limit", "Limit", {"n": 7})]).optimize()
    return [plan.describe(), opt.describe(), fired,
            [o.payload for o in opt.ops], limited.describe(), lfired,
            Plan().describe()]


def test_logical_plan_matches_jax():
    assert _plan(TPlan, TOp) == _plan(JPlan, JOp)


def _blocks(Block, tensor=True):
    """Five blocks of 26 rows in all, one empty; ``tensor=False`` drops
    the 2-D column (Arrow and pandas batches hold 1-D columns only)."""
    r = np.random.default_rng(3)
    out = []
    for n in (5, 0, 7, 3, 11):
        cols = {"x": r.integers(0, 100, n), "y": r.normal(size=(n, 2))}
        if not tensor:
            cols["y"] = cols["y"][:, 0]
        out.append(Block.from_batch(cols))
    return out


@pytest.mark.parametrize("batch_size,drop_last", [(4, False), (4, True),
                                                  (26, False), (1, False)])
def test_batches_from_blocks_matches_jax(batch_size, drop_last):
    want = [_np(b) for b in jiter.batches_from_blocks(
        iter(_blocks(JBlock)), batch_size, "numpy", drop_last)]
    got = [_np(b) for b in titer.batches_from_blocks(
        iter(_blocks(TBlock)), batch_size, "numpy", drop_last)]
    assert got == want
    assert sum(len(b["x"]) for b in got) == (
        26 - 26 % batch_size if drop_last else 26)


def test_batch_formats_match_jax():
    for fmt in ("pandas", "pyarrow"):
        want = list(jiter.batches_from_blocks(
            iter(_blocks(JBlock, False)), 8, fmt))
        got = list(titer.batches_from_blocks(
            iter(_blocks(TBlock, False)), 8, fmt))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert type(g) is type(w)
            assert g.equals(w)
    with pytest.raises(ValueError, match="unknown batch_format"):
        list(titer.batches_from_blocks(iter(_blocks(TBlock)), 8, "arrow"))


def _prefetch_log(mod, device):
    """Pull three batches through ``device_prefetch``, logging each pull
    from the source and each hand-over to the consumer."""
    log = []
    r = np.random.default_rng(5)
    batches = [{"i": np.arange(4, dtype=np.int64) + 4 * k,
                "f": r.normal(size=(4, 3)).astype(np.float32),
                "o": np.array(["a", None, 1, 2.5], dtype=object)}
               for k in range(3)]

    def source():
        for k, b in enumerate(batches):
            log.append(("pull", k))
            yield b

    got = []
    for k, b in enumerate(mod.device_prefetch(source(), device)):
        log.append(("got", k))
        got.append(b)
    return log, got, batches


def test_device_prefetch_cpu_matches_jax():
    """Values equal, and the same order and lookahead: batch N+1 is
    pulled (and its copy issued) before batch N is handed over."""
    import jax

    jlog, jgot, jsrc = _prefetch_log(jiter, jax.devices("cpu")[0])
    tlog, tgot, src = _prefetch_log(titer, "cpu")
    assert tlog == jlog == [("pull", 0), ("pull", 1), ("got", 0),
                            ("pull", 2), ("got", 1), ("got", 2)]
    for t, j, s in zip(tgot, jgot, src):
        for k in ("i", "f"):
            assert isinstance(t[k], torch.Tensor)
            assert t[k].device.type == "cpu"
            assert t[k].dtype == torch.from_numpy(s[k]).dtype
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        # Object columns stay numpy in both.
        assert t["o"] is s["o"]
    assert all(j["o"] is s["o"] for j, s in zip(jgot, jsrc))
    st = td.DataContext.get_current().last_prefetch_stats
    assert st["device"] == "cpu" and st["batches"] == 3
    assert st["bytes"] == 3 * (4 * 8 + 4 * 3 * 4)
    assert st["pinned"] is False and st["copy_stream"] is None
    assert len(st["wait_s"]) == 3


def test_device_prefetch_keeps_str_columns_on_the_host():
    """A deviation: the port keeps every column torch cannot hold (str,
    bytes, object) as numpy; JAX keeps only object columns on the host
    (``jax.device_put`` of a str column raises)."""
    batch = {"s": np.array(["a", "bc"]), "b": np.array([b"x", b"y"]),
             "t": np.array(["2020-01-01", "2021-01-01"],
                           dtype="datetime64[D]"),
             "u": np.array([True, False]), "h": np.array([1, 2], np.float16)}
    (got,) = list(titer.device_prefetch(iter([batch]), "cpu"))
    for k in ("s", "b", "t"):
        assert got[k] is batch[k]
    assert got["u"].dtype == torch.bool and got["h"].dtype == torch.float16
    import jax

    with pytest.raises(TypeError):
        list(jiter.device_prefetch(iter([{"s": batch["s"]}]),
                                   jax.devices("cpu")[0]))


def test_device_prefetch_copies_read_only_columns():
    """Blocks read from the object store are read-only; the CPU tensors
    handed over are writable copies, so a consumer's in-place update
    cannot reach the stored block."""
    v = np.arange(4)
    v.flags.writeable = False
    (got,) = list(titer.device_prefetch(iter([{"v": v}]), "cpu"))
    got["v"] += 1
    assert v.tolist() == [0, 1, 2, 3]


def test_package_reexports_match_jax():
    assert sorted(td.__all__) == sorted(jd.__all__)
    assert td.DataContext().default_batch_size == \
        jd.DataContext().default_batch_size
    assert td.DataContext().execution_window == \
        jd.DataContext().execution_window


# -------------------------------------------------------------- scenarios

#: Cases of ``_torch_data_scenarios.dataset``; each must be equal under
#: both packages.
CASES = ["range", "map_batches", "map_filter", "flat_map", "aggregates",
         "repartition", "random_shuffle", "sort", "limit_union", "schema",
         "batch_sizes", "device_batches", "torch_batches", "materialize",
         "parquet", "read_csv_json", "write_csv_json", "write_json_tensor",
         "split", "streaming_split", "split_epochs", "groupby", "zip",
         "random_sample", "sample_blocks_vary", "unseeded_samples_differ",
         "seeded_samples_repeat", "train_test_split", "std", "to_pandas",
         "map_groups", "actor_pool", "actor_pool_class", "backpressure",
         "fusion", "column_pushdown", "limit_pushdown", "join",
         "join_digest", "join_big_key", "join_empty_right",
         "stats_no_rerun"]


@pytest.mark.parametrize("case", CASES)
def test_dataset_matches_jax(case):
    ref, got = _pair()
    assert got[case] == ref[case]


def test_dataset_values():
    """The values ``tests/test_data.py`` asserts of the JAX package, read
    from the port's run."""
    _, got = _pair()
    assert got["range"] == [5, 100, [0, 1, 2]]
    assert got["map_batches"] == list(range(0, 200, 2))
    assert got["map_filter"] == list(range(2, 21, 2))
    assert got["flat_map"] == [1, 2, 10, 20]
    assert got["aggregates"] == [5050, 0, 100, 50.0]
    assert got["repartition"] == [3, 103, True]
    assert sorted(got["random_shuffle"]) == list(range(200))
    assert got["random_shuffle"] != list(range(200))
    assert got["sort"] == [1, 2, 3] and got["limit_union"] == [10, 10]
    assert got["batch_sizes"] == [[32, 32, 32, 4], [32, 32, 32], True]
    assert got["device_batches"] == [2, [list(range(32)),
                                         list(range(32, 64))]]
    assert got["torch_batches"] == ["Tensor", 45]
    assert got["parquet"] == [4, 40, list(range(40))]
    assert got["split"][2] == list(range(100))
    s = got["streaming_split"]
    assert sum(s[0]) == 120 and s[1] is False and s[2] is True
    assert got["split_epochs"] == [list(range(40))] * 2
    assert got["groupby"]["count"] == [[0, 4], [1, 4], [2, 4]]
    assert got["zip"][1] == ["id", "id_1"] and got["zip"][2] is True
    assert got["train_test_split"][:2] == [75, 25]
    assert abs(got["std"] - np.std(np.arange(50.0), ddof=1)) < 1e-9
    assert got["actor_pool"][0] == 64 and got["actor_pool"][2:] == [True,
                                                                    True]
    assert got["actor_pool_class"] == "TypeError"
    assert got["backpressure"] == [24, 24, True, True]
    assert got["fusion"][2:8] == [3, 1, 24, 3, 24, True]
    assert got["limit_pushdown"] == [7, list(range(7)), 7]
    assert got["join_empty_right"] == [8, True, 0]
    assert got["stats_no_rerun"] == [3, ["last_materialize"] * 2, 24, 3,
                                     True, "profiled_pass"]


def test_device_batches_are_each_packages_own():
    """A device batch is a JAX array in the JAX package and a CPU tensor
    in the port's (``device="cpu"``)."""
    ref, got = _pair()
    assert ref["device_batch_type"] == "jaxlib"
    assert got["device_batch_type"] == "torch"
