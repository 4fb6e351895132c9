"""Data and tune scenarios run under either package, one process each.

``python tests/_torch_data_scenarios.py --pkg ray_tpu_torch dataset``
imports the named package as ``rt``, runs the named scenarios in order
(each starts and stops its own cluster) and prints one JSON line,
``{scenario: result}``.  The tests (``tests/test_torch_data.py``,
``test_torch_tune.py``, ``test_torch_data_train.py``) run a file's
scenarios in one process per package, both at once, and compare the two
results, so every value a scenario returns is one the packages must agree
on: no pid, no clock, no path, no package name (a value the test reads
under each package's own meaning is named so, as the type of a device
batch).  The scenarios are the cases of ``tests/test_data.py``,
``tests/test_tune.py`` and ``tests/test_data_train.py`` that are not
marked slow there.  The port's gangs run with ``use_gpu=False`` and its
device batches with ``device="cpu"``: this host has no card.
"""

from __future__ import annotations

import argparse
import builtins
import importlib
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from _torch_runtime_scenarios import result

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def _sub(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _py(x):
    """``x`` as JSON-ready Python: numpy scalars and arrays (and CPU
    tensors) become numbers and lists, NaN becomes the string "nan"."""
    if isinstance(x, dict):
        return {str(k): _py(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_py(v) for v in x]
    if hasattr(x, "tolist") and not isinstance(x, (str, bytes)):
        return _py(np.asarray(x).tolist())
    if isinstance(x, float) and x != x:
        return "nan"
    if isinstance(x, np.generic):
        return _py(x.item())
    return x


def _here() -> str:
    """The package of the cluster this process belongs to: a trial or
    gang worker of the port has loaded ``ray_tpu_torch``, a JAX one never
    does."""
    return "ray_tpu_torch" if "ray_tpu_torch" in sys.modules else "ray_tpu"


def _ids(rows, key="id"):
    return sorted(int(r[key]) for r in rows)


# ----------------------------------------------------------------- dataset


@scenario
def dataset(rt):
    """Every case of ``tests/test_data.py`` that is not marked slow, in one
    cluster: transforms, aggregates, exchanges, splits, the actor pool,
    files, the plan's rules and stats."""
    rt.init(num_cpus=4)
    d = _sub(rt, "data")
    tmp = tempfile.mkdtemp(prefix="rt_data_scenario_")
    out = {}

    ds = d.range(100, override_num_blocks=5)
    out["range"] = [ds.num_blocks(), ds.count(),
                    [int(r["id"]) for r in ds.take(3)]]
    out["map_batches"] = sorted(
        int(r["x"]) for r in d.range(100).map_batches(
            lambda b: {"x": b["id"] * 2}).take_all())
    ds = d.from_items(list(builtins.range(20)))
    ds = ds.map(lambda r: {"v": int(r["item"]) + 1})
    ds = ds.filter(lambda r: r["v"] % 2 == 0)
    out["map_filter"] = sorted(int(r["v"]) for r in ds.take_all())
    out["flat_map"] = sorted(int(r["v"]) for r in d.from_items([1, 2]).flat_map(
        lambda r: [{"v": r["item"]}, {"v": r["item"] * 10}]).take_all())
    ds = d.range(101)
    out["aggregates"] = _py([ds.sum("id"), ds.min("id"), ds.max("id"),
                             ds.mean("id")])
    ds = d.range(103, override_num_blocks=7).repartition(3)
    out["repartition"] = [ds.num_blocks(), ds.count(),
                          _ids(ds.take_all()) == list(builtins.range(103))]
    out["random_shuffle"] = [int(r["id"]) for r in d.range(
        200, override_num_blocks=4).random_shuffle(seed=7).take_all()]
    out["sort"] = [int(r["item"]) for r in
                   d.from_items([3, 1, 2]).sort("item").take_all()]
    out["limit_union"] = [d.range(50).limit(10).count(),
                          d.range(5).union(d.range(5)).count()]
    out["schema"] = _py(d.range(10).map_batches(
        lambda b: {"id": b["id"], "f": b["id"].astype(np.float32)}).schema())
    ds = d.range(100, override_num_blocks=7)
    out["batch_sizes"] = [
        [len(b["id"]) for b in ds.iter_batches(batch_size=32)],
        [len(b["id"]) for b in ds.iter_batches(batch_size=32,
                                               drop_last=True)],
        np.concatenate([b["id"] for b in ds.iter_batches(batch_size=32)])
        .tolist() == list(builtins.range(100))]
    # The device batches: a jax.Array on JAX's CPU device, a CPU tensor
    # on the port (device="cpu").
    dev = "cpu" if _port(rt) else True
    batches = list(d.range(64, override_num_blocks=2).iter_batches(
        batch_size=32, device=dev))
    out["device_batches"] = [len(batches),
                             [np.asarray(b["id"]).tolist() for b in batches]]
    out["device_batch_type"] = type(batches[0]["id"]).__module__.split(".")[0]
    (tb,) = list(d.range(10).iter_torch_batches(batch_size=10))
    out["torch_batches"] = [type(tb["id"]).__name__, int(tb["id"].sum())]
    mat = d.range(50).map_batches(lambda b: {"x": b["id"] + 1}).materialize()
    out["materialize"] = _py([mat.count(), mat.sum("x"), mat.sum("x")])

    # Files.
    pq_dir = os.path.join(tmp, "pq")
    d.range(40, override_num_blocks=4).write_parquet(pq_dir)
    back = d.read_parquet(pq_dir)
    out["parquet"] = [len(os.listdir(pq_dir)), back.count(),
                      _ids(back.take_all())]
    csv = os.path.join(tmp, "t.csv")
    with open(csv, "w") as f:
        f.write("a,b\n1,x\n2,y\n")
    jl = os.path.join(tmp, "t.json")
    with open(jl, "w") as f:
        f.write('{"a": 1}\n{"a": 2}\n')
    ds = d.read_csv(csv)
    out["read_csv_json"] = _py([ds.count(), ds.take_all()[0]["a"],
                                d.read_json(jl).sum("a")])
    ds = d.from_items([{"a": i, "b": f"s{i}"} for i in builtins.range(12)],
                      override_num_blocks=3)
    ds.write_csv(os.path.join(tmp, "csv_out"))
    ds.write_json(os.path.join(tmp, "json_out"))
    rows = sorted(d.read_json(os.path.join(tmp, "json_out")).take_all(),
                  key=lambda r: r["a"])
    out["write_csv_json"] = [
        _ids(d.read_csv(os.path.join(tmp, "csv_out")).take_all(), "a"),
        _py(rows)]
    tj = os.path.join(tmp, "tjson")
    d.range_tensor(6, shape=(3,), override_num_blocks=2).write_json(tj)
    trows = []
    for f in sorted(os.listdir(tj)):
        with open(os.path.join(tj, f)) as fh:
            trows += [json.loads(line) for line in fh]
    out["write_json_tensor"] = trows

    # Splitting.
    parts = d.range(100, override_num_blocks=4).split(2)
    out["split"] = [len(parts), [p.count() for p in parts],
                    _ids(r for p in parts for r in p.take_all())]
    its = d.range(120, override_num_blocks=6).streaming_split(2)
    got = [np.concatenate([b["id"] for b in it.iter_batches(batch_size=16)])
           for it in its]
    out["streaming_split"] = [
        [len(g) for g in got], bool(set(got[0]) & set(got[1])),
        sorted(np.concatenate(got).tolist()) == list(builtins.range(120))]
    (it,) = d.range(40, override_num_blocks=4).streaming_split(1)
    out["split_epochs"] = [
        sorted(np.concatenate([b["id"] for b in it.iter_batches(
            batch_size=10)]).tolist()) for _ in builtins.range(2)]

    # Grouping, zip, sampling.
    ds = d.from_items([{"k": i % 3, "v": float(i)}
                       for i in builtins.range(12)]).repartition(4)
    g = ds.groupby("k")
    out["groupby"] = _py({
        name: sorted((r["k"], r[col]) for r in agg.take_all())
        for name, col, agg in (("count", "count()", g.count()),
                               ("sum", "sum(v)", g.sum("v")),
                               ("mean", "mean(v)", g.mean("v")),
                               ("max", "max(v)", g.max("v")))})
    a = d.range(10, override_num_blocks=3)
    b = d.from_items([{"sq": i * i} for i in builtins.range(10)],
                     override_num_blocks=4)
    rows = a.zip(b).take_all()
    try:
        a.zip(d.range(7))
        bad = "no error"
    except ValueError as e:
        bad = "equal row counts" in str(e)
    out["zip"] = [_py(rows), sorted(a.zip(d.range(
        10, override_num_blocks=2)).schema()), bad]
    ds = d.range(1000, override_num_blocks=4)
    s = ds.random_sample(0.2, seed=0)
    out["random_sample"] = [_ids(s.take_all()), _py(s.unique("id")) == _ids(
        s.take_all()), _py(d.from_items([{"k": v} for v in [3, 1, 3, 2, 1]])
                           .unique("k"))]
    s7 = _ids(ds.random_sample(0.1, seed=7).take_all())
    base = [i for i in s7 if i < 250]
    out["sample_blocks_vary"] = [s7, not all(
        sorted(i - off for i in s7 if off <= i < off + 250) == base
        for off in (250, 500, 750))]
    u1 = [int(r["id"]) for r in ds.random_sample(0.2).take_all()]
    u2 = [int(r["id"]) for r in ds.random_sample(0.2).take_all()]
    out["unseeded_samples_differ"] = u1 != u2
    out["seeded_samples_repeat"] = (
        [int(r["id"]) for r in ds.random_sample(0.2, seed=3).take_all()]
        == [int(r["id"]) for r in ds.random_sample(0.2, seed=3).take_all()])
    tr, te = d.range(100, override_num_blocks=5).train_test_split(0.25)
    out["train_test_split"] = [tr.count(), te.count(),
                               _ids(tr.take_all() + te.take_all())]
    vals = [float(i) for i in builtins.range(50)]
    ds = d.from_items([{"x": v} for v in vals], override_num_blocks=4)
    out["std"] = _py(ds.std("x"))
    df = d.range(20, override_num_blocks=3).to_pandas()
    out["to_pandas"] = [list(map(int, df["id"])),
                        len(d.range(20).to_pandas(limit=5))]
    ds = d.from_items([{"g": i % 3, "v": float(i)}
                       for i in builtins.range(12)], override_num_blocks=4)

    def center(batch):
        return {"g": batch["g"][:1], "v_mean": np.array([batch["v"].mean()])}

    out["map_groups"] = _py(sorted(
        ((r["g"], r["v_mean"]) for r in
         ds.groupby("g").map_groups(center).take_all())))

    # The actor pool.
    class Stateful:
        def __init__(self, offset):
            self.offset = offset
            self.calls = 0
            self.pid = os.getpid()

        def __call__(self, batch):
            self.calls += 1
            batch["id"] = batch["id"] + self.offset
            batch["ncalls"] = np.full(len(batch["id"]), self.calls)
            batch["pid"] = np.full(len(batch["id"]), self.pid)
            return batch

    ds = d.range(64, override_num_blocks=8).map_batches(
        Stateful, compute=d.ActorPoolStrategy(size=2),
        fn_constructor_args=(100,))
    n = ds.count()
    rows = ds.take_all()
    out["actor_pool"] = [n, _ids(rows), len({int(r["pid"]) for r in rows})
                         <= 2, max(int(r["ncalls"]) for r in rows) >= 2]
    try:
        d.range(8).map_batches(lambda b: b,
                               compute=d.ActorPoolStrategy(size=1))
        out["actor_pool_class"] = "no error"
    except TypeError:
        out["actor_pool_class"] = "TypeError"

    # Byte-budget backpressure.
    cfg = d.DataContext.get_current()
    old = cfg.max_in_flight_bytes, cfg.execution_window
    try:
        cfg.execution_window = 16
        cfg.max_in_flight_bytes = 4 * 1024 * 1024

        def make_big(batch):
            batch["payload"] = np.zeros((len(batch["id"]), 1 << 17),
                                        np.float64)
            return batch

        total = sum(b.num_rows for b in d.range(
            24, override_num_blocks=24).map_batches(make_big).iter_blocks())
        st = dict(cfg.last_execution_stats)
        cfg.max_in_flight_bytes = None
        sum(b.num_rows for b in d.range(
            24, override_num_blocks=24).map_batches(make_big).iter_blocks())
        out["backpressure"] = [total, st["submitted"],
                               st["effective_window_min"] <= 5,
                               cfg.last_execution_stats["peak_in_flight"]
                               >= 15]
    finally:
        cfg.max_in_flight_bytes, cfg.execution_window = old

    # The logical plan: fusion, pushdowns.
    import pyarrow as pa
    import pyarrow.parquet as pq

    fdir = os.path.join(tmp, "fuse")
    os.makedirs(fdir)
    for i in builtins.range(3):
        pq.write_table(pa.table({"x": np.arange(8) + 8 * i}),
                       os.path.join(fdir, f"p{i}.parquet"))

    def double(batch):
        batch["x"] = batch["x"] * 2
        return batch

    def plus_one(batch):
        batch["x"] = batch["x"] + 1
        return batch

    ds = d.read_parquet(fdir).map_batches(double).map_batches(plus_one)
    st = ds.stats()
    ds.materialize()
    ops = {o["operator"]: o for o in st["operators"]}
    out["fusion"] = [st["optimized_stages"], st["rules_fired"],
                     cfg.last_execution_stats["submitted"],
                     st["tasks_per_block"],
                     ops["ReadParquet"]["rows_out"],
                     ops["MapBatches(double)"]["tasks"],
                     ops["MapBatches(plus_one)"]["rows_out"],
                     all(o["wall_total_s"] >= 0 for o in st["operators"]),
                     sorted(int(r["x"]) for r in ds.take_all())]
    pdir = os.path.join(tmp, "push")
    os.makedirs(pdir)
    pq.write_table(pa.table({"a": np.arange(10), "b": np.zeros(10),
                             "c": np.ones(10)}),
                   os.path.join(pdir, "t.parquet"))
    ds = d.read_parquet(pdir).select_columns(["a"])
    rt_mod = _sub(rt, "data.dataset")
    out["column_pushdown"] = [
        all(isinstance(src, rt_mod._ReadTask) and src.columns == ["a"]
            and ops == [] for src, ops in ds._parts),
        ds.schema(), [int(r["a"]) for r in ds.take_all()],
        any("ReadPushdown" in r for r in ds.stats()["rules_fired"]),
        "ReadPushdown" in ds.explain(),
        d.read_parquet(pdir, columns=["a", "b"]).select_columns(
            ["b"]).schema()]
    ldir = os.path.join(tmp, "limit")
    os.makedirs(ldir)
    for i in builtins.range(4):
        pq.write_table(pa.table({"x": np.arange(5) + 5 * i}),
                       os.path.join(ldir, f"f{i}.parquet"))
    ds = d.read_parquet(ldir, override_num_blocks=1).limit(7)
    task = rt_mod._ReadTask("parquet", sorted(
        os.path.join(ldir, f"f{i}.parquet") for i in builtins.range(4)),
        limit=7)
    out["limit_pushdown"] = [ds.count(), [int(r["x"]) for r in ds.take_all()],
                             task().num_rows]

    # Joins.
    left = d.from_items([{"k": 1, "v": "a"}, {"k": 2, "v": "b"},
                         {"k": 2, "v": "b2"}, {"k": 3, "v": "c"}],
                        override_num_blocks=2)
    right = d.from_items([{"k": 1, "w": 10.0, "v": "R1"},
                          {"k": 2, "w": 20.0, "v": "R2"},
                          {"k": 2, "w": 21.0, "v": "R2b"},
                          {"k": 9, "w": 90.0, "v": "R9"}],
                         override_num_blocks=2)
    out["join"] = _py([
        sorted((r["k"], r["v"], r["w"], r["v_r"])
               for r in left.join(right, on="k").take_all()),
        sorted(((r["k"], r["v"], r["w"], r["v_r"]) for r in left.join(
            right, on="k", how="left").take_all()), key=repr),
        "HashJoin" in left.join(right, on="k").explain()])
    dig = rt_mod._join_key_digestable
    out["join_digest"] = [
        [dig(v) == dig(float(v)) for v in (2 ** 53, 2 ** 60, -(2 ** 58))],
        dig(2) == dig(2.0), dig(2 ** 53) != dig(2 ** 53 + 1),
        dig(True) != dig(1.0), dig(float(2 ** 53) + 2.0) == dig(2 ** 53 + 2)]
    big = 2 ** 53
    rows = sorted(d.from_items([{"k": big, "v": 1}, {"k": 7, "v": 2}],
                               override_num_blocks=2).join(
        d.from_items([{"k": float(big), "w": 10.0}, {"k": 7.0, "w": 70.0}],
                     override_num_blocks=2), on="k").take_all(),
        key=lambda r: r["v"])
    out["join_big_key"] = _py([(r["v"], r["w"]) for r in rows])
    left = d.from_items([{"k": i, "v": i * 10} for i in builtins.range(8)],
                        override_num_blocks=2)
    right = d.from_items([{"k": 100, "w": 1.5}])
    rows = left.join(right, on="k", how="left").take_all()
    out["join_empty_right"] = [len(rows), all(set(r) == {"k", "v", "w"}
                                              and np.isnan(r["w"])
                                              for r in rows),
                               left.join(right, on="k").count()]

    # stats() after materialize() does not run the plan again.
    calls_file = os.path.join(tmp, "calls")

    def effectful(batch):
        with open(calls_file, "a") as f:
            f.write("x")
        batch["id"] = batch["id"] * 2
        return batch

    ds = d.range(24, override_num_blocks=3).map_batches(effectful)
    mat = ds.materialize()
    n_mat = os.path.getsize(calls_file)
    sources = [x.stats()["operators_source"] for x in (ds, mat)]
    op = {o["operator"]: o for o in ds.stats()["operators"]}[
        "MapBatches(effectful)"]
    out["stats_no_rerun"] = [n_mat, sources, op["rows_out"], op["tasks"],
                             os.path.getsize(calls_file) == n_mat,
                             d.range(8, override_num_blocks=2).map_batches(
                                 effectful).stats()["operators_source"]]
    rt.shutdown()
    return out


# -------------------------------------------------------------------- tune

def _train_fn(config):
    tune = importlib.import_module(_here() + ".tune")
    for i in range(10):
        tune.report({"loss": config["lr"] * (10 - i)})
    return {"loss": config["lr"], "training_iteration": 11}


def _dying_fn(config):
    if config["i"] == 1:
        os._exit(1)  # a segfault or OOM the actor cannot catch
    return {"value": config["i"], "training_iteration": 1}


def _asha_fn(config):
    tune = importlib.import_module(_here() + ".tune")
    for i in range(1, 30):
        tune.report({"score": config["q"] * (1 - 0.5 ** i)})
        time.sleep(0.05)
    return {"score": config["q"], "training_iteration": 30}


def _slow_fn(config):
    ctx = importlib.import_module(_here() + ".core.context").ctx
    ctx.client.kv_put(f"ran:{config['i']}", b"1")
    time.sleep(config.get("sleep", 0.0))
    return {"value": config["i"], "training_iteration": 1}


def _tuned_loop(config):
    train = importlib.import_module(_here() + ".train")
    train.report({"loss": abs(config["lr"] - 0.1) + 0.01})


def _pbt_fn(config):
    tune = importlib.import_module(_here() + ".tune")
    ckpt = tune.get_checkpoint()
    step, score = 0, 0.0
    if ckpt:
        with open(os.path.join(ckpt, "state.json")) as f:
            state = json.load(f)
        step, score = state["step"], state["score"]

    def save():
        d = os.path.join(tune.get_trial_dir(), f"ckpt_{step}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump({"step": step, "score": score}, f)
        return d

    while step < 20:
        score += config["lr"]
        step += 1
        tune.report({"score": score, "training_iteration": step},
                    checkpoint=save())
    tune.report({"score": score, "training_iteration": step},
                checkpoint=save())


def _trials(results, keys):
    """Per trial, in trial order: its config, status and the named
    metrics."""
    out = []
    for r in results:
        out.append([_py(r.config), r.status,
                    _py({k: r.metrics.get(k) for k in keys})])
    return out


@scenario
def tune(rt):
    """``tests/test_tune.py``'s Tuner cases, in one cluster: a grid under
    FIFO, ASHA's early stops, a dead trial actor failing only its trial,
    a Tuner over a trainer (the port's gang with ``use_gpu=False``),
    interrupt and restore, PBT exploiting the better trial, a searcher and
    TPE through the Tuner."""
    rt.init(num_cpus=4)
    tune = _sub(rt, "tune")
    train = _sub(rt, "train")
    tmp = tempfile.mkdtemp(prefix="rt_tune_scenario_")
    out = {}

    def run_cfg(name=None):
        return train.RunConfig(name=name, storage_path=tmp)

    res = tune.Tuner(
        _train_fn, param_space={"lr": tune.grid_search([1.0, 2.0, 3.0, 4.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=run_cfg()).fit()
    best = res.get_best_result()
    out["grid_fifo"] = [_trials(res, ["loss", "training_iteration"]),
                        res.errors, best.config["lr"], best.metrics["loss"]]

    res = tune.Tuner(
        _dying_fn, param_space={"i": tune.grid_search([0, 1, 2])},
        tune_config=tune.TuneConfig(metric="value", mode="max"),
        run_config=run_cfg()).fit()
    out["actor_death"] = [[[r.config["i"], r.status] for r in res],
                          res.get_best_result().metrics["value"],
                          sum(bool(r.error) for r in res)]

    res = tune.Tuner(
        _asha_fn,
        param_space={"q": tune.grid_search([7, 5, 3, 1, 6, 4, 2, 0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=4,
            scheduler=tune.ASHAScheduler(metric="score", mode="max",
                                         max_t=30, grace_period=2,
                                         reduction_factor=3)),
        run_config=run_cfg()).fit()
    statuses = [r.status for r in res]
    # Which weaker trials are cut depends on the order their reports
    # arrive in; the strongest runs first and cannot be.
    out["asha"] = [len(res), "STOPPED" in statuses,
                   res.get_best_result().config["q"], statuses[0]]

    kw = {"use_gpu": False} if _port(rt) else {}
    trainer_cls = train.TorchTrainer if _port(rt) else train.JaxTrainer
    trainer = trainer_cls(
        _tuned_loop,
        scaling_config=train.ScalingConfig(num_workers=1, **kw))
    res = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search([0.01, 0.1, 0.5])}},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2),
        run_config=run_cfg()).fit()
    best = res.get_best_result()
    out["over_trainer"] = [len(res), res.errors,
                           best.config["train_loop_config"]["lr"],
                           round(best.metrics["loss"], 12),
                           [[r.config["train_loop_config"]["lr"], r.status,
                             round(r.metrics["loss"], 12)] for r in res]]

    # Interrupt, then restore: finished trials do not run again.
    ctx = _sub(rt, "core.context").ctx
    exp_dir = os.path.join(tmp, "resume_exp")
    tuner = tune.Tuner(
        _slow_fn,
        param_space={"i": tune.grid_search(list(range(8))), "sleep": 0.5},
        tune_config=tune.TuneConfig(metric="value", mode="max",
                                    max_concurrent_trials=2),
        run_config=run_cfg("resume_exp"))
    errors = []

    def fit():
        try:
            tuner.fit()
        except tune.TuneInterrupted:
            pass
        except BaseException as e:  # noqa: BLE001: part of the result
            errors.append(repr(e))

    def n_done():
        try:
            with open(os.path.join(exp_dir, "tuner_state.json")) as f:
                state = json.load(f)
            return sum(t["status"] == "TERMINATED" for t in state["trials"])
        except Exception:  # noqa: BLE001: not written yet
            return 0

    th = threading.Thread(target=fit)
    th.start()
    deadline = time.time() + 60
    while n_done() < 2 and time.time() < deadline:
        time.sleep(0.1)
    tuner._abort.set()
    th.join(timeout=60)
    done_before = n_done()
    for k in ctx.client.kv_keys("ran:"):
        ctx.client.kv_del(k)
    res = tune.Tuner.restore(exp_dir, _slow_fn).fit()
    out["restore"] = [errors, 2 <= done_before < 8, len(res),
                      [r.status for r in res],
                      len(ctx.client.kv_keys("ran:")) == 8 - done_before,
                      res.get_best_result("value", "max").metrics["value"]]

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0]}, seed=7)
    res = tune.Tuner(
        _pbt_fn,
        param_space={"lr": tune.grid_search([1.0, 1.0, 0.1, 0.1])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=pbt, max_concurrent_trials=1),
        run_config=run_cfg("pbt_exp")).fit()
    out["pbt"] = [_trials(res, ["score", "training_iteration"]),
                  pbt.num_exploits]

    def double(config):
        return {"value": config["x"] * 2}

    searcher = tune.ConcurrencyLimiter(
        tune.BasicVariantGenerator({"x": tune.grid_search([1, 2, 3, 4, 5])}),
        max_concurrent=2)
    res = tune.Tuner(
        double, tune_config=tune.TuneConfig(
            metric="value", mode="max", num_samples=5, search_alg=searcher),
        run_config=run_cfg("searcher_exp")).fit()
    out["searcher"] = [sorted(_py([[r.config["x"], r.metrics["value"]]
                                   for r in res])),
                       res.get_best_result().metrics["value"]]

    def bowl(config):
        tune_mod = importlib.import_module(_here() + ".tune")
        tune_mod.report({"score": (config["lr"] - 0.01) ** 2})

    tpe = tune.TPESearcher({"lr": tune.loguniform(1e-4, 1.0)},
                           metric="score", mode="min", n_initial=4, seed=3)
    res = tune.Tuner(
        bowl, tune_config=tune.TuneConfig(
            metric="score", mode="min", num_samples=12, search_alg=tpe,
            max_concurrent_trials=2),
        run_config=run_cfg("tpe_exp")).fit()
    out["tpe_tuner"] = [len(res), res.get_best_result().metrics["score"]
                        < 0.5, len(tpe._history) >= 8,
                        [r.status for r in res]]
    rt.shutdown()
    return out


# -------------------------------------------------------------- data_train


def _ingest_loop():
    """Each worker reads its shard in batches of 8 and reports the ids it
    saw (the JAX package's ``tests/test_data_train.py`` loop, one node)."""
    train = importlib.import_module(_here() + ".train")
    ctx = importlib.import_module(_here() + ".core.context").ctx
    kw = {"device": "cpu"} if _here() == "ray_tpu_torch" else {}
    rank = train.get_context().get_world_rank()
    ids = []
    for _ in range(2):  # two epochs: the same shard each time
        seen = []
        shard = train.get_dataset_shard("train")
        for batch in shard.iter_batches(batch_size=8, **kw):
            seen.extend(int(x) for x in np.asarray(batch["id"]))
            time.sleep(0.01)
        ids.append(sorted(seen))
        train.report({"rows": len(seen)})
    ctx.client.kv_put(f"ingest:{rank}", json.dumps(ids).encode())


@scenario
def data_train(rt):
    """``TorchTrainer(datasets=...)`` (the JAX package's ``JaxTrainer``) on
    two workers of one node: each worker's shard, the round's data wait in
    the gang's metrics; then one PPO trial through ``PPO.as_trainable`` on
    the CPU."""
    rt.init(num_cpus=4)
    d = _sub(rt, "data")
    train = _sub(rt, "train")
    tune = _sub(rt, "tune")
    rllib = _sub(rt, "rllib")
    out = {}
    kw = {"use_gpu": False} if _port(rt) else {}
    trainer_cls = train.TorchTrainer if _port(rt) else train.JaxTrainer
    tmp = tempfile.mkdtemp(prefix="rt_data_train_")
    ds = d.range(96, override_num_blocks=6).map_batches(
        lambda b: {"id": b["id"]})
    res = trainer_cls(
        _ingest_loop,
        datasets={"train": ds},
        scaling_config=train.ScalingConfig(num_workers=2, **kw),
        run_config=train.RunConfig(storage_path=tmp)).fit()
    ctx = _sub(rt, "core.context").ctx
    shards = [json.loads(ctx.client.kv_get(f"ingest:{r}").decode())
              for r in range(2)]
    # Which blocks a rank gets depends on which rank asks first, so the
    # shards are compared by their properties, not their rows.
    first = [set(ep[0]) for ep in shards]
    out["ingest"] = {"error": None if res.error is None else str(res.error),
                     "epochs_equal": [ep[0] == ep[1] for ep in shards],
                     "disjoint": not first[0] & first[1],
                     "covering": sorted(first[0] | first[1])
                     == list(range(96)),
                     "rounds": len(res.metrics_history)}
    gangs = ctx.client.call("list_state", {"kind": "gang_rounds"})["items"]
    out["data_wait"] = [{"world": g["world"],
                         "rounds": [p["round"] for p in g["profiles"]],
                         "data_s_positive": {r: rec["data_s"] > 0 for r, rec
                                             in g["ranks"].items()}}
                        for g in gangs]

    cfg = rllib.PPOConfig()
    cfg.num_env_runners = 1
    cfg.num_envs_per_runner = 2
    cfg.rollout_fragment_length = 16
    cfg.minibatch_size = 16
    cfg.num_epochs = 1
    if _port(rt):
        cfg.device = "cpu"
    res = tune.Tuner(
        rllib.PPO.as_trainable(cfg, stop_iters=1),
        tune_config=tune.TuneConfig(metric="episode_return_mean",
                                    mode="max"),
        run_config=train.RunConfig(storage_path=tmp)).fit()
    (r,) = list(res)
    out["ppo_trial"] = [r.status, r.error, r.metrics.get(
        "training_iteration"), sorted(k for k in r.metrics
                                      if k in ("episode_return_mean",
                                               "num_env_steps_sampled",
                                               "timesteps_total"))]
    rt.shutdown()
    return out


def _noop_loop():
    pass


@scenario
def no_card(rt):
    """The port alone, on a host with no CUDA and no card in the cluster:
    a default ``TorchTrainer`` trial fails with the trainer's own error
    (it never trains on the CPU), and ``iter_batches`` to a CUDA device
    raises."""
    rt.init(num_cpus=2)
    d = _sub(rt, "data")
    train = _sub(rt, "train")
    tune = _sub(rt, "tune")
    res = tune.Tuner(
        train.TorchTrainer(_noop_loop,
                           scaling_config=train.ScalingConfig(num_workers=1)),
        param_space={"train_loop_config": {"lr": tune.grid_search([0.1])}},
        run_config=train.RunConfig(
            storage_path=tempfile.mkdtemp(prefix="rt_no_card_"))).fit()
    (r,) = list(res)
    out = {"gpus": rt.cluster_resources().get("GPU", 0.0),
           "trial": [r.status, "use_gpu=False" in (r.error or "")]}
    ds = d.range(8)
    (shard,) = ds.streaming_split(1)
    for key, make in (("cuda", lambda: ds.iter_batches(device="cuda")),
                      ("true", lambda: ds.iter_batches(device=True)),
                      ("shard", lambda: shard.iter_batches(device="cuda"))):
        try:
            next(iter(make()))
            out[key] = "no error"
        except RuntimeError as e:
            out[key] = "CUDA is not available" in str(e)
    rt.shutdown()
    return out


# ------------------------------------------------------------------ driver


def run(names, pkg: str, env=None):
    """Start the scenarios ``names`` under ``pkg`` in one subprocess;
    returns the ``Popen`` (read it with ``result``).  ``env`` adds
    variables to this process's environment; a value of None removes
    one."""
    import subprocess

    full = dict(os.environ)
    # A scenario starts its own cluster: an address this process holds
    # (its own cluster, while one is up) must not send it to that one.
    for k in ("RT_ADDRESS", "RT_TORCH_ADDRESS"):
        full.pop(k, None)
    for k, v in (env or {}).items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    full["PYTHONPATH"] = os.pathsep.join(
        [root, here, full.get("PYTHONPATH", "")])
    full.setdefault("OMP_NUM_THREADS", "1")
    full.setdefault("MKL_NUM_THREADS", "1")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pkg", pkg, *names],
        cwd=root, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def run_pair(names, env=None, timeout: float = 300.0):
    """The scenarios under both packages at once (two clusters on one
    host), one process each: ``(ray_tpu results, ray_tpu_torch
    results)``, each ``{scenario: result}``."""
    jp = run(names, "ray_tpu", env)
    tp = run(names, "ray_tpu_torch", env)
    return result(jp, timeout), result(tp, timeout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", required=True, choices=("ray_tpu",
                                                     "ray_tpu_torch"))
    ap.add_argument("names", nargs="+", choices=sorted(SCENARIOS))
    args = ap.parse_args(argv)
    rt = importlib.import_module(args.pkg)
    out = {name: SCENARIOS[name](rt) for name in args.names}
    print("SCENARIO_RESULT " + json.dumps(out, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
