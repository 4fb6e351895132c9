"""Dataset: lazy plan + bounded-window streaming execution over the cluster.

Role-equivalent to the reference's Dataset / streaming executor (reference:
python/ray/data/dataset.py:139 — map_batches:383, repartition:1042,
split:1337, iter_batches:3675, streaming_split via
data/_internal/execution/operators/output_splitter.py;
data/_internal/execution/streaming_executor.py:48).  Design deviation: the
reference builds logical→physical plans with an optimizer and a
resource-budgeted operator state machine; here the plan is a list of
(source, op-chain) parts and execution is a pull-based window of remote
tasks — each task runs the whole chain for one block (operator fusion by
construction, which is what the reference's optimizer does to map chains
anyway).
"""

from __future__ import annotations

import builtins
import functools
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

import ray_tpu_torch

from .block import Batch, Block
from .context import DataContext
from .logical import LogicalOp, LogicalPlan

# A part is one block's production recipe: a source (callable returning a
# Block, or an ObjectRef of a materialized Block) plus the op chain to apply.
Source = Any
Op = Callable[[Block], Block]


class _TimedOp:
    """A named per-block op.  The name feeds Dataset.stats()' per-operator
    rows/wall breakdown (reference: each physical operator carries
    OpRuntimeMetrics — _internal/execution/interfaces/op_runtime_metrics.py).
    Execution cost is one attribute lookup; timing only happens on the
    stats path."""

    __slots__ = ("name", "fn")

    def __init__(self, name: str, fn: Op):
        self.name = name
        self.fn = fn

    def __call__(self, block: Block) -> Block:
        return self.fn(block)


def _op_name(op: Op) -> str:
    if isinstance(op, _TimedOp):
        return op.name
    if isinstance(op, _StatefulBatchOp):
        return f"MapBatches({op.fn_cls.__name__})"
    return getattr(op, "__name__", type(op).__name__)


class _ReadTask:
    """Picklable file-read source with pushdown knobs (reference:
    datasource ReadTask + the logical Read op that column/limit pushdown
    rules rewrite — logical/rules/).  ``columns`` prunes at the parquet
    reader (only those columns are decoded); ``limit`` caps rows per part.
    """

    __slots__ = ("kind", "files", "columns", "limit", "reader_kwargs")

    SUPPORTS_COLUMNS = {"parquet"}

    def __init__(self, kind: str, files: List[str],
                 columns: Optional[List[str]] = None,
                 limit: Optional[int] = None, reader_kwargs=None):
        self.kind = kind
        self.files = files
        self.columns = columns
        self.limit = limit
        self.reader_kwargs = reader_kwargs or {}

    def _read_one(self, f: str) -> Block:
        if self.kind == "parquet":
            import pyarrow.parquet as pq

            return Block.from_arrow(pq.read_table(f, columns=self.columns))
        if self.kind == "csv":
            import pyarrow.csv as pacsv

            return Block.from_arrow(pacsv.read_csv(f))
        if self.kind == "json":
            import pyarrow.json as pajson

            return Block.from_arrow(pajson.read_json(f))
        if self.kind == "images":
            return _read_image_file(f, **self.reader_kwargs)
        raise ValueError(f"unknown read kind {self.kind!r}")

    def __call__(self) -> Block:
        blocks: List[Block] = []
        rows = 0
        for f in self.files:
            b = self._read_one(f)
            blocks.append(b)
            rows += b.num_rows
            if self.limit is not None and rows >= self.limit:
                break  # row-limited read: later files are never opened
        out = Block.concat(blocks)
        if self.limit is not None and out.num_rows > self.limit:
            out = out.slice(0, self.limit)
        return out

    @property
    def name(self) -> str:
        return f"Read{self.kind.capitalize()}"


def _stage_name(source: Source, ops: List[Op]) -> str:
    """Low-cardinality stage label: the fused op chain this part runs
    (reference: each physical operator exports OpRuntimeMetrics tagged by
    operator name)."""
    parts = [getattr(source, "name", "Source") if callable(source)
             else "Block"]
    parts.extend(_op_name(op) for op in ops)
    return "->".join(parts)[:120]


def _exec_part_body(source: Source, ops: List[Op]) -> Block:
    import time as _time

    t0 = _time.perf_counter()
    block = source() if callable(source) else source
    for op in ops:
        block = op(block)
    _emit_stage_metrics(source, ops, block, _time.perf_counter() - t0)
    return block


def _emit_stage_metrics(source: Source, ops: List[Op], block: Block,
                        wall: float) -> None:
    # Per-stage throughput telemetry: two counters per part (rows and
    # wall-seconds, tagged by the fused stage) — rows/sec is their ratio,
    # and its trend is visible in the head's metrics history.
    try:
        from ray_tpu_torch.util.metrics import get_counter, get_gauge

        tags = {"stage": _stage_name(source, ops)}
        get_counter("ray_tpu_data_rows_total",
                    "Rows produced per dataset stage",
                    tag_keys=("stage",)).inc(block.num_rows, tags=tags)
        get_counter("ray_tpu_data_stage_seconds_total",
                    "Wall seconds spent per dataset stage",
                    tag_keys=("stage",)).inc(wall, tags=tags)
        if wall > 0:
            # pid tag: gauges merge last-writer-wins per (name, tags) at
            # the head, so parallel workers on one stage must stay
            # distinct series (rate over the two counters above gives the
            # stage-wide aggregate).
            import os as _os

            get_gauge("ray_tpu_data_rows_per_sec",
                      "Rows/sec of the most recent part per stage/worker",
                      tag_keys=("stage", "pid")).set(
                block.num_rows / wall,
                tags={**tags, "pid": str(_os.getpid())})
    except Exception:
        pass  # telemetry must never fail a data task


@ray_tpu_torch.remote
def _exec_part(source: Source, ops: List[Op]) -> Block:
    return _exec_part_body(source, ops)


@ray_tpu_torch.remote
def _exec_part_timed(source: Source, ops: List[Op]):
    """The materialize() executor: the block PLUS per-operator timings as
    a second return (submitted with num_returns=2), so Dataset.stats()
    can report the LAST RUN's breakdown without re-executing the plan.
    The timing rows are a few tuples per part — negligible next to the
    block itself."""
    import time as _time

    rows: List[tuple] = []
    t_start = _time.perf_counter()
    t0 = t_start
    block = source() if callable(source) else source
    rows.append((getattr(source, "name", "Source"),
                 _time.perf_counter() - t0, block.num_rows))
    for op in ops:
        t0 = _time.perf_counter()
        block = op(block)
        rows.append((_op_name(op), _time.perf_counter() - t0,
                     block.num_rows))
    _emit_stage_metrics(source, ops, block,
                        _time.perf_counter() - t_start)
    return block, rows


def _aggregate_op_rows(per_part: List[List[tuple]]
                       ) -> List[Dict[str, Any]]:
    """Fold [(op, wall, rows), ...] per part into the stats() operator
    table (tasks / rows_out / wall totals per operator)."""
    operators: List[Dict[str, Any]] = []
    agg: Dict[str, Dict[str, Any]] = {}
    for rows in per_part:
        for name, wall, n_rows in rows:
            ent = agg.get(name)
            if ent is None:
                ent = agg[name] = {
                    "operator": name, "tasks": 0, "rows_out": 0,
                    "wall_total_s": 0.0,
                }
                operators.append(ent)
            ent["tasks"] += 1
            ent["rows_out"] += int(n_rows)
            ent["wall_total_s"] += float(wall)
    for ent in operators:
        ent["wall_total_s"] = round(ent["wall_total_s"], 6)
        ent["wall_mean_s"] = round(
            ent["wall_total_s"] / max(ent["tasks"], 1), 6)
    return operators


@ray_tpu_torch.remote
def _part_rows(source: Source, ops: List[Op]) -> int:
    block = source() if callable(source) else source
    for op in ops:
        block = op(block)
    return block.num_rows


@ray_tpu_torch.remote
def _part_agg(source: Source, ops: List[Op], col: str, kind: str):
    block = source() if callable(source) else source
    for op in ops:
        block = op(block)
    if block.num_rows == 0:
        return None
    arr = block.to_numpy()[col]
    if kind == "sum":
        return (arr.sum(), len(arr))
    if kind == "min":
        return (arr.min(), len(arr))
    if kind == "max":
        return (arr.max(), len(arr))
    if kind == "sumsq":
        arr = arr.astype(np.float64)
        return ((arr.sum(), (arr * arr).sum()), len(arr))
    if kind == "unique":
        return (np.unique(arr).tolist(), len(arr))
    raise ValueError(kind)


@ray_tpu_torch.remote
def _part_group_agg(source: Source, ops: List[Op], key: str,
                    col: Optional[str], kind: str) -> dict:
    """Per-block grouped partials: key -> (accumulator, count)."""
    block = source() if callable(source) else source
    for op in ops:
        block = op(block)
    if block.num_rows == 0:
        return {}
    cols = block.to_numpy()
    keys = cols[key]
    vals = cols[col] if col is not None else None
    out: dict = {}
    for i in builtins.range(len(keys)):
        k = keys[i].item() if hasattr(keys[i], "item") else keys[i]
        acc, cnt = out.get(k, (None, 0))
        if vals is None:
            out[k] = (None, cnt + 1)
            continue
        v = vals[i]
        if acc is None:
            acc = v
        elif kind in ("sum", "mean"):
            acc = acc + v
        elif kind == "min":
            acc = min(acc, v)
        elif kind == "max":
            acc = max(acc, v)
        out[k] = (acc, cnt + 1)
    return out


class GroupedDataset:
    """(reference: python/ray/data/grouped_data.py GroupedData)"""

    def __init__(self, ds: "Dataset", key: str):
        self._ds = ds
        self._key = key

    def _run(self, col: Optional[str], kind: str) -> "Dataset":
        partials = ray_tpu_torch.get([
            _part_group_agg.remote(src, ops, self._key, col, kind)
            for src, ops in self._ds._plan_parts()
        ])
        merged: dict = {}
        for part in partials:
            for k, (acc, cnt) in part.items():
                macc, mcnt = merged.get(k, (None, 0))
                if acc is None or macc is None:
                    macc = acc if macc is None else macc
                elif kind in ("sum", "mean"):
                    macc = macc + acc
                elif kind == "min":
                    macc = min(macc, acc)
                elif kind == "max":
                    macc = max(macc, acc)
                merged[k] = (macc, mcnt + cnt)
        out_col = f"{kind}({col})" if col else "count()"
        rows = []
        for k in sorted(merged):
            acc, cnt = merged[k]
            if kind == "count":
                val = cnt
            elif kind == "mean":
                val = acc / cnt if cnt else None
            else:
                val = acc
            rows.append({self._key: k, out_col: val})
        return from_items(rows)

    def count(self) -> "Dataset":
        return self._run(None, "count")

    def sum(self, col: str) -> "Dataset":
        return self._run(col, "sum")

    def mean(self, col: str) -> "Dataset":
        return self._run(col, "mean")

    def min(self, col: str) -> "Dataset":
        return self._run(col, "min")

    def max(self, col: str) -> "Dataset":
        return self._run(col, "max")

    def map_groups(self, fn: Callable[[Batch], Batch]) -> "Dataset":
        """Apply ``fn`` to each group's batch (reference: grouped_data.py
        map_groups — sorts by key, then applies the UDF per contiguous
        group).  Single-task application after the sort; fine at the same
        scale as Dataset.sort."""
        key = self._key
        sorted_ds = self._ds.sort(key)
        refs, _ = sorted_ds._materialize_refs()

        @ray_tpu_torch.remote
        def apply(refs: List[Any]) -> Block:
            block = Block.concat([ray_tpu_torch.get(r) for r in refs])
            cols = block.to_numpy()
            keys = cols[key]
            pieces = []
            lo = 0
            for hi in builtins.range(1, len(keys) + 1):
                if hi == len(keys) or keys[hi] != keys[lo]:
                    group = {k: v[lo:hi] for k, v in cols.items()}
                    out = fn(group)
                    pieces.append(Block.from_batch(out))
                    lo = hi
            return Block.concat(pieces) if pieces else Block.from_batch({})

        return Dataset([(apply.remote(refs), [])])


@ray_tpu_torch.remote
def _sample_column(block: Block, key: str, k: int) -> np.ndarray:
    """Up to k evenly-spaced sample values of one block's sort column
    (block ref resolves at the task boundary; reference:
    planner/exchange/sort_task_spec.py sample_boundaries)."""
    arr = block.to_numpy()[key]
    if len(arr) <= k:
        return np.asarray(arr)
    idx = np.linspace(0, len(arr) - 1, k).astype(np.int64)
    return np.asarray(arr)[idx]


@ray_tpu_torch.remote
def _range_partition(block: Block, key: str, bounds: List) -> List[Block]:
    """Split one block into len(bounds)+1 sub-blocks by sort-key range
    (submitted with num_returns so each range lands in its own object)."""
    arr = np.asarray(block.to_numpy()[key])
    which = np.searchsorted(np.asarray(bounds), arr, side="right")
    return [block.take_rows(np.flatnonzero(which == j))
            for j in builtins.range(len(bounds) + 1)]


@ray_tpu_torch.remote
def _sort_range(refs: List[Any], key: str, descending: bool) -> Block:
    """Concat one range's partitions from every input block and sort it —
    each output task holds only its range, never the whole dataset."""
    block = Block.concat([ray_tpu_torch.get(r) for r in refs])
    if block.num_rows == 0:
        return block  # a range can be empty (all-duplicate sample bounds)
    order = np.argsort(np.asarray(block.to_numpy()[key]), kind="stable")
    if descending:
        order = order[::-1]
    return block.take_rows(order)


@ray_tpu_torch.remote
def _shuffle_partition(block: Block, n_out: int, seed) -> List[Block]:
    """Assign each row of one block to a uniformly random output bucket
    (submitted with num_returns=n_out)."""
    rng = np.random.default_rng(seed)
    which = rng.integers(0, n_out, block.num_rows)
    return [block.take_rows(np.flatnonzero(which == j))
            for j in builtins.range(n_out)]


@ray_tpu_torch.remote
def _shuffle_merge(refs: List[Any], seed) -> Block:
    """Concat one output bucket's pieces and permute rows locally."""
    block = Block.concat([ray_tpu_torch.get(r) for r in refs])
    rng = np.random.default_rng(seed)
    return block.take_rows(rng.permutation(block.num_rows))


def _join_key_digestable(v) -> str:
    """Canonical string for partition routing.  Values the probe-side dict
    treats as EQUAL (python equality: 2 == 2.0) must digest identically,
    or the same join returns different rows at different partition counts;
    and hash() itself is salted per worker process, so a digest of this
    canonical form is the only stable router."""
    if hasattr(v, "item"):
        v = v.item()
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return repr(v)
    try:
        f = float(v)
    except OverflowError:  # int beyond float range: no float equals it
        return repr(v)
    if f != v:
        return repr(v)  # int not exactly representable: no float equals it
    if abs(f) < 2.0 ** 53:  # exactly representable: canonical
        return repr(f)
    # |v| >= 2**53: repr(float) and repr(int) diverge for EQUAL values
    # (1 << 53 vs 9.007199254740992e+15) — integer-valued keys share the
    # exact integer form so int and float keys that compare equal route
    # to the same partition.  All floats this large are integers.
    if isinstance(v, int):
        return repr(v)
    return repr(int(f)) if f.is_integer() else repr(f)


@ray_tpu_torch.remote
def _hash_partition(block: Block, key: str, n_out: int) -> List[Block]:
    """Route each row to digest(key) % n_out (submitted with
    num_returns=n_out) — stage 1 of the join exchange."""
    keys = block.to_numpy()[key]
    import zlib

    which = np.fromiter(
        (zlib.crc32(_join_key_digestable(v).encode()) % n_out
         for v in keys),
        dtype=np.int64, count=len(keys),
    )
    return [block.take_rows(np.flatnonzero(which == j))
            for j in builtins.range(n_out)]


@ray_tpu_torch.remote
def _np_schema(refs: List[Any]) -> Dict[str, str]:
    """Raw numpy dtype strings (np.dtype-parseable) of the first non-empty
    block — the join exchange ships these so empty partitions keep the
    full column set."""
    for r in refs:
        b = ray_tpu_torch.get(r)
        if b.num_rows:
            return {k: v.dtype.str for k, v in b.to_numpy().items()}
    return {}


@ray_tpu_torch.remote
def _hash_join_partition(left_refs: List[Any], right_refs: List[Any],
                         on: str, how: str, suffix: str,
                         lschema: Dict[str, str],
                         rschema: Dict[str, str]) -> Block:
    """Stage 2: join ONE hash partition.  Build an index over the right
    side's keys, probe with the left side's (classic hash join; both
    sides of a partition share hash(key), so the join is complete).
    ``lschema``/``rschema`` carry the full column sets so partitions with
    an empty side still emit schema-consistent blocks (a left join whose
    partition has no right rows must still create the right columns)."""
    left = Block.concat([ray_tpu_torch.get(r) for r in left_refs])
    right = Block.concat([ray_tpu_torch.get(r) for r in right_refs])
    lcols = left.to_numpy()
    rcols = right.to_numpy()
    for name, dt in lschema.items():
        if name not in lcols:
            lcols[name] = np.empty(0, np.dtype(dt))
    for name, dt in rschema.items():
        if name not in rcols:
            rcols[name] = np.empty(0, np.dtype(dt))
    rkeys = rcols.get(on, np.array([]))
    index: dict = {}
    for i in builtins.range(len(rkeys)):
        k = rkeys[i].item() if hasattr(rkeys[i], "item") else rkeys[i]
        index.setdefault(k, []).append(i)
    lkeys = lcols.get(on, np.array([]))
    li: List[int] = []
    ri: List[int] = []
    unmatched: List[int] = []
    for i in builtins.range(len(lkeys)):
        k = lkeys[i].item() if hasattr(lkeys[i], "item") else lkeys[i]
        rows = index.get(k)
        if rows:
            li.extend([i] * len(rows))
            ri.extend(rows)
        elif how == "left":
            unmatched.append(i)
    out: Dict[str, np.ndarray] = {}
    li_a, ri_a = np.asarray(li, np.int64), np.asarray(ri, np.int64)
    for name, col in lcols.items():
        out[name] = col[li_a]
    for name, col in rcols.items():
        if name == on:
            continue
        out_name = name + suffix if name in lcols else name
        out[out_name] = col[ri_a]
    if how == "left":
        # Nullable right columns upcast UNCONDITIONALLY (numeric->float64,
        # else object): per-partition upcasting-only-when-unmatched would
        # give the same output column different dtypes in different
        # partitions.
        for name, col in rcols.items():
            if name == on:
                continue
            out_name = name + suffix if name in lcols else name
            if np.issubdtype(col.dtype, np.number):
                out[out_name] = out[out_name].astype(np.float64,
                                                     copy=False)
            else:
                out[out_name] = out[out_name].astype(object, copy=False)
        if unmatched:
            um = np.asarray(unmatched, np.int64)
            for name, col in lcols.items():
                out[name] = np.concatenate([out[name], col[um]])
            n_um = len(um)
            for name, col in rcols.items():
                if name == on:
                    continue
                out_name = name + suffix if name in lcols else name
                fill = (np.full(n_um, np.nan)
                        if np.issubdtype(col.dtype, np.number)
                        else np.full(n_um, None, object))
                out[out_name] = np.concatenate([out[out_name], fill])
    return Block.from_batch(out) if out else Block({})


@ray_tpu_torch.remote
def _gather_spans(spans: List[tuple]) -> Block:
    """Concatenate row spans [(block_ref, lo, hi), ...] into one block.
    Workers pull the referenced blocks (cross-node via the object plane)."""
    pieces = []
    for ref, lo, hi in spans:
        block = ray_tpu_torch.get(ref)
        pieces.append(block.slice(lo, hi))
    return Block.concat(pieces)


@ray_tpu_torch.remote
def _gather_indices(parts: List[tuple]) -> Block:
    """Concatenate fancy-indexed selections [(block_ref, indices), ...]."""
    pieces = []
    for ref, idx in parts:
        block = ray_tpu_torch.get(ref)
        pieces.append(block.take_rows(np.asarray(idx)))
    return Block.concat(pieces)


@ray_tpu_torch.remote
def _write_parquet_task(source: Source, ops: List[Op], path: str) -> int:
    import pyarrow.parquet as pq

    block = source() if callable(source) else source
    for op in ops:
        block = op(block)
    pq.write_table(block.to_arrow(), path)
    return block.num_rows


@ray_tpu_torch.remote
def _write_csv_task(source: Source, ops: List[Op], path: str) -> int:
    import pyarrow.csv as pacsv

    block = source() if callable(source) else source
    for op in ops:
        block = op(block)
    pacsv.write_csv(block.to_arrow(), path)
    return block.num_rows


@ray_tpu_torch.remote
def _write_json_task(source: Source, ops: List[Op], path: str) -> int:
    """JSON-lines, one object per row (reference: data write_json emits
    pandas-style JSONL files)."""
    import json as _json

    block = source() if callable(source) else source
    for op in ops:
        block = op(block)
    def cell(v):
        if isinstance(v, np.ndarray):
            return v.tolist()  # tensor column: serialize as a nested list
        return v.item() if hasattr(v, "item") else v

    cols = block.to_numpy()
    names = list(cols)
    with open(path, "w") as f:
        for i in builtins.range(block.num_rows):
            f.write(_json.dumps({k: cell(cols[k][i]) for k in names}) + "\n")
    return block.num_rows


@ray_tpu_torch.remote
def _zip_spans(left_spans: List[tuple], right_spans: List[tuple]) -> Block:
    """Column-wise join of two row-aligned span lists.  Duplicate column
    names from the right side get a _1 suffix (reference: dataset.py zip
    disambiguates with suffixes)."""
    def gather(spans):
        return Block.concat([
            ray_tpu_torch.get(r).slice(lo, hi) for r, lo, hi in spans
        ])

    left, right = gather(left_spans), gather(right_spans)
    lcols, rcols = left.to_numpy(), right.to_numpy()
    out = dict(lcols)
    for k, v in rcols.items():
        name, i = k, 1
        while name in out:  # probe _1, _2, ... until free — never overwrite
            name = f"{k}_{i}"
            i += 1
        out[name] = v
    return Block.from_batch(out)


class ActorPoolStrategy:
    """Compute strategy for stateful map_batches UDFs: a fixed pool of
    actors each instantiating the UDF class once and reusing it across
    blocks (reference: data/_internal/execution/operators/
    actor_pool_map_operator.py — essential for accelerator-resident or
    expensive-to-construct preprocessing state)."""

    def __init__(self, size: int = 2, *, num_cpus: float = 1.0,
                 max_tasks_in_flight_per_actor: int = 2):
        assert size >= 1
        self.size = size
        self.num_cpus = num_cpus
        self.max_tasks_in_flight_per_actor = max_tasks_in_flight_per_actor


# Worker/actor-process-global cache of stateful UDF instances, keyed by the
# op's uid: one instance per op per actor process, living as long as the
# pool actor does (the reference's _MapWorker holds the callable the same
# way).
_UDF_INSTANCES: Dict[str, Any] = {}


class _StatefulBatchOp:
    """A picklable op wrapping a callable-class UDF.  Executed inside a pool
    actor; the instance is constructed on first use and cached process-wide
    under the op uid."""

    def __init__(self, fn_cls, ctor_args, ctor_kwargs, batch_format: str,
                 fn_kwargs: Optional[dict], pool: ActorPoolStrategy):
        import uuid as _uuid

        self.fn_cls = fn_cls
        self.ctor_args = tuple(ctor_args or ())
        self.ctor_kwargs = dict(ctor_kwargs or {})
        self.batch_format = batch_format
        self.fn_kwargs = fn_kwargs or {}
        self.pool = pool  # executor routes chains containing this op
        self.uid = _uuid.uuid4().hex

    def __call__(self, block: Block) -> Block:
        inst = _UDF_INSTANCES.get(self.uid)
        if inst is None:
            inst = _UDF_INSTANCES[self.uid] = self.fn_cls(
                *self.ctor_args, **self.ctor_kwargs
            )
        return _apply_batch_fn(inst, block, self.batch_format,
                               self.fn_kwargs)


@ray_tpu_torch.remote
class _PoolWorker:
    """One actor of an ActorPoolStrategy pool: executes whole part chains
    so stateful ops hit this process's UDF instance cache."""

    def exec_part(self, source: Source, ops: List[Op]) -> Block:
        return _exec_part_body(source, ops)

    def ping(self) -> bool:
        return True


class _PoolManager:
    """Per-execution actor pools: created lazily on first routed chain,
    round-robin dispatch, torn down after every routed task completed
    (killing earlier would kill queued tasks)."""

    def __init__(self):
        self._pools: Dict[int, List[Any]] = {}
        self._rr: Dict[int, int] = {}
        self._routed_refs: List[Any] = []

    @staticmethod
    def pool_of(ops: List[Op]) -> Optional[ActorPoolStrategy]:
        for op in ops:
            pool = getattr(op, "pool", None)
            if pool is not None:
                return pool
        return None

    def submit(self, source: Source, ops: List[Op],
               pool: ActorPoolStrategy):
        key = id(pool)
        actors = self._pools.get(key)
        if actors is None:
            actors = self._pools[key] = [
                _PoolWorker.options(num_cpus=pool.num_cpus).remote()
                for _ in builtins.range(pool.size)
            ]
            self._rr[key] = 0
        i = self._rr[key]
        self._rr[key] = (i + 1) % len(actors)
        ref = actors[i].exec_part.remote(source, ops)
        # Track only still-running work (so shutdown won't kill actors with
        # queued tasks) and prune completed refs eagerly: holding a ref pins
        # the block in the store, which would defeat backpressure.
        if self._routed_refs:
            ready, _ = ray_tpu_torch.wait(self._routed_refs,
                                    num_returns=len(self._routed_refs),
                                    timeout=0)
            done = set(r.binary() for r in ready)
            self._routed_refs = [r for r in self._routed_refs
                                 if r.binary() not in done]
        self._routed_refs.append(ref)
        return ref

    def shutdown(self):
        if not self._pools:
            return
        try:
            # Wait until every routed task completed before killing its
            # actor.  No hard deadline — a slow UDF keeps its pool alive —
            # but a stall (no completions for 600s straight) aborts.
            while self._routed_refs:
                n_before = len(self._routed_refs)
                ready, rest = ray_tpu_torch.wait(
                    self._routed_refs, num_returns=n_before, timeout=600
                )
                self._routed_refs = list(rest)
                if self._routed_refs and len(ready) == 0:
                    import sys as _sys

                    print("ray_tpu_torch.data: pool shutdown stalled 600s with "
                          f"{len(self._routed_refs)} tasks in flight; "
                          "killing pool actors", file=_sys.stderr)
                    break
        finally:
            for actors in self._pools.values():
                for a in actors:
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:
                        pass
            self._pools.clear()
            self._routed_refs = []


def _object_sizes(refs: List[Any]) -> List[Optional[int]]:
    """Sealed sizes (None while running) via the head's object table."""
    from ray_tpu_torch.core.context import ctx

    try:
        reply = ctx.client.call(
            "object_sizes",
            {"object_ids": [r.binary() for r in refs]},
        )
        return reply["sizes"]
    except Exception:
        return [None] * len(refs)


def _apply_batch_fn(fn, block: Block, batch_format: str,
                    kwargs: dict) -> Block:
    if batch_format == "numpy":
        out = fn(block.to_numpy(), **kwargs)
    elif batch_format == "pandas":
        out = fn(block.to_pandas(), **kwargs)
    elif batch_format == "pyarrow":
        out = fn(block.to_arrow(), **kwargs)
    else:
        raise ValueError(f"unknown batch_format {batch_format!r}")
    return _coerce_batch_out(out)


def _coerce_batch_out(out) -> Block:
    if isinstance(out, Block):
        return out
    if isinstance(out, dict):
        return Block.from_batch(out)
    try:
        import pandas as pd

        if isinstance(out, pd.DataFrame):
            return Block.from_batch(
                {c: out[c].to_numpy() for c in out.columns}
            )
    except ImportError:
        pass
    try:
        import pyarrow as pa
    except ImportError:
        pa = None
    if pa is not None and isinstance(out, pa.Table):
        return Block.from_arrow(out)
    raise TypeError(
        f"map_batches fn must return dict/DataFrame/Table, got {type(out)}"
    )


def _batch_op(fn, batch_format: str, fn_kwargs: Optional[dict]) -> Op:
    kwargs = fn_kwargs or {}

    def op(block: Block) -> Block:
        return _apply_batch_fn(fn, block, batch_format, kwargs)

    return op


class Dataset:
    """Lazy, immutable dataset of blocks distributed over the cluster."""

    def __init__(self, parts: List[tuple],
                 counts: Optional[List[int]] = None,
                 total_rows: Optional[int] = None,
                 logical=None):
        self._parts = parts  # [(source, [op, ...]), ...]
        self._counts = counts  # per-part row counts, when known
        # Total row count when per-part counts are unknown but the total is
        # invariant (sort/shuffle exchanges preserve it).
        self._total_rows = (sum(counts) if counts is not None
                            else total_rows)
        # The inspectable plan description (reference: logical_plan.py);
        # optimize() fires fusion/pushdown rules over it (logical.py).
        self._logical = logical if logical is not None else LogicalPlan()
        # Per-operator rows from the last materialize() of/into this
        # dataset (None until then) — lets stats() report that run
        # instead of re-executing the plan.
        self._materialized_stats: Optional[List[Dict[str, Any]]] = None

    # ---------------------------------------------------------- transforms

    def _with_op(self, op: Op, lop=None) -> "Dataset":
        if lop is None:
            lop = LogicalOp("map", _op_name(op))
        return Dataset([(src, ops + [op]) for src, ops in self._parts],
                       logical=self._logical.appended(lop))

    def _plan_parts(self) -> List[tuple]:
        """Parts safe for direct stateless-task submission.  A chain with an
        ActorPoolStrategy op must run on its pool (instance reuse, sizing),
        so such plans materialize through the pool-routed executor first."""
        if any(_PoolManager.pool_of(ops) is not None
               for _, ops in self._parts):
            return self.materialize()._parts
        return self._parts

    def map_batches(
        self,
        fn: Callable[..., Union[Batch, Any]],
        *,
        batch_format: str = "numpy",
        fn_kwargs: Optional[dict] = None,
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[dict] = None,
        batch_size: Optional[int] = None,  # accepted for API parity; the
        # whole block is one batch (tasks already bound block sizes)
    ) -> "Dataset":
        """Apply fn to batches (reference: dataset.py map_batches:383).

        With ``compute=ActorPoolStrategy(size=n)`` and a callable-class
        ``fn``, each pool actor constructs the UDF once and reuses it
        across blocks — the stateful-UDF path (reference:
        actor_pool_map_operator.py)."""
        if compute is not None:
            if not isinstance(fn, type):
                raise TypeError(
                    "compute=ActorPoolStrategy requires a callable CLASS "
                    "(constructed once per pool actor); got "
                    f"{type(fn).__name__}"
                )
            sop = _StatefulBatchOp(
                fn, fn_constructor_args, fn_constructor_kwargs,
                batch_format, fn_kwargs, compute,
            )
            return self._with_op(sop, LogicalOp(
                "map_batches", _op_name(sop),
                {"compute": f"ActorPool({compute.size})"}))
        if isinstance(fn, type):
            # Task path: one driver-side instance shipped to tasks.
            fname = fn.__name__
            fn = fn(*fn_constructor_args, **(fn_constructor_kwargs or {}))
        else:
            fname = getattr(fn, "__name__", type(fn).__name__)
        return self._with_op(
            _TimedOp(f"MapBatches({fname})",
                     _batch_op(fn, batch_format, fn_kwargs)),
            LogicalOp("map_batches", f"MapBatches({fname})"))

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        def op(block: Block) -> Block:
            return Block.from_items([fn(row) for row in block.rows()])

        name = f"Map({getattr(fn, '__name__', 'fn')})"
        return self._with_op(_TimedOp(name, op), LogicalOp("map", name))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        def op(block: Block) -> Block:
            rows: List[Dict] = []
            for row in block.rows():
                rows.extend(fn(row))
            return Block.from_items(rows) if rows else Block({})

        name = f"FlatMap({getattr(fn, '__name__', 'fn')})"
        return self._with_op(_TimedOp(name, op),
                             LogicalOp("flat_map", name))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        def op(block: Block) -> Block:
            batch = block.to_numpy()
            keep = np.fromiter(
                (bool(fn(row)) for row in block.rows()), dtype=bool,
                count=block.num_rows,
            )
            return Block({k: v[keep] for k, v in batch.items()})

        name = f"Filter({getattr(fn, '__name__', 'fn')})"
        return self._with_op(_TimedOp(name, op), LogicalOp("filter", name))

    def _try_read_pushdown(self, **updates) -> Optional["Dataset"]:
        """Fold a projection/limit into the read sources when every part is
        a bare pushdown-capable _ReadTask (reference: the logical rules in
        logical/rules/ rewrite Read ops the same way).  Returns the new
        parts list, or None when pushdown does not apply."""
        if not self._parts:
            return None
        for src, ops in self._parts:
            if ops or not isinstance(src, _ReadTask):
                return None
            if ("columns" in updates
                    and src.kind not in _ReadTask.SUPPORTS_COLUMNS):
                return None
            if "columns" in updates and src.columns is not None:
                return None  # already pruned: chain the op instead
        new_parts = []
        for src, _ in self._parts:
            ns = _ReadTask(src.kind, src.files,
                           updates.get("columns", src.columns),
                           updates.get("limit", src.limit),
                           src.reader_kwargs)
            new_parts.append((ns, []))
        return new_parts

    def select_columns(self, columns: Sequence[str]) -> "Dataset":
        cols = list(columns)
        pushed = self._try_read_pushdown(columns=cols)
        if pushed is not None:
            # Column pruning folds into the parquet read itself: pruned
            # columns are never decoded, and the logical plan records the
            # rewritten Read (the optimizer's ReadPushdown rule output).
            lop = LogicalOp("project", "Project", {"columns": cols})
            return Dataset(pushed, self._counts, self._total_rows,
                           logical=self._logical.appended(lop))
        return self._with_op(
            _TimedOp("Project", lambda b: b.select(cols)),
            LogicalOp("project", "Project", {"columns": cols}))

    def add_column(self, name: str, fn: Callable[[Batch], np.ndarray]) -> "Dataset":
        def op(block: Block) -> Block:
            batch = block.to_numpy()
            batch[name] = np.asarray(fn(batch))
            return Block.from_batch(batch)

        return self._with_op(_TimedOp(f"AddColumn({name})", op),
                             LogicalOp("add_column", f"AddColumn({name})"))

    def drop_columns(self, columns: Sequence[str]) -> "Dataset":
        drop = set(columns)

        def op(block: Block) -> Block:
            return block.select([c for c in block.columns() if c not in drop])

        return self._with_op(
            _TimedOp("DropColumns", op),
            LogicalOp("drop_column", "DropColumns",
                      {"columns": sorted(drop)}))

    # ------------------------------------------------------- reorganization

    def repartition(self, num_blocks: int) -> "Dataset":
        """Rebalance into exactly num_blocks equal-ish blocks (reference:
        dataset.py repartition:1042).  Materializes, then one gather task
        per output block pulls just the row spans it needs."""
        refs, counts = self._materialize_refs()
        total = sum(counts)
        bounds = [total * i // num_blocks for i in builtins.range(num_blocks + 1)]
        # Prefix sums map global row ranges onto (block, local range) spans.
        starts = np.cumsum([0] + counts)
        parts: List[tuple] = []
        out_counts: List[int] = []
        for j in builtins.range(num_blocks):
            lo, hi = bounds[j], bounds[j + 1]
            spans = []
            for i, ref in enumerate(refs):
                blo, bhi = starts[i], starts[i + 1]
                s, e = max(lo, blo), min(hi, bhi)
                if s < e:
                    spans.append((ref, int(s - blo), int(e - blo)))
            parts.append((_gather_spans.remote(spans), []))
            out_counts.append(hi - lo)
        return Dataset(parts, out_counts)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Global row shuffle as a two-stage partition/merge exchange
        (reference: all-to-all shuffle in
        data/_internal/planner/exchange/shuffle_task_spec.py).  Stage 1:
        one task per input block assigns each row to a uniformly random
        output bucket (num_returns fan-out — no driver-side permutation,
        no global gather).  Stage 2: one task per output block concats its
        bucket from every input and permutes locally.  Peak task state is
        one block, so this survives datasets no single worker could hold."""
        refs, counts = self._materialize_refs()
        n_out = max(len(refs), 1)
        if seed is not None:
            base = seed
        else:
            import os as _os

            base = int.from_bytes(_os.urandom(8), "little")
        if n_out == 1:
            return Dataset(
                [(_shuffle_merge.remote(refs, (base, 1, 0)), [])],
                [sum(counts)],
            )
        part_lists = [
            _shuffle_partition.options(num_returns=n_out).remote(
                ref, n_out, (base, 0, i))
            for i, ref in enumerate(refs)
        ]
        parts: List[tuple] = []
        for j in builtins.range(n_out):
            bucket = [pl[j] for pl in part_lists]
            parts.append((_shuffle_merge.remote(bucket, (base, 1, j)), []))
        return Dataset(parts, total_rows=sum(counts))

    def join(self, other: "Dataset", on: str, how: str = "inner",
             *, num_partitions: Optional[int] = None,
             suffix: str = "_r") -> "Dataset":
        """Key-based join as a hash-partition/merge exchange (reference:
        Dataset.join — distributed hash join; the exchange shape matches
        planner/exchange/: stage 1 hash-routes each input block's rows
        with a num_returns fan-out, stage 2 joins one partition per task,
        so no worker ever holds either full dataset).

        ``how``: "inner" or "left".  Right-side columns colliding with
        left names (other than the key) get ``suffix``.  Key hashing uses
        a content digest, not Python hash() (which is salted per worker
        process)."""
        if how not in ("inner", "left"):
            raise ValueError(f"unsupported join how={how!r}")
        left_refs = list(self._iter_block_refs())
        right_refs = list(other._iter_block_refs())
        n_out = num_partitions or max(len(left_refs), len(right_refs), 1)
        lschema_ref = _np_schema.remote(left_refs)
        rschema_ref = _np_schema.remote(right_refs)

        def scatter(refs):
            if n_out == 1:
                return [list(refs)]
            lists = [
                _hash_partition.options(num_returns=n_out).remote(
                    r, on, n_out)
                for r in refs
            ]
            return [[pl[j] for pl in lists]
                    for j in builtins.range(n_out)]

        left_parts = scatter(left_refs)
        right_parts = scatter(right_refs)
        lschema, rschema = ray_tpu_torch.get([lschema_ref, rschema_ref])
        parts = [
            (_hash_join_partition.remote(
                left_parts[j], right_parts[j], on, how, suffix,
                lschema, rschema), [])
            for j in builtins.range(n_out)
        ]
        return Dataset(
            parts,
            logical=self._logical.appended(LogicalOp(
                "exchange", f"HashJoin[{how}]",
                {"on": on, "partitions": n_out})),
        )

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Total order by one column via a sample -> range-partition ->
        per-range sort exchange (reference:
        planner/exchange/sort_task_spec.py): boundary values come from
        per-block samples, every input block splits itself into ranges
        (num_returns fan-out), and each output task sorts ONE range — no
        task ever holds the whole dataset."""
        refs, counts = self._materialize_refs()
        n_out = len(refs)
        if n_out <= 1:
            return Dataset(
                [(_sort_range.remote(refs, key, descending), [])],
                [sum(counts)],
            )
        samples = ray_tpu_torch.get(
            [_sample_column.remote(r, key, 32) for r in refs]
        )
        allsamp = np.sort(np.concatenate(
            [s for s in samples if len(s)] or [np.empty(0)]
        ))
        if len(allsamp) == 0:
            return Dataset(
                [(_sort_range.remote(refs, key, descending), [])],
                [sum(counts)],
            )
        bounds = [
            allsamp[len(allsamp) * j // n_out]
            for j in builtins.range(1, n_out)
        ]
        part_lists = [
            _range_partition.options(num_returns=n_out).remote(
                r, key, bounds)
            for r in refs
        ]
        order = builtins.range(n_out)
        if descending:
            order = reversed(order)  # highest range first
        parts = [
            (_sort_range.remote([pl[j] for pl in part_lists], key,
                                descending), [])
            for j in order
        ]
        return Dataset(parts, total_rows=sum(counts))

    def union(self, other: "Dataset") -> "Dataset":
        return Dataset(self._parts + other._parts)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise join of two row-aligned datasets (reference:
        dataset.py zip — counts must match; right-side duplicate column
        names get a _1 suffix).  Output partitioning follows self's blocks;
        right spans covering each left block are gathered per task."""
        lrefs, lcounts = self._materialize_refs()
        rrefs, rcounts = other._materialize_refs()
        if sum(lcounts) != sum(rcounts):
            raise ValueError(
                f"zip requires equal row counts "
                f"({sum(lcounts)} != {sum(rcounts)})"
            )

        def spans_for(lo: int, hi: int) -> List[tuple]:
            """Right-side spans covering global rows [lo, hi)."""
            out, pos = [], 0
            for ref, cnt in builtins.zip(rrefs, rcounts):
                start, end = pos, pos + cnt
                pos = end
                if end <= lo or start >= hi:
                    continue
                out.append((ref, max(lo - start, 0), min(hi, end) - start))
            return out

        parts, pos = [], 0
        for ref, cnt in builtins.zip(lrefs, lcounts):
            parts.append((
                _zip_spans.remote([(ref, 0, cnt)], spans_for(pos, pos + cnt)),
                [],
            ))
            pos += cnt
        return Dataset(parts, list(lcounts))

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference: dataset.py random_sample).
        Seeded runs are reproducible for the same dataset; unseeded runs
        draw a fresh base seed per call."""
        if seed is not None:
            base = seed
        else:
            import os as _os

            base = int.from_bytes(_os.urandom(8), "little")

        def op(block: Block) -> Block:
            import zlib

            n = block.num_rows
            if n == 0:
                return block
            # Distinct stream per block: fold in a content fingerprint
            # (first/last row of the first column) so equal-sized blocks
            # don't replay identical in-block positions.
            cols = block.to_numpy()
            fp = 0
            if cols:
                first = next(iter(cols.values()))
                fp = zlib.crc32(
                    np.ascontiguousarray(first[:1]).tobytes()
                    + np.ascontiguousarray(first[-1:]).tobytes()
                )
            rng = np.random.default_rng((base, n, fp))
            return block.take_rows(np.flatnonzero(rng.random(n) < fraction))

        return self._with_op(op)

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column, computed as per-block partials on
        the cluster (reference: dataset.py unique — only each block's
        distinct set travels to the driver)."""
        partials = [p for p in ray_tpu_torch.get(
            [_part_agg.remote(src, ops, column, "unique")
             for src, ops in self._plan_parts()]
        ) if p is not None]
        seen: set = set()
        for vals, _ in partials:
            seen.update(vals)
        return sorted(seen)

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None) -> List["Dataset"]:
        """Split into (train, test) datasets (reference: dataset.py
        train_test_split)."""
        if not 0 < test_size < 1:
            raise ValueError("test_size must be in (0, 1)")
        ds = self.random_shuffle(seed=seed) if shuffle else self
        refs, counts = ds._materialize_refs()
        total = sum(counts)
        n_test = int(total * test_size)
        n_train = total - n_test
        train = Dataset([(r, []) for r in refs], counts).limit(n_train)
        # Tail rows: skip n_train, keep the rest.
        tail_parts, pos = [], 0
        tail_counts = []
        for ref, cnt in builtins.zip(refs, counts):
            start, end = pos, pos + cnt
            pos = end
            if end <= n_train:
                continue
            lo = max(n_train - start, 0)
            tail_parts.append((_gather_spans.remote([(ref, lo, cnt)]), []))
            tail_counts.append(cnt - lo)
        return [train, Dataset(tail_parts, tail_counts)]

    def limit(self, k: int) -> "Dataset":
        """First k rows (streams only as many parts as needed).  On a bare
        file-read plan the limit pushes into the read itself first (each
        part stops opening files once it has k rows), so a limit over a
        large dataset never materializes whole blocks."""
        lop = LogicalOp("limit", "Limit", {"n": k})
        src_ds = self
        pushed = self._try_read_pushdown(limit=k)
        if pushed is not None:
            src_ds = Dataset(pushed, logical=self._logical.appended(lop))
        else:
            src_ds = Dataset(self._parts, self._counts, self._total_rows,
                             logical=self._logical.appended(lop))
        taken: List[tuple] = []
        counts: List[int] = []
        remaining = k
        for ref in src_ds._iter_block_refs():
            if remaining <= 0:
                break
            block = ray_tpu_torch.get(ref)
            n = block.num_rows
            if n <= remaining:
                taken.append((ref, []))
                counts.append(n)
                remaining -= n
            else:
                taken.append((ray_tpu_torch.put(block.slice(0, remaining)), []))
                counts.append(remaining)
                remaining = 0
        return Dataset(taken, counts, logical=src_ds._logical)

    # ------------------------------------------------------------ execution

    def _iter_block_refs(self, window: Optional[int] = None,
                         timed_sink: Optional[List] = None) -> Iterator[Any]:
        """Launch part tasks with a bounded in-flight window, yielding block
        refs in plan order (the pull-based streaming executor: the consumer's
        pace bounds cluster work — reference: streaming_executor.py:48).

        Backpressure is two-dimensional (reference:
        execution/backpressure_policy/ + resource_manager.py):
        - task count: never more than ``execution_window`` parts in flight;
        - bytes: the window adapts down to keep (in-flight blocks x learned
          block size) under ``DataContext.max_in_flight_bytes``.  Sizing
          uses a HIGH PERCENTILE (p90) of recently observed block sizes,
          not the mean — a mixed dataset (small metadata blocks, then
          large image blocks) would overshoot the budget several-fold
          while a mean caught up.  Sizes come from sealed objects via the
          head's object table (no fetches), probed every submission until
          the sample is warm.
        Chains containing an ActorPoolStrategy op route to that pool's
        actors instead of stateless tasks."""
        cfg = DataContext.get_current()
        max_win = window or cfg.execution_window
        budget = cfg.max_in_flight_bytes
        min_win = max(1, cfg.min_execution_window)
        stats = {"peak_in_flight": 0, "submitted": 0,
                 "effective_window_min": max_win}
        cfg.last_execution_stats = stats
        pools = _PoolManager()
        seen_ids: set = set()
        recent_sizes: deque = deque(maxlen=64)  # sliding sample window
        warm_after = 8
        try:
            pending: deque = deque()
            for src, ops in self._parts:
                eff = max_win
                if budget and recent_sizes:
                    ordered = sorted(recent_sizes)
                    # Nearest-rank p90 (rounds toward the max for small
                    # samples — conservative means under-budget, never
                    # over).
                    p90 = ordered[min(len(ordered) - 1,
                                      int(0.9 * len(ordered)))]
                    if p90 > 0:
                        eff = max(min_win,
                                  min(max_win, int(budget // p90)))
                stats["effective_window_min"] = min(
                    stats["effective_window_min"], eff)
                while len(pending) >= eff:
                    yield pending.popleft()
                pool = _PoolManager.pool_of(ops)
                if pool is not None:
                    ref = pools.submit(src, ops, pool)
                elif not ops and not callable(src):
                    ref = src  # already-materialized block: no task needed
                elif timed_sink is not None:
                    # Opportunistic per-operator timing (materialize):
                    # same chain, block + timing rows as two returns.
                    # Pool-routed and pre-materialized parts above carry
                    # no timings (documented in stats()).
                    ref, t_ref = _exec_part_timed.options(
                        num_returns=2).remote(src, ops)
                    timed_sink.append(t_ref)
                else:
                    ref = _exec_part.remote(src, ops)
                pending.append(ref)
                stats["submitted"] += 1
                stats["peak_in_flight"] = max(stats["peak_in_flight"],
                                              len(pending))
                # Probe every submission until the sample is warm (a cold
                # mean/percentile is what lets mixed sizes overshoot),
                # then every 4th.
                if budget and (len(recent_sizes) < warm_after
                               or stats["submitted"] % 4 == 0):
                    probe = [r for r in pending
                             if r.binary() not in seen_ids]
                    if probe:
                        # Key by id bytes, NOT the ref: holding refs here
                        # would pin every probed block in the store.
                        for r, sz in zip(probe, _object_sizes(probe)):
                            if sz:
                                seen_ids.add(r.binary())
                                recent_sizes.append(sz)
            while pending:
                yield pending.popleft()
        finally:
            pools.shutdown()

    def iter_blocks(self) -> Iterator[Block]:
        for ref in self._iter_block_refs():
            yield ray_tpu_torch.get(ref)

    def _materialize_refs(self, timed_sink: Optional[List] = None) -> tuple:
        refs = list(self._iter_block_refs(timed_sink=timed_sink))
        if self._counts is not None and builtins.all(
            not ops and not callable(src) for src, ops in self._parts
        ):
            return refs, list(self._counts)
        counts = ray_tpu_torch.get(
            [_part_rows.remote(ref, []) for ref in refs]
        )
        return refs, counts

    def materialize(self) -> "Dataset":
        """Execute the plan; the result holds materialized block refs
        (reference: dataset.py materialize:4622).  Per-operator timings
        are collected opportunistically during this run (the timed
        executor's second return) and stashed on both this dataset and
        the result, so a following ``stats()`` reports THIS execution
        instead of profiling a second one."""
        sink: List = []
        refs, counts = self._materialize_refs(timed_sink=sink)
        stats = None
        if sink:
            try:
                stats = _aggregate_op_rows(ray_tpu_torch.get(sink))
            except Exception:
                stats = None  # timing is best-effort, never fails the run
        out = Dataset([(r, []) for r in refs], counts,
                      logical=self._logical)
        self._materialized_stats = stats
        out._materialized_stats = stats
        return out

    # --------------------------------------------------------- plan insight

    def explain(self) -> str:
        """The logical plan, its optimized form, and the rules that fired
        (reference: logical/optimizers.py — LogicalOptimizer rule list)."""
        optimized, fired = self._logical.optimize()
        lines = ["-- logical plan --", self._logical.describe(),
                 "-- optimized (physical stages) --", optimized.describe()]
        if fired:
            lines += ["-- rules fired --"] + [f"  {r}" for r in fired]
        lines.append(f"-- execution: {len(self._parts)} block(s), "
                     "fused chain = one task per block --")
        return "\n".join(lines)

    def stats(self) -> Dict[str, Any]:
        """Per-operator rows/wall breakdown plus the optimized stage list
        (reference: dataset.py stats:4790 returns per-operator
        wall/rows/output sizes).

        If this dataset ran (or came out of) ``materialize()``, the
        breakdown is that run's opportunistically collected timings —
        no extra work.  OTHERWISE THIS METHOD EXECUTES THE WHOLE PLAN
        once more in a profiled pass: side-effecting UDFs run AGAIN and
        large reads decode AGAIN.  Call ``materialize()`` first when that
        matters.  (Pool-routed chains also materialize through their
        actor pool before profiling, so their breakdown collapses to the
        materialized source.)"""
        operators = self._materialized_stats
        source = "last_materialize"
        if operators is None:
            source = "profiled_pass"
            timing_refs = [
                _exec_part_timed.options(num_returns=2).remote(src, ops)[1]
                for src, ops in self._plan_parts()
            ]
            operators = _aggregate_op_rows(ray_tpu_torch.get(timing_refs))
        optimized, fired = self._logical.optimize()
        return {
            "operators": operators,
            "operators_source": source,
            "num_blocks": len(self._parts),
            # Map chains execute inside ONE task per block — the physical
            # realization of the fusion rule.
            "tasks_per_block": 1,
            "optimized_stages": [op.describe() for op in optimized.ops],
            "rules_fired": fired,
            "last_execution": dict(
                DataContext.get_current().last_execution_stats),
        }

    # ---------------------------------------------------------- consumption

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_blocks: int = 2,
        device: Any = None,
    ) -> Iterator[Any]:
        """Stream batches (reference: dataset.py iter_batches:3675).  With
        ``device=`` each batch is copied to that device one batch ahead of
        consumption (``iterator.device_prefetch``: pinned staging, a side
        CUDA stream); ``device=True`` is the current CUDA device and
        ``device="cpu"`` yields CPU tensors."""
        from .iterator import batches_from_blocks, device_prefetch

        def blocks() -> Iterator[Block]:
            refs: deque = deque()
            it = self._iter_block_refs()
            for ref in it:
                refs.append(ref)
                if len(refs) > prefetch_blocks:
                    yield ray_tpu_torch.get(refs.popleft())
            while refs:
                yield ray_tpu_torch.get(refs.popleft())

        batch_size = batch_size or DataContext.get_current().default_batch_size
        out = batches_from_blocks(
            blocks(), batch_size, batch_format, drop_last
        )
        if device is not None:
            out = device_prefetch(out, device)
        return out

    def iter_torch_batches(self, *, batch_size: Optional[int] = None,
                           drop_last: bool = False) -> Iterator[Dict]:
        """CPU-torch batches (reference: dataset.py iter_torch_batches:3746)."""
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}

    def iter_rows(self) -> Iterator[Dict]:
        for block in self.iter_blocks():
            yield from block.rows()

    def take(self, k: int = 20) -> List[Dict]:
        out: List[Dict] = []
        for block in self.iter_blocks():
            for row in block.rows():
                out.append(row)
                if len(out) >= k:
                    return out
        return out

    def take_all(self) -> List[Dict]:
        out: List[Dict] = []
        for block in self.iter_blocks():
            out.extend(block.rows())
        return out

    def count(self) -> int:
        if self._counts is not None:
            return sum(self._counts)
        if self._total_rows is not None:
            return self._total_rows
        return sum(ray_tpu_torch.get(
            [_part_rows.remote(src, ops)
             for src, ops in self._plan_parts()]
        ))

    def schema(self) -> Dict[str, str]:
        for block in self.iter_blocks():
            if block.num_rows:
                return block.schema()
        return {}

    def columns(self) -> List[str]:
        return list(self.schema())

    def _agg(self, col: str, kind: str):
        partials = [p for p in ray_tpu_torch.get(
            [_part_agg.remote(src, ops, col, kind)
             for src, ops in self._plan_parts()]
        ) if p is not None]
        if not partials:
            return None
        vals = [v for v, _ in partials]
        if kind == "sum":
            return sum(vals)
        return min(vals) if kind == "min" else max(vals)

    def show(self, limit: int = 20) -> None:
        """Print the first ``limit`` rows (reference: dataset.py show)."""
        for row in self.take(limit):
            print(row)

    def to_pandas(self, limit: Optional[int] = None):
        """Materialize into one pandas DataFrame (reference: dataset.py
        to_pandas — caps at a row limit to protect the driver)."""
        import pandas as pd

        ds = self.limit(limit) if limit is not None else self
        frames = [
            pd.DataFrame(block.to_numpy())
            for block in ds.iter_blocks() if block.num_rows
        ]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def std(self, col: str, ddof: int = 1):
        """Column standard deviation via per-part (sum, sumsq, n) partials
        (reference: dataset.py std — the same Welford-free formulation)."""
        partials = [p for p in ray_tpu_torch.get(
            [_part_agg.remote(src, ops, col, "sumsq")
             for src, ops in self._plan_parts()]
        ) if p is not None]
        if not partials:
            return None
        s = sum(v for (v, _), _ in partials)
        ss = sum(v for (_, v), _ in partials)
        n = sum(c for _, c in partials)
        if n <= ddof:
            return None
        var = (ss - s * s / n) / (n - ddof)
        return float(np.sqrt(max(var, 0.0)))

    def sum(self, col: str):
        return self._agg(col, "sum")

    def min(self, col: str):
        return self._agg(col, "min")

    def max(self, col: str):
        return self._agg(col, "max")

    def mean(self, col: str):
        partials = [p for p in ray_tpu_torch.get(
            [_part_agg.remote(src, ops, col, "sum")
             for src, ops in self._plan_parts()]
        ) if p is not None]
        total = sum(v for v, _ in partials)
        n = sum(c for _, c in partials)
        return total / n if n else None

    def groupby(self, key: str) -> "GroupedDataset":
        """Group rows by a key column (reference: dataset.py groupby:1822 ->
        grouped_data.py aggregations).  Per-block partial aggregates run as
        tasks; the driver combines per key."""
        return GroupedDataset(self, key)

    # ------------------------------------------------------------- splitting

    def split(self, n: int) -> List["Dataset"]:
        """Materialize and split into n disjoint datasets, blocks assigned
        round-robin (reference: dataset.py split:1337)."""
        refs, counts = self._materialize_refs()
        out = []
        for i in builtins.range(n):
            mine = [(refs[j], []) for j in builtins.range(i, len(refs), n)]
            mine_counts = [counts[j] for j in builtins.range(i, len(refs), n)]
            out.append(Dataset(mine, mine_counts))
        return out

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List["DataIterator"]:
        """n coordinated iterators over disjoint streams of this dataset —
        the Train ingest path (reference: output_splitter.py OutputSplitter,
        dataset.py streaming_split).  `equal`/`locality_hints` accepted for
        API parity; blocks are handed out round-robin on demand."""
        from .split import make_split_iterators

        return make_split_iterators(self, n)

    # ---------------------------------------------------------------- output

    def write_parquet(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        ray_tpu_torch.get([
            _write_parquet_task.remote(
                src, ops, os.path.join(path, f"part-{i:05d}.parquet")
            )
            for i, (src, ops) in enumerate(self._plan_parts())
        ])

    def write_csv(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        ray_tpu_torch.get([
            _write_csv_task.remote(
                src, ops, os.path.join(path, f"part-{i:05d}.csv")
            )
            for i, (src, ops) in enumerate(self._plan_parts())
        ])

    def write_json(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        ray_tpu_torch.get([
            _write_json_task.remote(
                src, ops, os.path.join(path, f"part-{i:05d}.json")
            )
            for i, (src, ops) in enumerate(self._plan_parts())
        ])

    def num_blocks(self) -> int:
        return len(self._parts)

    def __repr__(self) -> str:
        return (
            f"Dataset(num_blocks={len(self._parts)}, "
            f"count={sum(self._counts) if self._counts is not None else '?'})"
        )


# ------------------------------------------------------------------ sources


def from_items(items: Sequence[Any], *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    n = override_num_blocks or min(
        DataContext.get_current().default_num_blocks, max(len(items), 1)
    )
    parts = []
    counts = []
    for i in builtins.range(n):
        chunk = items[len(items) * i // n: len(items) * (i + 1) // n]
        if not chunk:
            continue
        parts.append((functools.partial(Block.from_items, list(chunk)), []))
        counts.append(len(chunk))
    return Dataset(parts, counts)


def range(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:
    nb = override_num_blocks or DataContext.get_current().default_num_blocks

    def make(lo: int, hi: int) -> Block:
        return Block({"id": np.arange(lo, hi, dtype=np.int64)})

    parts = []
    counts = []
    for i in builtins.range(nb):
        lo, hi = n * i // nb, n * (i + 1) // nb
        if lo < hi:
            parts.append((functools.partial(make, lo, hi), []))
            counts.append(hi - lo)
    return Dataset(parts, counts)


def range_tensor(n: int, *, shape: Sequence[int] = (1,),
                 override_num_blocks: Optional[int] = None) -> Dataset:
    nb = override_num_blocks or DataContext.get_current().default_num_blocks
    shape = tuple(shape)

    def make(lo: int, hi: int) -> Block:
        ids = np.arange(lo, hi, dtype=np.int64)
        data = np.broadcast_to(
            ids.reshape((-1,) + (1,) * len(shape)), (hi - lo,) + shape
        ).copy()
        return Block({"data": data})

    parts = []
    counts = []
    for i in builtins.range(nb):
        lo, hi = n * i // nb, n * (i + 1) // nb
        if lo < hi:
            parts.append((functools.partial(make, lo, hi), []))
            counts.append(hi - lo)
    return Dataset(parts, counts)


def from_numpy(arr: np.ndarray, column: str = "data", *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    nb = override_num_blocks or DataContext.get_current().default_num_blocks
    parts = []
    counts = []
    for i in builtins.range(nb):
        lo, hi = len(arr) * i // nb, len(arr) * (i + 1) // nb
        if lo < hi:
            chunk = arr[lo:hi].copy()
            parts.append((functools.partial(Block.from_batch, {column: chunk}), []))
            counts.append(hi - lo)
    return Dataset(parts, counts)


def from_arrow(table) -> Dataset:
    return Dataset([(functools.partial(Block.from_arrow, table), [])],
                   [table.num_rows])


def from_pandas(df) -> Dataset:
    return Dataset(
        [(functools.partial(
            Block.from_batch, {c: df[c].to_numpy() for c in df.columns}), [])],
        [len(df)],
    )


def _expand_paths(paths: Union[str, Sequence[str]], suffixes) -> List[str]:
    import os

    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if f.endswith(suffixes)
            )
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files under {paths}")
    return out


def _read_image_file(f: str, *, size: Optional[tuple] = None,
                     mode: str = "RGB",
                     include_paths: bool = False) -> Block:
    from PIL import Image

    with Image.open(f) as im:
        im = im.convert(mode)
        if size is not None:
            im = im.resize((size[1], size[0]))  # PIL takes (w, h)
        arr = np.asarray(im, dtype=np.uint8)
    cols = {"image": arr[None]}
    if include_paths:
        cols["path"] = np.array([f], dtype=object)
    return Block.from_batch(cols)


def _read_source(kind: str, files: List[str],
                 override_num_blocks: Optional[int],
                 columns: Optional[List[str]] = None,
                 reader_kwargs=None) -> Dataset:
    """One read task per file (reference: read_api.py splits files across
    read tasks; per-file granularity is the common case).  Sources are
    _ReadTask objects so projection/limit pushdown can rewrite them."""
    n = override_num_blocks or len(files)
    n = min(n, len(files))
    parts = []
    for i in builtins.range(n):
        chunk = files[len(files) * i // n: len(files) * (i + 1) // n]
        if chunk:
            parts.append((_ReadTask(kind, chunk, columns,
                                    reader_kwargs=reader_kwargs), []))
    lop = LogicalOp("read", f"Read{kind.capitalize()}", {
        "files": len(files), "columns": columns,
        "supports_columns": kind in _ReadTask.SUPPORTS_COLUMNS,
        "supports_limit": True,
    })
    return Dataset(parts, logical=LogicalPlan([lop]))


def read_parquet(paths, *, override_num_blocks: Optional[int] = None,
                 columns: Optional[List[str]] = None) -> Dataset:
    return _read_source(
        "parquet", _expand_paths(paths, (".parquet",)),
        override_num_blocks, columns,
    )


def read_csv(paths, *, override_num_blocks: Optional[int] = None) -> Dataset:
    return _read_source(
        "csv", _expand_paths(paths, (".csv",)), override_num_blocks
    )


def read_json(paths, *, override_num_blocks: Optional[int] = None) -> Dataset:
    return _read_source(
        "json", _expand_paths(paths, (".json", ".jsonl")),
        override_num_blocks
    )


def read_images(paths, *, size: Optional[tuple] = None, mode: str = "RGB",
                include_paths: bool = False,
                override_num_blocks: Optional[int] = None) -> Dataset:
    """Image files -> blocks with an "image" uint8 tensor column
    (reference: data/read_api.py read_images / datasource ImageDatasource).
    ``size=(h, w)`` resizes so the column has a uniform tensor shape —
    required when source images vary (the batch format is dense numpy)."""
    return _read_source(
        "images",
        _expand_paths(paths, (".png", ".jpg", ".jpeg", ".bmp", ".gif")),
        override_num_blocks,
        reader_kwargs={"size": size, "mode": mode,
                       "include_paths": include_paths},
    )
