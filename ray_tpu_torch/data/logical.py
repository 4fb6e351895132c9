"""Logical plan + optimizer for Dataset pipelines.

Role-equivalent to the reference's logical/physical plan stack (reference:
python/ray/data/_internal/logical/interfaces/logical_plan.py,
logical/optimizers.py:36-54 LogicalOptimizer/PhysicalOptimizer rule lists —
notably OperatorFusionRule in physical_optimizer.py and column/limit
pushdown in logical/rules/).  The repo's physical executor runs one task
per block over a (source, [op, ...]) chain, so MAP FUSION is realized by
keeping fused ops in one chain (one task per block — exactly what the
reference's fusion rule produces), and READ PUSHDOWN rewrites the read
source itself (column-pruned / row-limited file reads).

The logical plan is the authoritative, inspectable description: every
Dataset transform appends a LogicalOp; optimize() applies the rule list
and records what fired; Dataset.explain() prints both plans.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

# Op kinds that are per-block row transforms — safely fusable into one task
# (reference: physical_optimizer.py OperatorFusionRule fuses Map->Map).
_FUSABLE = {"map_batches", "map", "flat_map", "filter", "project",
            "add_column", "drop_column"}


@dataclasses.dataclass
class LogicalOp:
    """One node of the (linear) logical plan."""

    kind: str                    # "read" | "map_batches" | "project" | ...
    name: str                    # display name, e.g. MapBatches(normalize)
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        extra = ""
        if self.payload:
            inner = ", ".join(f"{k}={v!r}" for k, v in self.payload.items()
                              if v is not None)
            if inner:
                extra = f" [{inner}]"
        return f"{self.name}{extra}"


class LogicalPlan:
    def __init__(self, ops: Optional[List[LogicalOp]] = None):
        self.ops: List[LogicalOp] = list(ops or [])

    def appended(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def optimize(self) -> Tuple["LogicalPlan", List[str]]:
        """Apply the rule list; returns (optimized plan, rules that fired).

        Rules (reference: logical/optimizers.py:36-54):
        - ReadPushdown: Project/Limit immediately after a pushdown-capable
          Read folds into the read op (column-pruned / row-limited files).
        - FuseMaps: adjacent per-block row transforms collapse into one
          FusedMap stage == one task per block at execution time.
        """
        ops = list(self.ops)
        fired: List[str] = []

        # -- read pushdown ---------------------------------------------------
        changed = True
        while changed:
            changed = False
            if len(ops) >= 2 and ops[0].kind == "read":
                read = ops[0]
                nxt = ops[1]
                if (nxt.kind == "project"
                        and read.payload.get("supports_columns")
                        and not read.payload.get("columns")):
                    merged = dataclasses.replace(
                        read, payload={**read.payload,
                                       "columns": nxt.payload["columns"]})
                    ops = [merged] + ops[2:]
                    fired.append(
                        f"ReadPushdown: {nxt.describe()} -> {read.name}")
                    changed = True
                elif nxt.kind == "limit" and read.payload.get(
                        "supports_limit"):
                    merged = dataclasses.replace(
                        read, payload={**read.payload,
                                       "limit": nxt.payload["n"]})
                    ops = [merged] + ops[2:]
                    fired.append(
                        f"ReadPushdown: {nxt.describe()} -> {read.name}")
                    changed = True

        # -- map fusion ------------------------------------------------------
        fused: List[LogicalOp] = []
        for op in ops:
            if (op.kind in _FUSABLE and fused
                    and fused[-1].kind in ("fused_map", *_FUSABLE)):
                prev = fused.pop()
                members = prev.payload.get("members", [prev.name])
                members = members + [op.name]
                fused.append(LogicalOp(
                    "fused_map", f"FusedMap[{' -> '.join(members)}]",
                    {"members": members, "tasks_per_block": 1}))
                if len(members) == 2:
                    fired.append(
                        f"FuseMaps: {members[0]} + {members[1]}")
                else:
                    fired[-1] = ("FuseMaps: " + " + ".join(members))
            else:
                fused.append(op)
        return LogicalPlan(fused), fired

    def describe(self) -> str:
        if not self.ops:
            return "(empty plan)"
        return "\n".join(
            ("  " * i) + ("-> " if i else "") + op.describe()
            for i, op in enumerate(self.ops)
        )
