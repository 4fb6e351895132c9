"""From a driver's output to the contract's last line.

- ``--trace 0``: the cell's end-to-end metrics, ``setup_s`` among them.
- ``--trace 1``: the cell's per-layer metrics, each from its reader in
  ``layer_metrics/`` (a reader that finds nothing returns None and the
  metric is left out), the device's busy and window seconds, and the
  breakdown of device time and idle gaps.

``checks`` comes last: every number ``correct`` compared, with its limit
(``limits/<cell>.json``).  The same lines end standard error.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from bk import spec, trace as tr, yardstick


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads.  ``ops``: the traced window's device
    operations as (name, start, end) wall-clock seconds, ``t0``/``t1`` the
    window; ``spans`` and ``steps`` the program's request spans and engine
    step records; ``gaps`` the clients' inter-token gaps (seconds) whose
    later token arrived in the window; ``family`` the configuration's
    family file (its attention shapes and FLOP counts)."""

    kind: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    ops: List[tr.Op]
    t0: float
    t1: float
    spans: List[Dict[str, Any]]
    steps: List[Dict[str, Any]]
    gaps: List[float] = dataclasses.field(default_factory=list)
    family: Any = None
    yardstick: Any = yardstick
    trace: Any = tr


def limits(cell: str, root: Path = spec.ROOT) -> Dict[str, float]:
    with open(root / "benchmarks" / "limits" / f"{cell}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def judge(readings: Dict[str, float], lim: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number with its limit (a missing one reads None and
    fails)."""
    return {k: {"value": readings.get(k), "limit": v}
            for k, v in lim.items()}


def layer_metrics(cell: spec.Cell, out: Dict[str, Any],
                  root: Path = spec.ROOT) -> Dict[str, Dict[str, Any]]:
    trace = out["trace"]
    li = out["layer_input"]
    run = Run(kind=li["kind"], config=cell.config, mix=cell.mix,
              ops=trace.ops if trace else [],
              t0=trace.t0 if trace else 0.0, t1=trace.t1 if trace else 0.0,
              spans=li.get("spans", []), steps=li.get("steps", []),
              gaps=li.get("gaps", []), family=cell.family)
    res = {}
    for m in cell.per_layer:
        value = spec.layer_reader(m["name"], root)(run)
        if value is not None:
            res[m["name"]] = {"value": value, "unit": m["unit"]}
    return res


def line(cell: spec.Cell, out: Dict[str, Any], traced: bool, device,
         root: Path = spec.ROOT) -> Dict[str, Any]:
    """The result object, ``checks`` last."""
    import torch

    lim = limits(cell.name, root)
    checks = judge(out["readings"], lim)
    correct = (out["attempted"] > 0 and out["failed"] == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if traced:
        metrics = layer_metrics(cell, out, root)
    else:
        values = dict(out["metrics"], setup_s=out["setup_s"])
        metrics = {k: {"value": values[k], "unit": u}
                   for k, u in units.items()}
    cuda = device.type == "cuda"
    dev: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    res: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": out["attempted"],
                           "failed": out["failed"], "metrics": metrics,
                           "device": dev}
    if traced:
        t = out["trace"]
        dev["busy_s"] = tr.busy_s(t.ops, t.t0, t.t1) if t else 0.0
        dev["window_s"] = t.window_s if t else 0.0
        res["breakdown"] = tr.breakdown(t)
    res["checks"] = checks
    bad = [k for k, m in metrics.items() if not math.isfinite(m["value"])]
    if bad:
        raise RuntimeError(f"metrics {bad} are not finite: {metrics}")
    return res


def emit(res: Dict[str, Any], notes: Optional[Dict[str, Any]] = None
         ) -> None:
    """Notes and checks to standard error (checks last), then the line."""
    if notes:
        print("notes " + json.dumps(notes), file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
