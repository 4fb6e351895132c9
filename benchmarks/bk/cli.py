"""One run of one cell, from a resolved cell to the result object.  The
mix's ``kind`` picks the driver; ``run.py`` wraps this with the checks of
the machine, and the tests call it on the CPU at tiny sizes."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

from bk import result, spec

DRIVERS = {"open_loop": "bk.serve", "closed_loop": "bk.serve"}


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device, t_start: float, control: bool = False,
            root: Path = spec.ROOT) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    import importlib

    driver = importlib.import_module(DRIVERS[cell.kind])
    out = driver.run(cell, seed, seconds, traced, device, t_start,
                     control=control)
    notes = dict(out["notes"], readings=out["readings"])
    if out["trace"] is not None:
        notes["trace"] = {"ops": len(out["trace"].ops),
                          "stop_s": out["trace"].stop_s}
    if out.get("control"):
        notes["control"] = out["control"]
    return result.line(cell, out, traced, device, root), notes
