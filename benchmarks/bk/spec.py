"""Everything the harness knows about a cell, found by name.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix; the files live under ``benchmarks/``:

- ``configs/<config>.json``: the model configuration as it is run; its
  ``family`` key names the two files of its model family;
- ``families/<family>.py``: what the harness knows of one architecture:
  the port's model classes and how the configuration's ``port`` keys
  become their config, the weight leaves of the globals and of layer i,
  each layer's attention shape, the parameter and prefill FLOP counts,
  and the check of ``port`` against the published ``config``;
- ``reference/<family>.py``: the family's plain reference, ``logits_at``
  in plain torch, which the family file imports as ``reference``;
- ``traffic/<mix>.json``: one traffic mix, read by the one generator of
  its ``kind`` (``bk/traffic.py``);
- ``layer_metrics/<metric>.py``: one reader per per-layer metric.

A new cell, configuration, family, mix or per-layer metric is new files
and new entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    family: ModuleType

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its
    configuration, mix and metrics loaded."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[w["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmarks" / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        family=family(config["family"], root))


def _load(path: Path, what: str) -> ModuleType:
    """The module in ``path``, loaded by path (``what`` names it in the
    error when the file is missing)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {what}: {path} does not exist")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_"
        + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def family(name: str, root: Path = ROOT) -> ModuleType:
    """``benchmarks/families/<name>.py`` (its plain reference is the
    module it imports as ``reference``)."""
    return _load(root / "benchmarks" / "families" / f"{name}.py",
                 f"model family {name!r}")


def layer_reader(metric: str, root: Path = ROOT
                 ) -> Callable[[Any], Optional[float]]:
    """``read(run)`` of ``benchmarks/layer_metrics/<metric>.py``."""
    return _load(root / "benchmarks" / "layer_metrics" / f"{metric}.py",
                 f"reader of {metric!r}").read
