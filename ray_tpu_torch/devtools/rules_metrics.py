"""RT006: ``ray_tpu_*`` metric-name drift.

Every built-in metric the framework emits must be declared (name and
kind) in the ``BUILTIN_METRICS`` catalog in ``util/metrics.py``.  The
catalog is what operators wire dashboards and alerts against; an emitted
name missing from it is invisible infrastructure, a catalog row nothing
emits is a dashboard panel that will never populate, and one name used
as two kinds renders a Prometheus exposition the scraper rejects.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from .astutil import const_str, str_dict_literal
from .rtlint import Finding, Project

#: constructor / memoized-getter name -> metric kind.
EMITTERS = {
    "Counter": "counter", "get_counter": "counter",
    "Gauge": "gauge", "get_gauge": "gauge",
    "Histogram": "histogram", "get_histogram": "histogram",
}
PREFIX = "ray_tpu_"


def _emitted(project: Project) -> Dict[str, List[Tuple[str, int, str]]]:
    """metric name -> [(path, line, kind), ...] across the package."""
    out: Dict[str, List[Tuple[str, int, str]]] = {}
    for module in project.modules:
        if module.rel.endswith("util/metrics.py"):
            continue  # the instrument classes themselves live here
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            fname = (f.attr if isinstance(f, ast.Attribute)
                     else f.id if isinstance(f, ast.Name) else None)
            kind = EMITTERS.get(fname or "")
            if kind is None or not node.args:
                continue
            name = const_str(node.args[0])
            if name is None or not name.startswith(PREFIX):
                continue
            out.setdefault(name, []).append((module.rel, node.lineno, kind))
    return out


def check_rt006(project: Project) -> List[Finding]:
    metrics_mod = project.find("util/metrics.py")
    if metrics_mod is None:
        return []
    out: List[Finding] = []
    catalog = str_dict_literal(metrics_mod.tree, "BUILTIN_METRICS")
    if catalog is None:
        out.append(Finding(
            "RT006", metrics_mod.rel, 1,
            "no BUILTIN_METRICS catalog ({name: kind} dict) — built-in "
            "ray_tpu_* metrics have nothing to validate against",
        ))
        return out
    emitted = _emitted(project)
    for name, sites in sorted(emitted.items()):
        rel, line, kind = sites[0]
        kinds = {k for _, _, k in sites}
        if len(kinds) > 1:
            out.append(Finding(
                "RT006", rel, line,
                f"metric {name!r} emitted as {sorted(kinds)} — one name "
                "must stick to one kind (Prometheus rejects duplicates)",
            ))
        if name not in catalog:
            out.append(Finding(
                "RT006", rel, line,
                f"metric {name!r} is not in util/metrics.py "
                "BUILTIN_METRICS — register it (name + kind) so "
                "dashboards/alerts can rely on the catalog",
            ))
        elif catalog[name] not in kinds:
            out.append(Finding(
                "RT006", rel, line,
                f"metric {name!r} emitted as {sorted(kinds)[0]} but "
                f"cataloged as {catalog[name]} in BUILTIN_METRICS",
            ))
    for name in sorted(set(catalog) - set(emitted)):
        out.append(Finding(
            "RT006", metrics_mod.rel, 1,
            f"BUILTIN_METRICS row {name!r} is emitted nowhere — stale "
            "catalog entry (remove it, or restore the emitter)",
        ))
    return out
