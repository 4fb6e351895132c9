"""RT005: undaemonized threads without a join path.

A non-daemon thread with no ``join()`` keeps the interpreter alive after
``main`` returns — in a worker that's a hung process the head must
health-check-reap; in the driver it's a script that never exits.  Either
mark the thread ``daemon=True`` (it holds no state that must flush) or
keep a reachable join path (then the non-daemon flag is the point:
exit waits for the flush).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .astutil import assigned_target, call_name, parent_map
from .rtlint import Finding, Project

THREAD_CALLS = {"threading.Thread", "Thread"}


def _module_join_info(tree) -> Tuple[Set[str], Dict[str, str]]:
    """(terminal names `.join()`/`.daemon = True` is applied to,
    alias map  alias_terminal -> source_terminal from `t = self.x`)."""
    handled: Set[str] = set()
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join":
            name = call_name(node)
            if name:
                parts = name.split(".")
                if len(parts) >= 2:
                    handled.add(parts[-2])
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            t, v = node.targets[0], node.value
            # x.daemon = True
            if isinstance(t, ast.Attribute) and t.attr == "daemon" \
                    and isinstance(v, ast.Constant) and v.value is True:
                base = t.value
                term = (base.attr if isinstance(base, ast.Attribute)
                        else base.id if isinstance(base, ast.Name) else None)
                if term:
                    handled.add(term)
            # t = self._pending  (alias for a later t.join())
            elif isinstance(t, ast.Name) and isinstance(
                    v, (ast.Name, ast.Attribute)):
                src = (v.attr if isinstance(v, ast.Attribute) else v.id)
                aliases[t.id] = src
    return handled, aliases


def _daemon_kw(call: ast.Call) -> Optional[bool]:
    for kw in call.keywords:
        if kw.arg == "daemon":
            if isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
            return True  # dynamic daemon= — assume deliberate
    return None


def check_rt005(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for module in project.modules:
        parents = parent_map(module.tree)
        handled, aliases = _module_join_info(module.tree)
        # Resolve one level of aliasing: `t = self._x; t.join()` covers _x.
        joined = set(handled)
        for alias in handled:
            if alias in aliases:
                joined.add(aliases[alias])
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) \
                    or call_name(node) not in THREAD_CALLS:
                continue
            if _daemon_kw(node):
                continue
            # daemon missing (or explicitly False): require a join path.
            target = assigned_target(node, parents)
            if target is not None and target in joined:
                continue
            out.append(Finding(
                    "RT005", module.rel, node.lineno,
                    "threading.Thread without daemon=True and no visible "
                    "join path — a leaked non-daemon thread hangs "
                    "interpreter exit; set daemon=True or join it",
                ))
    return out
