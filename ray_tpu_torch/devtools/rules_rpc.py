"""RT003: RPC-surface drift.

The reference gets wire safety from 22 protobuf files — every RPC has one
typed schema shared by caller and callee, and a rename breaks the build.
This framework ships msgpack dicts, so the three legs of each method
(client call string, ``h_*`` handler, ``schema.REQUIRED`` row) can drift
apart silently.  RT003 reconciles them statically:

- every method the package calls must have an ``h_<method>`` handler in
  ``core/head.py``, ``core/node_main.py``, or ``core/worker_main.py``
  (the worker-plane peer servers — direct actor calls, leased task
  submission, direct-result streaming — are RPC surface like any other);
- every method ``core/client.py`` sends that can mutate head state (i.e.
  is not in its ``IDEMPOTENT_METHODS`` read set) must have a
  ``schema.REQUIRED`` row so the boundary validates it;
- no orphan schema rows (row without a handler);
- no orphan handlers (handler no code calls — dead wire surface).

Handlers on node/worker servers register outside the head's ``_validated``
wrapper, so they must validate their schema rows in-handler (mirroring
``pull_object``/``read_log``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .astutil import const_str, iter_functions, str_collection_literal
from .rtlint import Finding, Project

#: call wrappers whose FIRST argument is the wire method name.
CALL_WRAPPERS = {
    "call", "call_bg", "call_batched", "call_async", "_call", "_call_bg_raw",
}
#: call wrappers whose SECOND argument is the method (first is an address).
ADDRESSED_WRAPPERS = {"_node_call"}


def _called_methods(module) -> Dict[str, int]:
    """method name -> first call-site line in this module."""
    out: Dict[str, int] = {}
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        fname = (f.attr if isinstance(f, ast.Attribute)
                 else f.id if isinstance(f, ast.Name) else None)
        method = None
        if fname in CALL_WRAPPERS and node.args:
            method = const_str(node.args[0])
        elif fname in ADDRESSED_WRAPPERS and len(node.args) >= 2:
            method = const_str(node.args[1])
        if method is not None:
            out.setdefault(method, node.lineno)
    return out


def _handlers(module) -> Dict[str, int]:
    return {
        fn.name[2:]: fn.lineno
        for fn in iter_functions(module.tree)
        if fn.name.startswith("h_")
    }


def check_rt003(project: Project) -> List[Finding]:
    client = project.find("core/client.py")
    head = project.find("core/head.py")
    node = project.find("core/node_main.py")
    worker = project.find("core/worker_main.py")
    schema = project.find("core/schema.py")
    if client is None or head is None or schema is None:
        return []  # not a control-plane tree (synthetic single-rule runs)
    out: List[Finding] = []

    handlers: Dict[str, Tuple[str, int]] = {}
    for mod in (m for m in (head, node, worker) if m is not None):
        for name, line in _handlers(mod).items():
            handlers.setdefault(name, (mod.rel, line))

    all_calls: Dict[str, Tuple[str, int]] = {}
    for mod in project.modules:
        for method, line in _called_methods(mod).items():
            all_calls.setdefault(method, (mod.rel, line))

    idempotent: Set[str] = set(
        str_collection_literal(client.tree, "IDEMPOTENT_METHODS") or ()
    )
    schema_rows: Dict[str, int] = {}
    for stmt in schema.tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if any(isinstance(t, ast.Name) and t.id == "REQUIRED"
                   for t in targets) and isinstance(stmt.value, ast.Dict):
                for k in stmt.value.keys:
                    s = const_str(k)
                    if s is not None:
                        schema_rows[s] = k.lineno

    # Leg 1: every called method has a handler.
    for method, (rel, line) in sorted(all_calls.items()):
        if method not in handlers:
            out.append(Finding(
                "RT003", rel, line,
                f"RPC {method!r} is called but no h_{method} handler "
                "exists in core/head.py, core/node_main.py, or "
                "core/worker_main.py",
            ))

    # Leg 2: every mutating method the PACKAGE sends carries a schema row
    # (not just core/client.py's — scripts.py, worker_main.py, the metric
    # flusher and daemons speak the same wire and drift the same way).
    # Methods without a handler are already leg-1 findings; skip them here.
    for method, (rel, line) in sorted(all_calls.items()):
        if method in idempotent or method in schema_rows \
                or method not in handlers:
            continue
        out.append(Finding(
            "RT003", rel, line,
            f"mutating RPC {method!r} has no schema.REQUIRED row — the "
            "head boundary can't validate it (add the row, or add the "
            "method to IDEMPOTENT_METHODS if it is a pure read)",
        ))

    # Leg 3: no orphan schema rows.
    for method, line in sorted(schema_rows.items()):
        if method not in handlers:
            out.append(Finding(
                "RT003", schema.rel, line,
                f"schema.REQUIRED row {method!r} has no h_{method} "
                "handler — dead schema surface",
            ))

    # Leg 4: no orphan handlers (dead wire surface nothing can reach).
    for method, (rel, line) in sorted(handlers.items()):
        if method not in all_calls:
            out.append(Finding(
                "RT003", rel, line,
                f"handler h_{method} has no call site anywhere in the "
                "package — dead wire surface (remove it, or wire the "
                "caller that should use it)",
            ))
    return out
