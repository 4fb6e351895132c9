"""RT007/RT008: interprocedural concurrency analysis over ``core/``.

The reference catches this bug class with TSAN + C++ annotations
(``GUARDED_BY``, reference: src/ray/util/mutex_protected.h and the
sanitizer CI).  Here the control plane is pure Python mutated from the
head loop, the shared peer-loop thread, RPC reader callbacks, executors,
and throwaway offload threads — so rtlint rebuilds the same protection
statically on the :class:`~.astutil.ConcurrencyModel` (thread-role
inference + guard-map inference + lock composition through the call
graph):

RT007 — **guarded-by races**: a ``self.<attr>`` written from two or more
thread roles where some access path holds no lock in common with the
write.  Classes may declare ``_RT_GUARDED_BY = {"attr": "_lock_attr"}``
(verified here, enforced at runtime by ``devtools.locks`` under
``RT_DEBUG_LOCKS=2``) and vet intentional handoffs via
``_RT_UNGUARDED = {"attr": "reason"}`` or a trailing
``# rt-unguarded: reason`` comment.

RT008 — **static lock-order cycles**: ``with lock:`` scopes composed
through the call graph form an ordering digraph; any cycle is a deadlock
waiting for the right interleaving — found at lint time instead of by the
runtime sentinel happening to hit the inversion.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .astutil import ConcurrencyModel
from .rtlint import Finding, Project


def _scope(project: Project):
    """The analyzed modules: ``core/`` when the tree has one (the real
    package), else every module (synthetic rule-test trees)."""
    core = [m for m in project.modules
            if "/core/" in m.rel or m.rel.startswith("core/")]
    return core if core else list(project.modules)


def _model(project: Project) -> ConcurrencyModel:
    cached = getattr(project, "_concurrency_model", None)
    if cached is None:
        cached = project._concurrency_model = ConcurrencyModel(
            _scope(project))
    return cached


# -- RT007 ---------------------------------------------------------------------


def check_rt007(project: Project) -> List[Finding]:
    model = _model(project)
    out: List[Finding] = []
    for cls_key, attrs in sorted(model.class_accesses().items()):
        ci = model.classes.get(cls_key)
        for attr, accesses in sorted(attrs.items()):
            if attr.startswith("__"):
                continue
            if ci is not None and (attr in ci.lock_attrs
                                   or attr in ci.threadsafe_attrs):
                continue
            declared = ci.guarded_by.get(attr) if ci is not None else None
            if declared is not None:
                out.extend(_check_declared(model, ci, attr, declared,
                                           accesses))
                continue
            if ci is not None and attr in ci.unguarded:
                continue
            if any(model.unguarded_annotation(a.func.module, a.line)
                   for a in accesses):
                continue
            f = _check_inferred(model, cls_key, attr, accesses)
            if f is not None:
                out.append(f)
    # Declared guards must reference real lock attributes, and dead
    # _RT_UNGUARDED rows are stale vetting (mirror the allowlist rule).
    by_class = model.class_accesses()
    for ci in model.classes.values():
        for attr, lock_attr in sorted(ci.guarded_by.items()):
            if lock_attr not in ci.lock_attrs:
                out.append(Finding(
                    "RT007", ci.module.rel, ci.lineno,
                    f"{ci.name}._RT_GUARDED_BY maps {attr!r} to "
                    f"{lock_attr!r}, which is not a lock attribute of "
                    f"{ci.name} — the runtime sentinel cannot enforce it",
                    meta={"class": ci.name, "attr": attr,
                          "guard": lock_attr, "kind": "bad-guard"}))
        for attr in sorted(ci.unguarded):
            if attr not in by_class.get(ci.key, {}):
                out.append(Finding(
                    "RT007", ci.module.rel, ci.lineno,
                    f"{ci.name}._RT_UNGUARDED vets {attr!r} but nothing "
                    "accesses it — stale vetting, remove the entry",
                    meta={"class": ci.name, "attr": attr, "kind": "stale"}))
    return out


def _check_declared(model, ci, attr, lock_attr, accesses) -> List[Finding]:
    """Writes to a declared-guarded field must hold the declared lock —
    the static twin of the RT_DEBUG_LOCKS=2 runtime assertion."""
    lock_id = ci.lock_attrs.get(lock_attr)
    if lock_id is None:
        return []  # reported as bad-guard above
    out = []
    for a in accesses:
        if a.kind != "write" or a.func.name == "__init__":
            continue
        if lock_id in a.effective_held():
            continue
        if model.unguarded_annotation(a.func.module, a.line):
            continue
        out.append(Finding(
            "RT007", a.func.module.rel, a.line,
            f"{ci.name}.{attr} is declared guarded by {lock_attr!r} "
            f"({lock_id!r}) but this write in {a.func.qualname} "
            f"(roles: {_roles(a.func.roles)}) does not hold it",
            meta={"class": ci.name, "attr": attr, "guard": lock_id,
                  "roles": sorted(a.func.roles), "kind": "declared"}))
    return out


def _roles(roles: Set[str]) -> str:
    return "/".join(sorted(roles)) if roles else "<unreached>"


def _check_inferred(model, cls_key, attr,
                    accesses) -> Optional[Finding]:
    live = [a for a in accesses
            if a.func.name != "__init__" and a.func.roles]
    writes = [a for a in live if a.kind == "write"]
    if not writes:
        return None  # set once in __init__, read-only after publication
    roles: Set[str] = set()
    for a in live:
        roles |= a.func.roles
    if len(roles) < 2:
        return None  # single thread class: confined state
    guard = model.infer_guard(live)
    if guard is not None:
        return None  # consistently guarded
    # Find a concrete racing pair: a write and another access on distinct
    # roles with no lock in common (a write whose own function runs under
    # two roles races with itself).
    for w in writes:
        for a in live:
            pair_roles = w.func.roles | a.func.roles
            if len(pair_roles) < 2:
                continue
            if w.effective_held() & a.effective_held():
                continue
            cls = cls_key[1]
            mostly = model.infer_guard(
                [x for x in live if x is not w and x is not a])
            hint = (f"; other accesses hold {mostly!r} — guard this one too"
                    if mostly else "")
            return Finding(
                "RT007", w.func.module.rel, w.line,
                f"{cls}.{attr} is written in {w.func.qualname} (roles: "
                f"{_roles(w.func.roles)}) with no lock in common with the "
                f"access in {a.func.qualname} at line {a.line} (roles: "
                f"{_roles(a.func.roles)}) — unguarded cross-thread "
                f"state{hint}",
                meta={"class": cls, "attr": attr,
                      "roles": sorted(roles),
                      "write_roles": sorted(w.func.roles),
                      "other_roles": sorted(a.func.roles),
                      "other_line": a.line,
                      "write_held": sorted(w.effective_held()),
                      "other_held": sorted(a.effective_held()),
                      "kind": "race"})
    return None


# -- RT008 ---------------------------------------------------------------------


def check_rt008(project: Project) -> List[Finding]:
    model = _model(project)
    edges = model.lock_order_edges()
    adj: Dict[str, List[str]] = {}
    nodes: Set[str] = set()
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        nodes.update((a, b))
    out: List[Finding] = []
    # One finding per strongly-connected component: composition through
    # the call graph derives shortcut edges (A held while calling into a
    # B-then-C chain yields A->C too), so one inconsistent cluster would
    # otherwise surface as several overlapping cycles.
    for scc in _sccs(nodes, adj):
        if len(scc) < 2:
            continue
        a = sorted(scc)[0]
        nxt = next(b for b in adj.get(a, ()) if b in scc)
        path = _path({k: [v for v in vs if v in scc]
                      for k, vs in adj.items()}, nxt, a)
        # _path ends at `a`; drop it — the cycle renders its own closure.
        cycle = [a] + (path[:-1] if path else [nxt])
        rel, line = edges[(cycle[0], cycle[1])]
        sites = {f"{x} -> {y}": "%s:%d" % edges[(x, y)]
                 for x, y in zip(cycle, cycle[1:] + [cycle[0]])
                 if (x, y) in edges}
        out.append(Finding(
            "RT008", rel, line,
            "static lock-order cycle among "
            + "/".join(repr(s) for s in sorted(scc)) + ": "
            + " -> ".join(repr(c) for c in cycle + [cycle[0]])
            + " — these locks nest in both orders somewhere in the call "
            "graph (" + ", ".join(f"{k} at {v}" for k, v in sites.items())
            + "); a matching interleaving deadlocks",
            meta={"locks": sorted(scc), "cycle": cycle, "sites": sites,
                  "kind": "lock-cycle"}))
    out.sort(key=Finding.key)
    return out


def _sccs(nodes: Set[str], adj: Dict[str, List[str]]) -> List[Set[str]]:
    """Kosaraju: strongly-connected components of the ordering digraph."""
    order: List[str] = []
    seen: Set[str] = set()
    for start in sorted(nodes):
        if start in seen:
            continue
        stack = [(start, iter(adj.get(start, ())))]
        seen.add(start)
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, iter(adj.get(nxt, ()))))
                    advanced = True
                    break
            if not advanced:
                order.append(node)
                stack.pop()
    radj: Dict[str, List[str]] = {}
    for a, bs in adj.items():
        for b in bs:
            radj.setdefault(b, []).append(a)
    sccs: List[Set[str]] = []
    assigned: Set[str] = set()
    for node in reversed(order):
        if node in assigned:
            continue
        comp = {node}
        queue = [node]
        assigned.add(node)
        while queue:
            cur = queue.pop()
            for nxt in radj.get(cur, ()):
                if nxt not in assigned:
                    assigned.add(nxt)
                    comp.add(nxt)
                    queue.append(nxt)
        sccs.append(comp)
    return sccs


def _path(adj: Dict[str, List[str]], src: str,
          dst: str) -> Optional[List[str]]:
    prev: Dict[str, Optional[str]] = {src: None}
    queue = [src]
    while queue:
        cur = queue.pop(0)
        if cur == dst:
            path = []
            node: Optional[str] = cur
            while node is not None:
                path.append(node)
                node = prev[node]
            return list(reversed(path))
        for nxt in adj.get(cur, ()):
            if nxt not in prev:
                prev[nxt] = cur
                queue.append(nxt)
    return None
