"""RT011: resource-lifecycle leak detection.

The serving/scheduling planes are built on manually paired
acquire/release protocols — KV pages out of the :class:`PageAllocator`,
LoRA slot pins in the :class:`AdapterPool`, prefix-cache page claims,
scheduler slot leases.  A path that acquires and does not release does
not crash: it strands capacity until the pool is exhausted and admission
wedges (the leak shows up hours later as "engine stopped admitting").

The declared pair catalog below is checked per function,
statement-block-sensitively:

- **leak** — an acquire whose result neither escapes the function
  (returned, stored into an attribute of self/a parameter — the
  request-object ownership handoff) nor reaches any release of the same
  pair.  Intentional transfers carry ``# rt-owns: <pair>`` on the
  acquire line.
- **exception-path leak** — the release exists but only on the fall-
  through path: nothing between acquire and release is try/finally- or
  with-protected, so a raise in between strands the resource.  A
  release inside a ``finally`` or an ``except`` handler whose ``try``
  covers the acquire satisfies both exits.
- **double release** — two releases of the same value in one statement
  block with no intervening acquire/rebind (a double ``free`` corrupts
  the allocator's refcounts silently).
- **release-without-acquire** — releasing a bare local name the
  function never bound: there is nothing to release (typo or stale
  refactor).

``--json`` meta names the pair and both site lists so the dashboard
lint view can render the unbalanced protocol directly.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .astutil import dotted_name, walk_own_body, _line_annotation
from .rtlint import Finding, Project

_OWNS_RE = re.compile(r"#\s*rt-owns:\s*([A-Za-z0-9_\-]+)")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: The lifecycle catalog: method-name pairs plus a receiver hint — a
#: lowercase substring the receiver's dotted path must contain, so an
#: unrelated ``options.release()`` never matches ``adapter_pool.release``.
#: (name, acquire methods, release methods, receiver hints)
_RT_RESOURCE_PAIRS: Tuple[Tuple[str, Tuple[str, ...], Tuple[str, ...],
                                Tuple[str, ...]], ...] = (
    ("kv_pages", ("alloc",), ("free",), ("alloc",)),
    ("prefix_claim", ("claim",), ("free", "decref"), ("cache", "alloc")),
    ("adapter_pin", ("reserve", "acquire"), ("release",),
     ("adapter", "pool")),
    ("sched_slot", ("lease_slot",), ("release_slot", "revoke"),
     ("scheduler", "sched")),
    ("gpus", ("allocate_gpus",), ("free_gpus",),
     ("scheduler", "sched")),
)


class _Site:
    __slots__ = ("call", "line", "kind", "pair", "recv", "bound")

    def __init__(self, call, kind, pair, recv, bound):
        self.call = call
        self.line = call.lineno
        self.kind = kind      # "acquire" | "release"
        self.pair = pair      # pair name
        self.recv = recv      # receiver dotted name ("self.allocator")
        self.bound = bound    # name the acquire result is bound to, or None


def _match_pair(call: ast.Call) -> Optional[Tuple[str, str, str]]:
    """(pair_name, kind, receiver) when the call is a cataloged
    acquire/release, else None."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    recv = dotted_name(f.value) or ""
    low = recv.lower()
    for name, acq, rel, hints in _RT_RESOURCE_PAIRS:
        if not any(h in low for h in hints):
            continue
        if f.attr in acq:
            return (name, "acquire", recv)
        if f.attr in rel:
            return (name, "release", recv)
    return None


def _first_arg_name(call: ast.Call) -> Optional[str]:
    """Bare-name (or dotted) identity of a release's subject."""
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, (ast.List, ast.Tuple)) and len(arg.elts) == 1:
        arg = arg.elts[0]
    return dotted_name(arg)


def _stmt_of(node: ast.AST, pmap: Dict) -> Optional[ast.stmt]:
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = pmap.get(cur)
    return cur


def _enclosing(node: ast.AST, pmap: Dict, func_node: ast.AST,
               kinds) -> List[ast.AST]:
    out = []
    cur = pmap.get(node)
    while cur is not None and cur is not func_node:
        if isinstance(cur, kinds):
            out.append(cur)
        if isinstance(cur, _FUNC_NODES):
            break
        cur = pmap.get(cur)
    return out


def _is_protected_release(site: _Site, pmap, func_node) -> bool:
    """Release reached on the exception exit too: inside a ``finally``
    or an ``except`` handler."""
    cur = pmap.get(site.call)
    child = site.call
    while cur is not None and cur is not func_node:
        if isinstance(cur, ast.Try):
            if child in getattr(cur, "finalbody", []):
                return True
        if isinstance(cur, ast.ExceptHandler):
            return True
        if isinstance(cur, _FUNC_NODES):
            break
        child, cur = cur, pmap.get(cur)
    # Walk again statement-wise: the direct child tracking above only
    # sees immediate members; check all finalbody containment.
    cur = pmap.get(site.call)
    prev = site.call
    while cur is not None and cur is not func_node:
        if isinstance(cur, ast.Try) and any(
                prev is s or _contains(s, prev) for s in cur.finalbody):
            return True
        if isinstance(cur, _FUNC_NODES):
            break
        prev, cur = cur, pmap.get(cur)
    return False


def _contains(root: ast.AST, node: ast.AST) -> bool:
    return any(n is node for n in ast.walk(root))


def _escapes(site: _Site, func_node: ast.AST, pmap) -> bool:
    """Does the acquired resource's ownership leave this function by a
    sanctioned route?  (a) the acquire result is returned; (b) it is
    assigned to an attribute (``req.pages = ...`` / ``self.x = ...`` —
    the object now owns it); (c) the bound name is later returned or
    attribute-assigned."""
    parent = pmap.get(site.call)
    while parent is not None and not isinstance(parent, ast.stmt):
        if isinstance(parent, ast.Return):
            return True
        parent = pmap.get(parent)
    stmt = _stmt_of(site.call, pmap)
    if isinstance(stmt, ast.Return):
        return True
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            if isinstance(t, ast.Attribute):
                return True
            if isinstance(t, ast.Subscript):
                return True
    if site.bound is None:
        return False
    for node in walk_own_body(func_node):
        if isinstance(node, ast.Return) and node.value is not None:
            if site.bound in {n.id for n in ast.walk(node.value)
                              if isinstance(n, ast.Name)}:
                return True
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, (ast.Attribute, ast.Subscript))
                        for t in node.targets):
            if site.bound in {n.id for n in ast.walk(node.value)
                              if isinstance(n, ast.Name)}:
                return True
        # Ownership also escapes through a call handoff the analysis
        # cannot see into (self._fail(req, pages) etc.) — only when the
        # bound name is an ARGUMENT of a non-release call.
        if isinstance(node, ast.Call) and _match_pair(node) is None:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id == site.bound:
                    return True
    return False


def check_rt011(project: Project) -> List[Finding]:
    out: List[Finding] = []
    from .astutil import parent_map, iter_functions

    for mod in project.modules:
        pmap = parent_map(mod.tree)
        for fn in iter_functions(mod.tree):
            sites: List[_Site] = []
            for node in walk_own_body(fn):
                if not isinstance(node, ast.Call):
                    continue
                m = _match_pair(node)
                if m is None:
                    continue
                pair, kind, recv = m
                bound = None
                if kind == "acquire":
                    stmt = _stmt_of(node, pmap)
                    if isinstance(stmt, ast.Assign) \
                            and len(stmt.targets) == 1 \
                            and isinstance(stmt.targets[0], ast.Name):
                        bound = stmt.targets[0].id
                sites.append(_Site(node, kind, pair, recv, bound))
            if not sites:
                continue
            by_pair: Dict[str, List[_Site]] = {}
            for s in sites:
                by_pair.setdefault(s.pair, []).append(s)
            for pair, ps in sorted(by_pair.items()):
                out.extend(_check_function_pair(mod, fn, pmap, pair, ps))
    return sorted(out, key=lambda f: (f.path, f.line))


def _check_function_pair(mod, fn, pmap, pair: str,
                         sites: List[_Site]) -> List[Finding]:
    out: List[Finding] = []
    acquires = [s for s in sites if s.kind == "acquire"]
    releases = [s for s in sites if s.kind == "release"]
    meta = {
        "pair": pair,
        "acquire_sites": [s.line for s in acquires],
        "release_sites": [s.line for s in releases],
    }

    def owned(site: _Site) -> bool:
        ann = _line_annotation(mod, site.line, _OWNS_RE)
        return ann is not None and (ann == pair or ann == "*")

    for acq in acquires:
        if owned(acq) or _escapes(acq, fn, pmap):
            continue
        if not releases:
            out.append(Finding(
                "RT011", mod.rel, acq.line,
                f"resource leak: {acq.recv}.{acq.call.func.attr}() "
                f"({pair}) acquired in {fn.name!r} but no matching "
                f"release ({'/'.join(_releases_of(pair))}) on any path — "
                "release it, hand ownership off explicitly, or annotate "
                f"the transfer with # rt-owns: {pair}",
                meta=dict(meta, kind="leak")))
            continue
        # Release exists: both exits must reach one.  A with-statement
        # around the acquire is managed cleanup; a finally/except release
        # covers the raise path.
        managed = bool(_enclosing(acq.call, pmap, fn, (ast.With,
                                                       ast.AsyncWith)))
        protected = any(_is_protected_release(r, pmap, fn)
                        for r in releases)
        if managed or protected:
            continue
        # Anything between the acquire and the last release that can
        # raise strands the resource.
        last_rel = max(r.line for r in releases)
        risky = None
        for node in walk_own_body(fn):
            if isinstance(node, (ast.Call, ast.Raise)) \
                    and acq.line < getattr(node, "lineno", 0) < last_rel \
                    and node is not acq.call \
                    and all(node is not r.call for r in releases):
                risky = node
                break
        if risky is not None:
            out.append(Finding(
                "RT011", mod.rel, acq.line,
                f"exception-path leak: {acq.recv}."
                f"{acq.call.func.attr}() ({pair}) in {fn.name!r} is "
                f"released only on the fall-through path (line "
                f"{last_rel}); a raise in between (e.g. line "
                f"{risky.lineno}) strands it — move the release into a "
                "finally/with, release in the except handler, or "
                f"annotate a transfer with # rt-owns: {pair}",
                meta=dict(meta, kind="exception_path",
                          risky_line=risky.lineno)))

    # Double release: same subject, same statement block, no intervening
    # acquire or rebind.
    by_block: Dict[int, List[_Site]] = {}
    for r in releases:
        stmt = _stmt_of(r.call, pmap)
        block = pmap.get(stmt)
        by_block.setdefault(id(block), []).append(r)
    for rs in by_block.values():
        by_subject: Dict[str, List[_Site]] = {}
        for r in rs:
            subj = _first_arg_name(r.call)
            if subj:
                by_subject.setdefault(subj, []).append(r)
        for subj, group in by_subject.items():
            if len(group) < 2:
                continue
            group.sort(key=lambda s: s.line)
            first, second = group[0], group[1]
            rebound = any(
                isinstance(n, ast.Assign)
                and first.line < n.lineno < second.line
                and any(dotted_name(t) == subj for t in n.targets)
                for n in walk_own_body(fn))
            reacquired = any(a.line > first.line and a.line < second.line
                             for a in acquires)
            if not rebound and not reacquired \
                    and not owned(second):
                out.append(Finding(
                    "RT011", mod.rel, second.line,
                    f"double release: {subj!r} ({pair}) released at line "
                    f"{first.line} and again here with no re-acquire or "
                    "rebind in between — the second release corrupts the "
                    "pool's refcounts",
                    meta=dict(meta, kind="double_release", subject=subj)))

    # Release of a name this function never bound (and that isn't a
    # parameter or an attribute path): nothing to release.
    params = {a.arg for a in list(fn.args.posonlyargs) + list(fn.args.args)
              + list(fn.args.kwonlyargs)}
    if fn.args.vararg:
        params.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        params.add(fn.args.kwarg.arg)
    assigned: Set[str] = set(params)
    for node in walk_own_body(fn):
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            assigned.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                assigned.add((alias.asname or alias.name).split(".")[0])
    for r in releases:
        subj = _first_arg_name(r.call)
        if subj is None or "." in subj:
            continue
        if subj not in assigned and not owned(r):
            out.append(Finding(
                "RT011", mod.rel, r.line,
                f"release without acquire: {r.recv}."
                f"{r.call.func.attr}({subj}) in {fn.name!r} releases a "
                "name this function never bound — stale refactor or "
                "typo'd subject",
                meta=dict(meta, kind="release_without_acquire",
                          subject=subj)))
    return out


def _releases_of(pair: str) -> Tuple[str, ...]:
    for name, _acq, rel, _h in _RT_RESOURCE_PAIRS:
        if name == pair:
            return rel
    return ()
