"""RT012: deadline/backoff contract drift.

``core/deadline.py`` is THE retry shape: every retry/reconnect loop
backs off on one jittered curve (:class:`BackoffPolicy`) and bounds
itself with a monotonic budget (:class:`Deadline`).  Drift away from it
re-introduces exactly the pathologies the module was built to kill —
synchronized redial storms after a head restart, loops that never give
up, and "infinite" sentinel timeouts that turn a hung peer into a hung
caller.

Findings:

- **hand-rolled retry curve** — ``time.sleep(expr)`` inside a loop
  where the delay is computed from the attempt counter (the loop
  variable or an ``x += 1``-style counter) in a function that never
  touches a ``BackoffPolicy``.  The curve exists; use it — it caps,
  jitters, and clips to the deadline.
- **unbounded re-dial loop** — ``while True`` + ``except: sleep``
  where the handler neither re-raises nor breaks and the function has
  no Deadline/budget reference: a permanently-down peer spins this loop
  forever.
- **sentinel timeout** — ``timeout=<huge constant>`` (>= 1e6 s)
  smuggled through an API that accepts ``None`` for "no timeout": the
  constant lies to every reader and survives unit conversions wrong.

A legitimately-infinite wait (a stream read paced by its producer) is
vetted with a trailing ``# rt-deadline-ok: <reason>``.

``--json`` meta names the loop site and the missing primitive so the
fix is mechanical.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from .astutil import (call_name, dotted_name, iter_functions, parent_map,
                      walk_own_body, _line_annotation)
from .rtlint import Finding, Project

_DEADLINE_OK_RE = re.compile(r"#\s*rt-deadline-ok:\s*(.+?)\s*$")

_LOOPS = (ast.For, ast.While, ast.AsyncFor)
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: names whose presence marks the function as on-contract.
_POLICY_MARKS = frozenset({"BackoffPolicy", "call_policy",
                           "reconnect_policy", "backoff"})
_DEADLINE_MARKS = frozenset({"Deadline", "deadline", "expired",
                             "remaining", "budget"})

_SENTINEL_S = 1e6  # anything "longer than a CI run" is a lie, not a bound


def _marks(fn: ast.AST) -> Set[str]:
    """Identifier tails referenced anywhere in the function body (nested
    defs included: retry helpers close over the policy)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def _has_policy(fn: ast.AST) -> bool:
    m = _marks(fn)
    return bool(m & _POLICY_MARKS) \
        or any("policy" in name.lower() for name in m)


def _has_deadline(fn: ast.AST) -> bool:
    m = _marks(fn)
    if m & _DEADLINE_MARKS:
        return True
    return any("deadline" in name.lower() for name in m)


def _aug_counters(fn: ast.AST) -> Set[str]:
    """Names stepped with ``x += ...`` (attempt counters)."""
    return {node.target.id for node in walk_own_body(fn)
            if isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Name)}


def _loop_vars(loop: ast.AST) -> Set[str]:
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        return {n.id for n in ast.walk(loop.target)
                if isinstance(n, ast.Name)}
    return set()


def _enclosing_loop(node: ast.AST, pmap, fn) -> Optional[ast.AST]:
    cur = pmap.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, _LOOPS):
            return cur
        if isinstance(cur, _FUNC_NODES):
            return None
        cur = pmap.get(cur)
    return None


def _is_while_true(loop: ast.AST) -> bool:
    return isinstance(loop, ast.While) \
        and isinstance(loop.test, ast.Constant) \
        and bool(loop.test.value)


def check_rt012(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        pmap = parent_map(mod.tree)
        for fn in iter_functions(mod.tree):
            # Only top-level walk per function: nested defs get their own
            # iteration.
            has_policy = None  # lazy: _marks walks the whole body
            has_deadline = None
            counters = None
            for node in walk_own_body(fn):
                if isinstance(node, ast.Call) \
                        and call_name(node) == "time.sleep" and node.args:
                    loop = _enclosing_loop(node, pmap, fn)
                    if loop is None:
                        continue
                    arg = node.args[0]
                    if isinstance(arg, ast.Constant):
                        continue  # constant-interval poll, not a curve
                    if counters is None:
                        counters = _aug_counters(fn)
                    curve_names = _loop_vars(loop) | counters
                    refs = {n.id for n in ast.walk(arg)
                            if isinstance(n, ast.Name)}
                    if not refs & curve_names:
                        continue
                    if has_policy is None:
                        has_policy = _has_policy(fn)
                    if has_policy:
                        continue
                    if _line_annotation(mod, node.lineno, _DEADLINE_OK_RE):
                        continue
                    out.append(Finding(
                        "RT012", mod.rel, node.lineno,
                        f"hand-rolled retry curve in {fn.name!r}: "
                        "time.sleep() computed from the attempt counter "
                        "instead of core.deadline.BackoffPolicy — the "
                        "shared curve caps, jitters, and clips to the "
                        "caller's Deadline",
                        meta={"kind": "retry_curve",
                              "loop_line": loop.lineno,
                              "missing": "BackoffPolicy"}))
                elif isinstance(node, ast.Try):
                    f = _check_redial(mod, fn, pmap, node)
                    if f is not None:
                        if has_deadline is None:
                            has_deadline = _has_deadline(fn)
                        if not has_deadline:
                            out.append(f)
                elif isinstance(node, ast.Call):
                    out.extend(_check_sentinel(mod, node))
    return sorted(out, key=lambda f: (f.path, f.line))


def _check_redial(mod, fn, pmap, trynode: ast.Try) -> Optional[Finding]:
    """``while True`` wrapping try/except whose handler sleeps and never
    exits the loop: an unbounded re-dial."""
    loop = _enclosing_loop(trynode, pmap, fn)
    if loop is None or not _is_while_true(loop):
        return None
    for handler in trynode.handlers:
        sleeps = [n for n in ast.walk(ast.Module(body=handler.body,
                                                 type_ignores=[]))
                  if isinstance(n, ast.Call)
                  and call_name(n) == "time.sleep"]
        if not sleeps:
            continue
        exits = any(isinstance(n, (ast.Raise, ast.Return, ast.Break))
                    for s in handler.body for n in ast.walk(s))
        if exits:
            continue
        if _line_annotation(mod, sleeps[0].lineno, _DEADLINE_OK_RE):
            continue
        return Finding(
            "RT012", mod.rel, sleeps[0].lineno,
            f"unbounded re-dial loop in {fn.name!r}: while True + "
            "swallow-and-sleep with no Deadline — a permanently-down "
            "peer spins this forever; bound it with "
            "core.deadline.Deadline (raise when .expired)",
            meta={"kind": "unbounded_redial", "loop_line": loop.lineno,
                  "missing": "Deadline"})
    return None


def _check_sentinel(mod, call: ast.Call) -> List[Finding]:
    out: List[Finding] = []
    for kw in call.keywords:
        if kw.arg is None or not kw.arg.startswith("timeout"):
            continue
        huge = _huge_const(kw.value)
        if huge is None:
            continue
        if _line_annotation(mod, kw.value.lineno, _DEADLINE_OK_RE):
            continue
        out.append(Finding(
            "RT012", mod.rel, kw.value.lineno,
            f"sentinel timeout {kw.arg}={huge:g}: an 'infinite' constant "
            "masquerading as a bound — pass timeout=None (and plumb "
            "Optional[float]) when the wait is genuinely unbounded, or a "
            "real Deadline-derived budget when it is not",
            meta={"kind": "sentinel_timeout", "value": huge,
                  "keyword": kw.arg}))
    return out


def _huge_const(node: ast.AST) -> Optional[float]:
    """A numeric constant >= the sentinel threshold anywhere in the
    timeout expression (covers ``1e9 if x < 0 else x + 30``)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) \
                and isinstance(n.value, (int, float)) \
                and not isinstance(n.value, bool) \
                and float(n.value) >= _SENTINEL_S:
            return float(n.value)
    return None
