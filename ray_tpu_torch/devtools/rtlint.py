"""rtlint: framework-aware static analysis for the ray_tpu_torch control plane.

Generic linters can't know that ``core/head.py`` is a single asyncio loop
whose handlers must never block, that every ``client.call("m")`` string
must have an ``h_m`` handler and (when mutating) a ``schema.REQUIRED``
row, or that ``ray_tpu_*`` metric names must match the catalog in
``util/metrics.py``.  rtlint does — it walks the package with ``ast``
(nothing is imported or executed) and enforces:

======  =====================================================================
RT001   blocking call (``time.sleep``, ``subprocess.*``, socket
        recv/sendall, sync ``rpc.call``, file reads, ``shutil.rmtree``)
        inside an ``async def`` — stalls the whole control plane
RT002   ``threading`` lock held across an ``await`` (with-block containing
        ``await`` under a lock) — cross-thread deadlock / loop stall
RT003   RPC drift: client-called method without an ``h_*`` handler in
        head/node, mutating client method without a ``schema.REQUIRED``
        row, schema row without a handler, handler nothing calls
RT004   ``ray_tpu_torch.get()`` inside a remote function body (nested-get
        deadlock risk) and closure captures in nested remote functions
        (re-shipped on every submission)
RT005   ``threading.Thread`` started without ``daemon=True`` or a visible
        join path — leaks non-daemon threads that hang interpreter exit
RT006   ``ray_tpu_*`` metric emitted but missing from (or conflicting
        with) the ``BUILTIN_METRICS`` catalog in ``util/metrics.py``
RT007   guarded-by race over ``core/``: a ``self.<attr>`` written from two
        or more inferred thread roles (loop / rpc callbacks / executors /
        named threads / main) with no lock in common across access paths;
        also verifies declared ``_RT_GUARDED_BY`` maps (the runtime race
        sentinel enforces the same maps under ``RT_DEBUG_LOCKS=2``)
RT008   static lock-order cycle: nested ``with lock:`` scopes composed
        through the call graph nest in both orders — a deadlock the test
        suite merely never interleaved
RT009   spawn-env contract drift: ad-hoc ``RT_*`` ``os.environ`` reads vs
        the ``SPAWN_ENV_CONTRACT`` catalog in ``core/config.py``
        (missing/stale/orphan-write, plus reads shadowing Config fields)
RT010   torch hot-path host syncs: ``.item()`` / ``.tolist()`` /
        ``.cpu()`` / ``float()`` / ``np.asarray`` /
        ``torch.cuda.synchronize()`` on the outputs of the registered
        programs (the ``jitguard``-counted paged programs and learner
        updates) inside the step loops — vetted per-line with
        ``# rt-sync-ok: <reason>``; the runtime half is the
        ``RT_DEBUG_JIT=1`` recompile sentinel (``devtools.jitguard``)
RT011   resource-lifecycle leaks over the declared acquire/release pair
        catalog (page alloc/free, adapter pin/release, prefix claims,
        scheduler leases): leaks on normal and exception exits, double
        releases, releases of never-acquired names — ownership
        transfers annotated ``# rt-owns: <pair>``
RT012   deadline-contract drift: hand-rolled retry curves instead of
        ``core.deadline.BackoffPolicy``, unbounded ``while True``
        re-dial loops with no ``Deadline``, and sentinel
        ``timeout=1e9``-style constants — vetted per-line with
        ``# rt-deadline-ok: <reason>``
======  =====================================================================

Vetted exceptions live in ``ray_tpu_torch/.rtlint-allowlist`` (shipped as
package data; one
``RULE path[:line]  # reason`` per line; the reason is mandatory).  The
pytest gate ``tests/test_torch_rtlint.py::test_package_lint_clean`` runs
this over the tree, so unallowlisted findings fail CI.

Usage::

    python -m ray_tpu_torch lint [--json] [--root DIR] [--allowlist FILE]
"""

from __future__ import annotations

import ast
import fnmatch
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Finding:
    rule: str
    path: str  # posix path relative to the package parent (repo-relative)
    line: int
    message: str
    #: structured context for --json consumers (dashboard lint view,
    #: future tooling): RT007 carries the inferred thread roles and guard
    #: locks behind the race, RT008 the lock cycle and its edge sites,
    #: RT009 the env key and drift kind — the WHY, not just the where.
    meta: Optional[dict] = None

    def key(self) -> tuple:
        return (self.rule, self.path, self.line, self.message)

    def as_dict(self) -> dict:
        out = {"rule": self.rule, "path": self.path, "line": self.line,
               "message": self.message}
        if self.meta is not None:
            out["meta"] = self.meta
        return out


class Module:
    def __init__(self, path: Path, rel: str, source: str, tree: ast.Module):
        self.path = path
        self.rel = rel  # e.g. "ray_tpu_torch/core/head.py"
        self.source = source
        self.tree = tree


class Project:
    """Parsed view of one package tree.  ``package_root`` is the package
    directory itself (the directory containing ``core/``); reported paths
    are prefixed with its name so findings read repo-relative."""

    def __init__(self, package_root: Path):
        self.package_root = Path(package_root)
        self.modules: List[Module] = []
        self.parse_errors: List[Finding] = []
        prefix = self.package_root.name
        for path in sorted(self.package_root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = f"{prefix}/{path.relative_to(self.package_root).as_posix()}"
            try:
                source = path.read_text()
                tree = ast.parse(source, filename=str(path))
            except (SyntaxError, UnicodeDecodeError) as e:
                line = getattr(e, "lineno", 0) or 0
                self.parse_errors.append(
                    Finding("RT000", rel, line, f"unparseable module: {e}")
                )
                continue
            self.modules.append(Module(path, rel, source, tree))

    def find(self, suffix: str) -> Optional[Module]:
        """Module whose repo-relative path ends with ``suffix`` (e.g.
        ``core/client.py``) — layout-independent so rules work over both
        the real package and synthetic test trees."""
        for m in self.modules:
            if m.rel.endswith(suffix):
                return m
        return None


# -- allowlist -----------------------------------------------------------------


@dataclass
class AllowEntry:
    rule: str
    pattern: str  # fnmatch pattern over the finding's repo-relative path
    line: Optional[int]
    reason: str
    lineno: int  # where in the allowlist file
    hits: int = 0

    def matches(self, f: Finding) -> bool:
        return (
            self.rule == f.rule
            and fnmatch.fnmatch(f.path, self.pattern)
            and (self.line is None or self.line == f.line)
        )


def load_allowlist(path: Path) -> Tuple[List[AllowEntry], List[Finding]]:
    """Parse ``RULE path[:line]  # reason`` lines.  Malformed entries (and
    entries with no reason — every exception must be justified) surface as
    findings so they can't silently disable a rule."""
    entries: List[AllowEntry] = []
    problems: List[Finding] = []
    rel = path.name
    if not path.exists():
        return entries, problems
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        body, _, reason = line.partition("#")
        reason = reason.strip()
        parts = body.split()
        if len(parts) != 2 or not parts[0].startswith("RT"):
            problems.append(Finding(
                "ALLOWLIST", rel, lineno,
                f"malformed entry {line!r} (expected 'RTnnn path[:line]"
                f"  # reason')"))
            continue
        if not reason:
            problems.append(Finding(
                "ALLOWLIST", rel, lineno,
                f"entry {body.strip()!r} has no '# reason' — every "
                "allowlisted exception must be justified"))
            continue
        rule, target = parts
        pat, sep, ln = target.rpartition(":")
        entry_line: Optional[int] = None
        if sep and ln.isdigit():
            entry_line = int(ln)
        else:
            pat = target
        entries.append(AllowEntry(rule, pat, entry_line, reason, lineno))
    return entries, problems


def apply_allowlist(
    findings: List[Finding], entries: List[AllowEntry], allow_name: str
) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed); stale entries that matched
    nothing come back as kept ALLOWLIST findings — the allowlist must
    shrink when the code it excuses is fixed."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        entry = next((e for e in entries if e.matches(f)), None)
        if entry is not None:
            entry.hits += 1
            suppressed.append(f)
        else:
            kept.append(f)
    for e in entries:
        if e.hits == 0:
            kept.append(Finding(
                "ALLOWLIST", allow_name, e.lineno,
                f"stale entry '{e.rule} {e.pattern}"
                f"{':%d' % e.line if e.line else ''}' matched no finding — "
                "remove it"))
    return kept, suppressed


# -- engine --------------------------------------------------------------------


def all_rules():
    from . import (rules_api, rules_async, rules_concurrency, rules_config,
                   rules_deadline, rules_metrics, rules_resources,
                   rules_rpc, rules_threads, rules_torch)

    return [
        rules_async.check_rt001,
        rules_async.check_rt002,
        rules_rpc.check_rt003,
        rules_api.check_rt004,
        rules_threads.check_rt005,
        rules_metrics.check_rt006,
        rules_concurrency.check_rt007,
        rules_concurrency.check_rt008,
        rules_config.check_rt009,
        rules_torch.check_rt010,
        rules_resources.check_rt011,
        rules_deadline.check_rt012,
    ]


def run_lint(
    package_root: Path,
    allowlist_path: Optional[Path] = None,
    rules=None,
) -> Tuple[List[Finding], List[Finding]]:
    """Lint a package tree.  Returns ``(kept, suppressed)`` — kept findings
    (including allowlist problems) mean failure."""
    project = Project(Path(package_root))
    findings: List[Finding] = list(project.parse_errors)
    for rule in (rules if rules is not None else all_rules()):
        findings.extend(rule(project))
    findings.sort(key=Finding.key)
    entries: List[AllowEntry] = []
    problems: List[Finding] = []
    if allowlist_path is not None:
        entries, problems = load_allowlist(Path(allowlist_path))
    kept, suppressed = apply_allowlist(
        findings, entries,
        allowlist_path.name if allowlist_path is not None else "",
    )
    kept.extend(problems)
    kept.sort(key=Finding.key)
    return kept, suppressed


def default_package_root() -> Path:
    return Path(__file__).resolve().parent.parent


def default_allowlist(package_root: Path) -> Path:
    # Inside the package (shipped as package data), so the CLI works on an
    # installed wheel, not only a repo checkout.
    return Path(package_root) / ".rtlint-allowlist"


def render_table(kept: Sequence[Finding],
                 suppressed: Sequence[Finding]) -> str:
    lines: List[str] = []
    for f in kept:
        lines.append(f"{f.path}:{f.line}: {f.rule} {f.message}")
    tail = (f"{len(kept)} finding(s)"
            if kept else "rtlint: no findings")
    if suppressed:
        tail += f" ({len(suppressed)} allowlisted)"
    lines.append(tail)
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="ray_tpu_torch lint",
        description="framework-aware static analysis (rules RT001-RT012)",
    )
    ap.add_argument("--root", default=None,
                    help="package directory to lint (default: the "
                         "installed ray_tpu_torch package)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist file (default: the package's own "
                         ".rtlint-allowlist; pass /dev/null for none)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings")
    args = ap.parse_args(argv)
    root = Path(args.root) if args.root else default_package_root()
    if not root.is_dir():
        print(f"rtlint: no such package directory: {root}")
        return 2
    allow = (Path(args.allowlist) if args.allowlist
             else default_allowlist(root))
    kept, suppressed = run_lint(root, allow)
    if args.json:
        print(json.dumps({
            "findings": [f.as_dict() for f in kept],
            "suppressed": [f.as_dict() for f in suppressed],
        }, indent=1))
    else:
        print(render_table(kept, suppressed))
    return 1 if kept else 0


if __name__ == "__main__":
    raise SystemExit(main())
