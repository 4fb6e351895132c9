"""RT010: torch hot-path host syncs.

The twin of ``ray_tpu/devtools/rules_jax.py``.  A stray host sync in an
eager torch step loop shows up on the card as a flat device-utilization
valley: the host waits for the card to drain before it can queue the
next step's kernels.  rtlint finds such syncs at lint time, on the same
interprocedural substrate the concurrency rules use
(:class:`~.astutil.ConcurrencyModel`):

**Programs.**  The port has no ``jax.jit``; its step programs are the
functions the recompile sentinel (``devtools.jitguard``) counts:

- a *recorder* calls ``jitguard.bump`` (``models/paged.py``'s ``_record``);
- a *guard class* defines ``__call__`` and calls ``jitguard.bump`` or
  ``jitguard.register_program`` (``rllib/learner.py``'s ``Program``);
- a *program* calls a recorder (``paged_decode_step``, ``paged_prefill``)
  or an instance of a guard class held in ``self.<attr>`` (a learner's
  ``_update``).  A program's return value is device data.

**Hot set.**  Seeded at the programs' call sites and grown along the
call graph, as RT010's JAX leg does: a function is *hot* when it calls a
program from inside a loop, or is itself invoked from a loop of a hot
function (the engine's ``_loop`` -> ``_run_step`` -> ``_prefill`` chain,
a learner's minibatch epochs).

**Finding.**  ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.to("cpu")`` /
``float()`` / ``int()`` / ``bool()`` / ``np.asarray()`` / ``np.array()``
applied to a value reachable from a program's output, or a
``torch.cuda.synchronize()``, inside a hot function's per-step code.  A
function that merely CONTAINS the step loop is checked inside the loop
only: its post-loop readback runs once.  THE step's sanctioned readback
carries a trailing ``# rt-sync-ok: <reason>``.  A sync's result is host
data, so what is derived from it is not checked again.

RT010's other JAX legs have no torch meaning, so this rule has none:
jit-in-loop and unhashable static arguments (an eager program has no
compile cache to miss; a new signature is what ``jitguard`` counts at
run time) and donated buffers read after the call (torch has no
``donate_argnums``: an argument stays valid after the call).

``--json`` meta carries the hot-path derivation (``hot_via``) so a
finding explains WHY that function is step-rate code.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .astutil import (ConcurrencyModel, FuncInfo, dotted_name, parent_map,
                      walk_own_body, _line_annotation)
from .rtlint import Finding, Project

_SYNC_OK_RE = re.compile(r"#\s*rt-sync-ok:\s*(.+?)\s*$")

_LOOPS = (ast.For, ast.While, ast.AsyncFor)
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: jitguard entry points that mark a program.
_RECORD = "bump"
_REGISTER = "register_program"
#: host-sync builtins taking the syncing value as first argument.
_SYNC_CALLS = frozenset({"float", "int", "bool"})
#: dotted callables that materialize device values on the host.
_SYNC_DOTTED_TAILS = frozenset({"asarray", "array"})
_SYNC_DOTTED_RECV = frozenset({"np", "numpy", "onp"})
#: method calls on a device value that force a sync.
_SYNC_METHODS = frozenset({"item", "tolist", "cpu"})
#: argument-free calls that wait for the whole device.
_SYNC_BARRIERS = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})


def _full_model(project: Project) -> ConcurrencyModel:
    """Whole-tree model (the concurrency rules scope to core/; the step
    loops live in models/, serve/, rllib/, train/)."""
    cached = getattr(project, "_rt_full_model", None)
    if cached is None:
        cached = project._rt_full_model = ConcurrencyModel(
            list(project.modules))
    return cached


def _jitguard_call(call: ast.Call) -> Optional[str]:
    """``"bump"`` / ``"register_program"`` when the call is the sentinel's
    (``jitguard.bump``, ``_jitguard.bump``, a bare imported ``bump``)."""
    name = dotted_name(call.func)
    if name is None:
        return None
    recv, _, tail = name.rpartition(".")
    if tail in (_RECORD, _REGISTER) and (not recv or "jitguard" in recv):
        return tail
    return None


class _ProgramIndex:
    """Where the programs are (see the module docstring)."""

    def __init__(self, model: ConcurrencyModel):
        self.model = model
        recorders: Set[FuncInfo] = set()
        guard_classes: Set[Tuple[str, str]] = set()
        calls_in: Dict[FuncInfo, List[ast.Call]] = {}
        for func in model.functions:
            if func.module.rel.endswith("devtools/jitguard.py"):
                continue  # the registry itself
            own = [n for n in walk_own_body(func.node)
                   if isinstance(n, ast.Call)]
            calls_in[func] = own
            kinds = {_jitguard_call(c) for c in own} - {None}
            if _RECORD in kinds and func.name != "__call__":
                recorders.add(func)
            if kinds and func.cls is not None:
                guard_classes.add((func.module.rel, func.cls))
        self.guard_classes = {
            key for key in guard_classes
            if (key[0], key[1], "__call__") in model._methods}
        self.recorder_names = {f.name for f in recorders
                               if f.cls is None and f.parent is None}
        self.recorders = recorders
        self.programs: Set[FuncInfo] = set()
        for func, own in calls_in.items():
            if func in recorders:
                continue
            if any(self._is_record(c, func) for c in own):
                self.programs.add(func)
        #: module-level programs by bare name: ``paged_prefill(...)`` after
        #: ``from ..models.paged import paged_prefill`` does not resolve
        #: through the model (it looks in the caller's own module).
        self.by_name: Dict[str, FuncInfo] = {
            f.name: f for f in self.programs
            if f.cls is None and f.parent is None}

    def _is_record(self, call: ast.Call, func: FuncInfo) -> bool:
        """Does ``call`` record a program call (a recorder, or a guard
        instance held in ``self.<attr>``)?"""
        callee = self.model._resolve_callable(call.func, func)
        if callee is not None and callee in self.recorders:
            return True
        f = call.func
        if isinstance(f, ast.Name) and f.id in self.recorder_names:
            return True
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and func.cls is not None:
            ci = self.model.classes.get((func.module.rel, func.cls))
            target = ci.attr_types.get(f.attr) if ci is not None else None
            return target is not None and target in self.guard_classes
        return False

    def resolve_call(self, call: ast.Call, func: FuncInfo
                     ) -> Optional[FuncInfo]:
        """The program this call site invokes, or None."""
        callee = self.model._resolve_callable(call.func, func)
        if callee is not None and callee in self.programs:
            return callee
        f = call.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        # paged.paged_decode_step(...) / an imported program's bare name.
        return self.by_name.get(name) if name else None


def _in_loop(node: ast.AST, func_node: ast.AST, parents) -> bool:
    """Is ``node`` lexically inside a loop within this function?"""
    cur = parents.get(node)
    while cur is not None and cur is not func_node:
        if isinstance(cur, _LOOPS):
            return True
        if isinstance(cur, _FUNC_NODES):
            return False
        cur = parents.get(cur)
    return False


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _self_attrs_in(node: ast.AST) -> Set[str]:
    return {n.attr for n in ast.walk(node)
            if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "self"}


def _taint_targets(target: ast.AST, names: Set[str], attrs: Set[str]):
    if isinstance(target, ast.Name):
        names.add(target.id)
    elif isinstance(target, ast.Attribute) \
            and isinstance(target.value, ast.Name) \
            and target.value.id == "self":
        attrs.add(target.attr)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for el in target.elts:
            _taint_targets(el, names, attrs)


def _refs_taint(node: ast.AST, names: Set[str], attrs: Set[str]) -> bool:
    if _names_in(node) & names:
        return True
    return bool(_self_attrs_in(node) & attrs)


def _derives_taint(node: ast.AST, names: Set[str], attrs: Set[str],
                   program_calls: Set[int]) -> bool:
    """Does evaluating ``node`` yield device data?  A program call does; so
    does any pure access path over tainted values (name, subscript,
    attribute, method call ON a tainted receiver like ``aux.items()``).
    A call to anything ELSE launders the taint (a host function's return
    is host data), and so does a sync (``.cpu()``'s result is on the
    host)."""
    if any(id(c) in program_calls for c in ast.walk(node)
           if isinstance(c, ast.Call)):
        return True
    if not _refs_taint(node, names, attrs):
        return False
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr not in _SYNC_METHODS \
                and _refs_taint(f.value, names, attrs):
            continue  # method on a tainted receiver keeps the taint
        return False
    return True


class _HotFunc:
    __slots__ = ("func", "via", "sites", "whole_body_hot")

    def __init__(self, func, via, whole_body_hot):
        self.func = func
        self.via = via  # human-readable derivation
        self.sites: List[Tuple[ast.Call, FuncInfo]] = []
        # True when the WHOLE function runs per step (it is invoked from
        # a loop).  False when it merely CONTAINS the step loop: its
        # post-loop epilogue runs once, and a sync there is the
        # sanctioned readback point, not a per-step stall.
        self.whole_body_hot = whole_body_hot


def _hot_set(model: ConcurrencyModel, index: _ProgramIndex
             ) -> Dict[FuncInfo, _HotFunc]:
    # Per-function: program call sites + whether each is inside a loop.
    sites: Dict[FuncInfo, List[Tuple[ast.Call, FuncInfo, bool]]] = {}
    in_loop_edges: Dict[FuncInfo, List[Tuple[FuncInfo, int]]] = {}
    pmaps: Dict[str, dict] = {}
    for func in model.functions:
        # One parent map a module (``setdefault`` would build the default
        # again for every function, the bulk of the rule's time).
        pmap = pmaps.get(func.module.rel)
        if pmap is None:
            pmap = pmaps[func.module.rel] = parent_map(func.module.tree)
        for node in walk_own_body(func.node):
            if not isinstance(node, ast.Call):
                continue
            loop = _in_loop(node, func.node, pmap)
            prog = index.resolve_call(node, func)
            if prog is not None and prog is not func:
                sites.setdefault(func, []).append((node, prog, loop))
            if loop:
                callee = model._resolve_callable(node.func, func)
                if callee is not None:
                    in_loop_edges.setdefault(callee, []).append(
                        (func, node.lineno))
    hot: Dict[FuncInfo, _HotFunc] = {}

    def mark(func, via, whole_body):
        hf = hot.get(func)
        if hf is not None:
            hf.whole_body_hot = hf.whole_body_hot or whole_body
            return
        hf = _HotFunc(func, via, whole_body)
        hf.sites = [(c, p) for c, p, _ in sites.get(func, [])]
        hot[func] = hf

    # Seed A: loops directly driving a program.
    for func, fsites in sites.items():
        for call, prog, loop in fsites:
            if loop:
                mark(func, f"calls program {prog.name!r} in a loop "
                           f"(line {call.lineno})", whole_body=False)
                break
    # Seed B: program-calling functions themselves driven from a loop.
    for func, fsites in sites.items():
        if func not in in_loop_edges:
            continue
        caller, line = in_loop_edges[func][0]
        mark(func, f"calls program {fsites[0][1].name!r}; invoked from a "
                   f"loop in {caller.qualname} (line {line})",
             whole_body=True)
    # One propagation round: functions a hot function drives from ITS
    # loops (the engine's _run_step -> _prefill), and program-calling
    # functions a hot function calls at all (per-step helpers).
    for func in list(hot):
        for callee, edges in in_loop_edges.items():
            if callee in hot:
                continue
            for caller, line in edges:
                if caller in hot:
                    mark(callee, f"invoked from a loop in hot "
                                 f"{caller.qualname} (line {line})",
                         whole_body=True)
                    break
    for cs in model.call_sites:
        if cs.func in hot and cs.callee not in hot \
                and cs.callee in sites:
            mark(cs.callee,
                 f"calls a program; called from hot "
                 f"{cs.func.qualname} (line {cs.line})", whole_body=True)
    return hot


def _function_taint(hf: _HotFunc) -> Tuple[Set[str], Set[str]]:
    """Names/self-attrs holding (or derived from) program outputs inside
    one hot function."""
    program_calls = {id(c) for c, _ in hf.sites}
    names: Set[str] = set()
    attrs: Set[str] = set()
    stmts = list(walk_own_body(hf.func.node))
    for _ in range(3):  # seed + two derivation rounds
        before = (len(names), len(attrs))
        for node in stmts:
            if isinstance(node, ast.Assign):
                if _derives_taint(node.value, names, attrs, program_calls):
                    for t in node.targets:
                        _taint_targets(t, names, attrs)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if _derives_taint(node.iter, names, attrs, program_calls):
                    _taint_targets(node.target, names, attrs)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    if _derives_taint(gen.iter, names, attrs,
                                      program_calls):
                        _taint_targets(gen.target, names, attrs)
        if (len(names), len(attrs)) == before:
            break
    return names, attrs


def _sync_kind(call: ast.Call, names: Set[str], attrs: Set[str]
               ) -> Optional[str]:
    """The sync shape of a call on tainted data (or a device barrier),
    else None."""
    f = call.func
    if dotted_name(f) in _SYNC_BARRIERS:
        return "torch.cuda.synchronize()"
    if isinstance(f, ast.Name) and f.id in _SYNC_CALLS and call.args:
        if _refs_taint(call.args[0], names, attrs):
            return f"{f.id}() on a device value"
        return None
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_METHODS \
                and _refs_taint(f.value, names, attrs):
            return f".{f.attr}() on a device value"
        if f.attr == "to" and call.args \
                and isinstance(call.args[0], ast.Constant) \
                and call.args[0].value == "cpu" \
                and _refs_taint(f.value, names, attrs):
            return '.to("cpu") on a device value'
        if f.attr in _SYNC_DOTTED_TAILS and call.args:
            recv = f.value
            if isinstance(recv, ast.Name) and recv.id in _SYNC_DOTTED_RECV \
                    and _refs_taint(call.args[0], names, attrs):
                return f"{recv.id}.{f.attr}() on a device value"
    return None


def check_rt010(project: Project) -> List[Finding]:
    model = _full_model(project)
    index = _ProgramIndex(model)
    out: List[Finding] = []
    for hf in _hot_set(model, index).values():
        func = hf.func
        mod = func.module
        names, attrs = _function_taint(hf)
        pmap = parent_map(func.node)
        for node in walk_own_body(func.node):
            if not isinstance(node, ast.Call):
                continue
            kind = _sync_kind(node, names, attrs)
            if kind is None:
                continue
            if not hf.whole_body_hot \
                    and not _in_loop(node, func.node, pmap):
                # The function CONTAINS the step loop; its epilogue runs
                # once — a post-loop readback is the sanctioned shape.
                continue
            if _line_annotation(mod, node.lineno, _SYNC_OK_RE):
                continue
            out.append(Finding(
                "RT010", mod.rel, node.lineno,
                f"implicit host sync in the program hot set: {kind} "
                f"inside {func.qualname} ({hf.via}) blocks the host on "
                "device completion every step — hoist the readback out "
                "of the hot path or vet THE step's readback point with "
                "# rt-sync-ok: <reason>",
                meta={"kind": "host_sync", "sync": kind,
                      "hot_via": hf.via}))
    return _dedup(out)


def _dedup(findings: List[Finding]) -> List[Finding]:
    seen = set()
    out = []
    for f in findings:
        if f.key() in seen:
            continue
        seen.add(f.key())
        out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line))
