"""Shared AST plumbing for the rtlint rules.

Everything here is dependency-free stdlib ``ast`` work: rules must stay
importable (and runnable over a scratch tree) without initializing any of
the framework's runtime machinery.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None (calls, subscripts
    and other dynamic receivers don't have a static dotted form)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    return {
        child: parent
        for parent in ast.walk(tree)
        for child in ast.iter_child_nodes(parent)
    }


def iter_functions(tree: ast.AST) -> Iterator[ast.AST]:
    """Every function/async-function definition in the module."""
    for node in ast.walk(tree):
        if isinstance(node, _FUNC_NODES):
            yield node


def walk_own_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's body EXCLUDING nested function/class definitions:
    a nested ``def`` has its own execution context (it may run in an
    executor, a thread, or never), so its statements are not attributable
    to the enclosing function's thread/loop."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNC_NODES + (ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def contains_await(node: ast.AST) -> bool:
    """True if the node's own body (nested defs excluded) awaits."""
    return any(isinstance(n, ast.Await) for n in walk_own_body(node))


def is_awaited(call: ast.Call, parents: Dict[ast.AST, ast.AST]) -> bool:
    return isinstance(parents.get(call), ast.Await)


def decorator_names(node: ast.AST) -> List[str]:
    """Dotted names of a def/class's decorators; ``@d(...)`` reports the
    callee ``d``."""
    out: List[str] = []
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name:
            out.append(name)
    return out


def assigned_target(call: ast.Call,
                    parents: Dict[ast.AST, ast.AST]) -> Optional[str]:
    """Terminal name a call's result is bound to (``x = f()`` -> ``x``,
    ``self.x = f()`` -> ``x``), else None."""
    parent = parents.get(call)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        t = parent.targets[0]
        if isinstance(t, ast.Name):
            return t.id
        if isinstance(t, ast.Attribute):
            return t.attr
    return None


def str_dict_literal(tree: ast.AST, var: str) -> Optional[Dict[str, str]]:
    """Parse a module-level ``var = {"k": "v", ...}`` assignment without
    importing the module."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == var for t in targets):
            if not isinstance(node.value, ast.Dict):
                return None
            out: Dict[str, str] = {}
            for k, v in zip(node.value.keys, node.value.values):
                ks, vs = const_str(k), const_str(v)
                if ks is not None and vs is not None:
                    out[ks] = vs
            return out
    return None


def str_collection_literal(tree: ast.AST, var: str) -> Optional[List[str]]:
    """String constants inside a module-level ``var = frozenset({...})`` /
    set / tuple / list / dict-keys assignment, without importing."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == var for t in node.targets
        ):
            return [
                n.value for n in ast.walk(node.value)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
            ]
    return None


def enclosing_functions(
    node: ast.AST, parents: Dict[ast.AST, ast.AST]
) -> List[ast.AST]:
    """Function defs lexically enclosing ``node``, innermost first."""
    out: List[ast.AST] = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, _FUNC_NODES):
            out.append(cur)
        cur = parents.get(cur)
    return out


def local_names(fn: ast.AST) -> set:
    """Parameter + locally-bound names of a function (its own body only)."""
    args = fn.args
    names = {
        a.arg
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        )
    }
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    for node in walk_own_body(fn):
        if isinstance(node, ast.Name) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
    # Direct child defs/classes bind their names in this scope too.
    for child in ast.iter_child_nodes(fn):
        if isinstance(child, _FUNC_NODES + (ast.ClassDef,)):
            names.add(child.name)
    return names


def module_scope_names(tree: ast.AST) -> set:
    """Names bound at MODULE scope only — nested function/class bodies are
    excluded (their Store names are locals, and treating them as module
    globals would mask closure captures)."""
    names = set()
    for node in walk_own_body(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
    for child in ast.iter_child_nodes(tree):
        if isinstance(child, _FUNC_NODES + (ast.ClassDef,)):
            names.add(child.name)
    return names


# ==============================================================================
# Concurrency model: call graph, thread-role inference, guard inference.
#
# The dataplane split (PR 6) means core/ state is mutated concurrently from
# the asyncio loops, the shared peer-loop thread, per-connection reader
# threads, executors, and throwaway offload threads.  The model below is the
# shared substrate for rules RT007 (guarded-by races) and RT008 (static
# lock-order cycles): pure ``ast`` work, nothing imported or executed.
#
# Thread roles (a role = one CLASS of threads; two accesses race only when
# their role sets differ):
#
#   main       entry from user/API threads (functions nothing in the
#              analyzed tree is seen to call)
#   loop       an asyncio event-loop thread: every ``async def``, plus sync
#              callbacks a loop runs (``call_soon``/``call_soon_threadsafe``
#              targets, ``on_push``/``subscribe`` handlers, future
#              ``add_done_callback``s — resolved by RPC read loops)
#   executor   ``run_in_executor`` / ``ThreadPoolExecutor.submit`` targets
#   thread:N   dedicated ``threading.Thread(target=..., name="N")`` targets
#   gc         ``__del__`` (cyclic GC runs it on whatever thread allocates)
#
# Known approximation: all event loops in one process collapse into one
# ``loop`` role, so a race strictly between two DIFFERENT loops (head loop
# vs peer loop) with no other role touching the field is not reported.
# Every real core/ field that multiple loops touch is also touched from
# ``main``, which does get reported.
#
# Annotations (documented in CONTRIBUTING.md):
#   # rt-role: <role>           on a def/lambda line — asserts the function
#                               runs under that role (escaping callbacks)
#   # rt-unguarded: <reason>    on an attribute-access line — vets that
#                               (class, attr) as an intentional unguarded
#                               cross-thread handoff
#   _RT_UNGUARDED = {"attr": "reason", ...}     class-level bulk form
#   _RT_GUARDED_BY = {"attr": "_lock_attr", ...}  declared guard map; RT007
#                               verifies it statically and devtools.locks
#                               enforces it at runtime under RT_DEBUG_LOCKS=2
# ==============================================================================

ROLE_MAIN = "main"
ROLE_LOOP = "loop"
ROLE_EXECUTOR = "executor"
ROLE_GC = "gc"

#: receiver-method call sites (``something.m()``) resolve cross-class only
#: when ``m`` is defined by exactly ONE class in the analyzed tree and is
#: not one of these ubiquitous names (dict/list/socket/file/future verbs
#: would resolve half the stdlib onto project classes).
_COMMON_METHODS = frozenset({
    "get", "put", "set", "pop", "add", "close", "run", "start", "stop",
    "call", "send", "recv", "submit", "wait", "cancel", "append", "remove",
    "clear", "update", "items", "keys", "values", "result", "done", "join",
    "acquire", "release", "flush", "write", "read", "register", "connect",
    "main", "handler", "shutdown", "exception", "copy", "sort", "extend",
    "insert", "discard", "setdefault", "split", "strip", "encode", "decode",
    "format", "create", "exists", "name", "free", "notify", "count",
})

#: container methods that mutate their receiver — ``self._x.append(...)``
#: is a write-shaped access to ``_x`` even though the attr node loads.
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "discard", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "move_to_end", "extendleft",
})

#: constructors whose instances are internally synchronized: accesses
#: through them (``self._q.put(...)``) are not races.
_THREADSAFE_CTORS = frozenset({
    "threading.Event", "threading.Condition", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.Barrier", "threading.local",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "ThreadPoolExecutor",
    "concurrent.futures.ThreadPoolExecutor",
})

#: lock factories.  kind "thread" locks participate in RT008 ordering;
#: asyncio locks serialize tasks on one loop, not threads, so they guard
#: (RT007) but impose no cross-thread order.
_LOCK_CTORS = {
    "make_lock": "thread", "make_rlock": "thread",
    "locks.make_lock": "thread", "locks.make_rlock": "thread",
    "threading.Lock": "thread", "threading.RLock": "thread",
    "asyncio.Lock": "async",
}

_ROLE_RE = re.compile(r"#\s*rt-role:\s*([A-Za-z0-9:_\-]+)")
_UNGUARDED_RE = re.compile(r"#\s*rt-unguarded:\s*(.+?)\s*$")


class FuncInfo:
    """One function/lambda in the analyzed tree."""

    __slots__ = ("node", "module", "cls", "name", "qualname", "parent",
                 "children", "is_async", "roles", "role_seeds", "entry_held",
                 "has_caller", "lineno", "def_site_held")

    def __init__(self, node, module, cls, name, qualname, parent):
        self.node = node
        self.module = module          # Module (rtlint)
        self.cls = cls                # innermost enclosing class name or None
        self.name = name
        self.qualname = qualname
        self.parent = parent          # enclosing FuncInfo or None
        self.children: Dict[str, "FuncInfo"] = {}
        self.is_async = isinstance(node, ast.AsyncFunctionDef)
        self.roles: Set[str] = set()
        self.role_seeds: Set[str] = set()
        self.entry_held: Optional[FrozenSet[str]] = None  # None = unknown/top
        self.has_caller = False       # some resolved call site targets it
        self.lineno = getattr(node, "lineno", 0)
        # Locks lexically held where a NESTED def/lambda appears: a nested
        # orphan (sorted keys, local helpers) runs right there, so it
        # inherits these along with the parent's entry set.
        self.def_site_held: FrozenSet[str] = frozenset()

    def __repr__(self):
        return f"<FuncInfo {self.module.rel}:{self.qualname}>"


class Access:
    """One ``self.<attr>`` access inside a method body."""

    __slots__ = ("cls_key", "attr", "kind", "func", "line", "held")

    def __init__(self, cls_key, attr, kind, func, line, held):
        self.cls_key = cls_key  # (module_rel, class_name)
        self.attr = attr
        self.kind = kind        # "write" | "read"
        self.func = func        # FuncInfo
        self.line = line
        self.held = held        # FrozenSet[str] lexically held lock ids

    def effective_held(self) -> FrozenSet[str]:
        extra = self.func.entry_held or frozenset()
        return self.held | extra


class ClassInfo:
    __slots__ = ("module", "name", "node", "lock_attrs", "lock_kinds",
                 "guarded_by", "unguarded", "threadsafe_attrs", "lineno",
                 "attr_types")

    def __init__(self, module, name, node):
        self.module = module
        self.name = name
        self.node = node
        self.lock_attrs: Dict[str, str] = {}   # attr -> canonical lock id
        self.lock_kinds: Dict[str, str] = {}   # attr -> "thread"|"async"
        self.guarded_by: Dict[str, str] = {}   # declared _RT_GUARDED_BY
        self.unguarded: Dict[str, str] = {}    # declared _RT_UNGUARDED
        self.threadsafe_attrs: Set[str] = set()
        self.lineno = node.lineno
        # self.X = ProjectClass(...) — light type inference so calls
        # through the attribute (self.scheduler.acquire(...)) resolve.
        self.attr_types: Dict[str, Tuple[str, str]] = {}

    @property
    def key(self):
        return (self.module.rel, self.name)


class Acquisition:
    """One ``with <lock>:`` acquisition site."""

    __slots__ = ("lock", "kind", "func", "line", "held")

    def __init__(self, lock, kind, func, line, held):
        self.lock = lock
        self.kind = kind
        self.func = func
        self.line = line
        self.held = held  # frozenset held lexically just before this acquire


class CallSite:
    __slots__ = ("callee", "func", "line", "held")

    def __init__(self, callee, func, line, held):
        self.callee = callee  # FuncInfo
        self.func = func      # caller FuncInfo
        self.line = line
        self.held = held


def _line_annotation(module, lineno, regex) -> Optional[str]:
    try:
        line = module.source.splitlines()[lineno - 1]
    except IndexError:
        return None
    m = regex.search(line)
    return m.group(1) if m else None


class ConcurrencyModel:
    """Interprocedural view of a set of modules: who runs what (thread
    roles), which lock guards what (guard maps), and which locks nest
    inside which (ordering edges)."""

    def __init__(self, modules: List):
        self.modules = list(modules)
        self.functions: List[FuncInfo] = []
        self._by_node: Dict[int, FuncInfo] = {}
        self.classes: Dict[Tuple[str, str], ClassInfo] = {}
        self._methods: Dict[Tuple[str, str, str], FuncInfo] = {}
        self._module_funcs: Dict[Tuple[str, str], FuncInfo] = {}
        self._module_locks: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self.accesses: List[Access] = []
        self.acquisitions: List[Acquisition] = []
        self.call_sites: List[CallSite] = []
        self._unique_methods: Dict[str, FuncInfo] = {}
        self._build_catalog()
        self._build_class_info()
        self._index_unique_methods()
        self._extract_bodies()
        self._propagate_roles()
        self._solve_entry_held()
        # Re-derive effective held sets now that entry_held is known: the
        # Access objects keep lexical held; effective_held() adds entry.

    # -- discovery -------------------------------------------------------------

    def _build_catalog(self):
        for mod in self.modules:
            self._scan_scope(mod, mod.tree, None, None)

    def _scan_scope(self, mod, node, cls, parent_func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._scan_scope(mod, child, child.name, None)
            elif isinstance(child, _FUNC_NODES + (ast.Lambda,)):
                name = getattr(child, "name",
                               f"<lambda:{child.lineno}>")
                qual = (f"{parent_func.qualname}.{name}" if parent_func
                        else f"{cls}.{name}" if cls else name)
                info = FuncInfo(child, mod, cls, name, qual, parent_func)
                self.functions.append(info)
                self._by_node[id(child)] = info
                if parent_func is not None:
                    parent_func.children[name] = info
                elif cls is not None:
                    self._methods[(mod.rel, cls, name)] = info
                else:
                    self._module_funcs[(mod.rel, name)] = info
                # Intrinsic role seeds.
                if info.is_async:
                    info.role_seeds.add(ROLE_LOOP)
                if name == "__del__":
                    info.role_seeds.add(ROLE_GC)
                explicit = _line_annotation(mod, child.lineno, _ROLE_RE)
                if explicit:
                    info.role_seeds.add(explicit)
                self._scan_scope(mod, child, cls, info)
            else:
                self._scan_scope(mod, child, cls, parent_func)

    def _build_class_info(self):
        for mod in self.modules:
            # Module-level locks: X = make_lock("name") / threading.Lock().
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and isinstance(stmt.value, ast.Call):
                    ctor = dotted_name(stmt.value.func)
                    if ctor in _LOCK_CTORS:
                        var = stmt.targets[0].id
                        lock_id = self._lock_name(stmt.value, mod, None, var)
                        self._module_locks[(mod.rel, var)] = (
                            lock_id, _LOCK_CTORS[ctor])
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                ci = ClassInfo(mod, node.name, node)
                self.classes[ci.key] = ci
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign) \
                            and len(stmt.targets) == 1 \
                            and isinstance(stmt.targets[0], ast.Name):
                        var = stmt.targets[0].id
                        if var in ("_RT_GUARDED_BY", "_RT_UNGUARDED") \
                                and isinstance(stmt.value, ast.Dict):
                            out = {}
                            for k, v in zip(stmt.value.keys,
                                            stmt.value.values):
                                ks, vs = const_str(k), const_str(v)
                                if ks is not None and vs is not None:
                                    out[ks] = vs
                            if var == "_RT_GUARDED_BY":
                                ci.guarded_by = out
                            else:
                                ci.unguarded = out
                # self.<attr> = <lock ctor>() / <threadsafe ctor>() anywhere
                # in the class body (constructors usually, but not only).
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Assign) \
                            or len(sub.targets) != 1:
                        continue
                    t = sub.targets[0]
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    if not isinstance(sub.value, ast.Call):
                        continue
                    ctor = dotted_name(sub.value.func)
                    if ctor in _LOCK_CTORS:
                        ci.lock_attrs[t.attr] = self._lock_name(
                            sub.value, mod, node.name, t.attr)
                        ci.lock_kinds[t.attr] = _LOCK_CTORS[ctor]
                    elif ctor in _THREADSAFE_CTORS:
                        ci.threadsafe_attrs.add(t.attr)
                    elif ctor is not None:
                        ci.attr_types[t.attr] = ctor.rsplit(".", 1)[-1]
        # Second pass: resolve attr ctor names to project classes (all
        # classes exist by now) and index module import aliases.
        class_by_name: Dict[str, List[Tuple[str, str]]] = {}
        for (rel, name) in self.classes:
            class_by_name.setdefault(name, []).append((rel, name))
        for ci in self.classes.values():
            resolved = {}
            for attr, cname in ci.attr_types.items():
                hits = class_by_name.get(cname)
                if hits and len(hits) == 1:
                    resolved[attr] = hits[0]
            ci.attr_types = resolved
        self._module_aliases: Dict[Tuple[str, str], str] = {}
        by_tail: Dict[str, List[str]] = {}
        for m in self.modules:
            tail = m.rel.rsplit("/", 1)[-1][:-3]
            by_tail.setdefault(tail, []).append(m.rel)
        for m in self.modules:
            for node in ast.walk(m.tree):
                names = (node.names
                         if isinstance(node, (ast.Import, ast.ImportFrom))
                         else [])
                for alias in names:
                    tail = alias.name.rsplit(".", 1)[-1]
                    hits = by_tail.get(tail)
                    if hits and len(hits) == 1:
                        self._module_aliases[
                            (m.rel, alias.asname or tail)] = hits[0]

    @staticmethod
    def _lock_name(call: ast.Call, mod, cls: Optional[str],
                   attr: str) -> str:
        """Canonical lock id: the ``make_lock("name")`` string when present
        (lock NAMES are the ordering identity — every Client's
        ``client.put_batch`` is one role), else class-qualified attr."""
        if call.args:
            s = const_str(call.args[0])
            if s is not None:
                return s
        return f"{cls}.{attr}" if cls else f"{mod.rel}:{attr}"

    def _index_unique_methods(self):
        seen: Dict[str, List[FuncInfo]] = {}
        for (rel, cls, name), info in self._methods.items():
            seen.setdefault(name, []).append(info)
        for name, infos in seen.items():
            if len(infos) == 1 and len(name) >= 4 \
                    and name not in _COMMON_METHODS \
                    and not name.startswith("__"):
                self._unique_methods[name] = infos[0]
        # Unique lock ATTRS resolve foreign lock references
        # (self._client._put_batch_lock) to their canonical id.
        self._unique_lock_attrs: Dict[str, Tuple[str, str]] = {}
        counts: Dict[str, List[Tuple[str, str]]] = {}
        for ci in self.classes.values():
            for attr, lock_id in ci.lock_attrs.items():
                counts.setdefault(attr, []).append(
                    (lock_id, ci.lock_kinds[attr]))
        for attr, ids in counts.items():
            if len(ids) == 1:
                self._unique_lock_attrs[attr] = ids[0]

    # -- resolution ------------------------------------------------------------

    def _resolve_callable(self, expr, func: FuncInfo) -> Optional[FuncInfo]:
        """Resolve a callback/callee expression in ``func``'s scope."""
        if isinstance(expr, ast.Lambda):
            return self._by_node.get(id(expr))
        if isinstance(expr, ast.Call):
            # e.g. run_coroutine_threadsafe(self._connect(), loop): the
            # interesting target is the called coroutine function.
            return self._resolve_callable(expr.func, func)
        if isinstance(expr, ast.Name):
            cur = func
            while cur is not None:
                child = cur.children.get(expr.id)
                if child is not None:
                    return child
                cur = cur.parent
            if func.cls is not None:
                m = self._methods.get((func.module.rel, func.cls, expr.id))
                if m is not None:
                    return m
            return self._module_funcs.get((func.module.rel, expr.id))
        if isinstance(expr, ast.Attribute):
            recv = expr.value
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls") \
                    and func.cls is not None:
                return self._methods.get(
                    (func.module.rel, func.cls, expr.attr))
            # Typed instance attribute: self.scheduler.acquire(...) where
            # __init__ assigned self.scheduler = ClusterScheduler(...).
            if isinstance(recv, ast.Attribute) \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id == "self" and func.cls is not None:
                ci = self.classes.get((func.module.rel, func.cls))
                if ci is not None:
                    target = ci.attr_types.get(recv.attr)
                    if target is not None:
                        m = self._methods.get(
                            (target[0], target[1], expr.attr))
                        if m is not None:
                            return m
            # Imported project module: oref._flush_free_queue(...).
            if isinstance(recv, ast.Name):
                target_rel = self._module_aliases.get(
                    (func.module.rel, recv.id))
                if target_rel is not None:
                    m = self._module_funcs.get((target_rel, expr.attr))
                    if m is not None:
                        return m
            return self._unique_methods.get(expr.attr)
        return None

    def _resolve_lock(self, expr, func: FuncInfo) -> Optional[Tuple[str, str]]:
        """(lock_id, kind) for a with-item / guard expression, else None."""
        if isinstance(expr, ast.Attribute):
            recv = expr.value
            if isinstance(recv, ast.Name) and recv.id == "self" \
                    and func.cls is not None:
                ci = self.classes.get((func.module.rel, func.cls))
                if ci is not None and expr.attr in ci.lock_attrs:
                    return (ci.lock_attrs[expr.attr],
                            ci.lock_kinds[expr.attr])
            # Foreign receiver: unique lock attr across the tree.
            return self._unique_lock_attrs.get(expr.attr)
        if isinstance(expr, ast.Name):
            return self._module_locks.get((func.module.rel, expr.id))
        return None

    # -- body extraction -------------------------------------------------------

    def _extract_bodies(self):
        for func in self.functions:
            self._walk_body(func, list(ast.iter_child_nodes(func.node)),
                            frozenset())

    def _walk_body(self, func: FuncInfo, nodes, held: FrozenSet[str]):
        for node in nodes:
            if isinstance(node, _FUNC_NODES + (ast.ClassDef, ast.Lambda)):
                # Separate execution context, cataloged on its own — but
                # remember what is held where it is DEFINED (sorted-key
                # lambdas and local helpers run right there).
                info = self._by_node.get(id(node))
                if info is not None:
                    info.def_site_held = held
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new = set(held)
                for item in node.items:
                    lk = self._resolve_lock(item.context_expr, func)
                    if lk is not None:
                        self.acquisitions.append(Acquisition(
                            lk[0], lk[1], func, node.lineno,
                            frozenset(new)))
                        new.add(lk[0])
                # with-item expressions evaluate before the body holds.
                self._walk_body(
                    func, [i.context_expr for i in node.items], held)
                self._walk_body(func, node.body, frozenset(new))
                continue
            if isinstance(node, ast.Call):
                self._handle_call(func, node, held)
            self._record_access(func, node, held)
            self._walk_body(func, list(ast.iter_child_nodes(node)), held)

    def _handle_call(self, func: FuncInfo, call: ast.Call,
                     held: FrozenSet[str]):
        # The method name alone drives seed matching so chained receivers
        # (``asyncio.get_running_loop().call_soon(cb)``) still count.
        tail = (call.func.attr if isinstance(call.func, ast.Attribute)
                else call.func.id if isinstance(call.func, ast.Name)
                else None)
        # Role seeds: the argument callback runs under the seeded role.
        seeded = None
        if tail == "Thread":
            target = next((kw.value for kw in call.keywords
                           if kw.arg == "target"), None)
            if target is not None:
                name_kw = next((const_str(kw.value) for kw in call.keywords
                                if kw.arg == "name"), None)
                cb = self._resolve_callable(target, func)
                if cb is not None:
                    role = f"thread:{name_kw}" if name_kw else (
                        f"thread:{cb.name}")
                    cb.role_seeds.add(role)
                    cb.has_caller = True
                    cb.entry_held = frozenset()
                    seeded = cb
        elif tail == "run_in_executor" and len(call.args) >= 2:
            cb = self._resolve_callable(call.args[1], func)
            if cb is not None:
                cb.role_seeds.add(ROLE_EXECUTOR)
                cb.has_caller = True
                cb.entry_held = frozenset()
                seeded = cb
        elif tail == "submit" and call.args:
            cb = self._resolve_callable(call.args[0], func)
            if cb is not None:
                cb.role_seeds.add(ROLE_EXECUTOR)
                cb.has_caller = True
                cb.entry_held = frozenset()
                seeded = cb
        elif tail in ("call_soon", "call_soon_threadsafe",
                      "add_done_callback") and call.args:
            cb = self._resolve_callable(call.args[0], func)
            if cb is not None:
                cb.role_seeds.add(ROLE_LOOP)
                cb.has_caller = True
                cb.entry_held = frozenset()
                seeded = cb
        elif tail in ("call_later", "call_at") and len(call.args) >= 2:
            # loop.call_later(delay, cb, ...) / call_at(when, cb, ...):
            # the callback runs on the same loop thread as call_soon.
            cb = self._resolve_callable(call.args[1], func)
            if cb is not None:
                cb.role_seeds.add(ROLE_LOOP)
                cb.has_caller = True
                cb.entry_held = frozenset()
                seeded = cb
        elif tail in ("on_push", "subscribe", "register", "handler") \
                and len(call.args) >= 2:
            cb = self._resolve_callable(call.args[1], func)
            if cb is not None:
                cb.role_seeds.add(ROLE_LOOP)
                cb.has_caller = True
                cb.entry_held = frozenset()
                seeded = cb
        elif tail == "run_coroutine_threadsafe" and call.args:
            cb = self._resolve_callable(call.args[0], func)
            if cb is not None:
                cb.role_seeds.add(ROLE_LOOP)
                cb.has_caller = True
                cb.entry_held = frozenset()
                seeded = cb
        # Direct call edge (not for seeded registrations: registering a
        # callback is not calling it here).
        callee = self._resolve_callable(call.func, func)
        if callee is not None and callee is not seeded:
            callee.has_caller = True
            self.call_sites.append(
                CallSite(callee, func, call.lineno, held))

    def _record_access(self, func: FuncInfo, node, held: FrozenSet[str]):
        """self.<attr> loads/stores, classifying writes (attr rebinds,
        subscript stores through the attr, mutator method calls)."""
        if func.cls is None:
            return
        cls_key = (func.module.rel, func.cls)
        targets: List[Tuple[ast.Attribute, str]] = []
        if isinstance(node, ast.Assign):
            for t in node.targets:
                targets.extend(self._attr_targets(t, "write"))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets.extend(self._attr_targets(node.target, "write"))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                targets.extend(self._attr_targets(t, "write"))
        elif isinstance(node, ast.Call):
            # self._x.append(...) and friends.
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS \
                    and isinstance(f.value, ast.Attribute) \
                    and isinstance(f.value.value, ast.Name) \
                    and f.value.value.id == "self":
                targets.append((f.value, "write"))
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" \
                and isinstance(node.ctx, ast.Load):
            targets.append((node, "read"))
        for attr_node, kind in targets:
            self.accesses.append(Access(
                cls_key, attr_node.attr, kind, func,
                attr_node.lineno, held))

    @staticmethod
    def _attr_targets(t, kind) -> List[Tuple[ast.Attribute, str]]:
        out = []
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == "self":
            out.append((t, kind))
        elif isinstance(t, ast.Subscript):
            v = t.value
            if isinstance(v, ast.Attribute) \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id == "self":
                out.append((v, kind))
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                out.extend(ConcurrencyModel._attr_targets(el, kind))
        return out

    # -- role propagation ------------------------------------------------------

    def _propagate_roles(self):
        # Entries: TOP-LEVEL functions/methods nothing resolvable calls and
        # nothing seeds run on whatever thread the user calls them from.
        # A NESTED orphan (sorted key, local helper) instead runs where it
        # is defined: it inherits the enclosing function's roles.
        orphans: List[FuncInfo] = []
        for f in self.functions:
            f.roles |= f.role_seeds
            if not f.role_seeds and not f.has_caller:
                if f.parent is None:
                    f.roles.add(ROLE_MAIN)
                    f.entry_held = frozenset()
                else:
                    orphans.append(f)
        # Roles flow caller -> callee along direct call edges, EXCEPT into
        # async defs: calling a coroutine function schedules it on a loop,
        # it does not run it on the calling thread.
        edges: Dict[FuncInfo, Set[FuncInfo]] = {}
        for cs in self.call_sites:
            if cs.callee.is_async:
                continue
            edges.setdefault(cs.func, set()).add(cs.callee)
        changed = True
        iters = 0
        while changed and iters < 50:
            changed = False
            iters += 1
            for caller, callees in edges.items():
                if not caller.roles:
                    continue
                for callee in callees:
                    if not caller.roles <= callee.roles:
                        callee.roles |= caller.roles
                        changed = True
            for f in orphans:
                if not f.parent.roles <= f.roles:
                    f.roles |= f.parent.roles
                    changed = True
        self._orphans = orphans

    def _solve_entry_held(self):
        """Locks provably held at ENTRY of each function: the intersection
        over its call sites of (caller entry_held + lexical held at the
        site).  Seeded callbacks and entries start with nothing held."""
        incoming: Dict[FuncInfo, List[CallSite]] = {}
        for cs in self.call_sites:
            incoming.setdefault(cs.callee, []).append(cs)
        # Functions with no known call site are entries: they start with
        # nothing held.  Without this pin the fixpoint never seeds — every
        # chain rooted at an entry would stay "unknown" and default to
        # nothing-held, erasing provable Lock-held-on-entry facts.
        for f in self.functions:
            if f.entry_held is None and f not in incoming:
                f.entry_held = frozenset()
        for _ in range(20):
            changed = False
            for callee, sites in incoming.items():
                if callee.entry_held == frozenset():
                    continue  # pinned: entry/seeded callback
                met: Optional[FrozenSet[str]] = None
                unknown = False
                for cs in sites:
                    base = cs.func.entry_held
                    if base is None:
                        unknown = True
                        continue
                    eff = cs.held | base
                    met = eff if met is None else (met & eff)
                if unknown and met is None:
                    continue
                if met is None:
                    met = frozenset()
                if callee.entry_held != met:
                    callee.entry_held = met
                    changed = True
            if not changed:
                break
        for f in self.functions:
            if f.entry_held is None:
                f.entry_held = frozenset()
        # Nested orphans execute where they were defined: what the parent
        # held there is held for them too.
        for _ in range(5):
            changed = False
            for f in self._orphans:
                inherited = (f.parent.entry_held or frozenset()) \
                    | f.def_site_held
                if inherited - (f.entry_held or frozenset()):
                    f.entry_held = (f.entry_held or frozenset()) | inherited
                    changed = True
            if not changed:
                break

    # -- derived views ---------------------------------------------------------

    def class_accesses(self) -> Dict[Tuple[str, str], Dict[str, List[Access]]]:
        out: Dict[Tuple[str, str], Dict[str, List[Access]]] = {}
        for a in self.accesses:
            out.setdefault(a.cls_key, {}).setdefault(a.attr, []).append(a)
        return out

    def unguarded_annotation(self, module, line) -> Optional[str]:
        return _line_annotation(module, line, _UNGUARDED_RE)

    def infer_guard(self, accesses: List[Access]) -> Optional[str]:
        """The lock (if any) held at EVERY access — the inferred guard."""
        met: Optional[FrozenSet[str]] = None
        for a in accesses:
            eff = a.effective_held()
            met = eff if met is None else (met & eff)
            if not met:
                return None
        if met:
            return sorted(met)[0]
        return None

    def lock_order_edges(self) -> Dict[Tuple[str, str], Tuple[str, int]]:
        """(outer, inner) -> first (module_rel, line) establishing it.
        Composes nested ``with`` scopes through the call graph: a call made
        while holding A to a function that (transitively) acquires B is an
        A -> B edge, exactly like a lexical nesting."""
        # Transitively acquired thread-lock sets per function.
        acquired: Dict[FuncInfo, Set[str]] = {f: set() for f in self.functions}
        for acq in self.acquisitions:
            if acq.kind == "thread":
                acquired[acq.func].add(acq.lock)
        callees: Dict[FuncInfo, Set[FuncInfo]] = {}
        for cs in self.call_sites:
            callees.setdefault(cs.func, set()).add(cs.callee)
        for _ in range(30):
            changed = False
            for f, cs in callees.items():
                for c in cs:
                    if not acquired[c] <= acquired[f]:
                        acquired[f] |= acquired[c]
                        changed = True
            if not changed:
                break
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for acq in self.acquisitions:
            if acq.kind != "thread":
                continue
            outer = acq.held | (acq.func.entry_held or frozenset())
            for o in outer:
                if o != acq.lock:
                    edges.setdefault((o, acq.lock),
                                     (acq.func.module.rel, acq.line))
        for cs in self.call_sites:
            outer = cs.held | (cs.func.entry_held or frozenset())
            if not outer:
                continue
            for inner in acquired.get(cs.callee, ()):
                for o in outer:
                    if o != inner:
                        edges.setdefault(
                            (o, inner), (cs.func.module.rel, cs.line))
        return edges
