"""RT009: spawn-env contract drift.

The spawner half of the framework hands state to child processes through
``RT_*`` environment variables (head -> node daemon -> worker), and the
reader half picks them up with raw ``os.environ`` reads scattered across
``cluster_utils.py``, ``node_main.py``, ``api.py``, ``worker_main.py``,
``train/worker_group.py``...  A typo'd key or a renamed-on-one-side-only
variable fails SILENTLY (``environ.get`` default kicks in) — the same
drift class RT003 closes for RPC methods.  ``core/config.py`` therefore
carries ``SPAWN_ENV_CONTRACT``, a catalog of every ad-hoc ``RT_*`` key,
and RT009 reconciles it three ways (mirroring RT003's shape):

- **missing**: an ``RT_*`` key is read outside ``core/config.py`` but has
  no catalog entry;
- **stale**: a catalog entry no module reads — the contract must shrink
  when the reader goes away;
- **orphan write**: an ``RT_*`` key is exported into a spawn environment
  (``os.environ[k] =``, an ``RT_*=...`` keyword, a dict literal key) but
  is neither in the catalog nor a ``Config`` field override — dead env
  plumbing no child ever reads.

Plus the config-shadow leg: reading ``RT_<FIELD>`` ad hoc when ``<field>``
is a ``Config`` dataclass field bypasses ``system_config`` overrides and
type coercion — use ``get_config().<field>``.

Key names resolve through module-level string constants
(``ENV_FLAG = "RT_DEBUG_LOCKS"; os.environ.get(ENV_FLAG)`` counts), and
through string constants imported from ``core/config.py`` itself
(``from .config import ADDRESS_ENV; os.environ[ADDRESS_ENV]`` is a read
of ``RT_TORCH_ADDRESS``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .astutil import const_str, dotted_name
from .rtlint import Finding, Project

CONTRACT_VAR = "SPAWN_ENV_CONTRACT"


def _module_str_consts(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            s = const_str(node.value)
            if s is not None:
                out[node.targets[0].id] = s
    return out


def _import_target(module, node: ast.ImportFrom) -> Optional[str]:
    """Repo-relative path of the module an ``ImportFrom`` names."""
    parts = node.module.split(".") if node.module else []
    if node.level == 0:
        base: List[str] = []
    else:
        base = module.rel.split("/")[:-1]
        if node.level > 1:
            base = base[:-(node.level - 1)]
    return "/".join(base + parts) + ".py" if parts else None


def _config_imports(module, config,
                    config_consts: Dict[str, str]) -> Dict[str, str]:
    """Names bound to ``core/config.py``'s string constants by
    ``from <config> import NAME [as ALIAS]`` anywhere in ``module``."""
    out: Dict[str, str] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ImportFrom) \
                and _import_target(module, node) == config.rel:
            for alias in node.names:
                if alias.name in config_consts:
                    out[alias.asname or alias.name] = \
                        config_consts[alias.name]
    return out


def _key_of(node, consts: Dict[str, str]) -> Optional[str]:
    s = const_str(node)
    if s is None and isinstance(node, ast.Name):
        s = consts.get(node.id)
    if s is not None and s.startswith("RT_"):
        return s
    return None


def _environ_reads(module, imported: Dict[str, str]
                   ) -> List[Tuple[str, int]]:
    """(key, line) for const-resolvable RT_* environ reads."""
    consts = {**imported, **_module_str_consts(module.tree)}
    out: List[Tuple[str, int]] = []
    for node in ast.walk(module.tree):
        key = None
        if isinstance(node, ast.Call):
            f = dotted_name(node.func)
            if f is not None and f.endswith("environ.get") and node.args:
                key = _key_of(node.args[0], consts)
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load):
            recv = dotted_name(node.value)
            if recv is not None and recv.endswith("environ"):
                key = _key_of(node.slice, consts)
        if key is not None:
            out.append((key, node.lineno))
    return out


def _environ_writes(module, imported: Dict[str, str]
                    ) -> List[Tuple[str, int]]:
    """(key, line) for RT_* spawn-env exports: environ item stores/pops,
    RT_*-named keywords, and RT_* dict-literal keys."""
    consts = {**imported, **_module_str_consts(module.tree)}
    out: List[Tuple[str, int]] = []
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript):
                    key = _key_of(t.slice, consts)
                    if key is not None:
                        out.append((key, t.lineno))
        elif isinstance(node, ast.Call):
            f = dotted_name(node.func)
            if f is not None and f.endswith("environ.pop") and node.args:
                key = _key_of(node.args[0], consts)
                if key is not None:
                    out.append((key, node.lineno))
            for kw in node.keywords:
                if kw.arg is not None and kw.arg.startswith("RT_"):
                    out.append((kw.arg, node.lineno))
        elif isinstance(node, ast.Dict):
            for k in node.keys:
                key = _key_of(k, consts) if k is not None else None
                if key is not None:
                    out.append((key, k.lineno))
    return out


def _contract(config) -> Optional[Dict[str, int]]:
    """key -> catalog line, from the SPAWN_ENV_CONTRACT dict literal."""
    for stmt in config.tree.body:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target] if isinstance(stmt, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == CONTRACT_VAR
               for t in targets) and isinstance(stmt.value, ast.Dict):
            out: Dict[str, int] = {}
            for k in stmt.value.keys:
                s = const_str(k)
                if s is not None:
                    out[s] = k.lineno
            return out
    return None


def _config_fields(config) -> List[str]:
    for node in ast.walk(config.tree):
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            return [stmt.target.id for stmt in node.body
                    if isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)]
    return []


def check_rt009(project: Project) -> List[Finding]:
    config = project.find("core/config.py")
    if config is None:
        return []  # not a control-plane tree
    contract = _contract(config)
    if contract is None:
        return [Finding(
            "RT009", config.rel, 1,
            f"core/config.py has no {CONTRACT_VAR} dict — the spawn-env "
            "contract catalog is the anchor this rule reconciles against",
            meta={"kind": "no-contract"})]
    overrides = {f"RT_{f.upper()}" for f in _config_fields(config)}
    config_consts = _module_str_consts(config.tree)
    out: List[Finding] = []
    reads: Dict[str, Tuple[str, int]] = {}
    writes: Dict[str, Tuple[str, int]] = {}
    for mod in project.modules:
        if mod is config:
            continue
        imported = _config_imports(mod, config, config_consts)
        for key, line in _environ_reads(mod, imported):
            reads.setdefault(key, (mod.rel, line))
            if key in overrides:
                field = key[3:].lower()
                out.append(Finding(
                    "RT009", mod.rel, line,
                    f"ad-hoc os.environ read of {key!r} shadows the "
                    f"Config field {field!r} — use get_config().{field} "
                    "(env override, system_config, and type coercion all "
                    "apply there)",
                    meta={"key": key, "kind": "shadow", "field": field}))
            elif key not in contract:
                out.append(Finding(
                    "RT009", mod.rel, line,
                    f"os.environ read of {key!r} has no "
                    f"{CONTRACT_VAR} entry in core/config.py — "
                    "uncataloged spawn-env keys drift silently (add the "
                    "entry, or read it through get_config())",
                    meta={"key": key, "kind": "missing"}))
        for key, line in _environ_writes(mod, imported):
            writes.setdefault(key, (mod.rel, line))
    for key, line in sorted(contract.items()):
        if key not in reads:
            out.append(Finding(
                "RT009", config.rel, line,
            f"{CONTRACT_VAR} entry {key!r} is read nowhere in the "
                "package — stale contract surface, remove the entry "
                "(and any spawner still exporting it)",
                meta={"key": key, "kind": "stale"}))
    for key, (rel, line) in sorted(writes.items()):
        if key in contract or key in overrides:
            continue
        out.append(Finding(
            "RT009", rel, line,
            f"spawn-env export of {key!r} matches no {CONTRACT_VAR} "
            "entry and no Config field — dead env plumbing no child "
            "reads (remove it, or catalog the reader's contract)",
            meta={"key": key, "kind": "orphan-write"}))
    return out
