"""RT004: user-facing remote-function footguns.

Two patterns that work in toy runs and bite at scale:

- ``ray_tpu_torch.get()`` inside a remote function body: the worker parks in a
  blocking get while holding its pool slot; deep enough nesting (or an
  actor awaiting its own queue) deadlocks the cluster.  The framework
  mitigates plain-task nesting via ``task_blocked`` resource release, but
  every such site deserves a look — vetted ones go in the allowlist.
- closure captures in nested remote functions: captured values are
  serialized into the function blob and re-shipped on every submission;
  a captured array silently multiplies submission cost.  Pass data as
  arguments (object-store refs ship once) instead.
"""

from __future__ import annotations

import ast
import builtins
from typing import List

from .astutil import (call_name, decorator_names, enclosing_functions,
                      local_names, module_scope_names, parent_map,
                      walk_own_body)
from .rtlint import Finding, Project

GET_CALLS = {"ray_tpu_torch.get", "api.get", "rt.get"}
REMOTE_DECORATORS = {"remote", "ray_tpu_torch.remote", "api.remote",
                     "rt.remote"}
_BUILTINS = set(dir(builtins))


def _remote_defs(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if any(d in REMOTE_DECORATORS for d in decorator_names(node)):
                yield node


def check_rt004(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for module in project.modules:
        parents = parent_map(module.tree)
        mod_names = module_scope_names(module.tree)
        for rdef in _remote_defs(module.tree):
            # -- nested get anywhere in the remote body -----------------------
            for node in ast.walk(rdef):
                if isinstance(node, ast.Call) \
                        and call_name(node) in GET_CALLS:
                    out.append(Finding(
                        "RT004", module.rel, node.lineno,
                        f"ray_tpu_torch.get() inside remote {rdef.name!r} — "
                        "nested blocking get; prefer passing refs as "
                        "arguments (auto-resolved) or restructuring to "
                        "avoid the worker parking on the result",
                    ))
            # -- closure captures in nested remote functions ------------------
            if isinstance(rdef, ast.ClassDef):
                continue
            enclosing = enclosing_functions(rdef, parents)
            if not enclosing:
                continue
            own = local_names(rdef)
            captured = set()
            for node in walk_own_body(rdef):
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Load) \
                        and node.id not in own \
                        and node.id not in mod_names \
                        and node.id not in _BUILTINS:
                    for encl in enclosing:
                        if node.id in local_names(encl):
                            captured.add(node.id)
                            break
            if captured:
                out.append(Finding(
                    "RT004", module.rel, rdef.lineno,
                    f"remote {rdef.name!r} captures enclosing-scope "
                    f"variable(s) {sorted(captured)} — captures are "
                    "serialized into the function blob and re-shipped on "
                    "every submission; pass them as arguments or "
                    "ray_tpu_torch.put() them once",
                ))
    return out
