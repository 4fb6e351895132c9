"""Developer tooling of the port (the twin of ``ray_tpu/devtools/``).

- **rtlint** (``python -m ray_tpu_torch lint``,
  :mod:`ray_tpu_torch.devtools.rtlint`): AST-based static analysis that
  knows this framework's idioms, rules RT001-RT012; vetted exceptions live
  in ``ray_tpu_torch/.rtlint-allowlist``.
- **lock sentinel** (:mod:`ray_tpu_torch.devtools.locks`): an opt-in
  (``RT_DEBUG_LOCKS=1``) instrumented lock used by ``core/``, the dynamic
  complement to rule RT002.
- **recompile sentinel** (:mod:`ray_tpu_torch.devtools.jitguard`): a
  registered program meeting a new signature after warmup raises under
  ``RT_DEBUG_JIT=1``, the runtime half of rule RT010.
"""

from __future__ import annotations


def __getattr__(name):
    # Lazy: importing devtools.locks from core/ at startup must not drag
    # the whole lint engine in.
    if name in ("run_lint", "Finding", "main"):
        from . import rtlint

        return getattr(rtlint, name)
    if name in ("make_lock", "make_rlock", "LockOrderError"):
        from . import locks

        return getattr(locks, name)
    raise AttributeError(name)
