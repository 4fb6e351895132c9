"""Runtime recompile sentinel: a trace-count registry for the port's
programs (port of ``ray_tpu/devtools/jitguard.py``).

The serving perf story rests on ONE specialization per hot program: the
engine's ``decode_traces`` stays flat after warmup, and the flight recorder
attributes any step that met a new program signature.  PyTorch runs
eagerly and compiles nothing per shape, so on the port a "trace" is the
first run of a program with a new signature (the shapes, dtypes and devices
of its tensor arguments and its static config, which is what a jit
specialization keys on); ``models/paged.py`` bumps this registry when that
happens, and a first run on the card may include a kernel's build at first
use.

- **disabled** (default): :func:`bump` is a plain counter increment, done
  only when a signature is new (never per call).
- **enabled** (``RT_DEBUG_JIT=1``): after :func:`arm` (the engine calls it
  at the end of ``warmup()``; tests can call it directly), any growth in an
  armed program's trace count raises :class:`RecompileError` naming the
  program, the argument shape/dtype/device delta against the last
  signature, and the call site: the steady-state loop fails loudly at the
  FIRST stray specialization.

``models.paged`` keeps its ``trace_count``/``trace_counts`` names as aliases
over this registry.  This module imports nothing of JAX and nothing of
``ray_tpu``.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Dict, Optional

ENV_FLAG = "RT_DEBUG_JIT"


class RecompileError(RuntimeError):
    """An armed program met a new signature after warmup: some argument's
    shape/dtype/device or static value drifted on the hot path."""


def enabled() -> bool:
    """Sentinel armed-on-arm()?  Off means :func:`arm` is a no-op and
    :func:`bump` stays the identity counter path."""
    return os.environ.get(ENV_FLAG, "") in ("1", "true", "yes")


# Registry state.  Locked: programs may run on different threads.  Bumps
# happen only on a new signature, never per step.
_lock = threading.Lock()
_counts: Dict[str, int] = {}
_sigs: Dict[str, Any] = {}          # program -> last signature
_baseline: Dict[str, int] = {}      # armed program -> count at arm()


def reset_sentinel_state() -> None:
    """Forget every count, signature, and armed baseline (tests)."""
    with _lock:
        _counts.clear()
        _sigs.clear()
        _baseline.clear()


def register_program(name: str) -> None:
    """Declare a program.  Registration before the first trace makes it
    visible in :func:`counts` snapshots at 0.  Re-registering an ARMED
    program stands its baseline down until the next :func:`arm`: building a
    new component that shares the program (a fresh engine or adapter pool)
    opens a legitimate compile phase, not a hot-path recompile."""
    with _lock:
        _counts.setdefault(name, 0)
        _baseline.pop(name, None)


def count(name: str) -> int:
    """Times the named program was traced (met a new signature)."""
    return _counts.get(name, 0)


def counts() -> Dict[str, int]:
    """Snapshot of every registered program's trace count."""
    with _lock:
        return dict(_counts)


def signature_of(arrays: Dict[str, Any]) -> Dict[str, Any]:
    """Shape/dtype/device signature of named tensors (other values by type
    and repr): what a program passes to :func:`bump` so a post-warmup
    recompile can say WHICH argument drifted."""
    out: Dict[str, Any] = {}
    for k, v in arrays.items():
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is not None:
            out[k] = (tuple(shape), str(dtype), str(getattr(v, "device", "")))
        else:
            out[k] = f"{type(v).__name__}:{v!r}"[:80]
    return out


def _delta(old: Optional[Dict[str, Any]],
           new: Optional[Dict[str, Any]]) -> str:
    if not isinstance(old, dict) or not isinstance(new, dict):
        return f"prev={old!r} now={new!r}"
    parts = []
    for k in sorted(set(old) | set(new)):
        a, b = old.get(k), new.get(k)
        if a != b:
            parts.append(f"{k}: {a!r} -> {b!r}")
    return "; ".join(parts) if parts else "identical visible signature " \
        "(a static arg or closure constant changed)"


def _call_site(stacklevel: int) -> str:
    """The frame ``stacklevel`` levels up from :func:`bump`'s caller (1 is
    the caller itself), torch's own frames (decorators, context managers)
    skipped: the call that met the new signature, which an operator can go
    fix.  A shallower stack gives its outermost frame."""
    frames = [f for f in traceback.extract_stack()
              if f.filename != __file__
              and "/torch/" not in f.filename.replace("\\", "/")]
    if not frames:
        return "<unknown>"
    f = frames[-min(stacklevel, len(frames))]
    return f"{f.filename}:{f.lineno} in {f.name}"


def bump(name: str, signature: Optional[Dict[str, Any]] = None,
         stacklevel: int = 2) -> None:
    """Record one trace of ``name``: called by a program when it meets a
    new signature.  When the sentinel is armed and this program's baseline
    is exceeded, raise :class:`RecompileError` with the signature delta and
    the call site, ``stacklevel`` frames up (2, the default, is the caller
    of the program that called ``bump``)."""
    with _lock:
        n = _counts.get(name, 0) + 1
        _counts[name] = n
        prev_sig = _sigs.get(name)
        if signature is not None:
            _sigs[name] = signature
        baseline = _baseline.get(name)
    if baseline is not None and n > baseline:
        raise RecompileError(
            f"program {name!r} recompiled after warmup (trace "
            f"{n} > armed baseline {baseline}): arg delta "
            f"[{_delta(prev_sig, signature)}] — triggered at "
            f"{_call_site(stacklevel)}"
        )


def arm(force: bool = False) -> bool:
    """Freeze every currently registered program's trace count as its
    baseline.  No-op (returns False) unless ``RT_DEBUG_JIT=1`` or
    ``force``.  Programs registered AFTER arming are unarmed until the next
    :func:`arm`."""
    if not (enabled() or force):
        return False
    with _lock:
        _baseline.clear()
        _baseline.update(_counts)
    return True


def disarm() -> None:
    with _lock:
        _baseline.clear()


def armed() -> bool:
    return bool(_baseline)
