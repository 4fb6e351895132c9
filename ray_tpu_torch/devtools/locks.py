"""Runtime concurrency sentinel: instrumented locks for the control plane.

The dynamic complement to rtlint's RT002 (the C++ reference leans on TSAN
in CI for this).  ``core/`` creates its locks through :func:`make_lock` /
:func:`make_rlock`:

- **disabled** (default): returns a plain ``threading.Lock``/``RLock`` —
  the zero-overhead path, nothing is wrapped.
- **enabled** (``RT_DEBUG_LOCKS=1``): returns a :class:`SentinelLock` that
  records each thread's acquisition order, asserts one consistent GLOBAL
  ordering between lock name-classes (acquiring B while holding A after
  some thread ever acquired A while holding B raises
  :class:`LockOrderError` — the textbook ABBA deadlock, caught on the
  first inverted acquisition instead of the first lost race), detects
  same-instance re-entry on non-reentrant locks, and logs any lock held
  longer than ``RT_DEBUG_LOCKS_HOLD_S`` (default 1.0s — a held lock that
  long under a 0.2s control-plane tick is a stall in waiting).
- **race sentinel** (``RT_DEBUG_LOCKS=2``, implies level 1): classes
  decorated with :func:`guarded` enforce their declared guard map at
  runtime — every rebind of a field listed in ``_RT_GUARDED_BY`` asserts
  the named lock is held by the writing thread, else
  :class:`GuardViolation` names the class, field, guard, and thread.
  The same maps are what rtlint RT007 verifies statically; this is the
  dynamic twin (the role TSAN + ``GUARDED_BY`` annotations play in the
  C++ reference), soaked by ``scripts/chaos_soak.sh`` under
  ``RT_DEBUG_LOCKS=2``.  ``__init__`` is exempt (the object is not yet
  published); container mutation without a rebind is invisible to
  ``__setattr__`` — the swap idiom (``x, self._x = self._x, []``) the
  hot paths use is exactly what gets checked.

Ordering is tracked between lock *names* (one name per call site /
role, e.g. ``client.put_batch``), not instances: every ``Client`` has its
own ``_put_batch_lock`` but the safe order between the *roles* must be
globally consistent.  Same-name edges between different instances are
skipped — instances of one role are unordered peers.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("ray_tpu_torch.locks")

ENV_FLAG = "RT_DEBUG_LOCKS"
ENV_HOLD = "RT_DEBUG_LOCKS_HOLD_S"


class LockOrderError(RuntimeError):
    """Two lock name-classes were acquired in both orders — an ABBA
    deadlock waiting for the right thread interleaving."""


class GuardViolation(RuntimeError):
    """A field declared guarded (``_RT_GUARDED_BY``) was rebound by a
    thread that does not hold its guard lock — a data race, caught at the
    racing write instead of at the corrupted read."""


def level() -> int:
    """Sentinel level: 0 off, 1 ordering checks, 2 + guard-map races."""
    raw = os.environ.get(ENV_FLAG, "")
    if raw in ("1", "2"):
        return int(raw)
    return 0


def enabled() -> bool:
    return level() >= 1


def race_sentinel_enabled() -> bool:
    return level() >= 2


def _hold_threshold() -> float:
    try:
        return float(os.environ.get(ENV_HOLD, "1.0"))
    except ValueError:
        return 1.0


# Global ordering state: (first_name, then_name) -> where first observed.
# RLock, deliberately: dict inserts under it can allocate and trigger
# cyclic GC, and ObjectRef.__del__ acquires a SentinelLock (_free_lock)
# whose order check re-enters here on the SAME thread — a plain Lock
# would self-deadlock the debug run (the exact GC-reentrancy hazard
# core/object_ref.py documents for client locks).
_edges: Dict[Tuple[str, str], str] = {}
_edges_lock = threading.RLock()
_held = threading.local()  # per-thread stack of (SentinelLock, t_acquire)


def reset_sentinel_state() -> None:
    """Forget every observed ordering edge (tests)."""
    with _edges_lock:
        _edges.clear()


def _held_stack() -> List[tuple]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _order_path(src: str, dst: str) -> Optional[List[str]]:
    """BFS over recorded edges: the established acquisition chain
    ``src -> ... -> dst`` if one exists.  A GLOBAL ordering is consistent
    only if no such chain is ever inverted — checking just the direct edge
    would miss 3+-lock cycles (A->B, B->C, then C-while-holding... A)."""
    with _edges_lock:
        adj: Dict[str, List[str]] = {}
        for a, b in _edges:
            adj.setdefault(a, []).append(b)
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


def _site() -> str:
    """The caller's frame OUTSIDE this module — the acquire/release site an
    operator can actually go look at (wrapper-internal frames vary with the
    entry path: acquire() vs the ``with`` protocol)."""
    for f in reversed(traceback.extract_stack()):
        if f.filename != __file__:
            return f"{f.filename}:{f.lineno} in {f.name}"
    return "<unknown>"


class SentinelLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper with ordering checks."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    # -- checks ----------------------------------------------------------------

    def _check_order(self) -> None:
        """Raise BEFORE a blocking acquire that inverts an established
        order — the whole point is to fail loudly instead of deadlocking."""
        me = threading.current_thread().name
        for other, _ in _held_stack():
            if other is self:
                if not self.reentrant:
                    raise LockOrderError(
                        f"thread {me!r} re-acquiring non-reentrant lock "
                        f"{self.name!r} it already holds — guaranteed "
                        f"deadlock (at {_site()})"
                    )
                continue
            if other.name == self.name:
                continue  # peer instances of one role: unordered
            path = _order_path(self.name, other.name)
            if path is not None:
                with _edges_lock:
                    first_seen = _edges.get((path[0], path[1]), "<unknown>")
                raise LockOrderError(
                    f"lock-order inversion: thread {me!r} acquires "
                    f"{self.name!r} while holding {other.name!r} (at "
                    f"{_site()}), but the opposite order "
                    f"{' -> '.join(repr(p) for p in path)} is established "
                    f"(first edge recorded at {first_seen}) — "
                    f"{'ABBA' if len(path) == 2 else 'cyclic'} deadlock"
                )

    def _record_edges(self) -> None:
        """Register held -> self ordering edges.  Called only after a
        SUCCESSFUL blocking acquire: a failed (or try-lock) attempt imposed
        no ordering, and try-lock-with-back-off is a legitimate
        deadlock-avoidance idiom that must not poison the edge table."""
        site = None
        for other, _ in _held_stack():
            if other is self or other.name == self.name:
                continue
            if site is None:
                site = _site()
            with _edges_lock:
                _edges.setdefault((other.name, self.name), site)

    def _on_acquired(self) -> None:
        _held_stack().append((self, time.monotonic()))

    def _on_release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is self:
                _, t0 = stack.pop(i)
                dt = time.monotonic() - t0
                if dt > _hold_threshold():
                    logger.warning(
                        "lock %r held %.3fs (> %.3fs threshold) — "
                        "released at %s",
                        self.name, dt, _hold_threshold(), _site(),
                    )
                return

    # -- lock protocol ---------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            self._check_order()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            if blocking:
                self._record_edges()
            self._on_acquired()
        return ok

    def release(self):
        self._on_release()
        self._lock.release()

    def locked(self):
        locked = getattr(self._lock, "locked", None)
        return locked() if locked is not None else False

    def held_by_current_thread(self) -> bool:
        return any(other is self for other, _ in _held_stack())

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<SentinelLock {self.name!r} reentrant={self.reentrant}>"


def make_lock(name: str):
    """A ``threading.Lock`` — instrumented when ``RT_DEBUG_LOCKS=1``."""
    if not enabled():
        return threading.Lock()
    return SentinelLock(name)


def make_rlock(name: str):
    """A ``threading.RLock`` — instrumented when ``RT_DEBUG_LOCKS=1``."""
    if not enabled():
        return threading.RLock()
    return SentinelLock(name, reentrant=True)


# -- guard-map race sentinel (RT_DEBUG_LOCKS=2) --------------------------------


def guarded(cls):
    """Class decorator enforcing the class's declared guard map at runtime.

    The map is the class attribute ``_RT_GUARDED_BY = {"field":
    "_lock_attr", ...}`` — the same declaration rtlint RT007 verifies
    statically.  Under ``RT_DEBUG_LOCKS=2`` every attribute REBIND of a
    listed field asserts the instance's guard lock is held by the current
    thread (``__init__`` exempt: the object is unpublished while it
    constructs).  Any other level returns the class untouched — the
    disabled path adds zero wrappers, zero per-write cost.
    """
    guards = getattr(cls, "_RT_GUARDED_BY", None)
    if not race_sentinel_enabled() or not guards:
        return cls

    orig_init = cls.__init__
    orig_setattr = cls.__setattr__

    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        object.__setattr__(self, "_rt_guards_armed", True)

    def __setattr__(self, name, value):
        lock_attr = guards.get(name)
        if lock_attr is not None \
                and getattr(self, "_rt_guards_armed", False):
            lock = getattr(self, lock_attr, None)
            if isinstance(lock, SentinelLock) \
                    and not lock.held_by_current_thread():
                raise GuardViolation(
                    f"guarded field {cls.__name__}.{name} rebound by "
                    f"thread {threading.current_thread().name!r} without "
                    f"holding its guard {lock.name!r} ({lock_attr}) — "
                    f"declared in {cls.__name__}._RT_GUARDED_BY; racing "
                    f"write at {_site()}"
                )
        orig_setattr(self, name, value)

    cls.__init__ = __init__
    cls.__setattr__ = __setattr__
    return cls
