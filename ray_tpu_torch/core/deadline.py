"""Unified deadline/backoff policy for every RPC path.

Role-equivalent to the reference's retryable-RPC plumbing (reference:
src/ray/rpc/retryable_grpc_client.h — one client-level policy of timeouts
and exponential backoff shared by every GCS call, instead of per-call-site
constants).  Before this module, each path carried its own ad-hoc shape:
``client.call`` hard-coded base/cap constants, the node and worker
reconnect loops each re-implemented jittered doubling, and peer calls had
NO in-flight deadline at all (only ``peer_connect_timeout_s``, which covers
the dial).  Every retry loop now shares:

- :class:`BackoffPolicy` — jittered exponential backoff, built once from
  config (``rpc_retry_base_s`` / ``rpc_retry_cap_s``), same curve on every
  path.
- :class:`Deadline` — a monotonic per-call budget.  Threaded through head
  calls (``head_restart_retry_window_s``), peer calls
  (``peer_call_deadline_s``, enforced by the dataplane watchdog), and the
  reconnect loops (``head_reconnect_deadline_s``).  A budget rides a task
  spec as ``spec["deadline_s"]`` (remaining seconds at hand-off), so a
  direct call retried via the head cannot exceed the submitter's original
  budget.

The retry/deadline counters live here too so every consumer emits through
one literal-named site (rtlint RT006).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional

from .config import get_config


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Jittered exponential backoff: delay(n) is ``base * multiplier**(n-1)``
    capped at ``cap``, scaled by a uniform factor in [1-jitter, 1+jitter]
    (the de-synchronizer: a head restart must not see every client redial
    on the same tick)."""

    base_s: float = 0.05
    multiplier: float = 2.0
    cap_s: float = 0.5
    jitter: float = 0.5

    def delay(self, attempt: int) -> float:
        d = min(self.base_s * (self.multiplier ** max(0, attempt - 1)),
                self.cap_s)
        return d * (1.0 - self.jitter + 2.0 * self.jitter * random.random())

    def sleep(self, attempt: int, deadline: "Optional[Deadline]" = None):
        """Sleep the attempt's delay, clipped to the deadline's remainder."""
        d = self.delay(attempt)
        if deadline is not None:
            d = min(d, max(0.0, deadline.remaining()))
        if d > 0:
            time.sleep(d)


class Deadline:
    """A monotonic expiry: the per-call budget every retry loop checks
    instead of counting attempts against ad-hoc windows."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = expires_at

    @classmethod
    def after(cls, budget_s: float) -> "Deadline":
        return cls(time.monotonic() + budget_s)

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def timeout(self, cap: Optional[float] = None) -> float:
        """A per-attempt timeout bounded by the remaining budget."""
        r = max(0.0, self.remaining())
        return r if cap is None else min(cap, r)


def call_policy() -> BackoffPolicy:
    """THE policy object: every RPC retry loop (idempotent head reads,
    reconnect loops, peer re-dials) backs off on this curve."""
    cfg = get_config()
    return BackoffPolicy(base_s=cfg.rpc_retry_base_s,
                         cap_s=cfg.rpc_retry_cap_s)


def reconnect_policy() -> BackoffPolicy:
    """Same curve, reconnect-scaled: redials of a down head start at 2x the
    call base and cap at the resync-grace-compatible 2 s (the head's
    ``head_resync_grace_s`` must exceed this cap for adoptions to win)."""
    cfg = get_config()
    return BackoffPolicy(base_s=max(0.1, 2 * cfg.rpc_retry_base_s),
                         cap_s=2.0)


# ------------------------------------------------------------------ metrics

_retry_counter = None
_deadline_counter = None


def count_retry(path: str):
    """One RPC attempt beyond the first, tagged by path ("head", "peer",
    "reconnect", "stream")."""
    global _retry_counter
    try:
        if _retry_counter is None:
            from ..util.metrics import get_counter

            _retry_counter = get_counter(
                "ray_tpu_rpc_retries_total",
                "RPC attempts beyond the first, by path",
                tag_keys=("path",),
            )
        _retry_counter.inc(1, tags={"path": path})
    except Exception:
        pass  # metrics must never fail a retry path


def count_deadline_exceeded(path: str):
    """A call abandoned because its deadline budget ran out."""
    global _deadline_counter
    try:
        if _deadline_counter is None:
            from ..util.metrics import get_counter

            _deadline_counter = get_counter(
                "ray_tpu_rpc_deadline_exceeded_total",
                "Calls abandoned at their deadline budget, by path",
                tag_keys=("path",),
            )
        _deadline_counter.inc(1, tags={"path": path})
    except Exception:
        pass
