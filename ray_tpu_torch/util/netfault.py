"""Deterministic network fault injection for the RPC transport.

Role-equivalent to the reference's network chaos tooling (reference:
release/nightly_tests/chaos_test/ + the gcs_health_check_manager tests that
perturb connection health): a seeded :class:`FaultSchedule` that
``core/rpc.py`` consults on every client send, client receive, and server
accept.  Unlike ``util/chaos.py`` (clean process kills), this layer models
the faults a real network serves: lost requests, lost replies, duplicated
replies, added latency, partitions between named endpoints, and gray
failures (a peer that accepts connections but never answers).

Armed two ways:

- ``RT_NETFAULT`` + ``RT_NETFAULT_SEED`` in the environment — every process
  that opens an RPC endpoint arms the same schedule spec (children inherit
  the env, so a cluster-wide partition needs one export).
- :func:`arm` / :func:`disarm` in-process (tests).

Zero overhead when off: the transport's hot paths check one module global
against ``None`` and touch nothing else.

Schedule DSL — semicolon-separated rules, ``kind:key=val,key=val``::

    drop_request:link=peer-direct,p=0.3      # lose 30% of peer requests
    drop_reply:link=driver-rpc,method=ping   # lose every ping reply
    dup_reply:link=peer-direct,p=0.1         # deliver 10% of replies twice
    delay:link=node-rpc,ms=50,dist=exp       # ~exp(50ms) added latency
    stall:link=peer-server,dur=5             # accept, answer nothing for 5s
    partition:link=node-rpc,at=1,dur=5       # head<->node dark for 5s
    partition:link=peer-direct,mode=out      # one-way: requests vanish,
                                             # replies still arrive

Keys: ``link=`` substring-matches the connection/server name (clients:
``driver-rpc``/``worker-rpc``/``node-rpc`` for the head link,
``peer-direct`` for the peer plane; servers: ``head-server``,
``node-server``, ``peer-server``).  ``method=`` exact-matches the RPC
method.  ``p=`` is the injection probability (default 1).  ``at=``/``dur=``
bound the rule to an arm-relative time window (seconds).  ``ms=`` is the
delay in milliseconds (``dist=exp`` draws from an exponential with that
mean; default fixed).  ``mode=sym|in|out`` sets partition direction
(symmetric, inbound-only — replies dropped, or outbound-only — requests
dropped).

Replayability: every probabilistic decision comes from a counter-indexed
``random.Random`` derived from (seed, rule, decision#) with integer
arithmetic only — the same seed and traffic order reproduce the same fault
sequence, and a soak failure replays from its printed seed.
"""

from __future__ import annotations

import random
import sys
import time
from typing import Dict, List, Optional

from ..devtools.locks import guarded, make_lock

KINDS = ("drop_request", "drop_reply", "delay", "dup_reply", "stall",
         "partition")


class _Rule:
    __slots__ = ("kind", "link", "method", "p", "at", "dur", "ms", "dist",
                 "mode")

    def __init__(self, kind: str):
        self.kind = kind
        self.link: Optional[str] = None
        self.method: Optional[str] = None
        self.p = 1.0
        self.at = 0.0
        self.dur: Optional[float] = None
        self.ms = 0.0
        self.dist = "fixed"
        self.mode = "sym"

    def describe(self) -> str:
        keys = []
        if self.link:
            keys.append(f"link={self.link}")
        if self.method:
            keys.append(f"method={self.method}")
        if self.p < 1.0:
            keys.append(f"p={self.p}")
        if self.at:
            keys.append(f"at={self.at}")
        if self.dur is not None:
            keys.append(f"dur={self.dur}")
        if self.kind == "delay":
            keys.append(f"ms={self.ms}")
        if self.kind == "partition" and self.mode != "sym":
            keys.append(f"mode={self.mode}")
        return f"{self.kind}:{','.join(keys)}" if keys else self.kind


def _parse(spec: str) -> List[_Rule]:
    rules: List[_Rule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"netfault: unknown fault kind {kind!r} (one of {KINDS})")
        rule = _Rule(kind)
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, _, val = kv.partition("=")
            if key == "link":
                rule.link = val
            elif key == "method":
                rule.method = val
            elif key == "p":
                rule.p = float(val)
            elif key == "at":
                rule.at = float(val)
            elif key == "dur":
                rule.dur = float(val)
            elif key == "ms":
                rule.ms = float(val)
            elif key == "dist":
                rule.dist = val
            elif key == "mode":
                rule.mode = val
            else:
                raise ValueError(f"netfault: unknown rule key {key!r}")
        rules.append(rule)
    return rules


@guarded
class FaultSchedule:
    """A parsed, seeded schedule.  Decision entry points are called from
    RPC loop threads (one per connection/server) concurrently."""

    # rtlint RT007 verifies these statically; RT_DEBUG_LOCKS=2 asserts the
    # guards at runtime (devtools.locks).
    _RT_GUARDED_BY = {
        "counts": "_lock",
        "_decisions": "_lock",
    }

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self.rules = _parse(spec)
        self._t0 = time.monotonic()
        self._lock = make_lock("netfault.decisions")
        #: per-rule decision counters — the replay index
        self._decisions = [0] * len(self.rules)
        #: injections actually performed, by kind (assertion hook)
        self.counts: Dict[str, int] = {}
        self._counter = None

    # ------------------------------------------------------------ matching

    def _window_open(self, rule: _Rule, now: float) -> bool:
        t = now - self._t0
        if t < rule.at:
            return False
        return rule.dur is None or t < rule.at + rule.dur

    @staticmethod
    def _match(rule: _Rule, link: str, method: Optional[str]) -> bool:
        if rule.link is not None and rule.link not in link:
            return False
        if rule.method is not None and method != rule.method:
            return False
        return True

    def _decide(self, idx: int, rule: _Rule) -> Optional[random.Random]:
        """One deterministic coin flip for rule ``idx``.  Integer-seeded so
        the sequence is independent of PYTHONHASHSEED and replays exactly
        for a given (seed, traffic order)."""
        with self._lock:
            n = self._decisions[idx]
            self._decisions[idx] = n + 1
        rng = random.Random((self.seed * 1_000_003 + idx) * 1_000_003 + n)
        if rule.p >= 1.0 or rng.random() < rule.p:
            return rng
        return None

    def _record(self, kind: str):
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
        try:
            if self._counter is None:
                from .metrics import get_counter

                self._counter = get_counter(
                    "ray_tpu_netfaults_injected_total",
                    "Network faults injected by the netfault schedule",
                    tag_keys=("kind",),
                )
            self._counter.inc(1, tags={"kind": kind})
        except Exception:
            pass  # metrics must never fail an injection site

    # ----------------------------------------------------------- decisions

    def on_send(self, link: str, method: str) -> Optional[dict]:
        """Client about to write a request frame.  Returns None (deliver)
        or {"kind": "drop"} / {"kind": "delay", "delay_s": s}."""
        now = time.monotonic()
        for idx, rule in enumerate(self.rules):
            if not self._window_open(rule, now):
                continue
            if not self._match(rule, link, method):
                continue
            if rule.kind == "drop_request" or (
                    rule.kind == "partition" and rule.mode in ("sym", "out")):
                if self._decide(idx, rule) is not None:
                    self._record(rule.kind)
                    return {"kind": "drop"}
            elif rule.kind == "delay":
                rng = self._decide(idx, rule)
                if rng is not None:
                    s = rule.ms / 1000.0
                    if rule.dist == "exp":
                        s = rng.expovariate(1.0 / s) if s > 0 else 0.0
                    self._record("delay")
                    return {"kind": "delay", "delay_s": s}
        return None

    def on_recv(self, link: str, method: str) -> Optional[dict]:
        """Client received a reply/push frame.  Returns None (deliver) or
        {"kind": "drop"} / {"kind": "dup"}."""
        now = time.monotonic()
        for idx, rule in enumerate(self.rules):
            if not self._window_open(rule, now):
                continue
            if not self._match(rule, link, method):
                continue
            if rule.kind == "drop_reply" or (
                    rule.kind == "partition" and rule.mode in ("sym", "in")):
                if self._decide(idx, rule) is not None:
                    self._record(rule.kind)
                    return {"kind": "drop"}
            elif rule.kind == "dup_reply":
                if self._decide(idx, rule) is not None:
                    self._record("dup_reply")
                    return {"kind": "dup"}
        return None

    def on_accept(self, link: str) -> float:
        """Server accepted a connection.  Returns seconds to stall before
        reading anything (0 = serve normally) — the gray-failure model: the
        TCP handshake succeeds, the peer looks alive, nothing answers."""
        now = time.monotonic()
        for idx, rule in enumerate(self.rules):
            if rule.kind != "stall" or not self._window_open(rule, now):
                continue
            if rule.link is not None and rule.link not in link:
                continue
            if self._decide(idx, rule) is not None:
                self._record("stall")
                if rule.dur is not None:
                    return max(0.0, (self._t0 + rule.at + rule.dur) - now)
                return 3600.0  # no window: stalled for the process's life
        return 0.0

    def describe(self) -> str:
        return "; ".join(r.describe() for r in self.rules)


# --------------------------------------------------------------- module API


def arm(spec: str, seed: int = 0) -> FaultSchedule:
    """Arm a schedule in THIS process (tests; env arming covers spawned
    children).  Replaces any armed schedule; returns it for assertions."""
    from ..core import rpc

    sched = FaultSchedule(spec, seed)
    rpc.set_fault_schedule(sched)
    print(f"netfault: armed seed={sched.seed} spec={spec!r}",
          file=sys.stderr, flush=True)
    return sched


def disarm():
    from ..core import rpc

    rpc.set_fault_schedule(None)


def current() -> Optional[FaultSchedule]:
    from ..core import rpc

    return rpc._netfault
