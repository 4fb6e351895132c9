"""Chaos-testing utilities: kill workers/nodes on a cadence (port of
``ray_tpu/util/chaos.py``, unchanged but for the package's name).

Role-equivalent to the reference's fault-injection test tooling
(reference: python/ray/_private/test_utils.py:1433 ResourceKillerActor,
:1500 NodeKillerBase, :1597 WorkerKillerActor; the release chaos harness
at release/nightly_tests/setup_chaos.py) — used by resilience tests and
available to users who want to soak their own pipelines against failures.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Optional


class WorkerKiller:
    """SIGKILLs a random busy worker every ``interval_s`` until stopped.

    Runs in the driver (it needs os.kill on local pids; remote workers die
    through their node daemon's kill route when the head requests it — for
    cross-node chaos use NodeKiller).  Retriable tasks should still
    complete; the kill count is the assertion hook.
    """

    def __init__(self, interval_s: float = 1.0, seed: int = 0,
                 states: tuple = ("leased",)):
        self.interval_s = interval_s
        self.states = states
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills = 0

    def _loop(self):
        from ray_tpu_torch.core.context import ctx

        local_node = (
            ctx.client.node_id.hex()
            if ctx.client and ctx.client.node_id else None
        )
        while not self._stop.wait(self.interval_s):
            try:
                workers = ctx.client.call(
                    "list_state", {"kind": "workers"}
                )["items"]
            except Exception:
                continue
            busy = [
                w for w in workers
                if w.get("state") in self.states and w.get("pid")
                # os.kill is only valid for pids this host owns: never
                # signal a pid reported by another node's daemon.
                and (local_node is None or w.get("node_id") == local_node)
            ]
            if not busy:
                continue
            victim = self._rng.choice(busy)
            try:
                os.kill(victim["pid"], signal.SIGKILL)
                self.kills += 1
            except (ProcessLookupError, PermissionError):
                pass

    def start(self) -> "WorkerKiller":
        self._thread = threading.Thread(
            target=self._loop, name="worker-killer", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return self.kills

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class NodeKiller:
    """Removes random non-head nodes from a ``cluster_utils.Cluster`` on a
    cadence (reference: NodeKillerBase kills raylets) — exercises task
    re-scheduling, object reconstruction, and PG bundle re-placement."""

    def __init__(self, cluster, interval_s: float = 2.0, seed: int = 0,
                 max_kills: Optional[int] = None):
        self.cluster = cluster
        self.interval_s = interval_s
        self.max_kills = max_kills
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills = 0

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            if self.max_kills is not None and self.kills >= self.max_kills:
                return
            nodes = list(getattr(self.cluster, "nodes", []) or [])
            if not nodes:
                continue
            victim = self._rng.choice(nodes)
            try:
                self.cluster.remove_node(victim)
                self.kills += 1
            except Exception:
                pass

    def start(self) -> "NodeKiller":
        self._thread = threading.Thread(
            target=self._loop, name="node-killer", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return self.kills

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class PreemptionInjector:
    """Announced preemptions: SIGTERMs random non-head node daemons of a
    ``cluster_utils.Cluster`` on a cadence, leaving each node its drain
    grace window (vs NodeKiller's instant kill).  Models spot/maintenance
    preemption — the dominant real-world TPU failure: the node reports
    DRAINING, training gangs get the should_checkpoint() signal, and the
    node dies only after the grace period.

    ``delay_s`` postpones the first preemption (let the workload reach
    steady state); ``max_preemptions`` bounds the blast radius so a soak
    can assert recovery rather than starve the cluster.
    """

    def __init__(self, cluster, interval_s: float = 5.0, seed: int = 0,
                 max_preemptions: Optional[int] = 1,
                 delay_s: float = 0.0):
        self.cluster = cluster
        self.interval_s = interval_s
        self.delay_s = delay_s
        self.max_preemptions = max_preemptions
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.preemptions = 0
        self.preempted: list = []  # NodeHandles, in preemption order

    def preempt_one(self) -> bool:
        """Preempt one random remaining node now.  Returns False when the
        cluster has no non-head nodes left."""
        nodes = list(getattr(self.cluster, "nodes", []) or [])
        if not nodes:
            return False
        victim = self._rng.choice(nodes)
        try:
            self.cluster.preempt_node(victim)
        except Exception:
            return False
        self.preemptions += 1
        self.preempted.append(victim)
        return True

    def _loop(self):
        if self.delay_s and self._stop.wait(self.delay_s):
            return
        while True:
            if (self.max_preemptions is not None
                    and self.preemptions >= self.max_preemptions):
                return
            self.preempt_one()
            if self._stop.wait(self.interval_s):
                return

    def start(self) -> "PreemptionInjector":
        self._thread = threading.Thread(
            target=self._loop, name="preemption-injector", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return self.preemptions

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class HeadKillInjector:
    """SIGKILLs an :class:`~ray_tpu_torch.cluster_utils.ExternalHead` on a
    cadence and restarts it after a configurable outage window — the
    control-plane crash drill (reference: the GCS FT release tests kill
    the GCS process under load and assert raylets/workers resync).  Each
    cycle is
    kill → outage_s of headless cluster → restart-with-same-identity;
    nodes/workers ride their reconnect loops, drivers re-register, and the
    assertion hook is ``kills`` plus whatever invariants the workload
    checks (e.g. zero failed direct calls).

    ``delay_s`` postpones the first kill (let the workload reach steady
    state); ``max_kills`` bounds the blast radius so a soak asserts
    recovery rather than an endless outage.
    """

    def __init__(self, head, interval_s: float = 5.0,
                 outage_s: float = 1.0, max_kills: Optional[int] = 1,
                 delay_s: float = 0.0):
        self.head = head
        self.interval_s = interval_s
        self.outage_s = outage_s
        self.max_kills = max_kills
        self.delay_s = delay_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills = 0

    def kill_once(self) -> bool:
        """One full kill→outage→restart cycle, synchronously."""
        try:
            self.head.kill()
        except Exception:
            return False
        self.kills += 1
        self._stop.wait(self.outage_s)
        self.head.restart()
        return True

    def _loop(self):
        if self.delay_s and self._stop.wait(self.delay_s):
            return
        while True:
            if (self.max_kills is not None
                    and self.kills >= self.max_kills):
                return
            self.kill_once()
            if self._stop.wait(self.interval_s):
                return

    def start(self) -> "HeadKillInjector":
        self._thread = threading.Thread(
            target=self._loop, name="head-kill-injector", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        return self.kills

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class StragglerSchedule:
    """A parsed, seeded slow-rank schedule (the training-plane analogue of
    util/netfault.py's FaultSchedule): ONE gang rank — chosen by the seed —
    runs a fixed per-phase delay inside an arm-relative time window, and
    every other rank runs clean.  The gang observability plane must then
    name that rank (and the injected phase) in its straggler incident, and
    the incident must resolve once the window closes.

    Spec DSL — ``key=val`` pairs, comma-separated::

        phase=data,ms=300,ranks=4,dur=6      # seeded rank of 4, +300ms per
                                             # data fetch, for 6s from arm
        phase=compute,ms=150,rank=2          # explicit rank, no window

    Keys: ``phase`` is the training phase to slow (``data`` — inside the
    dataset-shard iterator, ``compute`` — at report() entry, ``checkpoint``
    — inside checkpoint staging).  ``ms`` is the added delay per injection
    point.  ``ranks`` is the gang world size the seeded rank is drawn from
    (``rank=`` pins it explicitly instead).  ``at``/``dur`` bound the
    schedule to an arm-relative window (seconds) — a bounded window is how
    chaos tests assert the incident RESOLVES after heal.

    Armed two ways, mirroring netfault: ``RT_CHAOS_STRAGGLER`` +
    ``RT_CHAOS_SEED`` in the environment (children inherit, so one export
    covers a spawned gang) or :func:`arm_straggler` in-process.  Zero
    overhead when off: the injection sites check one module global against
    ``None`` and touch nothing else.
    """

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self.phase = "data"
        self.ms = 100.0
        self.at = 0.0
        self.dur: Optional[float] = None
        rank: Optional[int] = None
        ranks = 1
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            if key == "phase":
                if val not in ("data", "compute", "checkpoint"):
                    raise ValueError(
                        f"straggler: unknown phase {val!r} "
                        "(data|compute|checkpoint)")
                self.phase = val
            elif key == "ms":
                self.ms = float(val)
            elif key == "rank":
                rank = int(val)
            elif key == "ranks":
                ranks = int(val)
            elif key == "at":
                self.at = float(val)
            elif key == "dur":
                self.dur = float(val)
            else:
                raise ValueError(f"straggler: unknown spec key {key!r}")
        # Seeded rank choice — chaos_soak rotates the seed so every soak
        # iteration slows a different rank, and a failure replays from the
        # printed seed.
        self.rank = rank if rank is not None \
            else random.Random(self.seed).randrange(max(1, ranks))
        self._t0 = time.monotonic()
        self.delays = 0  # injections performed (assertion hook)

    def delay_s(self, phase: str, rank: int) -> float:
        if rank != self.rank or phase != self.phase:
            return 0.0
        t = time.monotonic() - self._t0
        if t < self.at or (self.dur is not None and t >= self.at + self.dur):
            return 0.0
        return self.ms / 1000.0

    def describe(self) -> str:
        win = "" if self.dur is None else f" at={self.at} dur={self.dur}"
        return (f"straggler rank={self.rank} phase={self.phase} "
                f"ms={self.ms:g}{win}")


_straggler: Optional[StragglerSchedule] = None
_straggler_env_checked = False


def arm_straggler(spec: str, seed: int = 0) -> StragglerSchedule:
    """Arm a straggler schedule in THIS process (tests; env arming covers
    spawned ranks).  Replaces any armed schedule; returns it for
    assertions."""
    global _straggler
    _straggler = StragglerSchedule(spec, seed)
    print(f"chaos: armed {_straggler.describe()} seed={seed}", flush=True)
    return _straggler


def disarm_straggler() -> None:
    global _straggler
    _straggler = None


def maybe_straggle(phase: str, rank: int) -> float:
    """Injection hook the train session's phase paths call.  Sleeps the
    scheduled delay when THIS (rank, phase) is the victim inside the arm
    window; free when nothing is armed (one global None-check after the
    lazy one-time env probe)."""
    global _straggler, _straggler_env_checked
    s = _straggler
    if s is None:
        if _straggler_env_checked:
            return 0.0
        _straggler_env_checked = True
        spec = os.environ.get("RT_CHAOS_STRAGGLER")
        if not spec:
            return 0.0
        s = _straggler = StragglerSchedule(
            spec, int(os.environ.get("RT_CHAOS_SEED", "0") or 0))
        print(f"chaos: armed {s.describe()} (env)", flush=True)
    d = s.delay_s(phase, rank)
    if d > 0:
        s.delays += 1
        time.sleep(d)
    return d


def run_under_chaos(fn, *, interval_s: float = 0.5, timeout_s: float = 60.0,
                    seed: int = 0):
    """Run ``fn()`` while a WorkerKiller fires; returns (result, kills).
    The canonical soak shape (reference: chaos tests wrap a workload with
    setup_chaos).  ``timeout_s`` bounds a HUNG workload — the exact
    failure a chaos soak exists to catch — by running it on a worker
    thread; on timeout the thread is abandoned (daemonic) and
    TimeoutError raised."""
    killer = WorkerKiller(interval_s=interval_s, seed=seed).start()
    box: dict = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=target, name="chaos-workload", daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    try:
        if t.is_alive():
            raise TimeoutError(
                f"workload still running after {timeout_s}s under chaos"
            )
        if "error" in box:
            raise box["error"]
        return box["result"], killer.kills
    finally:
        killer.stop()
