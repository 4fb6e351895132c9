"""ServeController: the deployment reconcile loop (port of
``ray_tpu/serve/controller.py``; a replica's "GPU" resource becomes its
actor's ``num_gpus`` where the JAX controller passes "TPU" as
``num_tpus``).

Two deliberate changes from the JAX controller.  A live replica whose
health probe misses its 5-s deadline is replaced after ``PROBE_MISSES``
such passes in a row, not at the first (a failed probe still replaces it
at once).  And a starting replica does not hold the reconcile loop.  The
JAX loop waits up to 120 s for each new
replica's first ``ping``, so a replica pending on a busy card stalls every
deployment's reconcile, and on the timeout the pending actor is left to
take the card later for nobody.  Here a new replica sits in ``pending``
with its ``ping`` in flight; the loop marks it ready when the ``ping``
lands and kills it when the deadline passes or its deployment goes away.

Role-equivalent to the reference's ServeController
(reference: serve/_private/controller.py:86 run_control_loop:372 +
deployment_state.py:2312 DeploymentStateManager): holds target state per
deployment, reconciles actual replica actors toward it (create on deploy /
scale-up, drain on scale-down, replace on death), and serves routing tables
to handles.  Request-based autoscaling compares reported queue pressure to
target (reference: autoscaling_state.py).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch

CONTROLLER_NAME = "SERVE_CONTROLLER"

#: Seconds a starting replica has to answer its first ``ping``.
REPLICA_START_TIMEOUT_S = 120.0
#: Health probes in a row a live replica may leave unanswered past their
#: 5-s deadline before it is replaced (a probe that fails, as on a dead
#: actor, replaces it at once): on a loaded host one late answer is not a
#: dead replica (reference: serve's health_check_failure_threshold).
PROBE_MISSES = 3


def _publish_slo(name: str, spec: Optional[dict]):
    """Mirror a deployment's latency SLO targets into the head KV
    (``serve_slo:<deployment>``) so the head's health engine can run SLO
    burn-rate detection without a serve import.  ``spec=None`` clears the
    key on undeploy.  Best-effort: KV hiccups must not fail deploy()."""
    try:
        from ray_tpu_torch.core.context import ctx
        if ctx.client is None:
            return
        key = f"serve_slo:{name}"
        targets: Dict[str, float] = {}
        auto = (spec or {}).get("autoscaling") or {}
        ttft = auto.get("target_ttft_s")
        itl = auto.get("target_itl_s")
        if ttft:
            targets["ttft"] = float(ttft)
        if itl:
            targets["itl"] = float(itl)
        if spec is not None and targets:
            ctx.client.kv_put(key, json.dumps(targets).encode())
        else:
            ctx.client.kv_del(key)
    except Exception:
        pass


def _scale_decision(cur: int, min_r: int, max_r: int,
                    per_queue: float, target_q: float,
                    ttft_p90: Optional[float] = None,
                    target_ttft: Optional[float] = None,
                    stall_frac: Optional[float] = None,
                    target_stall_frac: float = 0.25) -> int:
    """Pure scaling decision (unit-testable without actors): breach of
    ANY signal scales up; scale-down needs ALL comfortably idle.
    TTFT is the user-facing SLO — queue depth alone under-scales an
    engine whose batch is full but whose queue drains slowly (every
    admitted sequence decodes for many steps, so a short queue can still
    mean seconds of time-to-first-token).  ``stall_frac`` is the engine's
    admission-stall pressure (InferenceEngine.slo_signals, fraction of
    the window the decode loop spent stalled on prefills): a saturated
    engine stalls BEFORE TTFT breaches, so reacting to it scales ahead
    of the user-visible miss."""
    breach = per_queue > target_q or (
        target_ttft is not None and ttft_p90 is not None
        and ttft_p90 > target_ttft) or (
        stall_frac is not None and stall_frac > target_stall_frac)
    idle = per_queue < target_q / 2 and (
        target_ttft is None or ttft_p90 is None
        or ttft_p90 < target_ttft / 2) and (
        stall_frac is None or stall_frac < target_stall_frac / 2)
    if breach and cur < max_r:
        return cur + 1
    if idle and not breach and cur > min_r:
        return cur - 1
    return cur


@ray_tpu_torch.remote(max_concurrency=8)
class ServeController:
    def __init__(self):
        # name -> target spec dict
        self.targets: Dict[str, dict] = {}
        # name -> list of {"handle": ActorHandle, "id": int}
        self.replicas: Dict[str, List[dict]] = {}
        # name -> starting replicas, each also with its first "ping" ref
        # and a deadline; touched only by the reconcile thread.
        self.pending: Dict[str, List[dict]] = {}
        self._next_replica_id = 0
        self._lock = threading.Lock()
        self._version = 0
        self._shutdown = False
        threading.Thread(target=self._control_loop, daemon=True,
                         name="serve-reconcile").start()

    # -- API -----------------------------------------------------------------

    def deploy(self, name: str, spec: dict) -> bool:
        """Set a deployment's target (create or update).  spec: cls_blob,
        init_args_blob, num_replicas, max_concurrent, resources,
        autoscaling (optional {min_replicas, max_replicas,
        target_ongoing_requests})."""
        with self._lock:
            old = self.targets.get(name)
            spec = dict(spec)
            spec["version"] = (old["version"] + 1) if old else 1
            self.targets[name] = spec
            self._version += 1
        _publish_slo(name, spec)
        return True

    def delete(self, name: str) -> bool:
        with self._lock:
            self.targets.pop(name, None)
            self._version += 1
        _publish_slo(name, None)
        return True

    def routing_table(self) -> dict:
        """Replica actor handles per deployment (handles reconstruct
        actor refs on the receiving side).  ``replica_ids`` carries the
        stable controller-issued id per replica, position-aligned with
        ``deployments`` — handles feed them to rendezvous hashing so
        model affinity survives scale events."""
        with self._lock:
            return {
                "version": self._version,
                "deployments": {
                    name: [r["handle"] for r in reps]
                    for name, reps in self.replicas.items()
                },
                "replica_ids": {
                    name: [r["id"] for r in reps]
                    for name, reps in self.replicas.items()
                },
            }

    def status(self) -> dict:
        with self._lock:
            return {
                name: {
                    "target_replicas": self._target_replicas(name),
                    "running_replicas": len(self.replicas.get(name, [])),
                    "version": spec["version"],
                }
                for name, spec in self.targets.items()
            }

    def ready(self, name: str) -> bool:
        with self._lock:
            spec = self.targets.get(name)
            if spec is None:
                return False
            # Only CURRENT-version replicas count: a redeploy isn't ready
            # while old-code replicas still serve.
            current = [
                r for r in self.replicas.get(name, [])
                if r["version"] == spec["version"]
            ]
            return len(current) >= max(1, self._target_replicas(name))

    def shutdown(self) -> bool:
        with self._lock:
            self._shutdown = True
            self.targets.clear()
        return True

    # -- reconcile -----------------------------------------------------------

    def _target_replicas(self, name: str) -> int:
        spec = self.targets.get(name)
        if spec is None:
            return 0
        auto = spec.get("autoscaling")
        if auto:
            return spec.get("_autoscaled", auto["min_replicas"])
        return spec.get("num_replicas", 1)

    def _control_loop(self):
        while True:
            time.sleep(0.2)
            with self._lock:
                if self._shutdown and not any(self.replicas.values()) \
                        and not any(self.pending.values()):
                    break
                targets = dict(self.targets)
            # Drop deployments no longer targeted (starting replicas too).
            for name in list(self.replicas):
                if name not in targets:
                    with self._lock:
                        dropped = self.replicas.pop(name, [])
                        self._version += 1
                    for r in dropped:
                        self._stop_replica(r)
            for name in list(self.pending):
                if name not in targets:
                    for r in self.pending.pop(name):
                        self._stop_replica(r)
            for name, spec in targets.items():
                self._reconcile(name, spec)

    def _reconcile(self, name: str, spec: dict):
        """One pass over deployment ``name`` toward ``spec``."""
        with self._lock:
            reps = list(self.replicas.get(name, ()))
        # Replace dead replicas and version-mismatched ones (rolling
        # update: new code/config -> new actors).  Health probes go out in
        # parallel; stragglers past the deadline count as dead (a single
        # hung replica must not stall the loop for every deployment).
        changed = False
        alive_flags = self._alive_many(reps)
        live = []
        for r, ok in zip(reps, alive_flags):
            # None: the probe missed its deadline; False: it failed.
            r["missed"] = r.get("missed", 0) + 1 if ok is None else 0
            if (r["version"] != spec["version"] or ok is False
                    or r["missed"] >= PROBE_MISSES):
                self._stop_replica(r)
                changed = True
            else:
                live.append(r)
        reps = live
        started = self._collect_started(name, spec)
        if started:
            reps.extend(started)
            changed = True
        pending = self.pending.setdefault(name, [])
        self._autoscale(name, spec, reps)
        want = self._target_replicas(name)
        while len(reps) + len(pending) < want:
            try:
                pending.append(self._start_replica(name, spec))
            except Exception:
                break
        while pending and len(reps) + len(pending) > want:
            self._stop_replica(pending.pop())
        while len(reps) > want:
            self._stop_replica(reps.pop())
            changed = True
        with self._lock:
            orphans = []
            if name in self.targets:
                self.replicas[name] = reps
            else:
                # Deleted during this pass: the next pass stops what
                # self.replicas and self.pending still hold; a replica
                # that became ready here is in neither, so stop it now.
                held = {r["id"] for r in self.replicas.get(name, ())}
                orphans = [r for r in reps if r["id"] not in held]
            if changed:
                self._version += 1
        for r in orphans:
            self._stop_replica(r)

    def _alive_many(self, reps: List[dict]) -> List[Optional[bool]]:
        """Each replica's probe: True (answered), False (failed: the actor
        is dead), None (no answer within the 5-s deadline)."""
        if not reps:
            return []
        try:
            refs = [r["handle"].ping.remote() for r in reps]
        except Exception:
            return [False] * len(reps)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=5)
        ready_set = set(ready)
        out: List[Optional[bool]] = []
        for ref in refs:
            if ref not in ready_set:
                out.append(None)  # straggler past the deadline
                continue
            try:
                out.append(ray_tpu_torch.get(ref, timeout=1) == "ok")
            except Exception:
                out.append(False)  # sealed with ActorDiedError etc.
        return out

    def _start_replica(self, name: str, spec: dict) -> dict:
        from .replica import ServeReplica

        self._next_replica_id += 1
        opts: Dict[str, Any] = {
            "max_concurrency": spec.get("max_concurrent", 8),
            "name": f"SERVE_REPLICA:{name}#{self._next_replica_id}",
        }
        res = spec.get("resources") or {}
        if res.get("CPU") is not None:
            opts["num_cpus"] = res["CPU"]
        if res.get("GPU"):
            opts["num_gpus"] = res["GPU"]
        handle = ServeReplica.options(**opts).remote(
            name, spec["cls_blob"], spec["init_args_blob"]
        )
        # Not waited on here: _collect_started reads the ping.
        return {"handle": handle, "id": self._next_replica_id,
                "version": spec["version"], "ping": handle.ping.remote(),
                "deadline": time.monotonic() + REPLICA_START_TIMEOUT_S}

    def _collect_started(self, name: str, spec: dict) -> List[dict]:
        """The starting replicas of ``name`` whose first ``ping`` landed,
        ready to route.  A replica of an older version, one whose ping
        failed and one past its deadline are killed; the rest stay
        pending."""
        ready: List[dict] = []
        keep: List[dict] = []
        for r in self.pending.get(name, []):
            if r["version"] != spec["version"]:
                self._stop_replica(r)
                continue
            done, _ = ray_tpu_torch.wait([r["ping"]], num_returns=1,
                                         timeout=0)
            if done:
                try:
                    ok = ray_tpu_torch.get(r["ping"], timeout=1) == "ok"
                except Exception:
                    ok = False
                if ok:
                    ready.append({k: r[k] for k in
                                  ("handle", "id", "version")})
                else:
                    self._stop_replica(r)
            elif time.monotonic() > r["deadline"]:
                self._stop_replica(r)
            else:
                keep.append(r)
        self.pending[name] = keep
        return ready

    def _stop_replica(self, r: dict):
        try:
            ray_tpu_torch.kill(r["handle"])
        except Exception:
            pass

    def _autoscale(self, name: str, spec: dict, reps: List[dict]):
        auto = spec.get("autoscaling")
        if not auto:
            return
        if not reps:
            spec.setdefault("_autoscaled", auto["min_replicas"])
            return
        # SLO path: when the deployment declares target_ttft_s, ask each
        # replica's user callable for engine signals (LLMServer
        # .engine_metrics -> InferenceEngine.slo_signals) and scale on
        # queue depth + recent TTFT p90.  Non-engine replicas (or a
        # signal call that fails) fall back to the queue-length probe.
        total_q = 0.0
        ttfts: List[float] = []
        stalls: List[float] = []
        target_ttft = auto.get("target_ttft_s")
        for r in reps:
            sig = None
            if target_ttft is not None:
                try:
                    sig = ray_tpu_torch.get(
                        r["handle"].handle_request.remote(
                            "engine_metrics", (), {}),
                        timeout=5)
                except Exception:
                    sig = None
            if isinstance(sig, dict):
                total_q += sig.get("queue_depth", 0)
                if sig.get("ttft_p90_s") is not None:
                    ttfts.append(sig["ttft_p90_s"])
                if sig.get("stall_frac") is not None:
                    stalls.append(sig["stall_frac"])
                continue
            try:
                total_q += ray_tpu_torch.get(r["handle"].queue_len.remote(),
                                       timeout=5)
            except Exception:
                pass
        per = total_q / max(1, len(reps))
        target = auto.get("target_ongoing_requests", 2)
        cur = spec.get("_autoscaled", auto["min_replicas"])
        cur = _scale_decision(
            cur, auto["min_replicas"], auto["max_replicas"], per, target,
            max(ttfts) if ttfts else None, target_ttft,
            max(stalls) if stalls else None,
            auto.get("target_stall_frac", 0.25))
        spec["_autoscaled"] = cur
        with self._lock:
            if name in self.targets:
                self.targets[name]["_autoscaled"] = cur


def get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        try:
            return ServeController.options(
                name=CONTROLLER_NAME, num_cpus=0
            ).remote()
        except Exception:
            # Raced another creator: the name is taken now.
            return ray_tpu_torch.get_actor(CONTROLLER_NAME)
