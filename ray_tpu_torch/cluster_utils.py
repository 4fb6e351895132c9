"""Multi-node test cluster on one machine.

Role-equivalent to the reference's ray.cluster_utils.Cluster
(reference: python/ray/cluster_utils.py:135 — multi-node without real
machines by running one raylet per "node" on localhost): the head runs
in-process via ray_tpu_torch.init(); each added node is a real
``ray_tpu_torch.core.node_main`` daemon subprocess with its own store session,
object-plane server, and worker pool.  remove_node() SIGKILLs the daemon to
simulate node failure (workers are told to exit by the head on the daemon's
disconnect).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import ADDRESS_ENV
from ray_tpu_torch.core.ids import NodeID


class NodeHandle:
    def __init__(self, node_id: NodeID, proc: subprocess.Popen, session: str,
                 drain_grace_s: Optional[float] = None):
        self.node_id = node_id
        self.proc = proc
        self.session = session
        # Grace window this node's daemon honors on SIGTERM (None = the
        # daemon default); graceful removal waits must outlast it.
        self.drain_grace_s = drain_grace_s

    @property
    def hex(self) -> str:
        return self.node_id.hex()


class ExternalHead:
    """A head daemon in its OWN process (``ray_tpu_torch.core.head_main``),
    supervised: spawn, wait-ready, SIGKILL, restart — the process shape the
    head-kill chaos harness needs (a driver-hosted head cannot be killed
    without killing the workload).  The spawn env pins the three identities
    a restart must preserve: port (``RT_HEAD_PORT``), session
    (``RT_HEAD_SESSION``), and local node id (``RT_NODE_ID``); pass
    ``state_path`` to make the durable tables survive too."""

    def __init__(
        self,
        state_path: Optional[str] = None,
        num_cpus: int = 4,
        num_workers: Optional[int] = None,
        env: Optional[Dict[str, str]] = None,
    ):
        import socket as _socket

        self.session = f"xhead-{os.urandom(4).hex()}"
        self.node_id = NodeID.from_random()
        self.state_path = state_path
        # Reserve a port up front: the head must rebind the SAME one after
        # a kill, and the reconnecting field already holds the address.
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        self.port = s.getsockname()[1]
        s.close()
        self.addr = f"127.0.0.1:{self.port}"
        self._extra_env = dict(env or {})
        self._num_cpus = num_cpus
        self._num_workers = num_workers
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.start()

    def _spawn_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        env.pop(ADDRESS_ENV, None)
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = (
            pkg_parent + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_parent
        )
        env.update(
            RT_HEAD_PORT=str(self.port),
            RT_HEAD_SESSION=self.session,
            RT_NODE_ID=self.node_id.hex(),
            RT_NODE_RESOURCES=json.dumps(
                {"CPU": float(self._num_cpus), "memory": float(2**33)}),
            RT_NODE_NUM_WORKERS=str(
                self._num_workers if self._num_workers is not None
                else self._num_cpus),
        )
        if self.state_path:
            env["RT_HEAD_STATE_PATH"] = self.state_path
        env.update(self._extra_env)
        return env

    def start(self, timeout: float = 60.0):
        from ray_tpu_torch.core.node_main import LOG_ROOT

        log_dir = os.path.join(LOG_ROOT, self.session)
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(
            log_dir, f"head-{self.restarts}-{time.time_ns()}.log")
        logf = open(log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.head_main"],
            env=self._spawn_env(),
            stdout=logf, stderr=subprocess.STDOUT,
        )
        logf.close()
        self._log_path = log_path
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                with open(log_path, "rb") as f:
                    tail = f.read()[-4000:].decode(errors="replace")
                raise RuntimeError(
                    f"external head exited at boot (rc={self.proc.returncode}):\n{tail}")
            try:
                with open(log_path, "rb") as f:
                    if b"RAY_TPU_HEAD_READY" in f.read():
                        return self
            except OSError:
                pass
            time.sleep(0.05)
        raise TimeoutError("external head never reported ready")

    def kill(self):
        """SIGKILL — the crash being simulated.  No cleanup runs."""
        if self.proc is not None:
            try:
                self.proc.kill()
            except ProcessLookupError:
                pass
            self.proc.wait(timeout=10)

    def restart(self, timeout: float = 60.0):
        """Respawn with the identical identity env (port/session/node id/
        state path): the restarted head restores its durable snapshot and
        waits for field-state resync."""
        self.restarts += 1
        return self.start(timeout=timeout)

    def shutdown(self):
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.terminate()
                self.proc.wait(timeout=10)
            except Exception:
                try:
                    self.proc.kill()
                    self.proc.wait(timeout=5)
                except Exception:
                    pass
        # Sweep the head-node session's segments (a killed head never
        # cleaned /dev/shm).
        import glob

        for path in glob.glob(f"/dev/shm/rtpt-{self.session}-*") + glob.glob(
            f"/dev/shm/rtpt-pool-{self.session}/*"
        ):
            try:
                os.unlink(path)
            except OSError:
                pass
        try:
            os.rmdir(f"/dev/shm/rtpt-pool-{self.session}")
        except OSError:
            pass


class Cluster:
    def __init__(
        self,
        head_num_cpus: int = 2,
        head_resources: Optional[Dict[str, float]] = None,
        system_config: Optional[dict] = None,
    ):
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        ray_tpu_torch.init(
            num_cpus=head_num_cpus,
            resources=head_resources,
            system_config=system_config,
        )
        from ray_tpu_torch.core.context import ctx

        self.head_addr = os.environ[ADDRESS_ENV]
        self.head_node_id: NodeID = ctx.client.node_id
        self.nodes: List[NodeHandle] = []
        # Nodes preempted (SIGTERM'd) but possibly still draining: no
        # longer schedulable members, yet shutdown must still kill and
        # reap their daemons (a test can finish inside the grace window).
        self._preempted: List[NodeHandle] = []
        # Every session this cluster ever created (including killed nodes,
        # whose daemons died before they could clean /dev/shm) — swept on
        # shutdown so crash-simulation tests don't leak segments.
        self._sessions: List[str] = []

    @classmethod
    def attach(cls, head_addr: str) -> "Cluster":
        """Attach to an already-initialized cluster (no head startup):
        add_node/remove_node then manage daemons against it — used by the
        autoscaler's LocalNodeProvider."""
        self = cls.__new__(cls)
        self.head_addr = head_addr
        # Fail fast on a bad address: a wrong/stale head_addr would
        # otherwise construct fine and only surface minutes later as the
        # first add_node timing out.
        from ray_tpu_torch.core.rpc import RpcClient

        host, _, port = head_addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"cluster address {head_addr!r} is not host:port — "
                "attach() needs the head's control-plane address "
                "(RT_TORCH_ADDRESS / the value init() printed)"
            )
        probe = RpcClient(host, int(port), name="attach-probe")
        try:
            probe.call("ping", {}, timeout=10.0)
        finally:
            probe.close()
        from ray_tpu_torch.core.context import ctx

        self.head_node_id = ctx.client.node_id if ctx.client else None
        self.nodes = []
        self._preempted = []
        self._sessions = []
        return self

    def add_node(
        self,
        num_cpus: int = 2,
        resources: Optional[Dict[str, float]] = None,
        num_workers: Optional[int] = None,
        labels: Optional[Dict[str, str]] = None,
        timeout: float = 30.0,
        drain_grace_s: Optional[float] = None,
    ) -> NodeHandle:
        node_id = NodeID.from_random()
        session = f"node-{os.urandom(6).hex()}"
        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus))
        res.setdefault("memory", float(2**33))
        env = dict(os.environ)
        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = (
            pkg_parent + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else pkg_parent
        )
        env.update(
            RT_HEAD_ADDR=self.head_addr,
            RT_NODE_ID=node_id.hex(),
            RT_NODE_SESSION=session,
            RT_NODE_RESOURCES=json.dumps(res),
            RT_NODE_LABELS=json.dumps(labels or {}),
            RT_NODE_NUM_WORKERS=str(
                num_workers if num_workers is not None else num_cpus
            ),
        )
        if drain_grace_s is not None:
            # Grace window between SIGTERM (preemption notice) and daemon
            # exit — the window a training gang has to checkpoint.
            env["RT_DRAIN_GRACE_S"] = str(drain_grace_s)
        from ray_tpu_torch.core.node_main import LOG_ROOT

        log_dir = os.path.join(LOG_ROOT, session)
        os.makedirs(log_dir, exist_ok=True)
        logf = open(os.path.join(log_dir, "node-daemon.log"), "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.node_main"],
            env=env,
            stdout=logf,
            stderr=subprocess.STDOUT,
        )
        logf.close()
        handle = NodeHandle(node_id, proc, session, drain_grace_s)
        self._sessions.append(session)
        self._wait_registered(node_id, timeout)
        self.nodes.append(handle)
        return handle

    def _wait_registered(self, node_id: NodeID, timeout: float):
        deadline = time.monotonic() + timeout
        want = node_id.hex()
        while time.monotonic() < deadline:
            if any(n["node_id"] == want and n["alive"]
                   for n in ray_tpu_torch.nodes()):
                return
            time.sleep(0.05)
        raise TimeoutError(f"node {want[:12]} did not register in {timeout}s")

    def preempt_node(self, node: NodeHandle) -> NodeHandle:
        """Announce a preemption: SIGTERM the daemon and return immediately.
        The node reports DRAINING to the head, keeps running through its
        grace window (RT_DRAIN_GRACE_S / add_node(drain_grace_s=...)), then
        exits — the spot/maintenance preemption shape, vs remove_node's
        wait-for-death."""
        try:
            node.proc.send_signal(signal.SIGTERM)
        except ProcessLookupError:
            pass
        if node in self.nodes:
            self.nodes.remove(node)
        self._preempted.append(node)
        return node

    def remove_node(self, node: NodeHandle, graceful: bool = False,
                    wait: bool = True):
        """Kill a node daemon (SIGKILL = crash simulation; graceful=True
        drains first).  The head notices the disconnect, fails over its
        tasks/actors, and purges its object locations.

        ``wait=False`` (graceful only) returns right after the SIGTERM and
        reaps the daemon opportunistically — the autoscaler's scale-down
        path uses it so its single reconcile thread never blocks on a
        drain cycle (a drain is ~a second even for an idle node)."""
        sig = signal.SIGTERM if graceful else signal.SIGKILL
        try:
            node.proc.send_signal(sig)
        except ProcessLookupError:
            pass
        if graceful and not wait:
            if node in self.nodes:
                self.nodes.remove(node)
            self._preempted.append(node)
            # Opportunistic reap of earlier no-wait removals/preemptions so
            # a long-lived autoscaler doesn't accumulate zombies (poll()
            # reaps an exited child); shutdown sweeps whatever remains.
            for prev in list(self._preempted):
                if prev is not node and prev.proc.poll() is not None:
                    self._preempted.remove(prev)
            return
        # A graceful remove rides the drain protocol: the daemon exits only
        # after its grace window, so the wait must outlast it — including
        # custom (long) grace windows set at add_node time.
        if graceful:
            grace = node.drain_grace_s if node.drain_grace_s is not None \
                else float(os.environ.get("RT_DRAIN_GRACE_S", "5"))
            node.proc.wait(timeout=grace + 30)
        else:
            node.proc.wait(timeout=10)
        deadline = time.monotonic() + 10
        want = node.hex
        while time.monotonic() < deadline:
            if not any(n["node_id"] == want for n in ray_tpu_torch.nodes()):
                break
            time.sleep(0.05)
        if node in self.nodes:
            self.nodes.remove(node)

    def shutdown(self):
        # Preempted daemons may still be inside their grace window: kill
        # and reap them too, or they outlive the cluster (and zombie).
        for node in list(self.nodes) + self._preempted:
            try:
                node.proc.kill()
            except ProcessLookupError:
                pass
            try:
                node.proc.wait(timeout=10)
            except Exception:
                pass
        self.nodes.clear()
        self._preempted.clear()
        ray_tpu_torch.shutdown()
        # Sweep segments left by nodes that died without cleanup (SIGKILL
        # crash simulation): the store daemon owns unlinking in normal
        # operation, so anything still present belongs to a killed node.
        import glob

        for session in self._sessions:
            for path in glob.glob(f"/dev/shm/rtpt-{session}-*") + glob.glob(
                f"/dev/shm/rtpt-pool-{session}/*"
            ):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            try:
                os.rmdir(f"/dev/shm/rtpt-pool-{session}")
            except OSError:
                pass
        self._sessions.clear()
