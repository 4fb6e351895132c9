"""Node daemon: the per-host runtime for non-head nodes.

Role-equivalent to the reference's raylet main
(reference: src/ray/raylet/main.cc, node_manager.h:119) combined with the
object-manager transfer server (src/ray/object_manager/object_manager.h:117):

- registers the node (resources, labels, worker cap, store session, and the
  address of its object-plane server) with the head,
- owns the node's shared-memory ObjectStore (accounting, LRU eviction,
  spill/restore) for segments created by its workers,
- spawns worker processes when the head pushes ``spawn_worker`` (the lease
  protocol stays centralized in the head; this daemon is the arm that forks
  processes on the right host),
- serves chunked ``pull_object`` reads so any process in the cluster can
  fetch this node's objects over TCP (the analog of the reference's chunked
  object push/pull, object_manager.h:63 object_chunk_size).

Scheduling decisions stay in the head — a deliberate simplification vs the
reference's distributed raylet scheduler that a TPU cluster's scale profile
(hundreds of hosts, gang-scheduled jobs) tolerates well.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..devtools.locks import guarded, make_lock
from .config import get_config, tmp_root
from .ids import NodeID, ObjectID
from .object_store import ObjectStore
from .rpc import RpcClient, RpcServer, ServerThread

PULL_CHUNK_BYTES = 8 * 1024 * 1024

# Bulk-channel wire format: request = object_id | offset u64 | length u64;
# response = u64 byte count (NOT_FOUND sentinel if the object is gone)
# followed by that many raw bytes (server-side os.sendfile from the shm
# segment — zero user-space copies).
BULK_NOT_FOUND = 0xFFFF_FFFF_FFFF_FFFF


class BulkServer(threading.Thread):
    """Raw-TCP object reads: the data plane of the object manager.

    The msgpack RPC channel tops out well under 1 GiB/s on large frames
    (pack/unpack + asyncio stream copies); bulk transfers skip all of it —
    the server sendfile()s straight from the segment file and the client
    recv_into()s straight into its staged mmap (reference:
    object_manager.h:125-139 runs object chunks on dedicated rpc streams for
    the same reason).  One thread per connection; pullers hold one
    connection per remote node."""

    def __init__(self, store: ObjectStore, session: str, host: str):
        super().__init__(daemon=True, name="bulk-server")
        self._store = store
        self._session = session
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]

    def run(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name="bulk-conn",
            ).start()

    def _serve(self, conn: socket.socket):
        from .object_store import _seg_path

        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        id_len = ObjectID.byte_len()
        try:
            while True:
                hdr = _recv_exact(conn, id_len + 16)
                if hdr is None:
                    return
                oid = ObjectID(hdr[:id_len])
                offset, length = struct.unpack_from("<QQ", hdr, id_len)
                # Pin first: a concurrent spill between get() and the open
                # below would unlink the segment and fail a live object.
                # The puller holds a reference so a free can't race us; pin
                # guards against spill eviction only.
                self._store.pin(oid)
                view = self._store.get(oid)  # restores from spill if needed
                if view is None:
                    self._store.unpin(oid)
                    conn.sendall(struct.pack("<Q", BULK_NOT_FOUND))
                    continue
                n = max(0, min(length, len(view) - offset))
                del view  # holding it would block pooling the segment later
                try:
                    fd = os.open(_seg_path(self._session, oid), os.O_RDONLY)
                except FileNotFoundError:
                    self._store.unpin(oid)
                    conn.sendall(struct.pack("<Q", BULK_NOT_FOUND))
                    continue
                try:
                    conn.sendall(struct.pack("<Q", n))
                    sent = 0
                    while sent < n:
                        sent += os.sendfile(
                            conn.fileno(), fd, offset + sent, n - sent
                        )
                    self._store.count_transferred(sent)
                finally:
                    os.close(fd)
                    self._store.unpin(oid)
        except (OSError, ConnectionError):
            pass
        finally:
            conn.close()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def _recv_exact(conn: socket.socket, n: int):
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


# Log files live under this root; ranged log reads refuse anything else so
# the read-log RPC can never be aimed at an arbitrary file.
LOG_ROOT = tmp_root("logs")
LOG_READ_MAX_BYTES = 4 * 1024 * 1024


def own_log_path() -> str:
    """This process's own log file, for registration with the head's log
    index: the spawner exports RT_LOG_PATH; processes started with plain
    stdout redirection (node daemons under cluster_utils) discover it from
    /proc, restricted to the cluster log root."""
    path = os.environ.get("RT_LOG_PATH", "")
    if path:
        return path
    try:
        target = os.readlink("/proc/self/fd/1")
        if target.startswith(LOG_ROOT + os.sep) and os.path.isfile(target):
            return target
    except OSError:
        pass
    return ""


def read_log_range(path: str, offset=0, max_bytes=65536) -> dict:
    """Ranged read of a registered log file.  Negative offsets address from
    the end (tail); replies carry `next_offset` so callers can stream
    (`follow`) without re-reading.  Shared by the node daemon's `read_log`
    handler and the head (which reads its own node's files directly)."""
    real = os.path.realpath(path or "")
    # realpath BOTH sides: on hosts where /tmp is itself a symlink (macOS
    # /tmp -> /private/tmp), the literal root would never prefix-match.
    root = os.path.realpath(LOG_ROOT)
    if not real.startswith(root + os.sep):
        return {"found": False,
                "error": f"log path {path!r} is outside {LOG_ROOT}"}
    try:
        size = os.path.getsize(real)
        off = int(offset)
        if off < 0:
            off = max(0, size + off)
        n = max(0, min(int(max_bytes), LOG_READ_MAX_BYTES))
        with open(real, "rb") as f:
            f.seek(off)
            data = f.read(n)
    except OSError as e:
        return {"found": False, "error": f"cannot read {path}: {e}"}
    return {
        "found": True,
        "data": data,
        "offset": off,
        "next_offset": off + len(data),
        "size": size,
        "eof": off + len(data) >= size,
    }


def make_log_read_handler():
    """`read_log` for a node's RPC server: the head routes `get_log` calls
    for this node's processes here (head -> owning node -> file).  Like
    the pull handler, validates its own schema row — node servers sit
    outside the head's ``_validated`` wrapper."""

    async def h_read_log(conn, body):
        from . import schema as wire_schema
        from .rpc import RpcError

        try:
            wire_schema.validate("read_log", body)
        except wire_schema.SchemaError as e:
            raise RpcError(str(e)) from None
        return read_log_range(
            body.get("path", ""), body.get("offset", 0),
            body.get("max_bytes", 65536),
        )

    return h_read_log


def make_pull_handler(store: ObjectStore):
    """Chunked object reads from a node store.  Shared by the node daemon and
    the head (which serves its own local node's objects).  Validates its own
    schema row: pull servers register outside the head's ``_validated``
    wrapper, and the boundary guarantee must hold on every server that
    speaks the method."""

    async def h_pull_object(conn, body):
        from . import schema as wire_schema
        from .rpc import RpcError

        try:
            wire_schema.validate("pull_object", body)
        except wire_schema.SchemaError as e:
            raise RpcError(str(e)) from None
        oid = ObjectID(body["object_id"])
        view = store.get(oid)  # restores from spill if needed
        if view is None:
            return {"found": False}
        offset = body.get("offset", 0)
        max_bytes = body.get("max_bytes", PULL_CHUNK_BYTES)
        chunk = bytes(view[offset:offset + max_bytes])
        store.count_transferred(len(chunk))
        return {"found": True, "size": len(view), "data": chunk}

    return h_pull_object


@guarded
class NodeDaemon:
    # Worker bookkeeping is shared between the spawner thread, push
    # handlers on the head-connection rpc loop, and the main daemon loop:
    # rtlint RT007 verifies the guards statically, RT_DEBUG_LOCKS=2
    # asserts them at runtime.  head/node_id are write-once publications:
    # set before (or guarded against) any handler that reads them can run.
    _RT_GUARDED_BY = {
        "worker_pids": "_workers_lock",
        "worker_procs": "_workers_lock",
        "zygote": "_zygote_lock",
        "_reconnecting": "_reconnect_guard",
        "_headless_since": "_reconnect_guard",
        "headless_total_s": "_reconnect_guard",
    }
    _RT_UNGUARDED = {
        "head": "write-once in start() before any push handler is "
                "registered on it; afterwards only the single reconnect "
                "thread rebinds it (a racing reader uses the dying client "
                "once more and its call fails like the connection loss it "
                "is recovering from)",
        "node_id": "write-once after register(); the health-check lambda "
                   "guards the pre-registration None window",
        "_server_port": "write-once in start() before the head connection "
                        "exists; the reconnect thread (which re-reads it "
                        "for the re-register body) can only run after a "
                        "connection loss, which needs that connection",
    }

    def __init__(self):
        cfg = get_config()
        self.head_addr = os.environ["RT_HEAD_ADDR"]
        self.session = os.environ.get(
            "RT_NODE_SESSION", f"node-{os.urandom(6).hex()}"
        )
        self.resources = json.loads(os.environ.get("RT_NODE_RESOURCES", "{}"))
        self.labels = json.loads(os.environ.get("RT_NODE_LABELS", "{}"))
        if "GPU" not in self.resources:
            # Autodetect this host's cards (accelerators.num_gpus).
            from ray_tpu_torch import accelerators

            self.resources.update(accelerators.node_resources())
        self.num_workers = int(os.environ.get("RT_NODE_NUM_WORKERS", "4"))
        self.host = os.environ.get("RT_NODE_HOST", "127.0.0.1")
        self.store = ObjectStore(
            self.session, cfg.object_store_memory, cfg.spill_dir
        )
        self.server = RpcServer(host=self.host, name="node-server")
        self.server.register("pull_object", make_pull_handler(self.store))
        self.server.register("read_log", make_log_read_handler())
        self.server.register("ping", lambda conn, body: {"ok": True})
        self.server_thread = ServerThread(self.server)
        self.bulk_server = BulkServer(self.store, self.session, self.host)
        self.bulk_server.start()
        self.worker_procs: List[subprocess.Popen] = []
        self.worker_pids: set = set()  # zygote-forked (orphaned to init)
        self.zygote = None
        # worker_pids/worker_procs are touched from the spawner thread,
        # the rpc-loop push handlers (_on_kill_worker), and the main loop;
        # the zygote is swapped by start() and the spawner.  Cheap lock for
        # the former (list/set ops only); the zygote lock may be held for
        # a whole spawn handshake, so never take it on the rpc loop.
        self._workers_lock = make_lock("node.workers")
        self._zygote_lock = make_lock("node.zygote")
        from concurrent.futures import ThreadPoolExecutor

        self._spawn_exec = ThreadPoolExecutor(1, thread_name_prefix="spawner")
        self.node_id: Optional[NodeID] = None
        self.head: Optional[RpcClient] = None
        self._shutdown = threading.Event()
        # Announced preemption (SIGTERM): grace window before this daemon
        # actually exits.  During the window the node is DRAINING head-side
        # (no new leases) but running workers keep going so gangs can
        # checkpoint (reference: spot/maintenance preemption semantics —
        # SIGTERM, then SIGKILL after the grace period).
        self.drain_grace_s = float(os.environ.get("RT_DRAIN_GRACE_S", "5"))
        self._drain_requested = False
        self._drain_deadline: Optional[float] = None
        self._drain_min_wait = 1.0
        # Headless degraded mode: when the head connection drops, ONE
        # reconnect thread redials with backoff (workers keep executing,
        # the store keeps serving pulls) until re-registered or the suicide
        # deadline passes.  headless_total_s is cumulative across outages
        # (reported in node_stats and the resync register).
        self._reconnect_guard = make_lock("node.reconnect_guard")
        self._reconnecting = False
        self._headless_since: Optional[float] = None
        self.headless_total_s = 0.0
        self._server_port = 0

    def _install_push_handlers(self, client: RpcClient):
        client.on_push("spawn_worker", self._on_spawn_worker)
        client.on_push("kill_worker", self._on_kill_worker)
        client.on_push("free_objects", self._on_free_objects)
        client.on_push("adopt_object", self._on_adopt_object)
        client.on_push("shutdown", lambda b: self._shutdown.set())
        client.on_push(
            "health_check",
            lambda b: self.head.call_async(
                "node_health_ack", {"node_id": self.node_id.binary()}
            ) if self.node_id else None,
        )

    def _register_body(self) -> dict:
        from . import schema as wire_schema

        body = {
            "kind": "node",
            "protocol": wire_schema.PROTOCOL_VERSION,
            "resources": self.resources,
            "labels": self.labels,
            "num_workers": self.num_workers,
            "store_session": self.session,
            "object_addr": f"{self.host}:{self._server_port}",
            "bulk_addr": f"{self.host}:{self.bulk_server.port}",
            "pid": os.getpid(),
            "log_path": own_log_path(),
        }
        if self.node_id is not None:
            body["node_id"] = self.node_id.binary()
        elif os.environ.get("RT_NODE_ID"):  # pre-assigned (cluster_utils)
            body["node_id"] = bytes.fromhex(os.environ["RT_NODE_ID"])
        return body

    def start(self):
        self._server_port = self.server_thread.start()
        self.head = RpcClient(
            *self._split(self.head_addr), name="node-daemon-rpc"
        )
        self._install_push_handlers(self.head)
        self.head.on_connection_lost = self._on_head_lost
        reply = self.head.call("register", self._register_body())
        self.node_id = NodeID(reply["node_id"])
        # Boot the zygote eagerly so the first spawn request doesn't pay
        # the forkserver's one-time import cost.  Under the lock: a
        # spawn_worker push can arrive the moment register() returns, and
        # the spawner thread swaps self.zygote too — an unsynchronized
        # last-write-wins here would leak a live forkserver process.
        with self._zygote_lock:
            if self.zygote is None:
                try:
                    from .zygote import Zygote

                    self.zygote = Zygote(self._worker_env())
                except Exception:
                    self.zygote = None

    @staticmethod
    def _split(addr: str):
        host, port = addr.rsplit(":", 1)
        return host, int(port)

    # -- push handlers (run on the head-client rpc loop thread) ---------------

    def _worker_env(self):
        from ray_tpu_torch import accelerators

        env = dict(os.environ)
        accelerators.set_worker_env(env)
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = (
            pkg_parent + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else pkg_parent
        )
        env.update(
            RT_HEAD_ADDR=self.head_addr,
            RT_NODE_ID=self.node_id.hex(),
            RT_SESSION=self.session,
            # Peer-plane wiring: workers bind their peer RPC server on this
            # node's host.  (The node's object-plane endpoints travel via
            # the register body and head-side descriptors, not env.)
            RT_PEER_HOST=self.host,
        )
        return env

    def _on_spawn_worker(self, body):
        # Off-thread: this runs as a push handler on the head-client rpc
        # loop; the zygote handshake must not stall pushes.
        self._spawn_exec.submit(self._spawn_worker_blocking)

    def _spawn_worker_blocking(self):
        from .zygote import spawn_with_fallback

        env = self._worker_env()
        log_dir = os.path.join(LOG_ROOT, self.session)
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{time.time_ns()}.log")
        with self._zygote_lock:
            self.zygote, pid, proc = spawn_with_fallback(
                self.zygote, env, log_path
            )
        with self._workers_lock:
            if pid is not None:
                self.worker_pids.add(pid)
            else:
                self.worker_procs.append(proc)

    def _on_kill_worker(self, body):
        """SIGKILL a wedged local worker on the head's behalf — a stopped
        process can't run its connection-lost handler, so the daemon (which
        spawned it) must deliver the signal (reference: raylet DestroyWorker
        kills local worker processes)."""
        pid = body.get("pid")
        with self._workers_lock:
            ours = bool(pid) and (
                pid in self.worker_pids
                or any(p.pid == pid for p in self.worker_procs))
        if ours:
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def _on_free_objects(self, body):
        no_pool = set(body.get("no_pool", ()))
        for raw in body.get("object_ids", []):
            try:
                self.store.free(ObjectID(raw), pool=raw not in no_pool)
            except Exception:
                pass

    def _on_adopt_object(self, body):
        """Take accounting ownership of a segment a local worker created
        (the head routes this to the object's node)."""
        try:
            self.store.adopt(ObjectID(body["object_id"]))
        except (FileNotFoundError, MemoryError):
            pass

    # ------------------------------------------- headless mode / head restart

    def _on_head_lost(self):
        """Lost head connection (runs on the dying rpc loop thread): enter
        headless degraded mode instead of dying.  While headless, running
        workers keep executing (their own reconnect loops handle the head),
        the object store keeps serving pulls, and granted leases keep
        draining — only head-mediated ops (spawns, frees, stats) pause."""
        if self._shutdown.is_set() or self._drain_requested \
                or self._drain_deadline is not None:
            return  # already exiting: the run loop owns teardown
        with self._reconnect_guard:
            if self._reconnecting:
                return
            self._reconnecting = True
            self._headless_since = time.monotonic()
        threading.Thread(target=self._reconnect_loop, daemon=True,
                         name="head-reconnect").start()

    def _reconnect_loop(self):
        from . import deadline as _dl

        budget = get_config().head_reconnect_deadline_s
        deadline = _dl.Deadline.after(budget)
        policy = _dl.reconnect_policy()
        attempt = 0
        while not self._shutdown.is_set():
            if deadline.expired:
                _dl.count_deadline_exceeded("reconnect")
                print(
                    f"ray_tpu_torch node daemon (session {self.session}): head "
                    f"did not return within {budget:.0f}s "
                    "(head_reconnect_deadline_s); shutting the node down",
                    file=sys.stderr, flush=True,
                )
                # The run loop's teardown SIGTERMs workers, closes the
                # zygote, and shuts the store — no orphaned processes.
                self._shutdown.set()
                return
            try:
                self._reconnect_once()
                with self._reconnect_guard:
                    self._reconnecting = False
                    if self._headless_since is not None:
                        self.headless_total_s += (
                            time.monotonic() - self._headless_since
                        )
                    self._headless_since = None
                return
            except Exception:
                pass
            attempt += 1
            _dl.count_retry("reconnect")
            policy.sleep(attempt, deadline)

    def _reconnect_once(self):
        """One redial + re-register carrying this node's field state; on
        success, swap the client and replay the store manifest so the
        restarted head rebuilds its object directory (rides the existing
        segment-adoption path in put_object_batch)."""
        client = RpcClient(
            *self._split(self.head_addr), name="node-daemon-rpc"
        )
        manifest = self.store.manifest()
        try:
            self._install_push_handlers(client)
            body = self._register_body()
            body["reconnect"] = True
            self._prune_worker_pids()
            with self._workers_lock:
                pids = list(self.worker_pids) + [
                    p.pid for p in self.worker_procs if p.poll() is None
                ]
            with self._reconnect_guard:
                headless_s = self.headless_total_s + (
                    (time.monotonic() - self._headless_since)
                    if self._headless_since is not None else 0.0
                )
            body["resync"] = {
                "worker_pids": pids,
                "headless_s": headless_s,
                "num_objects": len(manifest),
            }
            reply = client.call("register", body)
            self.node_id = NodeID(reply["node_id"])
            client.on_connection_lost = self._on_head_lost
        except BaseException:
            try:
                client.close()
            except Exception:
                pass
            raise
        old, self.head = self.head, client
        try:
            old.on_connection_lost = None
            old.close()
        except Exception:
            pass
        # Field-state resync, object half: every object this store can
        # still serve re-enters the head's directory (adopt path tolerates
        # already-known ids, so a plain blip just re-asserts records).
        node_raw = self.node_id.binary()
        for i in range(0, len(manifest), 2000):
            entries = [
                {"object_id": oid.binary(), "size": size,
                 "node_id": node_raw, "resync": True}
                for oid, size in manifest[i:i + 2000]
            ]
            client.call("put_object_batch", {"objects": entries})

    # ------------------------------------------------------------- draining

    def request_drain(self):
        """SIGTERM handler body: flag only.  The RPC announcing the drain
        runs from the main loop — a signal handler interrupting a call that
        holds the rpc client's non-reentrant lock must not re-enter it."""
        self._drain_requested = True

    def _begin_drain(self):
        """Report DRAINING to the head, keep serving for the grace window,
        then exit through the normal shutdown path (the head's disconnect
        handling does node-death cleanup)."""
        if self._drain_deadline is not None:
            return  # second SIGTERM: already draining
        self._drain_deadline = time.monotonic() + self.drain_grace_s
        # Zero workers at drain time: nothing can need the grace window —
        # just a short linger so the announce RPC flushes (the early-exit
        # check in run() uses this floor).
        self._prune_worker_pids()
        with self._workers_lock:
            had_workers = bool(self.worker_pids) or any(
                p.poll() is None for p in self.worker_procs
            )
        self._drain_min_wait = 1.0 if had_workers else 0.3
        try:
            self.head.call_async("node_drain", {
                "node_id": self.node_id.binary(),
                "grace_s": self.drain_grace_s,
            })
        except Exception:
            pass  # head gone: nothing to announce, just run out the grace

    # ------------------------------------------------------------------ loop

    def _prune_worker_pids(self):
        """Drop zygote-forked worker pids whose process is gone (orphans
        reaped by init): a stale pid could be recycled by an unrelated
        process and must never be signalled at shutdown."""
        with self._workers_lock:
            pids = list(self.worker_pids)
        for pid in pids:
            try:
                os.kill(pid, 0)
            except (ProcessLookupError, PermissionError):
                # Gone (or recycled by an unrelated uid): not ours anymore.
                with self._workers_lock:
                    self.worker_pids.discard(pid)

    def _report_stats(self):
        """Push this node's resource view to the head: store pressure, host
        load, live worker count (the resource-syncer role — reference:
        src/ray/common/ray_syncer/ray_syncer.h:88 gossips per-node resource
        views to the GCS over a bidi stream; here it rides the existing
        daemon connection)."""
        try:
            load1 = os.getloadavg()[0]
        except OSError:
            load1 = 0.0
        from .config import host_memory_used_frac

        with self._reconnect_guard:
            headless_s = self.headless_total_s + (
                (time.monotonic() - self._headless_since)
                if self._headless_since is not None else 0.0
            )
        stats = {
            "node_id": self.node_id.binary(),
            "store": self.store.stats(),
            "load1": load1,
            "mem_used_frac": host_memory_used_frac(),
            "num_worker_procs": (
                len(self.worker_pids) + len(self.worker_procs)  # rt-unguarded: len() snapshot for best-effort stats
            ),
            # Cumulative seconds this daemon has spent without a head
            # connection (surfaced as the per-node
            # ray_tpu_headless_seconds gauge head-side).
            "headless_s": headless_s,
        }
        try:
            self.head.call_async("node_stats", stats)
        except Exception:
            pass  # reporting is best-effort; liveness has its own path

    def run(self):
        ticks = 0
        while not self._shutdown.wait(timeout=0.2):
            if self._drain_requested and self._drain_deadline is None:
                self._begin_drain()
            if self._drain_deadline is not None:
                if time.monotonic() >= self._drain_deadline:
                    break  # grace window over: the preemption lands now
                # Early exit: once the last worker process is gone there is
                # nothing left to grace (the head shuts down IDLE workers
                # at drain, so an idle node clears out in ~a second while a
                # gang-hosting node runs its full window).
                self._prune_worker_pids()
                with self._workers_lock:
                    live_procs = [p for p in self.worker_procs
                                  if p.poll() is None]
                    no_workers = not self.worker_pids and not live_procs
                if (no_workers
                        and time.monotonic() >=
                        self._drain_deadline - self.drain_grace_s
                        + self._drain_min_wait):
                    break
            self.store.tick()  # cooled freed segments -> warm pool
            # Reap exited worker processes so they don't zombie.
            with self._workers_lock:
                procs = list(self.worker_procs)
            for p in procs:
                p.poll()
            ticks += 1
            if ticks % 10 == 0:
                self._report_stats()
                self._prune_worker_pids()
        with self._workers_lock:
            procs = list(self.worker_procs)
            pids = list(self.worker_pids)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for pid in pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        with self._zygote_lock:
            if self.zygote is not None:
                self.zygote.close()
        # Sweep this node's session-scoped fn-table blob cache (workers
        # populate <temp dir>/ray_tpu_torch_fncache/<session>; the head's sweep only
        # covers its own host's filesystem).
        try:
            import shutil

            shutil.rmtree(
                os.path.join(tmp_root("fncache"), self.session),
                ignore_errors=True,
            )
        except Exception:
            pass
        self.store.shutdown()
        os._exit(0)


def main():
    import faulthandler

    faulthandler.register(signal.SIGUSR1)
    daemon = NodeDaemon()
    # Preemption notice: SIGTERM starts a graceful drain instead of killing
    # the daemon outright (SIGKILL remains the crash-simulation path).
    signal.signal(signal.SIGTERM, lambda *_: daemon.request_drain())
    daemon.start()
    daemon.run()


if __name__ == "__main__":
    sys.exit(main())
