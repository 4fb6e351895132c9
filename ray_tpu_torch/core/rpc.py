"""Message-framed RPC over asyncio TCP sockets.

Role-equivalent to the reference's gRPC layer (reference: src/ray/rpc/
grpc_server.h, client_call.h): request/response with per-call deadlines plus
server->client pushes (used for task dispatch and pubsub).  msgpack on the
wire; protobuf codegen isn't available in this image and the control-plane
messages are small, so a schema-light encoding is the right trade.

Frame format: [u32 length][msgpack payload]
Payload: [type, seq, method, body]  with type REQ=0 | RESP=1 | ERR=2 | PUSH=3.
"""

from __future__ import annotations

import asyncio
import struct
import sys
import threading
import time
import traceback
from concurrent.futures import TimeoutError as _cf_TimeoutError
from typing import Any, Awaitable, Callable, Dict, Optional

import msgpack

from ..devtools.locks import guarded, make_lock

REQ, RESP, ERR, PUSH = 0, 1, 2, 3
_HDR = struct.Struct("<I")

_max_msg_bytes: Optional[int] = None

# -- network fault injection (util/netfault.py) ------------------------------
# The armed FaultSchedule, or None.  Hot paths (per-frame send/receive)
# check this one global against None and touch nothing else — the injector
# hook is free when disabled.  Armed lazily from RT_NETFAULT at the first
# endpoint construction, or programmatically via set_fault_schedule.
_netfault = None
_netfault_env_checked = False

# Outbox queue-delay accounting (doctor --object-plane): how long requests
# sit in the coalescing outbox before the loop drains them — a congested
# shared loop (the peer dataplane multiplexes many connections over one)
# shows up here before it shows up anywhere else.  One observation per
# drained burst (the oldest entry's wait), armed lazily so client-less
# processes never build the instrument.
_outbox_hist = None


def _note_outbox_delay(seconds: float) -> None:
    global _outbox_hist
    if _outbox_hist is None:
        try:
            from ..util.metrics import get_histogram

            _outbox_hist = get_histogram(
                "ray_tpu_rpc_outbox_delay_seconds",
                "Request wait in the RPC outbox between enqueue and drain",
                boundaries=(0.0001, 0.001, 0.005, 0.025, 0.1, 0.5, 1.0))
        except Exception:
            return
    _outbox_hist.observe(seconds)


def _maybe_arm_netfault():
    global _netfault, _netfault_env_checked
    if _netfault_env_checked:
        return
    _netfault_env_checked = True
    import os

    spec = os.environ.get("RT_NETFAULT")
    if not spec:
        return
    try:
        from ..util.netfault import FaultSchedule

        _netfault = FaultSchedule(
            spec, int(os.environ.get("RT_NETFAULT_SEED", "0") or 0))
        print(f"netfault: armed seed={_netfault.seed} spec={spec!r}",
              file=sys.stderr, flush=True)
    except Exception as e:  # a bad spec must be loud, not a silent no-op
        print(f"netfault: failed to arm {spec!r}: {e}",
              file=sys.stderr, flush=True)


def set_fault_schedule(sched):
    """Install (or clear, with None) the process's fault schedule."""
    global _netfault, _netfault_env_checked
    _netfault = sched
    _netfault_env_checked = True


def _msg_limit() -> int:
    global _max_msg_bytes
    if _max_msg_bytes is None:
        from .config import get_config

        _max_msg_bytes = get_config().rpc_max_message_bytes
    return _max_msg_bytes


def _encode(msg) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    if len(body) > _msg_limit():
        raise RpcError(
            f"rpc message of {len(body)} bytes exceeds rpc_max_message_bytes "
            f"({_msg_limit()}); route bulk data through the object store"
        )
    return _HDR.pack(len(body)) + body


async def _read_msg(reader: asyncio.StreamReader):
    hdr = await reader.readexactly(_HDR.size)
    (n,) = _HDR.unpack(hdr)
    if n > _msg_limit():
        raise RpcError(f"incoming rpc frame of {n} bytes exceeds limit")
    body = await reader.readexactly(n)
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class Connection:
    """One peer connection, server side."""

    _next_id = 0

    def __init__(self, reader, writer, server: "RpcServer"):
        self.reader = reader
        self.writer = writer
        self.server = server
        Connection._next_id += 1
        self.conn_id = Connection._next_id
        self.meta: Dict[str, Any] = {}
        self.alive = True
        self._write_lock = asyncio.Lock()
        # Response/push coalescing: frames buffer here and ONE call_soon
        # flush per loop tick writes them all — a burst of completions
        # costs one send() syscall, not one per frame (send() is ~1ms on
        # virtualised kernels and bounds per-connection message rate).
        self._outbuf = bytearray()
        self._flush_scheduled = False

    async def push(self, method: str, body: Any):
        await self._send([PUSH, 0, method, body])

    async def _send(self, msg):
        self._outbuf += _encode(msg)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush)

    def _flush(self):
        self._flush_scheduled = False
        data, self._outbuf = bytes(self._outbuf), bytearray()
        if not data or not self.alive:
            return
        try:
            self.writer.write(data)
            # Coalesced writes skip drain() (its await would serialize the
            # burst) — so bound the transport buffer explicitly: a peer
            # that stopped reading must not grow server memory without
            # limit.  Closing trips the normal disconnect cleanup; the
            # health prober would have reaped such a peer anyway.
            if self.writer.transport.get_write_buffer_size() \
                    > RpcServer.STREAM_LIMIT:
                self.writer.close()
        except Exception:
            pass  # reader side notices the dead transport


class RpcServer:
    """Asyncio RPC server.  Handlers are ``async def handler(conn, body)`` or
    plain callables; return value becomes the response body."""

    _RT_UNGUARDED = {
        "handlers": "registered at server construction, before start() "
                    "opens the listening socket — no request can race the "
                    "registration",
    }

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 name: str = "server"):
        _maybe_arm_netfault()
        self.host = host
        self.port = port
        self.name = name  # netfault link id (e.g. "peer-server")
        self.handlers: Dict[str, Callable[[Connection, Any], Awaitable[Any]]] = {}
        self.connections: Dict[int, Connection] = {}
        self.on_disconnect: Optional[Callable[[Connection], Awaitable[None]]] = None
        self._server: Optional[asyncio.AbstractServer] = None

    def handler(self, name: str):
        def deco(fn):
            self.handlers[name] = fn
            return fn

        return deco

    def register(self, name: str, fn):
        self.handlers[name] = fn

    # StreamReader buffer limit: the default 64 KiB forces a transport
    # pause/resume cycle every ~128 KiB, capping large-frame throughput at
    # ~0.2 GiB/s; object-plane chunks are 8 MiB.
    STREAM_LIMIT = 64 * 1024 * 1024

    async def start(self):
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port, limit=self.STREAM_LIMIT
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self):
        # Close live connections first: in py3.12+ wait_closed() waits for all
        # connection handlers, which would deadlock while clients are attached.
        for conn in list(self.connections.values()):
            conn.writer.close()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2)
            except asyncio.TimeoutError:
                pass

    async def _on_client(self, reader, writer):
        conn = Connection(reader, writer, self)
        self.connections[conn.conn_id] = conn
        try:
            if _netfault is not None:
                # Gray failure: the accept succeeded (the peer sees a live
                # TCP endpoint) but nothing is read — and therefore nothing
                # is ever answered — until the stall window closes.
                stall_s = _netfault.on_accept(self.name)
                if stall_s > 0:
                    await asyncio.sleep(stall_s)
            while True:
                mtype, seq, method, body = await _read_msg(reader)
                if mtype == REQ:
                    asyncio.get_running_loop().create_task(
                        self._dispatch(conn, seq, method, body)
                    )
                # Servers ignore stray RESP/PUSH frames.
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            conn.alive = False
            self.connections.pop(conn.conn_id, None)
            writer.close()
            if self.on_disconnect is not None:
                await self.on_disconnect(conn)

    async def _dispatch(self, conn, seq, method, body):
        try:
            fn = self.handlers.get(method)
            if fn is None:
                raise RpcError(f"no handler for method {method!r}")
            result = fn(conn, body)
            if asyncio.iscoroutine(result):
                result = await result
            await conn._send([RESP, seq, method, result])
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            tb = traceback.format_exc()
            import os as _os
            if _os.environ.get("RT_DEBUG_RPC_ERR"):
                import sys as _sys
                print(f"RPC ERR in {method}: {e}\n{tb}", file=_sys.stderr,
                      flush=True)
            try:
                await conn._send([ERR, seq, method, f"{e}\n{tb}"])
            except Exception:
                pass


@guarded
class RpcClient:
    """Thread-safe synchronous client over a background asyncio loop.

    Push handlers run on the loop; long handlers must hand off to a thread.
    """

    # rtlint RT007 verifies the outbox guards statically; RT_DEBUG_LOCKS=2
    # asserts them at runtime (devtools.locks).
    _RT_GUARDED_BY = {
        "_seq": "_seq_lock",
        "_outbox": "_seq_lock",
        "_outbox_scheduled": "_seq_lock",
    }
    _RT_UNGUARDED = {
        "closed": "monotonic bool flip: every writer stores True; readers "
                  "that lose the race fail into ConnectionLost anyway",
        "_push_handlers": "handlers are registered at client setup before "
                          "their method's pushes can arrive; dict get/set "
                          "are GIL-atomic",
        "on_connection_lost": "voluntary close() stores None so the "
                              "lost-connection callback is suppressed; a "
                              "racing read in the reader's teardown just "
                              "runs the old callback once, which close() "
                              "tolerates",
        "_pending": "seq-keyed entries: the loop thread sets and pops them; "
                    "call()'s timeout abandon pops only its OWN seq from "
                    "the caller thread (GIL-atomic dict.pop — one pop wins "
                    "and the loser's fut.done() check makes a double "
                    "resolve impossible); the dict itself is never rebound",
    }

    def __init__(self, host: str, port: int, name: str = "rpc-client",
                 connect_timeout_s: Optional[float] = None,
                 loop: Optional[asyncio.AbstractEventLoop] = None):
        _maybe_arm_netfault()
        self.host = host
        self.port = port
        self.name = name  # netfault rules link-match on this
        # ``loop``: run on a caller-owned shared loop instead of spawning a
        # thread per connection — the peer dataplane multiplexes many
        # worker connections over ONE loop thread (a reader thread per
        # connection thrashes small hosts).  close() leaves a shared loop
        # running.
        self._owns_loop = loop is None
        if loop is not None:
            self._loop = loop
            self._thread = None
        else:
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._loop.run_forever, name=name, daemon=True
            )
            self._thread.start()
        self._seq = 0
        self._seq_lock = make_lock("rpc.seq")
        self._pending: Dict[int, Any] = {}
        # Outbox coalescing: requests append here and at most ONE loop
        # wakeup is scheduled at a time.  call_soon_threadsafe costs a
        # self-pipe write syscall (~1ms on virtualised kernels); a burst of N
        # submissions must pay it once, not N times.
        self._outbox: list = []
        self._outbox_scheduled = False
        self._push_handlers: Dict[str, Callable[[Any], None]] = {}
        self._writer = None
        self._write_lock = None
        self._reader_task = None
        self.closed = False
        self.on_connection_lost: Optional[Callable[[], None]] = None
        from .config import get_config

        fut = asyncio.run_coroutine_threadsafe(self._connect(), self._loop)
        try:
            # Peer-plane dials pass a short timeout: a dead worker's stale
            # address must fail fast into the head fallback, not stall the
            # caller for the full control-plane connect window.
            fut.result(timeout=connect_timeout_s
                       if connect_timeout_s is not None
                       else get_config().rpc_connect_timeout_s)
        except BaseException:
            # A failed dial must not leak the loop thread started above:
            # callers that probe-and-retry (Cluster.attach fail-fast,
            # reconnect loops) would accumulate one live thread + event
            # loop per attempt.  close() is null-safe pre-connect.
            fut.cancel()
            self.close()
            raise

    async def _connect(self):
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=RpcServer.STREAM_LIMIT
        )
        self._write_lock = asyncio.Lock()
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop()
        )

    def _handle_msg(self, mtype, seq, method, body):
        if mtype in (RESP, ERR):
            fut = self._pending.pop(seq, None)
            if fut is not None and not fut.done():
                if mtype == RESP:
                    fut.set_result(body)
                else:
                    fut.set_exception(RpcError(body))
        elif mtype == PUSH:
            fn = self._push_handlers.get(method)
            if fn is not None:
                try:
                    fn(body)
                except Exception:
                    traceback.print_exc()

    async def _read_loop(self):
        try:
            while True:
                mtype, seq, method, body = await _read_msg(self._reader)
                nf = _netfault
                if nf is not None:
                    act = nf.on_recv(self.name, method)
                    if act is not None:
                        if act["kind"] == "drop":
                            continue  # reply lost on the wire
                        if act["kind"] == "dup":
                            # Deliver twice: the second delivery exercises
                            # the abandoned-seq / double-resolve surface.
                            self._handle_msg(mtype, seq, method, body)
                self._handle_msg(mtype, seq, method, body)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError,
                asyncio.CancelledError):
            pass  # CancelledError: voluntary close() tearing the task down
        except BaseException as e:  # noqa: BLE001 — diagnose, treat as loss
            # An unexpected reader death (decode error, oversized frame) is
            # indistinguishable from connection loss to callers — but it is
            # a bug worth seeing: reconnect loops would redial forever.
            print(f"rpc {self.host}:{self.port} read loop died: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
            traceback.print_exc()
        finally:
            self.closed = True
            self._fail_outbox()
            # list(): call()'s timeout abandon pops entries from a foreign
            # thread; iterate a snapshot, pop-racers are already resolved.
            for fut in list(self._pending.values()):
                if not fut.done():
                    fut.set_exception(ConnectionLost("connection lost"))
            self._pending.clear()
            if self.on_connection_lost is not None:
                try:
                    self.on_connection_lost()
                except Exception:
                    traceback.print_exc()

    def on_push(self, method: str, handler: Callable[[Any], None]):
        self._push_handlers[method] = handler

    def _fail_outbox(self):
        with self._seq_lock:
            stranded, self._outbox = self._outbox, []
            self._outbox_scheduled = False
        for _, _, _, fut, _ in stranded:
            if not fut.done():
                fut.set_exception(ConnectionLost("connection lost"))

    def _drain_outbox(self):
        """Loop thread: encode and write every queued request.  Loops until
        the outbox is observed empty with the scheduled flag still set, so
        a producer racing the drain never schedules a second wakeup — one
        self-pipe write per burst, however long the burst."""
        for _ in range(64):
            with self._seq_lock:
                batch, self._outbox = self._outbox, []
                if not batch:
                    self._outbox_scheduled = False
                    return
            # Outbox queue delay (doctor --object-plane): the oldest entry
            # in the batch waited longest between enqueue and drain — one
            # histogram observe per burst, not per request, keeps this off
            # the per-call cost.
            _note_outbox_delay(time.monotonic() - batch[0][4])
            data = bytearray()
            written: list = []
            nf = _netfault
            for seq, method, body, fut, _ in batch:
                if fut.done():
                    continue  # e.g. cancelled while queued
                try:
                    frame = _encode([REQ, seq, method, body])
                except Exception as e:  # oversized message etc.
                    fut.set_exception(e)
                    continue
                if nf is not None:
                    act = nf.on_send(self.name, method)
                    if act is not None:
                        if act["kind"] == "drop":
                            # Lost on the wire: the caller still awaits a
                            # reply that never comes, exactly like a real
                            # dropped packet — pending registered, frame
                            # never written.
                            self._pending[seq] = fut
                            continue
                        if act["kind"] == "delay":
                            self._pending[seq] = fut
                            self._loop.call_later(
                                act["delay_s"], self._write_late,
                                bytes(frame))
                            continue
                self._pending[seq] = fut
                written.append(seq)
                data += frame
            if not data:
                continue
            try:
                self._writer.write(bytes(data))
                # Same buffer bound as Connection._flush: a server that
                # stopped reading must not grow this process's memory
                # without limit — close, and the read loop's teardown
                # fails every pending future with ConnectionLost.
                if self._writer.transport.get_write_buffer_size() \
                        > RpcServer.STREAM_LIMIT:
                    self._writer.close()
            except Exception as e:
                for seq in written:
                    fut = self._pending.pop(seq, None)
                    if fut is not None and not fut.done():
                        fut.set_exception(ConnectionLost(str(e)))
        # Producer still ahead of us after many passes: yield one loop
        # iteration (reads must not starve) and keep the flag claimed.
        self._loop.call_soon(self._drain_outbox)

    def _write_late(self, frame: bytes):
        """Loop thread, via call_later: a netfault-delayed frame finally
        hits the wire (unless the connection died meanwhile)."""
        if self.closed or self._writer is None:
            return
        try:
            self._writer.write(frame)
        except Exception:
            pass  # read loop's teardown already failed the pending future

    def call(self, method: str, body: Any = None,
             timeout: Optional[float] = 60.0) -> Any:
        """Blocking request/reply.  ``timeout=None`` waits forever — the
        caller owns its own deadline (e.g. a ``get(timeout=-1)`` that is
        contractually infinite); prefer that over sentinel constants."""
        if self.closed:
            raise ConnectionLost("client is closed")
        fut = self.call_async(method, body)
        try:
            return fut.result(timeout=timeout)
        except _cf_TimeoutError:
            # Abandon the call: drop the pending entry so a late reply to
            # this seq is a silent no-op instead of a leaked future, and
            # cancel() so a queued-but-unsent request never hits the wire.
            self._pending.pop(getattr(fut, "_rt_seq", -1), None)
            fut.cancel()
            from .deadline import count_deadline_exceeded

            count_deadline_exceeded(self.name)
            raise

    def call_async(self, method: str, body: Any = None):
        """Fire a request, return a concurrent.futures.Future.  Requests
        coalesce through the outbox; ordering across call()/call_async()
        is the append order (single connection, FIFO)."""
        import concurrent.futures as _cf

        fut: _cf.Future = _cf.Future()
        if self.closed:
            fut.set_exception(ConnectionLost("client is closed"))
            return fut
        with self._seq_lock:
            self._seq += 1
            fut._rt_seq = self._seq  # call()'s timeout abandon keys on this
            self._outbox.append(
                (self._seq, method, body, fut, time.monotonic()))
            wake = not self._outbox_scheduled
            if wake:
                self._outbox_scheduled = True
        if wake:
            try:
                self._loop.call_soon_threadsafe(self._drain_outbox)
            except RuntimeError:  # loop already closed (shutdown race)
                self._fail_outbox()
        return fut

    def close(self):
        if self.closed:
            return
        self.closed = True
        # Voluntary close: the lost-connection callback is for peer death,
        # not for our own teardown.
        self.on_connection_lost = None

        def _shutdown():
            self._drain_outbox()  # flush straggler fire-and-forget requests

            async def _graceful():
                task = self._reader_task
                if task is not None:
                    task.cancel()
                    try:
                        # Let the cancellation unwind (its finally runs) so
                        # the loop doesn't destroy a pending task at stop.
                        await task
                    except BaseException:  # noqa: BLE001 — CancelledError
                        pass
                if self._writer is not None:
                    self._writer.close()
                if self._owns_loop:
                    self._loop.stop()

            asyncio.ensure_future(_graceful())

        try:
            self._loop.call_soon_threadsafe(_shutdown)
        except RuntimeError:
            return  # shared loop already stopped
        if self._owns_loop and self._thread is not None:
            self._thread.join(timeout=5)


class ServerThread:
    """Runs an RpcServer (plus arbitrary coroutines) on a dedicated thread."""

    def __init__(self, server: RpcServer):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True, name="rpc-server")

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.start())
        self._started.set()
        self.loop.run_forever()

    def start(self) -> int:
        self.thread.start()
        self._started.wait(timeout=30)
        return self.server.port

    def run_coro(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        async def _stop():
            await self.server.stop()
            self.loop.stop()

        try:
            asyncio.run_coroutine_threadsafe(_stop(), self.loop)
            self.thread.join(timeout=5)
        except Exception:
            pass
