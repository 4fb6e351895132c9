"""Single-producer single-consumer shared-memory channel.

Role-equivalent to the reference's compiled-DAG mutable-object channels
(reference: python/ray/experimental/channel/shared_memory_channel.py:147
Channel, backed by the C++ mutable-object manager): a fixed shm buffer
written in place each execution — no per-call control-plane round trip, no
allocation.  Layout: [u64 write_seq][u64 read_seq][u64 payload_len][payload].
The writer waits until the reader consumed the previous value; the reader
waits for a new write_seq.  Spin-then-sleep keeps latency in the tens of
microseconds without burning a core when idle.  The port's own copy of
``ray_tpu/dag/channel.py``, over the port's ``_native.store_seq`` and
``wait_seq``.
"""

from __future__ import annotations

import mmap
import os
import struct

_HDR = struct.Struct("<QQQ")  # write_seq, read_seq, payload_len
CLOSE_SENTINEL = (1 << 64) - 1


class ShmChannel:
    def __init__(self, path: str, capacity: int = 8 * 1024 * 1024,
                 create: bool = False):
        self.path = path
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        self._fd = os.open(path, flags, 0o600)
        if create:
            os.ftruncate(self._fd, _HDR.size + capacity)
        self.capacity = os.fstat(self._fd).st_size - _HDR.size
        self._mm = mmap.mmap(self._fd, _HDR.size + self.capacity)
        self._view = memoryview(self._mm)

    # -- header ---------------------------------------------------------------

    def _read_hdr(self):
        return _HDR.unpack_from(self._view, 0)

    def _set_write(self, seq: int, length: int):
        from ray_tpu_torch import _native

        struct.pack_into("<Q", self._view, 16, length)
        # write_seq LAST, via an atomic release store: it publishes the
        # payload to the peer's acquire loads in wait_seq (a plain store
        # happens to be atomic on x86_64/aarch64 but may tear elsewhere).
        _native.store_seq(self._mm, 0, seq)

    def _set_read(self, seq: int):
        from ray_tpu_torch import _native

        _native.store_seq(self._mm, 8, seq)

    def _wait(self, want_unread: bool, timeout: float):
        """Block until the channel has (reader) / lacks (writer) an unread
        value.  The wait loop itself is native (ray_tpu_torch/_native wait_seq:
        ~1ns/iteration spin with the GIL released vs ~1us/iteration for a
        Python predicate loop) — this is what keeps DAG hop latency in the
        tens of microseconds."""
        from ray_tpu_torch import _native

        if not _native.wait_seq(self._mm, timeout, int(want_unread)):
            raise TimeoutError("channel wait timed out")

    # -- API ------------------------------------------------------------------

    def write_bytes(self, payload, timeout: float = 60.0):
        n = len(payload)
        if n > self.capacity:
            raise ValueError(
                f"payload of {n} bytes exceeds channel capacity "
                f"{self.capacity} (pass a larger capacity at compile)"
            )
        self._wait(False, timeout)
        w, _, _ = self._read_hdr()
        self._view[_HDR.size:_HDR.size + n] = (
            payload if isinstance(payload, (bytes, bytearray, memoryview))
            else bytes(payload)
        )
        self._set_write(w + 1, n)

    def read_bytes(self, timeout: float = 60.0) -> memoryview:
        """Returns a view of the payload; call done_reading() after
        deserializing to release the slot back to the writer."""
        self._wait(True, timeout)
        _, _, n = self._read_hdr()
        if n == CLOSE_SENTINEL:
            raise EOFError("channel closed")
        return self._view[_HDR.size:_HDR.size + n]

    def done_reading(self):
        w, r, _ = self._read_hdr()
        self._set_read(r + 1)

    def close_writer(self, timeout: float = 10.0):
        try:
            self._wait(False, timeout)
        except TimeoutError:
            pass
        w, _, _ = self._read_hdr()
        self._set_write(w + 1, CLOSE_SENTINEL)

    def close(self, unlink: bool = False):
        try:
            self._view.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass
        os.close(self._fd)
        if unlink:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
