"""Native fast-path loader.

Compiles ``fastpath.c`` on first import (cc -O3, a one-time ~1s cost, cached
next to the source keyed on source mtime) and exposes:

    copy(dest, src, nthreads=0) -> int     parallel memcpy, GIL released
    prefault(dest, nthreads=0) -> int      fault in backing pages
    available: bool                        False => pure-Python fallback

The build is best-effort: any toolchain failure degrades to a pure-Python
``copy`` (memoryview slice assignment) so the framework never hard-depends
on a compiler at runtime.  The reference keeps this entire path in C++
(reference: src/ray/object_manager/plasma/; python binds via Cython
python/ray/_raylet.pyx) — here only the memcpy/prefault inner loop is
native and the protocol logic stays in Python.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastpath.c")

available = False
_ext = None
_build_lock = threading.Lock()


def _so_path() -> str:
    tag = f"{sys.implementation.cache_tag}-{os.uname().machine}"
    san = os.environ.get("RT_NATIVE_SANITIZE")
    if san:
        tag += f"-{san}"  # never let a sanitized build shadow the normal one
    return os.path.join(_HERE, f"_fastpath.{tag}.so")


def _fresh(so: str) -> bool:
    try:
        return os.path.getmtime(so) >= os.path.getmtime(_SRC)
    except OSError:
        return False


def _build(so: str) -> bool:
    cc = os.environ.get("CC", "cc")
    inc = sysconfig.get_path("include")
    tmp = f"{so}.build-{os.getpid()}.so"
    cmd = [cc, "-O3", "-shared", "-fPIC", "-pthread", f"-I{inc}", _SRC, "-o", tmp]
    # Sanitized builds for the native data plane (the role of the
    # reference's bazel tsan/asan configs gating its C++ runtime —
    # .bazelrc build:tsan/build:asan): RT_NATIVE_SANITIZE=thread|address
    # rebuilds the extension instrumented; run python with
    # LD_PRELOAD=$(cc -print-file-name=lib<san>.so) so the sanitizer
    # runtime is present at dlopen (otherwise import falls back to pure
    # Python).  E.g.:
    #   rm ray_tpu_torch/_native/_fastpath.*.so
    #   LD_PRELOAD=$(cc -print-file-name=libtsan.so) \
    #     RT_NATIVE_SANITIZE=thread python -m pytest tests/test_core_units.py
    san = os.environ.get("RT_NATIVE_SANITIZE")
    if san in ("thread", "address", "undefined"):
        cmd.insert(1, f"-fsanitize={san}")
        cmd.insert(1, "-g")
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
        if proc.returncode != 0:
            return False
        os.replace(tmp, so)  # atomic: concurrent builds race benignly
        return True
    except Exception:
        return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


# Every symbol the current protocol needs.  A cached .so missing any of
# these is a stale build: mixing (say) a native atomic wait_seq with a
# Python plain-store store_seq silently reintroduces the data race the
# atomic pair exists to prevent, so stale builds are rebuilt, never
# partially patched.
_REQUIRED = ("copy", "prefault", "wait_seq", "store_seq")


def _import_so(so: str):
    try:
        spec = importlib.util.spec_from_file_location(
            "ray_tpu_torch._native._fastpath", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception:
        return None
    if any(not hasattr(mod, sym) for sym in _REQUIRED):
        return None  # stale ABI — caller rebuilds
    return mod


def _load():
    global _ext, available
    so = _so_path()
    with _build_lock:
        if _ext is not None:
            return
        mod = _import_so(so) if _fresh(so) else None
        if mod is None:
            # Missing, out of date, or symbol-incomplete: rebuild from
            # source.  (dlopen caches by path per-process, so the rebuild
            # helps the NEXT process if this one already dlopened a stale
            # image — that process stays on the pure-Python fallback, which
            # is slow but protocol-consistent on both sides of the pair.)
            if not _build(so):
                return
            mod = _import_so(so)
            if mod is None:
                return
        _ext = mod
        available = True


_load()

if available:
    copy = _ext.copy
    prefault = _ext.prefault
    wait_seq = _ext.wait_seq
    store_seq = _ext.store_seq
else:
    def copy(dest, src, nthreads: int = 0) -> int:  # type: ignore[misc]
        m = memoryview(src)
        if m.format != "B":
            m = m.cast("B")
        d = memoryview(dest)
        if d.format != "B":
            d = d.cast("B")
        d[: m.nbytes] = m
        return m.nbytes

    def prefault(dest, nthreads: int = 0) -> int:  # type: ignore[misc]
        return 0

    def store_seq(buf, offset: int, value: int) -> None:  # type: ignore[misc]
        import struct

        struct.pack_into("<Q", buf, offset, value)

    def wait_seq(buf, timeout_s: float, want_unread: int) -> bool:  # type: ignore[misc]
        import struct
        import time

        deadline = time.monotonic() + timeout_s
        mv = memoryview(buf)
        while True:
            w, r = struct.unpack_from("<QQ", mv, 0)
            if (w > r) == bool(want_unread):
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.0002)
