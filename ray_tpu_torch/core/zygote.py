"""Worker forkserver ("zygote"): pre-imports the worker runtime once, then
forks worker processes in milliseconds.

Role-equivalent to the reference's worker-pool prestart strategy
(reference: src/ray/raylet/worker_pool.h:153 — prestarted/pooled workers
absorb process-start latency; maximum_startup_concurrency bounds parallel
boots).  A host daemon spawns many short-lived Python workers (actors, data
tasks); a fresh interpreter + import cost per worker caps actor creation at
a few per second.  The zygote pays the import cost once and `fork()`s.

Protocol (line-JSON over stdin/stdout):
    -> {"env": {...}, "log": "/path"}       spawn request
    <- {"pid": 12345}                       worker pid (or {"error": ...})

Double-fork orphans the worker to init: the requester only keeps the pid
(kill via os.kill) and never needs to reap.  The zygote stays single-threaded
so fork() is safe.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from typing import Dict, Optional, Sequence

from ..devtools.locks import make_lock


def _set_comm(name: str):
    """Set the kernel thread name (prctl PR_SET_NAME) so zygote-forked
    workers are identifiable (`ps -o comm`, /proc/<pid>/comm) even though
    their argv still reads as the zygote's."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(15, name.encode()[:15], 0, 0, 0)  # PR_SET_NAME = 15
    except Exception:
        pass


def main():
    from . import worker_main  # noqa: F401 — preload the worker runtime
    import cloudpickle  # noqa: F401
    import msgpack  # noqa: F401
    import numpy  # noqa: F401

    # Keep the protocol stream clean: stray prints go to stderr.
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    for line in sys.stdin:
        try:
            req = json.loads(line)
        except ValueError:
            continue
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:
            # Intermediate child: fork the worker, report its pid, exit —
            # the worker is orphaned to init so nobody has to reap it.
            os.close(r)
            gpid = os.fork()
            if gpid == 0:
                os.close(w)
                try:
                    os.close(out.fileno())  # don't hold the protocol pipe open
                except OSError:
                    pass
                os.setsid()
                for k in req.get("unset", ()):
                    os.environ.pop(k, None)
                os.environ.update(req.get("env", {}))
                log = req.get("log")
                if log:
                    fd = os.open(log, os.O_CREAT | os.O_WRONLY | os.O_APPEND,
                                 0o644)
                    os.dup2(fd, 1)
                    os.dup2(fd, 2)
                    os.close(fd)
                devnull = os.open(os.devnull, os.O_RDONLY)
                os.dup2(devnull, 0)
                os.close(devnull)
                _set_comm("rtpt-worker")  # identify forked workers in ps
                try:
                    worker_main.main()
                except BaseException:  # noqa: BLE001
                    import traceback

                    traceback.print_exc()
                finally:
                    os._exit(0)
            os.write(w, str(gpid).encode())
            os._exit(0)
        os.close(w)
        os.waitpid(pid, 0)
        data = os.read(r, 64)
        os.close(r)
        try:
            reply = {"pid": int(data)}
        except ValueError:
            reply = {"error": "fork failed"}
        out.write(json.dumps(reply) + "\n")
        out.flush()


class Zygote:
    """Client handle: starts the forkserver subprocess and requests spawns.

    The zygote is started with the caller's worker environment (no card
    visible) and never imports torch, so no OpenMP pool or CUDA context
    exists when it forks; per-worker env (``RT_*``, ``PYTHON*`` and
    ``CUDA_VISIBLE_DEVICES``) goes in each spawn request.
    """

    def __init__(self, env: Dict[str, str]):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.zygote"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,
            text=True,
        )
        self._lock = make_lock("zygote.proc")

    def alive(self) -> bool:
        return self.proc.poll() is None

    def spawn(self, env: Dict[str, str], log: Optional[str] = None,
              unset: Sequence[str] = (), timeout: float = 20.0) -> int:
        import select

        req = json.dumps({"env": env, "log": log, "unset": list(unset)})
        with self._lock:
            self.proc.stdin.write(req + "\n")
            self.proc.stdin.flush()
            # Bounded wait: a wedged zygote must not hang the caller forever
            # (the caller falls back to a direct interpreter boot).
            ready, _, _ = select.select(
                [self.proc.stdout], [], [], timeout
            )
            if not ready:
                raise TimeoutError("zygote spawn timed out")
            line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("zygote process died")
        reply = json.loads(line)
        if "pid" not in reply:
            raise RuntimeError(f"zygote spawn failed: {reply}")
        return reply["pid"]

    def close(self):
        try:
            self.proc.stdin.close()
        except Exception:
            pass
        try:
            self.proc.terminate()
        except Exception:
            pass


def spawn_with_fallback(zygote: Optional[Zygote], env: Dict[str, str],
                        log_path: str):
    """Spawn one worker: fork from the zygote (~ms; reviving it if dead) or
    fall back to a fresh interpreter boot.  Returns (zygote, pid, proc) —
    exactly one of pid/proc is set.  Shared by the head's local spawner and
    the node daemon."""
    import subprocess as sp

    # The worker registers this path with the head's cluster log index so
    # `get_log`/`ray_tpu_torch logs` can retrieve its output from any machine —
    # including after the process dies (crash post-mortems).
    env = dict(env, RT_LOG_PATH=log_path)
    try:
        if zygote is None or not zygote.alive():
            zygote = Zygote(env)
        pid = zygote.spawn(
            {k: v for k, v in env.items()
             if k.startswith(("RT_", "PYTHON"))
             or k == "CUDA_VISIBLE_DEVICES"},
            log=log_path,
        )
        return zygote, pid, None
    except Exception:
        pass  # fall back to a direct interpreter boot
    logf = open(log_path, "wb")
    proc = sp.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.worker_main"],
        env=env,
        stdout=logf,
        stderr=sp.STDOUT,
    )
    logf.close()
    return zygote, None, proc


if __name__ == "__main__":
    main()
