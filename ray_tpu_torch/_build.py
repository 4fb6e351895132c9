"""Build the port's CUDA kernels and load them with ctypes.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use, for ``sm_90a``.  Libraries land in
``ray_tpu_torch/_build/`` under a name that carries a hash of the source,
of every header (``*.cuh``) under ``csrc/`` and of the flags, so an edited
source or header rebuilds and an unchanged one is reused.
``build()`` starts every requested ``nvcc`` at once and waits for all of
them.  Nothing here runs at import: the CPU tests import every module on a
machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("flash_fwd", "flash_bwd", "rms_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory report) per kernel built
#: in this process.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load the named kernels; raises with
    nvcc's output if any fails."""
    names = tuple(names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            out = _lib_path(n)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[n] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_lib_path(n)))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    return build((name,))[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if code != 0:
        lib.rt_error_string.restype = ctypes.c_char_p
        lib.rt_error_string.argtypes = [ctypes.c_int]
        msg = lib.rt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
