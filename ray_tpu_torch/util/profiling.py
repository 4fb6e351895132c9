"""Device profiling through ``torch.profiler`` (port of
``ray_tpu/util/profiling.py``)::

    from ray_tpu_torch.util import profiling

    with profiling.device_trace("/tmp/tb"):       # whole-section trace
        for step in range(10):
            with profiling.step_annotation(step):
                state, _ = train_step(state, batch)

The capture lands in ``log_dir`` as a Chrome trace
(``<host>_<pid>.<time>.pt.trace.json``, what ``tensorboard --logdir`` and
chrome://tracing read).  The activities follow the device, as the port's
entry points do: on the card (the default) host and CUDA activity, and if
this build of torch cannot capture CUDA activity the call raises instead of
quietly tracing the host alone; ``device="cpu"`` traces the host only.
One capture at a time per process (``ProfilerBusyError``,
``active_trace_dir``), as in the JAX package.  This module imports nothing
of JAX and nothing of ``ray_tpu``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity

from ..device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

#: The profiler is process-global: one capture at a time.  Guarded here so
#: a second ``device_trace`` fails TYPED instead of raising deep inside
#: torch and leaving the first capture wedged.
_active_lock = threading.Lock()
_active_dir: Optional[str] = None


class ProfilerBusyError(RuntimeError):
    """A device trace is already being captured in this process."""


def active_trace_dir() -> Optional[str]:
    """Log dir of the capture in flight, or None when idle."""
    return _active_dir


def _activities(device: DeviceLike):
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [ProfilerActivity.CPU]
    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        raise RuntimeError(
            "torch.profiler cannot capture CUDA activity in this build; "
            "pass device='cpu' to trace the host alone")
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


@contextlib.contextmanager
def device_trace(log_dir: str, *,
                 device: DeviceLike = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (the card's activity unless ``device="cpu"``).

    Raises :class:`ProfilerBusyError` when a capture is already active in
    this process.  A failing trace export is logged, never raised: it must
    not mask the block's real exception, and the active flag is cleared
    either way so the next capture isn't wedged behind a corpse."""
    global _active_dir
    activities = _activities(device)
    with _active_lock:
        if _active_dir is not None:
            raise ProfilerBusyError(
                f"device trace already capturing into {_active_dir!r}")
        _active_dir = log_dir
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        try:
            yield
        finally:
            try:
                prof.stop()
                torch.profiler.tensorboard_trace_handler(log_dir)(prof)
            except Exception:
                logger.warning("torch.profiler export failed for %s",
                               log_dir, exc_info=True)
    finally:
        with _active_lock:
            _active_dir = None


@contextlib.contextmanager
def step_annotation(step: int, name: str = "train") -> Iterator[None]:
    """Mark one step so the trace groups its ops (a ``name#step`` range,
    as the profiler's own ``ProfilerStep#N``)."""
    with torch.profiler.record_function(f"{name}#{step}"):
        yield


@contextlib.contextmanager
def annotation(name: str) -> Iterator[None]:
    """Named region in the host timeline."""
    with torch.profiler.record_function(name):
        yield
