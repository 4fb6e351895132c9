"""GPU accelerator support: card autodetect and visibility isolation (port
of ``ray_tpu/accelerators.py``, whose TPU chip pool this is the
counterpart of).

- **Autodetect** (`num_gpus`): ``RT_GPUS`` overrides the count, as
  ``RT_TPU_CHIPS`` does for chips (tests use it to mock cards).  A process
  that was started with ``CUDA_VISIBLE_DEVICES`` advertises the cards of
  that list.  Otherwise the count comes from NVML (the driver's management
  library, through ctypes), which creates no CUDA context: the head runs in
  the driver.  Without NVML the count is 0.  The ``/dev/nvidia<n>`` device
  files, the counterpart of ``/dev/accel*``, are not counted: a container
  may hold more of them than cards (one machine with one card exposed
  ``/dev/nvidia0`` and ``/dev/nvidia7``).
- **Validation** (`validate_request`): any whole count, or a fraction
  below 1, is accepted.  Fractions are admission only:
  they get no grant, so such a task sees no card.  The TPU's valid chip
  topologies, pod-slice resources and labels have no counterpart.
- **Visibility isolation** (`visibility_env`): a granted process gets
  ``CUDA_VISIBLE_DEVICES`` set to its card IDs, mapped through the
  parent's own ``CUDA_VISIBLE_DEVICES`` list when the parent had one (the
  spawner hands that list on as ``RT_PARENT_CUDA_VISIBLE_DEVICES``).
  Workers start with ``CUDA_VISIBLE_DEVICES=""``, so an ungranted task
  that asks the port for the card raises instead of sharing it unseen.

The head's scheduler owns the per-node GPU-ID pool (scheduler.py
``allocate_gpus``); the worker applies the env right before running the
task's function, before CUDA is first initialised in that process: CUDA
reads ``CUDA_VISIBLE_DEVICES`` once, at its first initialisation.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional

#: The worker environment's variable carrying the spawner's own
#: ``CUDA_VISIBLE_DEVICES`` (absent when the spawner had none).
PARENT_VISIBLE = "RT_PARENT_CUDA_VISIBLE_DEVICES"

def _nvml_count() -> Optional[int]:
    """Cards NVML sees, or None when the library is missing or fails."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    count = ctypes.c_uint(0)
    try:
        if nvml.nvmlInit_v2() != 0:
            return None
        try:
            if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
                return None
        finally:
            nvml.nvmlShutdown()
    except AttributeError:
        return None
    return int(count.value)


def _visible_list(value: str) -> List[str]:
    return [v.strip() for v in value.split(",") if v.strip()]


def num_gpus() -> int:
    """Number of GPUs this host offers the runtime (0 when none)."""
    override = os.environ.get("RT_GPUS")
    if override is not None:
        try:
            return max(0, int(override))
        except ValueError:
            return 0
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len(_visible_list(visible))
    return _nvml_count() or 0


def validate_request(quantity: float) -> Optional[str]:
    """None when ``quantity`` is a supported per-task GPU count, else an
    error message: a whole count, or a fraction below 1 (admission only).
    A whole count above every node's cards is infeasible, as any resource
    request larger than every node is."""
    if 0 < quantity < 1 or (quantity >= 1 and quantity == int(quantity)):
        return None
    return (
        f"requested GPU={quantity}, but only whole counts (or a fraction "
        "< 1) can be granted"
    )


def node_resources() -> Dict[str, float]:
    """Resources a node should auto-advertise for its GPUs."""
    n = num_gpus()
    return {"GPU": float(n)} if n else {}


def visibility_env(gpu_ids: List[int],
                   parent: Optional[str] = None) -> Dict[str, str]:
    """``CUDA_VISIBLE_DEVICES`` granting a process exactly ``gpu_ids``,
    each mapped through ``parent`` (the spawner's own list) when given."""
    ids = [str(g) for g in sorted(gpu_ids)]
    if parent is not None:
        plist = _visible_list(parent)
        ids = [plist[g] for g in sorted(gpu_ids) if g < len(plist)]
    return {"CUDA_VISIBLE_DEVICES": ",".join(ids)}


def apply_visibility(gpu_ids: List[int]) -> None:
    """Apply `visibility_env` to this process.  Takes effect only before
    CUDA's first initialisation in the process, which is why grants go to
    fresh workers."""
    os.environ.update(visibility_env(gpu_ids, os.environ.get(PARENT_VISIBLE)))


def set_worker_env(env: Dict[str, str]) -> None:
    """Make ``env`` (a copy of the spawner's environment) a worker's: no
    card visible until a grant, and the spawner's own
    ``CUDA_VISIBLE_DEVICES`` kept for mapping grants through."""
    parent = env.get("CUDA_VISIBLE_DEVICES")
    if parent is None:
        env.pop(PARENT_VISIBLE, None)
    else:
        env[PARENT_VISIBLE] = parent
    env["CUDA_VISIBLE_DEVICES"] = ""
