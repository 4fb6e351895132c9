"""Bounded device-resident LoRA adapter pool for the inference engine
(port of ``ray_tpu/serve/adapter_pool.py``).

Built like the KV :class:`PageAllocator`: a host-side free list over fixed
device slots.  The device tensors are ONE stacked tensor per LoRA matrix
(``models/paged.init_adapter_pool``), so which adapter a batch slot uses is
per-step DATA: loading, evicting or remixing adapters never adds a
signature to the decode program.

Slots are pinned while any in-flight sequence decodes with them; only
unpinned residents are LRU-evictable.  Adapter weights come from host or
device tensors; eviction is free (the slot is simply overwritten by the
next load), and index ``max_adapters`` is the permanent zero adapter for
base-model traffic.  Weights may also page in through the object store:
an ``ObjectRef`` source is read with the runtime's ``get`` when the
adapter loads.  Tensors come back from the store on the CPU, so what it
held is moved to the pool's device.

Not thread-safe by design: the engine's loop thread owns the pool the same
way it owns the KV pools (acquire/release only happen between decode
steps).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from ..core.object_ref import ObjectRef
from ..device import DeviceLike, resolve_device
from ..models.llama import Lora
from ..models.paged import (AdapterArrays, adapter_load, init_adapter_pool,
                            pack_lora)


class AdapterNotFoundError(KeyError):
    """Request named an adapter that was never registered."""


def _check_source(source: Any, lazy: bool = True) -> None:
    """Raise ``TypeError`` on a weight source the pool cannot read (with
    ``lazy=False``, on one that is not weights themselves: what a
    callable source returned)."""
    if lazy and isinstance(source, ObjectRef):
        return
    if not (isinstance(source, (dict, Lora)) or (lazy and callable(source))):
        raise TypeError(
            f"adapter source of type {type(source).__name__}: expected "
            f"packed tensors (pack_lora), a Lora, a numpy tree in the JAX "
            f"layout, an ObjectRef to one, or a zero-argument callable "
            f"returning one")


class AdapterPool:
    """Fixed number of device-resident adapter slots plus a host registry
    of every known adapter's weights (packed tensors, a ``Lora``, a numpy
    tree in the JAX layout, an ``ObjectRef`` to one of those, or a
    callable returning one)."""

    def __init__(self, model_config, max_adapters: int = 4, rank: int = 8,
                 device: DeviceLike = None):
        self.model_config = model_config
        self.max_adapters = max_adapters
        self.rank = rank
        self.device = resolve_device(device)
        self.arrays: AdapterArrays = init_adapter_pool(
            model_config, max_adapters, rank, device=self.device)
        self._free: List[int] = list(range(max_adapters))
        self._slots: Dict[str, int] = {}       # resident name -> slot
        self._pins: Dict[str, int] = {}        # resident name -> pin count
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # recency
        self._sources: Dict[str, Any] = {}     # name -> weight source
        self._pending: set = set()             # reserved, weights not loaded
        self.evictions = 0
        self.loads = 0

    # ------------------------------------------------------------ registry

    @property
    def zero_slot(self) -> int:
        """Slot index decoding base-model requests (all-zero delta)."""
        return self.max_adapters

    def register(self, name: str, source: Any) -> bool:
        """Make ``name`` loadable.  ``source`` is packed tensors (see
        ``pack_lora``), a ``Lora``, a numpy tree in the JAX layout, an
        ``ObjectRef`` to one of those (read when the adapter loads), or a
        zero-argument callable returning one.  Re-registering
        drops any resident copy (the weights changed: the caller must also
        drop derived state like cached prefixes).  Returns True when a
        resident copy was dropped."""
        _check_source(source)
        self._sources[name] = source
        if name in self._slots:
            if self._pins.get(name, 0):
                raise RuntimeError(
                    f"adapter {name!r} re-registered while pinned by "
                    "in-flight sequences")
            self._free.append(self._slots.pop(name))
            self._pins.pop(name, None)
            self._lru.pop(name, None)
            self._pending.discard(name)
            return True
        return False

    def has(self, name: str) -> bool:
        return name in self._sources

    def resident(self, name: str) -> bool:
        return name in self._slots

    # ------------------------------------------------------- acquire/release

    def can_acquire(self, name: Optional[str]) -> bool:
        """Admission-time check (no device work): would ``acquire``
        succeed right now?  True for base-model requests, residents, free
        slots, and evictable (unpinned) residents."""
        if name is None or name in self._slots or self._free:
            return name is None or name in self._sources
        if name not in self._sources:
            return False
        return any(self._pins.get(n, 0) == 0 for n in self._slots)

    def reserve(self, name: Optional[str]) -> int:
        """Pin ``name`` into a slot WITHOUT loading weights (host-only:
        safe under the engine lock).  Admission reserves so that requests
        admitted in the same round see each other's pins; the prefill path
        loads via :meth:`ensure_loaded` before the slot is read."""
        if name is None:
            return self.zero_slot
        if name not in self._sources:
            raise AdapterNotFoundError(name)
        slot = self._slots.get(name)
        if slot is None:
            slot = self._take_slot()
            self._slots[name] = slot
            self._pending.add(name)
        self._pins[name] = self._pins.get(name, 0) + 1
        self._lru[name] = None
        self._lru.move_to_end(name)
        return slot

    def ensure_loaded(self, name: Optional[str]) -> None:
        """Materialize a reserved adapter's weights into its slot (device
        work, loop thread only).  No-op for loaded residents."""
        if name is not None and name in self._pending:
            self._load(name, self._slots[name])
            self._pending.discard(name)

    def acquire(self, name: Optional[str]) -> int:
        """Pin ``name`` into a slot (loading/evicting on demand: device
        work, loop thread only) and return the slot index."""
        slot = self.reserve(name)
        self.ensure_loaded(name)
        return slot

    def release(self, name: Optional[str]) -> None:
        if name is None:
            return
        n = self._pins.get(name, 0)
        if n <= 0:
            raise AssertionError(f"release of unpinned adapter {name!r}")
        self._pins[name] = n - 1

    def reset(self) -> None:
        """Drop all residency and pins and rebuild the device tensors
        (after a failed in-place call may have left them half written).
        The registry survives: adapters reload on next acquire."""
        self.arrays = init_adapter_pool(
            self.model_config, self.max_adapters, self.rank,
            device=self.device)
        self._free = list(range(self.max_adapters))
        self._slots.clear()
        self._pins.clear()
        self._lru.clear()
        self._pending.clear()

    def warmup_compile(self) -> None:
        """Run the ``adapter_load`` program once before serving (engine
        ``warmup()``): a zero payload written into the permanent zero slot
        is a value no-op, but it records the load's signature so the first
        real adapter load after warmup adds none.  Loop thread only."""
        packed = {name: torch.zeros_like(arr[0])
                  for name, arr in self.arrays.items()}
        self.arrays = adapter_load(self.arrays, self.zero_slot, packed)

    # -------------------------------------------------------------- internal

    def _take_slot(self) -> int:
        if self._free:
            return self._free.pop()
        for victim in self._lru:  # oldest first
            if self._pins.get(victim, 0) == 0:
                self.evictions += 1
                self._lru.pop(victim)
                self._pins.pop(victim, None)
                self._pending.discard(victim)
                return self._slots.pop(victim)
        raise RuntimeError(
            f"all {self.max_adapters} adapter slots pinned by in-flight "
            "sequences; admission should have checked can_acquire()")

    def _load(self, name: str, slot: int) -> None:
        packed = self._materialize(self._sources[name])
        self.arrays = adapter_load(self.arrays, slot, packed)
        self._slots[name] = slot
        self.loads += 1

    def _materialize(self, source: Any) -> AdapterArrays:
        if isinstance(source, ObjectRef):
            from ..core.api import get

            source = get(source)
            _check_source(source)
        if callable(source) and not isinstance(source, Lora):
            source = source()
            _check_source(source, lazy=False)
        if isinstance(source, Lora) or (isinstance(source, dict)
                                        and "layers" in source):
            return pack_lora(self.model_config, source, device=self.device)
        # Packed tensors, from the store (on the CPU) or from a caller.
        return {k: v.to(self.device) for k, v in source.items()}

    @property
    def pinned_count(self) -> int:
        """Adapters currently pinned by in-flight sequences."""
        return sum(1 for c in self._pins.values() if c)

    def stats(self) -> Dict[str, Any]:
        return {
            "registered": len(self._sources),
            "resident": sorted(self._slots),
            "pinned": {n: c for n, c in self._pins.items() if c},
            "free_slots": len(self._free),
            "evictions": self.evictions,
            "loads": self.loads,
        }
