"""Checkpoints: directory handles + top-K retention (port of
``ray_tpu/train/checkpoint.py``).

Role-equivalent to the reference's train/_checkpoint.py:56 (Checkpoint as a
directory on a filesystem) and train/_internal/checkpoint_manager.py (top-K
by score).  Storage is a filesystem path (shared FS or local); model-state
serialization itself is the caller's business — `save_pytree`/`load_pytree`
helpers cover the common case: tensors (on the card or the CPU),
``nn.Module``s and optimizers (by their state dicts), dataclasses such as
``TrainState`` (by their fields) and nested containers of them go to the
host and into a pickle-5 file.  Tensors stay tensors there, on the CPU: a
bf16 tensor, which numpy cannot hold, restores bit for bit.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple


def link_or_copy(src: str, dst: str) -> str:
    """``dst`` as a hard link to ``src``, or a copy where no link can be
    made (another filesystem, a filesystem without links)."""
    try:
        if os.path.lexists(dst):
            os.unlink(dst)
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)
    return dst


class Checkpoint:
    """Handle to a checkpoint directory (reference: train/_checkpoint.py)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="rt_ckpt_")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        meta_path = os.path.join(self.path, ".metadata.json")
        existing = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                existing = json.load(f)
        existing.update(metadata)
        with open(meta_path, "w") as f:
            json.dump(existing, f)

    def get_metadata(self) -> Dict[str, Any]:
        meta_path = os.path.join(self.path, ".metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
        return {}

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


def _host_tree(tree: Any, pinned: list) -> Any:
    """``tree`` with every tensor replaced by a host copy of it: a CPU
    tensor is cloned, a device tensor gets a (pinned) host buffer whose copy
    is queued without waiting (``pinned`` collects them; the caller
    synchronizes once, so the copies overlap).  Modules and optimizers
    become their state dicts, dataclasses dicts of their fields; numpy
    arrays are copied; anything else is kept as it is."""
    import dataclasses

    import numpy as np
    import torch

    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.device.type == "cpu":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        pinned.append(t.device)
        return out
    if isinstance(tree, (torch.nn.Module, torch.optim.Optimizer)):
        return _host_tree(tree.state_dict(), pinned)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _host_tree(getattr(tree, f.name), pinned)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return type(tree)((k, _host_tree(v, pinned))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host_tree(v, pinned) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v, pinned) for v in tree)
    return tree


def host_snapshot(tree: Any) -> Any:
    """A host copy of ``tree`` that later in-place updates of its tensors
    (the fused AdamW's, for one) cannot reach: every device-to-host copy is
    queued first, then one wait per device completes them all."""
    import torch

    pinned: list = []
    out = _host_tree(tree, pinned)
    for dev in set(pinned):
        torch.cuda.synchronize(dev)
    return out


def save_pytree(tree: Any, directory: str, name: str = "state") -> None:
    """Save a tree of tensors, modules and containers into a checkpoint
    directory."""
    os.makedirs(directory, exist_ok=True)
    host_tree = host_snapshot(tree)
    with open(os.path.join(directory, f"{name}.pkl"), "wb") as f:
        pickle.dump(host_tree, f, protocol=5)


def load_pytree(directory: str, name: str = "state") -> Any:
    """The tree ``save_pytree`` wrote: tensors come back on the CPU."""
    with open(os.path.join(directory, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


def pack_directory(directory: str) -> bytes:
    """Flatten a checkpoint directory into one blob ({relpath: bytes},
    pickle-5) — the wire/object-store form of an in-memory checkpoint
    replica (see CheckpointConfig.memory_ckpt_every_k)."""
    files: Dict[str, bytes] = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, directory)] = f.read()
    return pickle.dumps(files, protocol=5)


def unpack_directory(blob: bytes, directory: str) -> str:
    """Materialize a pack_directory blob back into a directory."""
    files = pickle.loads(blob)
    for rel, data in files.items():
        path = os.path.join(directory, rel)
        os.makedirs(os.path.dirname(path) or directory, exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    os.makedirs(directory, exist_ok=True)  # empty checkpoints stay loadable
    return directory


class AsyncCheckpointWriter:
    """Overlapped checkpoint saves: ``save()`` snapshots the tree to host
    memory synchronously (every device-to-host copy is queued into pinned
    buffers first, so the transfers overlap, and the blocking part is just
    their completion), then serialization and disk IO run on a background
    thread while the train loop keeps stepping.

    The synchronous host snapshot is REQUIRED for correctness, not an
    implementation detail: the fused AdamW of the port's train step
    updates parameters and moments in place, so the very next step
    overwrites the tensors the tree names — a background thread reading
    them would pickle a later step, or a mix of two.  What overlaps is the
    expensive part (pickle + disk/remote IO — the reference gets the same
    overlap from Tune's threaded checkpoint upload,
    train/_internal/storage.py; SURVEY §7 lists async checkpointing as an
    MFU requirement).

    One save is in flight at a time: a new ``save`` waits for the previous
    write to land (bounded memory, ordered checkpoints).  The writer
    thread is non-daemon, so a process that exits right after ``save``
    still finishes the write.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree: Any, directory: str, name: str = "state") -> None:
        """Snapshot ``tree`` to host and start the async write.  Blocks
        only for the device-to-host copies (and any unfinished previous
        save); the caller may update the tensors as soon as it returns."""
        self.wait()  # one in flight; surfaces prior errors
        host_tree = host_snapshot(tree)

        def write():
            tmp = directory + f".tmp-{os.getpid()}"
            try:
                os.makedirs(tmp, exist_ok=True)
                with open(os.path.join(tmp, f"{name}.pkl"), "wb") as f:
                    pickle.dump(host_tree, f, protocol=5)
                # Publish without a window where NO checkpoint exists:
                # move the previous good dir aside (unique name), rename
                # the new one in, then drop the old.  A crash mid-sequence
                # leaves dest or a dest.old-* loadable — `recover` restores
                # the newest one.
                old = None
                if os.path.isdir(directory):
                    old = f"{directory}.old-{uuid.uuid4().hex[:8]}"
                    os.rename(directory, old)
                os.rename(tmp, directory)
                if old is not None:
                    shutil.rmtree(old, ignore_errors=True)
                # Sweep stale .old-* left by crashes of earlier publishes.
                parent = os.path.dirname(directory) or "."
                base = os.path.basename(directory)
                for entry in os.listdir(parent):
                    if entry.startswith(base + ".old-"):
                        shutil.rmtree(os.path.join(parent, entry),
                                      ignore_errors=True)
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e
                shutil.rmtree(tmp, ignore_errors=True)  # never reuse stale tmp

        with self._lock:
            self._pending = threading.Thread(
                target=write, name="async-ckpt"
            )
            self._pending.start()

    @staticmethod
    def recover(directory: str) -> Optional[str]:
        """Crash recovery: if ``directory`` is missing but a publish left a
        ``.old-*`` sibling, restore the newest one and return the usable
        path (or None when nothing is recoverable)."""
        if os.path.isdir(directory):
            return directory
        parent = os.path.dirname(directory) or "."
        base = os.path.basename(directory)
        try:
            candidates = sorted(
                (e for e in os.listdir(parent)
                 if e.startswith(base + ".old-")),
                key=lambda e: os.path.getmtime(os.path.join(parent, e)),
            )
        except OSError:
            return None
        if not candidates:
            return None
        os.rename(os.path.join(parent, candidates[-1]), directory)
        return directory

    def wait(self) -> None:
        """Block until the in-flight save (if any) is durable; re-raises a
        failed write here rather than losing it."""
        with self._lock:
            t = self._pending
        if t is not None:
            t.join()
            with self._lock:
                self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class CheckpointManager:
    """Keeps the top-K checkpoints by score under a storage directory
    (reference: train/_internal/checkpoint_manager.py)."""

    def __init__(
        self,
        storage_dir: str,
        num_to_keep: Optional[int] = None,
        score_attribute: Optional[str] = None,
        score_order: str = "max",
    ):
        self.storage_dir = storage_dir
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        # [(score, index, Checkpoint, metrics)]
        self.checkpoints: List[Tuple[float, int, Checkpoint, dict]] = []
        self._index = 0
        os.makedirs(storage_dir, exist_ok=True)

    def register(self, checkpoint: Checkpoint, metrics: dict, *,
                 link: bool = False) -> Checkpoint:
        """Persist a (worker-local) checkpoint into storage and apply the
        retention policy.  Returns the persisted handle.  ``link=True``
        hard-links the files instead of copying them, for a caller's
        private copy that nothing writes again (the trainer's merged
        rank checkpoints)."""
        self._index += 1
        dest = os.path.join(self.storage_dir, f"checkpoint_{self._index:06d}")
        if os.path.abspath(checkpoint.path) != dest:
            shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True,
                            copy_function=(link_or_copy if link
                                           else shutil.copy2))
        persisted = Checkpoint(dest)
        if self.score_attribute and self.score_attribute in metrics:
            score = float(metrics[self.score_attribute])
        else:
            score = float(self._index)  # recency
        if self.score_order == "min":
            score = -score
        self.checkpoints.append((score, self._index, persisted, dict(metrics)))
        self._apply_retention()
        return persisted

    def _apply_retention(self):
        if self.num_to_keep is None or len(self.checkpoints) <= self.num_to_keep:
            return
        self.checkpoints.sort(key=lambda t: (t[0], t[1]))
        while len(self.checkpoints) > self.num_to_keep:
            _, _, ckpt, _ = self.checkpoints.pop(0)  # worst first
            shutil.rmtree(ckpt.path, ignore_errors=True)

    def latest(self) -> Optional[Checkpoint]:
        if not self.checkpoints:
            return None
        return max(self.checkpoints, key=lambda t: t[1])[2]

    def best(self) -> Optional[Checkpoint]:
        if not self.checkpoints:
            return None
        return max(self.checkpoints, key=lambda t: (t[0], t[1]))[2]
