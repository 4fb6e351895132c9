"""Serialization: cloudpickle + pickle-5 out-of-band buffers.

Role-equivalent to the reference's SerializationContext
(reference: python/ray/_private/serialization.py:114) — cloudpickle for
arbitrary Python objects, protocol-5 ``buffer_callback`` so large contiguous
buffers (numpy arrays, torch tensors, Arrow buffers) are carried out-of-band
and can be placed directly into shared memory with zero copies on the write
path.

Tensors (the port's counterpart of the JAX package's ``_to_host``, which
turns a ``jax.Array`` into numpy): a CPU or CUDA ``torch.Tensor``, at any
depth of the object, crosses as a CPU tensor of the same dtype, shape and
values, so a CUDA tensor's ``get`` gives a CPU tensor.  torch's own pickling
puts a tensor's bytes in-band (its storage reducer), so ``_reduce_tensor``
carries them as a ``PickleBuffer`` over a uint8 view, with dtype and shape
in the meta.  ``reducer_override`` finds it by ``isinstance``, so
``nn.Parameter`` and other plain subclasses take it too.  Unlike numpy, a
tensor has no read-only flag, so ``_rebuild_tensor`` copies the bytes out of
the shared-memory segment (one memcpy): an in-place op on a tensor from
``get`` never writes into a sealed object.  torch is never imported here: a
process that has not imported it holds no tensor.

Wire format of a sealed object:
    [u32 meta_len][meta pickle bytes][u64 nbuf]
    ([u64 buf_len][buf bytes]) * nbuf
"""

from __future__ import annotations

import pickle
import struct
import sys
from typing import Any, Callable, Dict, List, Tuple

import cloudpickle

# Registry of custom reducers installed by the runtime (ObjectRef, ActorHandle).
_custom_reducers: Dict[type, Callable] = {}


def register_reducer(cls: type, reducer: Callable) -> None:
    _custom_reducers[cls] = reducer


class _Pickler(cloudpickle.CloudPickler):
    def reducer_override(self, obj):
        fn = _custom_reducers.get(type(obj))
        if fn is not None:
            return fn(obj)
        torch = sys.modules.get("torch")  # never import torch to type-check
        # getattr guard: another thread may be mid-`import torch`.
        tensor_t = getattr(torch, "Tensor", None) if torch else None
        if tensor_t is not None and isinstance(obj, tensor_t) \
                and _plain_tensor(torch, obj):
            return _reduce_tensor(torch, obj)
        return super().reducer_override(obj)


def _plain_tensor(torch, t) -> bool:
    """A dense tensor whose class adds no dispatch of its own (a wrapper
    subclass such as a DTensor keeps torch's reducer)."""
    return (t.layout == torch.strided and not t.is_quantized
            and t.device.type != "meta"
            and type(t).__torch_dispatch__ is torch.Tensor.__torch_dispatch__)


def _reduce_tensor(torch, t):
    src = t.detach()
    if src.device.type != "cpu":
        src = src.cpu()
    src = src.resolve_conj().resolve_neg().contiguous()
    raw = src.reshape(-1).view(torch.uint8).numpy()
    cls = type(t)
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(src.dtype).split(".", 1)[1],
             tuple(src.shape), bool(t.requires_grad),
             None if cls is torch.Tensor else cls))


def _rebuild_tensor(buf, dtype: str, shape, requires_grad: bool, cls):
    import torch

    from ray_tpu_torch import _native

    view = memoryview(buf)
    out = torch.empty(view.nbytes, dtype=torch.uint8)
    if view.nbytes:
        _native.copy(out.numpy(), view)  # out of the (sealed) segment
    t = out.view(getattr(torch, dtype)).reshape(shape)
    if cls is torch.nn.Parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if cls is not None:
        t = t.as_subclass(cls)
    return t.requires_grad_(requires_grad) if requires_grad else t


def serialize(obj: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Serialize to (meta, out-of-band buffers)."""
    import io

    buffers: List[pickle.PickleBuffer] = []
    bio = io.BytesIO()
    pickler = _Pickler(bio, protocol=5, buffer_callback=buffers.append)
    pickler.dump(obj)
    return bio.getvalue(), buffers


def deserialize(meta: bytes, buffers: List[Any]) -> Any:
    return pickle.loads(meta, buffers=buffers)


def pack(obj: Any) -> bytes:
    """Serialize to a single contiguous blob (header + meta + buffers)."""
    meta, buffers = serialize(obj)
    parts = [struct.pack("<I", len(meta)), meta, struct.pack("<Q", len(buffers))]
    for b in buffers:
        raw = b.raw()
        parts.append(struct.pack("<Q", raw.nbytes))
        parts.append(raw)
    return b"".join(parts)


def packed_size(meta: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    n = 4 + len(meta) + 8
    for b in buffers:
        n += 8 + b.raw().nbytes
    return n


def pack_into(meta: bytes, buffers: List[pickle.PickleBuffer], dest: memoryview) -> int:
    """Write the packed representation directly into ``dest`` (e.g. a shm
    segment), returning bytes written.  This is the zero-extra-copy write path;
    large buffers go through the native parallel memcpy (GIL released)."""
    from ray_tpu_torch import _native

    off = 0
    dest[off : off + 4] = struct.pack("<I", len(meta))
    off += 4
    dest[off : off + len(meta)] = meta
    off += len(meta)
    dest[off : off + 8] = struct.pack("<Q", len(buffers))
    off += 8
    for b in buffers:
        raw = b.raw()
        n = raw.nbytes
        dest[off : off + 8] = struct.pack("<Q", n)
        off += 8
        src = raw.cast("B") if raw.format != "B" else raw
        if n >= (1 << 20):
            _native.copy(dest[off : off + n], src)
        else:
            dest[off : off + n] = src
        off += n
    return off


def unpack(blob: memoryview | bytes) -> Any:
    """Deserialize from a packed blob.  Buffer contents are NOT copied — numpy
    arrays deserialized from shm alias the segment until the caller copies
    (tensors are copied out by ``_rebuild_tensor``)."""
    view = memoryview(blob)
    off = 0
    (meta_len,) = struct.unpack_from("<I", view, off)
    off += 4
    meta = bytes(view[off : off + meta_len])
    off += meta_len
    (nbuf,) = struct.unpack_from("<Q", view, off)
    off += 8
    buffers = []
    for _ in range(nbuf):
        (blen,) = struct.unpack_from("<Q", view, off)
        off += 8
        buffers.append(view[off : off + blen])
        off += blen
    return deserialize(meta, buffers)
