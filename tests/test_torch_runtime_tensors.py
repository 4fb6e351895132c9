"""Tensors through the port's object store (``ray_tpu_torch.core.
serialization``), held against the JAX package's ``pack`` of the same
values.

Every tensor crosses as a CPU tensor of the same dtype, shape and bits,
with its bytes out of band (one ``PickleBuffer``, so a large layer goes to
shared memory without a copy into the meta).  The JAX package carries
numpy's own dtypes out of band too, and the out-of-band bytes must be equal;
an ``ml_dtypes`` bfloat16 array it carries in band (numpy pickles a user
dtype in band), so there the port's buffer must equal the bytes the JAX
blob holds.  A tensor from ``get`` is the process's own copy: an in-place
write to one leaves a second ``get`` unchanged.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.core import serialization as jser
from ray_tpu_torch.core import serialization as tser

#: torch dtype -> the numpy dtype the JAX package would hold the values in.
DTYPES = {
    "float32": (torch.float32, np.float32),
    "float64": (torch.float64, np.float64),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
    "int64": (torch.int64, np.int64),
    "int32": (torch.int32, np.int32),
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "bool": (torch.bool, np.bool_),
}


def _values(name, shape, seed=0):
    tdt, ndt = DTYPES[name]
    rng = np.random.default_rng(seed)
    if name == "bool":
        a = rng.integers(0, 2, shape).astype(np.bool_)
    elif tdt.is_floating_point:
        a = rng.standard_normal(shape).astype(np.float32).astype(ndt)
    else:
        info = np.iinfo(ndt)
        a = rng.integers(max(info.min, -100), min(info.max, 100),
                         shape).astype(ndt)
    t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
        if name == "bfloat16" else torch.from_numpy(a.copy())
    return a, t


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy() \
        .tobytes()


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_tensor_round_trips_out_of_band_like_jax(name):
    a, t = _values(name, (3, 5, 7))
    meta, bufs = tser.serialize(t)
    assert len(bufs) == 1
    raw = bytes(bufs[0].raw())
    assert raw == _bits(t) == a.tobytes()
    jmeta, jbufs = jser.serialize(a)
    if name == "bfloat16":
        assert not jbufs and a.tobytes() in jmeta
    else:
        assert len(jbufs) == 1 and bytes(jbufs[0].raw()) == raw
    got = tser.unpack(tser.pack(t))
    assert type(got) is torch.Tensor and got.device.type == "cpu"
    assert got.dtype == t.dtype and got.shape == t.shape
    assert _bits(got) == _bits(t)


@pytest.mark.parametrize("case", ["zero_dim", "empty", "transposed",
                                  "strided_slice", "parameter",
                                  "requires_grad"])
def test_tensor_layouts_round_trip(case):
    base = torch.arange(48, dtype=torch.float32).reshape(6, 8) / 7
    t = {
        "zero_dim": torch.tensor(2.5, dtype=torch.bfloat16),
        "empty": torch.empty(0, 4, dtype=torch.float16),
        "transposed": base.t(),
        "strided_slice": base[::2, 1::3],
        "parameter": torch.nn.Parameter(base.clone()),
        "requires_grad": base.clone().requires_grad_(True),
    }[case]
    meta, bufs = tser.serialize(t)
    assert len(bufs) == 1
    assert bytes(bufs[0].raw()) == _bits(t)
    if case in ("transposed", "strided_slice"):
        assert not t.is_contiguous()
        # The JAX package's pack of the same values (numpy makes them
        # contiguous first): the same out-of-band bytes.
        _, jbufs = jser.serialize(np.ascontiguousarray(t.numpy()))
        assert bytes(jbufs[0].raw()) == bytes(bufs[0].raw())
    got = tser.unpack(tser.pack(t))
    assert got.shape == t.shape and got.dtype == t.dtype
    assert got.is_contiguous()
    assert torch.equal(got, t.detach())
    assert isinstance(got, torch.nn.Parameter) == (case == "parameter")
    assert got.requires_grad == t.requires_grad


def test_large_tensor_meta_stays_small_and_nested_tensors_cross():
    t = torch.randn(1024, 1024)  # 4 MB
    meta, bufs = tser.serialize({"w": t, "layers": [t[:2], (t[5],)]})
    assert len(meta) < 1024
    assert sum(b.raw().nbytes for b in bufs) == t.numel() * 4 + 2 * 4096 \
        + 4096
    got = tser.unpack(tser.pack({"w": t, "layers": [t[:2], (t[5],)]}))
    assert torch.equal(got["w"], t) and torch.equal(got["layers"][0], t[:2])
    assert torch.equal(got["layers"][1][0], t[5])


def test_unpacked_tensor_owns_its_bytes():
    """``unpack`` aliases the blob for numpy; a tensor is copied out."""
    t = torch.arange(1 << 16, dtype=torch.float32)
    blob = bytearray(tser.pack(t))
    a = tser.unpack(blob)
    b = tser.unpack(blob)
    a.add_(1)
    assert torch.equal(b, t)
    assert tser.unpack(blob).sum() == t.sum()


def test_tensors_through_a_port_cluster():
    """put/get and task arguments on a running port cluster: bit-exact,
    bf16 included, over the shared-memory path; an in-place write to one
    ``get`` leaves a second unchanged."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=2)
    try:
        _, layer = _values("bfloat16", (256, 512), seed=3)  # 256 KB
        ref = rt.put(layer)
        g1, g2 = rt.get(ref), rt.get(ref)
        assert _bits(g1) == _bits(layer)
        g1.mul_(0)
        assert _bits(g2) == _bits(layer)
        assert _bits(rt.get(ref)) == _bits(layer)

        @rt.remote
        def scale(x, k):
            return [x.dtype == torch.bfloat16, x * k, torch.nn.Parameter(x)]

        ok, doubled, param = rt.get(scale.remote(ref, 2))
        assert ok and isinstance(param, torch.nn.Parameter)
        assert _bits(doubled) == _bits(layer * 2)
        assert _bits(param) == _bits(layer)
    finally:
        rt.shutdown()
