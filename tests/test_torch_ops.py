"""CPU parity of the PyTorch port's ops (``ray_tpu_torch.ops``) with the JAX
package: RoPE, RMSNorm (plain version of kernel K4, against the jnp form
and the Pallas kernel in interpret mode) and flash attention (plain version
of kernel K1, out AND lse, against the Pallas forward kernel in interpret
mode and against ``mha_reference``).

Inputs are drawn with numpy from a seed and handed to both packages in
fp32; tolerances are fp32 summation-order noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rotary as jrot
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rotary as trot


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("offset", [0, 5, "tensor"])
def test_rotary_matches_jax(offset):
    x = _rng(1).standard_normal((2, 3, 10, 16)).astype(np.float32)
    jc, js = jrot.rope_frequencies(16, 64, theta=500000.0)
    tc, ts = trot.rope_frequencies(16, 64, theta=500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    if offset == "tensor":
        j_off, t_off = jnp.asarray(7), torch.tensor(7)
    else:
        j_off, t_off = offset, offset
    want = jrot.apply_rotary(jnp.asarray(x), jc, js, position_offset=j_off)
    got = trot.apply_rotary(torch.from_numpy(x), tc, ts, position_offset=t_off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("rows", [48, 50])  # 50: Pallas falls back to jnp
def test_rms_norm_matches_jax_and_pallas(rows):
    x = _rng(2).standard_normal((rows, 64)).astype(np.float32)
    w = (1 + 0.1 * _rng(3).standard_normal(64)).astype(np.float32)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    pallas = jnorms.rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                    block_rows=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-6)
    # The kernel wrapper takes the plain version for a CPU tensor.
    assert tnorms.rms_norm_cuda(torch.from_numpy(x), torch.from_numpy(w),
                                1e-5).equal(got)


def test_rms_norm_differentiable_under_autograd():
    x = torch.from_numpy(_rng(4).standard_normal((4, 32)).astype(np.float32))
    x.requires_grad_(True)
    w = torch.ones(32)
    tnorms.rms_norm(x, w).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# Sq 64 / Sk 64 with 16-wide tiles: 4 key tiles, so the causal diagonal cut
# is live.  Offsets: < 0 (leading rows see no key: some tiles visit nothing,
# some visit a tile where every score is masked), 0, mid, and >= Sk.
_HEADS = [(2, 2, 32), (4, 2, 64), (4, 1, 32)]  # (H, Hkv, D): groups 1, 2, 4
_FLASH_CASES = (
    [(True, h, hkv, d, off) for h, hkv, d in _HEADS
     for off in (-40, 0, 24, 80)]
    + [(False, h, hkv, d, 0) for h, hkv, d in _HEADS]
    + [(True, 4, 2, 32, 24), (False, 2, 2, 64, 0)])


def _qkv(H, Hkv, D, Sq=64, Sk=64, seed=5):
    r = _rng(seed)
    q = r.standard_normal((2, H, Sq, D)).astype(np.float32)
    k = r.standard_normal((2, Hkv, Sk, D)).astype(np.float32)
    v = r.standard_normal((2, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,H,Hkv,D,q_offset", _FLASH_CASES)
def test_flash_ref_matches_pallas_and_reference(causal, H, Hkv, D, q_offset):
    q, k, v = _qkv(H, Hkv, D)
    scale = D ** -0.5
    bq = bk = 16
    j_out, j_lse = jatt._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
        q_offset, bq, bk, True)
    t_out, t_lse = tatt.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        sm_scale=scale, q_offset=q_offset, block_q=bq, block_k=bk)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=2e-5, rtol=1e-6)
    # Rows that see at least one key equal the one-shot reference.
    ref_out = np.asarray(jatt.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=scale, q_offset=q_offset))
    seen = (np.arange(q.shape[2]) + q_offset >= 0) if causal else \
        np.ones(q.shape[2], bool)
    np.testing.assert_allclose(t_out.numpy()[:, :, seen],
                               ref_out[:, :, seen], atol=2e-5)


@pytest.mark.parametrize("causal,q_offset", [(True, -8), (True, 0),
                                             (True, 40), (False, 0)])
def test_mha_reference_matches_jax(causal, q_offset):
    q, k, v = _qkv(4, 2, 32, Sq=24, Sk=40, seed=6)
    j_out, j_lse = jatt._mha_reference_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=None, q_offset=q_offset)
    t_out, t_lse = tatt._mha_reference_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        sm_scale=None, q_offset=q_offset)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=2e-5,
                               rtol=1e-6)


def test_flash_attention_cpu_uses_kernel_tiles():
    """On a CPU tensor the kernel wrapper returns the plain version with
    the CUDA kernel's tile sizes, ragged lengths included."""
    q, k, v = _qkv(4, 2, 32, Sq=70, Sk=150, seed=7)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = tatt.flash_attention_fwd(*args, causal=True, q_offset=-70)
    ref_out, ref_lse = tatt.flash_attention_ref(
        *args, causal=True, q_offset=-70, block_q=tatt.KERNEL_BLOCK_Q,
        block_k=tatt.KERNEL_BLOCK_K)
    assert out.equal(ref_out) and lse.equal(ref_lse)
    assert tatt.flash_attention(*args, causal=True, q_offset=-70).equal(out)
    # Tile 0 visits no key tile: O = 0, lse ~ NEG_INF.
    assert float(out[:, :, :64].abs().max()) == 0.0
    assert float(lse[:, :, :64].max()) <= -1e29


# The 64x64 visiting rule that K1 keeps inside its 128-row blocks (each
# 64-row half of a block cuts its own key tiles): Sq 192 / Sk 320 are 3 q
# tiles and 5 key tiles of 64.  Offsets: whole tiles and half tiles that
# visit nothing, a tile whose rows see no key inside a visited tile, the
# diagonal, and past the end.
@pytest.mark.parametrize("q_offset", [-128, -70, -64, -1, 0, 64, 200])
def test_flash_ref_matches_pallas_at_kernel_tiles(q_offset):
    q, k, v = _qkv(2, 1, 16, Sq=192, Sk=320, seed=8)
    scale = 16 ** -0.5
    bq, bk = tatt.KERNEL_BLOCK_Q, tatt.KERNEL_BLOCK_K
    assert (bq, bk) == (64, 64)
    j_out, j_lse = jatt._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True,
        q_offset, bq, bk, True)
    j_lse = np.asarray(j_lse)[..., 0]
    # On a CPU tensor the kernel wrapper is the plain version at the
    # kernel's visiting tiles.
    t_out, t_lse = tatt.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
        sm_scale=scale, q_offset=q_offset)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, atol=2e-5, rtol=1e-6)
    # Rows that see no key (no visited tile, or every visited key masked)
    # carry lse = NEG_INF exactly, in both packages.
    dead = j_lse <= tatt.NEG_INF / 2
    assert dead.any() == (q_offset < 0)
    np.testing.assert_array_equal(t_lse.numpy()[dead], j_lse[dead])


# Head dim 32 (the tiny model's) at the kernels' 64 x 64 tiles, as the fp32
# kernels take it on the card: ragged lengths and offsets that leave rows
# with no key.
@pytest.mark.parametrize("causal,q_offset,Sq,Sk", [
    (True, 0, 192, 192), (True, -64, 192, 192), (True, 64, 128, 256),
    (False, 0, 128, 192)])
def test_flash_attention_head_dim_32_matches_pallas(causal, q_offset, Sq,
                                                    Sk):
    q, k, v = _qkv(4, 2, 32, Sq=Sq, Sk=Sk, seed=9)
    scale = 32 ** -0.5
    j_out, j_lse = jatt._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
        q_offset, tatt.KERNEL_BLOCK_Q, tatt.KERNEL_BLOCK_K, True)
    t_out, t_lse = tatt.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        q_offset=q_offset)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=2e-5, rtol=1e-6)


def test_kernel_args_head_dims_per_dtype():
    """The kernels take head_dim 32, 64 and 128 in fp32 and in bf16;
    anything else raises ValueError naming the dtype and the head dim (no
    fallback)."""
    for dt in (torch.float32, torch.bfloat16):
        for D in (32, 64, 128):
            x = torch.zeros(1, 2, 8, D, dtype=dt)
            tatt._check_kernel_args(x, x, x)
    for dt, D in ((torch.bfloat16, 96), (torch.bfloat16, 16),
                  (torch.float32, 16), (torch.float32, 256)):
        x = torch.zeros(1, 2, 8, D, dtype=dt)
        name = str(dt).split(".")[-1]
        with pytest.raises(ValueError, match=rf"{name}, got head_dim {D}"):
            tatt._check_kernel_args(x, x, x)


def test_lib_path_hashes_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ renames (so rebuilds) every kernel
    library; an unchanged tree keeps its names."""
    from ray_tpu_torch import _build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build._lib_path("k") != second


def test_kernel_layout_keeps_model_views():
    """q, k and v reach the kernels as the model makes them, transposed
    [B, S, H, D] views (seq stride H * D): no copy on the path; a view
    whose rows the kernels cannot read with 16-byte loads is copied."""
    x = torch.zeros(2, 40, 8, 64, dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    assert tatt._kernel_layout(view) is view
    odd = torch.zeros(2, 40, 8, 68, dtype=torch.bfloat16)[..., :64]
    assert odd.transpose(1, 2).stride(2) == 8 * 68
    fixed = tatt._kernel_layout(odd.transpose(1, 2))
    assert fixed.is_contiguous() and fixed.equal(odd.transpose(1, 2))
