"""CPU parity of the port's flash-attention backward with the JAX package:
``flash_attention_bwd_ref`` (the plain version of kernels K2 and K3)
against JAX's ``_flash_bwd`` (the Pallas kernels in interpret mode, through
``jax.vjp`` of ``flash_attention(..., force_pallas=True, interpret=True)``)
at JAX's tiles, and the port's ``torch.autograd.Function`` on the CPU
against plain autograd through ``mha_reference``.

Inputs are drawn with numpy from a seed and handed to both packages in
fp32; the tolerance (1e-4) is fp32 summation-order noise on gradients of
magnitude ~1-10.

Rows that see no key (``q_offset < 0``) get dO = 0: there JAX's backward is
not the gradient of its own forward (its fully masked rows have lse =
NEG_INF, so the backward's p = exp(s - lse) is 1 where the forward
averaged with 1/n), the port copies that formula, and the two kernels'
pair sets differ on exactly those rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

S = 64
BLOCK = 16  # 4 q tiles and 4 key tiles: the diagonal cut is live
TOL = 1e-4

# (H, Hkv, D): groups 1, 2 and 4, head dims 32 and 64.
_HEADS = [(2, 2, 32), (4, 2, 64), (4, 1, 32)]
# q_offset: 0, mid, >= S, < 0 (the leading rows see no key).
_CASES = ([(True, h, hkv, d, off) for h, hkv, d in _HEADS
           for off in (0, 24, S + 8, -40)]
          + [(False, h, hkv, d, 0) for h, hkv, d in _HEADS])


def _inputs(H, Hkv, D, q_offset, causal, seed=11):
    r = np.random.default_rng(seed)
    q = r.standard_normal((2, H, S, D)).astype(np.float32)
    k = r.standard_normal((2, Hkv, S, D)).astype(np.float32)
    v = r.standard_normal((2, Hkv, S, D)).astype(np.float32)
    do = r.standard_normal((2, H, S, D)).astype(np.float32)
    if causal:
        do[:, :, np.arange(S) + q_offset < 0] = 0.0  # rows that see no key
    return q, k, v, do


@pytest.mark.parametrize("causal,H,Hkv,D,q_offset", _CASES)
def test_bwd_ref_matches_pallas_bwd(causal, H, Hkv, D, q_offset):
    q, k, v, do = _inputs(H, Hkv, D, q_offset, causal)
    scale = D ** -0.5

    def f(q, k, v):
        return jatt.flash_attention(q, k, v, causal=causal, sm_scale=scale,
                                    q_offset=q_offset, block_q=BLOCK,
                                    block_k=BLOCK, force_pallas=True,
                                    interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tatt.flash_attention_ref(tq, tk, tv, causal=causal,
                                        sm_scale=scale, q_offset=q_offset,
                                        block_q=BLOCK, block_k=BLOCK)
    delta = (tdo * out).sum(-1)
    got = tatt.flash_attention_bwd_ref(tq, tk, tv, lse, delta, tdo,
                                       causal=causal, sm_scale=scale,
                                       q_offset=q_offset, block_q=BLOCK,
                                       block_k=BLOCK)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("causal,H,Hkv,q_offset,Sq,Sk", [
    (True, 4, 2, 0, 150, 150),    # the training shape: Sq = Sk, ragged
    (True, 4, 1, 70, 80, 150),    # a later q chunk, group 4
    (False, 2, 2, 0, 70, 130),
    (True, 4, 2, -70, 150, 150),  # leading rows see no key
])
def test_autograd_function_matches_reference_autograd(causal, H, Hkv,
                                                      q_offset, Sq, Sk):
    """On CPU tensors the Function runs the plain forward and backward at
    the CUDA kernels' 64 x 64 tiles; its gradients equal autograd through
    ``mha_reference`` (rows that see no key carry dO = 0)."""
    r = np.random.default_rng(12)
    D = 32
    arrs = [r.standard_normal(s).astype(np.float32) for s in
            ((2, H, Sq, D), (2, Hkv, Sk, D), (2, Hkv, Sk, D))]
    do = r.standard_normal((2, H, Sq, D)).astype(np.float32)
    if causal:
        do[:, :, np.arange(Sq) + q_offset < 0] = 0.0

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
        out = fn(*leaves, causal=causal, q_offset=q_offset)
        out.backward(torch.from_numpy(do))
        return out.detach(), [t.grad for t in leaves]

    out, got = grads(tatt.flash_attention)
    ref_out, want = grads(tatt.mha_reference)
    seen = (np.arange(Sq) + q_offset >= 0) if causal else np.ones(Sq, bool)
    np.testing.assert_allclose(out.numpy()[:, :, seen],
                               ref_out.numpy()[:, :, seen], atol=2e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_kernel_wrappers_take_plain_version_on_cpu():
    """For CPU tensors the K2/K3 wrappers return the plain version's parts,
    and no launch is counted."""
    r = np.random.default_rng(13)
    q, k, v, do = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                   for s in ((1, 4, 100, 64), (1, 2, 100, 64),
                             (1, 2, 100, 64), (1, 4, 100, 64)))
    out, lse = tatt.flash_attention_fwd(q, k, v, causal=True)
    delta = (do * out).sum(-1)
    before = (tatt.flash_attention_bwd_dq.launches,
              tatt.flash_attention_bwd_dkv.launches)
    ref = tatt.flash_attention_bwd_ref(q, k, v, lse, delta, do)
    assert tatt.flash_attention_bwd_dq(q, k, v, lse, delta, do).equal(ref[0])
    dk, dv = tatt.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
    assert dk.equal(ref[1]) and dv.equal(ref[2])
    assert (tatt.flash_attention_bwd_dq.launches,
            tatt.flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("causal,q_offset,Sq,Sk", [
    (True, 0, 192, 192), (True, -64, 192, 192), (True, 64, 128, 256),
    (False, 0, 128, 192)])
def test_flash_attention_head_dim_32_grads_match_pallas(causal, q_offset, Sq,
                                                        Sk):
    """The port's ``flash_attention`` under autograd at head_dim 32 (the
    tiny model's; fp32 K1-K3 on the card) against the vjp of JAX's
    ``flash_attention`` with the Pallas kernels in interpret mode, both at
    the kernels' 64 x 64 tiles; rows that see no key carry dO = 0."""
    r = np.random.default_rng(15)
    D, H, Hkv = 32, 4, 2
    q = r.standard_normal((2, H, Sq, D)).astype(np.float32)
    k = r.standard_normal((2, Hkv, Sk, D)).astype(np.float32)
    v = r.standard_normal((2, Hkv, Sk, D)).astype(np.float32)
    do = r.standard_normal((2, H, Sq, D)).astype(np.float32)
    if causal:
        do[:, :, np.arange(Sq) + q_offset < 0] = 0.0
    bq, bk = tatt.KERNEL_BLOCK_Q, tatt.KERNEL_BLOCK_K

    def f(q, k, v):
        return jatt.flash_attention(q, k, v, causal=causal,
                                    q_offset=q_offset, block_q=bq,
                                    block_k=bk, force_pallas=True,
                                    interpret=True)

    j_out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tatt.flash_attention(*leaves, causal=causal, q_offset=q_offset)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=2e-5)
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("causal,q_offset,Sq,Sk", [
    (True, 0, 192, 192), (True, -64, 192, 192), (True, 64, 128, 256),
    (False, 0, 128, 192)])
def test_flash_attention_head_dim_32_bf16_grads_match_pallas(causal,
                                                             q_offset, Sq,
                                                             Sk):
    """As above in bf16 (the tiny model's default dtype; the CUDA-core
    kernels take it on the card): the same bf16 inputs through both.  Both
    compute in fp32 and round each output to bf16, so they may differ by
    the rounding of sums taken in another order: per element 2^-7 |want|
    + 2^-8, and 2^-8 in relative norm."""
    import ml_dtypes

    r = np.random.default_rng(16)
    D, H, Hkv = 32, 4, 2
    q = r.standard_normal((2, H, Sq, D)).astype(ml_dtypes.bfloat16)
    k = r.standard_normal((2, Hkv, Sk, D)).astype(ml_dtypes.bfloat16)
    v = r.standard_normal((2, Hkv, Sk, D)).astype(ml_dtypes.bfloat16)
    do = r.standard_normal((2, H, Sq, D)).astype(np.float32)
    if causal:
        do[:, :, np.arange(Sq) + q_offset < 0] = 0.0
    do = do.astype(ml_dtypes.bfloat16)
    bq, bk = tatt.KERNEL_BLOCK_Q, tatt.KERNEL_BLOCK_K

    def f(q, k, v):
        return jatt.flash_attention(q, k, v, causal=causal,
                                    q_offset=q_offset, block_q=bq,
                                    block_k=bk, force_pallas=True,
                                    interpret=True)

    j_out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    leaves = [bf16(a).requires_grad_(True) for a in (q, k, v)]
    out = tatt.flash_attention(*leaves, causal=causal, q_offset=q_offset)
    out.backward(bf16(do))
    assert out.dtype == torch.bfloat16
    for name, got, w in zip(("out", "dq", "dk", "dv"),
                            (out.detach(), *(t.grad for t in leaves)),
                            (j_out, *want)):
        got = got.float().numpy()
        w = np.asarray(w, dtype=np.float32)
        np.testing.assert_allclose(got, w, rtol=2 ** -7, atol=2 ** -8,
                                   err_msg=name)
        assert np.linalg.norm(got - w) <= 2 ** -8 * np.linalg.norm(w), name


@pytest.mark.parametrize("q_offset", [0, -64, 100])
def test_bwd_is_the_gradient_of_the_plain_forward(q_offset):
    """The Function's backward (the plain K2/K3) against autograd through
    ``flash_attention_ref`` at the kernels' 64 x 64 tiles, with dO on every
    row.  At q_offset = -64 the first q tile sees no key and visits no key
    tile: its rows must contribute nothing (a backward that ignored K1's
    visits would give them p = exp(NEG_INF - lse) = 1)."""
    r = np.random.default_rng(14)
    Sq = Sk = 200  # 4 key tiles, ragged
    arrs = [r.standard_normal(s).astype(np.float32) for s in
            ((1, 4, Sq, 32), (1, 2, Sk, 32), (1, 2, Sk, 32))]
    do = torch.from_numpy(r.standard_normal((1, 4, Sq, 32)).astype(
        np.float32))

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
        fn(*leaves, causal=True, q_offset=q_offset).backward(do)
        return [t.grad for t in leaves]

    got = grads(tatt.flash_attention)
    want = grads(lambda *a, **kw: tatt.flash_attention_ref(*a, **kw)[0])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(w).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)
