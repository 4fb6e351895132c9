"""CPU parity of the port's RMSNorm gradient (``ray_tpu_torch.ops.norms``)
with the JAX package: the plain backward ``_rms_bwd_ref`` (the plain
version of K4's backward kernel) against ``jax.vjp`` of
``ray_tpu.ops.norms.rms_norm``; the ``_RMSNorm`` Function, which
``rms_norm`` takes under autograd on the card (its CPU path runs the plain
versions); and ``rms_norm`` under autograd on the CPU, which
differentiates the plain form.

Inputs are drawn with numpy from a seed and handed to both packages in
fp32.  Tolerance: 1e-5 relative plus 1e-6 absolute, fp32 summation-order
noise over rows of at most 100 values and sums over at most 64 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import norms as jnorms
from ray_tpu_torch.ops import norms as tnorms

EPS = 1e-5
RTOL, ATOL = 1e-5, 1e-6
CASES = [(rows, d) for rows in (1, 7, 64) for d in (16, 64, 100)]


def _inputs(rows, d, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((rows, d)).astype(np.float32)
    w = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    dy = r.standard_normal((rows, d)).astype(np.float32)
    return x, w, dy


def _jax_grads(x, w, dy):
    _, vjp = jax.vjp(lambda a, b: jnorms.rms_norm(a, b, EPS),
                     jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dy))
    return np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("rows,d", CASES)
def test_rms_bwd_ref_matches_jax_vjp(rows, d):
    x, w, dy = _inputs(rows, d, seed=rows * 1000 + d)
    dx, dw = tnorms._rms_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(dy), EPS)
    jdx, jdw = _jax_grads(x, w, dy)
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), jdw, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows,d", CASES)
def test_rms_norm_function_matches_ref_and_jax(rows, d):
    x, w, dy = _inputs(rows, d, seed=rows * 1000 + d + 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tnorms._RMSNorm.apply(xt, wt, EPS)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    assert y.equal(tnorms._rms_ref(xt.detach(), wt.detach(), EPS))
    y.backward(torch.from_numpy(dy))
    dx, dw = tnorms._rms_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(dy), EPS)
    assert xt.grad.equal(dx) and wt.grad.equal(dw)
    jdx, jdw = _jax_grads(x, w, dy)
    np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(7, 16), (64, 100), (2, 5, 64)])
def test_rms_bwd_ref_is_autograd_of_the_plain_form(shape):
    """On the CPU ``rms_norm`` under autograd differentiates ``_rms_ref``
    (the JAX package's jnp form op for op); ``_rms_bwd_ref`` gives the same
    bits, so the Function and the plain graph agree exactly."""
    r = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = r.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * r.standard_normal(shape[-1])).astype(np.float32)
    dy = r.standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tnorms.rms_norm(xt, wt, EPS)
    assert type(y.grad_fn).__name__ != "_RMSNormBackward"
    y.backward(torch.from_numpy(dy))
    dx, dw = tnorms._rms_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(dy), EPS)
    assert xt.grad.equal(dx) and wt.grad.equal(dw)


def test_rms_norm_function_over_leading_dims():
    """[B, S, d] as the model calls it: dw sums over every row."""
    x, w, dy = _inputs(2 * 5, 64, seed=7)
    xt = torch.from_numpy(x.reshape(2, 5, 64)).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tnorms._RMSNorm.apply(xt, wt, EPS).backward(
        torch.from_numpy(dy).view(2, 5, 64))
    jdx, jdw = _jax_grads(x, w, dy)
    assert xt.grad.shape == (2, 5, 64)
    np.testing.assert_allclose(xt.grad.numpy().reshape(10, 64), jdx,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["x", "w"])
def test_rms_norm_grad_of_one_input(which):
    x, w, dy = _inputs(7, 64, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    (xt if which == "x" else wt).requires_grad_(True)
    y = tnorms._RMSNorm.apply(xt, wt, EPS)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    y.backward(torch.from_numpy(dy))
    jdx, jdw = _jax_grads(x, w, dy)
    if which == "x":
        assert wt.grad is None
        np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=RTOL,
                                   atol=ATOL)
    else:
        assert xt.grad is None
        np.testing.assert_allclose(wt.grad.numpy(), jdw, rtol=RTOL,
                                   atol=ATOL)
    # The wrapper computes only what is asked for.
    dx, dw = tnorms.rms_norm_bwd(xt.detach(), wt.detach(),
                                 torch.from_numpy(dy), EPS,
                                 need_dx=which == "x", need_dw=which == "w")
    assert (dx is None) == (which == "w") and (dw is None) == (which == "x")


@pytest.mark.parametrize("how", ["no_grad", "frozen"])
def test_rms_norm_records_no_node_without_grad(how):
    x, w, _ = _inputs(7, 64, seed=4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if how == "no_grad":
        xt.requires_grad_(True)
        wt.requires_grad_(True)
        with torch.no_grad():
            y = tnorms.rms_norm(xt, wt, EPS)
    else:
        y = tnorms.rms_norm(xt, wt, EPS)
    assert y.grad_fn is None and not y.requires_grad
    assert y.equal(tnorms._rms_ref(xt.detach(), wt.detach(), EPS))


def test_rms_norm_bf16_grads_within_rounding_of_fp32():
    """bf16 inputs: the forward and both gradients are the fp32 values of
    the same (bf16-valued) inputs rounded once, so within half a bf16 ulp
    (2^-8 relative) of them."""
    x, w, dy = _inputs(64, 100, seed=5)
    xb, wb, dyb = (torch.from_numpy(a).bfloat16() for a in (x, w, dy))
    xt = xb.clone().requires_grad_(True)
    wt = wb.clone().requires_grad_(True)
    y = tnorms._RMSNorm.apply(xt, wt, EPS)
    y.backward(dyb)
    assert y.dtype == xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    y32 = tnorms._rms_ref(xb.float(), wb.float(), EPS)
    dx32, dw32 = tnorms._rms_bwd_ref(xb.float(), wb.float(), dyb.float(),
                                     EPS)
    for got, want in ((y, y32), (xt.grad, dx32), (wt.grad, dw32)):
        torch.testing.assert_close(got.detach().float(), want,
                                   rtol=2.0 ** -8, atol=1e-6)
