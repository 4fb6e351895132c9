"""Ring attention: causal attention over a sequence split on the ``sp``
mesh axis (context parallelism), port of ``ray_tpu/ops/ring_attention.py``.

Each rank holds a contiguous chunk of Q, K and V (S_local rows, rank r's
at global offset r * S_local); K/V chunks rotate around the ring while
each rank merges its Q rows' attention over every chunk, so no rank holds
more than two chunks and the S x S scores never exist.

``_RingFlash`` is the twin of the JAX ``_ring_flash`` custom VJP, on the
port's kernels.  Forward: at ring step s a rank holds chunk src = (rank -
s) mod n and runs K1 at ``q_offset = (rank - src) * S_local`` (0 on the
diagonal, causal; a positive multiple of S_local for a past chunk, all
keys visible; a negative one for a future chunk); the (out, lse) pairs
merge online in fp32; K and V go to the next rank.  Backward: ``delta =
rowsum(dO * O)`` of the merged output, then K2 and K3 on every chunk fed
the merged (global) lse and delta, so each chunk's share is exact; dQ sums
locally, and the dK/dV accumulators travel with their chunk and take one
last hop home.

A future chunk (``q_offset <= -S_local``) visits no tile where K1 has two
key tiles or more (S_local > 64): its rows come back with out 0 and lse
NEG_INF + log(1e-30), which rounds to NEG_INF in fp32, and the merge
gives them weight exp(NEG_INF - m) = 0.  So at S_local > 64 the ring
never meets rows that see no key inside a visited tile, where the
reference's flash backward is not the gradient of its forward
(ROADMAP.md, Queue 3).  With one key tile (S_local <= 64) the kernel
visits it and every row of a future chunk sees no key there: its lse is
NEG_INF + log(S_local), again NEG_INF in fp32, so its merge weight is 0
all the same, and the backward, fed the global lse, which every row has
finite (its own diagonal chunk), gets p = 0 on those pairs.

The JAX package keeps a blockwise jnp path for shapes its Pallas kernels
refuse; the port's K1-K3 take any S and any ``q_offset``, so one path
serves every shape.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..collective import mesh_ops
from ..parallel.mesh import current_mesh
from .attention import (NEG_INF, flash_attention, flash_attention_bwd_dkv,
                        flash_attention_bwd_dq, flash_attention_bwd_ref,
                        flash_attention_fwd)


def _ring_fwd(q, k, v, scale, axis, mesh):
    n = mesh_ops.axis_size(axis, mesh=mesh)
    rank = mesh_ops.axis_index(axis, mesh=mesh)
    B, H, S, D = q.shape
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, H, S), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for s in range(n):
        src = (rank - s) % n
        out_c, lse_c = flash_attention_fwd(q, kv[0], kv[1], causal=True,
                                           sm_scale=scale,
                                           q_offset=(rank - src) * S)
        m_new = torch.maximum(m_run, lse_c)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(lse_c - m_new)
        acc = acc * alpha[..., None] + out_c.float() * beta[..., None]
        l_run = l_run * alpha + beta
        m_run = m_new
        if s < n - 1:
            kv = mesh_ops.shift(kv, axis, 1, mesh=mesh)
    l_run = l_run.clamp_min(1e-30)
    out = (acc / l_run[..., None]).to(q.dtype)
    return out, m_run + torch.log(l_run)


def _ring_bwd(q, k, v, out, lse, do, scale, axis, mesh):
    n = mesh_ops.axis_size(axis, mesh=mesh)
    rank = mesh_ops.axis_index(axis, mesh=mesh)
    S = q.shape[2]
    delta = (do.float() * out.float()).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2, *k.shape), dtype=torch.float32, device=k.device)
    kv = torch.stack([k, v])
    for s in range(n):
        src = (rank - s) % n
        kw = dict(causal=True, sm_scale=scale, q_offset=(rank - src) * S)
        if q.is_cuda:
            dq_c = flash_attention_bwd_dq(q, kv[0], kv[1], lse, delta, do,
                                          **kw)
            dk_c, dv_c = flash_attention_bwd_dkv(q, kv[0], kv[1], lse,
                                                 delta, do, **kw)
        else:  # the plain version, computed once for all three
            dq_c, dk_c, dv_c = flash_attention_bwd_ref(q, kv[0], kv[1], lse,
                                                       delta, do, **kw)
        dq += dq_c.float()
        dkv[0] += dk_c.float()
        dkv[1] += dv_c.float()
        # The accumulators travel with their K/V chunk; after n hops each
        # chunk's gradient is home.  K/V are not read after the last step.
        if s < n - 1:
            kv = mesh_ops.shift(kv, axis, 1, mesh=mesh)
        dkv = mesh_ops.shift(dkv, axis, 1, mesh=mesh)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The ring's forward and backward as one autograd node: every rank
    runs the same sends and receives in the same order.  Runs without
    autograd inside, so K1 launches through ``flash_attention_fwd``'s
    plain branch."""

    @staticmethod
    def forward(ctx, q, k, v, scale, axis, mesh):
        out, lse = _ring_fwd(q, k, v, scale, axis, mesh)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, axis, mesh)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do.contiguous(),
                               *ctx.args)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None,
                   mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """[B, H, S_local, D] in (k, v with Hkv heads), same out, on the local
    chunk of a sequence split over ``axis_name`` of the ambient mesh (or
    ``mesh``).  With the axis unbound or of size 1: ``flash_attention``.
    Non-causal: K/V all-gathered (as bandwidth-cheap as the ring) and one
    K1.  Causal: the ring."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    mesh = mesh if mesh is not None else current_mesh()
    try:
        n = mesh_ops.axis_size(axis_name, mesh=mesh)
    except NameError:
        n = 1
    if n == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=scale)
    if not causal:
        kg = mesh_ops.allgather(k, axis_name, gather_axis=2, mesh=mesh)
        vg = mesh_ops.allgather(v, axis_name, gather_axis=2, mesh=mesh)
        return flash_attention(q, kg, vg, causal=False, sm_scale=scale)
    return _RingFlash.apply(q, k, v, scale, axis_name, mesh)
