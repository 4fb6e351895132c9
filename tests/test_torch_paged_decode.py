"""Paged decode attention (``ray_tpu_torch.ops.attention``): kernel K5
(``csrc/paged_decode.cu``) and its plain version.

On the CPU: the plain version against a position-by-position float64
attention over the page tables (ragged lengths with 0, idle slots on the
scratch page, lengths at and one past a page edge, the full table, pages
out of order, scratch entries past the prefix, pages shared by two
slots), the wrapper taking it for CPU tensors without a launch, and the
checks that refuse what K5 does not take.  On the card (marked ``card``,
skipped without CUDA; this file imports no JAX, so it runs there with
``python -m pytest tests/test_torch_paged_decode.py --noconftest -m card``):
K5 against the plain version in the working dtype at Mistral-7B's serving
shapes and the tiny model's, its refusals, and one launch a layer a
decode step.

Tolerances (elementwise |K5 - plain| <= atol + rtol |plain|, and the
norm of the difference within rtol of the plain output's): fp32 cases
atol 2e-5, rtol 1e-5: both sides sum in fp32, in another order, over at
most 4,160 positions.  bf16 cases atol 1e-2, rtol 1e-2: the plain version
rounds the probabilities to bf16 before P.V (2^-9 each, relative) and its
product to bf16, K5 carries them as bf16 hi + lo (about 16 bits), sums in
fp32 and rounds the output once, so the two may differ by one bf16 ulp of
the output (2^-8 of it) and a few 2^-9 of the probabilities.  Attending a wrong page or row moves the norm
by its whole size (the queries are scaled up so each softmax is
peaked).
"""

import math

import pytest
import torch

from ray_tpu_torch.models import paged
from ray_tpu_torch.models.llama import LlamaConfig, llama_init
from ray_tpu_torch.ops import attention as att

IDLE = None  # an idle slot: length 0, every entry the scratch page
#: (atol, rtol) of K5 against the plain version (the docstring's reasons).
FP32, BF16 = (2e-5, 1e-5), (1e-2, 1e-2)


def _case(B, maxp, ps, H, hkv, D, lens, dtype=torch.float32, device="cpu",
          seed=0, shared=(), extra_pages=0):
    """(q, k_pages, v_pages, page_tables, seq_lens) with each slot's pages
    drawn out of order from a shuffled pool, scratch past its prefix.
    ``lens[b]`` is the slot's seq_len (it attends 0..seq_len) or IDLE;
    ``shared`` holds (a, b, n): slot b's first n pages are slot a's."""
    g = torch.Generator().manual_seed(seed)
    need = [0 if n is IDLE else -(-(n + 1) // ps) for n in lens]
    n_pages = sum(need) + extra_pages
    scratch = n_pages
    order = torch.randperm(n_pages, generator=g).tolist()
    tables = torch.full((B, maxp), scratch, dtype=torch.int32)
    for b, n in enumerate(need):
        tables[b, :n] = torch.tensor(order[:n], dtype=torch.int32)
        order = order[n:]
    for a, b, n in shared:
        tables[b, :n] = tables[a, :n]
    seq_lens = torch.tensor([0 if n is IDLE else n for n in lens],
                            dtype=torch.int32)
    # Queries scaled up: peaked softmaxes, so a wrong row shows.
    q = torch.randn((B, H, D), generator=g) * 3.0
    k = torch.randn((n_pages + 1, hkv, ps, D), generator=g)
    v = torch.randn((n_pages + 1, hkv, ps, D), generator=g)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            tables.to(device), seq_lens.to(device))


def _attend_f64(q, k_pages, v_pages, page_tables, seq_lens, scale):
    """Position by position through the table, in float64."""
    B, H, D = q.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    n_rep = H // hkv
    out = torch.empty((B, H, D), dtype=torch.float64)
    for b in range(B):
        pos = torch.arange(int(seq_lens[b]) + 1)
        pages = page_tables[b].long()[pos // ps]
        for h in range(H):
            kk = k_pages[pages, h // n_rep, pos % ps].double()
            vv = v_pages[pages, h // n_rep, pos % ps].double()
            p = torch.softmax(kk @ q[b, h].double() * scale, dim=0)
            out[b, h] = p @ vv
    return out


#: (B, MAXP, page, H, Hkv, D, seq_lens, shared): every edge the card
#: cases hold K5 to, at CPU sizes.
CPU_CASES = {
    "ragged": (6, 6, 8, 4, 2, 32, [0, 7, 8, 15, 47, IDLE], ()),
    "pages_1": (3, 40, 1, 4, 4, 32, [0, 1, 39], ()),
    "pages_64_full": (2, 3, 64, 8, 1, 64, [191, 64], ()),
    "shared_pages": (4, 5, 4, 8, 2, 32, [17, 19, IDLE, 5], ((0, 1, 4),)),
    "group_8": (2, 4, 16, 8, 1, 128, [33, 63], ()),
}


@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_plain_version_attends_live_positions_through_the_table(name):
    B, maxp, ps, H, hkv, D, lens, shared = CPU_CASES[name]
    args = _case(B, maxp, ps, H, hkv, D, lens, shared=shared,
                 extra_pages=3)
    scale = D ** -0.5
    got = att.paged_decode_attention_ref(*args, scale=scale)
    want = _attend_f64(*args, scale)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    torch.testing.assert_close(got.double(), want, atol=2e-5, rtol=1e-5)


def test_idle_slot_reads_the_scratch_row():
    """An idle slot (length 0, all-scratch table) attends the scratch
    page's first row alone: a finite output, that row's V."""
    q, k, v, tables, lens = _case(2, 4, 8, 4, 2, 32, [IDLE, 9])
    out = att.paged_decode_attention_ref(q, k, v, tables, lens)
    scratch = k.shape[0] - 1
    assert bool((tables[0] == scratch).all())
    torch.testing.assert_close(out[0], v[scratch, :, 0].repeat_interleave(
        2, dim=0))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    args = _case(3, 6, 8, 4, 2, 32, [5, 20, IDLE])
    before = att.paged_decode_attention.launches
    got = att.paged_decode_attention(*args, scale=0.25)
    want = att.paged_decode_attention_ref(*args, scale=0.25)
    assert torch.equal(got, want)
    assert att.paged_decode_attention.launches == before


def test_cpu_decode_step_launches_nothing():
    """The decode step on the CPU goes through the plain version: no K5
    launch (the engine-against-JAX tests hold its tokens)."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
    pools = paged.init_paged_pools(cfg, 16, 8, device="cpu")
    adapters = paged.init_adapter_pool(cfg, 1, 4, device="cpu")
    tables = torch.full((3, 4), 16, dtype=torch.int32)
    tables[0, :2] = torch.tensor([3, 9])
    tables[1, :1] = torch.tensor([5])
    lens = torch.tensor([11, 2, 0], dtype=torch.int32)
    key = torch.Generator().manual_seed(1)
    before = att.paged_decode_attention.launches
    toks, new_lens, _, _ = paged.paged_decode_step(
        cfg, params, pools, adapters, torch.tensor([4, 8, 0]), tables, lens,
        torch.tensor([True, True, False]), torch.zeros(3),
        torch.full((3,), 1), key)
    assert att.paged_decode_attention.launches == before
    assert new_lens.tolist() == [12, 3, 0] and toks.shape == (3,)


@pytest.mark.parametrize("what", ["head_dim_96", "group_3", "page_12",
                                  "page_128", "float16", "lens_shape",
                                  "float_tables", "pages_mismatch",
                                  "strided_rows", "layouts_differ"])
def test_checks_refuse_what_k5_does_not_take(what):
    shapes = dict(B=2, maxp=4, ps=8, H=4, hkv=2, D=32)
    dtype = torch.float32
    if what == "head_dim_96":
        shapes["D"] = 96
    elif what == "group_3":
        shapes.update(H=6, hkv=2)
    elif what == "page_12":
        shapes["ps"] = 12
    elif what == "page_128":
        shapes["ps"] = 128
    elif what == "float16":
        dtype = torch.float16
    att._check_paged(*_case(lens=[3, 9], B=2, maxp=4, ps=8, H=4, hkv=2,
                            D=32))  # the sound case passes
    q, k, v, tables, lens = _case(lens=[3, 9], dtype=dtype, **shapes)
    if what == "lens_shape":
        lens = lens[:1]
    elif what == "float_tables":
        tables = tables.float()
    elif what == "pages_mismatch":
        v = v[:, :1]
    elif what == "strided_rows":
        k = torch.randn(k.shape[:-1] + (k.shape[-1] * 2,))[..., ::2]
    elif what == "layouts_differ":
        v = v.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((ValueError, TypeError)):
        att._check_paged(q, k, v, tables, lens)


# ------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("K5 is a CUDA kernel: needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _check_card(args, atol, rtol):
    q, k, v, tables, lens = args
    scale = q.shape[-1] ** -0.5
    n0 = att.paged_decode_attention.launches
    got = att.paged_decode_attention(q, k, v, tables, lens, scale=scale)
    torch.cuda.synchronize()
    assert att.paged_decode_attention.launches == n0 + 1
    # The splits' counts are left zero for the next launch.
    assert not any(plan.counts.any() for plan in att._plans.values())
    want = att.paged_decode_attention_ref(q, k, v, tables, lens, scale=scale)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    norm = ((got.float() - want.float()).norm()
            / want.float().norm()).item()
    assert norm <= rtol, norm


def _mistral_lens(B, n_ctx, busy, seed):
    """Busy slots' lengths drawn like a cell's occupancy, then the edges:
    0, a page's last row and the next page's first, a split's edge (256),
    the full table; the rest idle."""
    g = torch.Generator().manual_seed(seed)
    edges = [0, 15, 16, 255, 256, n_ctx - 1]
    draw = torch.randint(1, n_ctx - 1, (busy - len(edges),), generator=g)
    return edges + draw.tolist() + [IDLE] * (B - busy)


@pytest.mark.card
@pytest.mark.parametrize("shape", ["chat", "docs"])
def test_k5_at_mistral_serving_shapes(card, shape):
    B, maxp, busy = {"chat": (64, 96, 50), "docs": (16, 260, 15)}[shape]
    lens = _mistral_lens(B, maxp * 16, busy, seed=7)
    args = _case(B, maxp, 16, 32, 8, 128, lens, torch.bfloat16, card,
                 shared=((1, 8, 1), (6, 7, 3)), extra_pages=64)
    _check_card(args, *BF16)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_k5_at_head_dim_32(card, dtype, group):
    hkv = 2
    lens = [0, 7, 8, 9, 100, 255, 256, 511, IDLE, 300]
    args = _case(10, 32, 16, group * hkv, hkv, 32, lens, dtype, card,
                 shared=((4, 9, 5),), extra_pages=5)
    _check_card(args, *(FP32 if dtype == torch.float32 else BF16))


@pytest.mark.card
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("ps", [1, 8, 64])
def test_k5_head_dims_and_pages(card, D, ps):
    maxp = 1024 // ps
    lens = [0, ps - 1, ps, 1023, 300, IDLE]
    for dtype, tol in ((torch.float32, FP32), (torch.bfloat16, BF16)):
        args = _case(6, maxp, ps, 8, 2, D, lens, dtype, card,
                     shared=((1, 2, 1),), extra_pages=2)
        _check_card(args, *tol)


@pytest.mark.card
@pytest.mark.parametrize("what", ["head_dim_96", "group_3", "page_128",
                                  "float16"])
def test_k5_refuses_on_the_card(card, what):
    shapes = dict(B=2, maxp=4, ps=8, H=4, hkv=2, D=32)
    dtype = torch.float32
    if what == "head_dim_96":
        shapes["D"] = 96
    elif what == "group_3":
        shapes.update(H=6, hkv=2)
    elif what == "page_128":
        shapes["ps"] = 128
    else:
        dtype = torch.float16
    args = _case(lens=[3, 9], dtype=dtype, device=card, **shapes)
    n0 = att.paged_decode_attention.launches
    with pytest.raises((ValueError, TypeError)):
        att.paged_decode_attention(*args)
    assert att.paged_decode_attention.launches == n0


@pytest.mark.card
def test_decode_step_launches_k5_once_a_layer(card):
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    params = llama_init(cfg, torch.Generator(device=card).manual_seed(0))
    pools = paged.init_paged_pools(cfg, 16, 8, device=card)
    adapters = paged.init_adapter_pool(cfg, 1, 4, device=card)
    tables = torch.full((3, 4), 16, dtype=torch.int32)
    tables[0, :2] = torch.tensor([3, 9])
    tables[1, :1] = torch.tensor([5])
    lens = torch.tensor([11, 2, 0], dtype=torch.int32, device=card)
    args = [tables.to(card), lens, torch.tensor([True, True, False],
                                                device=card),
            torch.zeros(3, device=card), torch.full((3,), 1, device=card)]
    key = torch.Generator(device=card).manual_seed(1)
    toks = torch.tensor([4, 8, 0], device=card)
    for step in range(3):
        n0 = att.paged_decode_attention.launches
        toks, args[1], key, pools = paged.paged_decode_step(
            cfg, params, pools, adapters, toks, args[0], args[1], *args[2:],
            key)
        torch.cuda.synchronize()
        assert att.paged_decode_attention.launches - n0 == cfg.n_layers
    assert args[1].tolist() == [14, 5, 0]
    assert math.isfinite(float(toks.float().sum()))
