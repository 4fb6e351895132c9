#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, from the repo root

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. card: ``nvidia-smi`` name and power limit.
2. build: compile every kernel under ``ray_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together); print ptxas's
   registers and spills, and fail if the bf16 K2 or K3 kernels spill.
3. K4 (``csrc/rms_norm.cu``) against its plain version, timed beside the
   plain version and ``F.rms_norm``.
4. K1 (``csrc/flash_fwd.cu``) against ``flash_attention_ref`` (out and
   lse) over Llama-3-8B shapes, GQA groups, head dims, offsets, ragged
   lengths, the bf16 kernel's block edges, transposed [B, S, H, D] views
   and both dtypes (head_dim 32 in both), lse bit-equal on rows that see
   no key; timed beside the plain version and SDPA.
5. K2 and K3 (``csrc/flash_bwd.cu``) against ``flash_attention_bwd_ref``
   (dQ, dK, dV) over K1's first cases and 32/8 heads (head_dim 32 in both
   dtypes), Sq > Sk, and fed by K1's own (out, lse) at negative offsets;
   timed at the training shape (S = 512 and 2048) beside the plain
   version and SDPA's backward, with the SM clock sampled before and
   after each timed loop.
6. tiny serve: the tiny model (head_dim 32, ``llm_app``'s default model)
   served on the card by ``InferenceEngine``, in fp32 (its greedy tokens
   must equal the same engine's on the CPU from the same parameters) and
   in bf16, its default dtype (its prefill logits held against the fp32
   forward of the same parameters on the CPU).
7. forward: ``llama_apply`` on full Llama-3-8B (32 layers, random weights
   from a seed) at B=1, S=2048, then a 2-layer full-width model against the
   same weights in fp32 on the CPU through the plain path.
8. serve: ``InferenceEngine`` on full Llama-3-8B answers 12 requests (8 at
   once, 4 admitted while those decode); checks counts, page balance and
   greedy agreement with ``generate``; then a warm 8-request window under
   the profiler: wall, prefill and device busy time of that one window.
9. train: the serving model is freed; ``make_train_step(llama_loss)``
   with ``default_optimizer(lr=1e-4)`` on full Llama-3-8B (random weights
   from a seed, remat full) at B=1, S=2048: 2 warm and 5 timed AdamW
   steps (step time, tokens/s, MFU under bench.py's convention, peak
   memory; loss and grad norm finite, the loss falling), then one step
   under the profiler (idle share, time by kernel kind); then a 2-layer
   full-width model's loss and every gradient in bf16 against the same
   weights in fp32 on the CPU through the plain path (B=1, S=256).

Kernel launch counters are zeroed just before the tiny serve, the
forward, the serve and the train paths run and read just after: K1 and K4
must have launched on the tiny serve, forward and serve paths, and the train path must launch K1 twice per
layer and step (forward and remat recompute), K2 and K3 once and K4 never.
The second-to-last JSON line lists every kernel with its launches per
path, error, times and bound; the last line is the device record.
``--report PATH`` also writes every phase's numbers to PATH as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np

# Published H100 SXM peaks (dense), the bound's denominators.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after ``warmup`` calls; inputs stay L2-warm).  Where the
    host issues calls slower than the device runs them this is the host's
    rate; ``device_ms`` gives the kernels' own time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_window(torch, fn, iters: int = 10):
    """Run ``fn`` ``iters`` times under torch.profiler and return, for that
    one window, ({CUDA kernel name: device ms per call}, wall ms per call).
    The wall time is the host clock from the first call to the end of the
    last kernel, inside the profiled window, so busy / wall is the device's
    busy share of the same window.  Only device activity is traced (no host
    op records), which keeps the profiler's own host time small.  A window
    in which the profiler saw no device activity is profiled once more
    (CUPTI dropped a whole window's records once on the H100 machine);
    raises if the second one saw none either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / iters)
        if by_name:
            return by_name, wall_ms
        print("[profile] torch.profiler saw no device activity; profiling "
              "the window once more", flush=True)
    raise PhaseError("torch.profiler saw no device activity")


def device_ms(torch, fn, iters: int = 10) -> float:
    """Summed per-call device time (ms) of ``fn``'s kernels, after one warm
    call."""
    fn()
    return sum(profile_window(torch, fn, iters)[0].values())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clocks_line() -> str:
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def within(torch, got, ref, atol: float, rtol: float):
    """(max_abs_err, ok) for |got - ref| <= atol + rtol * |ref|."""
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), "kernel output is not finite")
    diff = (g - r).abs()
    return float(diff.max()), bool((diff <= atol + rtol * r.abs()).all())


# ------------------------------------------------------------------ phases


def ptxas_report(log: str):
    """[(kernel, registers, spilled bytes stored + loaded)] for each entry
    function in nvcc's ``-Xptxas -v`` output; a kernel template
    ``name<T, N>`` reads as ``name<bf16|f32, N>``."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"([a-z][a-z_]*_kernel)I(13__nv_bfloat16|f)Li(\d+)E",
                          m.group(1))
            name = (f"{t[1]}<{'f32' if t[2] == 'f' else 'bf16'}, {t[3]}>"
                    if t else m.group(1))
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m[1]), spill))
            name = None
    return out


def phase_build(report):
    from ray_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {}
    for name, log in _build.build_logs.items():
        kernels = ptxas_report(log)
        report["ptxas"][name] = kernels
        print(f"[build] {name}.cu ptxas: " + "; ".join(
            f"{k} {regs} registers, {spill} B spilled"
            for k, regs, spill in kernels))
    print(f"[build] kernels built in {report['build_s']:.1f} s")
    # The wgmma kernels of K2 and K3 (bf16, head_dim 64 and 128).
    spills = [(k, spill) for k, _, spill in report["ptxas"]["flash_bwd"]
              if k.startswith(("flash_bwd_dq_kernel<bf16",
                               "flash_bwd_dkv_kernel<bf16"))]
    check(len(spills) == 4 and not any(sp for _, sp in spills),
          f"the bf16 K2/K3 kernels spill (or were not found): {spills}")


def phase_rms(torch, report):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import norms

    eps = 1e-5
    g = torch.Generator(device="cuda").manual_seed(11)
    tol = {torch.bfloat16: (1e-6, 2.0 ** -7), torch.float32: (1e-6, 1e-5)}
    cases = [(512, 4096, torch.bfloat16), (8, 4096, torch.bfloat16),
             (1000, 4096, torch.bfloat16), (512, 4096, torch.float32),
             (37, 4100, torch.bfloat16)]
    rows_out = []
    main = None
    for rows, d, dt in cases:
        x = torch.randn(rows, d, generator=g, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
        out = norms.rms_norm_cuda(x, w, eps)
        ref = norms._rms_ref(x, w, eps)
        atol, rtol = tol[dt]
        err, ok = within(torch, out, ref, atol, rtol)
        check(ok, f"K4 [{rows}, {d}] {dt}: max err {err} beyond atol "
                  f"{atol} + rtol {rtol}")
        rec = {"shape": [rows, d], "dtype": str(dt), "max_abs_err": err,
               "atol": atol, "rtol": rtol}
        if dt == torch.bfloat16 and d == 4096:
            nbytes = 2 * rows * d * x.element_size() + d * w.element_size()
            flops = 4 * rows * d
            kern = lambda: norms.rms_norm_cuda(x, w, eps)  # noqa: E731
            plain = lambda: norms._rms_ref(x, w, eps)  # noqa: E731
            lib = lambda: F.rms_norm(x, (d,), w, eps)  # noqa: E731
            rec.update(
                call_ms=time_ms(torch, kern),
                plain_call_ms=time_ms(torch, plain),
                library_call_ms=time_ms(torch, lib),
                ms=device_ms(torch, kern),
                plain_ms=device_ms(torch, plain),
                library_ms=device_ms(torch, lib),
                bound_ms=max(nbytes / PEAK_HBM_BYTES,
                             flops / PEAK_FP32_FLOPS) * 1e3,
                bound_by=("bytes" if nbytes / PEAK_HBM_BYTES
                          >= flops / PEAK_FP32_FLOPS else "operations"))
            if rows == 512:
                main = rec
        rows_out.append(rec)
        print("[K4] " + json.dumps(rec))
    report["rms_norm"] = {"cases": rows_out, "main": main}


def _attn_inputs(torch, g, B, H, Hkv, Sq, Sk, D, dt):
    q = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dt)
    k = torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dt)
    v = torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dt)
    return q, k, v


def _flash_cases(torch):
    """K1's case grid: the main-path shapes; the first port's grid (both
    dtypes, GQA groups, head dims, offsets, ragged lengths); head_dim 32
    in both dtypes; the bf16 wgmma kernel's block edges (128-row blocks
    made of two 64-row visiting tiles, 64-key tiles); and q/k/v as
    transposed [B, S, H, D] views, as the model passes them."""
    cases = [dict(B=1, H=32, Hkv=8, Sq=s, Sk=s, D=128, causal=True, off=0,
                  dt=torch.bfloat16) for s in (512, 2048)]
    for dt in (torch.bfloat16, torch.float32):
        for H, Hkv in ((4, 4), (8, 2)):
            for D in (64, 128):
                for Sq, Sk in ((1000, 1000), (256, 1000), (64, 512)):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                                      causal=False, off=0, dt=dt))
                    for off in (-64, 0, 256, Sk + 64):
                        cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk,
                                          D=D, causal=True, off=off, dt=dt))
    # head_dim 32 (the tiny model's), both dtypes.
    for dt in (torch.float32, torch.bfloat16):
        for H, Hkv in ((4, 4), (8, 2)):
            for Sq, Sk in ((1000, 1000), (256, 1000), (64, 512)):
                cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=32,
                                  causal=False, off=0, dt=dt))
                for off in (-64, 0, 256, Sk + 64):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=32,
                                      causal=True, off=off, dt=dt))
    for H, Hkv in ((4, 4), (8, 2), (32, 8)):
        for D in (64, 128):
            for Sq in (1, 65, 127, 129, 200):
                for Sk in (1, 64, 65, 129, 300):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                                      causal=False, off=0,
                                      dt=torch.bfloat16))
                    for off in (-65, -64, -63, 0, 1, Sk + 64):
                        cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk,
                                          D=D, causal=True, off=off,
                                          dt=torch.bfloat16))
    for D in (64, 128):
        for S, off in ((200, 0), (1000, 0), (1000, -63)):
            cases.append(dict(B=2, H=32, Hkv=8, Sq=S, Sk=S, D=D, causal=True,
                              off=off, dt=torch.bfloat16, bshd=True))
    return cases


def _case_inputs(torch, g, c):
    if not c.get("bshd"):
        return _attn_inputs(torch, g, c["B"], c["H"], c["Hkv"], c["Sq"],
                            c["Sk"], c["D"], c["dt"])
    q, k, v = _attn_inputs(torch, g, c["B"], c["Sq"], c["Sk"], c["H"],
                           c["Hkv"], c["D"], c["dt"])
    # [B, S, H, D] storage viewed as [B, H, S, D]: seq stride H * D.
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def phase_flash(torch, report):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    g = torch.Generator(device="cuda").manual_seed(12)
    # Per element, |out - ref| <= a * spread + atol + rtol * |ref|, where
    # spread = sum_j p_j |v_j| / l (the same attention over |v|, fp32).
    # bf16: the kernel rounds p to bf16 (unit roundoff U = 2^-8) before the
    # p.v product, which moves an output element by at most U * spread, and
    # both sides round the output to bf16 (at most 2U |ref| apart).  fp32:
    # exact products, sums in another order than the reference.  "fro"
    # bounds ||out - ref|| / ||ref|| over the whole output; "lse" is
    # (atol, rtol).  On rows whose largest score is NEG_INF (every visited
    # key masked) or that visit no key tile, lse must equal the plain
    # version's bit for bit: K2/K3 take p = exp(s - lse) there, and one ulp
    # at -1e30 (7.6e22) overflows p.
    U = 2.0 ** -8
    tol = {torch.bfloat16: {"out": (U, 1e-5, 2 * U), "fro": 2 * U,
                            "lse": (1e-3, 1e-5)},
           torch.float32: {"out": (0.0, 1e-4, 1e-4), "fro": 1e-5,
                           "lse": (1e-4, 1e-5)}}
    cases = _flash_cases(torch)
    worst = {}
    masked_rows = 0
    for c in cases:
        q, k, v = _case_inputs(torch, g, c)
        out, lse = att.flash_attention_fwd(q, k, v, causal=c["causal"],
                                           q_offset=c["off"])
        ref_out, ref_lse = att.flash_attention_ref(
            q, k, v, causal=c["causal"], q_offset=c["off"])
        t = tol[c["dt"]]
        a, atol, rtol = t["out"]
        if a:
            spread = att.flash_attention_ref(
                q.float(), k.float(), v.float().abs(), causal=c["causal"],
                q_offset=c["off"])[0]
            atol = a * spread + atol
        e_out, ok_out = within(torch, out, ref_out, atol, rtol)
        e_lse, ok_lse = within(torch, lse, ref_lse, *t["lse"])
        trap = ref_lse <= att.NEG_INF / 2
        masked_rows += int(trap.sum())
        lse_bits = bool(torch.equal(lse[trap], ref_lse[trap]))
        d_norm = float((out.float() - ref_out.float()).norm())
        r_norm = float(ref_out.float().norm())
        fro = d_norm / r_norm if r_norm > 0 else d_norm
        tag = (f"B{c['B']} H{c['H']}/{c['Hkv']} Sq{c['Sq']} Sk{c['Sk']} "
               f"D{c['D']} causal={c['causal']} off={c['off']} {c['dt']}"
               + (" [B,S,H,D] view" if c.get("bshd") else ""))
        check(ok_out and ok_lse and fro <= t["fro"] and lse_bits,
              f"K1 {tag}: out err {e_out} (tol {t['out']}), relative "
              f"norm err {fro} (tol {t['fro']}), lse err {e_lse} (tol "
              f"{t['lse']}), lse bit-equal on NEG_INF rows {lse_bits}")
        w = worst.setdefault(str(c["dt"]), {"out": 0.0, "fro": 0.0})
        w["out"], w["fro"] = max(w["out"], e_out), max(w["fro"], fro)
    check(masked_rows > 0, "no case had a row that sees no key")
    tol_s = json.dumps({str(k): v for k, v in tol.items()})
    print(f"[K1] {len(cases)} cases within tolerance; worst out err and "
          f"relative norm err by dtype {json.dumps(worst)}; lse bit-equal "
          f"to the plain version's on all {masked_rows} rows whose "
          f"largest score is NEG_INF or that visit no tile; tolerances "
          f"{tol_s}")

    timed = []
    for S in (512, 2048):
        B, H, Hkv, D = 1, 32, 8, 128
        q, k, v = _attn_inputs(torch, g, B, H, Hkv, S, S, D, torch.bfloat16)
        out, lse = att.flash_attention_fwd(q, k, v, causal=True)
        ref_out, ref_lse = att.flash_attention_ref(q, k, v, causal=True)
        err = float((out.float() - ref_out.float()).abs().max())
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
        lib = lib_fn()
        kern = lambda: att.flash_attention_fwd(  # noqa: E731
            q, k, v, causal=True)
        plain = lambda: att.flash_attention_ref(  # noqa: E731
            q, k, v, causal=True)
        pairs = S * (S + 1) // 2  # causal (q, k) pairs per head
        flops = 4 * B * H * D * pairs
        nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * 2 + B * H * S * 4
        rec = {
            "shape": dict(B=B, H=H, Hkv=Hkv, S=S, D=D, causal=True,
                          dtype="bfloat16"),
            "max_abs_err": err,
            "sdpa_max_abs_diff": float((lib.float() - ref_out.float())
                                       .abs().max()),
            "call_ms": time_ms(torch, kern),
            "plain_call_ms": time_ms(torch, plain, iters=5),
            "library_call_ms": time_ms(torch, lib_fn),
            "ms": device_ms(torch, kern),
            "plain_ms": device_ms(torch, plain, iters=3),
            "library_ms": device_ms(torch, lib_fn),
            "bound_ms": max(flops / PEAK_BF16_FLOPS,
                            nbytes / PEAK_HBM_BYTES) * 1e3,
            "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                         >= nbytes / PEAK_HBM_BYTES else "bytes"),
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        timed.append(rec)
        print("[K1] " + json.dumps(rec))
    report["flash_fwd"] = {"cases": len(cases), "worst_out_err": worst,
                           "neg_inf_rows_bit_equal": masked_rows,
                           "timed": timed, "main": timed[-1]}


def _bwd_case(torch, att, g, c):
    """Inputs of one backward case: q, k, v, dO in the case's dtype, the
    plain forward's lse and delta = rowsum(dO * O)."""
    q, k, v = _attn_inputs(torch, g, c["B"], c["H"], c["Hkv"], c["Sq"],
                           c["Sk"], c["D"], c["dt"])
    do = torch.randn(q.shape, generator=g, device="cuda").to(c["dt"])
    out, lse = att.flash_attention_ref(q, k, v, causal=c["causal"],
                                       q_offset=c["off"])
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta


def _check_bwd(torch, att, c, tol, worst, q, k, v, do, lse, delta):
    """K2 and K3 on one case against ``flash_attention_bwd_ref`` on the
    same inputs; raises beyond the tolerance, updates ``worst``."""
    kw = dict(causal=c["causal"], q_offset=c["off"])
    dq = att.flash_attention_bwd_dq(q, k, v, lse, delta, do, **kw)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, lse, delta, do, **kw)
    refs = att.flash_attention_bwd_ref(q, k, v, lse, delta, do, **kw)
    t = tol[c["dt"]]
    a, atol, rtol = t["elem"]
    if a:
        p, ds = att._bwd_probs(q, k, v, lse, delta, do, sm_scale=None,
                               **kw)
        ads, Hkv = ds.abs(), c["Hkv"]
        spreads = (
            torch.einsum("bhqk,bhkd->bhqd", ads,
                         att._repeat_kv(k, c["H"]).float().abs()),
            att._sum_groups(torch.einsum(
                "bhqk,bhqd->bhkd", ads, q.float().abs()), Hkv),
            att._sum_groups(torch.einsum(
                "bhqk,bhqd->bhkd", p, do.float().abs()), Hkv))
        del p, ds, ads
    else:
        spreads = (0.0, 0.0, 0.0)
    tag = (f"B{c['B']} H{c['H']}/{c['Hkv']} Sq{c['Sq']} Sk{c['Sk']} "
           f"D{c['D']} causal={c['causal']} off={c['off']} {c['dt']}"
           + (" fed by K1" if c.get("fed_by_k1") else ""))
    w = worst.setdefault(str(c["dt"]), {})
    for name, got, ref, spread in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      refs, spreads):
        err, ok = within(torch, got, ref, a * spread + atol, rtol)
        d_norm = float((got.float() - ref.float()).norm())
        r_norm = float(ref.float().norm())
        fro = d_norm / r_norm if r_norm > 0 else d_norm
        check(ok and fro <= t["fro"],
              f"K2/K3 {name} {tag}: max err {err} (tol {t['elem']}), "
              f"relative norm err {fro} (tol {t['fro']})")
        e = w.setdefault(name, {"err": 0.0, "fro": 0.0})
        e["err"], e["fro"] = max(e["err"], err), max(e["fro"], fro)


def phase_flash_bwd(torch, report):
    """K2 and K3 against ``flash_attention_bwd_ref`` over K1's case grid
    (and 32/8 heads), then timed at the training shape."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    g = torch.Generator(device="cuda").manual_seed(14)
    # Per element, |got - ref| <= a * spread + atol + rtol * |ref|.  bf16:
    # the kernels round p (for dV) and ds (for dQ, dK) to bf16 (unit
    # roundoff U = 2^-8) before their products, which moves an element by
    # at most U times the same product over absolute values (spread: |ds|
    # . |k| for dQ, |ds|^T . |q| for dK, p^T . |dO| for dV, summed over the
    # GQA group, fp32), and both sides round the output to bf16 (at most
    # 2U |ref| apart).  fp32: exact products, sums in another order than
    # the reference.  "fro" bounds ||got - ref|| / ||ref|| per gradient.
    U = 2.0 ** -8
    tol = {torch.bfloat16: {"elem": (U, 1e-5, 2 * U), "fro": 2 * U},
           torch.float32: {"elem": (0.0, 1e-4, 1e-4), "fro": 1e-5}}
    cases = [dict(B=1, H=32, Hkv=8, Sq=s, Sk=s, D=128, causal=True, off=0,
                  dt=torch.bfloat16) for s in (512, 2048)]
    for dt in (torch.bfloat16, torch.float32):
        for H, Hkv in ((4, 4), (8, 2), (32, 8)):
            for D in (64, 128):
                for Sq, Sk in ((1000, 1000), (256, 1000), (64, 512)):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                                      causal=False, off=0, dt=dt))
                    for off in (-64, 0, 256, Sk + 64):
                        cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk,
                                          D=D, causal=True, off=off, dt=dt))
    # head_dim 32 (the tiny model's), both dtypes.
    for dt in (torch.float32, torch.bfloat16):
        for H, Hkv in ((4, 4), (8, 2), (32, 8)):
            for Sq, Sk in ((1000, 1000), (256, 1000), (64, 512)):
                cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=32,
                                  causal=False, off=0, dt=dt))
                for off in (-64, 0, 256, Sk + 64):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=32,
                                      causal=True, off=off, dt=dt))
    # Sq > Sk: K3's ragged q tail, and many more (q head, q tile)
    # iterations than the ring has stages.
    for H, Hkv in ((8, 2), (32, 8)):
        for D in (64, 128):
            for off in (0, -64):
                cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=1000, Sk=256, D=D,
                                  causal=True, off=off, dt=torch.bfloat16))
    worst = {}
    for c in cases:
        q, k, v, do, lse, delta = _bwd_case(torch, att, g, c)
        _check_bwd(torch, att, c, tol, worst, q, k, v, do, lse, delta)
    # K1 feeding K2/K3 as in training: K1's own out and lse, delta from
    # K1's out, dO zero on rows that see no key.  off -64: the first
    # 64-row tile visits nothing; off -63: its rows but the last see no key
    # inside a visited tile, so lse = NEG_INF there must be exact or p
    # overflows.
    chained = 0
    for off in (-64, -63):
        for H, Hkv in ((8, 2), (32, 8)):
            for D in (64, 128):
                c = dict(B=2, H=H, Hkv=Hkv, Sq=300, Sk=300, D=D, causal=True,
                         off=off, dt=torch.bfloat16, fed_by_k1=True)
                q, k, v = _attn_inputs(torch, g, 2, H, Hkv, 300, 300, D,
                                       c["dt"])
                out, lse = att.flash_attention_fwd(q, k, v, causal=True,
                                                   q_offset=off)
                sees = torch.arange(300, device="cuda") + off >= 0
                do = (torch.randn(q.shape, generator=g, device="cuda")
                      * sees[:, None]).to(c["dt"])
                delta = (do.float() * out.float()).sum(-1)
                _check_bwd(torch, att, c, tol, worst, q, k, v, do, lse,
                           delta)
                chained += 1
    tol_s = json.dumps({str(k): v for k, v in tol.items()})
    print(f"[K2/K3] {len(cases)} cases and {chained} fed by K1 within "
          f"tolerance; worst element err "
          f"and relative norm err by dtype {json.dumps(worst)}; tolerances "
          f"{tol_s}")

    # The training shape: B=1, H=32, Hkv=8, D=128, causal, bf16, at S =
    # 2048 (the main path's) and 512.
    timed = {}
    for S in (512, 2048):
        timed[S] = _time_bwd(torch, att, F, g, S)
    main = timed[2048]
    report["flash_bwd"] = {"cases": len(cases), "fed_by_k1": chained,
                           "worst": worst, "main": main,
                           "s512": timed[512]}


def _time_bwd(torch, att, F, g, S):
    """K2 and K3 at [1, 32, S, 128], Hkv 8, causal, bf16: error against the
    plain version, device and per-call time, the plain version's and SDPA's
    backward's time, the bound, and the SM clock before and after each
    kernel's timed loops."""
    B, H, Hkv, D = 1, 32, 8, 128
    c = dict(B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=D, causal=True, off=0,
             dt=torch.bfloat16)
    q, k, v, do, lse, delta = _bwd_case(torch, att, g, c)
    ref = att.flash_attention_bwd_ref(q, k, v, lse, delta, do)
    dq = att.flash_attention_bwd_dq(q, k, v, lse, delta, do)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
    errs = [float((x.float() - r.float()).abs().max())
            for x, r in zip((dq, dk, dv), ref)]
    del ref
    # Library yardstick for the pair: the device time of SDPA's backward,
    # i.e. one forward and backward less the forward alone.
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_route = "enable_gqa"

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                              enable_gqa=kr.shape[1] != H)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), do)

    try:
        sdpa_fwd_bwd()
    except RuntimeError as e:
        print(f"[K2/K3] SDPA backward refused GQA ({e}); K/V repeated to "
              f"{H} heads")
        lib_route = "K/V repeated to H heads"
        kr, vr = (att._repeat_kv(t, H).detach().requires_grad_(True)
                  for t in (k, v))
    library_ms = device_ms(torch, sdpa_fwd_bwd) - device_ms(torch, sdpa_fwd)
    library_call_ms = time_ms(torch, sdpa_fwd_bwd)
    plain = lambda: att.flash_attention_bwd_ref(  # noqa: E731
        q, k, v, lse, delta, do)
    plain_ms = device_ms(torch, plain, iters=3)
    plain_call_ms = time_ms(torch, plain, iters=5)
    pairs = S * (S + 1) // 2  # causal (q, key) pairs per head
    lse_bytes = 2 * B * H * S * 4  # lse and delta
    work = {
        "flash_bwd_dq": (6 * B * H * D * pairs,
                         (3 * B * H * S * D + 2 * B * Hkv * S * D) * 2
                         + lse_bytes,
                         lambda: att.flash_attention_bwd_dq(
                             q, k, v, lse, delta, do), errs[0]),
        "flash_bwd_dkv": (8 * B * H * D * pairs,
                          (2 * B * H * S * D + 4 * B * Hkv * S * D) * 2
                          + lse_bytes,
                          lambda: att.flash_attention_bwd_dkv(
                              q, k, v, lse, delta, do), max(errs[1:])),
    }
    out = {}
    for name, (flops, nbytes, kern, err) in work.items():
        clocks_before = clocks_line()
        call_ms = time_ms(torch, kern)
        ms = device_ms(torch, kern)
        clocks_after = clocks_line()
        rec = {
            "shape": dict(B=B, H=H, Hkv=Hkv, S=S, D=D, causal=True,
                          dtype="bfloat16"),
            "max_abs_err": err,
            "call_ms": call_ms, "ms": ms,
            # SM clock, max SM clock (nvidia-smi) around the timed loops.
            "clocks_before": clocks_before, "clocks_after": clocks_after,
            # The plain version and the library call compute K2 and K3
            # together: their times are the pair's.
            "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
            "library_ms": library_ms, "library_call_ms": library_call_ms,
            "library_route": lib_route,
            "bound_ms": max(flops / PEAK_BF16_FLOPS,
                            nbytes / PEAK_HBM_BYTES) * 1e3,
            "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                         >= nbytes / PEAK_HBM_BYTES else "bytes"),
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        out[name] = rec
        print(f"[{name}] S={S} " + json.dumps(rec))
    return out


def _counters():
    """{kernel name: its wrapper, which carries the launch count}."""
    from ray_tpu_torch.ops import attention, norms

    return {"flash_fwd": attention.flash_attention_fwd,
            "flash_bwd_dq": attention.flash_attention_bwd_dq,
            "flash_bwd_dkv": attention.flash_attention_bwd_dkv,
            "rms_norm": norms.rms_norm_cuda}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def phase_tiny_serve(torch, report, seed: int):
    """The tiny model (d_model 128, 4 heads: head_dim 32, as ``llm_app``'s
    default model) served on the card: 6 requests through an
    ``InferenceEngine``, greedy, and K1 and K4 must have launched.  In
    fp32 the tokens must equal those of the same engine built on the CPU
    from the same parameters (plain versions of the kernels there).  In
    bf16, the model's default dtype, the prefill forward's logits of the
    same prompts are held against the fp32 forward of the same parameters
    on the CPU, under the forward phase's rule."""
    from ray_tpu_torch.models.llama import (Llama, LlamaConfig, llama_apply,
                                            llama_init)
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(batch_slots=4, page_size=16, max_prompt_len=128,
                        max_new_tokens_cap=32, prefix_cache=False)
    rng = np.random.default_rng(seed + 4)
    lengths = (5, 40, 77, 128, 17, 64)
    new = 16

    def serve(cfg, p, device, prompts):
        engine = InferenceEngine(cfg, p, ecfg, seed=seed, device=device)
        try:
            streams = [engine.submit(t, max_new_tokens=new) for t in prompts]
            return [list(st) for st in streams], engine.stats()
        finally:
            engine.shutdown()

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = LlamaConfig.tiny(dtype=dt)
        name = str(dt).split(".")[-1]
        params = llama_init(cfg, torch.Generator(device="cuda")
                            .manual_seed(seed + 4))
        cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
        cpu_params = Llama(cpu_cfg, torch.device("cpu"))
        cpu_params.load_state_dict(params.state_dict())
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lengths]
        _reset_counts()
        got, stats = serve(cfg, params, None, prompts)
        torch.cuda.synchronize()
        counts = _read_counts()
        check(all(len(t) == new for t in got),
              f"tiny serve ({name}) lost tokens")
        check(counts["flash_fwd"] > 0 and counts["rms_norm"] > 0,
              f"tiny serve ({name}) did not launch K1 and K4: {counts}")
        rec = {"head_dim": cfg.head_dim, "requests": len(prompts),
               "launches": counts}
        if dt == torch.float32:
            want, _ = serve(cpu_cfg, cpu_params, "cpu", prompts)
            same = sum(int(a == b) for g, w in zip(got, want)
                       for a, b in zip(g, w))
            msg = (f"{same}/{len(prompts) * new} equal to the CPU "
                   f"engine's")
            check(got == want, f"tiny serve on the card differs from the "
                               f"CPU: {got} vs {want}")
            rec["tokens_equal"] = same
        else:
            # The prompts' prefill forward on the card (K1 at head_dim 32
            # in bf16, K4) against fp32 on the CPU, as the forward phase.
            with torch.no_grad():
                logits = torch.cat([llama_apply(
                    cfg, params, torch.from_numpy(t).long()[None].cuda())[0]
                    .float().cpu() for t in prompts])
                ref = torch.cat([llama_apply(
                    cpu_cfg, cpu_params, torch.from_numpy(t).long()[None])[0]
                    for t in prompts])
            rel = float((logits - ref).norm() / ref.norm())
            top1 = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
            rel_tol, top1_min = 5e-2, 0.75
            msg = (f"prefill logits vs fp32 CPU: rel err {rel:.4g} (tol "
                   f"{rel_tol}), top-1 agreement {top1:.4f} (min "
                   f"{top1_min})")
            check(rel <= rel_tol and top1 >= top1_min,
                  f"tiny bf16 prefill disagrees with the fp32 CPU "
                  f"forward: rel {rel}, top-1 {top1}")
            rec.update(rel_err=rel, top1=top1, rel_tol=rel_tol,
                       top1_min=top1_min)
        print(f"[tiny-serve] tiny model {name} (head_dim {cfg.head_dim}) on "
              f"the card: {len(prompts)} requests x {new} greedy tokens, "
              f"{msg}; {stats['decode_traces']} decode / "
              f"{stats['prefill_traces']} prefill traces; launches {counts}")
        out[name] = rec
    report["tiny_serve"] = out
    # The launch counts of the serving path are the two runs' together.
    report["tiny_serve"]["launches"] = {
        k: sum(r["launches"][k] for r in out.values())
        for k in out["float32"]["launches"]}


def phase_forward(torch, report, seed: int):
    with torch.no_grad():  # serving: no autograd, K4 on every norm
        return _forward(torch, report, seed)


def _forward(torch, report, seed: int):
    from ray_tpu_torch.models.llama import (Llama, LlamaConfig, llama_apply,
                                            llama_init)

    cfg = LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = llama_init(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    logits = llama_apply(cfg, params, tokens)  # warm (cuBLAS heuristics)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    logits = llama_apply(cfg, params, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    kernels, prof_wall_ms = profile_window(
        torch, lambda: llama_apply(cfg, params, tokens), iters=2)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"[forward] profiled window: device busy {busy_ms:.1f} ms of "
          f"{prof_wall_ms:.1f} ms wall per call (idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}); top kernels (ms per call): "
          + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))
    check(tuple(logits.shape) == (1, 2048, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")
    print(f"[forward] Llama-3-8B {n_params / 1e9:.2f}B params "
          f"({cfg.n_layers} layers, bf16) init {init_s:.1f} s; llama_apply "
          f"B=1 S=2048 wall {wall * 1e3:.1f} ms; launches {counts}")
    check(counts["flash_fwd"] > 0 and counts["rms_norm"] > 0,
          f"forward path did not launch both kernels: {counts}")
    del logits

    # Two layers at full width against the same weights in fp32 on the CPU
    # through the plain path (the kernels' plain versions).
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = llama_init(cfg2, torch.Generator(device="cuda")
                         .manual_seed(seed + 1))
    tok2 = tokens[:, :512]
    got = llama_apply(cfg2, params2, tok2).cpu()
    cpu = Llama(dataclasses.replace(cfg2, dtype=torch.float32),
                torch.device("cpu"))
    cpu.load_state_dict(params2.state_dict())
    del params2
    t0 = time.perf_counter()
    ref = llama_apply(cpu.config, cpu, tok2.cpu())
    cpu_s = time.perf_counter() - t0
    rel = float((got - ref).norm() / ref.norm())
    top1 = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # bf16 weights/activations vs fp32: ~1% relative logit error; top-1
    # flips only where the fp32 top-2 margin is inside that error.
    rel_tol, top1_min = 5e-2, 0.75
    print(f"[forward] 2-layer full-width S=512 vs fp32 CPU plain path "
          f"({cpu_s:.1f} s): rel err {rel:.4g} (tol {rel_tol}), top-1 "
          f"agreement {top1:.4f} (min {top1_min})")
    check(rel <= rel_tol and top1 >= top1_min,
          f"forward disagrees with the fp32 CPU reference: rel {rel}, "
          f"top-1 {top1}")
    del cpu
    report["forward"] = {"params_b": n_params / 1e9, "init_s": init_s,
                         "wall_ms": wall * 1e3, "launches": counts,
                         "profiled_wall_ms": prof_wall_ms,
                         "device_busy_ms": busy_ms,
                         "top_kernels_ms": dict(top),
                         "rel_err_2layer": rel, "top1_2layer": top1,
                         "rel_tol": rel_tol, "top1_min": top1_min}
    return cfg, params


def phase_serve(torch, report, cfg, params, seed: int):
    from ray_tpu_torch.models.generate import generate
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(batch_slots=8, page_size=16, max_prompt_len=512,
                        max_new_tokens_cap=64, prefix_cache=False)
    engine = InferenceEngine(cfg, params, ecfg, seed=seed)
    rng = np.random.default_rng(seed)
    new = 32
    first = [(16, 0.0), (40, 0.8), (77, 0.0), (128, 0.8), (200, 0.0),
             (256, 0.0), (380, 0.8), (512, 0.0)]
    late = [(24, 0.8), (96, 0.0), (300, 0.8), (512, 0.0)]
    check_idx = 5  # 256 tokens = a prefill bucket, greedy
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in first + late]
    temps = [t for _, t in first + late]
    results = [None] * len(prompts)
    errors = []
    started = threading.Event()

    def consume(i, stream):
        try:
            toks = []
            for tok in stream:
                toks.append(tok)
                started.set()
            results[i] = (toks, stream.ttft_s)
        except Exception as e:  # noqa: BLE001: reported below
            errors.append((i, repr(e)))
            started.set()

    try:
        _reset_counts()
        t0 = time.perf_counter()
        threads = []
        for i in range(len(first)):
            s = engine.submit(prompts[i], max_new_tokens=new,
                              temperature=temps[i])
            threads.append(threading.Thread(target=consume, args=(i, s)))
            threads[-1].start()
        check(started.wait(600), "no token within 600 s")
        # The late four arrive while the first eight decode.
        deadline = time.time() + 600
        while (engine.stats()["active_seqs"] < len(first) and not errors
               and time.time() < deadline):
            time.sleep(0.005)
        active_at_late = engine.stats()["active_seqs"]
        for i in range(len(first), len(prompts)):
            s = engine.submit(prompts[i], max_new_tokens=new,
                              temperature=temps[i])
            threads.append(threading.Thread(target=consume, args=(i, s)))
            threads[-1].start()
        for th in threads:
            th.join(timeout=600)
            check(not th.is_alive(), "a stream did not finish in 600 s")
        wall = time.perf_counter() - t0
        counts = _read_counts()
        check(not errors, f"stream errors: {errors}")
        for i, (toks, _) in enumerate(results):
            check(len(toks) == new, f"request {i}: {len(toks)} tokens, "
                                    f"expected {new}")
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"request {i}: token out of range")
        deadline = time.time() + 10
        while (engine.allocator.free_count != engine.allocator.total
               and time.time() < deadline):
            time.sleep(0.05)
        check(engine.allocator.free_count == engine.allocator.total,
              f"pages leaked: {engine.allocator.free_count} free of "
              f"{engine.allocator.total}")
        stats = engine.stats()
    finally:
        engine.shutdown()
    check(counts["flash_fwd"] > 0 and counts["rms_norm"] > 0,
          f"serve path did not launch both kernels: {counts}")
    ttfts = sorted(r[1] for r in results)
    total = sum(len(r[0]) for r in results)
    ref = generate(cfg, params, prompts[check_idx][None],
                   max_new_tokens=new)[0, -new:].cpu().tolist()
    got = results[check_idx][0]
    agree = sum(int(a == b) for a, b in zip(got, ref))
    prefix = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                  new)
    print(f"[serve] 12 requests x {new} tokens on Llama-3-8B: wall "
          f"{wall:.2f} s, {total / wall:.1f} tokens/s, TTFT p50 "
          f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms max {ttfts[-1] * 1e3:.1f} "
          f"ms, {stats['steps']} decode steps, active when late requests "
          f"arrived {active_at_late}; launches {counts}")
    print(f"[serve] greedy request ({len(prompts[check_idx])}-token prompt) "
          f"vs generate: first token {got[0]} vs {ref[0]}, {agree}/{new} "
          f"tokens agree, identical prefix {prefix}")
    check(got[0] == ref[0], "engine's first greedy token differs from "
                            "generate's")
    report["serve"] = {
        "wall_s": wall, "tokens": total, "tokens_per_s": total / wall,
        "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
        "ttft_max_ms": ttfts[-1] * 1e3, "steps": stats["steps"],
        "launches": counts, "greedy_agree": agree,
        "greedy_prefix": prefix}


def phase_serve_profile(torch, report, cfg, params, seed: int):
    """A warm serving window: 8 requests x 8 tokens through a fresh engine
    of the same geometry, after a warm window and an unprofiled timed one,
    under torch.profiler: wall time, prefill time, device busy time and the
    top kernels, all of that one window."""
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(
        cfg, params, EngineConfig(batch_slots=8, page_size=16,
                                  max_prompt_len=512, max_new_tokens_cap=64,
                                  prefix_cache=False), seed=seed)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 40, 77, 128, 200, 256, 380, 512)]

    def run():
        streams = [engine.submit(p, max_new_tokens=8) for p in prompts]
        return [list(s) for s in streams]

    outs = []
    try:
        run()  # warm
        # The same window unprofiled: only to show what the profiler costs.
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        unprofiled_ms = (time.perf_counter() - t0) * 1e3
        steps0, prefill0 = engine.step_count, engine.prefill_s
        kernels, wall_ms = profile_window(
            torch, lambda: outs.append(run()), iters=1)
        steps = engine.step_count - steps0
        prefill_s = engine.prefill_s - prefill0
    finally:
        engine.shutdown()
    check(all(len(t) == 8 for t in outs[0]), "profiled window lost tokens")
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"[serve-profile] 8 requests x 8 tokens, profiled window: wall "
          f"{wall_ms:.1f} ms ({prefill_s * 1e3:.1f} ms in prefill, {steps} "
          f"decode steps); device busy {busy:.1f} ms (idle share "
          f"{1 - busy / wall_ms:.3f}; unprofiled, the window took "
          f"{unprofiled_ms:.1f} ms); top kernels (ms): "
          + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))
    report["serve_profile"] = {"wall_ms": wall_ms,
                               "unprofiled_wall_ms": unprofiled_ms,
                               "prefill_ms": prefill_s * 1e3,
                               "decode_steps": steps, "device_busy_ms": busy,
                               "idle_share": 1 - busy / wall_ms,
                               "top_kernels_ms": dict(top)}


# Kernel-name patterns of a train step's device time, by kind.
_STEP_KINDS = (
    ("K1 flash_fwd", ("flash_fwd_kernel", "flash_fwd_fma_kernel")),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_fma_kernel")),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                          "flash_bwd_dkv_fma_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("AdamW (fused)", ("multi_tensor_apply", "fused_adam")),
)


def phase_train(torch, report, seed: int, steps: int = 5):
    """AdamW train steps on full Llama-3-8B (B=1, S=2048), as bench.py
    drives the JAX package: 2 warm steps, then ``steps`` timed ones."""
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init, llama_loss
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer,
                                                  make_train_step)

    cfg = LlamaConfig.llama3_8b()
    B, S = 1, 2048
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = llama_init(cfg, gen, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    tx = default_optimizer(lr=1e-4)
    state = TrainState.create(params, tx)
    step = make_train_step(
        lambda p, b: llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    metrics = []
    for _ in range(2):  # warm: optimizer state, cuBLAS heuristics
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels, prof_wall_ms = profile_window(torch, lambda: step(state, batch),
                                           iters=1)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    by_kind = {}
    for name, ms in kernels.items():
        kind = next((k for k, pats in _STEP_KINDS if any(
            pat in name for pat in pats)), "other (elementwise, reductions, "
                                           "copies)")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    L = cfg.n_layers
    tokens_per_s = B * S / step_s
    # bench.py's convention: 6N + 6 L S d model flops per token, remat
    # excluded, against the H100's dense bf16 peak.
    flops_per_token = 6 * n_params + 6 * L * S * cfg.d_model
    mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
    print(f"[train] Llama-3-8B {n_params / 1e9:.2f}B params ({L} layers, "
          f"bf16, remat full) B={B} S={S}: step {step_s * 1e3:.1f} ms, "
          f"{tokens_per_s:.1f} tokens/s, MFU {mfu:.4f}; peak memory "
          f"{peak_gb:.2f} GB; losses {[round(x, 4) for x in losses]}; "
          f"grad norms {[round(x, 4) for x in norms]}; launches {counts}")
    print(f"[train] profiled step: device busy {busy_ms:.1f} ms of "
          f"{prof_wall_ms:.1f} ms wall (idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}); by kind (ms): "
          + "; ".join(f"{k} {t:.1f}" for k, t in sorted(
              by_kind.items(), key=lambda kv: -kv[1]))
          + "; top kernels (ms): "
          + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(losses[-1] < losses[0],
          f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps, "rms_norm": 0}
    check(counts == want, f"train launches {counts}, expected {want} "
                          f"(K1 forward + remat recompute, K2/K3 once per "
                          f"layer, K4 none under autograd)")
    report["train"] = {
        "params_b": n_params / 1e9, "layers": L, "batch": B, "seq": S,
        "steps": steps, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens_per_s, "mfu": mfu, "peak_gb": peak_gb,
        "losses": losses, "grad_norms": norms, "launches": counts,
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / prof_wall_ms,
        "by_kind_ms": by_kind, "top_kernels_ms": dict(top)}
    return cfg, tokens


def phase_train_check(torch, report, cfg, tokens, seed: int):
    """Two layers at full width: loss and every gradient in bf16 on the
    card against the same weights in fp32 on the CPU through the plain
    path (the kernels' plain versions), B=1, S=256."""
    from ray_tpu_torch.models.llama import Llama, llama_init, llama_loss

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = llama_init(cfg2, torch.Generator(device="cuda")
                        .manual_seed(seed + 3), trainable=True)
    tok = tokens[:, :256]
    tgt = torch.roll(tok, -1, dims=1)
    loss = llama_loss(cfg2, params, tok, tgt)
    loss.backward()
    loss = float(loss.detach())
    got = {n: p.grad.float().cpu() for n, p in params.named_parameters()}
    cpu = Llama(dataclasses.replace(cfg2, dtype=torch.float32, remat=False),
                torch.device("cpu"))
    cpu.load_state_dict(params.state_dict())
    del params
    cpu.requires_grad_(True)
    t0 = time.perf_counter()
    ref = llama_loss(cpu.config, cpu, tok.cpu(), tgt.cpu())
    ref.backward()
    ref = float(ref.detach())
    cpu_s = time.perf_counter() - t0
    rel = {n: float((got[n] - p.grad).norm() / p.grad.norm())
           for n, p in cpu.named_parameters()}
    loss_rel = abs(loss - ref) / abs(ref)
    # bf16 against fp32: every activation, weight and gradient is rounded
    # to bf16 (unit roundoff 2^-8 = 0.4 %) at each of the ~20 ops of a
    # layer's forward and backward, and the weight gradients are summed
    # over 256 tokens; the relative norm error of each gradient is expected
    # at 1-2 %, and 5 % is the bound.  The loss is one fp32 reduction of
    # bf16 logits: 1 %.
    grad_tol, loss_tol = 5e-2, 1e-2
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    print(f"[train-check] 2-layer full-width S=256 vs fp32 CPU plain path "
          f"({cpu_s:.1f} s): loss {loss:.5f} vs {ref:.5f} "
          f"(rel {loss_rel:.3g}, tol {loss_tol}); gradient rel norm err over "
          f"{len(rel)} tensors, worst: "
          + ", ".join(f"{n} {e:.4g}" for n, e in worst)
          + f" (tol {grad_tol})")
    check(loss_rel <= loss_tol and max(rel.values()) <= grad_tol,
          f"train path disagrees with the fp32 CPU reference: loss rel "
          f"{loss_rel}, gradient rel {dict(worst)}")
    report["train_check"] = {"loss": loss, "ref_loss": ref,
                             "loss_rel": loss_rel, "grad_rel": rel,
                             "grad_tol": grad_tol, "loss_tol": loss_tol}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", help="also write every phase's numbers "
                    "to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import ray_tpu_torch ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    report = {"card": card}
    t_all = time.perf_counter()
    phase_build(report)
    phase_rms(torch, report)
    phase_flash(torch, report)
    phase_flash_bwd(torch, report)
    phase_tiny_serve(torch, report, args.seed)
    cfg, params = phase_forward(torch, report, args.seed)
    phase_serve(torch, report, cfg, params, args.seed)
    phase_serve_profile(torch, report, cfg, params, args.seed)
    del params  # the serving model makes room for training
    gc.collect()
    torch.cuda.empty_cache()
    cfg, tokens = phase_train(torch, report, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_check(torch, report, cfg, tokens, args.seed)
    report["total_s"] = time.perf_counter() - t_all

    paths = {path: report[path]["launches"]
             for path in ("tiny_serve", "forward", "serve", "train")}
    bwd = report["flash_bwd"]["main"]
    kernels = []
    for name, src, replaces, main in (
            ("flash_fwd", "ray_tpu_torch/csrc/flash_fwd.cu",
             "ray_tpu/ops/attention.py:84", report["flash_fwd"]["main"]),
            ("flash_bwd_dq", "ray_tpu_torch/csrc/flash_bwd.cu",
             "ray_tpu/ops/attention.py:174", bwd["flash_bwd_dq"]),
            ("flash_bwd_dkv", "ray_tpu_torch/csrc/flash_bwd.cu",
             "ray_tpu/ops/attention.py:214", bwd["flash_bwd_dkv"]),
            ("rms_norm", "ray_tpu_torch/csrc/rms_norm.cu",
             "ray_tpu/ops/norms.py:20", report["rms_norm"]["main"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(c[name] for c in paths.values()),
            **{f"launches_{path}": c[name] for path, c in paths.items()},
            "max_abs_err": main["max_abs_err"],
            # Device time from the profiler.
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "library_ms": main["library_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            # Host per-call time (CUDA events over back-to-back calls).
            "call_ms": main["call_ms"]})
    report["kernels"] = kernels
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(f"[done] all phases passed in {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
