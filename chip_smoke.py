#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, from the repo root

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. card: ``nvidia-smi`` name and power limit.
2. build: compile every kernel under ``ray_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together).
3. K4 (``csrc/rms_norm.cu``) against its plain version, timed beside the
   plain version and ``F.rms_norm``.
4. K1 (``csrc/flash_fwd.cu``) against ``flash_attention_ref`` (out and
   lse) over Llama-3-8B shapes, GQA groups, head dims, offsets, ragged
   lengths and both dtypes, timed beside the plain version and SDPA.
5. forward: ``llama_apply`` on full Llama-3-8B (32 layers, random weights
   from a seed) at B=1, S=2048, then a 2-layer full-width model against the
   same weights in fp32 on the CPU through the plain path.
6. serve: ``InferenceEngine`` on full Llama-3-8B answers 12 requests (8 at
   once, 4 admitted while those decode); checks counts, page balance and
   greedy agreement with ``generate``; then a warm 8-request window under
   the profiler: wall, prefill and device busy time of that one window.

Kernel launch counters are zeroed just before the forward and the serve
paths run and read just after; both kernels must have launched on both.
The second-to-last JSON line lists every kernel with its launches, error,
times and bound; the last line is the device record.  ``--report PATH``
also writes every phase's numbers to PATH as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    op records), which keeps the profiler's own host time small.  Raises
    when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    check(bool(by_name), "torch.profiler saw no device activity")
    return by_name, wall_ms


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


def within(torch, got, ref, atol: float, rtol: float):
    """(max_abs_err, ok) for |got - ref| <= atol + rtol * |ref|."""
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), "kernel output is not finite")
    diff = (g - r).abs()
    return float(diff.max()), bool((diff <= atol + rtol * r.abs()).all())


# ------------------------------------------------------------------ phases


def phase_build(report):
    from ray_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build()
    report["build_s"] = time.perf_counter() - t0
    for name, log in _build.build_logs.items():
        lines = [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l.lower()
                 or "smem" in l]
        print(f"[build] {name}.cu ptxas: " + " | ".join(lines[:8]))
    print(f"[build] kernels built in {report['build_s']:.1f} s")


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
    # (atol, rtol).
    U = 2.0 ** -8
    tol = {torch.bfloat16: {"out": (U, 1e-5, 2 * U), "fro": 2 * U,
                            "lse": (1e-3, 1e-5)},
           torch.float32: {"out": (0.0, 1e-4, 1e-4), "fro": 1e-5,
                           "lse": (1e-4, 1e-5)}}
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
    worst = {}
    for c in cases:
        q, k, v = _attn_inputs(torch, g, c["B"], c["H"], c["Hkv"], c["Sq"],
                               c["Sk"], c["D"], c["dt"])
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
        d_norm = float((out.float() - ref_out.float()).norm())
        r_norm = float(ref_out.float().norm())
        fro = d_norm / r_norm if r_norm > 0 else d_norm
        tag = (f"B{c['B']} H{c['H']}/{c['Hkv']} Sq{c['Sq']} Sk{c['Sk']} "
               f"D{c['D']} causal={c['causal']} off={c['off']} {c['dt']}")
        check(ok_out and ok_lse and fro <= t["fro"],
              f"K1 {tag}: out err {e_out} (tol {t['out']}), relative "
              f"norm err {fro} (tol {t['fro']}), lse err {e_lse} (tol "
              f"{t['lse']})")
        w = worst.setdefault(str(c["dt"]), {"out": 0.0, "fro": 0.0})
        w["out"], w["fro"] = max(w["out"], e_out), max(w["fro"], fro)
    tol_s = json.dumps({str(k): v for k, v in tol.items()})
    print(f"[K1] {len(cases)} cases within tolerance; worst out err and "
          f"relative norm err by dtype {json.dumps(worst)}; tolerances "
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
                           "timed": timed, "main": timed[-1]}


def _reset_counts():
    from ray_tpu_torch.ops import attention, norms

    attention.flash_attention_fwd.launches = 0
    norms.rms_norm_cuda.launches = 0


def _read_counts():
    from ray_tpu_torch.ops import attention, norms

    return {"flash_fwd": attention.flash_attention_fwd.launches,
            "rms_norm": norms.rms_norm_cuda.launches}


def phase_forward(torch, report, seed: int):
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
    cfg, params = phase_forward(torch, report, args.seed)
    phase_serve(torch, report, cfg, params, args.seed)
    phase_serve_profile(torch, report, cfg, params, args.seed)
    report["total_s"] = time.perf_counter() - t_all

    fwd = report["forward"]["launches"]
    srv = report["serve"]["launches"]
    kernels = []
    for name, src, replaces, main in (
            ("flash_fwd", "ray_tpu_torch/csrc/flash_fwd.cu",
             "ray_tpu/ops/attention.py:84", report["flash_fwd"]["main"]),
            ("rms_norm", "ray_tpu_torch/csrc/rms_norm.cu",
             "ray_tpu/ops/norms.py:20", report["rms_norm"]["main"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": fwd[name] + srv[name],
            "launches_forward": fwd[name],
            "launches_serve": srv[name],
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
