#!/usr/bin/env python3
"""Compare builds of the bf16 flash-attention backward kernels on one GPU.

    python3 scripts/bwd_builds.py dq     # K2 (dQ), from the repo root
    python3 scripts/bwd_builds.py dkv    # K3 (dK, dV)

Each build is the committed ``ray_tpu_torch/csrc/flash_bwd.cu`` with a few
text substitutions (``VARIANTS``, each replacing every match),
compiled with the flags of ``ray_tpu_torch._build`` into
``ray_tpu_torch/_build/bwd_builds/<kernel>/``.  The script prints each
build's ptxas registers and spills for the kernel's bf16 instantiations,
checks every build that computes the kernel's function on every K2/K3
case of ``chip_smoke.phase_flash_bwd`` (each in a process of its own, so
a faulting build cannot poison the others), then times all builds in
turns (three rounds, alternating order) at [1, 32, S, 128], Hkv 8,
causal, bf16, S = 512 and 2048, with the SM clock sampled after each
round.  Builds marked "ablation" drop work and compute wrong results by
design: only their times mean something.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "ray_tpu_torch" / "csrc" / "flash_bwd.cu"
OUT = ROOT / "ray_tpu_torch" / "_build" / "bwd_builds"

# Per kernel: its C entry, its pointer arguments, the ptxas name of its
# bf16 kernels and its wrapper in ray_tpu_torch.ops.attention.
KERNELS = {
    "dq": ("rt_flash_bwd_dq", 7, "flash_bwd_dq_kernel<bf16",
           "flash_attention_bwd_dq"),
    "dkv": ("rt_flash_bwd_dkv", 8, "flash_bwd_dkv_kernel<bf16",
            "flash_attention_bwd_dkv"),
}

# One consumer warpgroup running all four products, the dV/dK products
# issued as soon as p^T and ds^T are ready.
ONE_WARPGROUP = '''
template <typename T, int D>
__device__ __forceinline__ void consume_all(const Block& bk, Tile tl,
                                            T* dk, T* dv, int warp,
                                            int lane) {
  using L = Layout<D>;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t k_addr = bk.base + L::K, v_addr = bk.base + L::V;
  for (int i = 0; i < bk.n_it; ++i) {
    const int s = i % ST;
    tl.q0 = (bk.qt_lo + i % bk.nq) * BQ;
    const bool masked = tl.masked(bk.k0);
    rt::mbar_wait_spin(bk.full + 8 * s, (i / ST) & 1);
    const uint32_t q_addr = stage_addr<D>(bk, s);
    const uint32_t do_addr = q_addr + L::TILE;
    const float* lse_s = stats<D>(bk, s);
    float sc[32], dp[32];
    uint32_t pa[4][4], da[4][4];
    rt::wgmma_fence();
    issue_scores<D>(sc, k_addr, q_addr);
    rt::wgmma_commit();
    issue_scores<D>(dp, v_addr, do_addr);
    rt::wgmma_commit();
    rt::wgmma_wait<1>();
    fence_all(sc);
    probs(sc, lse_s, tl, masked);
    pack(sc, pa);
    rt::wgmma_fence();
    issue_acc<D>(dva, pa, do_addr);
    rt::wgmma_commit();
    rt::wgmma_wait<1>();
    fence_all(dp);
    dscores(dp, sc, lse_s + 64, tl);
    pack(dp, da);
    rt::wgmma_fence();
    issue_acc<D>(dka, da, q_addr);
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    fence_all(dka);
    fence_all(dva);
    fence_all(pa);
    fence_all(da);
    rt::mbar_arrive(bk.empty + 8 * s);
  }
  rt::named_barrier(1, 128);
  store_rows<T, D>(dk, bk.smem + L::K, dka, warp, lane, bk.k_rows);
  store_rows<T, D>(dv, bk.smem + L::V, dva, warp, lane, bk.k_rows);
}

'''

HANDOFF_LATE = """    pack(sc, pa);
    rt::wgmma_fence();
    issue_acc<D>(dva, pa, q_addr + L::TILE);  // dV += P^T.dO
    rt::wgmma_commit();
    // p^T to warpgroup 0, once it has read this stage's previous one.
    if (i >= ST) rt::named_barrier(PFREE + s, 256);
#pragma unroll
    for (int x = 0; x < 32; ++x) pt[x * 128 + tid] = sc[x];
    rt::named_barrier_arrive(PREADY + s, 256);
"""
HANDOFF_FIRST = """    if (i >= ST) rt::named_barrier(PFREE + s, 256);
#pragma unroll
    for (int x = 0; x < 32; ++x) pt[x * 128 + tid] = sc[x];
    rt::named_barrier_arrive(PREADY + s, 256);
    pack(sc, pa);
    rt::wgmma_fence();
    issue_acc<D>(dva, pa, q_addr + L::TILE);  // dV += P^T.dO
    rt::wgmma_commit();
"""

# K2: the next tile's S and dP issued before the previous tile's dQ
# product has retired; the previous stage is released once they have.
DQ_LOOP = """        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        fence_all(acc);
        fence_all(da);
      }
      rt::mbar_arrive(empty + 8 * s);  // this thread is done with stage s
    }
"""
DQ_LOOP_OVERLAP = """        rt::wgmma_commit();
        if (j + 1 == hi) {
          rt::wgmma_wait<0>();
          fence_all(acc);
          fence_all(da);
          rt::mbar_arrive(empty + 8 * s);
        }
      } else {
        rt::mbar_arrive(empty + 8 * s);
      }
    }
"""
DQ_SCORES_WAIT = """        rt::wgmma_wait<0>();
        fence_all(sc);
        fence_all(dp);
"""
DQ_SCORES_WAIT_OVERLAP = """        rt::wgmma_wait<0>();  // the previous tile's dQ product too
        fence_all(sc);
        fence_all(dp);
        fence_all(acc);
        fence_all(da);
        if (j > 0) rt::mbar_arrive(empty + 8 * ((j - 1) % ST));
"""

# kernel: {name: (is the kernel's function, [(old, new), ...])}
VARIANTS = {"dkv": {
    "shipped": (True, []),
    "guarded_wait": (True, [("rt::mbar_wait_spin(bk.full", "rt::mbar_wait(bk.full")]),
    "handoff_first": (True, [(HANDOFF_LATE, HANDOFF_FIRST)]),
    "one_warpgroup": (True, [
        ("// Warpgroup 1 of two:", ONE_WARPGROUP + "// Warpgroup 1 of two:"),
        ("constexpr int NTHREADS = 2 * 128 + 32;", "constexpr int NTHREADS = 128 + 32;"),
        ("constexpr int NCONS = 2 * 128;", "constexpr int NCONS = 128;"),
        ("    if (w == 1)\n      consume_dv<T, D>(bk, tl, dv + row0, tid, warp, lane);\n"
         "    else\n      consume_dk<T, D>(bk, tl, dk + row0, tid, warp, lane);",
         "    consume_all<T, D>(bk, tl, dk + row0, dv + row0, warp, lane);")]),
    "ablation_no_score_products": (False, [
        ("    issue_scores<D>(sc, k_addr, q_addr);\n", ""),
        ("    issue_scores<D>(dp, v_addr, q_addr + L::TILE);\n", "")]),
    "ablation_no_dk_dv_products": (False, [
        ("    issue_acc<D>(dva, pa, q_addr + L::TILE);  // dV += P^T.dO\n", ""),
        ("    issue_acc<D>(dka, da, q_addr);\n", "")]),
    "ablation_no_exp": (False, [
        ("x[i] = rt::ex2(fmaf(x[i], sl2, -lse_c * LOG2E));",
         "x[i] = fmaf(x[i], sl2, -lse_c * LOG2E);")]),
}, "dq": {
    "shipped": (True, []),
    "spin_wait": (True, [("rt::mbar_wait(full + 8 * s, (j / ST) & 1);",
                          "rt::mbar_wait_spin(full + 8 * s, (j / ST) & 1);")]),
    "three_stages": (True, [
        ("constexpr int ST = 2;                   // ring stages",
         "constexpr int ST = 3;                   // ring stages")]),
    "overlap": (True, [
        ("        uint32_t da[4][4];\n", ""),
        ("    rt::mbar_wait(qbar, 0);\n",
         "    uint32_t da[4][4];\n    rt::mbar_wait(qbar, 0);\n"),
        (DQ_SCORES_WAIT, DQ_SCORES_WAIT_OVERLAP),
        (DQ_LOOP, DQ_LOOP_OVERLAP)]),
    "ablation_no_score_products": (False, [
        ("        issue_scores<D>(sc, q_addr, k_addr);             // S = Q.K^T\n",
         ""),
        ("        issue_scores<D>(dp, do_addr, k_addr + L::TILE);  // dP = dO.V^T\n",
         "")]),
    "ablation_no_dq_product": (False, [
        ("        issue_acc<D>(acc, da, k_addr);  // dQ += dS.K\n", "")]),
    "ablation_no_exp": (False, [
        ("p = rt::ex2(fmaf(sc[i], sl2, -lse_l2[r]));",
         "p = fmaf(sc[i], sl2, -lse_l2[r]);")]),
}}


def build_all(kernel):
    from ray_tpu_torch import _build

    import chip_smoke as cs

    src = SRC.read_text()
    out = OUT / kernel
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS[kernel].items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{kernel} {name}: substitution no longer "
                                 f"matches {SRC.name}: {old[:60]!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent),
               "-o", str(out / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        rows = [r for r in cs.ptxas_report(log) if KERNELS[kernel][2] in r[0]]
        print(f"[build] {kernel} {name}: rc {proc.returncode}; (kernel, "
              f"registers, spilled bytes) {rows}", flush=True)
        if proc.returncode == 0:
            built.append(name)
        else:
            print(log[-3000:])
    return built


def load(kernel, name):
    entry, n_ptrs = KERNELS[kernel][:2]
    lib = ctypes.CDLL(str(OUT / kernel / f"{name}.so"))
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def check_one(kernel, name):
    """Every K2/K3 case of chip_smoke with the kernel from build ``name``."""
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import attention as att

    att._fns[KERNELS[kernel][0]] = load(kernel, name)
    cs.phase_flash_bwd(torch, {})


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--check":
        check_one(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) != 2 or sys.argv[1] not in KERNELS:
        print(f"usage: {sys.argv[0]} {{{','.join(KERNELS)}}}", file=sys.stderr)
        return 2
    kernel = sys.argv[1]
    entry, _, _, wrapper = KERNELS[kernel]
    import torch

    import chip_smoke as cs
    from ray_tpu_torch import _build
    from ray_tpu_torch.ops import attention as att

    if not torch.cuda.is_available():
        print("bwd_builds: CUDA is not available", file=sys.stderr)
        return 2
    print(f"[card] {cs.card_line()}", flush=True)
    built = build_all(kernel)
    _build.build()
    timed = []
    for name in built:
        if VARIANTS[kernel][name][0]:
            r = subprocess.run(
                [sys.executable, __file__, "--check", kernel, name],
                capture_output=True, text=True, timeout=600)
            print(f"[check] {name}: "
                  + ("every K2/K3 case within tolerance" if r.returncode == 0
                     else f"FAILED\n{(r.stdout + r.stderr)[-2000:]}"),
                  flush=True)
            if r.returncode:
                continue
        timed.append(name)
    libs = {name: load(kernel, name) for name in timed}
    fn = getattr(att, wrapper)
    g = torch.Generator(device="cuda").manual_seed(3)
    inputs = {S: cs._bwd_case(torch, att, g, dict(
        B=1, H=32, Hkv=8, Sq=S, Sk=S, D=128, causal=True, off=0,
        dt=torch.bfloat16)) for S in (512, 2048)}
    res = {n: {S: [] for S in inputs} for n in timed}
    for turn in range(3):
        for name in (timed if turn % 2 == 0 else timed[::-1]):
            att._fns[entry] = libs[name]
            for S, (q, k, v, do, lse, delta) in inputs.items():
                ms = cs.device_ms(torch, lambda: fn(q, k, v, lse, delta, do),
                                  iters=20)
                res[name][S].append(round(ms * 1e3, 2))
        print(f"[clocks] round {turn}: {cs.clocks_line()}", flush=True)
    for name in timed:
        print(f"[time] {kernel} {name}: S=512 {res[name][512]} us; "
              f"S=2048 {res[name][2048]} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
