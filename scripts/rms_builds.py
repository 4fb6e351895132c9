#!/usr/bin/env python3
"""Compare builds of kernel K4 (RMSNorm forward and backward) on one GPU.

    python3 scripts/rms_builds.py        # from the repo root

Each build is the committed ``ray_tpu_torch/csrc/rms_norm.cu`` with a few
text substitutions (``VARIANTS``, each replacing every match), compiled
with the flags of ``ray_tpu_torch._build`` into
``ray_tpu_torch/_build/rms_builds/``.  The script prints each build's
ptxas registers and spills, checks every build on every case of
``chip_smoke.phase_rms`` (forward and backward, each build in a process
of its own, so a faulting build cannot poison the others), then times all
builds in turns (three rounds, alternating order): device time of the
forward at [8, 512, 2048] x 4096 bf16 and of the backward at
[2048, 4096] bf16, the backward split into its row kernel and its dw
kernel.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "ray_tpu_torch" / "csrc" / "rms_norm.cu"
OUT = ROOT / "ray_tpu_torch" / "_build" / "rms_builds"

BWD_4096 = "  if (d == 4096) return f(Bwd<T, VEC, 4096 / VEC / 256, 256, 1>{});"
PER_SM = "constexpr int BWD_BLOCKS_PER_SM = 3;"
ROW_LOADS = """#pragma unroll 1
    for (int i = 0; i < per_slot; ++i) {
      const int row = row0 + i;
      const bool live = row < row1;
      const int64_t off = (int64_t)row * d;
      P xv[VPT], gv[VPT];
      if (live)
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int c = (j * G + t) * VEC;
          xv[j] = load<T, VEC>(x + off + c);
          gv[j] = load<T, VEC>(dy + off + c);
        }
"""
# The next row's x and dy loaded while this row is reduced.
ROW_LOADS_PREFETCH = """    P xn[VPT], gn[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) xn[j].e[k] = gn[j].e[k] = from_f<T>(0.f);
    if (row0 < row1)
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = (j * G + t) * VEC;
        xn[j] = load<T, VEC>(x + (int64_t)row0 * d + c);
        gn[j] = load<T, VEC>(dy + (int64_t)row0 * d + c);
      }
#pragma unroll 1
    for (int i = 0; i < per_slot; ++i) {
      const int row = row0 + i;
      const bool live = row < row1;
      const int64_t off = (int64_t)row * d;
      P xv[VPT], gv[VPT];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        xv[j] = xn[j];
        gv[j] = gn[j];
      }
      if (row + 1 < row1)
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int c = (j * G + t) * VEC;
          xn[j] = load<T, VEC>(x + off + d + c);
          gn[j] = load<T, VEC>(dy + off + d + c);
        }
"""


def _threads(n: int) -> str:
    return BWD_4096.replace("256", str(n))


def _per_sm(n: int) -> str:
    return PER_SM.replace("3", str(n))


# {name: [(old, new), ...]}; every build computes K4's function.
VARIANTS = {
    "shipped": [],
    "bwd 2 blocks an SM": [(PER_SM, _per_sm(2))],
    "bwd 1 block an SM": [(PER_SM, _per_sm(1))],
    "bwd 4 blocks an SM": [(PER_SM, _per_sm(4))],
    "bwd 128 threads a row": [(BWD_4096, _threads(128))],
    "bwd 512 threads a row": [(BWD_4096, _threads(512))],
    "bwd next row prefetched": [(ROW_LOADS, ROW_LOADS_PREFETCH)],
    "fwd 512 threads a row at every row count": [
        ("constexpr int FEW_ROWS = 264;", "constexpr int FEW_ROWS = 1 << 30;")],
    "fwd 256 threads a row when rows are many": [
        ("return fwd<T, VEC, 4, 4096 / VEC / 4, 1>",
         "return fwd<T, VEC, 2, 4096 / VEC / 2, 1>")],
}


def _file(name: str) -> str:
    return re.sub(r"\W+", "_", name)


def build_all():
    from ray_tpu_torch import _build

    import chip_smoke as cs

    src = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: substitution no longer matches "
                                 f"{SRC.name}: {old[:60]!r}")
            text = text.replace(old, new)
        cu = OUT / f"{_file(name)}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent),
               "-o", str(OUT / f"{_file(name)}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        rows = [r for r in cs.ptxas_report(log) if "<bf16, 8, " in r[0]]
        print(f"[build] {name}: rc {proc.returncode}; (bf16 kernel, "
              f"registers, spilled bytes) {rows}", flush=True)
        if proc.returncode == 0:
            built.append(name)
        else:
            print(log[-3000:])
    return built


def use(name: str) -> None:
    from ray_tpu_torch.ops import norms

    norms._fns = norms._bind(
        ctypes.CDLL(str(OUT / f"{_file(name)}.so")))


def check_one(name: str) -> None:
    import torch

    import chip_smoke as cs

    use(name)
    cs.phase_rms(torch, {})


def main() -> int:
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import norms

    if not torch.cuda.is_available():
        print("rms_builds: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--check":
        check_one(sys.argv[2])
        return 0
    card = cs.card_line()
    print(f"[card] {card}", flush=True)
    checked = []
    for name in build_all():
        r = subprocess.run([sys.executable, __file__, "--check", name],
                           capture_output=True, text=True)
        ok = r.returncode == 0
        print(f"[check] {name}: {'every K4 case passed' if ok else 'FAILED'}",
              flush=True)
        if ok:
            checked.append(name)
        else:
            print(r.stdout[-2000:] + r.stderr[-2000:])
    g = torch.Generator(device="cuda").manual_seed(3)
    d, eps = 4096, 1e-5
    w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).bfloat16()
    xs = {rows: torch.randn(rows, d, generator=g, device="cuda").bfloat16()
          for rows in (8, 512, 2048)}
    dy = torch.randn(2048, d, generator=g, device="cuda").bfloat16()
    times = {name: [] for name in checked}
    for rnd in range(3):
        order = checked if rnd % 2 == 0 else checked[::-1]
        for name in order:
            use(name)
            rec = {f"fwd {rows} us": 1e3 * cs.device_ms(
                torch, lambda x=x: norms.rms_norm_cuda(x, w, eps))
                for rows, x in xs.items()}
            bwd = lambda: norms.rms_norm_bwd(xs[2048], w, dy, eps)  # noqa
            bwd()
            by_name, _ = cs.profile_window(torch, bwd)
            rec["bwd 2048 us"] = 1e3 * sum(by_name.values())
            rec["bwd row kernel us"] = 1e3 * sum(
                t for n, t in by_name.items() if "rms_norm_bwd_kernel" in n)
            rec["bwd dw kernel us"] = 1e3 * sum(
                t for n, t in by_name.items() if "rms_norm_dw_kernel" in n)
            times[name].append(rec)
            print(f"[time] round {rnd} {name}: " + json.dumps(
                {k: round(v, 3) for k, v in rec.items()}), flush=True)
        print(f"[clocks] {cs.clocks_line()}", flush=True)
    print("[summary] µs, min-max over rounds (device time, inputs L2-warm)")
    for name, recs in times.items():
        print(f"  {name}: " + "; ".join(
            f"{k} {min(r[k] for r in recs):.2f}-{max(r[k] for r in recs):.2f}"
            for k in recs[0]))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
