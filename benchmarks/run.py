"""The benchmark of ray_tpu_torch on NVIDIA H100s: one cell of
``BENCHMARK.json``, one process, the contract's last line on stdout.

    python3 benchmarks/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Run from the root of a checkout.  Builds and kernel caches stay inside it
(``benchmarks/_cache/``; the port builds its kernels in
``ray_tpu_torch/_build/``).  Exits non-zero, printing no result, without
CUDA or with fewer cards than the cell asks for, and if JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that the port may not use,
    compared whole (``ray_tpu_torch`` is not ``ray_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the fp8 control in the program's place "
                    "(it must come out not correct); for setting limits")
    args = ap.parse_args(argv)

    # Kernel caches at fixed paths inside the checkout, for the program's
    # kernels that build through torch or Triton (its own nvcc builds land
    # in ray_tpu_torch/_build/).
    cache = BENCH / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(BENCH), str(ROOT)]

    from bk import cli, result, spec

    cell = spec.resolve(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res, notes = cli.execute(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             T_START, control=args.control, root=ROOT)
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result.emit(res, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
