#!/usr/bin/env python3
"""Time the Llama-3-8B train step under every remat policy on one GPU,
in turns, to show the spread between runs.

    python3 scripts/remat_steps.py                  # two rounds
    python3 scripts/remat_steps.py --rounds 3 --report out.json

Runs ``chip_smoke.phase_train`` (full Llama-3-8B, random weights from a
seed, B=1, S=2048, remat full, AdamW) for the model and optimizer state,
then ``--rounds`` times ``chip_smoke.phase_remat`` on that state: ``full``, ``save_attn``, ``save_dots``, ``save_dots_no_batch``
and ``xla_cse`` in turn, each with 1 warm and 3 timed steps (step time,
MFU, peak memory, allocator retries, SM clock, launches checked) and one
profiled step (device busy, idle share, time by kernel kind).  Prints the
card's name and power limit and one JSON line per round.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("remat_steps: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {chip_smoke.card_line()}", flush=True)
    report = {"card": chip_smoke.card_line()}
    cfg, tokens, state = chip_smoke.phase_train(torch, report, args.seed)
    rounds = []
    for i in range(args.rounds):
        deferred = chip_smoke.phase_remat(torch, report, cfg, state, tokens)
        if deferred:
            print(f"remat_steps: {deferred} do not fit; see "
                  f"chip_smoke.phase_remat_shallow", file=sys.stderr)
            return 1
        rounds.append(report["remat"])
        print(f"[round {i}] " + json.dumps({
            p: {k: r[k] for k in ("step_ms", "mfu", "peak_gb",
                                  "device_busy_ms", "idle_share")}
            for p, r in report["remat"].items()}), flush=True)
    report["rounds"] = rounds
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(report["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
