"""Find the highest rate an open-loop serving cell sustains: one engine,
the cell's mix at each rate in turn, each for ``--seconds`` after a
lead-in, reporting the tokens delivered, the TTFT tail and whether the
wait queue grew through the window (a growing backlog is past the knee).
Used once to set a mix's ``rate_per_s``; the benchmark's runs do not call
it.

    python3 benchmarks/knee.py --workload serve_mistral7b_chat \\
        --rates 2.5,3,3.5,4 --seconds 40 --seed 7
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--lead", type=float, default=None,
                    help="lead-in seconds (default: the mix's)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from bk import serve, spec, traffic
    from bk.program import build_model, port_config
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    cell = spec.resolve(args.workload)
    mix, config = dict(cell.mix), cell.config
    dev = torch.device("cuda", 0)
    engine = InferenceEngine(port_config(cell.family, config),
                             build_model(cell.family, config, args.seed,
                                         dev),
                             EngineConfig(**mix["engine"]), device=dev)
    serve.warm(engine, mix)
    for rate in [float(r) for r in args.rates.split(",")]:
        mix["rate_per_s"] = rate
        lead = float(mix["lead_s"] if args.lead is None else args.lead)
        reqs = traffic.requests(mix, args.seed, config["port"]["vocab_size"],
                                lead_s=lead, seconds=args.seconds)
        clients = [serve.Client(r) for r in reqs]
        t0 = time.perf_counter()
        ws, we = t0 + lead, t0 + lead + args.seconds
        sent, senders = serve._drive_open(engine, clients, mix, t0, we,
                                          False)
        queue = []
        while time.perf_counter() < we:
            time.sleep(0.5)
            if time.perf_counter() >= ws:
                queue.append(engine.stats()["queued"])
        due = [c for c in list(sent) if ws <= c.due < we]
        time.sleep(2.0)
        ttft = [(c.times[0] - c.due) if c.times else float("inf")
                for c in due]
        toks = sum(1 for c in sent for t in c.times if ws <= t <= we)
        third = len(queue) // 3
        print(json.dumps({
            "rate": rate, "due": len(due),
            "tokens_per_s": toks / args.seconds,
            "ttft_p50_ms": serve.nearest_rank(ttft, 50) * 1e3,
            "ttft_p90_ms": serve.nearest_rank(ttft, 90) * 1e3,
            "queue_by_third": [float(np.mean(queue[i * third:(i + 1) * third]))
                               for i in range(3)],
            "queue_end": queue[-1]}), flush=True)
        for t in senders:
            t.join()
        for c in list(sent):
            if c.thread is not None and c.thread.is_alive():
                c.stream.cancel()
        for c in list(sent):
            if c.thread is not None:
                c.thread.join(timeout=30)
        while engine.stats()["active_seqs"] or engine.stats()["queued"]:
            time.sleep(0.1)
    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
