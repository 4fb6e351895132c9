"""The serving cells: the program's ``InferenceEngine`` driven through
``submit`` and its ``TokenStream``s by the mix's clients, timed from the
clients' side, then checked against the plain reference.

Timeline of a run: weights from the seed, the engine, one warm-up prompt
per prefill bucket the mix can reach (and a decode): that is the set-up,
``setup_s``.  Then the traffic: ``lead_s`` of load that is not measured,
so the window opens on a full batch (a fixed wait, left out of
``setup_s`` so that a change to the set-up shows), then ``--seconds`` of
window.  Requests due in the window count;
after it closes the run waits for each one's first token (an answer that
comes late is late, not missing), then cancels what is left and shuts the
engine down.

End-to-end metrics, from the clients' clock:
- ``ttft_p90_ms``: 90th percentile (nearest rank) over every request due
  in the window of its first token's arrival minus the time it was due
  (open loop) or sent (closed loop); a failed request counts as missing.
- ``output_tokens_per_s``: tokens that reached a client in the window,
  over the window.

The clients' inter-token gaps (every gap between consecutive tokens of
one request whose later token arrived in the window) go to the per-layer
readers (``itl_p95_ms.serve``) and, as their 50th and 95th percentiles, to
the notes.

``correct``: a sample of the finished requests, drawn from the seed with
the longest among them, goes through the fp32 reference of the cell's
model family (``reference/<family>.py``): each served token's reference
logit must lie within the limit of the reference's best at its position
(the widest such gap is compared).  Greedy traffic only.
With ``--control`` the fp8 control is put in the program's place: at each
position of the same prompts and served tokens, the token it puts first
is judged in the same way, and its gap is the ``logit_gap`` that the
result line compares (the program's own goes to the notes).
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bk import traffic
from bk.program import build_model, port_config
from bk.trace import DeviceTrace
from reference.model import FP8, no_tf32
from reference.weights import global_weights, group_seed, layer_weights


class Client:
    """One request as a client sees it."""

    def __init__(self, req: traffic.Request):
        self.req = req
        self.due = 0.0          # perf_counter time it was due or sent
        self.sent = 0.0
        self.times: List[float] = []
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        self.done = False
        self.stream = None
        self.thread: Optional[threading.Thread] = None

    def consume(self) -> None:
        try:
            for tok in self.stream:
                self.times.append(time.perf_counter())
                self.tokens.append(tok)
            self.done = len(self.tokens) == self.req.max_new
        except Exception as e:  # noqa: BLE001: a failed request is data
            self.error = repr(e)[:200]


def nearest_rank(values: List[float], pct: float) -> float:
    if not values:
        return float("nan")
    v = sorted(values)
    return v[max(0, math.ceil(pct / 100.0 * len(v)) - 1)]


def _submit(engine, c: Client, mix: Dict, traced: bool) -> None:
    from ray_tpu_torch.util import tracing

    c.sent = time.perf_counter()
    try:
        if traced:
            with tracing.trace("bench:request", force=True):
                c.stream = engine.submit(c.req.prompt, c.req.max_new,
                                         temperature=mix["temperature"])
        else:
            c.stream = engine.submit(c.req.prompt, c.req.max_new,
                                     temperature=mix["temperature"])
    except Exception as e:  # noqa: BLE001: shed at submit is data
        c.error = repr(e)[:200]
        return
    # Published only once started: the wait for first tokens reads a
    # thread that is set but not alive as a stream that has ended.
    t = threading.Thread(target=c.consume, daemon=True)
    t.start()
    c.thread = t


def warm(engine, mix: Dict) -> None:
    """One prompt per prefill bucket the mix's prompt lengths reach, with
    two new tokens each so the decode program runs too."""
    lo, hi = mix["prompt_len"]["min"], mix["prompt_len"]["max"]
    buckets = engine.config.prefill_buckets()

    def bucket_of(n: int) -> int:
        return next(b for b in buckets if b >= n)

    for b in buckets:
        if bucket_of(lo) <= b <= bucket_of(hi):
            n = min(b, hi)
            for _ in engine.submit(np.ones((n,), np.int32),
                                   max_new_tokens=2):
                pass


def _drive_open(engine, clients: List[Client], mix: Dict, start: float,
                end: float, traced: bool) -> List[Client]:
    """Send each request at its due time until the window's end, on a
    thread of its own; returns the list it fills and the thread."""
    sent: List[Client] = []

    def sender():
        for c in clients:
            c.due = start + c.req.due
            if c.due >= end:
                return
            wait = c.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            _submit(engine, c, mix, traced)
            sent.append(c)

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    return sent, [t]


def _drive_closed(engine, pool: List[Client], mix: Dict, start: float,
                  end: float, traced: bool):
    """``clients`` callers, each sending its next request when the last
    ends, until the window's end; returns the list of requests sent and
    the callers."""
    lock = threading.Lock()
    sent: List[Client] = []
    it = iter(pool)

    def caller():
        while time.perf_counter() < end:
            with lock:
                c = next(it, None)
                if c is None:
                    return
                sent.append(c)
            c.due = time.perf_counter()
            _submit(engine, c, mix, traced)
            if c.thread is not None:
                c.thread.join()

    callers = [threading.Thread(target=caller, daemon=True)
               for _ in range(int(mix["clients"]))]
    for t in callers:
        t.start()
    return sent, callers


def _sample(done: List[Client], mix: Dict, seed: int) -> List[Client]:
    """Finished requests for the check: the longest, then others in an
    order drawn from the seed, until ``min_tokens`` served tokens or
    ``max_requests`` requests."""
    if not done:
        return []
    chk = mix["check"]
    longest = max(done, key=lambda c: c.req.prompt.size + len(c.tokens))
    rest = [c for c in done if c is not longest]
    rng = np.random.default_rng(group_seed(seed, "sample"))
    out = [longest]
    for i in rng.permutation(len(rest)):
        if (sum(len(c.tokens) for c in out) >= chk["min_tokens"]
                or len(out) >= chk["max_requests"]):
            break
        out.append(rest[i])
    return out


def check(family, config: Dict, seed: int, sample: List[Client], device,
          control: bool = False) -> Dict[str, float]:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position; with ``control``, that of the
    token the fp8 control puts first at each position, with the program's
    own as ``program_logit_gap``."""
    port = config["port"]
    seqs, rows = [], []
    for c in sample:
        n = c.req.prompt.size
        toks = np.concatenate([c.req.prompt, np.asarray(c.tokens[:-1],
                                                        np.int32)])
        seqs.append(torch.as_tensor(toks, device=device))
        rows.append(torch.arange(n - 1, n - 1 + len(c.tokens),
                                 device=device))
    glob = {k: v.float() for k, v in global_weights(family, config, seed,
                                                    device).items()}

    def layer_w(i):
        return {k: v.float() for k, v in layer_weights(
            family, config, seed, i, device).items()}

    logits_at = family.reference.logits_at
    with no_tf32():
        logits = logits_at(port, layer_w, glob, seqs, rows)
        out = {"logit_gap": 0.0, "served_tokens": 0}
        for c, lg in zip(sample, logits):
            served = torch.as_tensor(c.tokens, device=device).long()
            gap = lg.max(-1).values - lg.gather(-1, served[:, None])[:, 0]
            out["logit_gap"] = max(out["logit_gap"], float(gap.max()))
            out["served_tokens"] += len(c.tokens)
        if control:
            low = logits_at(port, layer_w, glob, seqs, rows, FP8())
            worst = 0.0
            for lg, lw in zip(logits, low):
                pick = lw.argmax(-1)
                gap = lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]
                worst = max(worst, float(gap.max()))
            out["program_logit_gap"] = out["logit_gap"]
            out["logit_gap"] = worst
    return out


def occupancy(steps: List[Dict[str, Any]], t0: float, t1: float
              ) -> Dict[str, float]:
    """Mean busy slots, KV pages in use and queue length over the step
    records that ended in [t0, t1] (wall-clock seconds)."""
    rs = [r for r in steps if t0 <= r["t"] <= t1]
    if not rs:
        return {}
    total = rs[0]["pages_used"] + rs[0]["pages_free"]
    return {"steps": len(rs),
            "slots_busy_mean": float(np.mean([r["occupancy"] for r in rs])),
            "slots": rs[0]["slots"],
            "pages_used_mean": float(np.mean([r["pages_used"] for r in rs])),
            "pages_used_max": max(r["pages_used"] for r in rs),
            "pages_total": total,
            "queued_mean": float(np.mean([r["queued"] for r in rs]))}


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False) -> Dict[str, Any]:
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    from ray_tpu_torch.util import steprec, tracing

    mix, config, family = cell.mix, cell.config, cell.family
    cfg = port_config(family, config)
    phases = {"imports_s": time.perf_counter() - t_start}
    params = build_model(family, config, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["weights_s"] = time.perf_counter() - t_start
    engine = InferenceEngine(cfg, params, EngineConfig(**mix["engine"]),
                             seed=group_seed(seed, "engine") % (1 << 62),
                             device=device)
    phases["engine_s"] = time.perf_counter() - t_start
    warm(engine, mix)
    phases["warm_s"] = time.perf_counter() - t_start
    lead = float(mix["lead_s"])
    vocab = config["port"]["vocab_size"]
    if mix["kind"] == "open_loop":
        reqs = traffic.requests(mix, seed, vocab, lead_s=lead,
                                seconds=seconds)
    else:
        reqs = traffic.requests(mix, seed, vocab,
                                n=int(mix["clients"]) * 64 + 256)
    clients = [Client(r) for r in reqs]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace = DeviceTrace(device) if traced else None
    if trace is not None:
        trace.start()
    steprec.drain_buffered()
    tracing.drain_buffered()

    t0 = time.perf_counter()
    wall0 = time.time() - t0
    ws, we = t0 + lead, t0 + lead + seconds
    setup_s = t0 - t_start
    drive = _drive_open if mix["kind"] == "open_loop" else _drive_closed
    sent, senders = drive(engine, clients, mix, t0, we, traced)
    time.sleep(max(0.0, we - time.perf_counter()))
    if trace is not None:
        trace.stop(window=(ws + wall0, we + wall0))
    steps = steprec.drain_buffered()
    # Every request due in the window gets its first token, or fails.  The
    # wait runs from the window's close or, on a traced run, from the end
    # of the profiler's stop, which can outlast the wait and holds the
    # engine back while it runs.
    due = [c for c in list(sent) if ws <= c.due < we]
    deadline = (max(we, time.perf_counter())
                + float(mix["first_token_wait_s"]))
    while time.perf_counter() < deadline and any(
            not c.times and c.error is None
            and (c.thread is None or c.thread.is_alive()) for c in due):
        time.sleep(0.05)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    for c in list(sent):
        if c.stream is not None and c.thread is not None \
                and c.thread.is_alive():
            c.stream.cancel()
    engine.shutdown()
    for t in senders:
        t.join(timeout=10)
    for c in list(sent):
        if c.thread is not None:
            c.thread.join(timeout=10)
    spans = tracing.drain_buffered()

    ttft = [(c.times[0] - c.due) if c.times else math.inf for c in due]
    gaps = []
    tokens_in = 0
    for c in sent:
        for i, t in enumerate(c.times):
            if ws <= t <= we:
                tokens_in += 1
                if i > 0:
                    gaps.append(t - c.times[i - 1])
    failed = sum(1 for c in due if not c.times)
    metrics = {
        "ttft_p90_ms": nearest_rank(ttft, 90) * 1e3,
        "output_tokens_per_s": tokens_in / seconds,
    }
    done = [c for c in sent if c.done]
    sample = _sample(done, mix, seed)

    del engine, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = (check(family, config, seed, sample, device, control)
                if sample else {})
    return {
        "setup_s": setup_s,
        "metrics": metrics,
        "attempted": len(due),
        "failed": failed,
        "readings": readings,
        "memory_peak_bytes": peak,
        "trace": trace,
        "layer_input": {"kind": "serve", "spans": spans, "steps": steps,
                        "gaps": gaps},
        "notes": {"requests_due": len(due), "sent": len(sent),
                  "finished": len(done),
                  "send_late_max_s": max([c.sent - c.due for c in due],
                                         default=0.0),
                  "ttft_p50_ms": nearest_rank(ttft, 50) * 1e3,
                  "itl_p50_ms": nearest_rank(gaps, 50) * 1e3,
                  "itl_p95_ms": nearest_rank(gaps, 95) * 1e3,
                  "sample_requests": len(sample), "lead_s": lead,
                  "failed_errors": [c.error for c in due if not c.times][:5],
                  "setup_phases": phases,
                  "window": occupancy(steps, ws + wall0, we + wall0)},
    }
