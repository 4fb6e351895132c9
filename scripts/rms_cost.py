#!/usr/bin/env python3
"""Measure what RMSNorm costs the Llama-3-8B training step on one GPU.

    python3 scripts/rms_cost.py                       # both forms
    python3 scripts/rms_cost.py --forms plain --steps 3 --report out.json

For each form of the norm (``plain``: the differentiable ``_rms_ref``
under autograd, eight eager ops forward and their autograd backward;
``kernel``: ``rms_norm``, which under autograd runs kernel K4 both ways on
the card):

1. The op alone at the training shape [2048, 4096] bf16 (B=1, S=2048,
   d_model 4096), x and w both requiring a gradient: the device time
   (torch.profiler, inputs L2-warm) of the forward and of the forward
   plus its backward, beside ``F.rms_norm``'s.
2. The train step of ``chip_smoke.phase_train`` (full Llama-3-8B, random
   weights from a seed, B=1, S=2048, remat full, AdamW) with every norm of
   the model taken by that form: the step time over ``--steps`` steps
   after 2 warm ones, then one step profiled with CPU and CUDA activity.
   Each device kernel of the profiled step is put to the norm's forward
   when the innermost enclosing norm range or autograd node evaluation
   of the op that launched it is a norm range (forward, and remat's
   recompute inside the backward), to the norm's backward when it is the
   evaluation of an autograd node that a norm's forward created (matched
   by forward thread and sequence number), else to the rest of the step.

The forms run in turns in one process on one card, so their numbers
compare.  Prints one JSON line per measurement and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

_RANGE = "rms_norm"
_EVAL = "autograd::engine::evaluate_function: "


def _forms():
    from ray_tpu_torch.ops import norms

    return {"plain": norms._rms_ref, "kernel": norms.rms_norm}


def op_alone(torch, form: str, rows: int = 2048, d: int = 4096):
    import torch.nn.functional as F

    fn = _forms()[form]
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).bfloat16()
    dy = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    eps = 1e-5
    lib = lambda x, w, eps: F.rms_norm(x, (d,), w, eps)  # noqa: E731
    out = {"form": form, "shape": [rows, d], "dtype": "bfloat16"}
    for name, f in ((form, fn), ("F.rms_norm", lib)):
        fwd = lambda: f(x, w, eps)  # noqa: E731
        both = lambda: torch.autograd.grad(f(x, w, eps), (x, w), dy)  # noqa
        out[f"{name} fwd ms"] = chip_smoke.device_ms(torch, fwd)
        out[f"{name} fwd+bwd ms"] = chip_smoke.device_ms(torch, both)
        out[f"{name} fwd kernels"] = len(chip_smoke.profile_window(
            torch, fwd, iters=1)[0])
    print("[op] " + json.dumps(out), flush=True)
    return out


def attribute(prof):
    """({"fwd", "bwd", "rest", "k4_by_name": device ms}, {"fwd", "bwd":
    kernels launched}) of one profiled window."""
    events = list(prof.events())

    def owner(e):
        p = e
        while p is not None:
            if p.name == _RANGE or p.name.startswith(_EVAL):
                return p
            p = p.cpu_parent
        return None

    # Autograd nodes created inside a norm range: (forward thread, seq nr).
    norm_nodes = set()
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(_EVAL):
            o = owner(e)
            if o is not None and o.name == _RANGE:
                norm_nodes.add((e.thread, e.sequence_nr))
    ms = {"fwd": 0.0, "bwd": 0.0, "rest": 0.0, "k4_by_name": 0.0}
    launches = {"fwd": 0, "bwd": 0}
    for e in events:
        if not e.kernels:
            continue
        o = owner(e)
        if o is None:
            kind = "rest"
        elif o.name == _RANGE:
            kind = "fwd"
        elif (o.fwd_thread, o.sequence_nr) in norm_nodes:
            kind = "bwd"
        else:
            kind = "rest"
        for k in e.kernels:
            ms[kind] += k.duration / 1e3
            if "rms_norm" in k.name:  # K4's kernels, found by name
                ms["k4_by_name"] += k.duration / 1e3
            if kind != "rest":
                launches[kind] += 1
    return ms, launches


def train_step(torch, forms, steps: int, seed: int, n_layers: int):
    import dataclasses

    from torch.profiler import ProfilerActivity, profile, record_function

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer,
                                                  make_train_step)
    from ray_tpu_torch.ops import norms

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=n_layers)
    B, S = 1, 2048
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = llama.llama_init(cfg, gen, trainable=True)
    tx = default_optimizer(lr=1e-4)
    state = TrainState.create(params, tx)
    step = make_train_step(
        lambda p, b: llama.llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    original = llama.rms_norm
    out = []
    try:
        for form in forms:
            fn = _forms()[form]

            def ranged(x, w, eps, fn=fn):
                with record_function(_RANGE):
                    return fn(x, w, eps)

            llama.rms_norm = fn
            for _ in range(2):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
            norms.rms_norm_cuda.launches = norms.rms_norm_bwd.launches = 0
            t0 = time.perf_counter()
            for _ in range(steps):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / steps
            launches = {"rms_norm": norms.rms_norm_cuda.launches,
                        "rms_norm_bwd": norms.rms_norm_bwd.launches}
            llama.rms_norm = ranged
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, _ = step(state, batch)
                torch.cuda.synchronize()
            ms, kernels = attribute(prof)
            busy = ms["fwd"] + ms["bwd"] + ms["rest"]
            rec = {"form": form, "layers": n_layers, "steps": steps,
                   "step_ms": step_ms, "loss": float(m["loss"]),
                   "launches": launches,
                   "profiled_busy_ms": busy,
                   "norm_fwd_ms": ms["fwd"], "norm_bwd_ms": ms["bwd"],
                   "norm_share": (ms["fwd"] + ms["bwd"]) / busy,
                   "k4_kernels_ms": ms["k4_by_name"],
                   "norm_fwd_kernels": kernels["fwd"],
                   "norm_bwd_kernels": kernels["bwd"]}
            print("[step] " + json.dumps(rec), flush=True)
            out.append(rec)
    finally:
        llama.rms_norm = original
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forms", default="plain,kernel")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("rms_cost: CUDA is not available", file=sys.stderr)
        return 2
    forms = args.forms.split(",")
    card = chip_smoke.card_line()
    print(f"[card] {card}", flush=True)
    report = {"card": card,
              "op": [op_alone(torch, f) for f in forms],
              "step": train_step(torch, forms, args.steps, args.seed,
                                 args.layers)}
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
