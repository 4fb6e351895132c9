"""What decides ``correct``, shown to fail: each tiny cell runs on the CPU
through the whole harness with the timed path broken underneath, under
its real cell's limits, and ``correct`` must come out false; the sound
run beside it must come out true.  So must the control: the reference put
in the program's place in float8, judged by the same result line."""

import time

import pytest
import torch

from bk import cli, spec

SEED = 2**31 + 41


def _run(root, cell, seconds=2.0, control=False):
    c = spec.resolve(cell, root)
    return cli.execute(c, SEED, seconds, False, torch.device("cpu"),
                       time.perf_counter(), control=control, root=root)


def _wrap_decode(monkeypatch, fault):
    from ray_tpu_torch.serve import engine

    real = engine.paged_decode_step

    def broken(config, params, pools, adapters, tokens, page_tables,
               seq_lens, active, temps, adapter_ids, key):
        if fault == "half":
            # Half the batch left out: the step runs on the first half of
            # the slots; the rest keep their token and their length.
            h = tokens.shape[0] // 2
            toks, lens, key, pools = real(
                config, params, pools, adapters, tokens[:h],
                page_tables[:h], seq_lens[:h], active[:h], temps[:h],
                adapter_ids[:h], key)
            return (torch.cat([toks, tokens[h:].to(toks.dtype)]),
                    torch.cat([lens, seq_lens[h:].to(lens.dtype)]), key,
                    pools)
        toks, lens, key, pools = real(config, params, pools, adapters,
                                      tokens, page_tables, seq_lens, active,
                                      temps, adapter_ids, key)
        if fault == "token":      # a token altered where it is produced
            toks = (toks + 1) % config.vocab_size
        elif fault == "state":    # the step's state returned unchanged
            lens = seq_lens.to(lens.dtype)
        return toks, lens, key, pools

    monkeypatch.setattr(engine, "paged_decode_step", broken)


@pytest.mark.parametrize("cell", ["t_chat", "t_docs"])
@pytest.mark.parametrize("fault", ["token", "half", "state"])
def test_serving_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    _wrap_decode(monkeypatch, fault)
    res, notes = _run(tiny_root, cell)
    assert not res["correct"], (res["checks"], notes)
    assert res["checks"]["logit_gap"]["value"] > \
        res["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", ["t_chat", "t_docs"])
def test_serving_sound(tiny_root, cell):
    res, notes = _run(tiny_root, cell)
    assert res["correct"], (res["checks"], notes)
    assert notes["readings"]["served_tokens"] >= 10


@pytest.mark.parametrize("cell", ["t_chat", "t_docs"])
def test_serving_control_is_not_correct(tiny_root, cell):
    """``--control``: the fp8 control's first tokens in the program's
    place; the result line itself reads ``correct`` false."""
    res, notes = _run(tiny_root, cell, control=True)
    assert not res["correct"], (res["checks"], notes)
    r = notes["readings"]
    assert res["checks"]["logit_gap"]["value"] == r["logit_gap"] > \
        res["checks"]["logit_gap"]["limit"] >= r["program_logit_gap"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["serve_mistral7b_chat",
                                  "serve_mistral7b_docs"])
def test_control_fails_on_the_card(card, cell):
    """At the cell's own size on an H100, on three seeds: the run with
    the fp8 control in the program's place reads ``correct`` false, and
    the program's own gap, read in the same run, is under the limit
    (``run.py --control``; about 2.5 minutes a run)."""
    import json
    import subprocess
    import sys

    from conftest import ROOT

    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        p = subprocess.run(
            [sys.executable, "benchmarks/run.py", "--workload", cell,
             "--seed", str(seed), "--seconds", "51", "--trace", "0",
             "--control"], cwd=ROOT, capture_output=True, text=True,
            timeout=900)
        assert p.returncode == 0, p.stderr[-4000:]
        notes = next(json.loads(line[6:]) for line in p.stderr.splitlines()
                     if line.startswith("notes "))
        res = json.loads(p.stdout.strip().splitlines()[-1])
        limit = res["checks"]["logit_gap"]["limit"]
        assert not res["correct"]
        assert res["checks"]["logit_gap"]["value"] > limit
        assert notes["readings"]["program_logit_gap"] <= limit
