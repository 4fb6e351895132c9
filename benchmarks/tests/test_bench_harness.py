"""The harness on the CPU: every cell resolves by name, the yardstick
against hand counts, the generators repeat for a seed, the result line's
shape, the trace's reduction, and the benchmark's imports."""

import ast
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT

from bk import cli, spec, trace as tr, traffic, yardstick as ys

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    c = spec.resolve(cell)
    assert c.kind in cli.DRIVERS
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.layer_reader(m["name"]))
        assert m["moves"] in e2e
    lim = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert lim["limits"]


@pytest.mark.parametrize("config", SPEC["configs"],
                         ids=lambda c: c["name"])
def test_config_files(config):
    """The file matches its entry, and its family's ``check_config``
    finds its ``port`` keys equal to the published ``config``."""
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["source"] == config["source"]
    assert sorted(body["reduced"]) == sorted(config["reduced"])
    spec.family(body["family"]).check_config(body)


def test_a_new_mix_is_a_file(tiny_root):
    """A cell added from a temporary root (new config, new mix, new entry)
    resolves and runs with no change to the harness."""
    cell = spec.resolve("t_docs", tiny_root)
    assert cell.mix["clients"] == 3 and cell.config["name"] == "tiny"


def test_yardstick_hand_counts():
    # K1 at [1, 32, 2048, 128], causal: two products of 2*S*S*D over the
    # causal half, 32 heads (PERF.md's kernel table: 34.4 GFLOP).
    f, b = ys.attention_fwd(1, 32, 8, 2048, 128)
    assert f == 2 * 2 * 32 * 2048 * 2048 * 128 / 2
    assert b == 2 * 2048 * 128 * (2 * 32 + 2 * 8) + 4 * 32 * 2048
    assert ys.min_time(f, b) == f / 989e12
    # A short call is bound by its bytes.
    f, b = ys.attention_fwd(1, 32, 8, 16, 128)
    assert ys.min_time(f, b) == b / 3.35e12
    # A sliding window of 1024 over 4096 causal positions: the band of
    # that width under the diagonal.
    f, _ = ys.attention_fwd(1, 32, 4, 4096, 128, window=1024)
    assert f == 2 * 2 * 32 * 128 * (4096 * 4096 / 2 - 3072 * 3072 / 2)
    assert ys.attention_fwd(1, 32, 4, 1024, 128, window=1024) == \
        ys.attention_fwd(1, 32, 4, 1024, 128)
    mistral = json.loads((BENCH / "configs" / "mistral7b.json").read_text())
    dense = spec.family(mistral["family"])
    # Mistral-7B-v0.3's published count.
    assert dense.param_count(mistral["port"]) == 7_248_023_552
    assert dense.prefill_flop(mistral["port"], 100) == \
        2 * 7_248_023_552 * 100 + 2 * 32 * 100 * 100 * 4096
    assert dense.attention_shapes(mistral["port"]) == [(32, 8, 128, None)] * 32


def test_traffic_repeats_for_a_seed():
    mix = json.loads((BENCH / "traffic" / "chat.json").read_text())
    lead, secs = mix["lead_s"], SPEC["run_seconds"]
    a = traffic.requests(mix, 2**31 + 5, 32768, lead, secs)
    b = traffic.requests(mix, 2**31 + 5, 32768, lead, secs)
    c = traffic.requests(mix, 12345, 32768, lead, secs)
    assert [r.due for r in a] == [r.due for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    # Another seed: the same arrivals and, block by block, the same sizes
    # in another order.
    assert [r.due for r in a] == [r.due for r in c]
    step = mix["block_s"]
    for t in np.arange(0, lead + secs, step):
        def block(rs):
            return sorted((r.prompt.size, r.max_new) for r in rs
                          if t <= r.due < t + step)
        assert block(a) == block(c)
    assert [r.prompt.size for r in a] != [r.prompt.size for r in c]
    # The window offers the stated rate, the lead-in too.
    due = np.array([r.due for r in a])
    assert np.all(np.diff(due) >= 0)
    assert ((due >= lead).sum() ==
            round(mix["rate_per_s"] * step) * (secs // step)
            + round(mix["rate_per_s"] * (secs % step)))
    assert (due < lead).sum() == round(mix["rate_per_s"] * lead)
    lo, hi = mix["prompt_len"]["min"], mix["prompt_len"]["max"]
    assert all(lo <= r.prompt.size <= hi for r in a)
    assert all(r.prompt.min() >= 1 and r.prompt.max() < 32768 for r in a)


def test_closed_loop_blocks():
    """Closed loop: every block of ``block`` requests holds the same sizes
    for every seed, in another order."""
    mix = json.loads((BENCH / "traffic" / "docs.json").read_text())
    size = mix["block"]
    a = traffic.requests(mix, 2**31 + 6, 32768, n=5 * size + 3)
    c = traffic.requests(mix, 99, 32768, n=5 * size + 3)
    assert len(a) == len(c) == 5 * size + 3
    for i in range(0, 5 * size, size):
        assert sorted((r.prompt.size, r.max_new) for r in a[i:i + size]) \
            == sorted((r.prompt.size, r.max_new) for r in c[i:i + size])
    assert [r.prompt.size for r in a] != [r.prompt.size for r in c]


def test_weights_repeat():
    from reference import weights

    cfg = json.loads((BENCH / "configs" / "mistral7b.json").read_text())
    cfg = dict(cfg, port=dict(cfg["port"], d_model=64, n_heads=4,
                              n_kv_heads=2, d_ff=96, vocab_size=128))
    fam = spec.family(cfg["family"])
    a = weights.layer_weights(fam, cfg, 2**31 + 9, 3, "cpu")
    b = weights.layer_weights(fam, cfg, 2**31 + 9, 3, "cpu")
    c = weights.layer_weights(fam, cfg, 2**31 + 9, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["attn.wq"], c["attn.wq"])
    assert a["attn.wq"].dtype == torch.bfloat16
    assert torch.equal(a["attn_norm"], torch.ones(64, dtype=torch.bfloat16))


def test_trace_reduction():
    ops = [("void k1<a>(int)", 0.0, 1.0), ("k2", 0.5, 2.0),
           ("k1<a>", 3.0, 4.0), ("Memcpy DtoH", 6.0, 6.5)]
    assert tr.busy_s(ops, 0.0, 10.0) == 3.5
    assert tr.busy_s(ops, 1.5, 3.5) == 1.0
    gaps = dict(tr.idle_gaps(ops, 0.0, 10.0))
    assert gaps == {"before k1<a>": 1.0, "before Memcpy DtoH": 2.0,
                    "window end": 3.5}
    top = tr.top_ops(ops)
    assert top[0] == ["k1<a>", 2.0]


def _forbidden(path: Path, names):
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            found.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            found.add(str(node.args[0].value).split(".")[0])
    return sorted(found & set(names))


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH) for p in
                                        BENCH.rglob("*.py")), ids=str)
def test_no_jax_imports(path):
    """Compared by whole top-level name: ray_tpu_torch is allowed, ray_tpu
    is not; the reference imports nothing of the program either."""
    banned = ["jax", "jaxlib", "flax", "ray_tpu"]
    if path.parts[0] == "reference":
        banned.append("ray_tpu_torch")
    assert _forbidden(BENCH / path, banned) == []


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (BENCH / "families").glob("*.py")))
def test_program_families_are_the_port(name):
    """Each family file names a module of the port, and imports none of
    it itself (the harness imports it), so the reference never does."""
    module, *classes = spec.family(name).PROGRAM
    assert module.split(".")[0] == "ray_tpu_torch" and len(classes) == 2
    assert _forbidden(BENCH / "families" / f"{name}.py",
                      ["ray_tpu_torch"]) == []


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA here: run.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to measure: non-zero exit, no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", ["t_chat", "t_docs"])
def test_result_line_shape(tiny_root, cell, traced):
    """A tiny cell through the whole run on the CPU: the line's keys, the
    metrics of the cell's kind, ``checks`` last, and a sound run is
    correct."""
    c = spec.resolve(cell, tiny_root)
    res, notes = cli.execute(c, 2**31 + 77, 2.0, bool(traced),
                             torch.device("cpu"), time.perf_counter(),
                             root=tiny_root)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"], (res["checks"], notes)
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    assert set(res["metrics"]) <= want
    if not traced:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    json.loads(json.dumps(res))
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in res["device"] and "window_s" in res["device"]


def test_a_stream_starting_late_reads_as_pending(monkeypatch):
    """While a request's consumer thread is still starting, the client
    shows no thread, which the wait for first tokens reads as pending; a
    thread shown before it runs would read as a stream that has ended,
    and a request sent as the window closes would count as failed."""
    import threading

    from bk import serve

    real = threading.Thread

    class SlowStart(real):
        def start(self):
            time.sleep(0.5)
            super().start()

    class Engine:
        def submit(self, prompt, max_new, temperature):
            return iter([7])

    c = serve.Client(traffic.Request(due=0.0, prompt=np.ones(3, np.int32),
                                     max_new=1))
    monkeypatch.setattr(serve.threading, "Thread", SlowStart)
    sender = real(target=serve._submit,
                  args=(Engine(), c, {"temperature": 0.0}, False))
    sender.start()
    time.sleep(0.2)
    pending = c.thread is None or c.thread.is_alive()
    sender.join()
    c.thread.join()
    assert pending and c.tokens == [7] and c.done


def test_the_first_token_wait_outlasts_the_trace_stop(tiny_root, tmp_path,
                                                      monkeypatch):
    """A profiler's stop that holds the engine back for longer than the
    mix's ``first_token_wait_s``: the requests due in the window's last
    0.3 s are admitted only once it ends, and still get their first
    tokens, since the wait runs from the stop's end."""
    import shutil
    import threading

    from bk import serve
    from ray_tpu_torch.serve import engine

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    mix = root / "benchmarks" / "traffic" / "tinychat.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   first_token_wait_s=6)))
    cell = spec.resolve("t_chat", root)
    seconds, held = 2.0, threading.Event()
    close = {}

    def gated(real):
        def call(*a, **k):
            if time.perf_counter() > close.get("at", math.inf):
                held.wait()
            return real(*a, **k)
        return call

    for name in ("paged_prefill", "paged_decode_step"):
        monkeypatch.setattr(engine, name, gated(getattr(engine, name)))
    start, stop = serve.DeviceTrace.start, serve.DeviceTrace.stop

    def start_(self):
        close["at"] = time.perf_counter() + cell.mix["lead_s"] \
            + seconds - 0.3
        start(self)

    def stop_(self, window=None):
        time.sleep(7.0)
        stop(self, window=window)
        held.set()

    monkeypatch.setattr(serve.DeviceTrace, "start", start_)
    monkeypatch.setattr(serve.DeviceTrace, "stop", stop_)
    res, notes = cli.execute(cell, 2**31 + 91, seconds, True,
                             torch.device("cpu"), time.perf_counter(),
                             root=root)
    assert held.is_set()
    assert res["failed"] == 0 and res["correct"], (res, notes)


@pytest.mark.card
def test_one_cell_on_the_card(card):
    """The first cell as the driver runs it (python3 -m pytest
    benchmarks/tests -m card, on an H100)."""
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed",
                        str(2**31 + 3), "--seconds", "10", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
