"""A model family is files: ``families/<family>.py`` and
``reference/<family>.py``.  The harness (``bk/``) names none; a second
family, its configuration, mix, limits and cell, added as new files and
entries, runs its tiny cell to ``correct``; the dense family's weights and
reference read what they read before they moved into its files; and the
prefill readers take their counts from the family."""

import hashlib
import json
import re
import shutil
import time

import pytest
import torch

from conftest import BENCH, ROOT, TINY_PORT

from bk import cli, result, spec, trace as tr

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

#: A second family for the test: the dense block with its head size given
#: in ``port`` (the port's Llama needs it to be d / H), and a layer kind
#: chosen by the layer's index: every third layer draws its norms'
#: weights from N(0, 0.1) instead of taking ones.
FAMILY = '''
"""Test family: dense, head size given, norms drawn on every third layer."""
from math import prod

from reference import densehd as reference  # noqa: F401

PROGRAM = ("ray_tpu_torch.models.llama", "LlamaConfig", "Llama")


def port_keys(port):
    keys = dict(port)
    if keys.pop("head_dim") * keys["n_heads"] != keys["d_model"]:
        raise ValueError("the port's Llama takes head_dim = d / H")
    return keys


def n_layers(port):
    return port["n_layers"]


def global_leaves(port):
    d, v = port["d_model"], port["vocab_size"]
    return [("embed", (v, d), 1.0), ("final_norm", (d,), None),
            ("lm_head", (d, v), d ** -0.5)]


def kind(i):
    return "drawn_norms" if i % 3 == 2 else "plain"


def layer_leaves(port, i):
    d, f, D = port["d_model"], port["d_ff"], port["head_dim"]
    q, kv = port["n_heads"] * D, port["n_kv_heads"] * D
    norm = 0.1 if kind(i) == "drawn_norms" else None
    return [("attn_norm", (d,), norm), ("attn.wq", (d, q), d ** -0.5),
            ("attn.wk", (d, kv), d ** -0.5), ("attn.wv", (d, kv), d ** -0.5),
            ("attn.wo", (q, d), q ** -0.5), ("mlp_norm", (d,), norm),
            ("mlp.w1", (d, f), d ** -0.5), ("mlp.w3", (d, f), d ** -0.5),
            ("mlp.w2", (f, d), f ** -0.5)]


def attention_shapes(port):
    return [(port["n_heads"], port["n_kv_heads"], port["head_dim"], None)
            ] * port["n_layers"]


def param_count(port):
    n = sum(prod(s) for _, s, _ in global_leaves(port))
    return n + sum(prod(s) for i in range(port["n_layers"])
                   for _, s, _ in layer_leaves(port, i))


def prefill_flop(port, n):
    q = port["n_heads"] * port["head_dim"]
    return 2 * param_count(port) * n + 2 * port["n_layers"] * n * n * q


def check_config(body):
    if body["port"]["head_dim"] != body["config"]["head_dim"]:
        raise ValueError("head_dim")
'''

#: Its plain reference: the dense block with D from ``head_dim``; the
#: layer kinds differ only in their weights, which it is handed.
REFERENCE = '''
"""Test family's plain reference."""
import torch
import torch.nn.functional as F

from reference.model import FP32, attention, rms_norm, rope


def block(cfg, w, x, prec):
    H, Hkv, D, eps = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                      cfg["norm_eps"])
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    outs = []
    for b in range(x.shape[0]):
        h = rms_norm(x[b], w["attn_norm"], eps)
        q = prec.mm(h, w["attn.wq"]).view(S, H, D).transpose(0, 1)
        k = prec.mm(h, w["attn.wk"]).view(S, Hkv, D).transpose(0, 1)
        v = prec.mm(h, w["attn.wv"]).view(S, Hkv, D).transpose(0, 1)
        o = attention(rope(q, pos, cfg["rope_theta"]),
                      rope(k, pos, cfg["rope_theta"]), v, prec)
        outs.append(prec.mm(o.transpose(0, 1).reshape(S, H * D),
                            w["attn.wo"]))
    x = x + torch.stack(outs)
    h = rms_norm(x, w["mlp_norm"], eps)
    return x + prec.mm(F.silu(prec.mm(h, w["mlp.w1"]))
                       * prec.mm(h, w["mlp.w3"]), w["mlp.w2"])


@torch.no_grad()
def logits_at(cfg, layer_w, glob, seqs, rows, prec=FP32):
    xs = [glob["embed"][s.long()][None] for s in seqs]
    for i in range(cfg["n_layers"]):
        w = layer_w(i)
        xs = [block(cfg, w, x, prec) for x in xs]
    return [prec.mm(rms_norm(x[0, r], glob["final_norm"], cfg["norm_eps"]),
                    glob["lm_head"]) for x, r in zip(xs, rows)]
'''


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "benchmarks").rglob("*")
            if p.is_file() and not {"__pycache__", "_cache"} & set(p.parts)}


def test_a_new_family_is_files(tiny_root, tmp_path, monkeypatch):
    """A second family (its family file, its reference, a configuration, a
    mix, a limits file and a cell entry) added to a copy of the benchmark
    runs its tiny cell on the CPU to ``correct``, its per-layer metrics
    from its own counts; every file that was there is byte for byte the
    repository's, and every entry of BENCHMARK.json is as it was, but for
    the cell's name added to the metrics' ``workloads``."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    before = _files(root)
    bench = root / "benchmarks"
    (bench / "families" / "densehd.py").write_text(FAMILY)
    (bench / "reference" / "densehd.py").write_text(REFERENCE)
    # A run of this root has its ``benchmarks/`` on the path; this process
    # imported the repository's ``reference`` package.
    import reference
    monkeypatch.setattr(reference, "__path__",
                        [str(bench / "reference"), *reference.__path__])
    port = dict(TINY_PORT, head_dim=TINY_PORT["d_model"]
                // TINY_PORT["n_heads"])
    (bench / "configs" / "tinyhd.json").write_text(json.dumps({
        "name": "tinyhd", "source": "tiny", "family": "densehd",
        "dtype": "float32", "config": {"head_dim": port["head_dim"]},
        "reduced": {}, "assumed": {}, "port": port}))
    shutil.copy(bench / "traffic" / "tinychat.json",
                bench / "traffic" / "tinyhd.json")
    shutil.copy(bench / "limits" / "serve_mistral7b_chat.json",
                bench / "limits" / "t_hd.json")
    sp = json.loads((root / "BENCHMARK.json").read_text())
    sp["configs"].append({"name": "tinyhd", "source": "tiny",
                          "file": "benchmarks/configs/tinyhd.json",
                          "reduced": [], "why": "t"})
    sp["workloads"].append({"name": "t_hd", "config": "tinyhd",
                            "traffic": "tinyhd", "chips": 1, "why": "t"})
    for m in sp["end_to_end"] + sp["per_layer"]:
        if "serve_mistral7b_chat" in m.get("workloads", ()):
            m["workloads"].append("t_hd")
    (root / "BENCHMARK.json").write_text(json.dumps(sp))

    cell = spec.resolve("t_hd", root)
    assert cell.family.kind(2) != cell.family.kind(1)
    spec.family("densehd", root).check_config(cell.config)
    res, notes = cli.execute(cell, 2**31 + 55, 2.0, True,
                             torch.device("cpu"), time.perf_counter(),
                             root=root)
    assert res["correct"], (res["checks"], notes)
    assert notes["readings"]["served_tokens"] >= 10
    assert res["metrics"]["prefill_mfu.serve"]["value"] > 0

    repo = _files(ROOT)
    after = _files(root)
    for rel, data in before.items():
        assert after[rel] == data
        if rel in repo:
            assert data == repo[rel], rel
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        new = {e["name"]: e for e in sp[key]}
        for e in SPEC[key]:
            got = dict(new[e["name"]])
            if "workloads" in e:
                assert got.pop("workloads")[:len(e["workloads"])] \
                    == e["workloads"]
                e = {k: v for k, v in e.items() if k != "workloads"}
            assert got == e


def test_an_unknown_family_names_its_path(tiny_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    path = root / "benchmarks" / "configs" / "tiny.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    family="nosuch")))
    want = str(root / "benchmarks" / "families" / "nosuch.py")
    with pytest.raises(FileNotFoundError, match=re.escape(want)):
        spec.resolve("t_chat", root)
    with pytest.raises(FileNotFoundError, match=re.escape(want)):
        spec.family("nosuch", root)


@pytest.mark.parametrize("path", sorted(
    p.name for p in (BENCH / "bk").glob("*.py")))
def test_the_harness_names_no_family(path):
    text = (BENCH / "bk" / path).read_text()
    assert re.findall(r"dense|llama|LlamaConfig", text, re.I) == []


@pytest.mark.parametrize("config", SPEC["configs"],
                         ids=lambda c: c["name"])
def test_family_counts_agree_with_its_leaves(config):
    """Each configuration's family counts the parameters its leaves hold,
    gives one attention shape a layer, and counts a prefill's FLOP as at
    least 2N a token."""
    body = json.loads((ROOT / config["file"]).read_text())
    fam = spec.family(body["family"])
    port = body["port"]
    leaves = fam.global_leaves(port) + [
        lf for i in range(fam.n_layers(port))
        for lf in fam.layer_leaves(port, i)]
    total = sum(torch.Size(shape).numel() for _, shape, _ in leaves)
    assert fam.param_count(port) == total
    assert len(fam.attention_shapes(port)) == fam.n_layers(port)
    assert fam.prefill_flop(port, 64) >= 2 * total * 64


def _digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def test_dense_digests_as_before_the_family_files():
    """The tiny configuration's globals, layer 3 and the reference's
    logits at one seed and prompt, on the CPU, read the digests they read
    when the leaves and the block lived in ``reference/weights.py`` and
    ``reference/model.py``: the same draws, bit for bit."""
    from reference import weights
    from reference.model import no_tf32

    cfg = {"name": "tiny", "family": "dense", "dtype": "float32",
           "port": TINY_PORT}
    fam = spec.family("dense")
    seed = 2**31 + 9
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        glob = weights.global_weights(fam, cfg, seed, "cpu")
        assert _digest(glob) == ("435afddaedcb2d0bb9de8a86b78ca87f"
                                 "d6079e23ce3f7509daaa9dbef502025b")
        assert _digest(weights.layer_weights(fam, cfg, seed, 3, "cpu")) == (
            "3d16d3d595b2e9b7916de151ab87a51ebe7b011c1dc53bd2cff4c8bac9d67887")
        toks = (torch.arange(40) * 37 + 5) % TINY_PORT["vocab_size"]
        with no_tf32():
            lg = fam.reference.logits_at(
                TINY_PORT, lambda i: weights.layer_weights(fam, cfg, seed, i,
                                                           "cpu"),
                glob, [toks], [torch.arange(20, 40)])
    finally:
        torch.set_num_threads(threads)
    assert _digest({"logits": lg[0]}) == (
        "91a09358174ce31c50d7f4e47a7a978640ba7b4425dd2ed22173b4a130d4a13d")


def _prefill(start, end, n=100, bucket=128):
    return {"name": "engine:prefill", "start": start, "end": end,
            "attrs": {"prompt_len": n, "bucket": bucket}}


def _run(spans, ops=()):
    body = json.loads((BENCH / "configs" / "mistral7b.json").read_text())
    return result.Run(kind="serve", config=body, mix={}, ops=list(ops),
                      t0=0.0, t1=10.0, spans=spans, steps=[],
                      family=spec.family(body["family"]))


def test_prefill_mfu_leaves_out_a_prefill_cut_by_the_window():
    """Two prefills inside [0, 10] s count; one that starts before the
    window and one that ends after it (the profiler's stop stretches it)
    are left out."""
    read = spec.layer_reader("prefill_mfu.serve")
    inside = [_prefill(1.0, 1.5), _prefill(4.0, 4.25, n=300)]
    run = _run(inside + [_prefill(-0.2, 0.3), _prefill(9.8, 70.0, n=900)])
    port, fam = run.config["port"], run.family
    want = ((fam.prefill_flop(port, 100) + fam.prefill_flop(port, 300))
            / 0.75 / run.yardstick.PEAK_BF16_FLOPS * 100)
    assert read(run) == pytest.approx(want, rel=1e-12)
    assert read(_run(inside)) == read(run)
    assert read(_run([_prefill(9.8, 70.0)])) is None


def test_attn_roofline_takes_the_family_shapes():
    """One prefill whose span holds one ``flash_fwd`` a layer: the least
    time of 32 calls at Mistral's (32, 8, 128) and the bucket, over their
    device time."""
    read = spec.layer_reader("attn_roofline.serve")
    ops = [(f"void flash_fwd_kernel<{i}>", 1.0 + i * 0.01,
            1.0 + i * 0.01 + 0.001) for i in range(32)]
    run = _run([_prefill(0.9, 1.5, bucket=2048)], ops)
    ys = run.yardstick
    want = 32 * ys.min_time(*ys.attention_fwd(1, 32, 8, 2048, 128)) \
        / tr.busy_s(ops, 0.0, 10.0) * 100
    assert read(run) == pytest.approx(want, rel=1e-9)
    assert read(_run([_prefill(0.9, 1.5, bucket=2048)], ops[:31])) is None
