"""The dense decoder family (Mistral-7B's block: RMSNorm, GQA attention
with RoPE over every earlier position, SwiGLU), run through the port's
Llama path.

What the harness knows of the architecture, and nothing else does:

- the program: ``PROGRAM`` names the port's module, config class and
  model class (imported by the harness, not here, so the plain reference
  never imports the port), ``port_keys`` how the configuration's
  ``port`` keys become that config;
- the weight leaves: ``global_leaves(port)`` and ``layer_leaves(port,
  i)``, each ``(name, shape, std or None for ones)`` in draw order, named
  as the port's parameters (layer i's as ``layers.<i>.<name>``); the
  distributions are the port's ``llama_init`` ones: embedding N(0, 1),
  projections N(0, d^-1/2), down projections N(0, d_ff^-1/2);
- the counts a reader needs: ``attention_shapes`` (H, Hkv, D and a
  window, None for full, a layer), ``param_count``, ``prefill_flop``;
- ``check_config(body)``: the ``port`` keys against the published
  ``config``.

The plain reference, ``benchmarks/reference/dense.py``, is imported here
as ``reference``: the harness calls ``reference.logits_at``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from reference import dense as reference  # noqa: F401: the harness's
from reference.weights import Leaf

#: The port's module, config class and model class.
PROGRAM = ("ray_tpu_torch.models.llama", "LlamaConfig", "Llama")


def port_keys(port: Dict) -> Dict:
    """The config class's keyword arguments (the dtype aside)."""
    return dict(port)


def n_layers(port: Dict) -> int:
    return port["n_layers"]


def global_leaves(port: Dict) -> List[Leaf]:
    d, v = port["d_model"], port["vocab_size"]
    return [("embed", (v, d), 1.0),
            ("final_norm", (d,), None),
            ("lm_head", (d, v), d ** -0.5)]


def layer_leaves(port: Dict, i: int) -> List[Leaf]:
    """Layer ``i``'s leaves, relative names, in draw order (every layer
    alike)."""
    d, f = port["d_model"], port["d_ff"]
    kv = port["n_kv_heads"] * (d // port["n_heads"])
    sd, sf = d ** -0.5, f ** -0.5
    return [("attn_norm", (d,), None),
            ("attn.wq", (d, d), sd),
            ("attn.wk", (d, kv), sd),
            ("attn.wv", (d, kv), sd),
            ("attn.wo", (d, d), sd),
            ("mlp_norm", (d,), None),
            ("mlp.w1", (d, f), sd),
            ("mlp.w3", (d, f), sd),
            ("mlp.w2", (f, d), sf)]


def attention_shapes(port: Dict) -> List[Tuple[int, int, int,
                                                Optional[int]]]:
    """(H, Hkv, D, window) of each layer's attention: full, D = d / H."""
    H = port["n_heads"]
    return [(H, port["n_kv_heads"], port["d_model"] // H, None)
            ] * port["n_layers"]


def param_count(port: Dict) -> int:
    """Parameters of a dense decoder configuration (untied head)."""
    d, f, v, L = (port["d_model"], port["d_ff"], port["vocab_size"],
                  port["n_layers"])
    kv = port["n_kv_heads"] * (d // port["n_heads"])
    layer = 2 * d * d + 2 * d * kv + 2 * d + 3 * d * f
    return 2 * v * d + d + L * layer


def prefill_flop(port: Dict, n: int) -> float:
    """The training benchmarks' MFU convention (6N + 6 L S d a token) in
    forward form for a prompt of ``n`` real tokens: 2N a token plus
    causal attention, 2 L n^2 d."""
    N = param_count(port)
    return 2 * N * n + 2 * port["n_layers"] * n * n * port["d_model"]


def check_config(body: Dict) -> None:
    """Raise ValueError where a ``port`` key differs from the published
    ``config`` it stands for."""
    port, hf = body["port"], body["config"]
    pairs = {"d_model": "hidden_size", "d_ff": "intermediate_size",
             "n_layers": "num_hidden_layers",
             "n_heads": "num_attention_heads",
             "n_kv_heads": "num_key_value_heads",
             "vocab_size": "vocab_size", "rope_theta": "rope_theta",
             "norm_eps": "rms_norm_eps"}
    bad = {k: (port[k], hf[h]) for k, h in pairs.items() if port[k] != hf[h]}
    if hf.get("head_dim", port["d_model"] // port["n_heads"]) \
            != port["d_model"] // port["n_heads"]:
        bad["head_dim"] = (port["d_model"] // port["n_heads"],
                           hf["head_dim"])
    if hf.get("sliding_window") is not None:
        bad["sliding_window"] = (None, hf["sliding_window"])
    if bad:
        raise ValueError(f"{body['name']}: port keys differ from the "
                         f"published config (port, published): {bad}")
