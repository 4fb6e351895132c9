"""Shared set-up of the benchmark's tests: the harness on the path, a
marker for tests that need the card, and a temporary root holding the
real benchmark plus tiny cells that run on the CPU.

    python3 -m pytest benchmarks/tests -q          # here, on the CPU
    python3 -m pytest benchmarks/tests -q -m card  # on an H100
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

#: The tiny stand-ins of the real cells (same mixes' kinds and checks).
#: Deep enough, and checked over enough served tokens, that the fp8
#: control's widest gap clears the real limits as it does at full size
#: (0.42-0.59 at this size on six seeds of random weights, on the CPU).
TINY_PORT = {"vocab_size": 4096, "d_model": 128, "n_layers": 8,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 256, "max_seq": 128,
             "rope_theta": 10000.0, "norm_eps": 1e-5}
TINY_CELLS = {"serve_mistral7b_chat": "t_chat",
              "serve_mistral7b_docs": "t_docs"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA H100 (skips without CUDA)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the H100")
    return torch.device("cuda", 0)


def _tiny_mixes():
    def load(name):
        return json.loads((BENCH / "traffic" / f"{name}.json").read_text())

    chat = load("chat")
    chat.update(rate_per_s=20, lead_s=0.5,
                prompt_len={"median": 16, "sigma": 0.5, "min": 4, "max": 48},
                output_len={"median": 10, "sigma": 0.5, "min": 4,
                            "max": 20},
                engine={"batch_slots": 8, "page_size": 8,
                        "max_prompt_len": 48, "max_new_tokens_cap": 20,
                        "prefix_cache": False, "max_queue": 512},
                check={"min_tokens": 400, "max_requests": 80},
                first_token_wait_s=20)
    docs = load("docs")
    docs.update(clients=3, lead_s=1,
                prompt_len={"median": 24, "sigma": 0.4, "min": 8, "max": 60},
                output_len={"median": 8, "sigma": 0.5, "min": 4, "max": 16},
                engine={"batch_slots": 3, "page_size": 8,
                        "max_prompt_len": 64, "max_new_tokens_cap": 16,
                        "prefix_cache": False, "max_queue": 16},
                check={"min_tokens": 400, "max_requests": 80},
                first_token_wait_s=20)
    return {"tinychat": chat, "tinydocs": docs}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with tiny cells beside the real ones, each
    tiny cell under its real cell's limits: new configurations, mixes and
    cells are files and entries only."""
    root = tmp_path_factory.mktemp("bench_root")
    shutil.copytree(BENCH, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfgs = root / "benchmarks" / "configs"
    tiny = {"name": "tiny", "source": "tiny", "family": "dense",
            "dtype": "float32", "config": {}, "reduced": {}, "assumed": {},
            "port": TINY_PORT}
    (cfgs / "tiny.json").write_text(json.dumps(tiny))
    spec["configs"].append({"name": "tiny", "source": "tiny",
                            "file": "benchmarks/configs/tiny.json",
                            "reduced": [], "why": "t"})
    for name, mix in _tiny_mixes().items():
        (root / "benchmarks" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    mixes = {"t_chat": "tinychat", "t_docs": "tinydocs"}
    lim = root / "benchmarks" / "limits"
    for real, tiny in TINY_CELLS.items():
        spec["workloads"].append({"name": tiny, "config": "tiny",
                                  "traffic": mixes[tiny], "chips": 1,
                                  "why": "t"})
        shutil.copy(lim / f"{real}.json", lim / f"{tiny}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
