"""The PyTorch port stands alone: nothing under ``ray_tpu_torch/`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and its entry points
refuse to fall back to the CPU silently."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top in _FORBIDDEN


def test_port_imports_neither_jax_nor_ray_tpu():
    files = _port_files()
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imports(p) if _forbidden(m)]
    assert not bad, bad


def test_import_leaves_ray_tpu_unloaded():
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.ops, "
            "ray_tpu_torch.models.generate, ray_tpu_torch.models.paged, "
            "ray_tpu_torch.models.train_state, ray_tpu_torch.ops.losses, "
            "ray_tpu_torch.serve.engine; "
            "print(sorted(m for m in sys.modules if m == 'ray_tpu' "
            "or m.startswith('ray_tpu.')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_missing_cuda(monkeypatch):
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_init(cfg, device="cuda")
    params = llama_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(cfg, params, EngineConfig(prefix_cache=False))
