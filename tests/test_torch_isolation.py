"""The PyTorch port stands alone: nothing under ``ray_tpu_torch/`` (nor
``chip_smoke.py``) imports JAX or the JAX package or names one of its
modules in a string, its runtime's workers load neither, a JAX cluster and
a port cluster run side by side on one host, and its entry points refuse
to fall back to the CPU silently."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import _torch_runtime_scenarios as sc

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


#: A ``ray_tpu.`` module path (``ray_tpu_torch.`` is the port's own).
_JAX_MODULE = re.compile(r"\bray_tpu\.")


def test_port_strings_name_no_jax_module():
    """Module paths in strings (``-m ray_tpu.core.zygote``, lazy imports by
    name, docstrings) must be the port's: a string naming a ``ray_tpu.``
    module would start or load the JAX package's code."""
    bad = []
    for p in _port_files():
        tree = ast.parse(p.read_text(), filename=str(p))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and _JAX_MODULE.search(node.value):
                bad.append((str(p.relative_to(ROOT)), node.lineno))
    assert not bad, bad


def test_runtime_modules_import_without_ray_tpu_or_torch():
    """The runtime core imports neither package, and not torch either: the
    worker zygote imports it before it forks."""
    mods = ["ray_tpu_torch", "ray_tpu_torch.accelerators",
            "ray_tpu_torch.cluster_utils", "ray_tpu_torch.exceptions",
            "ray_tpu_torch._native", "ray_tpu_torch.devtools.locks",
            "ray_tpu_torch.util.netfault", "ray_tpu_torch.util.gangrec",
            "ray_tpu_torch.util.health"] + sorted(
        "ray_tpu_torch.core." + p.stem
        for p in (ROOT / "ray_tpu_torch" / "core").glob("*.py")
        if p.stem != "__init__")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'ray_tpu', 'torch')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(mods) > 25


def test_port_and_jax_clusters_side_by_side():
    """A JAX cluster and a port cluster at once on one host: each serves
    its own tasks, the port's workers load no JAX and no ``ray_tpu``, and
    each package's shared-memory segments carry its own prefix."""
    ref, got = sc.run_pair("port_imports")
    assert got["loaded"] == []
    assert "ray_tpu" in ref["loaded"]
    assert got["tasks"] == [[i, "ray_tpu_torch"] for i in range(8)]
    assert ref["tasks"] == [[i, "ray_tpu"] for i in range(8)]
    from ray_tpu.core import object_store as jstore
    from ray_tpu_torch.core import object_store as tstore
    from ray_tpu_torch.core.ids import ObjectID

    oid = ObjectID.from_random()
    assert tstore._seg_path("s", oid).startswith("/dev/shm/rtpt-s-")
    assert jstore._seg_path("s", oid).startswith("/dev/shm/rtpu-s-")
    assert tstore._pool_dir("s") != jstore._pool_dir("s")


def test_port_and_jax_init_in_one_process():
    """``ray_tpu.init()`` exports ``RT_ADDRESS``; a following
    ``ray_tpu_torch.init()`` in the same process still starts and serves
    its own head, and each package's workers load only that package."""
    got = sc.result(sc.run("both_in_one", "ray_tpu_torch"))
    assert got["jax_address"] and got["port_address"]
    assert got["jax_address"] != got["port_address"]
    assert got["in_process_heads"] == [True, True]
    assert got["sessions_differ"]
    assert got["jax_worker"] == ["ray_tpu"]
    assert got["port_worker"] == ["ray_tpu_torch"]
    assert got["port_nodes"] == 1
    assert got["left_after"] == [None, None]


def test_scratch_roots_follow_tmpdir(tmp_path):
    """Every file the port's runtime writes outside ``/dev/shm`` (the
    address file, spill, logs, the function cache) lies under the temp
    dir that ``TMPDIR`` names, in the driver and in its workers."""
    code = (
        "import json, os, ray_tpu_torch as rt\n"
        "from ray_tpu_torch.core import config, node_main\n"
        "rt.init(num_cpus=1)\n"
        "def roots():\n"
        "    from ray_tpu_torch.core.config import get_config, tmp_root\n"
        "    return [get_config().spill_dir, tmp_root('fncache')]\n"
        "out = {'driver': [config.get_config().spill_dir, node_main.LOG_ROOT,"
        " config.address_file()], 'worker': rt.get(rt.remote(roots).remote()),"
        " 'address': os.environ['RT_TORCH_ADDRESS']}\n"
        "rt.shutdown()\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    paths = got["driver"] + got["worker"]
    assert all(p.startswith(str(tmp_path) + os.sep) for p in paths), paths
    assert all("ray_tpu_torch" in p for p in paths), paths
    assert (tmp_path / "ray_tpu_torch" / "latest_address").read_text() \
        == got["address"]
    assert any((tmp_path / "ray_tpu_torch_logs").iterdir())


def test_import_leaves_ray_tpu_unloaded():
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.ops, "
            "ray_tpu_torch.models.generate, ray_tpu_torch.models.paged, "
            "ray_tpu_torch.models.train_state, ray_tpu_torch.models.moe, "
            "ray_tpu_torch.models.mlp, ray_tpu_torch.ops.losses, "
            "ray_tpu_torch.serve.engine, ray_tpu_torch.util.metrics, "
            "ray_tpu_torch.util.tracing, ray_tpu_torch.util.steprec, "
            "ray_tpu_torch.util.devmem, ray_tpu_torch.util.profiling, "
            "ray_tpu_torch.util.trace_analysis, "
            "ray_tpu_torch.devtools.jitguard, ray_tpu_torch.parallel, "
            "ray_tpu_torch.collective.mesh_ops, "
            "ray_tpu_torch.ops.ring_attention, ray_tpu_torch.rllib, "
            "ray_tpu_torch.serve.api, ray_tpu_torch.serve.controller, "
            "ray_tpu_torch.serve.replica, ray_tpu_torch.serve.handle; "
            "print(sorted(m for m in sys.modules if m == 'ray_tpu' "
            "or m.startswith('ray_tpu.')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_serve_imports_neither_jax_nor_ray_tpu():
    """``ray_tpu_torch.serve`` (reached lazily from the package, as
    ``ray_tpu.serve`` is) and each module of the serving front load no JAX
    and no ``ray_tpu``; gRPC loads only when its ingress starts."""
    mods = ["api", "batching", "config", "controller", "engine",
            "grpc_ingress", "handle", "multiplex", "replica",
            "adapter_pool", "prefix_cache"]
    code = ("import sys, ray_tpu_torch as rt\n"
            "serve = rt.serve\n"
            + "".join(f"import ray_tpu_torch.serve.{m}\n" for m in mods)
            + "print(serve.__name__, sorted(m for m in sys.modules if "
              "m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'grpc')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ray_tpu_torch.serve", "[]"]


def test_serve_apps_side_by_side():
    """A serve app of each package at once on one host: two heads, two
    controllers, two HTTP ingresses, each answering its own deployment;
    the port's replica loads no JAX and no ``ray_tpu``."""
    import _torch_serve_scenarios as ssc

    ref, got = ssc.run_pair("side_by_side")
    assert got["http"] == [200, {"x": 3, "pkg": "ray_tpu_torch",
                                 "loaded": []}]
    assert ref["http"][0] == 200 and ref["http"][1]["pkg"] == "ray_tpu"
    assert "ray_tpu" in ref["http"][1]["loaded"]


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

    # The data path's device copy, and (in a port cluster with no card) a
    # default TorchTrainer trial and iter_batches to a CUDA device.
    import numpy as np

    import _torch_data_scenarios as dsc
    from ray_tpu_torch.data.iterator import device_prefetch

    for dev in ("cuda", True):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(device_prefetch(iter([{"x": np.arange(3)}]), dev))
    out = dsc.result(dsc.run(["no_card"], "ray_tpu_torch",
                             {"RT_GPUS": None, "CUDA_VISIBLE_DEVICES": None}),
                     240)["no_card"]
    assert out == {"gpus": 0.0, "trial": ["ERROR", True], "cuda": True,
                   "true": True, "shard": True}


def test_data_and_tune_import_without_pyarrow_pandas_pil():
    """The card's machine has no pyarrow, pandas or PIL: the port's data
    and tune import without them, and numpy blocks, batches and the
    device copy need none of them."""
    code = (
        "import sys\n"
        "class Hide:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pyarrow', 'pandas', 'PIL'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Hide())\n"
        "import numpy as np\n"
        "import ray_tpu_torch.data as d, ray_tpu_torch.tune as t\n"
        "from ray_tpu_torch.data.block import Block\n"
        "from ray_tpu_torch.data.iterator import (batches_from_blocks,\n"
        "                                          device_prefetch)\n"
        "from ray_tpu_torch.data.dataset import _coerce_batch_out\n"
        "b = Block.from_batch({'x': np.arange(5)})\n"
        "assert not b.is_arrow and b.num_rows == 5\n"
        "out = list(device_prefetch(batches_from_blocks(iter([b]), 2),\n"
        "                           'cpu'))\n"
        "assert [o['x'].tolist() for o in out] == [[0, 1], [2, 3], [4]]\n"
        "try:\n"
        "    _coerce_batch_out(3)\n"
        "except TypeError:\n"
        "    pass\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('pyarrow', 'pandas', 'PIL')]\n"
        "print('ok', bad, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "[]", "False"]
