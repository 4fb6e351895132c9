"""Every ported package has the JAX package's public names: each name of a
package's ``__all__``, and each function, class and capitalised constant a
module defines at its top level (read from its source), is in the port's
twin, under the same name or the one ``RENAMES`` gives it.  The
exceptions are written out: names with no torch meaning (``JAX_ONLY``) and
names of modules not ported yet, each with its ROADMAP.md Queue 1 item
(``NOT_PORTED``).  A module of the JAX package with no twin file is the
Queue's business, not this check's."""

import ast
import dataclasses
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: JAX name -> the port's name for the same thing.
RENAMES = {
    "JaxTrainer": "TorchTrainer",          # Ray's own name for it
    "xla_ops": "mesh_ops",                 # XLA collectives -> torch's
    "use_tpu": "use_gpu",                  # ScalingConfig: {"GPU": 1}
    "jax_distributed": "torch_distributed",
    "wants_jax_distributed": "wants_torch_distributed",
    # autoscaler/gce.py: TPU slices through the TPU-VM API -> GPU slices
    # through the Compute Engine instances API (A3 machine types).
    "MockGceTpuApi": "MockGceGpuApi",
    "TpuSliceNodeProvider": "GpuSliceNodeProvider",
    "SLICE_TOPOLOGY": "SLICE_SHAPES",
    # devtools: RT010's module (a module's file name maps too, ``_twins``).
    "rules_jax": "rules_torch",
}
# Paths are not names, so they are not in the map: the scratch roots
# ``ray_tpu_*`` under the temp dir are the port's ``ray_tpu_torch_*``
# (``core/config.tmp_root``), among them the trainer's and the tuner's
# default results root, ``ray_tpu_torch_results``
# (``tests/test_torch_tune.py`` checks the tuner's).

#: Names with no torch meaning.
JAX_ONLY = {
    # parallel: named shardings and XLA's propagation; the port shards
    # parameters as DTensors and runs local shards (Spmd).
    "data_sharding", "infer_param_specs", "named_sharding",
    "with_sharding_constraint",
    # ops: the Pallas kernels' block constants and the Pallas entry point.
    "DEFAULT_BLOCK_K", "DEFAULT_BLOCK_Q", "LSE_LANES", "rms_norm_pallas",
    # models: the pytree type alias (parameters are nn.Modules).
    "Params",
    # accelerators: TPU topology helpers (GPU counts need no topology).
    "TPU_VALID_CHIP_OPTIONS", "accelerator_type", "is_valid_pod_type",
    "node_labels", "num_chips", "pod_type", "pod_worker_count", "tpu_name",
    "worker_id",
}

#: Names whose module is not ported yet, with their ROADMAP.md Queue 1
#: item (none: every module of the JAX package has its twin).
NOT_PORTED = {}

PACKAGES = ["", "models", "ops", "parallel", "collective", "rllib", "train",
            "serve", "util", "data", "tune", "dag", "workflow",
            "job_submission", "autoscaler", "devtools"]


def _expected(names):
    return {RENAMES.get(n, n) for n in names
            if n not in JAX_ONLY and n not in NOT_PORTED}


def _defined(path: pathlib.Path):
    """Public functions, classes and capitalised names a module assigns at
    its top level (imports excluded)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update(t.id for t in targets
                       if isinstance(t, ast.Name) and t.id[:1].isupper())
    return {n for n in out if not n.startswith("_")}


def _twins(pkg: str):
    """(JAX module file, port module name) of each module of ``pkg`` that
    has a twin in the port; the top level's are its own modules, a
    module's (``job_submission``) itself, and a package with no
    ``__all__`` (``workflow``) has its ``__init__``."""
    jdir = ROOT / "ray_tpu" / pkg
    tdir = ROOT / "ray_tpu_torch" / pkg
    if pkg == "":
        files = [jdir / f"{m}.py" for m in ("accelerators", "exceptions",
                                             "cluster_utils", "dashboard",
                                             "scripts")]
    elif jdir.with_suffix(".py").is_file():
        yield jdir.with_suffix(".py"), f"ray_tpu_torch.{pkg}"
        return
    else:
        files = sorted(jdir.glob("*.py"))
    own_init = not hasattr(importlib.import_module(
        ".".join(p for p in ("ray_tpu", pkg) if p)), "__all__")
    for f in files:
        if f.name == "__init__.py":
            if own_init and (tdir / f.name).exists():
                yield f, f"ray_tpu_torch.{pkg}"
        elif (tdir / f"{RENAMES.get(f.stem, f.stem)}.py").exists():
            stem = RENAMES.get(f.stem, f.stem)
            mod = ".".join(p for p in ("ray_tpu_torch", pkg, stem) if p)
            yield f, mod


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p or "top")
def test_package_names_match_jax(pkg):
    jname = ".".join(p for p in ("ray_tpu", pkg) if p)
    tname = ".".join(p for p in ("ray_tpu_torch", pkg) if p)
    jmod, tmod = importlib.import_module(jname), importlib.import_module(
        tname)
    # A module or package with no ``__all__`` is held by its definitions
    # (``_twins``).
    missing = _expected(getattr(jmod, "__all__", ())) - set(
        getattr(tmod, "__all__", ()))
    assert not missing, (tname, sorted(missing))
    for name in getattr(tmod, "__all__", ()):
        assert getattr(tmod, name) is not None, name
    twins = list(_twins(pkg))
    assert twins
    for jfile, mod in twins:
        missing = _expected(_defined(jfile)) - set(vars(
            importlib.import_module(mod)))
        assert not missing, (mod, sorted(missing))


def test_scaling_config_fields_match_jax():
    """The train configs' fields, through the renames."""
    from ray_tpu.train import config as jconfig
    from ray_tpu_torch.train import config as tconfig

    for cls in ("ScalingConfig", "RunConfig", "FailureConfig",
                "CheckpointConfig", "Result"):
        jf = [f.name for f in dataclasses.fields(getattr(jconfig, cls))]
        tf = [f.name for f in dataclasses.fields(getattr(tconfig, cls))]
        assert [RENAMES.get(n, n) for n in jf] == tf, cls
    assert hasattr(tconfig.ScalingConfig, "wants_torch_distributed")


def test_exceptions_are_really_missing():
    """Each exception names something the port does not have, so the map
    cannot hide a name that was ported since."""
    import ray_tpu_torch
    import ray_tpu_torch.accelerators as acc
    import ray_tpu_torch.util as util
    from ray_tpu_torch import ops, parallel
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention, norms
    from ray_tpu_torch.util import metrics

    spaces = [ray_tpu_torch, acc, util, ops, parallel, llama, attention,
              norms, metrics, importlib.import_module(
                  "ray_tpu_torch.parallel.sharding")]
    for name in set(JAX_ONLY) | set(NOT_PORTED):
        assert not any(name in vars(m) for m in spaces), name
    for old, new in RENAMES.items():
        assert old != new
