"""The port's rtlint (``ray_tpu_torch/devtools/``) against the JAX
package's.

Every case of ``tests/test_rtlint.py`` for the rules both packages share
(RT001-RT009, RT011, RT012) runs as written, its snippets and asserts on
the JAX rule; each tree it lints is then copied with the package renamed
(``ray_tpu`` -> ``ray_tpu_torch``; the ``ray_tpu_*`` metric names stay)
and linted by the port's rule of the same name, and the two rules'
findings must be equal as (rule, path, line, message with the package
name normalised).  RT010's torch leg (``rules_torch``) has its own
positives and negatives.  Then the gate: the port's lint over
``ray_tpu_torch/`` with its allowlist reports nothing, all twelve rules
are registered, and the allowlist rejects stale entries and entries with
no reason.  The whole-tree lint runs once, in this process.
"""

import ast
import importlib
import importlib.util
import re
from pathlib import Path

import pytest

from ray_tpu_torch.devtools import rules_torch
from ray_tpu_torch.devtools.rtlint import (Project, all_rules,
                                           default_allowlist,
                                           default_package_root,
                                           load_allowlist, run_lint)

ROOT = Path(__file__).resolve().parent.parent
_JAX_TESTS = ROOT / "tests" / "test_rtlint.py"
_SHARED = {f"TestRT{i:03d}" for i in (1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12)}


def _shared_cases():
    """(class, method) of every shared-rule case of the JAX tests, read
    from the file's source."""
    tree = ast.parse(_JAX_TESTS.read_text())
    return [(cls.name, fn.name) for cls in tree.body
            if isinstance(cls, ast.ClassDef) and cls.name in _SHARED
            for fn in cls.body
            if isinstance(fn, ast.FunctionDef)
            and fn.name.startswith("test_")]


def _load_jax_tests():
    spec = importlib.util.spec_from_file_location("_jax_rtlint_cases",
                                                  _JAX_TESTS)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: ``tests/test_rtlint.py`` as a module (its classes stay out of this
#: module's namespace, so pytest does not collect them twice).
_JT = _load_jax_tests()
make_pkg = _JT.make_pkg


def _to_port(src: str) -> str:
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)


def _key(f, port: bool):
    msg = re.sub(r"\bray_tpu_torch\b", "ray_tpu", f.message) if port \
        else f.message
    return (f.rule, f.path, f.line, msg)


def _port_copy(root: Path, dest: Path) -> Path:
    """``root`` copied to ``dest/pkg`` with the package renamed."""
    out = dest / "pkg"
    for path in root.rglob("*.py"):
        target = out / path.relative_to(root)
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(_to_port(path.read_text()))
    return out


@pytest.mark.parametrize("case", _shared_cases(),
                         ids=lambda c: f"{c[0]}.{c[1]}")
def test_rules_match_jax(case, tmp_path, monkeypatch):
    jt = _JT
    seen = []
    orig = jt.findings

    def spy(root, rule):
        got = orig(root, rule)
        seen.append((Path(root), rule, got))
        return got

    monkeypatch.setattr(jt, "findings", spy)
    cls, name = case
    getattr(getattr(jt, cls)(), name)(tmp_path / "jax")
    assert seen, "the case linted nothing"
    for i, (root, rule, got) in enumerate(seen):
        mod = rule.__module__.rsplit(".", 1)[-1]
        port_rule = getattr(importlib.import_module(
            f"ray_tpu_torch.devtools.{mod}"), rule.__name__)
        port_root = _port_copy(root, tmp_path / "port" / str(i))
        want = sorted(_key(f, False) for f in got)
        have = sorted(_key(f, True) for f in port_rule(Project(port_root)))
        assert have == want


def test_shared_cases_cover_every_shared_rule():
    classes = {c for c, _ in _shared_cases()}
    assert classes == _SHARED
    assert len(_shared_cases()) >= 35


# -- RT010: the torch leg -----------------------------------------------------


def rt010(root: Path) -> list:
    return rules_torch.check_rt010(Project(root))


#: A paged program recorded through the sentinel, as models/paged.py does.
_PAGED = """
    from ..devtools import jitguard as _jitguard


    def _record(name, **tensors):
        _jitguard.bump(name, _jitguard.signature_of(tensors))


    def decode_step(pools, tokens):
        _record("decode", pools=pools)
        return tokens + 1, pools
"""


def test_rt010_flags_a_sync_in_a_hot_loop(tmp_path):
    root = make_pkg(tmp_path, {"models/paged.py": _PAGED, "serve/eng.py": """
        import numpy as np
        import torch

        from ..models.paged import decode_step


        class Engine:
            def _step(self):
                self.tokens, self.pools = decode_step(self.pools,
                                                      self.tokens)
                first = int(self.tokens[0])
                torch.cuda.synchronize()
                return first

            def loop(self, n):
                for _ in range(n):
                    self._step()


        def run(pools, tokens, steps):
            out = []
            for _ in range(steps):
                tokens, pools = decode_step(pools, tokens)
                out.append(tokens.item())
                host = np.asarray(tokens)
                out.append(tokens.to("cpu"))
            return out, host
    """})
    got = rt010(root)
    syncs = sorted((f.line, f.meta["sync"]) for f in got)
    assert [s for _, s in syncs] == [
        "int() on a device value", "torch.cuda.synchronize()",
        ".item() on a device value", "np.asarray() on a device value",
        '.to("cpu") on a device value']
    assert all(f.rule == "RT010" and f.meta["kind"] == "host_sync"
               for f in got)
    step = [f for f in got if "Engine._step" in f.message]
    assert "invoked from a loop in Engine.loop" in step[0].meta["hot_via"]


def test_rt010_sync_ok_annotation_vets_the_line(tmp_path):
    root = make_pkg(tmp_path, {"models/paged.py": _PAGED, "serve/eng.py": """
        from ..models.paged import decode_step


        def run(pools, tokens, steps):
            out = []
            for _ in range(steps):
                tokens, pools = decode_step(pools, tokens)
                toks = tokens.cpu().numpy()  # rt-sync-ok: THE step's readback
                out.append(int(toks[0]))  # host data: derived from a sync
            return out
    """})
    assert rt010(root) == []


def test_rt010_post_loop_readback_is_clean(tmp_path):
    root = make_pkg(tmp_path, {"models/paged.py": _PAGED, "serve/eng.py": """
        from ..models.paged import decode_step


        def run(pools, tokens, steps):
            for _ in range(steps):
                tokens, pools = decode_step(pools, tokens)
            return tokens.tolist(), float(tokens.sum())
    """})
    assert rt010(root) == []


def test_rt010_learner_program_guard(tmp_path):
    """A learner's update is a program through a guard class held in
    ``self`` (rllib/learner.py's ``Program``): a per-minibatch ``.item()``
    is flagged, the post-epoch readback is not."""
    root = make_pkg(tmp_path, {"rllib/learner.py": """
        from ..devtools import jitguard


        class Program:
            def __init__(self, name):
                self.name = name
                jitguard.register_program(name)

            def __call__(self, batch):
                jitguard.bump(self.name, {})


        class Learner:
            def __init__(self):
                self._program = Program("update")

            def _update(self, mb):
                self._program(mb)
                return mb["loss"] * 2

            def fit(self, batches):
                losses = []
                for mb in batches:
                    aux = self._update(mb)
                    losses.append(aux.item())
                last = self._update(batches[-1])
                return losses, float(last)
    """})
    got = rt010(root)
    assert [(f.meta["sync"], "Learner.fit" in f.message) for f in got] == [
        (".item() on a device value", True)]


def test_rt010_host_values_are_not_syncs(tmp_path):
    """Host data in a hot loop (a host function's return, a plain list)
    is not a device value."""
    root = make_pkg(tmp_path, {"models/paged.py": _PAGED, "serve/eng.py": """
        from ..models.paged import decode_step


        def run(pools, tokens, lens, steps, env):
            for i in range(steps):
                tokens, pools = decode_step(pools, tokens)
                reward = env.step(i)
                total = float(reward) + int(lens[i])
            return total
    """})
    assert rt010(root) == []


# -- allowlist ----------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "test_suppression_and_stale_detection", "test_reason_is_mandatory"])
def test_allowlist_matches_jax(name, tmp_path, monkeypatch):
    """The JAX tests' allowlist cases (a suppressed finding beside a stale
    entry; an entry with no reason) on the port's ``run_lint`` and
    ``load_allowlist``."""
    monkeypatch.setattr(_JT, "run_lint", run_lint)
    monkeypatch.setattr(_JT, "load_allowlist", load_allowlist)
    getattr(_JT.TestAllowlist(), name)(tmp_path)


# -- the gate: the port's package must lint clean -----------------------------


_gate = {}


def _package_lint():
    if "result" not in _gate:
        root = default_package_root()
        _gate["result"] = run_lint(root, default_allowlist(root))
    return _gate["result"]


def test_package_lint_clean():
    """The self-check: rtlint over ``ray_tpu_torch/`` with its allowlist
    reports nothing."""
    assert default_package_root() == ROOT / "ray_tpu_torch"
    kept, suppressed = _package_lint()
    assert kept == [], "unallowlisted rtlint findings:\n" + "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in kept)
    # The two vetted RT004 patterns (the JAX package's two entries).
    assert {(f.rule, f.path.rsplit("/", 2)[-2]) for f in suppressed} == {
        ("RT004", "data"), ("RT004", "serve")}


def test_allowlist_entries_have_reasons():
    entries, problems = load_allowlist(
        default_allowlist(default_package_root()))
    assert problems == []
    assert entries and all(e.reason for e in entries)
    assert all(e.line is None or e.line > 0 for e in entries)


def test_gate_covers_all_twelve_rules():
    names = [r.__name__ for r in all_rules()]
    assert names == [f"check_rt{i:03d}" for i in range(1, 13)]
    assert all_rules()[9] is rules_torch.check_rt010


def test_rt010_finds_the_engine_readbacks_unvetted():
    """With every ``# rt-sync-ok:`` stripped, RT010 over the port flags
    exactly the serving engine's two vetted readbacks (the prefill's first
    token and the decode step's batched tokens)."""
    project = Project(default_package_root())
    for m in project.modules:
        m.source = re.sub(r"#\s*rt-sync-ok:.*", "", m.source)
    got = rules_torch.check_rt010(project)
    assert [(f.path, f.meta["sync"]) for f in got] == [
        ("ray_tpu_torch/serve/engine.py", "int() on a device value"),
        ("ray_tpu_torch/serve/engine.py", ".cpu() on a device value")]
    assert "InferenceEngine._prefill" in got[0].message
    assert "InferenceEngine._run_step" in got[1].message
