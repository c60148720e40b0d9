# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, graftlint (``analysis/``) against the reference's:

1. Every rule test of the reference's ``tests/test_analysis.py`` that
   lints a synthetic tree runs here with its ``lint`` helper standing for
   BOTH linters: each tree goes through the reference's ``run_graftlint``
   and the port's, the findings (rule, file, line, severity, message)
   must be identical, and the reference test's own assertions then hold
   on them. The lock graph, the CLI, lockwatch and the exit codes run the
   reference's cases against the port's modules.
2. The torch forms of two rules: draws from torch's global generator and
   ``torch.manual_seed`` (``graft-unseeded-rng``); a captured CUDA graph's
   body, a host loop replaying a graph, and ``.cpu()``/``.numpy()``/
   ``synchronize()`` (``graft-host-sync-in-loop``) — positives and the
   clean idioms the port uses.
3. The package gate: both linters return no finding over the port, whose
   inline suppressions are at most 10, each with a reason.
4. The smoke-test preflight refuses a planted bad tree
   (``TPU_SMOKETEST_LINT_DIR``) before any device or world comes up, and
   an unreadable tree does not block the run.
"""

import inspect
import json
import os
import textwrap

import pytest
import test_analysis as ref_tests
import torch.distributed as dist

from nvidia_terraform_modules_tpu.analysis import (
    run_graftlint as ref_graftlint,
)
from nvidia_terraform_modules_tpu.analysis.lockgraph import (
    build_lock_graph as ref_lock_graph,
)
from nvidia_terraform_modules_tpu.analysis.pysrc import (
    PyContext as RefContext,
)
from nvidia_terraform_modules_tpu_torch import analysis
from nvidia_terraform_modules_tpu_torch.analysis import (
    Finding,
    PyContext,
    exit_code,
    lockwatch,
    run_graftlint,
)
from nvidia_terraform_modules_tpu_torch.analysis.__main__ import main
from nvidia_terraform_modules_tpu_torch.analysis.graftlint import RULES
from nvidia_terraform_modules_tpu_torch.analysis.lockgraph import (
    build_lock_graph,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nvidia_terraform_modules_tpu_torch")


def _key(findings):
    return [(f.rule, f.where, f.severity, f.message) for f in findings]


def _unmodule(text: str) -> str:
    # the catalog hint names each package's own CLI module
    return text.replace("nvidia_terraform_modules_tpu_torch.",
                        "nvidia_terraform_modules_tpu.")


def _both(tmp_path, files, overrides=None):
    """The reference's ``lint`` helper, through both linters: the same
    tree, identical findings (or the same refusal), the reference's
    findings returned."""
    root = tmp_path / "src"
    for rel, body in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))

    def run(fn):
        try:
            return fn(str(root), rel_to=str(tmp_path), overrides=overrides)
        except ValueError as exc:
            return exc

    ref, port = run(ref_graftlint), run(run_graftlint)
    if isinstance(ref, Exception):
        assert type(port) is type(ref)
        assert _unmodule(str(port)) == str(ref)
        raise ref
    assert _key(port) == _key(ref), (files, _key(port), _key(ref))
    return ref


def _both_graphs(ctx):
    """The reference's ``build_lock_graph`` through both modules."""
    port = build_lock_graph(PyContext(ctx.root, ctx.rel_to))
    ref = ref_lock_graph(ctx)
    assert (port.nodes, port.edges, port.cycles()) == \
        (ref.nodes, ref.edges, ref.cycles())
    return ref


def _ref_cases(pred):
    return [name for name, fn in vars(ref_tests).items()
            if name.startswith("test_") and callable(fn) and pred(fn)]


_LINT_CASES = _ref_cases(lambda fn: "lint(tmp_path" in inspect.getsource(fn))
# the reference's cases of the lock graph, the CLI, lockwatch and the exit
# codes, run against the port's modules
_MODULE_CASES = [
    "test_lockgraph_condition_aliases_its_lock", "test_cli_exit_codes",
    "test_cli_json_and_sarif", "test_cli_bad_severity_is_a_diagnostic",
    "test_cli_rules_listing", "test_exit_code_shared_semantics",
    *_ref_cases(lambda fn: fn.__name__.startswith("test_lockwatch_")),
]


def _call(fn, tmp_path, capsys):
    kw = {"tmp_path": tmp_path, "capsys": capsys}
    return fn(**{p: kw[p] for p in inspect.signature(fn).parameters})


def test_every_reference_rule_case_is_covered():
    """Each rule has reference trees among the parametrised cases."""
    assert len(_LINT_CASES) >= 38
    sources = [inspect.getsource(getattr(ref_tests, name))
               for name in _LINT_CASES]
    for rule in RULES:
        assert any(f'"{rule}"' in src for src in sources), rule


@pytest.mark.parametrize("case", _LINT_CASES)
def test_reference_trees_give_identical_findings(case, tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.setattr(ref_tests, "lint", _both)
    _call(getattr(ref_tests, case), tmp_path, capsys)


@pytest.mark.parametrize("case", _MODULE_CASES)
def test_reference_module_cases_on_the_port(case, tmp_path, capsys,
                                            monkeypatch):
    monkeypatch.setattr(ref_tests, "build_lock_graph", _both_graphs)
    monkeypatch.setattr(ref_tests, "PyContext", RefContext)
    monkeypatch.setattr(ref_tests, "graft_main", main)
    monkeypatch.setattr(ref_tests, "RULES", RULES)
    monkeypatch.setattr(ref_tests, "lockwatch", lockwatch)
    monkeypatch.setattr(ref_tests, "exit_code", exit_code)
    monkeypatch.setattr(ref_tests, "Finding", Finding)
    _call(getattr(ref_tests, case), tmp_path, capsys)


def test_the_rule_catalog_is_the_references():
    from nvidia_terraform_modules_tpu.analysis import list_rules as ref_rules

    assert [(r.id, r.severity, r.family, r.summary)
            for r in analysis.list_rules()] == \
        [(r.id, r.severity, r.family, r.summary) for r in ref_rules()]


def test_lockwatch_names_port_locks_by_package_path():
    """A lock created in a port module is named by its path in the port
    package (the fleet chaos test selects the port's locks so); one
    created elsewhere by its file's name."""
    import threading

    from nvidia_terraform_modules_tpu_torch.telemetry.core import Counter

    with lockwatch.armed(guard_sleep=False) as watch:
        counter = Counter("c")
        here = threading.Lock()
    with here:
        counter.inc()
    names = sorted(watch.lock_names)
    assert [n.rsplit(":", 1)[0] for n in names] == [
        "nvidia_terraform_modules_tpu_torch/telemetry/core.py",
        "test_torch_analysis.py"]
    assert watch.cycles() == []


# ======================================================= the torch forms

def _lint(tmp_path, files):
    """The port's findings on a synthetic tree, and the reference's (which
    knows no torch form)."""
    return _split(tmp_path, files, run_graftlint), \
        _split(tmp_path, files, ref_graftlint)


def _split(tmp_path, files, fn):
    root = tmp_path / "src"
    for rel, body in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
    return [(f.rule, f.where) for f in fn(str(root), rel_to=str(tmp_path))]


def test_torch_global_generator_draws_are_flagged(tmp_path):
    port, ref = _lint(tmp_path, {"m.py": """\
        import torch
        from torch import randn

        a = torch.rand(3)
        b = randn(3, device="cuda")
        c = torch.randint(0, 5, (3,))
        d = torch.randperm(4)
        e = torch.multinomial(torch.ones(4), 2, generator=None)
        f = torch.normal(0.0, 1.0, (3,))
        g = torch.bernoulli(torch.ones(3) / 2)
        h = torch.rand_like(a)
        i = torch.randn_like(a)
        j = torch.randint_like(a, 5)
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        """})
    assert port == [("graft-unseeded-rng", f"src/m.py:{n}")
                    for n in (4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15)]
    assert ref == []


def test_torch_generator_draws_are_clean(tmp_path):
    port, _ = _lint(tmp_path, {"m.py": """\
        import torch

        def draw(seed, device):
            gen = torch.Generator(device=device).manual_seed(seed)
            x = torch.randn((4, 4), generator=gen, device=device)
            perm = torch.randperm(4, generator=gen)
            idx = torch.multinomial(x.softmax(-1), 1, generator=gen)
            return x, perm, idx, torch.empty(3).normal_(generator=gen)
        """})
    assert port == []


def test_sync_inside_a_captured_graph_is_flagged(tmp_path):
    port, ref = _lint(tmp_path, {"m.py": """\
        import torch

        def capture(step, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = step(x)
                n = y.sum().item()
                host = y.cpu()
                torch.cuda.synchronize()
                flag = bool(y.any())
            return g, n, host, flag
        """})
    assert port == [("graft-host-sync-in-loop", f"src/m.py:{n}")
                    for n in (7, 8, 9, 10)]
    assert ref == []


def test_sync_in_a_replay_loop_is_flagged(tmp_path):
    port, ref = _lint(tmp_path, {"m.py": """\
        import torch

        def serve(graph, tokens, waves, done):
            out = []
            for _ in range(waves):
                graph.replay()
                out.append(tokens.cpu())
                if tokens.numpy()[0] == done:
                    break
                torch.cuda.current_stream().synchronize()
            return out
        """})
    assert port == [("graft-host-sync-in-loop", f"src/m.py:{n}")
                    for n in (7, 8, 10)]
    assert ref == []


def test_replay_loops_that_read_after_the_loop_are_clean(tmp_path):
    port, _ = _lint(tmp_path, {"m.py": """\
        import torch

        def serve(graph, tokens, waves):
            hist = []
            for _ in range(waves):
                graph.replay()
                hist.append(tokens.clone())
            return torch.stack(hist).cpu()

        def capture(step, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = step(x)
            torch.cuda.synchronize()
            return g, y

        def host_loop(rows):
            return [r.cpu() for r in rows]
        """})
    assert port == []


def test_a_suppression_with_a_reason_covers_a_torch_form(tmp_path):
    port, _ = _lint(tmp_path, {"m.py": """\
        def serve(graph, tokens, waves):
            for _ in range(waves):
                graph.replay()
                # graftlint: ignore[graft-host-sync-in-loop] — exact eos
                tok = tokens.cpu()
            return tok
        """})
    assert port == []


# ===================================================== the package gate

@pytest.fixture(scope="module")
def port_scan():
    """The port package's one real scan here (the port's linter), with
    its context for the suppression audit."""
    ctx = PyContext(PKG)
    return run_graftlint(PKG, ctx=ctx), ctx


def test_the_port_is_clean_under_its_own_linter(port_scan):
    findings, ctx = port_scan
    assert findings == []
    assert len(ctx.files) > 50


def test_the_port_is_clean_under_the_references_linter():
    assert ref_graftlint(PKG) == []


def test_suppression_budget_and_reasons(port_scan):
    _, ctx = port_scan
    subs = ctx.count_suppressions()
    assert 0 < len(subs) <= 10, \
        f"{len(subs)} inline suppressions (cap is 10): {subs}"
    for fname, line, reason in subs:
        assert reason, (f"{fname}:{line}: suppression carries no reason "
                        f"string after the bracket")


def test_the_cli_gates_the_installed_package_by_default(tmp_path, capsys,
                                                        monkeypatch):
    """A bare invocation scans the installed port package: here aimed at
    a planted tree through the default's seam, exit 2 and the finding."""
    import nvidia_terraform_modules_tpu_torch.analysis.__main__ as cli

    bad = tmp_path / "pkg"
    bad.mkdir()
    (bad / "m.py").write_text("import torch\nX = torch.randn(3)\n")
    monkeypatch.setattr(cli, "_PACKAGE_DIR", str(bad))
    assert main(["-json"]) == 2
    doc = json.loads(capsys.readouterr().out)
    assert [(f["rule"], f["file"], f["line"]) for f in doc["findings"]] == \
        [("graft-unseeded-rng", "pkg/m.py", 2)]


# =============================================== the smoke-test preflight

def _tree(tmp_path, body):
    root = tmp_path / "lintroot"
    root.mkdir()
    (root / "m.py").write_text(textwrap.dedent(body))
    return str(root)


def test_the_preflight_refuses_a_bad_tree_before_the_world(tmp_path,
                                                            monkeypatch):
    import nvidia_terraform_modules_tpu_torch.smoketest.runner as runner

    def touched(*a, **k):
        raise AssertionError("the preflight let the run reach the device")

    monkeypatch.setattr(runner, "rank_device", touched)
    monkeypatch.setattr(runner, "maybe_initialize_distributed", touched)
    bad = _tree(tmp_path, """\
        import random
        import torch

        R = random.Random()
        X = torch.rand(3)
        """)
    for level in runner.LEVELS:
        r = runner.run_smoketest(level=level, env={
            "TPU_SMOKETEST_PLATFORM": "cpu", "TPU_SMOKETEST_LINT_DIR": bad})
        assert r.ok is False
        assert r.checks["level"] == level
        assert r.checks["lint_runtime_ok"] is False
        assert [f.split(": ")[1].rsplit(":", 1)[0]
                for f in r.checks["lint_runtime_findings"]] == \
            ["lintroot/m.py", "lintroot/m.py"]
        assert "process_id" not in r.checks and "psum_ok" not in r.checks
    assert not dist.is_initialized()


def test_an_unreadable_tree_is_reported_and_does_not_block(tmp_path):
    from nvidia_terraform_modules_tpu_torch.smoketest import run_smoketest

    root = tmp_path / "lintroot"
    root.mkdir()
    os.symlink(tmp_path / "gone.py", root / "dangling.py")
    r = run_smoketest(level="psum", env={
        "TPU_SMOKETEST_PLATFORM": "cpu",
        "TPU_SMOKETEST_LINT_DIR": str(root)})
    assert r.ok is True, r.checks
    assert r.checks["lint_runtime_ok"] is True
    assert "dangling.py" in r.checks["lint_runtime_error"]
    assert r.checks["psum_ok"] is True
