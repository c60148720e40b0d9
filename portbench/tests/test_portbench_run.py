"""The command line and what a run loads: no card, no result; no module
of a run and no file of the benchmark with a JAX-side top-level name; on
a card, a short run of each cell prints a correct result line."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

SPEC = json.loads(harness.BENCHMARK.read_text())


def _command(*args):
    return [sys.executable, "-m", "portbench.run", *args]


def test_no_card_no_result():
    cell = SPEC["workloads"][0]["name"]
    got = subprocess.run(
        _command("--workload", cell, "--seed", "1", "--seconds", "1",
                 "--trace", "0"),
        cwd=harness.PKG.parent, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(harness.PKG.parent)})
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_levels():
    assert harness.forbidden_modules(
        ["nvidia_terraform_modules_tpu_torch.models", "jaxtyping",
         "torch"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "nvidia_terraform_modules_tpu.models"]) == [
            "jax", "nvidia_terraform_modules_tpu"]


def test_no_file_of_the_benchmark_imports_jax_side_modules():
    for path in harness.PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not harness.forbidden_modules(names), (path, names)


def test_a_runs_modules_hold_no_jax_side_name(tiny):
    code = (
        "import sys, json\n"
        "from portbench import harness\n"
        f"b = harness.Bench({str(tiny.root)!r}, "
        f"{str(tiny.root.parent / 'BENCHMARK.json')!r})\n"
        "for cell in ('dense-train-4k', 'dense-serve-chat'):\n"
        "    harness.execute(b, b.job(cell, 1, 0.2, False, 'cpu'))\n"
        "print(json.dumps(harness.forbidden_modules(sys.modules)))\n")
    got = subprocess.run([sys.executable, "-c", code], cwd=harness.PKG.parent,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    assert json.loads(got.stdout.strip().splitlines()[-1]) == []


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_on_the_card_is_correct(cuda, cell):
    got = subprocess.run(
        _command("--workload", cell, "--seed", "77", "--seconds", "4",
                 "--trace", "0"),
        cwd=harness.PKG.parent, capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stderr[-4000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
