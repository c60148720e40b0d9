"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
at a tiny size (every width and length cut, the harness and the kinds
unchanged), run on the CPU with the port's plain paths."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from portbench import harness

TINY_MODEL = dict(vocab=256, d_model=64, n_heads=4, d_ff=128, n_layers=2)


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def make_tiny(dest: Path) -> Path:
    """A tiny copy of the benchmark under ``dest``: its package folder
    and its ``BENCHMARK.json``."""
    pb = dest / "portbench"
    shutil.copytree(harness.PKG, pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.BENCHMARK, dest / "BENCHMARK.json")
    for cfg in (pb / "configs").glob("*.json"):
        _edit(cfg, **TINY_MODEL)
    for mix in (pb / "traffic").glob("*.json"):
        if json.loads(mix.read_text())["kind"] == "serve_open_loop":
            _edit(mix, prompt={"lo": 4, "hi": 24, "mean": 10},
                  output={"lo": 2, "hi": 8, "mean": 4}, slots=4, max_len=64,
                  kv_block=8, check={"min_tokens": 20, "min_requests": 2,
                         "max_requests": 4},
                  trace_segment={"seconds": 0.5, "from": 0.1})
        else:
            _edit(mix, seq_len=16, batch=2)
    for cell in (pb / "workloads").glob("*.json"):
        if "rate_rps" in json.loads(cell.read_text()):
            _edit(cell, rate_rps=20.0)
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> harness.Bench:
    root = make_tiny(tmp_path_factory.mktemp("tiny"))
    return harness.Bench(root / "portbench", root / "BENCHMARK.json")


@pytest.fixture
def cuda():
    """Skips without a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU "
                    "mode")
