# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The PyTorch port stands alone: no module of it, and not ``chip_smoke.py``,
imports JAX or the JAX reference package; importing the whole port loads
no JAX; and its entry points target the card unless the caller asks for
the CPU — on a machine without one they raise, never quietly run on the
CPU."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import nvidia_terraform_modules_tpu_torch as port
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    greedy_decode,
    init_cache,
    init_paged_cache,
    init_params,
    instrument_step,
    make_adamw_train_step,
    make_decoder,
    make_quantized_decoder,
    make_serve_engine,
    make_speculative_decoder,
    make_train_step,
    opt_state_from_numpy,
    params_from_numpy,
    qparams_from_numpy,
    sample_decode,
    speculative_greedy_decode,
    synthetic_batch,
)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nvidia_terraform_modules_tpu"}


def _port_files():
    files = sorted(Path(port.__file__).parent.rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.exists()
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import nvidia_terraform_modules_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print(len([n for n in new if n.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15    # every module was imported


@pytest.mark.parametrize("fn", [init_params, greedy_decode,
                                make_serve_engine, init_paged_cache,
                                init_cache, make_train_step,
                                make_adamw_train_step, synthetic_batch,
                                params_from_numpy, opt_state_from_numpy,
                                make_quantized_decoder, qparams_from_numpy,
                                sample_decode, speculative_greedy_decode,
                                make_speculative_decoder, make_decoder,
                                instrument_step])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_a_card():
    cfg = BurnInConfig(vocab=32, d_model=16, n_heads=2, d_ff=32,
                       n_layers=1, dtype=torch.float32)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    calls = [
        lambda: init_params(cfg),
        lambda: make_serve_engine(cpu_params, cfg, max_len=8),
        lambda: greedy_decode(cpu_params, torch.zeros((1, 4), dtype=int), 2,
                              cfg),
        lambda: init_paged_cache(cfg, 1, 8, block_size=4, num_blocks=3),
        lambda: make_train_step(cfg),
        lambda: make_adamw_train_step(cfg),
        lambda: synthetic_batch(torch.Generator().manual_seed(0), cfg),
        lambda: make_quantized_decoder(cfg),
        lambda: make_decoder(cfg),
    ]
    if torch.cuda.is_available():
        assert init_params(cfg)["embed"].device.type == "cuda"
        with pytest.raises(ValueError, match="params live on cpu"):
            calls[1]()
        batch = synthetic_batch(torch.Generator(device="cuda"), cfg)
        with pytest.raises(ValueError, match="params live on cpu"):
            make_train_step(cfg)(cpu_params, batch)
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
