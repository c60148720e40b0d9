"""The check that decides ``correct``: the reference agrees with the
port's plain path at a tiny size, the control computed a precision below
reads farther off than the program, and a run with the timed path broken
underneath comes out not correct."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from nvidia_terraform_modules_tpu_torch.models import burnin
from portbench import control, harness, program, weights
from portbench.reference import model as ref

# the flagship with each FFN a Switch layer of 8 experts, top-1
MOE8 = dict(n_experts=8, router_top_k=1)


def _model(bench, config):
    m = bench.config("flagship-dense")
    return dict(m, **MOE8) if config == "flagship-moe8" else m


def _cfg(bench, name, dtype=torch.float32, **over):
    m = dict(_model(bench, name), dtype=str(dtype).split(".")[1])
    return m, program.config(m, seq_len=16, batch=2, **over)


@pytest.mark.parametrize("config", ["flagship-dense", "flagship-moe8"])
def test_reference_equals_the_ports_plain_path(tiny, config):
    m, cfg = _cfg(tiny, config)
    cfg = dataclasses.replace(cfg, attn="dense")
    params = weights.make(m, 11, "cpu")
    tokens = torch.randint(0, m["vocab"], (2, 16),
                           generator=torch.Generator().manual_seed(1))
    targets = tokens.roll(-1, dims=1)
    want = burnin.forward(params, tokens, cfg)
    with ref.exact():
        got = ref.forward(weights.to_float(params), tokens, m,
                          capacity=None if not m["n_experts"] else
                          ref.expert_capacity(32, m["n_experts"], 1.25))[0]
        loss = ref.loss(weights.to_float(params), tokens, targets, m)
    torch.testing.assert_close(got, want.float(), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        loss, burnin.loss_fn(params, (tokens, targets), cfg).float(),
        rtol=1e-4, atol=1e-4)


def test_reference_serve_logits_equal_its_forward(tiny):
    m = _model(tiny, "flagship-moe8")
    params = weights.to_float(weights.make(m, 3, "cpu"))
    tokens = torch.arange(12) % m["vocab"]
    with ref.exact():
        a = ref.serve_logits(params, tokens, m)
        b = ref.forward(params, tokens[None], m)[0][0]
    torch.testing.assert_close(a, b)


def test_the_control_reads_farther_off_than_the_program(tiny):
    got = control.train_seed(tiny, "dense-train-4k", 5, "cpu", faults=True)
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert got["control"][k] > 3 * got["program"][k], (k, got)
        assert got["half_batch"][k] > got["program"][k], (k, got)


def _run(bench, cell, fault=None, seconds=0.5):
    job = bench.job(cell, 2 ** 35 + 3, seconds, False, "cpu", fault=fault)
    out = harness.execute(bench, job)
    return harness.result(bench, job, out, 1.0, {"platform": "cpu"})


@pytest.mark.parametrize("cell", ["dense-train-4k", "dense-serve-chat"])
def test_a_sound_run_is_correct(tiny, cell):
    line = _run(tiny, cell)
    assert line["correct"], line
    assert list(line)[-1] == "compared"


def _control_run(bench, cell, seconds, device):
    job = bench.job(cell, 2 ** 35 + 5, seconds, False, device)
    job.fault = control.Fp8Control(job)
    out = harness.execute(bench, job)
    return harness.result(bench, job, out, 1.0, {"platform": device})


def test_the_fp8_control_in_the_programs_place_is_not_correct(tiny):
    # a tiny served model's greedy tokens rarely differ in fp8 (no number
    # could tell the two apart): the serve cell's control runs on the card
    line = _control_run(tiny, "dense-train-4k", 0.5, "cpu")
    assert line["compared"] and not line["correct"], line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dense-train-4k", "dense-serve-chat"])
def test_the_fp8_control_at_the_cells_size_is_not_correct(cuda, cell):
    line = _control_run(harness.Bench(), cell, 4.0, "cuda")
    print(cell, line["compared"])
    assert line["compared"] and not line["correct"], line


def _unchanged(point, step):
    return (lambda params, batch: (params, step(params, batch)[1])) \
        if point == "train_step" else step


def _altered(point, outs):
    """Each request's last served token replaced by the next id."""
    if point != "serve_outputs":
        return outs
    bad = {}
    for req, toks in outs.items():
        bad[req] = toks.clone()
        bad[req][-1] = (bad[req][-1] + 1) % 256
    return bad


@pytest.mark.parametrize("cell,fault", [
    ("dense-train-4k", _unchanged), ("dense-train-4k", control.half_batch),
    ("dense-serve-chat", _altered)],
    ids=["unchanged", "half-batch", "token-altered"])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    assert not _run(tiny, cell, fault)["correct"]
