"""The yardstick's frozen pieces: the traffic copies, the FLOP counts and
kernel bounds, and the idle share as a union of intervals."""

from __future__ import annotations

import pytest

from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    train_step_flops,
)
from nvidia_terraform_modules_tpu_torch.utils import traffic as port_traffic
from portbench import flops, gen, harness, trace
from portbench.traffic import serve_open_loop

def test_traffic_copies_equal_the_ports_draws():
    assert gen.poisson_trace(120.0, 300, 9) == \
        port_traffic.poisson_trace(120.0, 300, 9)
    assert gen.spike_trace(5.0, 50, 2) == port_traffic.spike_trace(5.0, 50, 2)
    assert gen.ragged_lengths(300, 9, lo=64, hi=2048, mean=512) == \
        port_traffic.ragged_lengths(300, 9, lo=64, hi=2048, mean=512)
    assert gen.shared_prefix_prompts(20, 3) == \
        port_traffic.shared_prefix_prompts(20, 3)


def test_a_plan_reproduces_from_its_seed_and_keeps_the_work():
    mix = harness.Bench().traffic("chat")
    seed = 2 ** 33 + 17                       # past 32 signed bits
    a = serve_open_loop.plan(mix, 100.0, 20.0, seed)
    assert a == serve_open_loop.plan(mix, 100.0, 20.0, seed)
    b = serve_open_loop.plan(mix, 100.0, 20.0, seed + 1)
    assert a != b
    # every seed: the same sizes and gaps, in another order
    assert sorted(zip(a[1], a[2])) == sorted(zip(b[1], b[2]))
    gaps = [sorted(x - y for x, y in zip(d, [0.0] + d[:-1]))
            for d in (a[0], b[0])]
    assert gaps[0] == pytest.approx(gaps[1])
    assert a[0][-1] == pytest.approx(20.0)


def test_prompts_reproduce_from_their_seed():
    import torch
    x = serve_open_loop.prompts_of([3, 5], 100, 2 ** 40, "cpu")
    y = serve_open_loop.prompts_of([3, 5], 100, 2 ** 40, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(x, y))


@pytest.mark.parametrize("experts", [0, 8], ids=["dense", "moe8"])
def test_frozen_train_flops_equal_the_ports(experts):
    import torch
    m = dict(harness.Bench().config("flagship-dense"), n_experts=experts)
    cfg = BurnInConfig(
        vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
        d_ff=m["d_ff"], n_layers=m["n_layers"], seq_len=4096, batch=2,
        n_experts=m["n_experts"], router_top_k=m["router_top_k"],
        attn=m["attn"], dtype=torch.bfloat16)
    assert flops.train_step_flops(m, 2, 4096) == train_step_flops(cfg)


def test_flash_bounds_equal_the_kernel_table():
    assert flops.flash_fwd_bound_s(2, 4096, 16, 128) * 1e3 == \
        pytest.approx(0.139, abs=5e-4)
    assert flops.flash_bwd_bound_s(2, 4096, 16, 128) * 1e3 == \
        pytest.approx(0.348, abs=1e-3)


def test_idle_share_counts_overlap_once():
    assert trace.union_seconds([(0.0, 2.0), (1.0, 3.0)]) == 3.0
    assert trace.union_seconds([(0.0, 1.0), (2.0, 3.0)]) == 2.0
    got = trace.reduce([("a", 0.0, 2.0), ("b", 1.0, 3.0)],
                       [("host_op", 3.0, 4.0)], 0.0, 4.0)
    assert got["busy_s"] == 3.0 and got["window_s"] == 4.0
    assert got["breakdown"]["idle_gaps"] == [["host_op", 1.0]]
    reader = harness.Bench().metric("idle_share.train")
    assert reader.read({"kind": "train", "trace": got}) == \
        pytest.approx(25.0)


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert flops.percentile(xs, 95) == 95
    assert flops.percentile([5.0], 95) == 5.0
