# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the paged serve engine under ``run(rules=)`` in gloo
worlds (``_torch_world.py``) of 2 (``plan_mesh(2, tp=2)``: tp 2) and of 4
(``plan_mesh(4, tp=2)``: dp 2 × tp 2), against the JAX engine UNSHARDED
on the same weights (reference ``init_params`` → numpy) and prompts.

Every rank runs its shards: heads over ``tp`` in the admissions and the
waves, each data rank its half of the slots. At f32 each request's tokens
must EQUAL the JAX engine's, greedy and sampled (keys by request and
position), for MHA, for grouped-query attention with rope (2 KV heads,
which tp 2 divides: each rank's pool holds one) and for one KV head,
which tp 2 does not divide (each rank's pool holds it whole); and
``forward_paged(rules=)``'s logits over a prompt (a prefill, then a T=1
step through the tables) must agree with the reference's ``forward``
within 1e-5 — tokens alone would miss a small error in attention, which
the residual stream outweighs at these widths. The int8
pool under ``rules`` must equal the port's unsharded int8 engine. The
engine's levers under ``rules`` equal the JAX engine unsharded too:
``spec_k=2`` (every rank the same verification steps), int8 weights
(``quantize_params(shards, rules=)``, the phase split from the shards)
and MoE (2 experts top-1, 4 experts top-2; ``spec_k`` over MoE), the
experts replicated with their ``d_ff`` over ``tp`` in those worlds, and
over ``ep`` in worlds of 4 (``plan_mesh(4, ep=2, tp=2)``) and 2
(``plan_mesh(2, ep=2, tp=1)``). The host KV tier (``host_spill`` with a
keep-cap of 0, on template prompts) under ``rules`` in the world of 2:
each rank's host pool holds its KV heads, and the tokens and the spill
counts equal the JAX engine's unsharded. Slots that the data axes do not divide
are refused; in this process, a world of one runs the unsharded engine's
tokens.
"""

import concurrent.futures
import datetime
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_world import run_world

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import quantize as jquant
from nvidia_terraform_modules_tpu.models import serving as jserving
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    make_serve_engine,
    params_from_numpy,
    quantize_params,
)
from nvidia_terraform_modules_tpu_torch.parallel import (
    build_mesh,
    make_rules,
    plan_mesh,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2, attn="dense")
ENGINE = dict(max_len=16, kv_block=4)
N_NEW = 6
SEED = 7
MOE1 = dict(n_experts=2, router_top_k=1)
MOE2 = dict(n_experts=4, router_top_k=2)
# name → (config changes, engine keywords, run keywords); "quantized":
# the engine serves quantize_params(shards, rules=)
CASES = {
    "greedy": ({}, {}, {}),
    "sampled": ({}, {"sampler": {"temperature": 5.0}}, {"rng": SEED}),
    "gqa_rope": (dict(n_kv_heads=2, rope=True), {}, {}),
    "kv_replicated": (dict(n_kv_heads=1), {}, {}),
    "int8_pool": ({}, {"cache_dtype": "int8"}, {}),
    "spec_k": ({}, {"spec_k": 2}, {}),
    "int8_weights": ({}, {"quantized": True}, {}),
    "moe_top1": (MOE1, {}, {}),
    "moe_top2": (MOE2, {}, {}),
    "moe_spec_k": (MOE1, {"spec_k": 2}, {}),
    "host_spill": ({}, {"share_prefix": True, "prefix_keep_blocks": 0,
                        "host_spill": True}, {}),
}
# the cases whose world also records the pool's shape and the logits
LOGITS = ("greedy", "gqa_rope", "kv_replicated", "int8_pool")
LEVERS = ("spec_k", "int8_weights", "moe_top1", "moe_top2")
MOE = ("moe_top1", "moe_top2", "moe_spec_k")
# world name → (world size, plan_mesh keywords, slots, cases)
WORLDS = {
    "tp2": (2, dict(tp=2), 2, tuple(CASES)[:5] + LEVERS + ("host_spill",)),
    "dp2xtp2": (4, dict(tp=2), 4, tuple(CASES)[:5] + LEVERS),
    "ep2xtp2": (4, dict(tp=2, ep=2), 4, MOE),
    "ep2": (2, dict(tp=1, ep=2), 2, MOE),
}
DENSE_WORLDS = ("dp2xtp2", "tp2")
LEVER_PAIRS = [(w, c) for w, (_, _, _, cases) in WORLDS.items()
               for c in cases if c in LEVERS + MOE]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors on a shared CPU: one intra-op thread a process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(name):
    over = CASES[name][0]
    jcfg = jburnin.BurnInConfig(**BASE, **over, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(len(name)), jcfg)
    rng = np.random.default_rng(len(name))
    if "host_spill" in CASES[name][1]:
        # two 8-token templates (two blocks of 4) and short suffixes
        tmpl = [rng.integers(0, BASE["vocab"], size=(8,)) for _ in range(2)]
        return jcfg, jp, [np.concatenate([tmpl[i % 2], rng.integers(
            0, BASE["vocab"], size=(1 + i % 2,))]).astype(np.int32)
            for i in range(6)]
    prompts = [rng.integers(0, BASE["vocab"], size=(4 + (i % 3) * 2,))
               .astype(np.int32) for i in range(5)]
    return jcfg, jp, prompts


# (case, slots) → the JAX engine's spill record, less its host time
_JAX_SPILL: dict = {}


@functools.lru_cache(maxsize=None)
def _jax_tokens(name, slots):
    """The JAX engine's tokens, unsharded (the int8 pool's case: none —
    it is held to the port's unsharded int8 engine)."""
    jcfg, jp, prompts = _weights(name)
    over, engine_kw, run_kw = CASES[name]
    engine_kw = dict(engine_kw)
    if engine_kw.pop("quantized", False):
        jp = jquant.quantize_params(jp, dtype=jnp.float32)
    jeng = jserving.make_serve_engine(jp, jcfg, **ENGINE, **engine_kw)
    run = dict(run_kw)
    if "rng" in run:
        run["rng"] = jax.random.PRNGKey(run["rng"])
    outs = jeng([jnp.asarray(p) for p in prompts], N_NEW, slots=slots,
                **run)
    if engine_kw.get("host_spill"):
        _JAX_SPILL[name, slots] = {
            k: v for k, v in jeng.last_stats["prefix"]["spill"].items()
            if k != "swap_ms"}
    return [np.asarray(o).tolist() for o in outs]


def _port_unsharded(name, slots):
    _, jp, prompts = _weights(name)
    over, engine_kw, run_kw = CASES[name]
    cfg = BurnInConfig(**BASE, **over, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    eng = make_serve_engine(params, cfg, device="cpu", **ENGINE,
                            **engine_kw)
    return [t.tolist() for t in eng(prompts, N_NEW, slots=slots, **run_kw)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results; the JAX engine's tokens are computed in this
    process while the worlds run in theirs."""
    jobs = []
    for world, (n, plan, slots, names) in WORLDS.items():
        cases = []
        for name in names:
            over, engine_kw, run_kw = CASES[name]
            _, jp, prompts = _weights(name)
            cases.append({"name": name, "cfg": {**BASE, **over},
                          "params": jax.tree.map(np.asarray, jp),
                          "prompts": prompts, "n_new": N_NEW,
                          "engine": {**ENGINE, **engine_kw},
                          "run": {**run_kw, "slots": slots},
                          "logits": name in LOGITS,
                          **({"steps": True} if "spec_k" in engine_kw
                             else {})})
        jobs.append((world, n, tmp_path_factory.mktemp(world),
                     {"plan": plan, "cases": cases}))

    def run_all():
        return {world: run_world("serve_sharded", n, tmp, args, timeout=150)
                for world, n, tmp, args in jobs}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_all)
        for world, (_, _, slots, names) in WORLDS.items():
            for name in names:
                if name != "int8_pool":
                    _jax_tokens(name, slots)
        return future.result()


@pytest.mark.parametrize("name", ["greedy", "sampled", "gqa_rope",
                                  "kv_replicated"])
@pytest.mark.parametrize("world", DENSE_WORLDS)
def test_sharded_run_matches_unsharded_jax_engine(worlds, world, name):
    want = _jax_tokens(name, WORLDS[world][2])
    for rank, r in enumerate(worlds[world]):
        assert r[name]["tokens"] == want, (rank, name)


@pytest.mark.parametrize("world,name", LEVER_PAIRS)
def test_sharded_levers_match_unsharded_jax_engine(worlds, world, name):
    """``spec_k``, int8 weights and MoE under ``run(rules=)``: each
    request equals the JAX engine's, unsharded; under ``spec_k`` every
    rank counts the same verification steps."""
    want = _jax_tokens(name, WORLDS[world][2])
    for rank, r in enumerate(worlds[world]):
        assert r[name]["tokens"] == want, (rank, name)
        if "spec_k" in CASES[name][1]:
            assert r[name]["decode_steps"] == \
                worlds[world][0][name]["decode_steps"]


def test_sharded_host_spill_matches_unsharded_jax_engine(worlds):
    """The host KV tier under ``run(rules=)`` (tp 2, each rank spilling
    and swapping in its own KV head): tokens and spill counts equal the
    JAX engine's unsharded, with swap-ins, and both pools drain."""
    want = _jax_tokens("host_spill", 2)
    spill = _JAX_SPILL["host_spill", 2]
    assert spill["swapins"] > 0
    for rank, r in enumerate(worlds["tp2"]):
        assert r["host_spill"]["tokens"] == want, rank
        assert r["host_spill"]["spill"] == spill, rank
        assert r["host_spill"]["in_use"] == 0


@pytest.mark.parametrize("name", ["greedy", "gqa_rope", "kv_replicated"])
@pytest.mark.parametrize("world", DENSE_WORLDS)
def test_sharded_forward_paged_logits_match_reference(worlds, world, name):
    """``forward_paged(rules=)`` over the first prompt (a prefill, then a
    T=1 step through the tables) against the reference's ``forward`` on
    the same tokens, within 1e-5 (f32; the head's partial logits and the
    row-parallel products are summed in another order)."""
    jcfg, jp, prompts = _weights(name)
    want = np.asarray(jburnin.forward(jp, jnp.asarray(prompts[0])[None],
                                      jcfg))[0]
    for r in worlds[world]:
        np.testing.assert_allclose(r[name]["logits"], want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("world", DENSE_WORLDS)
def test_sharded_int8_pool_matches_unsharded_port_engine(worlds, world):
    want = _port_unsharded("int8_pool", WORLDS[world][2])
    for r in worlds[world]:
        assert r["int8_pool"]["tokens"] == want
        assert r["int8_pool"]["kv"] > 0


@pytest.mark.parametrize("world", DENSE_WORLDS)
def test_pool_holds_this_ranks_kv_heads(worlds, world):
    """``tp`` divides the KV heads: a rank's pool holds ``kv / tp`` of
    them; it does not (one KV head, tp 2): the pool holds them all."""
    tp = WORLDS[world][1]["tp"]
    head_dim = BASE["d_model"] // BASE["n_heads"]
    for r in worlds[world]:
        assert r["mesh"]["tp"] == tp
        assert r["greedy"]["pool"] == (5, 4, BASE["n_heads"] // tp, head_dim)
        assert r["gqa_rope"]["pool"] == (5, 4, 2 // tp, head_dim)
        assert r["kv_replicated"]["pool"] == (5, 4, 1, head_dim)


def test_slots_must_divide_over_the_data_axes(worlds):
    for r in worlds["dp2xtp2"]:
        assert "slots (3) must divide over the data axes (2 shards)" in \
            r["odd_slots"]
    for r in worlds["tp2"]:
        assert r["odd_slots"] is None       # one data shard divides all


@pytest.fixture
def world_of_one():
    """A gloo world of one rank in this process, taken down after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_rules(build_mesh(plan_mesh(1)))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["greedy", "sampled", "int8_pool",
                                  "spec_k", "int8_weights", "moe_top2",
                                  "host_spill"])
def test_world_of_one_rules_run_equals_unsharded(world_of_one, name):
    _, jp, prompts = _weights(name)
    over, engine_kw, run_kw = CASES[name]
    cfg = BurnInConfig(**BASE, **over, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    engine_kw = dict(engine_kw)
    if engine_kw.pop("quantized", False):
        params = quantize_params(params, torch.float32, world_of_one)
    eng = make_serve_engine(params, cfg, device="cpu", **ENGINE, **engine_kw)
    plain = eng(prompts, N_NEW, slots=2, **run_kw)
    sharded = eng(prompts, N_NEW, slots=2, rules=world_of_one, **run_kw)
    for a, b in zip(plain, sharded):
        assert torch.equal(a, b)
