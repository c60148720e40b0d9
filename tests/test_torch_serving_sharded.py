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
pool under ``rules`` must equal the port's unsharded int8 engine. Slots
that the data axes do not divide are refused; in this process, a world of
one runs the unsharded engine's tokens, and ``spec_k``, MoE and int8
weights under ``rules`` raise ``NotImplementedError`` naming ROADMAP
Queue A item 6.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_world import run_world

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import serving as jserving
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    init_params,
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
# name → (config changes, engine keywords, run keywords)
CASES = {
    "greedy": ({}, {}, {}),
    "sampled": ({}, {"sampler": {"temperature": 5.0}}, {"rng": SEED}),
    "gqa_rope": (dict(n_kv_heads=2, rope=True), {}, {}),
    "kv_replicated": (dict(n_kv_heads=1), {}, {}),
    "int8_pool": ({}, {"cache_dtype": "int8"}, {}),
}
# world name → (world size, tp, slots)
WORLDS = {"tp2": (2, 2, 2), "dp2xtp2": (4, 2, 4)}


def _weights(name):
    over = CASES[name][0]
    jcfg = jburnin.BurnInConfig(**BASE, **over, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(len(name)), jcfg)
    rng = np.random.default_rng(len(name))
    prompts = [rng.integers(0, BASE["vocab"], size=(4 + (i % 3) * 2,))
               .astype(np.int32) for i in range(5)]
    return jcfg, jp, prompts


def _jax_tokens(name, slots):
    """The JAX engine's tokens, unsharded (the int8 pool's case: none —
    it is held to the port's unsharded int8 engine)."""
    jcfg, jp, prompts = _weights(name)
    over, engine_kw, run_kw = CASES[name]
    jeng = jserving.make_serve_engine(jp, jcfg, **ENGINE, **engine_kw)
    run = dict(run_kw)
    if "rng" in run:
        run["rng"] = jax.random.PRNGKey(run["rng"])
    outs = jeng([jnp.asarray(p) for p in prompts], N_NEW, slots=slots,
                **run)
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
    out = {}
    for world, (n, tp, slots) in WORLDS.items():
        cases = []
        for name, (over, engine_kw, run_kw) in CASES.items():
            _, jp, prompts = _weights(name)
            cases.append({"name": name, "cfg": {**BASE, **over},
                          "params": jax.tree.map(np.asarray, jp),
                          "prompts": prompts, "n_new": N_NEW,
                          "engine": {**ENGINE, **engine_kw},
                          "run": {**run_kw, "slots": slots}})
        out[world] = run_world("serve_sharded", n,
                               tmp_path_factory.mktemp(world),
                               {"tp": tp, "cases": cases}, timeout=150)
    return out


@pytest.mark.parametrize("name", ["greedy", "sampled", "gqa_rope",
                                  "kv_replicated"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_run_matches_unsharded_jax_engine(worlds, world, name):
    want = _jax_tokens(name, WORLDS[world][2])
    for rank, r in enumerate(worlds[world]):
        assert r[name]["tokens"] == want, (rank, name)


@pytest.mark.parametrize("name", ["greedy", "gqa_rope", "kv_replicated"])
@pytest.mark.parametrize("world", sorted(WORLDS))
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


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_int8_pool_matches_unsharded_port_engine(worlds, world):
    want = _port_unsharded("int8_pool", WORLDS[world][2])
    for r in worlds[world]:
        assert r["int8_pool"]["tokens"] == want
        assert r["int8_pool"]["kv"] > 0


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_pool_holds_this_ranks_kv_heads(worlds, world):
    """``tp`` divides the KV heads: a rank's pool holds ``kv / tp`` of
    them; it does not (one KV head, tp 2): the pool holds them all."""
    tp = WORLDS[world][1]
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


@pytest.mark.parametrize("name", ["greedy", "sampled", "int8_pool"])
def test_world_of_one_rules_run_equals_unsharded(world_of_one, name):
    _, jp, prompts = _weights(name)
    over, engine_kw, run_kw = CASES[name]
    cfg = BurnInConfig(**BASE, **over, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    eng = make_serve_engine(params, cfg, device="cpu", **ENGINE, **engine_kw)
    plain = eng(prompts, N_NEW, slots=2, **run_kw)
    sharded = eng(prompts, N_NEW, slots=2, rules=world_of_one, **run_kw)
    for a, b in zip(plain, sharded):
        assert torch.equal(a, b)


def test_spec_k_moe_and_int8_weights_under_rules_refuse(world_of_one):
    _, jp, prompts = _weights("greedy")
    cfg = BurnInConfig(**BASE, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    spec = make_serve_engine(params, cfg, device="cpu", spec_k=2, **ENGINE)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        spec(prompts, 2, rules=world_of_one)
    q = make_serve_engine(quantize_params(params, dtype=torch.float32), cfg,
                          device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        q(prompts, 2, rules=world_of_one)
    mcfg = BurnInConfig(**BASE, n_experts=2, capacity_factor=4.0,
                        dtype=torch.float32)
    moe = make_serve_engine(init_params(mcfg, torch.Generator().manual_seed(0),
                                        device="cpu"), mcfg, device="cpu",
                            **ENGINE)
    with pytest.raises(NotImplementedError,
                       match="MoE serving under rules=.*Queue A item 6"):
        moe(prompts, 2, rules=world_of_one)
