# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the data- and tensor-parallel SGD step over a
``torch.distributed`` world against the JAX reference's unsharded
``make_train_step``: one gloo world of 4 CPU ranks (``_torch_world.py``)
runs three meshes — dp 2 × tp 2, tp 4, and dp 2 × tp 2 with grouped-query
attention (2 KV heads) — for 3 SGD steps each from the reference's
``init_params`` weights and one seeded numpy batch. It also checks that
``shard_params`` and ``gather_params`` reassemble the tree exactly, and
the refusals (a ``tp`` that the heads, KV heads or FFN do not divide; MoE
over an axis above 1; ``sp`` over the world). In this process, a world of
one runs the unsharded step's operations bit for bit.

Tolerances (f32): the tied head's partial logits and the mean over dp
change the order of sums, so losses agree within 1e-5 relative and each
parameter leaf within ``max|Δ| / max|ref| <= 1e-5``; a world of one and
the round trip are exact.
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
from nvidia_terraform_modules_tpu.parallel import sharding as jsharding
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    make_train_step,
    params_from_numpy,
    synthetic_batch,
    tree_leaves,
)
from nvidia_terraform_modules_tpu_torch.parallel import (
    build_mesh,
    make_rules,
    plan_mesh,
)

BASE = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2,
            seq_len=16, batch=4)
LR = 0.05
STEPS = 3
# name → (tp of the world of 4, config changes)
CASES = {
    "dp2xtp2": (2, dict(attn="dense")),
    "tp4": (4, dict(attn="flash")),
    "gqa_dp2xtp2": (2, dict(attn="dense", n_kv_heads=2, rope=True)),
}


def _reference(name):
    """The case's reference weights and batch (numpy), and its losses and
    parameters after ``STEPS`` of the reference's unsharded step."""
    over = CASES[name][1]
    jcfg = jburnin.BurnInConfig(**BASE, **over, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(len(name)), jcfg)
    stream = np.random.default_rng(len(name)).integers(
        0, BASE["vocab"], size=(BASE["batch"], BASE["seq_len"] + 1),
        dtype=np.int32)
    batch = (stream[:, :-1], stream[:, 1:])
    params_np = jax.tree.map(np.asarray, jp)
    jstep = jburnin.make_train_step(jcfg, lr=LR)
    jb = tuple(jnp.asarray(x) for x in batch)
    losses = []
    for _ in range(STEPS):
        jp, loss = jstep(jp, jb)
        losses.append(float(loss))
    return params_np, batch, losses, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 4's results (one spawn for the module) beside the
    reference's."""
    refs = {name: _reference(name) for name in CASES}
    cases = [{"name": name, "tp": tp, "cfg": {**BASE, **over},
              "params": refs[name][0], "batch": refs[name][1], "lr": LR,
              "steps": STEPS} for name, (tp, over) in CASES.items()]
    ranks = run_world("sharded_train", 4, tmp_path_factory.mktemp("tp"),
                      {"cases": cases}, timeout=150)
    return ranks, refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_reference(world, name):
    ranks, refs = world
    _, _, ref_losses, ref_params = refs[name]
    for r in ranks:                      # every rank reports the world's
        np.testing.assert_allclose(r[name]["losses"], ref_losses,
                                   rtol=1e-5, atol=0)
    got = ranks[0][name]["params"]
    flat_w = jax.tree_util.tree_leaves_with_path(ref_params)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        assert g.shape == w.shape, path
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= 1e-5, (path, rel)


@pytest.mark.parametrize("name", sorted(CASES))
def test_shard_params_reassembles_and_rows_split(world, name):
    ranks, _ = world
    tp = CASES[name][0]
    for r in ranks:
        assert r[name]["roundtrip"] is True
        assert r[name]["mesh"] == {"dp": 4 // tp, "sp": 1, "tp": tp}
        assert r[name]["local_rows"] == BASE["batch"] // (4 // tp)


@pytest.mark.parametrize("case, kind, words", [
    ("tp_heads", "ValueError", "tp = 4 must divide n_heads (2)"),
    ("tp_kv_heads", "ValueError", "n_kv_heads (2)"),
    ("tp_d_ff", "ValueError", "d_ff (66)"),
    ("moe", "NotImplementedError", "Queue A item 6"),
    ("sp_with_tp", "NotImplementedError", "sp > 1 together with dp or tp"),
    ("sp_alone", "NotImplementedError", "ring and Ulysses over processes"),
])
def test_refusals(world, case, kind, words):
    ranks, _ = world
    for r in ranks:
        got = r["refusals"][case]
        assert got is not None and got[0] == kind and words in got[1], got


@pytest.fixture
def world_of_one():
    """A gloo world of one rank in this process, taken down after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_world_of_one_equals_unsharded_step_bitwise(world_of_one, attn):
    cfg = BurnInConfig(**BASE, attn=attn, n_kv_heads=2,
                       dtype=torch.float32)
    rules = make_rules(build_mesh(plan_mesh(1)))
    assert type(rules.mesh).__name__ == "WorldMesh"
    gen = torch.Generator().manual_seed(3)
    params = params_from_numpy(jax.tree.map(np.asarray, jburnin.init_params(
        jax.random.PRNGKey(9), jburnin.BurnInConfig(
            **BASE, attn=attn, n_kv_heads=2, dtype=jnp.float32))), cfg,
        device="cpu")
    batch = synthetic_batch(gen, cfg, device="cpu")
    sharded = make_train_step(cfg, rules, lr=LR, device="cpu")
    plain = make_train_step(cfg, lr=LR, device="cpu")
    ps, pp = params, params
    for _ in range(STEPS):
        ps, loss_s = sharded(ps, batch)
        pp, loss_p = plain(pp, batch)
        assert torch.equal(loss_s, loss_p)
    for a, b in zip(tree_leaves(ps), tree_leaves(pp)):
        assert torch.equal(a, b)


def _path_str(path):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def test_param_sharding_matches_reference_roles(jax8):
    """Every leaf's spec, a dense tree and an MoE tree, against the
    reference's ``ShardingRules.param_sharding`` on a dp 2 × tp 4 mesh."""
    from jax.sharding import Mesh as JMesh

    from nvidia_terraform_modules_tpu.parallel import make_rules as jmake

    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 1, 4),
                  ("dp", "sp", "tp"))
    jrules = jmake(jmesh)
    assert isinstance(jrules, jsharding.ShardingRules)

    class _Shape:           # the port's rules read only the axis names
        axis_names = ("dp", "sp", "tp")
        shape = {"dp": 2, "sp": 1, "tp": 4}

    rules = make_rules(_Shape())
    for over in ({}, dict(n_experts=4)):
        jcfg = jburnin.BurnInConfig(**BASE, **over, dtype=jnp.float32)
        tree = jax.eval_shape(
            lambda: jburnin.init_params(jax.random.PRNGKey(0), jcfg))
        for path, _ in jax.tree_util.tree_leaves_with_path(tree):
            want = tuple(jrules.param_sharding(_path_str(path)).spec)
            got = rules.param_sharding(_path_str(path))
            assert tuple(got) == want, (path, got, want)
