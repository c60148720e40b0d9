# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, MoE with its experts sharded over ``ep`` in a
``torch.distributed`` world, against the JAX reference's UNSHARDED model:
the cases of the reference's ``tests/test_moe.py`` (its config, ``:32``)
in gloo worlds (``_torch_world.py``) of 2 (``plan_mesh(2, ep=2, tp=1)``),
of 4 with ep 2 × tp 2 (``plan_mesh(4, ep=2)``) and of 4 with dp 2 × ep 2.

Each world runs top-1, top-2, and both at a capacity factor of 0.5, where
tokens must drop (128 top-1 assignments for 4 × 16 slots), so the
capacity positions must follow the global token order. Checked:

- ``forward_and_aux``: every rank's logits (its batch rows) against the
  reference's within rtol = atol = 2e-4, aux within 1e-4 relative (the
  reference's own bounds, ``tests/test_moe.py:104-107``);
- one SGD step's parameters against the reference's unsharded step, each
  leaf within ``max|Δ| / max|ref| <= 1e-5``, and the loss within 1e-5
  relative (``tests/test_torch_sharded_train.py``'s bounds); the loss
  falls over 5 steps (``tests/test_moe.py:110``);
- on dp 2 × ep 2, one ZeRO-1 AdamW step against the reference's
  unsharded AdamW (parameters within 5e-5 absolute, as
  ``tests/test_torch_optimizer.py``), and the moments' specs against the
  reference's ``opt_state_shardings`` on the same mesh;
- each rank's shard sizes, and an ``ep``-sharded checkpoint round trip in
  the world of 2 (``tests/test_moe.py:123``);
- in this process, a world of one runs the unsharded MoE step bit for bit.
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
from nvidia_terraform_modules_tpu.models import optimizer as jopt
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    make_train_step,
    params_from_numpy,
    synthetic_batch,
    tree_leaves,
)
from nvidia_terraform_modules_tpu_torch.models.burnin import _tree_map_path
from nvidia_terraform_modules_tpu_torch.parallel import (
    build_mesh,
    make_rules,
    plan_mesh,
)

# the reference's tests/test_moe.py:32 config
BASE = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=2,
            seq_len=16, batch=8, n_experts=4)
CASES = {
    "top1": {},
    "top2": dict(router_top_k=2),
    "top1_drop": dict(capacity_factor=0.5),
    "top2_drop": dict(router_top_k=2, capacity_factor=0.5),
}
LR = 0.05
TRAIN_STEPS = 5
ADAMW = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1)
ADAMW_STEPS = 1
# world name → (world size, (axis names, shape))
WORLDS = {
    "ep2": (2, (("dp", "ep", "sp", "tp"), (1, 2, 1, 1))),
    "ep2xtp2": (4, (("dp", "ep", "sp", "tp"), (1, 2, 1, 2))),
    "dp2xep2": (4, (("dp", "ep", "sp", "tp"), (2, 2, 1, 1))),
}


def _reference(name):
    """The case's weights and batch (numpy), and the reference's
    unsharded logits, aux, one SGD step's loss and parameters, the losses
    of ``TRAIN_STEPS`` steps, and ``ADAMW_STEPS`` AdamW steps'
    parameters."""
    jcfg = jburnin.BurnInConfig(**BASE, **CASES[name], dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(len(name)), jcfg)
    stream = np.random.default_rng(len(name)).integers(
        0, BASE["vocab"], size=(BASE["batch"], BASE["seq_len"] + 1),
        dtype=np.int32)
    batch = (stream[:, :-1], stream[:, 1:])
    jb = tuple(jnp.asarray(x) for x in batch)
    logits, aux = jax.jit(lambda p, t: jburnin.forward_and_aux(
        p, t, jcfg))(jp, jb[0])
    step = jburnin.make_train_step(jcfg, lr=LR)
    p, losses = jp, []
    for i in range(TRAIN_STEPS):
        p, loss = step(p, jb)
        losses.append(float(loss))
        if i == 0:
            sgd = jax.tree.map(np.asarray, p)
    init_state, astep = jopt.make_adamw_train_step(
        jcfg, opt=jopt.AdamWConfig(**ADAMW))
    p, state = jp, init_state(jp)
    for _ in range(ADAMW_STEPS):
        p, state, aloss = astep(p, state, jb)
    grads = jax.grad(lambda q: jburnin.loss_fn(q, jb, jcfg))(jp)
    return {"params": jax.tree.map(np.asarray, jp), "batch": batch,
            "logits": np.asarray(logits), "aux": float(aux),
            "losses": losses, "sgd": sgd,
            "adamw": {k: jax.tree.map(np.asarray, v) for k, v in (
                ("params", p), ("mu", state["mu"]), ("nu", state["nu"]))},
            "adamw_loss": float(aloss),
            "grads": jax.tree.map(np.asarray, grads)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    refs = {name: _reference(name) for name in CASES}
    out = {}
    for world, (n, plan) in WORLDS.items():
        cases = [{"name": name, "cfg": {**BASE, **over},
                  "params": refs[name]["params"],
                  "batch": refs[name]["batch"], "lr": LR}
                 for name, over in CASES.items()]
        if world == "dp2xep2":
            for c in cases:
                if c["name"] in ("top1", "top2_drop"):
                    c.update(adamw=ADAMW, adamw_steps=ADAMW_STEPS)
        tmp = tmp_path_factory.mktemp(world)
        args = {"plan": plan, "cases": cases, "train_steps": TRAIN_STEPS,
                "ckpt": str(tmp / "ckpt") if world == "ep2" else None}
        out[world] = run_world("moe_ep", n, tmp, args, timeout=150)
    return out, refs


def _rows(rank_out):
    b = BASE["batch"] // rank_out["mesh"]["dp"] // rank_out["mesh"]["ep"]
    i = rank_out["data_index"]
    return slice(i * b, (i + 1) * b)


def _assert_params_close(got, want, bound, what):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        assert g.shape == w.shape, (what, path)
        err = np.abs(g - w).max()
        if bound[0] == "rel":
            err = err / np.abs(w).max()
        assert err <= bound[1], (what, path, err)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_forward_matches_unsharded_reference(worlds, world, case):
    ranks, refs = worlds[0][world], worlds[1][case]
    for r in ranks:
        np.testing.assert_allclose(r[case]["logits"],
                                   refs["logits"][_rows(r)],
                                   rtol=2e-4, atol=2e-4)
        assert r[case]["aux"] == pytest.approx(refs["aux"], rel=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_sgd_step_matches_unsharded_reference(worlds, world, case):
    ranks, refs = worlds[0][world], worlds[1][case]
    for r in ranks:                    # every rank reports the world's loss
        assert r[case]["sgd_loss"] == pytest.approx(refs["losses"][0],
                                                    rel=1e-5)
    _assert_params_close(ranks[0][case]["sgd"], refs["sgd"], ("rel", 1e-5),
                         "sgd")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_moe_loss_falls_over_five_steps(worlds, world):
    for r in worlds[0][world]:
        for case in CASES:
            losses = r[case]["losses"]
            assert len(losses) == TRAIN_STEPS
            assert np.isfinite(losses).all()
            assert losses[-1] < losses[0], (case, losses)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_each_rank_holds_its_experts_and_rows(worlds, world):
    """Every rank holds ``E / ep`` experts with ``d_ff / tp`` columns of
    each, and ``batch / (dp · ep)`` rows; the router is whole."""
    for r in worlds[0][world]:
        ep, tp = r["mesh"]["ep"], r["mesh"]["tp"]
        e, d, f = BASE["n_experts"], BASE["d_model"], BASE["d_ff"]
        local = r["top1"]["local"]
        for shape in ((d, e), (e // ep, d, f // tp), (e // ep, f // tp, d)):
            assert shape in local, (shape, local)
        assert r["top1"]["logits"].shape[0] == \
            BASE["batch"] // (r["mesh"]["dp"] * ep)


@pytest.mark.parametrize("case", ["top1", "top2_drop"])
def test_zero1_adamw_on_dp_ep_matches_unsharded_reference(worlds, case):
    """The moments within 1e-4 of their largest element; the parameters
    within 5e-5 absolute. AdamW's first step moves an element by
    ``lr · g / (|g| + eps)``, so where the first gradient is below 100 eps
    (1e-6) the sums' rounding moves that quotient freely: those elements
    are held to the largest move, ``lr``."""
    ranks, refs = worlds[0]["dp2xep2"], worlds[1][case]
    for r in ranks:
        assert r[case]["adamw_loss"] == pytest.approx(refs["adamw_loss"],
                                                      rel=1e-5)
    got, want = ranks[0][case]["adamw"], refs["adamw"]
    for key in ("mu", "nu"):
        _assert_params_close(got[key], want[key], ("rel", 1e-4), key)
    flat_w = jax.tree_util.tree_leaves_with_path(want["params"])
    flat_g = jax.tree_util.tree_leaves(got["params"])
    flat_d = jax.tree_util.tree_leaves(refs["grads"])
    assert len(flat_w) == len(flat_g) == len(flat_d)
    tiny = 0
    for (path, w), g, d in zip(flat_w, flat_g, flat_d):
        assert g.shape == w.shape, path
        err = np.abs(g - w)
        small = np.abs(d) < 1e-6
        tiny += int((small & (err > 5e-5)).sum())
        assert err[~small].max(initial=0.0) <= 5e-5, (path, err.max())
        assert err.max() <= ADAMW["lr"] * ADAMW_STEPS, path
    assert tiny <= 4, tiny


def test_zero1_specs_on_dp_ep_match_reference(worlds, jax8):
    """The moments' specs on dp 2 × ep 2 equal the reference's
    ``opt_state_shardings``: each expert moment adds ``dp`` alone (its
    parameter already uses ``ep``), each dense moment ``("dp", "ep")``;
    each rank holds the matching slice."""
    from jax.sharding import Mesh as JMesh

    from nvidia_terraform_modules_tpu.parallel import make_rules as jmake

    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2, 1, 1),
                  ("dp", "ep", "sp", "tp"))
    jcfg = jburnin.BurnInConfig(**BASE, dtype=jnp.float32)
    abstract = jax.eval_shape(
        lambda: jburnin.init_params(jax.random.PRNGKey(0), jcfg))
    want = jopt.opt_state_shardings(abstract, jmake(jmesh))["mu"]
    flat_w = {
        tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
        tuple(w.spec) for path, w in jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: hasattr(x, "spec"))}
    for r in worlds[0]["dp2xep2"]:
        flat_g = {}
        _tree_map_path(lambda path, spec: flat_g.setdefault(path, spec),
                       r["top1"]["zero1_specs"])
        assert flat_g == flat_w
        experts = [s for p, s in flat_g.items() if "experts_up" in p]
        assert experts and all(s[0] == "ep" and "dp" in s for s in experts)
        # each rank's moment is a dp slice of its expert shard (ep already
        # splits it) and a dp × ep slice of every dense leaf
        for p_shape, m_shape in zip(r["top1"]["local"],
                                    r["top1"]["zero1_local"]):
            ratio = 2 if len(p_shape) == 3 else 4
            assert np.prod(m_shape) * ratio == np.prod(p_shape), (p_shape,
                                                                  m_shape)


def test_ep_sharded_checkpoint_round_trip(worlds):
    for r in worlds[0]["ep2"]:
        assert r["ckpt"] == {"step": 1, "equal": True}


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


@pytest.mark.parametrize("case", ["top1", "top2_drop"])
def test_world_of_one_moe_step_equals_unsharded_bitwise(world_of_one, case):
    cfg = BurnInConfig(**BASE, **CASES[case], dtype=torch.float32)
    rules = make_rules(build_mesh(plan_mesh(1)))
    jcfg = jburnin.BurnInConfig(**BASE, **CASES[case], dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jburnin.init_params(
        jax.random.PRNGKey(9), jcfg)), cfg, device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
    sharded = make_train_step(cfg, rules, lr=LR, device="cpu")
    plain = make_train_step(cfg, lr=LR, device="cpu")
    ps, pp = params, params
    for _ in range(3):
        ps, loss_s = sharded(ps, batch)
        pp, loss_p = plain(pp, batch)
        assert torch.equal(loss_s, loss_p)
    for a, b in zip(tree_leaves(ps), tree_leaves(pp)):
        assert torch.equal(a, b)


def test_moe_refuses_sp_and_an_ep_that_does_not_divide():
    """``sp > 1`` with MoE stays refused on a one-process mesh, and an
    ``ep`` that does not divide the experts is a ValueError; on a world
    mesh ``sp > 1`` is now accepted (the burn-in gathers the sequence
    before routing: ``tests/test_torch_sp_world.py`` holds it to the
    reference)."""
    from nvidia_terraform_modules_tpu_torch.models.moe import check_rules

    cfg = BurnInConfig(**BASE, dtype=torch.float32)
    rules = make_rules(build_mesh(plan_mesh(2, sp=2),
                                  devices=[torch.device("cpu")] * 2))
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        check_rules(rules, cfg)

    from nvidia_terraform_modules_tpu_torch.parallel.mesh import WorldMesh

    fake = WorldMesh(np.arange(6).reshape(1, 3, 1, 2),
                     ("dp", "ep", "sp", "tp"), 0, torch.device("cpu"), {})
    with pytest.raises(ValueError, match="ep = 3 must divide n_experts"):
        check_rules(make_rules(fake), cfg)
    fake_sp = WorldMesh(np.arange(4).reshape(2, 2, 1),
                        ("dp", "sp", "tp"), 0, torch.device("cpu"), {})
    assert check_rules(make_rules(fake_sp), cfg) is None
