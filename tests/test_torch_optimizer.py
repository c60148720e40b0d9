# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, AdamW against the JAX reference's ``models/optimizer.py``:
the warmup + cosine schedule, ``adamw_update`` leaf by leaf with the
reference's state carried in through ``opt_state_from_numpy``, and whole
AdamW train steps on shared weights and one numpy batch. ZeRO-1: the
moment specs against the reference's ``opt_state_shardings`` for the same
mesh plans; the sharded step in gloo worlds of 2 and 4
(``_torch_world.py``) against the reference's ``make_adamw_train_step(cfg,
rules)`` on a CPU JAX mesh of the same plan, moments included; a world of
one against the unsharded step, bit for bit.

Tolerances (f32): schedule 5e-7 relative (a few f32 ulps: the two
libraries' ``cos`` differ by one); one update 1e-6 (``pow``,
``sqrt`` and ``cos`` may differ by an ulp between the two libraries);
train steps 1e-5 (the gradients' own tolerance). The sharded steps:
losses 1e-5 relative; parameters within 5e-5 absolute and moments within
``max|Δ| / max|ref| <= 1e-4``, leaf by leaf. An AdamW update is
normalised: it moves an element by up to ``lr`` (1e-2) a step whatever
the gradient's scale, and where ``|g|`` is near ``eps`` the gradient's
rounding (its sums run in another order over the ranks) moves it by a
part of that — the reference's own sharded and unsharded steps differ by
4.7e-6 here. A wrong slice moves whole elements by ``O(lr)``.
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
from nvidia_terraform_modules_tpu.parallel import mesh as jmesh
from nvidia_terraform_modules_tpu.parallel import sharding as jsharding
from nvidia_terraform_modules_tpu_torch.models import (
    AdamWConfig,
    BurnInConfig,
    abstract_train_state,
    adamw_update,
    init_opt_state,
    init_params,
    lr_at,
    make_adamw_train_step,
    opt_state_from_numpy,
    opt_state_shardings,
    params_from_numpy,
    params_to_numpy,
    synthetic_batch,
    tree_leaves,
)
from nvidia_terraform_modules_tpu_torch.models.burnin import _tree_map_path
from nvidia_terraform_modules_tpu_torch.parallel import (
    build_mesh,
    make_rules,
    plan_mesh,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2)
SCHEDULES = {
    "constant": dict(),
    "warmup": dict(warmup_steps=3),
    "warmup-cosine": dict(warmup_steps=2, decay_steps=5, min_lr_ratio=0.1),
    "cosine": dict(decay_steps=4),
}


def _opt(name):
    kw = dict(lr=3e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              **SCHEDULES[name])
    return jopt.AdamWConfig(**kw), AdamWConfig(**kw)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_reference(name):
    jo, to = _opt(name)
    for step in range(0, 10):
        want = float(jopt.lr_at(jo, jnp.int32(step)))
        got = lr_at(to, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=5e-7, atol=0)


def _tree(seed):
    jp = jburnin.init_params(jax.random.PRNGKey(seed),
                             jburnin.BurnInConfig(**BASE,
                                                  dtype=jnp.float32))
    return jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("start", [0, 4])
def test_adamw_update_matches_reference(name, start):
    jo, to = _opt(name)
    cfg = BurnInConfig(**BASE, dtype=torch.float32)
    rng = np.random.default_rng(start + len(name))
    params = _tree(1)

    def noise(scale):
        return jax.tree.map(
            lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
            params)

    grads, mu = noise(0.1), noise(0.01)
    nu = jax.tree.map(np.abs, noise(1e-3))
    jstate = {"step": np.int32(start), "mu": mu, "nu": nu}
    want_p, want_s = jopt.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, jstate), jo)
    got_p, got_s = adamw_update(
        params_from_numpy(params, cfg, device="cpu"),
        params_from_numpy(grads, cfg, device="cpu"),
        opt_state_from_numpy(jstate, device="cpu"), to)
    assert got_s["step"].dtype == torch.int32
    assert int(got_s["step"]) == int(want_s["step"]) == start + 1
    for got, want in ((got_p, want_p), (got_s["mu"], want_s["mu"]),
                      (got_s["nu"], want_s["nu"])):
        for g, w in zip(jax.tree.leaves(params_to_numpy(got)),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6,
                                       rtol=1e-6)


def test_moments_stay_f32_for_bf16_params():
    cfg = BurnInConfig(**BASE, dtype=torch.bfloat16)
    params = params_from_numpy(_tree(2), cfg, device="cpu")
    state = init_opt_state(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    grads = {"embed": torch.ones_like(params["embed"]),
             "out_norm": torch.ones_like(params["out_norm"]),
             "layers": [{k: torch.ones_like(t) for k, t in layer.items()}
                        for layer in params["layers"]]}
    new_p, new_s = adamw_update(params, grads, state, AdamWConfig())
    assert new_p["embed"].dtype == torch.bfloat16
    assert new_s["mu"]["embed"].dtype == torch.float32
    assert new_s["nu"]["layers"][0]["wq"].dtype == torch.float32


def test_adamw_train_steps_match_reference():
    kw = {**BASE, "attn": "flash"}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    tcfg = BurnInConfig(**kw, dtype=torch.float32)
    jo, to = _opt("warmup-cosine")
    jp = jburnin.init_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    stream = np.random.default_rng(4).integers(
        0, tcfg.vocab, size=(tcfg.batch, tcfg.seq_len + 1), dtype=np.int32)
    jb = (jnp.asarray(stream[:, :-1]), jnp.asarray(stream[:, 1:]))
    tb = tuple(torch.from_numpy(x.astype(np.int64))
               for x in (stream[:, :-1], stream[:, 1:]))
    jinit, jstep = jopt.make_adamw_train_step(jcfg, opt=jo)
    tinit, tstep = make_adamw_train_step(tcfg, opt=to, device="cpu")
    js, ts = jinit(jp), tinit(tp)
    losses = []
    for _ in range(3):
        jp, js, jloss = jstep(jp, js, jb)
        tp, ts, loss = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                                   rtol=1e-4)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for g, w in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ ZeRO-1

def _jrules(n, tp):
    """The reference's rules on a CPU JAX mesh of ``plan_mesh(n, tp=tp)``."""
    plan = jmesh.plan_mesh(n, tp=tp)
    return jsharding.make_rules(jmesh.build_mesh(plan,
                                                 devices=jax.devices()[:n]))


def _rules(n, tp):
    """The port's rules for the same plan on a one-process mesh of ``n``
    CPU positions: the specs read only the axis sizes."""
    return make_rules(build_mesh(plan_mesh(n, tp=tp),
                                 devices=[torch.device("cpu")] * n))


@pytest.mark.parametrize("n, tp", [(4, None), (4, 2), (8, 2), (4, 1)],
                         ids=["plan_mesh(4)", "dp2xtp2", "dp4xtp2", "dp4"])
@pytest.mark.parametrize("over", [{}, dict(d_model=18, n_heads=3,
                                           d_ff=36)],
                         ids=["even", "odd_widths"])
def test_zero1_specs_match_reference(jax8, n, tp, over):
    """Every moment's spec equals the reference's ``opt_state_shardings``
    for the same plan (``odd_widths``: a ``d_model`` of 18, which dp 4
    does not divide, so the norms and the projections keep their
    parameter's spec there)."""
    from nvidia_terraform_modules_tpu.models import optimizer as jo

    kw = {**BASE, **over}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    abstract = jax.eval_shape(
        lambda: jburnin.init_params(jax.random.PRNGKey(0), jcfg))
    want = jo.opt_state_shardings(abstract, _jrules(n, tp))
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    got = opt_state_shardings(
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
        _rules(n, tp))
    assert got["step"] == () and tuple(want["step"].spec) == ()
    flat_w = {
        tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
        tuple(w.spec) for path, w in jax.tree_util.tree_leaves_with_path(
            want["mu"], is_leaf=lambda x: hasattr(x, "spec"))}
    flat_g = {}
    _tree_map_path(lambda path, spec: flat_g.setdefault(path, spec),
                   got["nu"])
    assert flat_g == flat_w


def test_zero1_keeps_the_param_spec_when_no_dimension_divides(jax8):
    """A norm of odd length on dp 4: no dimension divides, so its moments
    keep the parameter's own (replicated) spec, as the reference's do."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nvidia_terraform_modules_tpu.models import optimizer as jo
    from nvidia_terraform_modules_tpu_torch.models.optimizer import (
        _zero1_spec,
    )

    jr = _jrules(4, 1)
    for shape in ((6,), (6, 4), (4, 6), (8, 6)):
        leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
        want = jo._zero1_sharding(leaf, NamedSharding(jr.mesh, P()), jr)
        assert _zero1_spec(shape, (), _rules(4, 1)) == tuple(want.spec)
    assert _zero1_spec((6,), (), _rules(4, 1)) == (None,)


def _zero1_reference(n, tp, name, dtype=jnp.float32):
    """Shared weights and batch (numpy), and the reference's sharded AdamW
    after ``ZERO1_STEPS`` steps: losses, params and moments."""
    from nvidia_terraform_modules_tpu.models import optimizer as jo

    jcfg = jburnin.BurnInConfig(**ZERO1_BASE, dtype=dtype)
    jr = _jrules(n, tp)
    jp = jburnin.init_params(jax.random.PRNGKey(len(name)), jcfg, jr)
    stream = np.random.default_rng(len(name)).integers(
        0, jcfg.vocab, size=(jcfg.batch, jcfg.seq_len + 1), dtype=np.int32)
    batch = (stream[:, :-1], stream[:, 1:])
    params_np = jax.tree.map(np.asarray, jp)
    init_state, step = jo.make_adamw_train_step(
        jcfg, jr, jo.AdamWConfig(**ZERO1_OPT))
    js = init_state(jp)
    jb = tuple(jnp.asarray(x) for x in batch)
    losses = []
    for _ in range(ZERO1_STEPS):
        jp, js, loss = step(jp, js, jb)
        losses.append(float(loss))
    # a ZeRO-1 moment really is dp-sharded on the reference's side too
    return (params_np, batch, losses,
            {k: jax.tree.map(np.asarray, v) for k, v in
             (("params", jp), ("mu", js["mu"]), ("nu", js["nu"]))})


ZERO1_BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
                  seq_len=16, batch=8)
ZERO1_OPT = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1)
ZERO1_STEPS = 3
# world size → {case name: tp}
ZERO1_WORLDS = {2: {"dp2": 1}, 4: {"dp2xtp2": 2, "dp4": 1}}


@pytest.fixture(scope="module")
def zero1_worlds(tmp_path_factory, jax8):
    out = {}
    for n, cases in ZERO1_WORLDS.items():
        refs = {name: _zero1_reference(n, tp, name)
                for name, tp in cases.items()}
        args = [{"name": name, "tp": tp, "cfg": ZERO1_BASE,
                 "params": refs[name][0], "batch": refs[name][1],
                 "opt": ZERO1_OPT, "steps": ZERO1_STEPS}
                for name, tp in cases.items()]
        if n == 2:      # bf16 parameters: their moments stay f32
            args.append({**args[0], "name": "dp2_bf16", "dtype": "bfloat16"})
        ranks = run_world("zero1_adamw", n, tmp_path_factory.mktemp("z1"),
                          {"cases": args}, timeout=150)
        for name in cases:
            out[name] = (ranks, refs[name])
        if n == 2:
            out["dp2_bf16"] = (ranks, None)
    return out


def _assert_trees_close(got, want, what):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        assert g.shape == w.shape, (what, path)
        err = np.abs(g - w).max()
        if what == "params":
            assert err <= 5e-5, (what, path, err)
        else:
            assert err / np.abs(w).max() <= 1e-4, (what, path, err)


@pytest.mark.parametrize("name", ["dp2", "dp2xtp2", "dp4"])
def test_zero1_adamw_matches_reference(zero1_worlds, name):
    ranks, (_, _, ref_losses, ref) = zero1_worlds[name]
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], ref_losses, rtol=1e-5,
                                   atol=0)
        assert r[name]["step"] == ZERO1_STEPS
    for key in ("params", "mu", "nu"):
        _assert_trees_close(ranks[0][name][key], ref[key], key)


@pytest.mark.parametrize("name", ["dp2", "dp2xtp2", "dp4"])
def test_zero1_moments_hold_a_data_slice(zero1_worlds, name):
    """Each rank holds ``1 / dp`` of every moment whose parameter has a
    dimension the data axes divide (all of them at these widths), f32."""
    ranks, _ = zero1_worlds[name]
    for r in ranks:
        dp = r[name]["mesh"]["dp"]
        for p_shape, m_shape, dtype in r[name]["local"]:
            assert dtype == "torch.float32"
            assert np.prod(m_shape) * dp == np.prod(p_shape), (p_shape,
                                                               m_shape)


def test_zero1_moments_stay_f32_for_bf16_params(zero1_worlds):
    ranks, _ = zero1_worlds["dp2_bf16"]
    for r in ranks:
        rec = r["dp2_bf16"]
        assert rec["step"] == ZERO1_STEPS
        assert all(dtype == "torch.float32" for _, _, dtype in rec["local"])
        assert rec["losses"][-1] < rec["losses"][0]


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


def test_zero1_world_of_one_equals_unsharded_bitwise(world_of_one):
    cfg = BurnInConfig(**ZERO1_BASE, attn="flash", dtype=torch.float32)
    rules = make_rules(build_mesh(plan_mesh(1)))
    assert type(rules.mesh).__name__ == "WorldMesh"
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(2), cfg,
                            device="cpu")
    opt = AdamWConfig(**ZERO1_OPT)
    s_init, s_step = make_adamw_train_step(cfg, rules, opt, device="cpu")
    u_init, u_step = make_adamw_train_step(cfg, opt=opt, device="cpu")
    ps, ss = params, s_init(params)
    pu, su = params, u_init(params)
    for _ in range(ZERO1_STEPS):
        ps, ss, ls = s_step(ps, ss, batch)
        pu, su, lu = u_step(pu, su, batch)
        assert torch.equal(ls, lu)
    for a, b in zip(tree_leaves([ps, ss["mu"], ss["nu"]]),
                    tree_leaves([pu, su["mu"], su["nu"]])):
        assert torch.equal(a, b)
    assert torch.equal(ss["step"], su["step"])


def test_abstract_train_state_matches_reference(jax8):
    """The abstract state's leaves — paths as the checkpoint names them,
    shapes and dtypes — equal the reference's ``abstract_train_state``
    (dense and MoE, bf16 parameters: f32 moments, an int32 step); nothing
    is allocated, and without rules every leaf is whole."""
    from nvidia_terraform_modules_tpu.models import optimizer as jo
    from nvidia_terraform_modules_tpu_torch.models.checkpoint import (
        _DTYPE_NAMES,
        _flatten,
    )

    for over in ({}, dict(n_experts=2)):
        kw = dict(ZERO1_BASE, n_kv_heads=2, **over)
        want = jo.abstract_train_state(
            jburnin.BurnInConfig(**kw, dtype=jnp.bfloat16))
        got = abstract_train_state(
            BurnInConfig(**kw, dtype=torch.bfloat16), device="cpu")
        flat_w = [(jax.tree_util.keystr(p), w)
                  for p, w in jax.tree_util.tree_leaves_with_path(want)]
        flat_g = _flatten(got)
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, a), (_, w) in zip(flat_g, flat_w):
            assert a.shape == tuple(w.shape), path
            assert _DTYPE_NAMES[a.dtype] == np.dtype(w.dtype).name, path
            assert a.mesh is None and a.bounds() == [[0, d]
                                                      for d in a.shape]
