# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, ``parallel/`` and the sequence-parallel burn-in step against
the JAX reference:

- ``plan_mesh`` against the reference's over a grid of (n, tp, sp, ep),
  its errors included; ``build_mesh``, ``make_rules`` and the specs;
- ``ring_permute`` and ``all_to_all`` against ``jax.lax.ppermute`` /
  ``jax.lax.all_to_all(tiled=True)`` under the reference's ``shard_map``
  on its virtual 8-device CPU mesh; ``ring_map`` cuts and joins;
- the burn-in with ``rules`` (``attn="ring"`` and ``"ulysses"``) on a
  mesh ``sp = 4`` of repeated CPU devices against the reference on
  ``build_mesh(plan_mesh(4, tp=1, sp=4), devices=jax.devices()[:4])``:
  loss and every gradient (f32, weights carried by ``params_from_numpy``),
  then three SGD steps;
- the refusals: dp or tp above 1, and the sharded AdamW step.

Tolerances (f32): loss and gradients atol 1e-5, rtol 1e-4 (the reference's
8-row shards run its interpret-mode flash sweeps, the port's the plain
K2/K5); SGD parameters 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.parallel import mesh as jmesh_mod
from nvidia_terraform_modules_tpu.parallel import sharding as jsharding
from nvidia_terraform_modules_tpu.utils.compat import shard_map
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    forward_and_aux,
    init_params,
    make_adamw_train_step,
    make_grads_fn,
    make_train_step,
    params_from_numpy,
    params_to_numpy,
    synthetic_batch,
)
from nvidia_terraform_modules_tpu_torch.parallel import (
    Mesh,
    all_to_all,
    build_mesh,
    make_rules,
    plan_mesh,
    ring_map,
    ring_permute,
)

tburnin = importlib.import_module(
    "nvidia_terraform_modules_tpu_torch.models.burnin")
CPU = torch.device("cpu")


def _tmesh(n, **kw):
    return build_mesh(plan_mesh(n, **kw), devices=[CPU] * n)


# ---------------------------------------------------------------- mesh

def _plan_or_error(fn, *args, **kw):
    try:
        plan = fn(*args, **kw)
    except ValueError as e:
        return ("error", str(e))
    return (tuple(plan.axis_names), tuple(plan.shape), plan.n_devices,
            plan.describe())


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16, 0])
def test_plan_mesh_matches_reference(n):
    for tp in (None, 1, 2, 4, 3):
        for sp in (1, 2, 4):
            for ep in (1, 2, 0):
                kw = dict(tp=tp, sp=sp, ep=ep)
                assert _plan_or_error(plan_mesh, n, **kw) == _plan_or_error(
                    jmesh_mod.plan_mesh, n, **kw), kw
    names = ("a", "b", "c")
    for ep in (1, 2):
        assert _plan_or_error(plan_mesh, 4, ep=ep, axis_names=names) == \
            _plan_or_error(jmesh_mod.plan_mesh, 4, ep=ep, axis_names=names)


def test_build_mesh_shapes_and_refusals():
    mesh = _tmesh(8, tp=2, sp=2)
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ("dp", "sp", "tp")
    assert mesh.shape == {"dp": 2, "sp": 2, "tp": 2} and mesh.size == 8
    assert mesh.devices.shape == (2, 2, 2)
    assert all(d == CPU for d in mesh.devices.flat)
    assert mesh.shape == dict(jmesh_mod.build_mesh(
        jmesh_mod.plan_mesh(8, tp=2, sp=2), devices=jax.devices()[:8]).shape)
    with pytest.raises(ValueError, match="wants 4 devices"):
        build_mesh(plan_mesh(4), devices=[CPU] * 2)
    assert build_mesh(devices=[CPU] * 4).shape == {"dp": 1, "sp": 1,
                                                   "tp": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh()


@pytest.mark.parametrize("ep", [1, 2])
def test_rules_match_reference(ep):
    plan = plan_mesh(8, tp=2, ep=ep)
    rules = make_rules(build_mesh(plan, devices=[CPU] * 8))
    jrules = jsharding.make_rules(jmesh_mod.build_mesh(
        jmesh_mod.plan_mesh(8, tp=2, ep=ep), devices=jax.devices()[:8]))
    assert rules.data == jrules.data
    assert P(*rules.act()) == jrules.batch
    assert P(*rules.act("sp")) == jrules.batch_seq
    assert P(*rules.act("sp", "tp", None)) == jrules.act("sp", "tp", None)


# --------------------------------------------------------- collectives

def test_ring_permute_and_all_to_all_match_jax():
    n = 4
    data = np.random.default_rng(0).normal(size=(n, 8, 12)).astype(
        np.float32)
    jm = jmesh_mod.build_mesh(jmesh_mod.plan_mesh(n, tp=1, sp=n),
                              devices=jax.devices()[:n])
    spec = P("sp")

    def jax_run(body):
        out = shard_map(body, mesh=jm, in_specs=(spec,), out_specs=spec,
                        check_vma=False)(jnp.asarray(data.reshape(n * 8, 12)))
        return np.split(np.asarray(out), n)     # the per-device blocks

    perm = [(i, (i + 1) % n) for i in range(n)]
    want_hop = jax_run(lambda x: jax.lax.ppermute(x, "sp", perm))
    want_a2a = jax_run(lambda x: jax.lax.all_to_all(
        x, "sp", split_axis=1, concat_axis=0, tiled=True))
    tm = _tmesh(n, tp=1, sp=n)
    blocks = [torch.from_numpy(data[i]) for i in range(n)]
    got_hop = ring_permute(blocks, tm)
    got_a2a = all_to_all(blocks, tm, split_axis=1, concat_axis=0)
    for i in range(n):
        assert np.array_equal(got_hop[i].numpy(), want_hop[i])
        assert np.array_equal(got_a2a[i].numpy(), want_a2a[i])
    with pytest.raises(ValueError, match="ring of 4"):
        ring_permute(blocks[:3], tm)
    with pytest.raises(ValueError, match="split"):
        all_to_all([b[:, :6] for b in blocks], tm, split_axis=1,
                   concat_axis=0)


def test_ring_map_cuts_and_joins_by_spec():
    mesh = _tmesh(8, tp=2, sp=2)
    x = torch.arange(4 * 8 * 6 * 2, dtype=torch.float32).reshape(4, 8, 6, 2)
    seen = []

    def kernel(xs, coords):
        seen.append((dict(coords), [tuple(s.shape) for s in xs]))
        return [s * 1 for s in xs]

    assert torch.equal(ring_map(kernel, (x,), mesh, ("dp", "sp", "tp")), x)
    assert len(seen) == 4          # one ring per (dp, tp) group
    assert all(shapes == [(2, 4, 3, 2)] * 2 for _, shapes in seen)
    # an axis the spec leaves out replicates: only its coordinate 0 runs
    seen.clear()
    assert torch.equal(ring_map(kernel, (x,), mesh, (None, "sp")), x)
    assert [c for c, _ in seen] == [{}]
    for bad in (("dp", "sp", "dp"), ("dp", "xx"), ("dp", None, "tp")):
        with pytest.raises(ValueError):
            ring_map(kernel, (x,), mesh, bad)
    with pytest.raises(ValueError, match="does not split"):
        ring_map(kernel, (x[:, :7],), mesh, ("dp", "sp"))


# ------------------------------------------------- burn-in with rules

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=32, batch=2)


@pytest.fixture(scope="module")
def jrules():
    return jsharding.make_rules(jmesh_mod.build_mesh(
        jmesh_mod.plan_mesh(4, tp=1, sp=4), devices=jax.devices()[:4]))


def _assert_trees_close(got, want, atol, rtol=0.0):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol, err_msg=str(path))


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sharded_burnin_matches_reference(jrules, attn):
    jcfg = jburnin.BurnInConfig(**BASE, attn=attn, dtype=jnp.float32)
    tcfg = BurnInConfig(**BASE, attn=attn, dtype=torch.float32)
    rules = make_rules(_tmesh(4, tp=1, sp=4))
    jp = jburnin.init_params(jax.random.PRNGKey(len(attn)), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    stream = np.random.default_rng(3).integers(
        0, BASE["vocab"], size=(BASE["batch"], BASE["seq_len"] + 1),
        dtype=np.int32)
    jb = (jnp.asarray(stream[:, :-1]), jnp.asarray(stream[:, 1:]))
    tb = tuple(torch.from_numpy(x.astype(np.int64))
               for x in (stream[:, :-1], stream[:, 1:]))

    jloss, jgrads = jax.jit(jax.value_and_grad(jburnin.loss_fn),
                            static_argnums=(2, 3))(jp, jb, jcfg, jrules)
    loss, grads = make_grads_fn(tcfg, rules)(tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-4)
    _assert_trees_close(params_to_numpy(grads), jgrads, atol=1e-5, rtol=1e-4)

    jstep = jburnin.make_train_step(jcfg, jrules, lr=0.05)
    step = make_train_step(tcfg, rules, lr=0.05)
    for _ in range(3):
        jp, jl = jstep(jp, jb)
        tp, tl = step(tp, tb)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5,
                                   rtol=1e-4)
    _assert_trees_close(params_to_numpy(tp), jp, atol=1e-5)


def test_sharded_burnin_places_on_the_mesh_and_runs_its_attention(
        monkeypatch):
    """With rules, parameters and batch live on the mesh's first device and
    each layer's attention goes through the sharded op; without rules the
    ring layout runs dense attention, as in the reference."""
    cfg = BurnInConfig(**BASE, attn="ring", dtype=torch.float32)
    rules = make_rules(_tmesh(4, tp=1, sp=4))
    params = init_params(cfg, torch.Generator().manual_seed(0), rules=rules)
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg,
                            rules=rules)
    assert params["embed"].device == CPU and batch[0].device == CPU
    calls = []
    real = tburnin.ring_self_attention

    def spy(*a, **k):
        calls.append(k["spec"])
        return real(*a, **k)

    monkeypatch.setattr(tburnin, "ring_self_attention", spy)
    logits, _ = forward_and_aux(params, batch[0], cfg, rules)
    assert calls == [("dp", "sp", "tp", None)] * cfg.n_layers
    dense, _ = forward_and_aux(params, batch[0], cfg)
    assert len(calls) == cfg.n_layers
    assert torch.allclose(logits, dense, atol=1e-5, rtol=0)


def test_sharded_training_refusals():
    cfg = BurnInConfig(**BASE, attn="ring", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(tp=2, sp=2), dict(tp=1, sp=2)):   # tp = 2, dp = 2
        rules = make_rules(_tmesh(4, **kw))
        for call in (lambda: make_train_step(cfg, rules),
                     lambda: make_grads_fn(cfg, rules),
                     lambda: init_params(cfg, gen, rules=rules),
                     lambda: synthetic_batch(gen, cfg, rules=rules)):
            with pytest.raises(NotImplementedError, match="Queue A item 6"):
                call()
    rules = make_rules(_tmesh(4, tp=1, sp=4))
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        make_adamw_train_step(cfg, rules)
