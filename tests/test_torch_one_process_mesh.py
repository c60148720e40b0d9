# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the lock-step form on a one-process mesh (``[cpu] * 4``:
one CPU named four times, the counterpart of a card named ``n`` times)
against the JAX reference:

- every plan of ``test_torch_sharded_train.CASES`` (dp × tp, tp 4, GQA,
  MoE over dp × sp, the ring over sp × tp, Ulysses and flash over sp 4, a
  sliding window over sp 4 and sp 2 × tp 2) and two MoE plans over ``ep``
  (ep 2 top-2, ep 2 × tp 2): three SGD steps of ``make_train_step(cfg,
  rules)`` from the reference's weights, held to the reference's
  unsharded step (its GSPMD step on the same plan computes the same
  function);
- ZeRO-1 AdamW on dp 2 × tp 2 against the reference's
  ``make_adamw_train_step(cfg, rules)`` on the same plan of its virtual
  CPU devices;
- that a ``tp`` 2 step's projections run at member width (a profile of
  the step's matrix products, with their shapes: no product of a whole
  ``wq``/``wo``/``up``/``down``), and the positions' devices;
- the public surface on such a mesh: ``init_params``/``synthetic_batch``
  keep the global tree and batch on the mesh's first device,
  ``forward_and_aux`` and ``loss_fn`` the global logits and loss;
- the serve engine's ``run(rules=)`` on ``[cpu] * 2`` (tp 2: greedy,
  sampled, one KV head, ``spec_k``, int8 weights, the host KV tier) and
  on ``[cpu] * 4`` (ep 2 × tp 2, MoE top-2; dp 2 × tp 2: greedy, sampled,
  the int8 pool, ``spec_k``, the host KV tier): each request's tokens EQUAL
  the JAX engine's unsharded (``test_torch_serving_sharded``'s cases and
  references), and the int8 pool's the port's unsharded int8 engine; the
  pool's buffers hold each member's KV heads, in a replica for each data
  coordinate;
- that a dp 2 × tp 2 decode step runs each data coordinate's rows alone
  and writes every replica of the cache.

Tolerances (f32), as the world's test: losses 1e-5 relative, each
parameter leaf ``max|Δ| / max|ref| <= 1e-5`` (the row-parallel sums and
the mean over the data coordinates change the order of sums); AdamW
parameters 5e-5 absolute (an update moves an element by up to ``lr``
whatever ``|g|``, so where ``|g|`` is near ``eps`` the gradients'
rounding moves it by a part of that).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_serving_sharded as served
from test_torch_sharded_train import BASE, CASES, LR, STEPS

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import optimizer as jopt
from nvidia_terraform_modules_tpu.parallel import mesh as jmesh_mod
from nvidia_terraform_modules_tpu.parallel import sharding as jsharding
from nvidia_terraform_modules_tpu_torch.models import (
    AdamWConfig,
    BurnInConfig,
    forward_and_aux,
    forward_cached,
    init_cache,
    init_paged_cache,
    init_params,
    loss_fn,
    make_adamw_train_step,
    make_serve_engine,
    make_train_step,
    params_from_numpy,
    params_to_numpy,
    quantize_params,
    synthetic_batch,
)
from nvidia_terraform_modules_tpu_torch.parallel import (
    Lockstep,
    build_mesh,
    make_rules,
    plan_mesh,
)

CPU = torch.device("cpu")
# CASES' plans, and MoE with the experts over ep
ALL = {**CASES,
       "moe_ep2_top2": (dict(tp=1, ep=2),
                        dict(attn="flash", n_experts=4, router_top_k=2)),
       "moe_ep2xtp2": (dict(tp=2, ep=2), dict(attn="dense", n_experts=4))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny and the test workers share the CPU: one
    intra-op thread a process (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rules(plan, n=4):
    return make_rules(build_mesh(plan_mesh(n, **plan), devices=[CPU] * n))


def _jcfg(over):
    return jburnin.BurnInConfig(**BASE, **over, dtype=jnp.float32)


def _tcfg(over):
    return BurnInConfig(**BASE, **over, dtype=torch.float32)


def _batch(seed):
    stream = np.random.default_rng(seed).integers(
        0, BASE["vocab"], size=(BASE["batch"], BASE["seq_len"] + 1),
        dtype=np.int32)
    return stream[:, :-1], stream[:, 1:]


def _reference(name):
    """The reference's weights and batch (numpy) for the case, and its
    losses and parameters after ``STEPS`` of its unsharded step."""
    jcfg = _jcfg(ALL[name][1])
    jp = jburnin.init_params(jax.random.PRNGKey(len(name)), jcfg)
    batch = _batch(len(name))
    params_np = jax.tree.map(np.asarray, jp)
    jstep = jburnin.make_train_step(jcfg, lr=LR)
    jb = tuple(jnp.asarray(x) for x in batch)
    losses = []
    for _ in range(STEPS):
        jp, loss = jstep(jp, jb)
        losses.append(float(loss))
    return params_np, batch, losses, jax.tree.map(np.asarray, jp)


def _rel_close(got, want, rel):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        assert g.shape == w.shape, path
        err = np.abs(g - np.asarray(w)).max() / np.abs(w).max()
        assert err <= rel, (path, err)


@pytest.mark.parametrize("name", sorted(ALL))
def test_one_process_step_matches_reference(name):
    plan, over = ALL[name]
    params_np, batch, ref_losses, ref_params = _reference(name)
    cfg, rules = _tcfg(over), _rules(plan)
    params = params_from_numpy(params_np, cfg, device="cpu")
    tb = tuple(torch.from_numpy(x).long() for x in batch)
    step = make_train_step(cfg, rules, lr=LR, device="cpu")
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, tb)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=0)
    _rel_close(params_to_numpy(params), ref_params, 1e-5)


def test_one_process_adamw_matches_reference_on_the_plan(jax8):
    over = dict(attn="dense", n_kv_heads=2)
    jrules = jsharding.make_rules(jmesh_mod.build_mesh(
        jmesh_mod.plan_mesh(4, tp=2), devices=jax.devices()[:4]))
    jcfg, cfg = _jcfg(over), _tcfg(over)
    jp = jburnin.init_params(jax.random.PRNGKey(11), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    stream = _batch(11)
    jinit, jstep = jopt.make_adamw_train_step(
        jcfg, jrules, jopt.AdamWConfig(lr=1e-2))
    init_state, step = make_adamw_train_step(
        cfg, _rules(dict(tp=2)), AdamWConfig(lr=1e-2), device="cpu")
    js, state = jinit(jp), init_state(params)
    jb = tuple(jnp.asarray(x) for x in stream)
    tb = tuple(torch.from_numpy(x).long() for x in stream)
    for _ in range(2):
        jp, js, jloss = jstep(jp, js, jb)
        params, state, loss = step(params, state, tb)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = params_to_numpy(params)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-5, rtol=0,
                                   err_msg=str(path))
    assert int(state["step"]) == 2
    assert state["mu"]["embed"].dtype == torch.float32


def test_tp2_projections_run_at_member_width():
    """A profile of one tp 2 step (``record_shapes=True``; dimensions that
    no activation shares): every matrix product's operands are a
    member's columns or rows — half of ``wq``/``wk``/``wv``/``up``, of
    ``wo``/``down`` and of the tied ``embed`` — and none is a whole
    weight."""
    d, f, v = 48, 112, 40
    cfg = BurnInConfig(vocab=v, d_model=d, n_heads=4, d_ff=f, n_layers=2,
                       seq_len=10, batch=2, attn="dense",
                       dtype=torch.float32)
    rules = _rules(dict(tp=2), n=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), rules=rules,
                         device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg,
                            rules=rules, device="cpu")
    step = make_train_step(cfg, rules, lr=LR, device="cpu")
    with torch.profiler.profile(record_shapes=True) as prof:
        step(params, batch)
    operands = {tuple(s) for e in prof.events() if e.name == "aten::mm"
                for s in e.input_shapes if len(s) == 2}
    whole = {(d, d), (d, f), (f, d), (v, d), (d, v)}
    member = {(d, d // 2), (d // 2, d), (d, f // 2), (f // 2, d),
              (v, d // 2), (d // 2, v)}
    assert operands and not whole & operands, sorted(operands)
    assert member <= operands, sorted(member - operands)


def test_positions_and_the_public_surface():
    """dp 2 × tp 2: four positions on the mesh's devices, the batch's rows
    cut over dp; ``init_params``/``synthetic_batch`` stay global on the
    first device; ``forward_and_aux`` and ``loss_fn`` give the global
    logits and mean loss, equal to the unsharded model's."""
    cfg = _tcfg(dict(attn="dense"))
    rules = _rules(dict(tp=2))
    ls = Lockstep(rules)
    assert (ls.n_data, ls.tp) == (2, 2)
    assert [ls.coords(c, j) for c in range(2) for j in range(2)] == [
        {"dp": 0, "tp": 0}, {"dp": 0, "tp": 1}, {"dp": 1, "tp": 0},
        {"dp": 1, "tp": 1}]
    params = init_params(cfg, torch.Generator().manual_seed(0), rules=rules,
                         device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg,
                            rules=rules, device="cpu")
    assert params["layers"][0]["wq"].shape == (BASE["d_model"],) * 2
    assert batch[0].shape == (BASE["batch"], BASE["seq_len"])
    assert torch.equal(ls.rows(batch[0], 1), batch[0][2:])
    wq = params["layers"][0]["wq"]
    assert torch.equal(ls.piece(wq, rules.param_sharding(
        ("layers", "0", "wq")), 1, 1), wq[:, BASE["d_model"] // 2:])
    logits, aux = forward_and_aux(params, batch[0], cfg, rules)
    plain, _ = forward_and_aux(params, batch[0], cfg)
    assert logits.shape == plain.shape
    np.testing.assert_allclose(logits.detach().numpy(),
                               plain.detach().numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss_fn(params, batch, cfg, rules)),
                               float(loss_fn(params, batch, cfg)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="tp = 4 must divide"):
        make_train_step(dataclasses.replace(cfg, n_heads=2), _rules(
            dict(tp=4)), device="cpu")


SERVE = ([("tp2", name) for name in ("greedy", "sampled", "kv_replicated",
                                     "int8_pool", "spec_k", "int8_weights",
                                     "host_spill")]
         + [("ep2xtp2", "moe_top2")]
         + [("dp2xtp2", name) for name in ("greedy", "sampled", "int8_pool",
                                           "spec_k", "host_spill")])


@pytest.mark.parametrize("world,name", SERVE)
def test_one_process_run_rules_matches_jax_engine(world, name):
    n, plan, slots, _ = served.WORLDS[world]
    _, jp, prompts = served._weights(name)
    over, engine_kw, run_kw = served.CASES[name]
    cfg = BurnInConfig(**served.BASE, **over, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    rules = _rules(plan, n)
    engine_kw = dict(engine_kw)
    if engine_kw.pop("quantized", False):
        params = quantize_params(params, torch.float32, rules)
    eng = make_serve_engine(params, cfg, device="cpu", **served.ENGINE,
                            **engine_kw)
    got = [t.tolist() for t in eng(prompts, served.N_NEW, slots=slots,
                                   rules=rules, **run_kw)]
    want = (served._port_unsharded(name, slots) if name == "int8_pool"
            else served._jax_tokens(name, slots))
    assert got == want
    # a pool on the mesh: each tp member's KV heads, contiguous on its
    # device, every head in the whole view
    pool = init_paged_cache(cfg, slots, served.ENGINE["max_len"],
                            block_size=served.ENGINE["kv_block"],
                            num_blocks=8, rules=rules)
    tp, kv = plan["tp"], cfg.kv_heads
    assert pool["k"][0].shape[2] == kv
    assert all(m.shape[2] == (kv // tp if kv % tp == 0 else kv)
               and m.is_contiguous() for m in pool["k"][0].members)
    # and a replica of it for each data coordinate
    assert len(pool["k"][0].replicas) == Lockstep(rules).n_data


def test_one_process_decode_splits_rows_over_data_coordinates():
    """dp 2 × tp 2 on ``[cpu] * 4``: each data coordinate runs its half of
    the rows (a profile of ``forward_cached``'s matrix products: every
    projection takes ``B / 2`` rows at a member's width, none the whole
    batch), and each member's fresh K/V rows land in every replica of the
    cache, equal to the unsharded cache's and the logits to the unsharded
    model's."""
    d, v, b, t = 48, 40, 4, 5
    cfg = BurnInConfig(vocab=v, d_model=d, n_heads=4, d_ff=112, n_layers=2,
                       seq_len=16, batch=b, attn="dense", dtype=torch.float32)
    rules = _rules(dict(tp=2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, v, (b, t),
                           generator=torch.Generator().manual_seed(1))
    cache = init_cache(cfg, b, 16, rules, device="cpu")
    plain = init_cache(cfg, b, 16, device="cpu")
    with torch.profiler.profile(record_shapes=True) as prof:
        logits, _ = forward_cached(params, tokens, cache, cfg, rules)
    rows = {tuple(s)[0] for e in prof.events() if e.name == "aten::mm"
            for s in e.input_shapes[:1] if len(s) == 2}
    assert rows == {b // 2 * t}, rows
    want, _ = forward_cached(params, tokens, plain, cfg)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5,
                               rtol=0)
    for key in ("k", "v"):
        for li in range(cfg.n_layers):
            buf = cache[key][li]
            for j in range(2):
                assert torch.equal(buf.member(0, j), buf.member(1, j))
            np.testing.assert_allclose(buf.whole().numpy(),
                                       plain[key][li].numpy(), atol=1e-5,
                                       rtol=0)
