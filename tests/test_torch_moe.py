# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the MoE layer and the MoE model against the JAX reference
on the CPU.

Both sides load the reference's weights (``init_moe_params`` /
``init_params`` → numpy → the port) and the same seeded numpy inputs, at
f32. Tolerances: the layer, ``forward_and_aux`` (logits and aux), the loss
and its gradients within atol 1e-5 (gradients rtol 1e-4, as
``test_torch_train.py``); a chunk-routed 150-token prefill within 1e-4;
every greedy, int8, sampled and speculative token EQUAL to the reference's.
Configurations: 2 layers, d_model 32, 4 experts, top-1 and top-2; the
serving ones at ``capacity_factor=4.0``, where the factor's capacity drops
nothing, so the full forward and the drop-free cached paths route alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int8_matmul import jax_qtree_to_numpy

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import decode as jdecode
from nvidia_terraform_modules_tpu.models import moe as jmoe
from nvidia_terraform_modules_tpu.models import quantize as jquant
from nvidia_terraform_modules_tpu.models import serving as jserving
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    QTensor,
    drop_free_capacity,
    expert_capacity,
    forward,
    forward_and_aux,
    forward_cached,
    greedy_decode,
    init_cache,
    init_params,
    loss_fn,
    make_grads_fn,
    make_quantized_decoder,
    make_serve_engine,
    moe_layer,
    params_from_numpy,
    params_to_numpy,
    qparams_from_numpy,
    quantize_params,
    serve,
    train_step_flops,
)
from nvidia_terraform_modules_tpu_torch.parallel import (
    build_mesh,
    make_rules,
    plan_mesh,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2, n_experts=4, capacity_factor=4.0)


def _cfgs(dtype="f32", **over):
    kw = {**BASE, **over}
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    return jburnin.BurnInConfig(**kw, dtype=jd), BurnInConfig(**kw, dtype=td)


def _pair(seed=0, **over):
    jcfg, cfg = _cfgs(**over)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jcfg, jp, cfg, params


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=(4 + (i % 3) * 2,)).astype(np.int32)
            for i in range(n)]


def _layer_params(jp):
    return {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize("top_k,factor", [(1, 1.25), (2, 1.25), (1, 0.05),
                                          (2, 0.3)],
                         ids=["top1", "top2", "top1-drops", "top2-drops"])
def test_moe_layer_matches_reference(top_k, factor):
    """Outputs and the Switch aux against the reference's ``moe_layer`` at
    the factor capacity; at a tiny factor (``tests/test_moe.py:72``) the
    same tokens drop to exact zeros on both sides."""
    jcfg, cfg = _cfgs(n_layers=1, batch=8, seq_len=64, router_top_k=top_k,
                      capacity_factor=factor)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(top_k), jcfg)
    x = np.random.default_rng(1).normal(size=(8, 64, 32)).astype(np.float32)
    want, want_aux = jax.jit(jmoe.moe_layer, static_argnums=2)(
        jnp.asarray(x), jp, jcfg)
    got, aux = moe_layer(torch.from_numpy(x), _layer_params(jp), cfg)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-5,
                               rtol=0)
    dropped = (got.numpy() == 0).all(-1)
    assert np.array_equal(dropped, (want == 0).all(-1))
    assert dropped.any() == (factor < 1)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layer_ties_route_to_the_lowest_expert(top_k):
    """A zero token has a uniform router: ``jax.lax.top_k`` takes the lowest
    indices, and so must the port (padding tokens of a chunked prefill are
    such tokens)."""
    jcfg, cfg = _cfgs(n_layers=1, router_top_k=top_k)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(3), jcfg)
    x = np.zeros((1, 8, 32), np.float32)
    x[0, 4:] = np.random.default_rng(2).normal(size=(4, 32))
    want, want_aux = jmoe.moe_layer(jnp.asarray(x), jp, jcfg, capacity=8)
    got, aux = moe_layer(torch.from_numpy(x), _layer_params(jp), cfg,
                         capacity=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6)


def test_capacity_matches_reference():
    for tokens in (1, 4, 7, 8, 64, 150, 1024, 4096):
        assert drop_free_capacity(tokens) == jmoe.drop_free_capacity(tokens)
        for e in (1, 4, 8):
            for factor in (0.05, 1.0, 1.25, 4.0):
                assert expert_capacity(tokens, e, factor) == \
                    jmoe.expert_capacity(tokens, e, factor)


@pytest.mark.parametrize("plan", [dict(sp=2), dict(tp=2), dict(ep=2, tp=1),
                                  dict(ep=2, tp=2)],
                         ids=["sp2", "dp2", "ep2", "ep2xtp2"])
def test_moe_layer_refuses_a_sharded_mesh(plan):
    """A one-process mesh is no longer refused: the lock-step layer
    (``lockstep_moe``; rows over the data axes, experts over ``ep``,
    ``d_ff`` over ``tp``) gives the reference's unsharded ``moe_layer``
    output and aux (atol 1e-5, as above), top-2 at a capacity that
    drops tokens."""
    jcfg, cfg = _cfgs(n_layers=1, batch=4, seq_len=8, router_top_k=2,
                      capacity_factor=0.5)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(5), jcfg)
    x = np.random.default_rng(5).normal(size=(4, 8, 32)).astype(np.float32)
    want, want_aux = jax.jit(jmoe.moe_layer, static_argnums=2)(
        jnp.asarray(x), jp, jcfg)
    n = 4 if len(plan) > 1 or "tp" in plan else 2
    rules = make_rules(build_mesh(plan_mesh(n, **plan),
                                  devices=[torch.device("cpu")] * n))
    got, aux = moe_layer(torch.from_numpy(x), _layer_params(jp), cfg, rules)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-5)


# ------------------------------------------------------------ the trees

def test_moe_trees_keep_the_router_f32_and_the_experts_dense():
    """bf16 config: the router is f32 in every tree the port builds or
    loads, the expert stacks are dense 3-D tensors in ``cfg.dtype``, and
    ``quantize_params`` quantises the attention and the head only (the
    reference's rule), holding the reference's int8 values."""
    jcfg, cfg = _cfgs("bf16")
    jp = jburnin.init_params(jax.random.PRNGKey(5), jcfg)
    jq = jquant.quantize_params(jp, dtype=jnp.bfloat16)
    trees = {
        "init_params": init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"),
        "params_from_numpy": params_from_numpy(jax.tree.map(np.asarray, jp),
                                               cfg, device="cpu"),
        "qparams_from_numpy": qparams_from_numpy(jax_qtree_to_numpy(jq),
                                                 cfg, device="cpu"),
    }
    trees["quantize_params"] = quantize_params(trees["params_from_numpy"])
    for name, tree in trees.items():
        for layer in tree["layers"]:
            assert "up" not in layer and "down" not in layer, name
            moe = layer["moe"]
            assert moe["router"].dtype == torch.float32, name
            assert moe["router"].shape == (32, 4), name
            assert moe["experts_up"].shape == (4, 32, 64), name
            assert moe["experts_down"].shape == (4, 64, 32), name
            assert moe["experts_up"].dtype == torch.bfloat16, name
        quantised = name in ("qparams_from_numpy", "quantize_params")
        assert isinstance(tree["layers"][0]["wq"], QTensor) == quantised
    mine = trees["quantize_params"]["layers"][1]
    ref = trees["qparams_from_numpy"]["layers"][1]
    assert torch.equal(mine["wk"].q, ref["wk"].q)
    assert torch.equal(mine["moe"]["router"], ref["moe"]["router"])
    np.testing.assert_array_equal(
        mine["moe"]["router"].numpy(),
        np.asarray(jp["layers"][1]["moe"]["router"]))


def test_convert_refuses_a_tree_of_the_other_family():
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(np.asarray,
                      jburnin.init_params(jax.random.PRNGKey(0), jcfg))
    dense_cfg = BurnInConfig(**{**BASE, "n_experts": 0},
                             dtype=torch.float32)
    with pytest.raises(ValueError, match="lacks"):
        params_from_numpy(jp, dense_cfg, device="cpu")
    dense = jax.tree.map(np.asarray, jburnin.init_params(
        jax.random.PRNGKey(0), jburnin.BurnInConfig(
            **{**BASE, "n_experts": 0}, dtype=jnp.float32)))
    with pytest.raises(ValueError, match="moe/router"):
        params_from_numpy(dense, cfg, device="cpu")


# ---------------------------------------------------- forward and train

@pytest.mark.parametrize("top_k,attn", [(1, "dense"), (2, "flash")])
def test_forward_and_aux_matches_reference(top_k, attn):
    jcfg, jp, cfg, params = _pair(seed=top_k, router_top_k=top_k, attn=attn,
                                  capacity_factor=1.25)
    toks = np.random.default_rng(4).integers(0, 64, size=(2, 16),
                                             dtype=np.int32)
    want, want_aux = jax.jit(jburnin.forward_and_aux, static_argnums=2)(
        jp, jnp.asarray(toks), jcfg)
    got, aux = forward_and_aux(params, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-5,
                               rtol=0)
    assert aux.item() >= 2.0 * (1 - 1e-6)   # two layers, each >= 1


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_loss_and_grads_match_reference(top_k):
    """``loss_fn`` adds ``aux_loss_weight · aux``; its value and every
    gradient leaf (the router's through the gates and the aux) against
    ``jax.value_and_grad``."""
    jcfg, jp, cfg, params = _pair(seed=7, router_top_k=top_k,
                                  capacity_factor=1.25, aux_loss_weight=0.5)
    stream = np.random.default_rng(8).integers(0, 64, size=(2, 17),
                                               dtype=np.int32)
    batch = (stream[:, :-1], stream[:, 1:])
    jloss, jgrads = jax.jit(jax.value_and_grad(jburnin.loss_fn),
                            static_argnums=2)(
        jp, tuple(jnp.asarray(x) for x in batch), jcfg)
    loss, grads = make_grads_fn(cfg)(
        params, tuple(torch.from_numpy(x.astype(np.int64)) for x in batch))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=0)
    nll_only = loss_fn(params, tuple(torch.from_numpy(x.astype(np.int64))
                                     for x in batch),
                       BurnInConfig(**{**BASE, "router_top_k": top_k,
                                       "capacity_factor": 1.25,
                                       "aux_loss_weight": 0.0},
                                    dtype=torch.float32))
    assert loss.item() - nll_only.item() > 0.5 * 2.0 * (1 - 1e-5)
    flat_w = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_g = jax.tree_util.tree_leaves(params_to_numpy(grads))
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("over", [dict(), dict(router_top_k=2),
                                  dict(n_experts=0, capacity_factor=1.25)],
                         ids=["top1", "top2", "dense"])
def test_train_step_flops_matches_reference(over):
    jcfg, cfg = _cfgs(**over)
    assert train_step_flops(cfg) == jburnin.train_step_flops(jcfg)


# ------------------------------------------------------------- serving

def test_chunked_prefill_matches_reference_and_full_forward():
    """A 150-token prompt routes in two 128-token chunks (the second
    zero-padded): logits against the reference's ``forward_cached`` and the
    port's unchunked ``forward`` within 1e-4."""
    jcfg, jp, cfg, params = _pair(seed=2, seq_len=160)
    toks = np.random.default_rng(5).integers(0, 64, size=(1, 150),
                                             dtype=np.int32)
    want, _ = jdecode.forward_cached(jp, jnp.asarray(toks),
                                     jdecode.init_cache(jcfg, 1, 150), jcfg)
    got, cache = forward_cached(params, torch.from_numpy(toks).long(),
                                init_cache(cfg, 1, 150, device="cpu"), cfg)
    assert cache["pos"] == 150
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    full = forward(params, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("slots,top_k", [(2, 1), (6, 1), (2, 2)],
                         ids=["top1", "more-slots-than-requests", "top2"])
def test_moe_engine_tokens_equal_jax_serve(slots, top_k):
    """``tests/test_serving.py:69``: the routed serve path rides the paged
    engine; every request's tokens equal the JAX ``serve``'s and its own
    solo greedy decode, idle slots included."""
    jcfg, jp, cfg, params = _pair(seed=slots + top_k, router_top_k=top_k)
    prompts = _prompts(3, seed=slots)
    want = jserving.serve(jp, [jnp.asarray(p) for p in prompts], 4, jcfg,
                          slots=slots)
    got = serve(params, prompts, 4, cfg, slots=slots, device="cpu")
    for i, (g, w, p) in enumerate(zip(got, want, prompts)):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"request {i}"
        solo = greedy_decode(params, torch.from_numpy(p)[None], 4, cfg,
                             device="cpu")[0]
        assert torch.equal(g, solo), f"request {i}"


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_moe_quantized_decoder_tokens_equal_reference(cache_dtype):
    """``make_quantized_decoder`` over the reference's int8 MoE tree (router
    f32, experts dense): tokens equal the reference's decoder."""
    jcfg, jp, cfg, _ = _pair(seed=9, rope=True, n_kv_heads=2)
    jqp = jquant.quantize_params(jp, dtype=jnp.float32)
    qp = qparams_from_numpy(jax_qtree_to_numpy(jqp), cfg, device="cpu")
    prompt = np.random.default_rng(6).integers(0, 64, size=(2, 6),
                                               dtype=np.int32)
    want = np.asarray(jquant.make_quantized_decoder(
        jcfg, n_new=6, dtype=jnp.float32, cache_dtype=cache_dtype)(
        jqp, jnp.asarray(prompt)))
    got = make_quantized_decoder(cfg, n_new=6, dtype=torch.float32,
                                 cache_dtype=cache_dtype, device="cpu")(
        qp, torch.from_numpy(prompt))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["sampled", "spec"])
def test_moe_sampled_and_spec_engines_equal_jax(mode):
    """The sampled engine (one key, the same folds) and the ``spec_k``
    engine on an MoE config give the JAX engine's tokens."""
    jcfg, jp, cfg, params = _pair(seed=11)
    if mode == "sampled":
        prompts = _prompts(4, seed=12)
        engine_kw = dict(max_len=16, kv_block=4,
                         sampler=dict(temperature=5.0))
        run_kw = dict(slots=2)
        jrun, trun = (dict(rng=jax.random.PRNGKey(7)), dict(rng=7))
    else:
        prompts = [np.array(([3, 7, 11] * 4)[:8 + i], np.int32)
                   for i in range(3)]
        engine_kw = dict(max_len=24, kv_block=4, spec_k=3)
        run_kw = dict(slots=2)
        jrun, trun = {}, {}
    want = jserving.make_serve_engine(jp, jcfg, **engine_kw)(
        [jnp.asarray(p) for p in prompts], 6, **run_kw, **jrun)
    got = make_serve_engine(params, cfg, device="cpu", **engine_kw)(
        prompts, 6, **run_kw, **trun)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"request {i}"


def test_decoder_graph_key_walks_the_moe_subtree():
    """A replayed decoder is keyed on every tensor its graph reads: an MoE
    tree's key holds the router and both expert stacks, and a tree with
    another router has another key (its graph is captured anew)."""
    from nvidia_terraform_modules_tpu_torch.models.decode import _params_key

    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    key = _params_key(params)
    moe = params["layers"][1]["moe"]
    ptrs = {entry[0][0] for entry in key}
    assert {moe[k].data_ptr() for k in moe} <= ptrs
    other = {**params, "layers": [dict(params["layers"][0]), {
        **params["layers"][1],
        "moe": {**moe, "router": moe["router"].clone()}}]}
    assert _params_key(other) != key
