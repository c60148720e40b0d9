# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the burn-in train step against the JAX reference on shared
weights: the loss and every gradient leaf against
``jax.value_and_grad(loss_fn)`` (the reference's flash path runs its Pallas
kernels in interpret mode), three SGD steps against the reference's
``make_train_step``, and inside the port remat and gradient accumulation
against the plain pass.

Both sides load the reference's ``init_params`` weights (through
``params_from_numpy``) and one seeded numpy batch. Tolerances (f32): loss
and gradients atol 1e-5, rtol 1e-4; SGD parameters 1e-5; accumulation
1e-6 (the microbatch sums round in another order); remat bitwise (the
same kernels recompute the same numbers on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    forward,
    forward_and_aux,
    loss_fn,
    make_grads_fn,
    make_train_step,
    params_from_numpy,
    params_to_numpy,
    synthetic_batch,
    train_step_flops,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=4)


def _pair(seed=0, **over):
    kw = {**BASE, **over}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    tcfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, seed):
    stream = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(cfg.batch, cfg.seq_len + 1), dtype=np.int32)
    return stream[:, :-1], stream[:, 1:]


def _tbatch(batch):
    return tuple(torch.from_numpy(x.astype(np.int64)) for x in batch)


def _assert_trees_close(got, want, atol, rtol=0.0):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol, err_msg=str(path))


CASES = {
    "flash": dict(attn="flash"),
    "flash-split": dict(attn="flash", flash_backward="split"),
    "dense": dict(attn="dense"),
    "flash-gqa-rope": dict(attn="flash", n_kv_heads=2, rope=True),
    "dense-gqa-rope": dict(attn="dense", n_kv_heads=2, rope=True),
    "flash-window": dict(attn="flash", flash_window=5),
    "dense-window": dict(attn="dense", flash_window=5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_reference(case):
    jcfg, jp, tcfg, tp = _pair(seed=len(case), **CASES[case])
    batch = _batch(tcfg, seed=3)
    jloss, jgrads = jax.value_and_grad(jburnin.loss_fn)(
        jp, tuple(jnp.asarray(x) for x in batch), jcfg)
    loss, grads = make_grads_fn(tcfg)(tp, _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-4)
    _assert_trees_close(params_to_numpy(grads), jgrads, atol=1e-5,
                        rtol=1e-4)
    # the forward is the same function the inference oracle computes
    logits, aux = forward_and_aux(tp, _tbatch(batch)[0], tcfg)
    assert float(aux) == 0.0
    assert torch.allclose(logits, forward(tp, _tbatch(batch)[0], tcfg),
                          atol=1e-6, rtol=0)


def test_three_sgd_steps_match_reference():
    jcfg, jp, tcfg, tp = _pair(seed=5, attn="flash")
    batch = _batch(tcfg, seed=4)
    jstep = jburnin.make_train_step(jcfg, lr=0.05)
    step = make_train_step(tcfg, lr=0.05, device="cpu")
    jb, tb = tuple(jnp.asarray(x) for x in batch), _tbatch(batch)
    for _ in range(3):
        jp, jloss = jstep(jp, jb)
        tp, loss = step(tp, tb)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                                   rtol=1e-4)
    _assert_trees_close(params_to_numpy(tp), jp, atol=1e-5)


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_remat_is_exact(attn):
    _, _, tcfg, tp = _pair(seed=6, attn=attn, n_kv_heads=2)
    batch = _tbatch(_batch(tcfg, seed=5))
    loss, grads = make_grads_fn(tcfg)(tp, batch)
    rcfg = BurnInConfig(**{**BASE, "attn": attn, "n_kv_heads": 2,
                           "remat": True}, dtype=torch.float32)
    rloss, rgrads = make_grads_fn(rcfg)(tp, batch)
    assert torch.equal(loss, rloss)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(grads)),
                    jax.tree_util.tree_leaves(params_to_numpy(rgrads))):
        assert np.array_equal(a, b)


def test_grad_accumulation_matches_full_batch():
    _, _, tcfg, tp = _pair(seed=7, attn="flash")
    batch = _tbatch(_batch(tcfg, seed=6))
    loss, grads = make_grads_fn(tcfg)(tp, batch)
    aloss, agrads = make_grads_fn(tcfg, accum_steps=4)(tp, batch)
    assert abs(float(aloss) - float(loss)) <= 1e-6
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(agrads)),
                    jax.tree_util.tree_leaves(params_to_numpy(grads))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        make_grads_fn(tcfg, accum_steps=3)(tp, batch)
    with pytest.raises(ValueError, match="accum_steps"):
        make_grads_fn(tcfg, accum_steps=0)


def test_sgd_lowers_the_loss_and_leaves_the_input_params():
    """The on-CPU form of the reference's ``burnin_ok``: five SGD steps on
    one batch lower the loss; the step is functional."""
    _, _, tcfg, tp = _pair(seed=8, attn="flash")
    before = params_to_numpy(tp)
    batch = synthetic_batch(torch.Generator().manual_seed(1), tcfg,
                            device="cpu")
    step = make_train_step(tcfg, device="cpu")
    params, losses = tp, []
    for _ in range(5):
        params, loss = step(params, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(params_to_numpy(tp))):
        assert np.array_equal(a, b)


def test_bf16_step_keeps_dtypes():
    cfg = BurnInConfig(**{**BASE, "attn": "flash"}, dtype=torch.bfloat16)
    jp = jburnin.init_params(jax.random.PRNGKey(9), jburnin.BurnInConfig(
        **{**BASE, "attn": "flash"}))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    batch = _tbatch(_batch(cfg, seed=9))
    params, loss = make_train_step(cfg, device="cpu")(tp, batch)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.bfloat16
               for p in jax.tree_util.tree_leaves(
                   {"e": params["embed"], "l": params["layers"]}))


def test_synthetic_batch_is_next_token_and_seeded():
    cfg = BurnInConfig(**BASE, dtype=torch.float32)
    tok, tgt = synthetic_batch(torch.Generator().manual_seed(3), cfg,
                               device="cpu")
    tok2, _ = synthetic_batch(torch.Generator().manual_seed(3), cfg,
                              device="cpu")
    assert tok.shape == tgt.shape == (cfg.batch, cfg.seq_len)
    assert torch.equal(tok[:, 1:], tgt[:, :-1]) and torch.equal(tok, tok2)
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab


@pytest.mark.parametrize("over", [{}, {"n_kv_heads": 2},
                                  {"flash_window": 5, "attn": "flash"},
                                  {"seq_len": 64, "batch": 2}])
def test_train_step_flops_matches_reference(over):
    kw = {**BASE, **over}
    assert train_step_flops(BurnInConfig(**kw, dtype=torch.float32)) == \
        jburnin.train_step_flops(jburnin.BurnInConfig(**kw))


def test_config_validation_and_unported_levers():
    for kw, match in [(dict(flash_backward="bogus"), "flash_backward"),
                      (dict(flash_window=0), "flash_window"),
                      (dict(flash_window=4, attn="ring"), "flash_window")]:
        with pytest.raises(ValueError, match=match):
            BurnInConfig(**kw)
        with pytest.raises(ValueError, match=match):
            jburnin.BurnInConfig(**kw)
    cfg = BurnInConfig(**BASE, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        make_grads_fn(cfg, rules=object())
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        loss_fn({}, (None, None), cfg, rules=object())
