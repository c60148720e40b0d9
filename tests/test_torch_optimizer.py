# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, AdamW against the JAX reference's ``models/optimizer.py``:
the warmup + cosine schedule, ``adamw_update`` leaf by leaf with the
reference's state carried in through ``opt_state_from_numpy``, and whole
AdamW train steps on shared weights and one numpy batch.

Tolerances (f32): schedule 5e-7 relative (a few f32 ulps: the two
libraries' ``cos`` differ by one); one update 1e-6 (``pow``,
``sqrt`` and ``cos`` may differ by an ulp between the two libraries);
train steps 1e-5 (the gradients' own tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import optimizer as jopt
from nvidia_terraform_modules_tpu_torch.models import (
    AdamWConfig,
    BurnInConfig,
    adamw_update,
    init_opt_state,
    lr_at,
    make_adamw_train_step,
    opt_state_from_numpy,
    params_from_numpy,
    params_to_numpy,
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
