# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the sampled serve engine on the CPU.

The same numpy-made weights (``params_from_numpy``), prompts and PRNG key go
to the JAX engine and the port's at f32: the sampled tokens must be EQUAL
(no tolerance), since both key every token with ``fold_in(fold_in(rng,
request), position)`` over threefry-2x32. On top, the reference's own
contracts (``tests/test_serving.py``): ``top_k=1`` is the greedy engine,
the schedule — slot count, chunking, sharing, lazy growth with a
preemption — changes no token, and a sampled engine needs ``rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import serving as jserving
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    make_serve_engine,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.models.decode import make_sampler

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2)
HOT = dict(temperature=5.0)


def _setup(n=4, seed=0, lens=None, **over):
    kw = {**BASE, "attn": "dense", **over}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    rng = np.random.default_rng(seed + 1)
    lens = lens or [4 + (i % 3) * 2 for i in range(n)]
    prompts = [rng.integers(0, cfg.vocab, size=(ln,)).astype(np.int32)
               for ln in lens]
    return jcfg, jp, cfg, params, prompts


def _template_prompts(vocab, n=6, seed=90):
    """Two 9-token templates with ragged suffixes (2 full blocks of 4)."""
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(0, vocab, size=(9,)) for _ in range(2)]
    return [np.concatenate([tmpl[i % 2],
                            rng.integers(0, vocab, size=(2 + i % 3,))])
            .astype(np.int32) for i in range(n)]


def _pair(jp, jcfg, params, cfg, prompts, n_new, engine_kw, run_kw,
          seed=7, prefix=None):
    """The JAX engine and the port's on one schedule and one key: equal
    tokens; returns ``(tokens, port stats, JAX stats)``."""
    jkw = dict(engine_kw)
    if prefix is not None:
        jkw["prefix"] = jnp.asarray(prefix)
    jeng = jserving.make_serve_engine(jp, jcfg, **jkw)
    want = jeng([jnp.asarray(p) for p in prompts], n_new,
                rng=jax.random.PRNGKey(seed), **run_kw)
    eng = make_serve_engine(params, cfg, device="cpu", prefix=prefix,
                            **engine_kw)
    got = eng(prompts, n_new, rng=seed, **run_kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"request {i}"
    return got, eng.last_stats, jeng.last_stats


def _equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"request {i}"


def test_sampled_engine_contracts():
    """The reference's contracts (``tests/test_serving.py:231``): top_k=1
    is the greedy engine; at temperature 5, slots 1 and 3 give the same
    tokens, a second run the same again, and they differ from greedy; a
    sampled engine without rng refuses."""
    jcfg, jp, cfg, params, prompts = _setup()
    greedy = make_serve_engine(params, cfg, max_len=16, device="cpu")(
        prompts, 5, slots=2)
    k1 = make_serve_engine(params, cfg, max_len=16, device="cpu",
                           sampler=make_sampler(top_k=1))
    _equal(k1(prompts, 5, slots=2, rng=7), greedy)
    hot = make_serve_engine(params, cfg, max_len=16, device="cpu",
                            sampler=make_sampler(**HOT))
    few = hot(prompts, 5, slots=1, rng=7)
    many = hot(prompts, 5, slots=3, rng=7)
    _equal(few, many)
    _equal(hot(prompts, 5, slots=3, rng=7), many)
    assert any(not torch.equal(a, b) for a, b in zip(many, greedy))
    with pytest.raises(ValueError, match="needs rng"):
        hot(prompts, 5, slots=2)
    with pytest.raises(TypeError, match="make_sampler"):
        make_serve_engine(params, cfg, max_len=16, device="cpu",
                          sampler=lambda logits, key: logits.argmax(-1))


@pytest.mark.parametrize("spec", [
    HOT, dict(temperature=0.8, top_k=20), dict(top_p=0.9),
    dict(temperature=1.3, top_k=30, top_p=0.8), dict(top_k=1)],
    ids=["hot", "top_k", "top_p", "both", "greedy"])
def test_sampled_engine_equals_jax_engine(spec):
    """Sampler specs (the dict form, normalised through make_sampler, as
    the reference's engine takes them) on a recycling schedule."""
    jcfg, jp, cfg, params, prompts = _setup(n=5, seed=3, n_kv_heads=2,
                                            rope=True)
    _, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 6,
                         dict(max_len=24, kv_block=4, sampler=spec),
                         dict(slots=2))
    assert mine["waves"] == ref["waves"]
    assert mine["generated"] == ref["generated"]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_request_key_equals_reference(seed):
    """The key contract's host form, fold_in(fold_in(rng, req), pos), for
    ``PRNGKey`` and ``key`` seeds, dead-slot request ids included."""
    from nvidia_terraform_modules_tpu_torch.models.serving import (
        _request_key,
    )

    for rng in (jax.random.PRNGKey(seed),
                jax.random.key_data(jax.random.key(seed))):
        for req, pos in ((0, 0), (3, 1), (5, 17), (1000, 0), (2, 4095)):
            want = np.asarray(jserving._request_key(rng, req, pos))
            got = _request_key(np.asarray(rng), req, pos)
            assert np.array_equal(got.numpy(), want), (req, pos)


def test_rng_forms_give_the_same_tokens():
    """An int seed, ``PRNGKey``'s array and ``key``'s key data."""
    _, _, cfg, params, prompts = _setup()
    eng = make_serve_engine(params, cfg, max_len=16, device="cpu",
                            sampler=HOT)
    want = eng(prompts, 4, slots=2, rng=11)
    _equal(eng(prompts, 4, slots=2,
               rng=np.asarray(jax.random.PRNGKey(11))), want)
    _equal(eng(prompts, 4, slots=2, rng=jax.random.key_data(
        jax.random.key(11))), want)
    _equal(eng(prompts, 4, slots=2, rng=torch.tensor([0, 11])), want)


@pytest.mark.parametrize("every", [1, 4])
def test_sampled_eos_matches_jax(every):
    jcfg, jp, cfg, params, prompts = _setup(n=5, seed=4)
    eng = make_serve_engine(params, cfg, max_len=16, device="cpu",
                            sampler=HOT)
    eos = int(eng(prompts, 8, slots=2, rng=7)[1][3])
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 8,
                           dict(max_len=16, sampler=HOT),
                           dict(slots=2, eos_id=eos,
                                eos_check_every=every))
    assert len(got[1]) <= 4
    assert mine["generated"] == ref["generated"]
    assert mine["waves"] == ref["waves"]


def test_sampled_chunked_prefill_matches_jax_and_unchunked():
    """``tests/test_serving.py:329``: chunking changes no sampled token."""
    jcfg, jp, cfg, params, prompts = _setup(n=3)
    hot = make_serve_engine(params, cfg, max_len=16, device="cpu",
                            sampler=HOT)(prompts, 5, slots=3, rng=11)
    got, _, _ = _pair(jp, jcfg, params, cfg, prompts, 5,
                      dict(max_len=16, sampler=HOT, prefill_chunk=3),
                      dict(slots=2), seed=11)
    _equal(got, hot)


def test_sampled_template_prefix_matches_jax():
    jcfg, jp, cfg, params, prompts = _setup(n=4, seed=5)
    prefix = np.random.default_rng(9).integers(0, 64, size=(6,)).astype(
        np.int32)
    for chunk in (None, 4):
        _pair(jp, jcfg, params, cfg, prompts, 5,
              dict(max_len=32, kv_block=4, sampler=HOT,
                   prefill_chunk=chunk), dict(slots=2), prefix=prefix)


def test_sampled_share_prefix_matches_jax_and_unshared():
    """``tests/test_serving.py:1023``: sharing blocks changes no token."""
    jcfg, jp, cfg, params, _ = _setup(n=0)
    prompts = _template_prompts(cfg.vocab)
    max_len = max(len(p) for p in prompts) + 5
    want = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             device="cpu", sampler=HOT)(
        prompts, 5, slots=2, rng=7)
    got, mine, _ = _pair(jp, jcfg, params, cfg, prompts, 5,
                         dict(max_len=max_len, kv_block=4, sampler=HOT,
                              share_prefix=True), dict(slots=3))
    _equal(got, want)
    assert mine["prefix"]["hit_blocks"] > 0


def test_sampled_lazy_growth_preemption_regenerates_the_same_tokens():
    """A tight pool under lazy growth stalls slots and preempts the
    youngest; keys follow (request, position), so the preempted request
    draws the same tokens again: the ample pool's, and the JAX engine's
    on the same schedule."""
    jcfg, jp, cfg, params, _ = _setup(n=0)
    prompts = _template_prompts(cfg.vocab)
    max_len = max(len(p) for p in prompts) + 6
    ample = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                              device="cpu", sampler=HOT)(
        prompts, 6, slots=4, rng=7)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 6,
                           dict(max_len=max_len, kv_block=4, sampler=HOT,
                                lazy_growth=True),
                           dict(slots=4, kv_blocks=1 + -(-max_len // 4)
                                + 2))
    _equal(got, ample)
    assert mine["sched"]["preempted"] > 0
    assert mine["sched"] == ref["sched"]
    assert mine["kv"]["in_use"] == 0


def test_sampled_int8_pool_and_weights_match_jax():
    """The int8 pool, and int8 weights through the phase split."""
    from nvidia_terraform_modules_tpu.models import quantize as jquantize
    from nvidia_terraform_modules_tpu_torch.models import qparams_from_numpy
    from test_torch_int8_matmul import jax_qtree_to_numpy

    jcfg, jp, cfg, params, prompts = _setup(n=4, seed=6)
    _pair(jp, jcfg, params, cfg, prompts, 5,
          dict(max_len=16, sampler=HOT, cache_dtype="int8"), dict(slots=2))
    jq = jquantize.quantize_params(jp, dtype=jnp.float32)
    qp = qparams_from_numpy(jax_qtree_to_numpy(jq), cfg, device="cpu")
    _pair(jq, jcfg, qp, cfg, prompts, 5, dict(max_len=16, sampler=HOT),
          dict(slots=2))

