# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the key contract and the samplers on the CPU.

``ops.sampling`` computes ``jax.random``'s threefry-2x32 draws in PyTorch:
key data, folds, splits, raw bits and uniforms must equal JAX's bit for bit
(integers, and floats made from them by exact steps). The Gumbel transform
takes two logs; XLA's CPU ``log`` and PyTorch's are different
implementations, each within an ulp of the true value, so the Gumbel
values ``-log(y)``, ``y = -log(u)``, are held to ``|got - want| <=
2·eps·max(1, |want|)`` (eps = 2^-23: one ulp of ``y`` near 1 moves
``log(y)``, itself near 0, by one eps absolute), and everything decided by
them — ``categorical``'s, ``make_sampler``'s and ``sample_decode``'s
tokens — is held exactly: tokens are integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import decode as jdecode
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    greedy_decode,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.models.decode import (
    make_sampler,
    sample_decode,
)
from nvidia_terraform_modules_tpu_torch.ops import sampling

TINY = np.finfo(np.float32).tiny
SEEDS = [0, 7, 2**31 - 1]


def _kd(key) -> torch.Tensor:
    return sampling.key_data(np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_of_prngkey_and_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    assert np.array_equal(
        np.asarray(jax.random.key_data(jax.random.key(seed))), want)
    assert np.array_equal(sampling.key_data(seed).numpy(), want)
    assert np.array_equal(sampling.key_data(np.int64(seed)).numpy(), want)
    assert np.array_equal(_kd(jax.random.key(seed)).numpy(), want)
    assert np.array_equal(sampling.key_data(torch.from_numpy(
        want.astype(np.int64))).numpy(), want)


def test_key_data_refuses_a_wrong_shape():
    with pytest.raises(ValueError, match="2 words"):
        sampling.key_data(np.zeros((3,), np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_request_position_keys(seed):
    """The serve engine's key contract, fold_in(fold_in(rng, req), pos),
    for 100 pairs, one by one and as a tensor of requests."""
    rng = jax.random.PRNGKey(seed)
    k = sampling.key_data(seed)
    for req in range(10):
        kr = jax.random.fold_in(rng, req)
        assert np.array_equal(sampling.fold_in(k, req).numpy(),
                              np.asarray(kr))
        want = np.stack([np.asarray(jax.random.fold_in(kr, pos))
                         for pos in range(10)])
        got = sampling.fold_in(sampling.fold_in(k, req), torch.arange(10))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 5, 17])
def test_split(seed, n):
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.split(rng, n))
    k = sampling.key_data(seed)
    assert np.array_equal(sampling.split(k, n).numpy(), want)
    for i in range(n):       # split(k, n)[i] == fold_in(k, i)
        assert np.array_equal(sampling.fold_in(k, i).numpy(), want[i])


@pytest.mark.parametrize("shape", [(7,), (1, 1000), (3, 50), (4, 8192)])
def test_random_bits_and_uniform(shape):
    rng = jax.random.PRNGKey(11)
    k = sampling.key_data(11)
    want = np.asarray(jax.random.bits(rng, shape, jnp.uint32))
    assert np.array_equal(sampling.random_bits(k, shape).numpy(),
                          want.astype(np.int64))
    u = np.asarray(jax.random.uniform(rng, shape, minval=TINY))
    got = sampling.uniform(k, shape).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, u)


@pytest.mark.parametrize("shape", [(1, 1000), (3, 50), (4, 8192)])
def test_gumbel_within_two_eps(shape):
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.gumbel(rng, shape)).astype(np.float64)
    got = sampling.gumbel(sampling.key_data(5), shape).numpy()
    assert got.dtype == np.float32
    eps = np.finfo(np.float32).eps
    bound = 2 * eps * np.maximum(1, np.abs(want))
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("b,v", [(1, 1000), (3, 50), (4, 8192)])
def test_categorical_tokens(b, v):
    lg = np.random.default_rng(b * v).normal(size=(b, v)).astype(np.float32)
    for seed in range(10):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                                 jnp.asarray(lg)))
        got = sampling.categorical(sampling.key_data(seed),
                                   torch.from_numpy(lg))
        assert np.array_equal(got.numpy(), want), seed


def test_draw_rows_with_fold_equal_folded_keys_and_offsets():
    """``draw``'s two keying forms against what they stand for: ``fold``
    equals per-row keys folded beforehand, and an offset of ``b·V`` equals
    the batched draw's row ``b``; ties and -inf rows go as jnp.argmax."""
    g = torch.Generator().manual_seed(3)
    lg = torch.randn((4, 300), generator=g)
    lg[1] = -torch.inf                      # every logit -inf → index 0
    lg[2, 10] = lg[2, 20] = torch.inf       # an exact tie → the lower
    key = sampling.key_data(9)
    fold = torch.tensor([[0, 1], [3, 0], [5, 7], [2, 9]])
    keys = torch.stack([sampling.fold_in(sampling.fold_in(key, int(r)),
                                         int(p)) for r, p in fold])
    a = sampling.draw(lg, key, None, fold)
    assert torch.equal(a, sampling.draw(lg, keys))
    assert a[1] == 0 and a[2] == 10
    offs = torch.arange(4) * 300
    batched = sampling.draw(lg, key, offs)
    for b in range(4):
        row = sampling.draw(lg[b:b + 1], key, offs[b:b + 1])
        assert row[0] == batched[b]
    tok, scores = sampling.draw_ref(lg, key, offs, scores=True)
    assert torch.equal(tok, batched) and scores.shape == lg.shape


def test_draw_validates_its_inputs():
    lg = torch.zeros((2, 8))
    key = sampling.key_data(0)
    with pytest.raises(ValueError, match="f32 logits"):
        sampling.draw(lg.double(), key)
    with pytest.raises(ValueError, match="keys"):
        sampling.draw(lg, key.int())
    with pytest.raises(ValueError, match="offsets"):
        sampling.draw(lg, key, torch.zeros((3,), dtype=torch.int64))
    with pytest.raises(ValueError, match="fold"):
        sampling.draw(lg, key, None, torch.zeros((2,), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        sampling.draw_scores(lg, key)


SAMPLERS = [
    dict(temperature=0.7),
    dict(temperature=0.7, top_k=50),
    dict(temperature=0.9, top_p=0.9),
    dict(temperature=1.3, top_k=100, top_p=0.8),
    dict(top_k=1),
    dict(top_p=1.0),
    dict(top_p=1e-4),
    dict(temperature=0.0),
]


@pytest.mark.parametrize("kw", SAMPLERS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_make_sampler_equals_reference(kw):
    """One key over a [B, V] batch (sample_decode's form) and a key a row
    folded from (request, position) (the serve engine's vmapped form)."""
    jpick, pick = jdecode.make_sampler(**kw), make_sampler(**kw)
    rng = np.random.default_rng(17)
    jrows = jax.jit(jax.vmap(lambda row, k: jpick(row[None], k)[0]))
    for i in range(8):
        lg = (rng.normal(size=(4, 1000)) * 3).astype(np.float32)
        lg[:, :3] = lg[:, 3:6]                 # tied logits
        key = jax.random.PRNGKey(i)
        want = np.asarray(jax.jit(jpick)(jnp.asarray(lg), key))
        got = pick(torch.from_numpy(lg), sampling.key_data(i))
        assert np.array_equal(got.numpy(), want), i
        reqs, poss = np.arange(4) * 3, np.arange(4) + i
        keys = jax.vmap(lambda r, p: jax.random.fold_in(
            jax.random.fold_in(key, r), p))(reqs, poss)
        want = np.asarray(jrows(jnp.asarray(lg), keys))
        fold = torch.from_numpy(np.stack([reqs, poss], 1))
        got = pick.rows(torch.from_numpy(lg), sampling.key_data(i), fold)
        assert np.array_equal(got.numpy(), want), i


def test_top_k_one_is_argmax_and_validation():
    lg = torch.randn((3, 40), generator=torch.Generator().manual_seed(0))
    pick = make_sampler(temperature=3.0, top_k=1)
    assert torch.equal(pick(lg, sampling.key_data(1)), lg.argmax(-1))
    for kw, msg in ((dict(top_k=0), "top_k"), (dict(top_p=0.0), "top_p"),
                    (dict(top_p=1.5), "top_p")):
        with pytest.raises(ValueError, match=msg):
            make_sampler(**kw)
        with pytest.raises(ValueError, match=msg):
            jdecode.make_sampler(**kw)
    assert make_sampler(temperature=0.0).temperature == 1e-6


BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2, attn="dense")


@pytest.mark.parametrize("kw", [dict(temperature=0.8),
                                dict(temperature=1.2, top_k=10),
                                dict(top_p=0.9), dict(top_k=1)],
                         ids=["temp", "top_k", "top_p", "greedy"])
def test_sample_decode_equals_reference(kw):
    jcfg = jburnin.BurnInConfig(**BASE, dtype=jnp.float32)
    cfg = BurnInConfig(**BASE, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(2), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    prompt = np.random.default_rng(3).integers(0, 64, size=(2, 6)).astype(
        np.int32)
    for seed in (0, 5):
        want = np.asarray(jdecode.sample_decode(
            jp, jnp.asarray(prompt), 10, jcfg, jax.random.PRNGKey(seed),
            **kw))
        got = sample_decode(params, torch.from_numpy(prompt), 10, cfg, seed,
                            device="cpu", **kw)
        assert np.array_equal(got.numpy(), want), seed
    if kw.get("top_k") == 1:
        assert torch.equal(got, greedy_decode(params, torch.from_numpy(
            prompt), 10, cfg, device="cpu"))
