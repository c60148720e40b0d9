# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the compiled greedy decoder on the CPU.

``make_decoder(device="cpu")`` against the reference's ``make_decoder``
(``jax.jit`` over ``greedy_decode``) on the same numpy-made weights at
f32: tokens equal, for the bf16 and the int8 cache, dense and flash
prefills, and ``make_quantized_decoder`` (routed through it) against the
reference's on the same int8 weights. A second params tree after the first
gives the second tree's tokens. ``_params_key`` — what decides, on the
card, whether a call replays a captured graph or captures its own — tells
trees apart by the tensors a graph reads. The captured graph itself runs
only on the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int8_matmul import jax_qtree_to_numpy

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import decode as jdecode
from nvidia_terraform_modules_tpu.models import quantize as jquant
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    greedy_decode,
    make_decoder,
    make_quantized_decoder,
    params_from_numpy,
    qparams_from_numpy,
    quantize_params,
)
from nvidia_terraform_modules_tpu_torch.models.decode import _params_key

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2)


def _pair(seed=0, **over):
    kw = {**BASE, **over}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _prompt(shape, seed):
    return np.random.default_rng(seed).integers(0, 64, size=shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("attn,t,n_new,max_len", [
    ("dense", 6, 8, None),
    ("dense", 5, 1, None),           # no steps: the prefill's token alone
    ("flash", 16, 6, 32),            # a flash prefill, a longer cache
])
def test_make_decoder_equals_reference(cache_dtype, attn, t, n_new,
                                       max_len):
    jcfg, jp, cfg, tp = _pair(attn=attn, n_kv_heads=2, rope=True)
    prompt = _prompt((2, t), seed=3)
    want = np.asarray(jdecode.make_decoder(
        jcfg, n_new=n_new, max_len=max_len, cache_dtype=cache_dtype)(
            jp, jnp.asarray(prompt)))
    dec = make_decoder(cfg, n_new=n_new, max_len=max_len,
                       cache_dtype=cache_dtype, device="cpu")
    got = dec(tp, torch.from_numpy(prompt))
    assert got.shape == (2, n_new) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    # a second call of the same decoder: the same tokens
    assert torch.equal(dec(tp, torch.from_numpy(prompt)), got)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_second_params_tree_gives_its_own_tokens(cache_dtype):
    """One decoder, two trees, then the first again: each call's tokens
    are its own tree's greedy decode."""
    _, _, cfg, tp_a = _pair(seed=0)
    _, _, _, tp_b = _pair(seed=7)
    # a small random model repeats its prompt's last token; a negated
    # output norm turns its argmax into another token
    tp_b["out_norm"] = -tp_b["out_norm"]
    prompt = torch.from_numpy(_prompt((2, 6), seed=4))
    dec = make_decoder(cfg, n_new=8, cache_dtype=cache_dtype, device="cpu")
    want = [greedy_decode(tp, prompt, 8, cfg, cache_dtype=cache_dtype,
                          device="cpu") for tp in (tp_a, tp_b)]
    assert not torch.equal(want[0], want[1])
    for tp, w in ((tp_a, want[0]), (tp_b, want[1]), (tp_a, want[0])):
        assert torch.equal(dec(tp, prompt), w)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_quantized_decoder_equals_reference(fused, cache_dtype):
    jcfg, jp, cfg, _ = _pair(d_model=128, d_ff=256, vocab=128)
    jqp = jquant.quantize_params(jp, dtype=jnp.float32)
    qp = qparams_from_numpy(jax_qtree_to_numpy(jqp), cfg, device="cpu")
    prompt = _prompt((2, 6), seed=5)
    want = np.asarray(jquant.make_quantized_decoder(
        jcfg, n_new=8, dtype=jnp.float32, fused=fused,
        cache_dtype=cache_dtype)(jqp, jnp.asarray(prompt)))
    got = make_quantized_decoder(cfg, n_new=8, dtype=torch.float32,
                                 fused=fused, cache_dtype=cache_dtype,
                                 device="cpu")(qp, torch.from_numpy(prompt))
    assert np.array_equal(got.numpy(), want)


def test_params_key_tells_trees_apart():
    _, _, cfg, tp = _pair()
    assert _params_key(tp) == _params_key(tp)
    # a new tree with equal values sits at other addresses
    clone = {**tp, "embed": tp["embed"].clone()}
    assert _params_key(clone) != _params_key(tp)
    # the same storage under another shape or dtype reads differently
    same = {**tp, "embed": tp["embed"].view(-1, 16)}
    assert _params_key(same) != _params_key(tp)
    qp = quantize_params(tp, dtype=torch.float32)
    assert _params_key(qp) == _params_key(qp)
    assert _params_key(qp) != _params_key(tp)
    assert len(_params_key(qp)) == len(_params_key(tp))


def test_make_decoder_validates_like_greedy_decode():
    _, _, cfg, tp = _pair()
    with pytest.raises(ValueError, match="n_new"):
        make_decoder(cfg, n_new=0, device="cpu")
    with pytest.raises(ValueError, match="cache_dtype"):
        make_decoder(cfg, cache_dtype="fp8", device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        make_decoder(cfg, n_new=8, max_len=10, device="cpu")(
            tp, torch.zeros((1, 6), dtype=torch.long))
