# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, quantised decoding against the JAX reference on shared
weights: the storage-level tree API (``quantize_tree`` /
``dequantize_tree`` / ``quantized_nbytes``), quantised logits against the
dense model, and ``make_quantized_decoder`` — fused and ``fused=False``,
bf16 and int8 caches — whose greedy tokens EQUAL the reference decoder's on
the same int8 weights (``qparams_from_numpy``). On the CPU every int8
product and the int8 decode step run the kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int8_matmul import jax_qtree_to_numpy

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import quantize as jquant
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    dequantize_tree,
    forward,
    greedy_decode,
    make_quantized_decoder,
    params_from_numpy,
    qparams_from_numpy,
    quantize_params,
    quantize_tree,
    quantized_nbytes,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2)


def _pair(seed=0, **over):
    kw = {**BASE, **over}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _tokens(shape, seed, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def test_tree_roundtrip_and_footprint_match_reference():
    jcfg, jp, cfg, tp = _pair()
    qt = quantize_tree(tp)
    jqt = jquant.quantize_tree(jp)
    assert qt["q"]["embed"].dtype == torch.int8 and qt["q"]["out_norm"] is None
    assert np.array_equal(qt["q"]["layers"][1]["up"].numpy(),
                          np.asarray(jqt["q"]["layers"][1]["up"]))
    assert np.array_equal(qt["scale"]["embed"].numpy(),
                          np.asarray(jqt["scale"]["embed"]))
    back = dequantize_tree(qt, torch.float32)
    jback = jquant.dequantize_tree(jqt, jnp.float32)
    assert torch.equal(back["out_norm"], tp["out_norm"])   # norms exact
    np.testing.assert_array_equal(back["layers"][0]["wq"].numpy(),
                                  np.asarray(jback["layers"][0]["wq"]))
    assert quantized_nbytes(qt) == jquant.quantized_nbytes(jqt)
    full = sum(x.numel() * x.element_size() for x in
               (tp["embed"], tp["out_norm"]))
    assert quantized_nbytes(qt) < quantized_nbytes(tp) * 0.5 + full
    qp = quantize_params(tp, dtype=torch.float32)
    assert quantized_nbytes(qp) == jquant.quantized_nbytes(
        jquant.quantize_params(jp, dtype=jnp.float32))


def test_quantized_logits_close_to_dense():
    """The reference's fidelity bar, on its weights: logits of the
    dequantised tree within 0.15 (max) and 0.02 (mean) relative error of
    the dense model's, and equal to the reference's quantised logits."""
    jcfg, jp, cfg, tp = _pair()
    toks = _tokens((2, 16), seed=1)
    ref = forward(tp, torch.from_numpy(toks).long(), cfg).numpy()
    q = forward(dequantize_tree(quantize_tree(tp), torch.float32),
                torch.from_numpy(toks).long(), cfg).numpy()
    rel = np.abs(q - ref) / np.maximum(np.abs(ref), 1.0)
    assert rel.max() < 0.15 and rel.mean() < 0.02
    jq = jburnin.forward(jquant.dequantize_tree(jquant.quantize_tree(jp),
                                                jnp.float32),
                         jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(q, np.asarray(jq), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_quantized_decoder_tokens_equal_reference(fused, cache_dtype):
    jcfg, jp, cfg, _ = _pair(seed=2, n_kv_heads=2, rope=True)
    jqp = jquant.quantize_params(jp, dtype=jnp.float32)
    qp = qparams_from_numpy(jax_qtree_to_numpy(jqp), cfg, device="cpu")
    prompt = _tokens((2, 6), seed=3)
    want = np.asarray(jquant.make_quantized_decoder(
        jcfg, n_new=8, dtype=jnp.float32, fused=fused,
        cache_dtype=cache_dtype)(jqp, jnp.asarray(prompt)))
    got = make_quantized_decoder(cfg, n_new=8, dtype=torch.float32,
                                 fused=fused, cache_dtype=cache_dtype,
                                 device="cpu")(qp, torch.from_numpy(prompt))
    assert got.shape == (2, 8)
    assert np.array_equal(got.numpy(), want)
    # the decoder is the stock greedy decode over the QTensor tree
    assert torch.equal(got, greedy_decode(qp, torch.from_numpy(prompt), 8,
                                          cfg, cache_dtype=cache_dtype,
                                          device="cpu"))


def test_quantized_decoder_validation():
    _, _, cfg, tp = _pair()
    prompt = torch.from_numpy(_tokens((1, 4), seed=4))
    dec = make_quantized_decoder(cfg, n_new=2, dtype=torch.float32,
                                 device="cpu")
    with pytest.raises(ValueError, match="QTensor"):
        dec(tp, prompt)
    with pytest.raises(ValueError, match="dtype"):
        dec(quantize_params(tp, dtype=torch.bfloat16), prompt)
    with pytest.raises(ValueError, match="cache_dtype"):
        make_quantized_decoder(cfg, n_new=2, dtype=torch.float32,
                               cache_dtype="fp8", device="cpu")(
            quantize_params(tp, dtype=torch.float32), prompt)
