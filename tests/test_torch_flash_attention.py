# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, flash attention: the plain version (what the kernel wrapper
runs on a CPU tensor) against the JAX reference's Pallas forward run in
interpret mode, for O and LSE, plus the numpy selection rules.

Tolerances: f32 1e-5 (online vs one-pass softmax: summation order only);
bf16 2e-2 on O — the reference rounds each tile's unnormalised P to bf16
against its running max, the plain version against the row max.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, not the same-named functions their packages re-export
jfa = importlib.import_module("nvidia_terraform_modules_tpu.ops.flash_attention")
tfa = importlib.import_module(
    "nvidia_terraform_modules_tpu_torch.ops.flash_attention")


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    return q, k, v


def _jax_fwd(q, k, v, spec, dtype, block):
    """Reference _fwd (the pallas_call) in interpret mode, K/V repeated to
    the MHA shape the TPU kernel takes (the reference's ``grow``)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]

    def bhsd(x, heads):
        x = np.repeat(x, heads, axis=2) if heads > 1 else x
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d),
                           dtype)

    o, lse = jfa._fwd(bhsd(q, 1), bhsd(k, rep), bhsd(v, rep),
                      scale=d ** -0.5, spec=spec, block_q=block,
                      block_k=block, pipe=False, interpret=True)
    o = np.asarray(o.astype(jnp.float32)).reshape(b, h, s, d)
    return o.transpose(0, 2, 1, 3), np.asarray(lse).reshape(b, h, s)


@pytest.mark.parametrize("mask", ["causal", "full", ("window", 5)])
@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_flash_ref_matches_reference_kernel_f32(mask, s, heads):
    h, kv = heads
    q, k, v = _inputs(1, s, h, kv, 16, seed=s + h)
    spec = jfa.as_mask_spec(mask)
    want_o, want_lse = _jax_fwd(q, k, v, spec, jnp.float32, block=8)
    got_o, got_lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=mask)
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)


def test_flash_ref_matches_reference_kernel_bf16():
    q, k, v = _inputs(2, 64, 4, 2, 32, seed=9)
    spec = jfa.as_mask_spec(None)
    want_o, want_lse = _jax_fwd(q, k, v, spec, jnp.bfloat16, block=16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got_o, got_lse = tfa.flash_attention_fwd(tq, tk, tv)
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(got_o.float().numpy(), want_o, atol=2e-2,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-3, rtol=0)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 24, 4, 1, 8, 3))
    o, lse = tfa.flash_attention_fwd(q, k, v, mask=("window", 7))
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, mask=("window", 7))
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert torch.equal(tfa.flash_attention(q, k, v), tfa.flash_attention_ref(
        q, k, v)[0])


@pytest.mark.parametrize("mask", ["causal", "full", ("window", 3),
                                  ("window", 70)])
@pytest.mark.parametrize("nq,nk,bq,bk", [(4, 4, 16, 16), (3, 6, 32, 16),
                                         (5, 5, 64, 64)])
def test_block_liveness_matches_reference(mask, nq, nk, bq, bk):
    spec_t, spec_j = tfa.as_mask_spec(mask), jfa.as_mask_spec(mask)
    assert np.array_equal(tfa.block_liveness(spec_t, nq, nk, bq, bk),
                          jfa.block_liveness(spec_j, nq, nk, bq, bk))


def test_selection_rules_match_reference():
    """_fit_block everywhere, pick_impl on every length the reference's
    production rule decides (above its CPU-interpreter clause)."""
    for s in range(1, 700):
        for want in (None, 8, 64, 100, 1024):
            assert tfa._fit_block(s, want) == jfa._fit_block(s, want)
    for s in range(9, 700):
        assert tfa.pick_impl(None, s, "x") == jfa.pick_impl(None, s, "x")
    assert tfa.pick_impl("dense", 64, "x") == "dense"
    with pytest.raises(ValueError):
        tfa.pick_impl("bogus", 64, "x")
    with pytest.raises(ValueError):
        tfa.MaskSpec("window")
    with pytest.raises(ValueError):
        tfa.as_mask_spec(("diag", 3))
