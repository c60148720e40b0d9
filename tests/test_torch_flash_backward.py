# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, flash-attention backward: the plain versions of K3/K4/K5
(what the kernel wrappers run on a CPU tensor) against the JAX reference's
Pallas kernels ``flash_dq`` / ``flash_dkv`` / ``flash_dqdkv`` in interpret
mode, given the same LSE and delta; and ``torch.autograd.grad`` through
:class:`FlashAttention` against ``jax.grad`` through the reference's
``flash_attention``, for both backward modes.

Tolerances: f32 1e-5 (one tile vs the reference's 16-row tiles: summation
order only); bf16 2e-2 of max(1, max|ref|) — the products accumulate in
another order before dQ/dK/dV round to bf16.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("nvidia_terraform_modules_tpu.ops.flash_attention")
tfa = importlib.import_module(
    "nvidia_terraform_modules_tpu_torch.ops.flash_attention")

BLOCK = 16


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32)
                 for _ in range(4))


def _bhsd(x):
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _bshd(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x, np.float32).reshape(b, h, s, d).transpose(0, 2, 1, 3)


def _residuals(q, k, v, do, spec, dtype):
    """The reference forward's O and LSE (interpret mode) and delta, for
    inputs rounded to ``dtype``: numpy, f32, [B,S,H,D] and [B,H,S]."""
    b, s, h, d = q.shape
    qj, kj, vj = (jnp.asarray(_bhsd(x), dtype) for x in (q, k, v))
    o, lse = jfa._fwd(qj, kj, vj, scale=d ** -0.5, spec=spec, block_q=BLOCK,
                      block_k=BLOCK, pipe=False, interpret=True)
    doj = jnp.asarray(_bhsd(do), dtype)
    delta = jnp.sum(doj.astype(jnp.float32) * o.astype(jnp.float32),
                    axis=-1, keepdims=True)
    return (qj, kj, vj, doj, lse, delta,
            np.array(lse).reshape(b, h, s),
            np.array(delta).reshape(b, h, s))


def _both(q, k, v, do, mask, dtype_j, dtype_t):
    """(reference dq, dk, dv, fused dq, dk, dv) — port (dq, dk, dv) from
    flash_dq_ref + flash_dkv_ref and from flash_dqdkv_ref."""
    b, s, h, d = q.shape
    spec = jfa.as_mask_spec(mask)
    qj, kj, vj, doj, lse, delta, lse_t, delta_t = _residuals(
        q, k, v, do, spec, dtype_j)
    kw = dict(scale=d ** -0.5, causal=True, mask=spec, block_q=BLOCK,
              block_k=BLOCK, interpret=True)
    want = (jfa.flash_dq(qj, kj, vj, doj, lse, delta, **kw),
            *jfa.flash_dkv(qj, kj, vj, doj, lse, delta, **kw))
    want_fused = jfa.flash_dqdkv(qj, kj, vj, doj, lse, delta, **kw)
    want = [_bshd(x.astype(jnp.float32), b, h) for x in want]
    want_fused = [_bshd(x.astype(jnp.float32), b, h) for x in want_fused]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype_t) for x in (q, k, v, do))
    args = (tq, tk, tv, tdo, torch.from_numpy(lse_t),
            torch.from_numpy(delta_t))
    tkw = dict(scale=d ** -0.5, mask=mask)
    split = (tfa.flash_dq_ref(*args, **tkw), *tfa.flash_dkv_ref(*args, **tkw))
    fused = tfa.flash_dqdkv_ref(*args, **tkw)
    return want, want_fused, split, fused


@pytest.mark.parametrize("mask", ["causal", "full", ("window", 5)])
@pytest.mark.parametrize("s", [32, 64])
def test_plain_backward_matches_reference_kernels_f32(mask, s):
    q, k, v, do = _inputs(1, s, 2, 16, seed=s)
    want, want_fused, split, fused = _both(q, k, v, do, mask, jnp.float32,
                                           torch.float32)
    for w, wf, sp, f in zip(want, want_fused, split, fused):
        assert sp.dtype == f.dtype == torch.float32
        np.testing.assert_allclose(sp.numpy(), w, atol=1e-5, rtol=0)
        np.testing.assert_allclose(f.numpy(), wf, atol=1e-5, rtol=0)
        assert torch.equal(sp, f)     # one P/dS: the same numbers


def test_plain_backward_matches_reference_kernels_bf16():
    q, k, v, do = _inputs(2, 64, 2, 32, seed=7)
    want, want_fused, split, fused = _both(q, k, v, do, None, jnp.bfloat16,
                                           torch.bfloat16)
    for w, wf, sp, f in zip(want, want_fused, split, fused):
        assert sp.dtype == f.dtype == torch.bfloat16
        lim = 2e-2 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(sp.float().numpy(), w, atol=lim, rtol=0)
        np.testing.assert_allclose(f.float().numpy(), wf, atol=lim, rtol=0)


@pytest.mark.parametrize("mask", ["causal", "full"])
def test_plain_backward_f32_outputs_match_reference_kernels(mask):
    """``out_dtype=float32`` (the ring's per-block gradients) on bf16
    inputs: the reference's kernels with ``out_dtype=jnp.float32``."""
    b, s, h, d = 2, 32, 2, 16
    q, k, v, do = _inputs(b, s, h, d, seed=13)
    spec = jfa.as_mask_spec(mask)
    qj, kj, vj, doj, lse, delta, lse_t, delta_t = _residuals(
        q, k, v, do, spec, jnp.bfloat16)
    kw = dict(scale=d ** -0.5, causal=True, mask=spec, block_q=BLOCK,
              block_k=BLOCK, interpret=True, out_dtype=jnp.float32)
    want = (jfa.flash_dq(qj, kj, vj, doj, lse, delta, **kw),
            *jfa.flash_dkv(qj, kj, vj, doj, lse, delta, **kw))
    want_fused = jfa.flash_dqdkv(qj, kj, vj, doj, lse, delta, **kw)
    args = (*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)),
            torch.from_numpy(lse_t), torch.from_numpy(delta_t))
    tkw = dict(scale=d ** -0.5, mask=mask, out_dtype=torch.float32)
    split = (tfa.flash_dq(*args, **tkw), *tfa.flash_dkv(*args, **tkw))
    fused = tfa.flash_dqdkv(*args, **tkw)
    for w, wf, sp, f in zip(want, want_fused, split, fused):
        assert w.dtype == jnp.float32
        assert sp.dtype == f.dtype == torch.float32
        w, wf = _bshd(w, b, h), _bshd(wf, b, h)
        lim = 2e-2 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(sp.numpy(), w, atol=lim, rtol=0)
        np.testing.assert_allclose(f.numpy(), wf, atol=lim, rtol=0)
    # the default stays the inputs' dtype; any other dtype is refused
    assert tfa.flash_dq(*args, scale=1.0).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="out_dtype"):
        tfa.flash_dqdkv(*args, scale=1.0, out_dtype=torch.float16)


@pytest.mark.parametrize("mask", [None, ("window", 6)])
@pytest.mark.parametrize("backward", ["fused", "split"])
def test_autograd_function_matches_jax_grad(backward, mask):
    q, k, v, w = _inputs(2, 32, 2, 16, seed=11)

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, block_q=BLOCK, block_k=BLOCK,
                                backward=backward, mask=mask)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                 for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, mask=mask, backward=backward)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-5,
                                   rtol=0)


def test_wrappers_on_cpu_are_the_plain_versions():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 24, 2, 8, 3))
    o, lse = tfa.flash_attention_fwd(q, k, v, mask=("window", 7))
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, delta)
    kw = dict(scale=0.3, mask=("window", 7))
    for got, want in zip(tfa.flash_dqdkv(*args, **kw),
                         tfa.flash_dqdkv_ref(*args, **kw)):
        assert torch.equal(got, want)
    assert torch.equal(tfa.flash_dq(*args, **kw),
                       tfa.flash_dq_ref(*args, **kw))
    for got, want in zip(tfa.flash_dkv(*args, **kw),
                         tfa.flash_dkv_ref(*args, **kw)):
        assert torch.equal(got, want)
    for mode in ("fused", "split"):
        got = tfa.flash_backward(q, k, v, o, do, lse, backward=mode, **kw)
        for g, w in zip(got, tfa.flash_dqdkv_ref(*args, **kw)):
            assert torch.equal(g, w)


def test_no_gradient_keeps_the_forward_path():
    """Without a gradient (the serve path) flash_attention is the plain
    forward call: no autograd node, GQA shapes allowed."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 4, 8, 5))
    o = tfa.flash_attention(q, k[:, :, :2], v[:, :, :2])
    assert o.grad_fn is None
    assert torch.equal(o, tfa.flash_attention_fwd(q, k[:, :, :2],
                                                  v[:, :, :2])[0])


def test_backward_validation():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 4, 8, 6))
    with pytest.raises(ValueError, match="fused|split"):
        tfa.flash_attention(q, k, v, backward="bogus")
    with pytest.raises(ValueError, match="fused|split"):
        tfa.flash_backward(q, k, v, q, q, torch.zeros(1, 4, 16),
                           scale=1.0, backward="bogus")
    kg = k[:, :, :2].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="MHA"):
        tfa.flash_attention(q, kg, v[:, :, :2])
    lse = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_dq(q, k, v, q, lse[:, :, :8], lse, scale=1.0)


@pytest.mark.parametrize("mask", ["causal", "full", ("window", 3),
                                  ("window", 40)])
@pytest.mark.parametrize("s", [16, 33, 100])
def test_mask_live_frac_matches_reference(mask, s):
    assert tfa.mask_live_frac(tfa.as_mask_spec(mask), s) == \
        jfa.mask_live_frac(jfa.as_mask_spec(mask), s)


@pytest.mark.parametrize("backward", ["fused", "split"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_backward_f32_out_matches_reference(backward, dtype):
    """``flash_backward(..., out_dtype=torch.float32)`` passes the dtype on
    to K5 or K3 + K4 (their plain versions here): f32 dQ/dK/dV that match
    the reference's ``flash_backward(out_dtype=float32)`` (interpret mode)
    on the reference forward's O and LSE, bf16 and f32 inputs alike,
    within 1e-5 of max(1, |ref|): both sums run in f32, in another order
    (a few f32 ulps at these magnitudes)."""
    b, s, h, d = 1, 48, 2, 16
    q, k, v, do = _inputs(b, s, h, d, 11)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    spec = jfa.as_mask_spec(None)
    qj, kj, vj, doj, lse, _delta, lse_t, _ = _residuals(q, k, v, do, spec,
                                                        jdt)
    o, _ = jfa._fwd(qj, kj, vj, scale=d ** -0.5, spec=spec, block_q=BLOCK,
                    block_k=BLOCK, pipe=False, interpret=True)
    want = jfa.flash_backward(qj, kj, vj, o, doj, lse, scale=d ** -0.5,
                              causal=True, block_q=BLOCK, block_k=BLOCK,
                              interpret=True, backward=backward,
                              out_dtype=jnp.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    to = torch.from_numpy(_bshd(o.astype(jnp.float32), b, h).copy()).to(tdt)
    got = tfa.flash_backward(tq, tk, tv, to, tdo, torch.from_numpy(lse_t),
                             scale=d ** -0.5, backward=backward,
                             out_dtype=torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        w = _bshd(w, b, h)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * max(1.0, np.abs(w).max()), err
    # without out_dtype the gradients keep the inputs' dtype
    assert all(g.dtype == tdt for g in tfa.flash_backward(
        tq, tk, tv, to, tdo, torch.from_numpy(lse_t), scale=d ** -0.5,
        backward=backward))
