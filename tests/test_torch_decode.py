# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, cached decoding against the JAX reference on shared weights.

Both sides load the reference's ``init_params`` weights (through
``params_from_numpy``) and the same seeded tokens. f32 configs: logits
within 1e-5, greedy tokens EQUAL — for the dense prefill and for the flash
prefill (the reference's flash runs its Pallas kernel in interpret mode).
Inside the port, ``forward_paged`` through scattered blocks reproduces
``forward_cached`` bit for bit, through the gather path and through the
paged kernel's plain version.
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
    forward,
    forward_cached,
    forward_paged,
    greedy_decode,
    init_cache,
    init_paged_cache,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.models import decode as tdecode

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2)


def _pair(seed=0, **over):
    kw = {**BASE, **over}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    tcfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _tokens(shape, seed, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def test_params_from_numpy_takes_bf16_and_f32_leaves():
    """The reference's bf16 tree (``ml_dtypes.bfloat16`` leaves) and its f32
    copy load bit-identically into the port's bf16 dict."""
    kw = {**BASE, "n_kv_heads": 2}
    jp = jburnin.init_params(jax.random.PRNGKey(2), jburnin.BurnInConfig(**kw))
    bf = jax.tree.map(np.asarray, jp)
    f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    assert bf["embed"].dtype.name == "bfloat16"
    cfg = BurnInConfig(**kw, dtype=torch.bfloat16)
    a = params_from_numpy(bf, cfg, device="cpu")
    b = params_from_numpy(f32, cfg, device="cpu")
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["embed"],
                       torch.from_numpy(f32["embed"]).to(torch.bfloat16))
    assert torch.equal(a["out_norm"], b["out_norm"])
    for la, lb in zip(a["layers"], b["layers"]):
        assert la.keys() == lb.keys()
        for key in la:
            assert torch.equal(la[key], lb[key]), key


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_forward_oracle_matches_reference(attn):
    jcfg, jp, tcfg, tp = _pair(attn=attn, n_kv_heads=2, rope=True)
    toks = _tokens((2, 16), seed=1)
    want = np.asarray(jburnin.forward(jp, jnp.asarray(toks), jcfg))
    got = forward(tp, torch.from_numpy(toks).long(), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("prefill", ["dense", "flash"])
def test_forward_cached_logits_match_reference(prefill):
    jcfg, jp, tcfg, tp = _pair(n_kv_heads=2)
    prompt = _tokens((2, 8), seed=2)
    jc = jdecode.init_cache(jcfg, 2, 12)
    tc = init_cache(tcfg, 2, 12, device="cpu")
    jl, jc = jdecode.forward_cached(jp, jnp.asarray(prompt), jc, jcfg,
                                    prefill_impl=prefill)
    tl, tc = forward_cached(tp, torch.from_numpy(prompt).long(), tc, tcfg,
                            prefill_impl=prefill)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    step = _tokens((2, 1), seed=3)
    jl, _ = jdecode.forward_cached(jp, jnp.asarray(step), jc, jcfg)
    tl, tc = forward_cached(tp, torch.from_numpy(step).long(), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert tc["pos"] == 9


@pytest.mark.parametrize("attn,over", [
    ("dense", {}),
    ("flash", {}),
    ("flash", {"n_kv_heads": 2, "rope": True}),
    ("dense", {"n_kv_heads": 1, "rope": True}),
])
def test_greedy_tokens_equal_reference(attn, over):
    jcfg, jp, tcfg, tp = _pair(seed=4, attn=attn, **over)
    prompt = _tokens((2, 16), seed=5)
    want = np.asarray(jdecode.greedy_decode(jp, jnp.asarray(prompt), 6,
                                            jcfg))
    got = greedy_decode(tp, torch.from_numpy(prompt), 6, tcfg,
                        device="cpu")
    assert got.shape == (2, 6)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("paged_kernel", ["off", "on"])
def test_forward_paged_matches_forward_cached(paged_kernel):
    """Scattered, out-of-order physical blocks: the table, not adjacency,
    carries the logical order — logits equal the dense buffer's at every
    step ("on" runs the paged kernel's plain version for T=1)."""
    _, _, cfg, params = _pair(seed=6, n_kv_heads=2, rope=True)
    prompt = torch.from_numpy(_tokens((1, 6), seed=7)).long()
    dense = init_cache(cfg, 1, 16, device="cpu")
    d_logits, dense = forward_cached(params, prompt, dense, cfg)
    pool = init_paged_cache(cfg, 1, 16, block_size=4, num_blocks=9,
                            device="cpu")
    pool["block_tables"][0] = torch.tensor([7, 2, 5, 3], dtype=torch.int32)
    p_logits, pool = forward_paged(params, prompt, pool, cfg,
                                   prefill_impl="dense",
                                   paged_kernel=paged_kernel)
    assert torch.equal(d_logits, p_logits)
    tok = d_logits[:, -1].argmax(-1)
    for _ in range(4):
        d_logits, dense = forward_cached(params, tok[:, None], dense, cfg)
        p_logits, pool = forward_paged(params, tok[:, None], pool, cfg,
                                       paged_kernel=paged_kernel)
        torch.testing.assert_close(p_logits, d_logits, atol=1e-6, rtol=0)
        tok = d_logits[:, -1].argmax(-1)
    assert int(pool["pos"][0]) == dense["pos"] == 10


def test_forward_paged_fences_dead_rows_to_the_garbage_block():
    _, _, cfg, params = _pair(seed=8)
    pool = init_paged_cache(cfg, 2, 8, block_size=4, num_blocks=5,
                            device="cpu")
    pool["block_tables"][0] = torch.tensor([1, 2], dtype=torch.int32)
    pool["block_tables"][1] = torch.tensor([3, 4], dtype=torch.int32)
    toks = torch.tensor([[5], [9]])
    active = torch.tensor([True, False])
    _, pool = forward_paged(params, toks, pool, cfg, active=active)
    assert pool["pos"].tolist() == [1, 0]            # dead row frozen
    for li in range(cfg.n_layers):
        assert pool["k"][li][1, 0].abs().sum() > 0   # live row written
        assert pool["k"][li][3].abs().sum() == 0     # dead row's block clean
        assert pool["k"][li][0, 0].abs().sum() > 0   # ... its write: block 0


def test_prefill_selection_matches_reference():
    for attn in ("dense", "flash", "ring"):
        kw = {**BASE, "attn": attn}
        jcfg = jburnin.BurnInConfig(**kw)
        tcfg = BurnInConfig(**kw)
        for t in (8, 9, 16, 100, 512):
            for prefill in ("auto", "dense", "flash"):
                try:
                    want = jdecode._select_prefill_impl(jcfg, t, prefill)
                except ValueError:
                    want = ValueError
                try:
                    got = tdecode._select_prefill_impl(tcfg, t, prefill)
                except ValueError:
                    got = ValueError
                assert got == want, (attn, t, prefill)
