# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, a sliding window across sequence shards: one seeded numpy
sequence of ``N · S`` rows is cut into ``N`` shards; shard ``i``'s queries
fold the plain K2 (``flash_partial`` with ``q_offset = (i − j)·S`` on each
live block ``j``, what ``shard_flash_attention`` runs on a CPU tensor)
and the joined outputs are held against the JAX reference's windowed
``flash_attention`` on the whole sequence (interpret mode); the gradients
through ``ShardFlash`` (the plain K5, or K3 + K4, at the same offsets)
against ``jax.grad`` of it. Windows ``W`` in {1, S − 1, S, S + 1, 2.5·S,
longer than the sequence}, f32 and bf16, MHA and GQA (the reference's
K/V repeated to the query heads). Offset 0 is the plain versions as they
were before the offset, bit for bit; a block that no query of the shard
reaches launches nothing.

Tolerances: f32 1e-5 · max(1, max|ref|) (summation order: one tile a
block here, 16-row tiles in the reference); bf16 2e-2 · max(1, max|ref|)
(P rounds to bf16 per 16-key tile in the reference and once per block
here, and the folds rescale in another order). Each reference is jitted
and computed once per (window, dtype).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("nvidia_terraform_modules_tpu.ops.flash_attention")
tfa = importlib.import_module(
    "nvidia_terraform_modules_tpu_torch.ops.flash_attention")
tring = importlib.import_module(
    "nvidia_terraform_modules_tpu_torch.ops.ring_attention")

N, S, B, H, D = 4, 8, 2, 4, 16          # 4 shards of 8 rows
BLOCK = 16
WINDOWS = [1, S - 1, S, S + 1, int(2.5 * S), 2 * N * S]
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny and the test workers share the CPU: one
    intra-op thread a process (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(kv_heads=H, seed=0):
    """q, the cotangent w ``[B, N·S, H, D]`` and k, v ``[B, N·S, KV, D]``,
    numpy f32."""
    rng = np.random.default_rng(seed)
    q, w = (rng.normal(size=(B, N * S, H, D)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(B, N * S, kv_heads, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, w


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@functools.lru_cache(maxsize=None)
def _reference(window, dtype, kv_heads=H, seed=0):
    """The inputs (:func:`_inputs`), the reference's windowed flash
    attention on the whole sequence (K/V repeated to the query heads) and
    its q, k, v gradients of ``sum(o · w)`` (k, v summed back over each
    group)."""
    q, k, v, w = _inputs(kv_heads, seed)
    rep = H // kv_heads
    jdtype = DTYPES[dtype][1]

    def out(q_, k_, v_):
        return jfa.flash_attention(
            q_, jnp.repeat(k_, rep, axis=2), jnp.repeat(v_, rep, axis=2),
            mask=("window", window), block_q=BLOCK, block_k=BLOCK,
            interpret=True)

    def loss(q_, k_, v_):
        o = out(q_, k_, v_)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w)), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x, jdtype) for x in (q, k, v)))
    return (q, k, v, w), o, grads


def _sharded(q, k, v, window, backward="fused"):
    """Every shard's output through ``shard_flash_attention``, joined."""
    return torch.cat([tring.shard_flash_attention(
        q[:, i * S:(i + 1) * S], k, v, i, window=window, backward=backward)
        for i in range(N)], dim=1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", WINDOWS)
def test_shard_fold_matches_reference_window(window, dtype):
    tdt, _, tol = DTYPES[dtype]
    (q, k, v, _), want, _ = _reference(window, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = _sharded(tq, tk, tv, window)
    assert got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("window", [S - 1, int(2.5 * S)])
def test_shard_fold_with_gqa_matches_reference(window):
    (q, k, v, _), want, _ = _reference(window, "f32", kv_heads=2, seed=5)
    with torch.no_grad():
        got = _sharded(*(torch.from_numpy(x) for x in (q, k, v)), window)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("backward", ["fused", "split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", WINDOWS)
def test_shard_gradients_match_reference(window, dtype, backward):
    tdt, _, tol = DTYPES[dtype]
    (q, k, v, w), _, want = _reference(window, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    out = _sharded(tq, tk, tv, window, backward)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, wnt in zip(got, want):
        assert g.dtype == tdt
        _close(g, wnt, tol)


def test_offset_backward_plain_versions_match_reference_block():
    """Shard 2's queries against block 1 alone (offset S, window 10): the
    plain K5, K3 and K4 against the reference's kernels on the two blocks
    as one sequence, keeping that pair's rows and columns."""
    q, k, v, w = _inputs(seed=7)
    window, i, j = 10, 2, 1
    rows, cols = slice(i * S, (i + 1) * S), slice(j * S, (j + 1) * S)
    # the reference: a sequence [block j; shard i] (2S rows), whose
    # second half's queries see the first half's keys at offset S
    cat = [np.concatenate([x[:, cols], x[:, rows]], axis=1)
           for x in (q, k, v, w)]
    spec = jfa.as_mask_spec(("window", window))
    qj, kj, vj, doj = (jnp.asarray(x.transpose(0, 2, 1, 3).reshape(
        B * H, 2 * S, D)) for x in cat)
    o, lse = jfa._fwd(qj, kj, vj, scale=D ** -0.5, spec=spec, block_q=BLOCK,
                      block_k=BLOCK, pipe=False, interpret=True)
    delta = jnp.sum(doj * o, axis=-1, keepdims=True)
    kw = dict(scale=D ** -0.5, causal=True, mask=("window", window),
              block_q=BLOCK, block_k=BLOCK, interpret=True)
    jdq, jdk, jdv = jfa.flash_dqdkv(qj, kj, vj, doj, lse, delta, **kw)

    def bshd(x, sl):
        return torch.from_numpy(np.asarray(x).reshape(
            B, H, 2 * S, -1).transpose(0, 2, 1, 3)[:, sl].copy())

    second, first = slice(S, 2 * S), slice(0, S)
    tq, tdo = bshd(qj, second), bshd(doj, second)
    tk, tv = bshd(kj, first), bshd(vj, first)
    tlse = bshd(lse[..., None], second)[..., 0].permute(0, 2, 1).contiguous()
    tdelta = bshd(delta, second)[..., 0].permute(0, 2, 1).contiguous()
    args = (tq, tk, tv, tdo, tlse, tdelta)
    okw = dict(scale=D ** -0.5, mask=("window", window), q_offset=S,
               out_dtype=torch.float32)
    fused = tfa.flash_dqdkv(*args, **okw)
    split = (tfa.flash_dq(*args, **okw), *tfa.flash_dkv(*args, **okw))
    # the reference's dQ of the second half sums both blocks' keys; the
    # block-j part is its dQ less the diagonal block's (offset 0)
    diag = tfa.flash_dq(tq, bshd(kj, second), bshd(vj, second), tdo, tlse,
                        tdelta, scale=D ** -0.5, mask=("window", window))
    want_dq = bshd(jdq, second) - diag
    want_dk, want_dv = bshd(jdk, first), bshd(jdv, first)
    for got in (fused, split):
        _close(got[0], want_dq.numpy(), 1e-5)
        # the first half's dK/dV in the reference also hold its own
        # queries' part (offset 0 against itself): take it out
        own = tfa.flash_dkv(bshd(qj, first), tk, tv, bshd(doj, first),
                            bshd(lse[..., None], first)[..., 0].permute(
                                0, 2, 1).contiguous(),
                            bshd(delta, first)[..., 0].permute(
                                0, 2, 1).contiguous(),
                            scale=D ** -0.5, mask=("window", window))
        _close(got[1], (want_dk - own[0]).numpy(), 1e-5)
        _close(got[2], (want_dv - own[1]).numpy(), 1e-5)


def _old_partial_ref(q, k, v, scale, spec):
    """``flash_partial_ref`` as it was before the key offset: local
    positions only."""
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if spec.kind != "full":
        qi = torch.arange(q.shape[1])[:, None]
        ki = torch.arange(k.shape[1])[None, :]
        keep = qi >= ki
        if spec.kind == "window":
            keep &= (qi - ki) < spec.window
        sc = torch.where(keep, sc, torch.full_like(sc, tfa.NEG_INF))
    m = sc.amax(dim=-1)
    p = torch.where(sc <= tfa.NEG_INF / 2, torch.zeros_like(sc),
                    torch.exp(sc - m[..., None]))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(dim=-1)


@pytest.mark.parametrize("mask", [None, "full", ("window", 3)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_offset_zero_is_the_plain_version_bit_for_bit(mask, dtype):
    tdt = DTYPES[dtype][0]
    q, k, v, w = (torch.from_numpy(x).to(tdt) for x in _inputs(seed=3))
    q, k, v, do = q[:, :S], k[:, :S], v[:, :S], w[:, :S]
    spec = tfa.as_mask_spec(mask)
    new = tfa.flash_partial(q, k, v, scale=0.25, mask=mask, q_offset=0)
    old = _old_partial_ref(q, k, v, 0.25, spec)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(
        new, tfa.flash_partial(q, k, v, scale=0.25, mask=mask)))
    o, lse = tfa.flash_attention_fwd(q, k, v, scale=0.25, mask=mask)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    for fn in (tfa.flash_dqdkv, tfa.flash_dq, tfa.flash_dkv):
        got = fn(*args, scale=0.25, mask=mask, q_offset=0)
        was = fn(*args, scale=0.25, mask=mask)
        got = got if isinstance(got, tuple) else (got,)
        was = was if isinstance(was, tuple) else (was,)
        assert all(torch.equal(a, b) for a, b in zip(got, was))


def test_fully_masked_rows_fold_finite():
    """Window 1 at offset S: no query of the shard sees a key of the
    block — ``m = -1e30``, ``l = 0``, a zero accumulator — and the fold
    with the shard's own block stays finite and equal to the own block
    alone."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(seed=4))
    q, k_own, v_own = q[:, S:2 * S], k[:, S:2 * S], v[:, S:2 * S]
    acc, m, l_ = tfa.flash_partial(q, k[:, :S], v[:, :S], scale=0.25,
                                   mask=("window", 1), q_offset=S)
    assert torch.equal(acc, torch.zeros_like(acc))
    assert bool((m == tfa.NEG_INF).all()) and bool((l_ == 0).all())
    own = tfa.flash_partial(q, k_own, v_own, scale=0.25, mask=("window", 1))
    folded = tring._fold(tring._fold(tring._fold_start(q), own),
                         (acc, m, l_))
    alone = tring._fold(tring._fold_start(q), own)
    assert all(bool(torch.isfinite(x).all()) for x in folded)
    for a, b in zip(folded, alone):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", WINDOWS)
def test_dead_blocks_launch_nothing(monkeypatch, window):
    """Shard ``i`` visits block ``j`` iff ``(i − j)·S − (S − 1) < W``:
    the K2 calls of the forward and the K5 calls of the backward are the
    live blocks, no more."""
    calls = {"fwd": [], "bwd": []}
    partial, dqdkv = tring.flash_partial, tring.flash_dqdkv

    def k2(*a, **kw):
        calls["fwd"].append(kw["q_offset"])
        return partial(*a, **kw)

    def k5(*a, **kw):
        calls["bwd"].append(kw["q_offset"])
        return dqdkv(*a, **kw)

    monkeypatch.setattr(tring, "flash_partial", k2)
    monkeypatch.setattr(tring, "flash_dqdkv", k5)
    q, k, v, w = (torch.from_numpy(x).requires_grad_(True)
                  for x in _inputs(seed=6))
    for i in range(N):
        calls["fwd"].clear()
        calls["bwd"].clear()
        out = tring.shard_flash_attention(q[:, i * S:(i + 1) * S], k, v, i,
                                          window=window)
        out.sum().backward()
        live = [(i - j) * S for j in range(i, -1, -1)
                if (i - j) * S - (S - 1) < window]
        assert calls["fwd"] == live and calls["bwd"] == live
        assert [tring.shard_block_live(i, j, S, window)
                for j in range(N)] == [j <= i and (i - j) * S - (S - 1)
                                       < window for j in range(N)]
