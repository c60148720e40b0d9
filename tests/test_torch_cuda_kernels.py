# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc (the kernels have no CPU mode), so they
carry the ``cuda`` marker and skip elsewhere. On a machine with a card,
without JAX, run them with::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: bf16 outputs within 2e-2 (O) / 1e-3 (LSE) and 1e-2 (decode) —
the kernel rounds the UNNORMALISED probabilities to bf16 per tile where the
plain version rounds them once over the row; f32 within 1e-4 / 1e-5
(summation order only). The int8 kernels hold bf16 within 1e-2 of max(1,
max|plain|) — the int8 decode outputs of a row over a few keys reach
|out| > 2, where one bf16 rounding is 0.0156 — and f32 within 1e-5 of it;
the int8 matmul's plain version scales before the product, the kernel
after it. The backward kernels hold dQ/dK/dV within
2e-2 (bf16) / 1e-4 (f32) of max(1, max|plain|), and within a relative L2
error ||got - plain|| / ||plain|| of 1e-2 (bf16) / 1e-4 (f32): bf16 products
accumulate in another order, and the fused kernel's dQ atomics in an order
that changes from run to run. K2 (the partial forward) holds acc, m and l
within 1e-2 (bf16) / 1e-5 (f32) of max(1, max|plain|), and, normalised,
equals K1 bit for bit (one sweep, two epilogues).
"""

import dataclasses

import pytest
import torch

from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    greedy_decode,
    init_params,
    make_grads_fn,
    make_serve_engine,
    quantize_kv,
    quantize_params,
    synthetic_batch,
    tree_leaves,
)
from nvidia_terraform_modules_tpu_torch.ops import (
    flash_attention_fwd,
    flash_attention_ref,
    flash_dkv,
    flash_dq,
    flash_dqdkv,
    flash_dqdkv_ref,
    flash_partial,
    flash_partial_ref,
    int8_matmul,
    int8_matmul_ref,
    kv_decode_attention,
    kv_decode_attention_ref,
    launches,
    paged_decode_attention,
    paged_decode_attention_ref,
    ring_self_attention,
    ulysses_self_attention,
)
from nvidia_terraform_modules_tpu_torch.ops.decode_attention import (
    gather_logical,
)
from nvidia_terraform_modules_tpu_torch.ops.ring_attention import (
    dense_reference_attention,
)
from nvidia_terraform_modules_tpu_torch.parallel import build_mesh, plan_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, shape, dtype, dev):
    return torch.randn(shape, generator=g).to(dtype).to(dev)


@pytest.mark.parametrize("b,s,h,kv,d,dtype,mask", [
    (1, 128, 16, 16, 128, torch.bfloat16, None),
    (1, 512, 16, 16, 128, torch.bfloat16, None),
    (1, 136, 16, 16, 128, torch.bfloat16, None),
    (2, 100, 4, 2, 64, torch.float32, None),
    (1, 200, 4, 4, 128, torch.float32, ("window", 50)),
    (1, 70, 2, 1, 32, torch.bfloat16, "full"),
])
def test_flash_fwd_matches_plain(cuda, b, s, h, kv, d, dtype, mask):
    g = torch.Generator().manual_seed(s * 7 + d)
    q = _randn(g, (b, s, h, d), dtype, cuda)
    k = _randn(g, (b, s, kv, d), dtype, cuda)
    v = _randn(g, (b, s, kv, d), dtype, cuda)
    before = launches["flash_fwd"]
    o, lse = flash_attention_fwd(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert launches["flash_fwd"] == before + 1
    o_ref, lse_ref = flash_attention_ref(q, k, v, mask=mask)
    o_tol, l_tol = (2e-2, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - o_ref.float()).abs().max().item() <= o_tol
    assert (lse - lse_ref).abs().max().item() <= l_tol


@pytest.mark.parametrize("b,h,kv,d,bs,dtype", [
    (4, 16, 16, 128, 16, torch.bfloat16),
    (3, 8, 2, 64, 5, torch.float32),
])
def test_paged_decode_matches_plain(cuda, b, h, kv, d, bs, dtype):
    g = torch.Generator().manual_seed(b * 31 + bs)
    nt = -(-600 // bs)
    nb = 1 + b * nt
    k_pool = _randn(g, (nb, bs, kv, d), dtype, cuda)
    v_pool = _randn(g, (nb, bs, kv, d), dtype, cuda)
    k_pool[0] = 1e4                   # the garbage block: a read would show
    v_pool[0] = 1e4
    perm = torch.randperm(nb - 1, generator=g) + 1
    tables = perm.reshape(b, nt).to(torch.int32)
    pos = torch.randint(0, 560, (b,), generator=g).to(torch.int32)
    pos[-1] = 3                       # a frozen short row
    for i in range(b):                # entries past pos point at garbage
        tables[i, int(pos[i]) // bs + 1:] = 0
    tables, pos = tables.to(cuda), pos.to(cuda)
    q = _randn(g, (b, h, d), dtype, cuda)
    scale = d ** -0.5
    before = launches["paged_decode"]
    out = paged_decode_attention(q, k_pool, v_pool, tables, pos, scale=scale)
    torch.cuda.synchronize()
    assert launches["paged_decode"] == before + 1
    ref = paged_decode_attention_ref(q, k_pool, v_pool, tables, pos,
                                     scale=scale)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("b,h,kv,d,s,qdtype,quant", [
    (8, 16, 16, 128, 768, torch.bfloat16, True),   # the int8 decode step
    (3, 8, 2, 128, 300, torch.bfloat16, True),     # GQA, ragged pos
    (2, 4, 1, 64, 130, torch.float32, True),
    (3, 8, 2, 64, 200, torch.bfloat16, False),     # bf16 cache
    (2, 4, 4, 32, 70, torch.float32, False),       # f32 cache
])
def test_kv_decode_matches_plain(cuda, b, h, kv, d, s, qdtype, quant):
    g = torch.Generator().manual_seed(b * 7 + d + s)
    q = _randn(g, (b, h, d), qdtype, cuda)
    pos = torch.randint(0, s, (b,), generator=g).to(torch.int32)
    pos[0] = 0                              # a row that sees one key
    k, v = (_randn(g, (b, s, kv, d), torch.float32, cuda) for _ in range(2))
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(qdtype), v.to(qdtype)
    for i in range(b):                      # rows past pos: a read shows
        k[i, int(pos[i]) + 1:] = 127 if quant else 1e4
        v[i, int(pos[i]) + 1:] = 127 if quant else 1e4
        if quant:
            ks[i, int(pos[i]) + 1:] = 1e4
            vs[i, int(pos[i]) + 1:] = 1e4
    pos = pos.to(cuda)
    before = launches["kv_decode"]
    out = kv_decode_attention(q, k, v, pos, scale=d ** -0.5, k_scale=ks,
                              v_scale=vs)
    torch.cuda.synchronize()
    assert launches["kv_decode"] == before + 1
    ref = kv_decode_attention_ref(q, k, v, pos, scale=d ** -0.5, k_scale=ks,
                                  v_scale=vs)
    tol = 1e-2 if qdtype == torch.bfloat16 else 1e-5
    assert out.dtype == qdtype
    lim = tol * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= lim


@pytest.mark.parametrize("b,h,kv,d,bs", [(4, 16, 16, 128, 16),
                                         (3, 8, 2, 64, 5)])
def test_paged_decode_int8_matches_plain_and_contiguous(cuda, b, h, kv, d,
                                                        bs):
    """The int8 pool through the tables: against the plain version, and bit
    for bit against the contiguous kernel on the gathered view (one fold);
    the garbage block's rows (127) and scales (1e4) are never read."""
    g = torch.Generator().manual_seed(b * 13 + bs)
    nt = -(-600 // bs)
    nb = 1 + b * nt
    k, ks = quantize_kv(_randn(g, (nb, bs, kv, d), torch.float32, cuda))
    v, vs = quantize_kv(_randn(g, (nb, bs, kv, d), torch.float32, cuda))
    for t in (k, v):
        t[0] = 127
    for t in (ks, vs):
        t[0] = 1e4
    tables = (torch.randperm(nb - 1, generator=g) + 1).reshape(b, nt)
    tables = tables.to(torch.int32)
    pos = torch.randint(0, 560, (b,), generator=g).to(torch.int32)
    pos[-1] = 3
    for i in range(b):
        tables[i, int(pos[i]) // bs + 1:] = 0
    tables, pos = tables.to(cuda), pos.to(cuda)
    q = _randn(g, (b, h, d), torch.bfloat16, cuda)
    before = dict(launches)
    out = paged_decode_attention(q, k, v, tables, pos, scale=d ** -0.5,
                                 k_scale=ks, v_scale=vs)
    rows = nt * bs
    flat = kv_decode_attention(
        q, gather_logical(k, tables, rows), gather_logical(v, tables, rows),
        pos, scale=d ** -0.5, k_scale=gather_logical(ks, tables, rows),
        v_scale=gather_logical(vs, tables, rows))
    torch.cuda.synchronize()
    assert launches["paged_decode_int8"] == before["paged_decode_int8"] + 1
    assert launches["paged_decode"] == before["paged_decode"]
    ref = paged_decode_attention_ref(q, k, v, tables, pos, scale=d ** -0.5,
                                     k_scale=ks, v_scale=vs)
    lim = 1e-2 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= lim
    assert torch.equal(out, flat)


@pytest.mark.parametrize("m,k,n,trans,dtype", [
    (4, 2048, 2048, False, torch.bfloat16),
    (4, 2048, 8192, False, torch.bfloat16),
    (4, 8192, 2048, False, torch.bfloat16),
    (4, 2048, 8192, True, torch.bfloat16),     # the tied head, [N, K]
    (64, 384, 640, False, torch.bfloat16),
    (1, 256, 128, True, torch.float32),
    (7, 640, 192, False, torch.float32),
])
def test_int8_matmul_matches_plain(cuda, m, k, n, trans, dtype):
    g = torch.Generator().manual_seed(m * 3 + k + n)
    w = torch.randint(-127, 128, (n, k) if trans else (k, n), generator=g,
                      dtype=torch.int8).to(cuda)
    scale = (torch.rand((n,), generator=g) * 0.02 + 1e-3).to(cuda)
    x = _randn(g, (m, k), dtype, cuda)
    before = launches["int8_matmul"]
    out = int8_matmul(x, w, scale, transpose_rhs=trans)
    rows = torch.cat([int8_matmul(x[i:i + 1], w, scale, transpose_rhs=trans)
                      for i in range(m)])
    torch.cuda.synchronize()
    assert launches["int8_matmul"] == before + 1 + m
    ref = int8_matmul_ref(x, w, scale, transpose_rhs=trans).float()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    lim = tol * max(1.0, ref.abs().max().item())
    assert out.dtype == dtype and out.shape == (m, n)
    assert (out.float() - ref).abs().max().item() <= lim
    assert torch.equal(out, rows)            # a row's bits do not depend on M


def test_int8_kernels_refuse_what_they_cannot_take(cuda):
    w = torch.zeros((256, 256), dtype=torch.int8, device=cuda)
    s = torch.ones((256,), device=cuda)
    x = torch.zeros((65, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="M <= 64"):
        int8_matmul(x, w, s)
    with pytest.raises(ValueError, match="K % 128"):
        int8_matmul(x[:4, :100], w[:100], s)
    with pytest.raises(ValueError, match="N % 64"):
        int8_matmul(x[:4], w[:, :100], s[:100])
    q = torch.zeros((1, 2, 24), dtype=torch.bfloat16, device=cuda)
    cache = torch.zeros((1, 8, 2, 24), dtype=torch.int8, device=cuda)
    sc = torch.ones((1, 8, 2), device=cuda)
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kv_decode_attention(q, cache, cache, pos, scale=1.0, k_scale=sc,
                            v_scale=sc)


def test_int8_serve_engine_on_card_matches_solo(cuda):
    """f32 int8 weights and an int8 cache through all three kernels: the
    engine (K7-int8 waves, and the gather path's K6) equals solo decode
    (K6). Prompts are longer than 64 tokens, so the solo prefill takes the
    same dequantised product as the engine's admissions."""
    cfg = BurnInConfig(vocab=512, d_model=256, n_heads=2, n_kv_heads=1,
                       d_ff=512, n_layers=2, dtype=torch.float32,
                       attn="flash")
    params = quantize_params(init_params(
        cfg, torch.Generator(device=cuda).manual_seed(3), device=cuda),
        dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (72 + 8 * i,), generator=g)
               for i in range(4)]
    kw = dict(max_len=112, kv_block=16, cache_dtype="int8", device=cuda)
    got = make_serve_engine(params, cfg, **kw)(prompts, 8, slots=2)
    off = make_serve_engine(params, cfg, paged_kernel="off", **kw)(
        prompts, 8, slots=2)
    for p, a, c in zip(prompts, got, off):
        solo = greedy_decode(params, p[None], 8, cfg, cache_dtype="int8",
                             device=cuda)[0]
        assert torch.equal(a, solo) and torch.equal(c, solo)


def _bwd_inputs(g, b, s, h, d, dtype, dev, mask):
    q, k, v, do = (_randn(g, (b, s, h, d), dtype, dev) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, mask=mask)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("b,s,h,d,dtype,mask", [
    (1, 128, 16, 128, torch.bfloat16, None),
    (1, 512, 16, 128, torch.bfloat16, None),
    (1, 136, 16, 128, torch.bfloat16, None),
    (1, 512, 16, 128, torch.bfloat16, ("window", 128)),
    (1, 70, 2, 32, torch.bfloat16, ("window", 20)),
    (1, 256, 8, 64, torch.bfloat16, None),
    (1, 200, 4, 128, torch.bfloat16, ("window", 64)),
    (1, 200, 4, 128, torch.float32, "full"),
    (2, 100, 4, 64, torch.float32, None),
])
def test_flash_backward_kernels_match_plain(cuda, b, s, h, d, dtype, mask):
    g = torch.Generator().manual_seed(s * 5 + d)
    args = _bwd_inputs(g, b, s, h, d, dtype, cuda, mask)
    kw = dict(scale=d ** -0.5, mask=mask)
    before = {n: launches[n] for n in ("flash_bwd_fused", "flash_dq",
                                       "flash_dkv")}
    fused = flash_dqdkv(*args, **kw)
    split = (flash_dq(*args, **kw), *flash_dkv(*args, **kw))
    torch.cuda.synchronize()
    assert {n: launches[n] - c for n, c in before.items()} == {
        "flash_bwd_fused": 1, "flash_dq": 1, "flash_dkv": 1}
    ref = flash_dqdkv_ref(*args, **kw)
    tol, tol_l2 = (2e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    for name, f, sp, r in zip("qkv", fused, split, ref):
        assert f.dtype == sp.dtype == dtype and f.shape == r.shape
        r = r.float()
        lim = tol * max(1.0, r.abs().max().item())
        for got, want in ((f, r), (sp, r), (f, sp.float())):
            diff = got.float() - want
            err = diff.abs().max().item()
            assert err <= lim, f"d{name}: {err} > {lim}"
            l2 = (diff.norm() / want.norm()).item()
            assert l2 <= tol_l2, f"d{name}: relative L2 {l2} > {tol_l2}"


def test_kernels_refuse_unsupported_shapes(cuda):
    q = torch.zeros((1, 16, 2, 136), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)
    qd = torch.zeros((1, 2, 260), device=cuda, dtype=torch.bfloat16)
    pool = torch.zeros((2, 4, 2, 260), device=cuda, dtype=torch.bfloat16)
    tab = torch.zeros((1, 1), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(qd, pool, pool, tab, tab[:, 0], scale=1.0)


def test_serve_engine_on_card_matches_solo_greedy(cuda):
    """The on-card exactness contract: f32, head_dim 128, both kernels."""
    cfg = BurnInConfig(vocab=512, d_model=256, n_heads=2, n_kv_heads=1,
                       d_ff=512, n_layers=2, dtype=torch.float32,
                       attn="flash")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(3),
                         device=cuda)
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (8 * (1 + i % 3),), generator=g)
               for i in range(5)]
    engine = make_serve_engine(params, cfg, max_len=40, kv_block=16,
                               device=cuda)
    off = make_serve_engine(params, cfg, max_len=40, kv_block=16,
                            paged_kernel="off", device=cuda)
    got, got_off = engine(prompts, 8, slots=2), off(prompts, 8, slots=2)
    for p, a, c in zip(prompts, got, got_off):
        solo = greedy_decode(params, p[None], 8, cfg, device=cuda)[0]
        assert torch.equal(a, solo) and torch.equal(c, solo)


@pytest.mark.parametrize("t", [13, 521])
def test_greedy_decode_ragged_prompt_runs_flash_prefill(cuda, t):
    """A prompt with no 8-multiple block (521 raised before the prefill
    rule became device-aware) prefills through K1 on the card and decodes
    the same tokens as the dense prefill (f32, head_dim 128)."""
    cfg = BurnInConfig(vocab=512, d_model=256, n_heads=2, n_kv_heads=1,
                       d_ff=512, n_layers=2, dtype=torch.float32,
                       attn="flash")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(7),
                         device=cuda)
    prompt = torch.randint(0, cfg.vocab, (1, t),
                           generator=torch.Generator().manual_seed(t))
    before = launches["flash_fwd"]
    got = greedy_decode(params, prompt, 6, cfg, device=cuda)
    torch.cuda.synchronize()
    assert launches["flash_fwd"] == before + cfg.n_layers
    want = greedy_decode(params, prompt, 6, cfg, prefill="dense",
                         device=cuda)
    assert torch.equal(got, want)


@pytest.mark.parametrize("backward", ["fused", "split"])
def test_train_grads_on_card_match_dense(cuda, backward):
    """The autograd path through the kernels (K1 forward; K5, or K3 + K4,
    backward) against the same model on the dense path, f32 at head_dim
    128, GQA and a window: loss and every gradient within 1e-4 of
    max(1, max|g|)."""
    cfg = BurnInConfig(vocab=256, d_model=256, n_heads=2, n_kv_heads=1,
                       d_ff=256, n_layers=2, seq_len=136, batch=2,
                       attn="flash", flash_backward=backward,
                       flash_window=100, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(5),
                         device=cuda)
    batch = synthetic_batch(torch.Generator(device=cuda).manual_seed(6), cfg,
                            device=cuda)
    names = ("flash_fwd", "flash_bwd_fused", "flash_dq", "flash_dkv")
    before = {n: launches[n] for n in names}
    loss, grads = make_grads_fn(cfg)(params, batch)
    torch.cuda.synchronize()
    fused = backward == "fused"
    assert {n: launches[n] - c for n, c in before.items()} == {
        "flash_fwd": 2, "flash_bwd_fused": 2 * fused,
        "flash_dq": 2 * (not fused), "flash_dkv": 2 * (not fused)}
    dloss, dgrads = make_grads_fn(dataclasses.replace(cfg, attn="dense"))(
        params, batch)
    assert abs(loss.item() - dloss.item()) <= 1e-4 * max(1.0, dloss.item())
    for g, w in zip(tree_leaves(grads), tree_leaves(dgrads)):
        lim = 1e-4 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= lim


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dtype,mask", [
    (2, 128, 128, 4, 4, 128, torch.bfloat16, "causal"),
    (2, 128, 128, 4, 4, 128, torch.bfloat16, "full"),
    (1, 136, 200, 4, 2, 64, torch.bfloat16, "full"),
    (1, 200, 72, 2, 2, 128, torch.float32, "causal"),
    (1, 256, 256, 2, 1, 32, torch.bfloat16, ("window", 50)),
    (1, 96, 96, 2, 2, 128, torch.float32, "full"),
])
def test_flash_partial_matches_plain_and_flash_fwd(cuda, b, sq, sk, h, kv,
                                                   d, dtype, mask):
    g = torch.Generator().manual_seed(sq * 3 + sk)
    q = _randn(g, (b, sq, h, d), dtype, cuda)
    k = _randn(g, (b, sk, kv, d), dtype, cuda)
    v = _randn(g, (b, sk, kv, d), dtype, cuda)
    kw = dict(scale=d ** -0.5, mask=mask)
    before = launches["flash_partial"]
    got = flash_partial(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launches["flash_partial"] == before + 1
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for a, r in zip(got, flash_partial_ref(q, k, v, **kw)):
        assert a.dtype == torch.float32 and a.shape == r.shape
        lim = tol * max(1.0, r.abs().max().item())
        assert (a - r).abs().max().item() <= lim
    if sq == sk and kv == h:
        acc, m, l_ = got
        o, lse = flash_attention_fwd(q, k, v, **kw)
        lm = l_.clamp_min(1e-30)
        assert torch.equal((acc / lm.transpose(1, 2)[..., None]).to(dtype), o)
        assert ((m + torch.log(lm) - lse).abs()
                / lse.abs().clamp_min(1.0)).max().item() <= 1e-6


def _k2_normalised_equals_k1(q, k, v, got, **kw):
    acc, m, l_ = got
    o, lse = flash_attention_fwd(q, k, v, **kw)
    lm = l_.clamp_min(1e-30)
    assert torch.equal((acc / lm.transpose(1, 2)[..., None]).to(q.dtype), o)
    assert ((m + torch.log(lm) - lse).abs()
            / lse.abs().clamp_min(1.0)).max().item() <= 1e-6
    return o, lse


@pytest.mark.parametrize("b,sq,sk,h,kv,d,mask", [
    (1, 1, 1, 16, 16, 128, "causal"),
    (2, 65, 65, 4, 4, 64, "causal"),
    (1, 129, 129, 16, 1, 128, "causal"),        # GQA 16:1
    (2, 200, 200, 8, 2, 32, "causal"),          # GQA 8:2
    (1, 4100, 4100, 2, 2, 128, "causal"),
    (1, 200, 200, 4, 4, 128, ("window", 70)),   # edges inside 64-key tiles
    (1, 129, 129, 4, 2, 64, "full"),
    (1, 200, 72, 4, 4, 128, "causal"),          # K2: keys shorter than q
    (1, 65, 300, 4, 4, 64, "causal"),           # K2: keys longer than q
    (1, 129, 200, 8, 2, 32, "full"),
    (1, 300, 129, 4, 4, 128, ("window", 50)),
])
def test_flash_forward_bf16_ragged_lengths(cuda, b, sq, sk, h, kv, d,
                                           mask):
    """The bf16 sweep at lengths that are no multiple of its 64-row q
    block or of its 64-key tile, GQA, window edges inside a tile and
    d = 32 / 64 / 128: K2 against its plain version (1e-2 of max(1,
    max|plain|)); at equal lengths K1 against its plain version (2e-2 /
    1e-3) and K2 normalised equal to K1 bit for bit."""
    g = torch.Generator().manual_seed(sq * 5 + sk + d)
    q = _randn(g, (b, sq, h, d), torch.bfloat16, cuda)
    k = _randn(g, (b, sk, kv, d), torch.bfloat16, cuda)
    v = _randn(g, (b, sk, kv, d), torch.bfloat16, cuda)
    kw = dict(scale=d ** -0.5, mask=mask)
    got = flash_partial(q, k, v, **kw)
    for a, r in zip(got, flash_partial_ref(q, k, v, **kw)):
        assert a.shape == r.shape
        lim = 1e-2 * max(1.0, r.abs().max().item())
        assert (a - r).abs().max().item() <= lim
    if sq != sk:
        return
    o, lse = _k2_normalised_equals_k1(q, k, v, got, **kw)
    o_ref, lse_ref = flash_attention_ref(q, k, v, **kw)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_flash_forward_bf16_is_deterministic(cuda):
    """Two launches give the same bits, and row b of a batch-2 call equals
    the same input run alone, though the two grids order their blocks
    differently."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (_randn(g, (2, 520, 16, 128), torch.bfloat16, cuda)
               for _ in range(3))
    o, lse = flash_attention_fwd(q, k, v)
    o2, lse2 = flash_attention_fwd(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    part = flash_partial(q, k, v, scale=128 ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(
        part, flash_partial(q, k, v, scale=128 ** -0.5)))
    for row in range(2):
        sl = slice(row, row + 1)
        o1, lse1 = flash_attention_fwd(q[sl], k[sl], v[sl])
        assert torch.equal(o1, o[sl]) and torch.equal(lse1, lse[sl])
        p1 = flash_partial(q[sl], k[sl], v[sl], scale=128 ** -0.5)
        assert all(torch.equal(x, y[sl]) for x, y in zip(p1, part))


def test_flash_partial_equals_flash_fwd_at_causal_4096(cuda):
    """K2 normalised equals K1 bit for bit at the train step's causal
    length."""
    g = torch.Generator().manual_seed(12)
    q, k, v = (_randn(g, (1, 4096, 4, 128), torch.bfloat16, cuda)
               for _ in range(3))
    got = flash_partial(q, k, v, scale=128 ** -0.5, causal=True)
    _k2_normalised_equals_k1(q, k, v, got, scale=128 ** -0.5, causal=True)


@pytest.mark.parametrize("shape", [(2, 256, 4, 128), (2, 1024, 16, 128)])
@pytest.mark.parametrize("mask", ["causal", "full"])
def test_flash_backward_f32_outputs_match_plain(cuda, mask, shape):
    """``out_dtype=float32`` on bf16 inputs (the ring's per-block
    gradients, up to the flagship ring's block): K5, K3 and K4 against
    their plain versions."""
    g = torch.Generator().manual_seed(17)
    args = _bwd_inputs(g, *shape, torch.bfloat16, cuda, mask)
    kw = dict(scale=128 ** -0.5, mask=mask, out_dtype=torch.float32)
    fused = flash_dqdkv(*args, **kw)
    split = (flash_dq(*args, **kw), *flash_dkv(*args, **kw))
    torch.cuda.synchronize()
    ref = flash_dqdkv_ref(*args, **kw)
    for name, f, sp, r in zip("qkv", fused, split, ref):
        assert f.dtype == sp.dtype == r.dtype == torch.float32
        lim = 2e-2 * max(1.0, r.abs().max().item())
        for got in (f, sp):
            diff = got - r
            assert diff.abs().max().item() <= lim, f"d{name}"
            assert (diff.norm() / r.norm()).item() <= 1e-2, f"d{name}"


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_flash_dkv_bf16_is_deterministic(cuda, out_dtype):
    """K4 has no atomics and sums its q tiles in a fixed order: two calls
    give the same bits, and batch row 0 of a batch-2 call equals the same
    row run alone, though the two grids order their blocks differently."""
    g = torch.Generator().manual_seed(19)
    args = _bwd_inputs(g, 2, 520, 16, 128, torch.bfloat16, cuda, None)
    kw = dict(scale=128 ** -0.5, out_dtype=out_dtype)
    dk, dv = flash_dkv(*args, **kw)
    dk2, dv2 = flash_dkv(*args, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    dk1, dv1 = flash_dkv(*(t[:1].contiguous() for t in args), **kw)
    assert torch.equal(dk1, dk[:1]) and torch.equal(dv1, dv[:1])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("fn", [ring_self_attention, ulysses_self_attention],
                         ids=["ring", "ulysses"])
def test_sequence_parallel_on_card_matches_dense(cuda, sp, fn):
    """The f32 ring (K2; K5 or K3 + K4) and Ulysses (K1; K5 or K3 + K4) on
    a mesh of ``sp`` members of the one card against dense attention:
    output and gradients within 1e-4 of max(1, max|dense|)."""
    mesh = build_mesh(plan_mesh(sp, tp=1, sp=sp), devices=[cuda] * sp)
    g = torch.Generator().manual_seed(sp)
    q, k, v, w = (_randn(g, (2, 256, 4, 128), torch.float32, cuda)
                  for _ in range(4))

    def run(f):
        x = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = f(*x)
        return [out.detach(), *torch.autograd.grad((out * w).sum(), x)]

    ref = run(lambda *x: dense_reference_attention(*x, causal=True))
    for backward in ("fused", "split"):
        got = run(lambda *x: fn(*x, mesh, causal=True, impl="flash",
                                backward=backward))
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            lim = 1e-4 * max(1.0, r.abs().max().item())
            assert (a - r).abs().max().item() <= lim


@pytest.mark.parametrize("fn,kernel", [
    (ring_self_attention, "flash_partial"),
    (ulysses_self_attention, "flash_fwd")], ids=["ring", "ulysses"])
def test_sequence_parallel_on_card_flash_at_ragged_lengths(cuda, fn, kernel):
    """``impl=None`` on the card runs the kernels at a length with no
    8-multiple block (S = 52: 13-row ring shards at sp = 4), and matches
    dense attention, output and gradients, within 1e-4 of
    max(1, max|dense|)."""
    mesh = build_mesh(plan_mesh(4, tp=1, sp=4), devices=[cuda] * 4)
    g = torch.Generator().manual_seed(52)
    q, k, v, w = (_randn(g, (2, 52, 4, 64), torch.float32, cuda)
                  for _ in range(4))

    def run(f):
        x = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = f(*x)
        return [out.detach(), *torch.autograd.grad((out * w).sum(), x)]

    ref = run(lambda *x: dense_reference_attention(*x, causal=True))
    before = dict(launches)
    got = run(lambda *x: fn(*x, mesh, causal=True))
    torch.cuda.synchronize()
    for name in (kernel, "flash_bwd_fused"):
        assert launches[name] > before[name], name
    for a, r in zip(got, ref):
        lim = 1e-4 * max(1.0, r.abs().max().item())
        assert (a - r).abs().max().item() <= lim
