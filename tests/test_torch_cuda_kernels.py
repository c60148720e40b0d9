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
(summation order only). The backward kernels hold dQ/dK/dV within
2e-2 (bf16) / 1e-4 (f32) of max(1, max|plain|), and within a relative L2
error ||got - plain|| / ||plain|| of 1e-2 (bf16) / 1e-4 (f32): bf16 products
accumulate in another order, and the fused kernel's dQ atomics in an order
that changes from run to run.
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
    launches,
    paged_decode_attention,
    paged_decode_attention_ref,
)

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
