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
equals K1 bit for bit (one sweep, two epilogues). K3 and K4 have no atomics:
two calls, and a row alone against the same row in a batch, give the same
bits; so does K8, which sums its K slices in slice order inside a
cluster, on any stream and with other shapes queued around it. The decode kernels split a row's keys into fixed spans combined in
span order, so the paged kernel equals the contiguous one on the gathered
view, and a row alone equals the same row in a batch, bit for bit. The
serve engine's wave replayed from its captured CUDA graph equals the eager
wave bit for bit: tokens, and every byte of the pool; so do the sampled wave
(tokens, the slots' (request, position) rows) and the speculative trip
(context, counts, report). D1, the keyed draw, equals its plain version bit
for bit, tokens and Gumbel scores: both take libdevice's ``logf``. The
compiled greedy decoder (``make_decoder``: an eager prefill, then one
replay of the captured steps) equals the eager loop bit for bit, its
capture holds ``n_new - 1`` times one step's launches, a second params tree
is captured anew, and the engine's telemetry adds no synchronise.
"""

import dataclasses

import pytest
import torch

from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    greedy_decode,
    init_paged_cache,
    init_params,
    make_decoder,
    make_grads_fn,
    make_quantized_decoder,
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
    flash_dq_ref,
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
    DECODE_SPAN,
    gather_logical,
)
from nvidia_terraform_modules_tpu_torch.ops.int8_matmul import (
    int8_grid,
    int8_slices,
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


def _paged_case(g, dev, b, h, kv, d, bs, nt, pos, dtype, quant):
    """A pool of 1 + b·nt blocks (block 0 the garbage block, planted), each
    row's live blocks at random, its entries past pos at block 0."""
    nb = 1 + b * nt
    k = _randn(g, (nb, bs, kv, d), torch.float32, dev)
    v = _randn(g, (nb, bs, kv, d), torch.float32, dev)
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        for t in (k, v):
            t[0] = 127
        for t in (ks, vs):
            t[0] = 1e4
    else:
        k, v = k.to(dtype), v.to(dtype)
        k[0] = 1e4
        v[0] = 1e4
    tables = (torch.randperm(nb - 1, generator=g) + 1).reshape(b, nt)
    tables = tables.to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32)
    for i in range(b):
        tables[i, int(pos[i]) // bs + 1:] = 0
    q = _randn(g, (b, h, d), dtype, dev)
    return q, k, v, ks, vs, tables.to(dev), pos.to(dev)


def _gathered(k, v, ks, vs, tables, rows):
    flat = [gather_logical(t, tables, rows) for t in (k, v)]
    if ks is None:
        return flat + [None, None]
    return flat + [gather_logical(t, tables, rows) for t in (ks, vs)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_matches_contiguous_bitwise(cuda, dtype):
    """The bf16/f32 pool through the tables equals the contiguous kernel on
    the gathered view bit for bit (one fold, one split); garbage block 0
    (1e4) is never read."""
    g = torch.Generator().manual_seed(29)
    b, h, kv, d, bs = 4, 16, 16, 128, 16
    nt = -(-600 // bs)
    q, k, v, _, _, tables, pos = _paged_case(
        g, cuda, b, h, kv, d, bs, nt, [559, 301, 77, 130], dtype, False)
    out = paged_decode_attention(q, k, v, tables, pos, scale=d ** -0.5)
    fk, fv, _, _ = _gathered(k, v, None, None, tables, nt * bs)
    flat = kv_decode_attention(q, fk, fv, pos, scale=d ** -0.5)
    torch.cuda.synchronize()
    ref = paged_decode_attention_ref(q, k, v, tables, pos, scale=d ** -0.5)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(out, flat)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs", [16, 5])
def test_decode_kernels_across_span_boundaries(cuda, quant, bs):
    """K7 (bf16 or int8 pool) and K6 at positions on either side of the
    span boundaries (0, S - 1, S, S + 1, 2 S, 3 S + 7 for a span of S
    keys): against the plain version, and K7 against K6 on the gathered
    view bit for bit."""
    g = torch.Generator().manual_seed(31 + bs)
    s = DECODE_SPAN
    pos = [0, s - 1, s, s + 1, 2 * s, 3 * s + 7]
    b, h, kv, d = len(pos), 8, 4, 128
    nt = -(-(4 * s) // bs)
    q, k, v, ks, vs, tables, pos_t = _paged_case(
        g, cuda, b, h, kv, d, bs, nt, pos, torch.bfloat16, quant)
    kw = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)
    out = paged_decode_attention(q, k, v, tables, pos_t, **kw)
    fk, fv, fks, fvs = _gathered(k, v, ks, vs, tables, nt * bs)
    flat = kv_decode_attention(q, fk, fv, pos_t, scale=d ** -0.5,
                               k_scale=fks, v_scale=fvs)
    torch.cuda.synchronize()
    ref = paged_decode_attention_ref(q, k, v, tables, pos_t, **kw).float()
    lim = 1e-2 * (max(1.0, ref.abs().max().item()) if quant else 1.0)
    assert (out.float() - ref).abs().max().item() <= lim
    assert torch.equal(out, flat)


@pytest.mark.parametrize("kernel", ["paged", "paged_int8", "contiguous",
                                    "contiguous_int8"])
def test_decode_row_alone_equals_row_in_batch(cuda, kernel):
    """A row's bits depend only on its own keys and position: each row of a
    batch of 4 unrelated rows equals the same row run alone."""
    g = torch.Generator().manual_seed(37)
    quant = kernel.endswith("int8")
    b, h, kv, d, bs = 4, 16, 16, 128, 16
    nt = -(-600 // bs)
    q, k, v, ks, vs, tables, pos = _paged_case(
        g, cuda, b, h, kv, d, bs, nt, [559, 63, 64, 300], torch.bfloat16,
        quant)
    def rows(i, *ts):        # row i alone (fresh, aligned copies), or all
        sl = slice(i, i + 1) if i is not None else slice(None)
        return [None if t is None else t[sl].clone() for t in ts]

    if kernel.startswith("paged"):
        def run(i):
            qi, ti, pi = rows(i, q, tables, pos)
            return paged_decode_attention(qi, k, v, ti, pi, scale=d ** -0.5,
                                          k_scale=ks, v_scale=vs)
    else:
        flat = _gathered(k, v, ks, vs, tables, nt * bs)

        def run(i):
            qi, pi, fk, fv, fks, fvs = rows(i, q, pos, *flat)
            return kv_decode_attention(qi, fk, fv, pi, scale=d ** -0.5,
                                       k_scale=fks, v_scale=fvs)
    batch = run(None)
    for i in range(b):
        assert torch.equal(run(i)[0], batch[i]), f"row {i}"


@pytest.mark.parametrize("m,k,n,trans,dtype", [
    (4, 2048, 2048, False, torch.bfloat16),
    (4, 2048, 8192, False, torch.bfloat16),
    (4, 8192, 2048, False, torch.bfloat16),
    (4, 2048, 8192, True, torch.bfloat16),     # the tied head, [N, K]
    (64, 384, 640, False, torch.bfloat16),
    (1, 256, 128, True, torch.float32),
    (7, 640, 192, False, torch.float32),
    # M across the mma's 8-row n-tiles (row groups of 8)
    (1, 2048, 2048, False, torch.bfloat16),
    (8, 2048, 2048, False, torch.bfloat16),
    (9, 2048, 2048, False, torch.bfloat16),
    (16, 2048, 2048, False, torch.bfloat16),
    (64, 2048, 2048, False, torch.bfloat16),
    # K = 8192: 8 slices of 8 tiles, summed in the launch
    (8, 8192, 2048, False, torch.bfloat16),
    (9, 8192, 2048, False, torch.bfloat16),
    (8, 2048, 8192, True, torch.bfloat16),     # the head at the decode M
    # a half-filled last channel block, split over slices
    (4, 2048, 192, False, torch.bfloat16),
    (4, 2048, 320, True, torch.bfloat16),
    # f32 x: the CUDA-core sweep through the same split
    (4, 2048, 2048, False, torch.float32),
    (9, 2048, 8192, True, torch.float32),
    # K whose tile count is not a power of two: 4 slices of 3 tiles, 8 of
    # 3 and 4 of 7
    (4, 1536, 2048, False, torch.bfloat16),
    (4, 3072, 2048, False, torch.bfloat16),
    (8, 3584, 2048, True, torch.bfloat16),
])
def test_int8_matmul_matches_plain(cuda, m, k, n, trans, dtype):
    g = torch.Generator().manual_seed(m * 3 + k + n)
    w = torch.randint(-127, 128, (n, k) if trans else (k, n), generator=g,
                      dtype=torch.int8).to(cuda)
    scale = (torch.rand((n,), generator=g) * 0.02 + 1e-3).to(cuda)
    x = _randn(g, (m, k), dtype, cuda)
    before = launches["int8_matmul"]
    out = int8_matmul(x, w, scale, transpose_rhs=trans)
    again = int8_matmul(x, w, scale, transpose_rhs=trans)
    rows = torch.cat([int8_matmul(x[i:i + 1], w, scale, transpose_rhs=trans)
                      for i in range(m)])
    torch.cuda.synchronize()
    assert launches["int8_matmul"] == before + 2 + m
    ref = int8_matmul_ref(x, w, scale, transpose_rhs=trans).float()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    lim = tol * max(1.0, ref.abs().max().item())
    assert out.dtype == dtype and out.shape == (m, n)
    assert (out.float() - ref).abs().max().item() <= lim
    assert torch.equal(out, again)           # the same bits on a second call
    assert torch.equal(out, rows)            # a row's bits do not depend on M


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 8192), (8192, 2048),
                                 (1536, 2048), (3584, 640), (128, 64)])
def test_int8_grid_is_the_launch(cuda, k, n):
    """The grid the kernel reports: 128-channel blocks, the wrapper's K
    split (the same at every M) and row groups of 8."""
    for m in (1, 4, 8, 9, 64):
        assert int8_grid(m, k, n) == (-(-n // 128), int8_slices(k, n),
                                      -(-m // 8))


def _int8_case(seed, m, k, n, trans, dev):
    g = torch.Generator().manual_seed(seed)
    w = torch.randint(-127, 128, (n, k) if trans else (k, n), generator=g,
                      dtype=torch.int8).to(dev)
    scale = (torch.rand((n,), generator=g) * 0.02 + 1e-3).to(dev)
    return _randn(g, (m, k), torch.bfloat16, dev), w, scale


def test_int8_matmul_back_to_back_shapes(cuda):
    """Two shapes with different splits (8 slices of 8 tiles, then 2 of 8
    on [N, K] weights) queued on one stream with no synchronise between
    them: each equals its own call run alone, bit for bit."""
    a = _int8_case(1, 4, 8192, 2048, False, cuda)
    b = _int8_case(2, 8, 2048, 8192, True, cuda)
    alone_a = int8_matmul(*a)
    torch.cuda.synchronize()
    alone_b = int8_matmul(*b, transpose_rhs=True)
    torch.cuda.synchronize()
    got = [(int8_matmul(*a), int8_matmul(*b, transpose_rhs=True))
           for _ in range(3)]
    torch.cuda.synchronize()
    for out_a, out_b in got:
        assert torch.equal(out_a, alone_a) and torch.equal(out_b, alone_b)


def test_int8_matmul_on_a_side_stream(cuda):
    """Calls on another stream, overlapping one on the default stream, give
    the default stream's bits."""
    x, w, scale = _int8_case(3, 4, 2048, 2048, False, cuda)
    want = int8_matmul(x, w, scale)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [int8_matmul(x, w, scale) for _ in range(4)]
    main = int8_matmul(x, w, scale)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in got + [main])


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


@pytest.mark.parametrize("b,s,h,d,mask,out_dtype", [
    (1, 200, 4, 64, None, torch.bfloat16),
    (1, 200, 4, 128, None, torch.bfloat16),
    (2, 136, 4, 128, "full", torch.bfloat16),            # a ragged tail
    (1, 300, 4, 128, ("window", 64), torch.bfloat16),
    (1, 70, 2, 32, ("window", 20), torch.bfloat16),      # d padded to 64
    (1, 100, 4, 96, None, torch.bfloat16),               # d padded to 128
    (2, 1024, 16, 128, None, torch.float32),             # the ring's block
    (2, 1024, 16, 128, "full", torch.float32),
])
def test_flash_dq_bf16_matches_plain(cuda, b, s, h, d, mask, out_dtype):
    """K3 on bf16 inputs (the query-block mma.sync sweep) against its plain
    version: causal, full and window masks, ragged tails, padded head
    dims, and the ring's block with f32 outputs."""
    g = torch.Generator().manual_seed(s * 3 + d)
    args = _bwd_inputs(g, b, s, h, d, torch.bfloat16, cuda, mask)
    kw = dict(scale=d ** -0.5, mask=mask, out_dtype=out_dtype)
    before = launches["flash_dq"]
    got = flash_dq(*args, **kw)
    torch.cuda.synchronize()
    assert launches["flash_dq"] == before + 1
    ref = flash_dq_ref(*args, **kw)
    assert got.dtype == ref.dtype == out_dtype
    ref = ref.float()
    diff = got.float() - ref
    assert diff.abs().max().item() <= 2e-2 * max(1.0, ref.abs().max().item())
    assert (diff.norm() / ref.norm()).item() <= 1e-2


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_flash_dq_bf16_is_deterministic(cuda, out_dtype):
    """K3 has no atomics and sums its key tiles in a fixed order: two calls
    give the same bits, and batch row 0 of a batch-2 call equals the same
    row run alone."""
    g = torch.Generator().manual_seed(23)
    args = _bwd_inputs(g, 2, 520, 16, 128, torch.bfloat16, cuda, None)
    kw = dict(scale=128 ** -0.5, out_dtype=out_dtype)
    dq = flash_dq(*args, **kw)
    assert torch.equal(dq, flash_dq(*args, **kw))
    dq1 = flash_dq(*(t[:1].contiguous() for t in args), **kw)
    assert torch.equal(dq1, dq[:1])


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


_SERVE_CFG = dict(vocab=512, d_model=256, n_heads=2, n_kv_heads=1,
                  d_ff=512, n_layers=2, dtype=torch.float32, attn="flash")


def _serve_params(dev, int8_weights):
    cfg = BurnInConfig(**_SERVE_CFG)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(5),
                         device=dev)
    if int8_weights:
        params = quantize_params(params, dtype=torch.float32)
    return cfg, params


def _filled_pool(cfg, dev, slots, max_len, bs, cache_dtype, seed):
    """A pool whose rows hold seeded values (int8 rows and scales in an
    int8 pool), slot i mapped to its own blocks, ragged positions."""
    nt = -(-(256 if cache_dtype == "int8" else max_len) // bs)
    pool = init_paged_cache(cfg, slots, max_len, block_size=bs,
                            num_blocks=2 + slots * nt,
                            cache_dtype=cache_dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for key in ("k", "v"):
        for buf in pool[key]:
            if buf.dtype == torch.int8:
                buf.copy_(torch.randint(-127, 128, buf.shape, generator=g,
                                        device=dev))
            else:
                buf.copy_(torch.randn(buf.shape, generator=g, device=dev))
    for key in ("k_scale", "v_scale"):
        for buf in pool.get(key, []):
            buf.copy_(torch.rand(buf.shape, generator=g, device=dev) / 64)
    for i in range(slots):
        pool["block_tables"][i] = torch.arange(1 + i * nt, 1 + (i + 1) * nt,
                                               dtype=torch.int32)
    pool["pos"].copy_(torch.tensor([5, 17, 30, 0][:slots]))
    return pool


@pytest.mark.parametrize("cache_dtype,int8_weights", [
    ("bf16", False), ("int8", True)], ids=["bf16", "int8"])
def test_wave_graph_replay_equals_eager_wave(cuda, cache_dtype,
                                             int8_weights):
    """The captured wave against the eager step on a copy of the pool: the
    same tokens every wave and the same pool bytes after, through a change
    of the active set and a table rewrite (lazy growth's) between replays;
    the launch tally the capture took is K7 (or K7-int8) once a layer and,
    with int8 weights, K8 once a weight product."""
    cfg, params = _serve_params(cuda, int8_weights)
    engine = make_serve_engine(params, cfg, max_len=64, kv_block=16,
                               cache_dtype=cache_dtype, device=cuda)
    pool = _filled_pool(cfg, cuda, 4, 64, 16, cache_dtype, seed=6)
    graph = engine.capture(pool)   # its warm-up writes the garbage block
    twin = {k: ([t.clone() for t in v] if isinstance(v, list)
                else v.clone()) for k, v in pool.items()}
    k7 = "paged_decode_int8" if cache_dtype == "int8" else "paged_decode"
    want = {k7: cfg.n_layers}
    if int8_weights:
        want["int8_matmul"] = 6 * cfg.n_layers + 1
    assert graph.launches == want
    toks = torch.tensor([3, 77, 501, 9], device=cuda)
    active = torch.tensor([True, True, False, True], device=cuda)
    graph.tokens.copy_(toks)
    graph.active.copy_(active)
    before = dict(launches)
    for wave in range(6):
        if wave == 2:                        # the active set changes
            active = torch.tensor([False, True, True, True], device=cuda)
            graph.active.copy_(active)
        if wave == 4:                        # a table entry is rewritten
            for p in (pool, twin):
                p["block_tables"][1, 2] = p["block_tables"].shape[1] * 4 + 1
        graph.replay()
        toks = engine.step(toks, active, twin)
        assert torch.equal(graph.tokens, toks), wave
    torch.cuda.synchronize()
    for name, n in want.items():        # six replays and six eager steps
        assert launches[name] - before[name] == 2 * 6 * n, name
    for key, val in pool.items():
        for a, b in zip(val if isinstance(val, list) else [val],
                        twin[key] if isinstance(val, list) else [twin[key]]):
            assert torch.equal(a, b), key


def test_engine_keeps_its_graph_across_runs(cuda):
    """One capture per (slots, kv_blocks): a second run resets the pool in
    place and replays the same graph, with the same tokens; lazy growth on a
    tight pool rewrites tables between replays and still equals solo
    decode."""
    cfg, params = _serve_params(cuda, False)
    g = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, cfg.vocab, (8 * (1 + i % 3),), generator=g)
               for i in range(5)]
    engine = make_serve_engine(params, cfg, max_len=48, kv_block=16,
                               device=cuda)
    first = engine(prompts, 12, slots=2)
    assert engine.captures == 1
    second = engine(prompts, 12, slots=2)
    assert engine.captures == 1
    for a, b, p in zip(first, second, prompts):
        solo = greedy_decode(params, p[None], 12, cfg, device=cuda)[0]
        assert torch.equal(a, b) and torch.equal(a, solo)
    engine(prompts[:1], 2, slots=3)
    assert engine.captures == 2
    lazy = make_serve_engine(params, cfg, max_len=48, kv_block=16,
                             lazy_growth=True, device=cuda)
    got = lazy(prompts, 12, slots=2, kv_blocks=1 + 3 + 1)
    st = lazy.last_stats
    assert st["kv"]["blocks_grown_lazy"] > 0 and st["kv"]["in_use"] == 0
    for a, b in zip(got, first):
        assert torch.equal(a, b)


def test_levers_on_card_match_solo(cuda):
    """Sharing, chunked prefill, sjf and lazy growth in one engine on the
    card: each request's tokens equal its solo decode with the dense
    prefill (what chunked prefill computes)."""
    cfg, params = _serve_params(cuda, False)
    g = torch.Generator().manual_seed(9)
    tmpl = torch.randint(0, cfg.vocab, (40,), generator=g)
    prompts = [torch.cat([tmpl, torch.randint(0, cfg.vocab, (3 + 5 * i,),
                                              generator=g)])
               for i in range(5)]
    budgets = [6, 9, 4, 8, 5]
    engine = make_serve_engine(params, cfg, max_len=96, kv_block=16,
                               share_prefix=True, prefill_chunk=16,
                               policy="sjf", lazy_growth=True, device=cuda)
    got = engine(prompts, budgets, slots=3, kv_blocks=12)
    st = engine.last_stats
    assert st["prefix"]["hit_blocks"] > 0 and st["kv"]["in_use"] == 0
    for p, n, a in zip(prompts, budgets, got):
        solo = greedy_decode(params, p[None], n, cfg, prefill="dense",
                             device=cuda)[0]
        assert torch.equal(a, solo)


# ------------------------------------------------ D1 and sampled serving

@pytest.mark.parametrize("rows,v,offset", [(4, 8192, 0), (8, 8192, 0),
                                           (1, 8192, 3 * 2**32 - 5),
                                           (3, 1000, 7)])
def test_sample_draw_matches_plain(cuda, rows, v, offset):
    """D1 against the plain draw, tokens and every Gumbel score bit for
    bit (libdevice's logf on both sides), with -inf entries, a row of
    -inf only (index 0) and an exact tie of +inf logits (the lower index),
    one shared key or a key a row, with and without the (request,
    position) fold, counts past 2^32."""
    from nvidia_terraform_modules_tpu_torch.ops import sampling

    g = torch.Generator(device=cuda).manual_seed(rows + v)
    lg = torch.randn((rows, v), generator=g, device=cuda) * 3
    lg[:, 5:50] = -torch.inf
    lg[0, 100] = lg[0, 300] = torch.inf
    if rows > 1:
        lg[1] = -torch.inf
    offs = torch.arange(rows, device=cuda, dtype=torch.int64) * v + offset
    keys = torch.tensor([[7, 1000 + i] for i in range(rows)], device=cuda)
    fold = torch.stack([torch.arange(rows), torch.arange(rows) + 9],
                       1).to(cuda)
    before = launches["sample_draw"]
    for k, f in ((keys, None), (keys[0].contiguous(), fold)):
        tok, sc = sampling.draw_scores(lg, k, offs, f)
        ref, ref_sc = sampling.draw_ref(lg, k, offs, f, scores=True)
        assert torch.equal(tok, ref)
        assert torch.equal(sc, ref_sc)
        assert tok[0] == 100
        if rows > 1:
            assert tok[1] == 0
        assert torch.equal(sampling.draw(lg, k, offs, f), ref)
    assert launches["sample_draw"] - before == 4


def test_sample_draw_refuses_what_it_cannot_take(cuda):
    from nvidia_terraform_modules_tpu_torch.ops import sampling

    lg = torch.zeros((2, 8), device=cuda)
    key = torch.zeros((2,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sampling.draw(lg, key.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        sampling.draw(lg.t().contiguous().t(), key)
    with pytest.raises(ValueError, match="f32"):
        sampling.draw(lg.half(), key)


@pytest.mark.parametrize("cache_dtype,int8_weights", [
    ("bf16", False), ("int8", True)], ids=["bf16", "int8"])
def test_sampled_wave_replay_equals_eager_wave(cuda, cache_dtype,
                                               int8_weights):
    """The captured sampled wave against the eager sampled step on a copy
    of the pool: the same tokens every wave, the same (request, position)
    rows (the graph advances active slots' positions itself), the same
    pool bytes; the capture's tally is D1 once and K7 once a layer."""
    from nvidia_terraform_modules_tpu_torch.models import make_sampler

    cfg, params = _serve_params(cuda, int8_weights)
    engine = make_serve_engine(params, cfg, max_len=64, kv_block=16,
                               cache_dtype=cache_dtype, device=cuda,
                               sampler=make_sampler(temperature=0.8,
                                                    top_p=0.95))
    pool = _filled_pool(cfg, cuda, 4, 64, 16, cache_dtype, seed=6)
    graph = engine.capture(pool)
    twin = {k: ([t.clone() for t in v] if isinstance(v, list)
                else v.clone()) for k, v in pool.items()}
    k7 = "paged_decode_int8" if cache_dtype == "int8" else "paged_decode"
    want = {k7: cfg.n_layers, "sample_draw": 1}
    if int8_weights:
        want["int8_matmul"] = 6 * cfg.n_layers + 1
    assert graph.launches == want
    toks = torch.tensor([3, 77, 501, 9], device=cuda)
    active = torch.tensor([True, True, False, True], device=cuda)
    fold = torch.tensor([[0, 1], [1, 4], [5, 0], [2, 2]], device=cuda)
    key = torch.tensor([0, 42], device=cuda)
    graph.tokens.copy_(toks)
    graph.active.copy_(active)
    graph.fold.copy_(fold)
    graph.key.copy_(key)
    for wave in range(6):
        if wave == 3:
            active = torch.tensor([False, True, True, True], device=cuda)
            graph.active.copy_(active)
            fold[2] = torch.tensor([3, 1])
            graph.fold[2] = torch.tensor([3, 1])
        graph.replay()
        toks = engine.step(toks, active, fold, key, twin)
        assert torch.equal(graph.tokens, toks), wave
        assert torch.equal(graph.fold, fold), wave
    for k_, val in pool.items():
        for a, b in zip(val if isinstance(val, list) else [val],
                        twin[k_] if isinstance(val, list) else [twin[k_]]):
            assert torch.equal(a, b), k_


def test_sampled_engine_on_card_is_schedule_invariant(cuda):
    """On the card: a top-k = 1 sampler is the greedy engine; at
    temperature 5 slots 1 and 3 give the same tokens, and a second run
    captures nothing new; lazy growth with a preemption on a tight pool
    gives the ample pool's tokens."""
    from nvidia_terraform_modules_tpu_torch.models import make_sampler

    cfg, params = _serve_params(cuda, False)
    g = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, cfg.vocab, (8 * (1 + i % 3),), generator=g)
               for i in range(5)]
    greedy = make_serve_engine(params, cfg, max_len=48, kv_block=16,
                               device=cuda)(prompts, 10, slots=2)
    k1 = make_serve_engine(params, cfg, max_len=48, kv_block=16, device=cuda,
                           sampler=make_sampler(top_k=1))
    for a, b in zip(k1(prompts, 10, slots=2, rng=3), greedy):
        assert torch.equal(a, b)
    hot = make_serve_engine(params, cfg, max_len=48, kv_block=16,
                            device=cuda, sampler={"temperature": 5.0})
    one = hot(prompts, 10, slots=1, rng=3)
    three = hot(prompts, 10, slots=3, rng=3)
    captures = hot.captures
    again = hot(prompts, 10, slots=3, rng=3)
    assert hot.captures == captures == 2
    for a, b, c in zip(one, three, again):
        assert torch.equal(a, b) and torch.equal(b, c)
    # five 15-token prompts take a block each and all cross into a second
    # at the same wave: a pool of four blocks stalls them all
    short = [torch.randint(0, cfg.vocab, (15,), generator=g)
             for _ in range(5)]
    ample = hot(short, 8, slots=4, rng=3)
    lazy = make_serve_engine(params, cfg, max_len=48, kv_block=16,
                             device=cuda, sampler={"temperature": 5.0},
                             lazy_growth=True)
    got = lazy(short, 8, slots=4, rng=3, kv_blocks=1 + 4)
    assert lazy.last_stats["sched"]["preempted"] > 0
    for a, b in zip(got, ample):
        assert torch.equal(a, b)


def test_spec_trip_replay_equals_eager_trip(cuda):
    """The captured speculative trip against the eager trip on copies of
    the pool and the state: the same context, counts and report after
    every trip of a multi-step, the same pool bytes outside the garbage
    block; the tally holds no K7 (T = k + 1 reads through the gather
    path)."""
    cfg, params = _serve_params(cuda, False)
    engine = make_serve_engine(params, cfg, max_len=64, kv_block=16,
                               spec_k=4, device=cuda)
    pool = _filled_pool(cfg, cuda, 4, 64, 16, "bf16", seed=7)
    graph = engine.capture(pool)
    assert "paged_decode" not in graph.launches
    twin_pool = {k: ([t.clone() for t in v] if isinstance(v, list)
                     else v.clone()) for k, v in pool.items()}
    eager = engine.capture(twin_pool, on_card=False)
    g = torch.Generator(device=cuda).manual_seed(3)
    for st in (graph.state, eager.state):
        st.ctx.copy_(torch.randint(0, 8, st.ctx.shape, generator=g,
                                   device=cuda))
        st.cur.copy_(pool["pos"].long() + 1)
        st.n_out.fill_(1)
        st.n_new.copy_(torch.tensor([12, 20, 6, 9], device=cuda))
        st.active.copy_(torch.tensor([True, True, False, True],
                                     device=cuda))
        st.granted.fill_(64)
        st.eos.fill_(-1)
        st.stop.fill_(2)
        g.manual_seed(3)
    for trip in range(12):
        graph.replay()
        eager.replay()
        for a, b in ((graph.state.ctx, eager.state.ctx),
                     (graph.state.report, eager.state.report)):
            assert torch.equal(a, b), trip
    # every block but the garbage block 0, where the frozen slots' k + 1
    # rows land on the same few rows, in an order the scatter does not fix
    for k_, val in pool.items():
        for a, b in zip(val if isinstance(val, list) else [val],
                        twin_pool[k_] if isinstance(val, list)
                        else [twin_pool[k_]]):
            if k_ in ("k", "v", "k_scale", "v_scale"):
                a, b = a[1:], b[1:]
            assert torch.equal(a, b), k_


def test_spec_engine_on_card_matches_greedy(cuda):
    """The speculative engine on the card (every trip a replay): solo
    greedy decode's tokens, decode steps below the tokens on periodic
    prompts; with int8 weights the verification runs K8 at M = slots x
    (k + 1) and equals the gather-path greedy engine (whose rows K8 makes
    at M = slots, bit for bit the same rows)."""
    cfg, params = _serve_params(cuda, False)
    prompts = [torch.tensor(([3, 7, 11, 5] * 8)[:20 + i]) for i in range(4)]
    eng = make_serve_engine(params, cfg, max_len=64, kv_block=16, spec_k=4,
                            device=cuda)
    for a, p in zip(eng(prompts, 16, slots=2), prompts):
        assert torch.equal(a, greedy_decode(params, p[None], 16, cfg,
                                            device=cuda)[0])
    st = eng.last_stats
    assert st["slot_steps"] < st["generated"] - len(prompts)
    assert eng.captures == 1
    _, qparams = _serve_params(cuda, True)
    q = make_serve_engine(qparams, cfg, max_len=64, kv_block=16, spec_k=4,
                          device=cuda)
    qgreedy = make_serve_engine(qparams, cfg, max_len=64, kv_block=16,
                                paged_kernel="off", device=cuda)(
        prompts, 16, slots=2)
    before = launches["int8_matmul"]
    got = q(prompts, 16, slots=2)
    assert launches["int8_matmul"] > before
    for a, b in zip(got, qgreedy):
        assert torch.equal(a, b)


def _decode_prompt(cfg, dev, b=3, t=24, seed=9):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, t), generator=g).to(dev)


@pytest.mark.parametrize("cache_dtype,int8_weights", [
    ("bf16", False), ("int8", False), ("bf16", True), ("int8", True)],
    ids=["bf16", "int8_cache", "int8_weights", "int8_both"])
def test_decoder_replay_equals_eager_loop(cuda, cache_dtype, int8_weights):
    """One call = the eager prefill (K1) and one replay of the captured
    steps: tokens equal ``greedy_decode``'s eager loop bit for bit, on the
    first call (the capture) and the next (a replay of the same graph); the
    capture's tally is ``n_new - 1`` times one step's K6 (int8 cache) and
    K8 (int8 weights) launches, and a call adds the prefill's and that."""
    cfg, params = _serve_params(cuda, int8_weights)
    prompt = _decode_prompt(cfg, cuda)           # M = 72: no K8 in prefill
    n_new = 10
    want = greedy_decode(params, prompt, n_new, cfg, cache_dtype=cache_dtype,
                         device=cuda)
    dec = make_decoder(cfg, n_new=n_new, cache_dtype=cache_dtype,
                       device=cuda)
    assert torch.equal(dec(params, prompt), want)
    (graph,) = dec.graphs.values()
    step = {}
    if cache_dtype == "int8":
        step["kv_decode"] = cfg.n_layers
    if int8_weights:
        step["int8_matmul"] = 6 * cfg.n_layers + 1
    assert graph.launches == {k: (n_new - 1) * n for k, n in step.items()}
    before = dict(launches)
    got = dec(params, prompt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert list(dec.graphs.values()) == [graph]          # no new capture
    delta = {k: launches[k] - before.get(k, 0) for k in launches
             if launches[k] != before.get(k, 0)}
    assert delta == {"flash_fwd": cfg.n_layers, **graph.launches}


def test_decoder_captures_anew_for_another_params_tree(cuda):
    """A different tree (another output norm; the int8 tree of
    ``quantize_params``) selects its own capture, never the stale graph;
    back to the first tree, its tokens again. ``n_new == 1`` captures
    nothing."""
    cfg, params_a = _serve_params(cuda, False)
    params_b = {**params_a, "out_norm": -params_a["out_norm"]}
    qparams = quantize_params(params_a, dtype=torch.float32)
    prompt = _decode_prompt(cfg, cuda, seed=10)
    dec = make_decoder(cfg, n_new=8, cache_dtype="int8", device=cuda)
    want = {name: greedy_decode(p, prompt, 8, cfg, cache_dtype="int8",
                                device=cuda)
            for name, p in (("a", params_a), ("b", params_b),
                            ("q", qparams))}
    assert not torch.equal(want["a"], want["b"])
    graphs = []
    for name, p in (("a", params_a), ("b", params_b), ("q", qparams),
                    ("a", params_a)):
        assert torch.equal(dec(p, prompt), want[name]), name
        (graph,) = dec.graphs.values()
        assert graph not in graphs
        graphs.append(graph)
    one = make_decoder(cfg, n_new=1, device=cuda)
    assert torch.equal(one(params_a, prompt),
                       greedy_decode(params_a, prompt, 1, cfg, device=cuda))
    assert one.graphs == {}


@pytest.mark.parametrize("fused", [True, False])
def test_quantized_decoder_replays_its_graph(cuda, fused):
    cfg, params = _serve_params(cuda, False)
    qparams = quantize_params(params, dtype=torch.float32)
    prompt = _decode_prompt(cfg, cuda, seed=11)
    dec = make_quantized_decoder(cfg, n_new=8, dtype=torch.float32,
                                 fused=fused, cache_dtype="int8",
                                 device=cuda)
    want = greedy_decode(qparams, prompt, 8, cfg, cache_dtype="int8",
                         device=cuda)
    for _ in range(2):
        assert torch.equal(dec(qparams, prompt), want)


def test_decoder_capture_failure_raises(cuda, monkeypatch):
    """A capture that fails raises; nothing runs the eager loop instead."""
    cfg, params = _serve_params(cuda, False)

    def broken(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(torch.cuda, "graph", broken)
    dec = make_decoder(cfg, n_new=4, device=cuda)
    with pytest.raises(RuntimeError, match="capture refused"):
        dec(params, _decode_prompt(cfg, cuda))
    assert dec.graphs == {}


def test_engine_telemetry_adds_no_synchronise(cuda):
    """The flagship-shaped traffic with and without a telemetry registry:
    the same tokens, and no stream synchronisation that PyTorch's sync
    debug mode reports is raised from inside the telemetry hooks
    (``serving._ServeTelemetry``: each warning's Python stack is read as
    it is raised)."""
    import inspect
    import warnings

    from nvidia_terraform_modules_tpu_torch.models.serving import (
        _ServeTelemetry,
    )
    from nvidia_terraform_modules_tpu_torch.telemetry import Registry

    cfg, params = _serve_params(cuda, False)
    g = torch.Generator().manual_seed(12)
    prompts = [torch.randint(0, cfg.vocab, (8 * (1 + i % 3),), generator=g)
               for i in range(5)]
    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        syncs.append(any(isinstance(f.frame.f_locals.get("self"),
                                    _ServeTelemetry)
                         for f in inspect.stack(0)))

    runs = []
    for reg in (None, Registry()):
        engine = make_serve_engine(params, cfg, max_len=48, kv_block=16,
                                   telemetry=reg, device=cuda)
        engine(prompts, 4, slots=2)                  # capture, warm
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.ones(1, device=cuda).item()    # the hook sees syncs
                runs.append(engine(prompts, 12, slots=2))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert syncs and not any(syncs), \
        f"{sum(syncs)} synchronisations from telemetry"
    # the warm-up run and the measured one
    assert reg.counter("serve_generated_tokens").value == \
        (4 + 12) * len(prompts)
    assert reg.histogram("serve_request_ms").count == 2 * len(prompts)


# ------------------------------------------------------------------- MoE

def _moe_params(dev, int8_weights, top_k=1, dtype=torch.float32):
    """``_SERVE_CFG`` with 4 experts at ``capacity_factor=4.0`` (where the
    factor's capacity drops nothing), its seeded params (int8 weights:
    attention and head; the router and the expert stacks stay dense)."""
    cfg = BurnInConfig(**{**_SERVE_CFG, "dtype": dtype}, n_experts=4,
                       router_top_k=top_k, capacity_factor=4.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(13),
                         device=dev)
    if int8_weights:
        params = quantize_params(params, dtype=dtype)
    return cfg, params


@pytest.mark.parametrize("cache_dtype,int8_weights,top_k", [
    ("bf16", False, 1), ("int8", True, 2)], ids=["bf16-top1", "int8-top2"])
def test_moe_wave_replay_equals_eager_wave(cuda, cache_dtype, int8_weights,
                                           top_k):
    """The routed wave replayed from its captured graph against the eager
    step on a copy of the pool: the same tokens every wave and the same
    pool bytes after, a slot going idle between replays; the capture holds
    K7 (or K7-int8) once a layer and, with int8 weights, K8 for the four
    attention products a layer and the head (the experts stay dense)."""
    cfg, params = _moe_params(cuda, int8_weights, top_k)
    engine = make_serve_engine(params, cfg, max_len=64, kv_block=16,
                               cache_dtype=cache_dtype, device=cuda)
    pool = _filled_pool(cfg, cuda, 4, 64, 16, cache_dtype, seed=14)
    graph = engine.capture(pool)
    twin = {k: ([t.clone() for t in v] if isinstance(v, list)
                else v.clone()) for k, v in pool.items()}
    k7 = "paged_decode_int8" if cache_dtype == "int8" else "paged_decode"
    want = {k7: cfg.n_layers}
    if int8_weights:
        want["int8_matmul"] = 4 * cfg.n_layers + 1
    assert graph.launches == want
    toks = torch.tensor([3, 77, 501, 9], device=cuda)
    active = torch.tensor([True, True, True, True], device=cuda)
    graph.tokens.copy_(toks)
    graph.active.copy_(active)
    for wave in range(5):
        if wave == 2:
            active = torch.tensor([True, False, True, True], device=cuda)
            graph.active.copy_(active)
        graph.replay()
        toks = engine.step(toks, active, twin)
        assert torch.equal(graph.tokens, toks), wave
    torch.cuda.synchronize()
    for key, val in pool.items():
        for a, b in zip(val if isinstance(val, list) else [val],
                        twin[key] if isinstance(val, list) else [twin[key]]):
            assert torch.equal(a, b), key


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_router_stays_f32_and_tf32_free_under_capture(cuda, top_k):
    """bf16 MoE: the router is f32 in ``init_params`` and
    ``quantize_params``; with TF32 allowed for the process, ``moe_layer``
    eager and replayed from a captured graph gives the bits it gives with
    TF32 off (the bf16 expert products ignore the flag; a TF32 router
    product would move the gates and so every output)."""
    from nvidia_terraform_modules_tpu_torch.models import moe_layer

    cfg, params = _moe_params(cuda, False, top_k, torch.bfloat16)
    assert params["layers"][0]["moe"]["router"].dtype == torch.float32
    qtree = quantize_params(params)
    assert qtree["layers"][0]["moe"]["router"].dtype == torch.float32
    moe = params["layers"][0]["moe"]
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn((4, 1, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    want, want_aux = moe_layer(x, moe, cfg, capacity=8)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        eager, _ = moe_layer(x, moe, cfg, capacity=8)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            moe_layer(x, moe, cfg, capacity=8)           # warm-up
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out, aux = moe_layer(x, moe, cfg, capacity=8)
        graph.replay()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(eager, want)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("cache_dtype,int8_weights", [
    ("bf16", False), ("int8", True)], ids=["bf16", "int8_both"])
def test_moe_decoder_replay_equals_eager_loop(cuda, cache_dtype,
                                              int8_weights):
    """``make_decoder`` over an MoE tree: the replayed steps give the eager
    loop's tokens bit for bit, on the capturing call and a replay; the
    capture's tally is ``n_new - 1`` steps of K6 (int8 cache) and K8 (the
    attention products and the head)."""
    cfg, params = _moe_params(cuda, int8_weights)
    prompt = _decode_prompt(cfg, cuda)
    n_new = 10
    want = greedy_decode(params, prompt, n_new, cfg, cache_dtype=cache_dtype,
                         device=cuda)
    dec = make_decoder(cfg, n_new=n_new, cache_dtype=cache_dtype,
                       device=cuda)
    got = [dec(params, prompt) for _ in range(2)]
    (graph,) = dec.graphs.values()
    step = {}
    if cache_dtype == "int8":
        step["kv_decode"] = cfg.n_layers
    if int8_weights:
        step["int8_matmul"] = 4 * cfg.n_layers + 1
    assert graph.launches == {k: (n_new - 1) * n for k, n in step.items()}
    assert all(torch.equal(g, want) for g in got)


def test_moe_engine_on_card_matches_solo_and_full_forward(cuda):
    """More slots than requests, a 150-token prompt among them (its
    admission routes in two chunks): every request's tokens equal its solo
    greedy decode and the argmax of one full ``forward`` over the prompt
    and its generated tokens (the factor capacity drops nothing here)."""
    from nvidia_terraform_modules_tpu_torch.models import forward

    cfg, params = _moe_params(cuda, False, 2)
    g = torch.Generator().manual_seed(16)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g)
               for n in (24, 150, 8)]
    engine = make_serve_engine(params, cfg, max_len=176, kv_block=16,
                               device=cuda)
    got = engine(prompts, 8, slots=6)
    for p, toks in zip(prompts, got):
        solo = greedy_decode(params, p[None].to(cuda), 8, cfg,
                             device=cuda)[0]
        assert torch.equal(toks, solo)
        seq = torch.cat([p.to(cuda), toks[:-1]])[None]
        full = forward(params, seq, cfg)[0, p.shape[0] - 1:].argmax(-1)
        assert torch.equal(full, toks)
