# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, decode attention: the plain versions (what the wrappers
run on a CPU tensor) against the JAX reference's Pallas kernels in
interpret mode — the paged kernel (K7, and K7-int8 with scale sidecars
riding the tables) through dead table entries pointing at a POISONED
garbage block and at blocks recycled to another row, and the contiguous
kernel (K6, int8 and plain) — MHA and GQA, ragged positions.

Tolerance: f32 1e-5 (online vs one-pass softmax); bf16 1e-2 (the kernel
rounds unnormalised per-tile P to bf16, the plain version the normalised
row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models.decode import (
    quantize_kv as jax_quantize_kv,
)
from nvidia_terraform_modules_tpu.ops.decode_attention import (
    kv_decode_attention as jax_kv_decode,
)
from nvidia_terraform_modules_tpu.ops.decode_attention import (
    paged_decode_attention as jax_paged,
)
from nvidia_terraform_modules_tpu_torch.models import quantize_kv
from nvidia_terraform_modules_tpu_torch.ops import (
    int8_kv_decode_attention,
    kv_decode_attention,
    kv_decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
)


def _case(b, h, kv, d, bs, nt, seed):
    rng = np.random.default_rng(seed)
    nb = 1 + b * nt
    k_pool = rng.normal(size=(nb, bs, kv, d)).astype(np.float32)
    v_pool = rng.normal(size=(nb, bs, kv, d)).astype(np.float32)
    k_pool[0] = 1e4                    # garbage block: a read would show
    v_pool[0] = -1e4
    tables = (rng.permutation(nb - 1) + 1).reshape(b, nt).astype(np.int32)
    pos = rng.integers(0, nt * bs, size=(b,)).astype(np.int32)
    pos[0] = 0                         # a row that sees one key only
    for i in range(b):
        dead = int(pos[i]) // bs + 1
        tables[i, dead:] = 0           # dead entries → the garbage block
        if i and dead < nt:
            tables[i, dead] = tables[0, 0]   # a block another row owns
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    return q, k_pool, v_pool, tables, pos


@pytest.mark.parametrize("b,h,kv,d,bs,nt", [
    (3, 4, 4, 16, 4, 5),               # MHA
    (3, 8, 2, 16, 8, 3),               # GQA, rep 4
    (2, 4, 1, 32, 3, 7),               # MQA, odd block size
])
def test_plain_paged_decode_matches_reference_kernel(b, h, kv, d, bs, nt):
    q, kp, vp, tables, pos = _case(b, h, kv, d, bs, nt, seed=b * 10 + bs)
    scale = d ** -0.5
    want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(pos), scale=scale,
                                interpret=True))
    got = paged_decode_attention(*(torch.from_numpy(x) for x in
                                   (q, kp, vp, tables, pos)), scale=scale)
    assert np.abs(got.numpy()).max() < 10     # no garbage leaked in
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_plain_paged_decode_matches_reference_kernel_bf16():
    q, kp, vp, tables, pos = _case(2, 8, 2, 32, 8, 4, seed=5)
    kp[0] = vp[0] = 0.0        # 1e4 is not a bf16-sized poison: zero it
    scale = 32 ** -0.5
    want = np.asarray(jax_paged(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables),
        jnp.asarray(pos), scale=scale, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in (q, kp, vp))
    got = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                 torch.from_numpy(pos), scale=scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version_and_int8_is_refused():
    """On a CPU tensor each wrapper is its plain version — for the bf16/f32
    pool and, since the int8 variant was ported, for the int8 pool with its
    sidecars, which is no longer refused; what IS refused is a half-given
    pair of scales, scales on a float pool, and a bad GQA split."""
    q, kp, vp, tables, pos = (torch.from_numpy(x) for x in
                              _case(2, 4, 2, 8, 4, 3, seed=1))
    got = paged_decode_attention(q, kp, vp, tables, pos, scale=0.3)
    assert torch.equal(got, paged_decode_attention_ref(q, kp, vp, tables,
                                                       pos, scale=0.3))
    (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
    got = paged_decode_attention(q, k8, v8, tables, pos, scale=0.3,
                                 k_scale=ks, v_scale=vs)
    assert torch.equal(got, paged_decode_attention_ref(
        q, k8, v8, tables, pos, scale=0.3, k_scale=ks, v_scale=vs))
    assert got.dtype == q.dtype and got.abs().max() < 10
    with pytest.raises(ValueError, match="together"):
        paged_decode_attention(q, k8, v8, tables, pos, scale=0.3, k_scale=ks)
    with pytest.raises(ValueError, match="int8"):
        paged_decode_attention(q, kp, vp, tables, pos, scale=0.3,
                               k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="multiple"):
        paged_decode_attention(q[:, :3], kp, vp, tables, pos, scale=0.3)


def _contiguous(b, h, kv, d, s, seed, quant):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    pos = rng.integers(0, s, size=(b,)).astype(np.int32)
    pos[0] = 0
    if not quant:
        for i in range(b):                # rows past pos: poison
            k[i, pos[i] + 1:] = 1e4
            v[i, pos[i] + 1:] = -1e4
        return q, k, v, None, None, pos
    (k, ks), (v, vs) = (jax_quantize_kv(jnp.asarray(x)) for x in (k, v))
    k, ks, v, vs = (np.array(x) for x in (k, ks, v, vs))
    for i in range(b):
        k[i, pos[i] + 1:] = 127
        ks[i, pos[i] + 1:] = 1e4
        vs[i, pos[i] + 1:] = 1e4
    return q, k, v, ks, vs, pos


@pytest.mark.parametrize("b,h,kv,d,s,quant", [
    (3, 8, 2, 16, 48, True),           # GQA (8, 2), int8 + scales
    (2, 4, 4, 32, 64, True),           # MHA int8
    (3, 8, 2, 16, 48, False),          # GQA, f32 cache
    (2, 4, 1, 32, 40, False),          # MQA
])
def test_plain_kv_decode_matches_reference_kernel(b, h, kv, d, s, quant):
    q, k, v, ks, vs, pos = _contiguous(b, h, kv, d, s, seed=s + h,
                                       quant=quant)
    scale = d ** -0.5
    jkw = ({} if not quant else
           {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)})
    want = np.asarray(jax_kv_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos),
                                    scale=scale, block_s=8, interpret=True,
                                    **jkw))
    tkw = ({} if not quant else
           {"k_scale": torch.from_numpy(ks), "v_scale": torch.from_numpy(vs)})
    tq, tk, tv, tpos = (torch.from_numpy(x) for x in (q, k, v, pos))
    got = kv_decode_attention(tq, tk, tv, tpos, scale=scale, **tkw)
    assert torch.equal(got, kv_decode_attention_ref(tq, tk, tv, tpos,
                                                    scale=scale, **tkw))
    if quant:
        assert torch.equal(got, int8_kv_decode_attention(
            tq, tk, tkw["k_scale"], tv, tkw["v_scale"], tpos, scale=scale))
    assert np.abs(got.numpy()).max() < 10       # no poisoned row leaked
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_plain_paged_int8_decode_matches_reference_kernel():
    """The int8 pool: sidecars gathered with the same tables, through dead
    entries at the garbage block (rows 127, scales 1e4) and recycled
    blocks, against the reference's paged kernel with k_scale/v_scale."""
    q, kp, vp, tables, pos = _case(3, 8, 2, 16, 8, 3, seed=11)
    (k8, ks), (v8, vs) = (jax_quantize_kv(jnp.asarray(x)) for x in (kp, vp))
    k8, ks, v8, vs = (np.array(x) for x in (k8, ks, v8, vs))
    k8[0] = v8[0] = 127
    ks[0] = vs[0] = 1e4
    scale = 16 ** -0.5
    want = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(tables), jnp.asarray(pos), scale=scale,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True))
    got = paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, k8, v8, tables, pos)),
        scale=scale, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    assert np.abs(got.numpy()).max() < 10
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
