# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, paged decode attention: the plain version (the gather +
masked softmax the wrapper runs on a CPU tensor) against the JAX
reference's Pallas paged kernel in interpret mode — MHA and GQA, ragged
positions, dead table entries pointing at a POISONED garbage block and at
blocks recycled to another row.

Tolerance: f32 1e-5 (online vs one-pass softmax); bf16 1e-2 (the kernel
rounds unnormalised per-tile P to bf16, the plain version the normalised
row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.ops.decode_attention import (
    paged_decode_attention as jax_paged,
)
from nvidia_terraform_modules_tpu_torch.ops import (
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
    q, kp, vp, tables, pos = (torch.from_numpy(x) for x in
                              _case(2, 4, 2, 8, 4, 3, seed=1))
    got = paged_decode_attention(q, kp, vp, tables, pos, scale=0.3)
    assert torch.equal(got, paged_decode_attention_ref(q, kp, vp, tables,
                                                       pos, scale=0.3))
    scales = torch.ones(kp.shape[:3])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_decode_attention(q, kp, vp, tables, pos, scale=0.3,
                               k_scale=scales, v_scale=scales)
    with pytest.raises(ValueError, match="multiple"):
        paged_decode_attention(q[:, :3], kp, vp, tables, pos, scale=0.3)
