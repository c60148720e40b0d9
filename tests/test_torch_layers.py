# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, layer primitives against the JAX reference on the CPU.

The same numpy inputs (seeded) go through the reference function and its
port. f32 comparisons hold at 1e-6 (the same formula, summation order
aside); bf16 ones at one bf16 ulp of the output magnitude, since the two
frameworks round the f32 intermediates at the same points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.utils import layers as jlayers
from nvidia_terraform_modules_tpu.utils import traffic as jtraffic
from nvidia_terraform_modules_tpu_torch.models import burnin as tburnin
from nvidia_terraform_modules_tpu_torch.utils import layers as tlayers
from nvidia_terraform_modules_tpu_torch.utils import traffic as ttraffic


def _both(x, jdtype, tdtype):
    return jnp.asarray(x, jdtype), torch.from_numpy(x).to(tdtype)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3
    s = rng.normal(size=(32,)).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jx, tx = _both(x, jd, td)
    js, ts = _both(s, jd, td)
    want = np.asarray(jlayers.rmsnorm(jx, js).astype(jnp.float32))
    got = _np(tlayers.rmsnorm(tx, ts))
    assert tlayers.rmsnorm(tx, ts).dtype == td
    tol = 1e-6 if dtype == "f32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("theta", [10000.0, 500.0])
def test_apply_rope_matches_reference(per_row, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 3, 8)).astype(np.float32)
    pos = (rng.integers(0, 40, size=(2, 6)) if per_row
           else np.arange(3, 9)).astype(np.int32)
    want = np.asarray(jburnin.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta))
    got = tburnin.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_mlp_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the TANH approximation (the reference MLP,
    models/decode.py:331), so the port must use approximate="tanh": its
    MLP matches the reference formula, and the erf form would not."""
    rng = np.random.default_rng(2)
    h = rng.normal(size=(4, 16)).astype(np.float32)
    up = rng.normal(size=(16, 24)).astype(np.float32)
    down = rng.normal(size=(24, 16)).astype(np.float32)
    want = np.asarray(
        jax.nn.gelu((jnp.asarray(h) @ jnp.asarray(up)).astype(jnp.float32))
        @ jnp.asarray(down))
    layer = {"up": torch.from_numpy(up), "down": torch.from_numpy(down)}
    got = tburnin.mlp(torch.from_numpy(h), layer, torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    z = torch.from_numpy(h @ up)
    erf_gap = (F.gelu(z) - F.gelu(z, approximate="tanh")).abs().max()
    assert erf_gap > 1e-4       # the two forms are distinguishable here


def test_dense_init_scale_dtype_and_seed():
    g = torch.Generator().manual_seed(7)
    w = tlayers.dense_init(g, (256, 64), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 64)
    assert abs(w.float().std().item() - 0.02) < 2e-3
    again = tlayers.dense_init(torch.Generator().manual_seed(7), (256, 64),
                               torch.bfloat16)
    assert torch.equal(w, again)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_traffic_copies_draw_the_reference_traces(seed):
    assert ttraffic.poisson_trace(4.0, 12, seed) == \
        jtraffic.poisson_trace(4.0, 12, seed)
    for kw in ({}, {"lo": 128, "hi": 512}, {"lo": 2, "hi": 9, "mean": 3.5}):
        assert ttraffic.ragged_lengths(10, seed, **kw) == \
            jtraffic.ragged_lengths(10, seed, **kw)


def test_config_validation_matches_reference():
    for kw in ({"n_heads": 4, "n_kv_heads": 3},
               {"attn": "bogus"},
               {"d_model": 36, "n_heads": 4, "rope": True}):
        with pytest.raises(ValueError):
            jburnin.BurnInConfig(**kw)
        with pytest.raises(ValueError):
            tburnin.BurnInConfig(**kw)
    t = tburnin.BurnInConfig(d_model=64, n_heads=8, n_kv_heads=2)
    j = jburnin.BurnInConfig(d_model=64, n_heads=8, n_kv_heads=2)
    assert (t.head_dim, t.kv_heads) == (j.head_dim, j.kv_heads) == (8, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tburnin.BurnInConfig(n_experts=2)
