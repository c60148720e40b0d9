# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, int8 weights: the int8 matmul (K8's plain version, which
the wrapper runs on a CPU tensor) against the JAX reference's Pallas kernel
in interpret mode and its plain version; ``quantize`` / ``quantize_kv`` bit
for bit against the reference's; ``QTensor`` (product, gather, ``.T``, the
refusals, ``h @ qt`` dispatch) against the reference's ``QTensor``; the
``quantize_params`` layout and the ``qparams_from_numpy`` round trip; and
K8's K split (``int8_slices``): its constants are the kernel's, and the
split follows from K and N alone.

Tolerances: f32 max-abs within 1e-5 of max(1, max|ref|) against both the
reference's plain version and its kernel (the sums run in another order;
the kernel also scales after the product), bf16 2e-2 (one bf16 rounding of
the output); quantised values and scales exactly.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import decode as jdecode
from nvidia_terraform_modules_tpu.models import quantize as jquant
from nvidia_terraform_modules_tpu.ops.int8_matmul import (
    int8_matmul as jax_int8_matmul,
)
from nvidia_terraform_modules_tpu.ops.int8_matmul import (
    int8_matmul_ref as jax_int8_matmul_ref,
)
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    QTensor,
    params_from_numpy,
    qparams_from_numpy,
    quantize,
    quantize_kv,
    quantize_params,
)
from nvidia_terraform_modules_tpu_torch.ops import int8_matmul, int8_matmul_ref
from nvidia_terraform_modules_tpu_torch.ops.int8_matmul import (
    K8_BK,
    K8_BN,
    K8_CTAS,
    K8_MIN_TILES,
    K8_SLICES,
    int8_slices,
)

BF16 = torch.bfloat16


def _case(m, k, n, trans, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.integers(-127, 128, size=(n, k) if trans else (k, n),
                     dtype=np.int8)
    scale = rng.uniform(0.01, 0.1, size=(n,)).astype(np.float32)
    return x, w, scale


def jax_qtree_to_numpy(tree):
    """The reference's ``quantize_params`` tree → numpy leaves, each QTensor
    as ``{"q", "scale", "scale_axis"}`` (no JAX class crosses over)."""
    if isinstance(tree, dict):
        return {k: jax_qtree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_qtree_to_numpy(v) for v in tree]
    if isinstance(tree, jquant.QTensor):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale),
                "scale_axis": tree.scale_axis}
    return np.asarray(tree)


@pytest.mark.parametrize("m", [1, 7, 64])
@pytest.mark.parametrize("trans", [False, True])
def test_plain_int8_matmul_matches_reference_f32(m, trans):
    x, w, scale = _case(m, 256, 384, trans, seed=m + 10 * trans)
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(scale), transpose_rhs=trans).numpy()
    want_ref = np.asarray(jax_int8_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        transpose_rhs=trans))
    want_kernel = np.asarray(jax_int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        transpose_rhs=trans, interpret=True))
    assert got.shape == (m, 384) and got.dtype == np.float32
    for want in (want_ref, want_kernel):
        lim = 1e-5 * max(1.0, np.abs(want).max())
        assert np.abs(got - want).max() <= lim


@pytest.mark.parametrize("m", [1, 7, 64])
@pytest.mark.parametrize("trans", [False, True])
def test_plain_int8_matmul_matches_reference_bf16(m, trans):
    x, w, scale = _case(m, 256, 128, trans, seed=100 + m + trans)
    tx = torch.from_numpy(x).to(BF16)
    jx = jnp.asarray(x, jnp.bfloat16)
    got = int8_matmul(tx, torch.from_numpy(w), torch.from_numpy(scale),
                      transpose_rhs=trans)
    assert got.dtype == BF16
    got = got.float().numpy()
    for want in (jax_int8_matmul_ref(jx, jnp.asarray(w), jnp.asarray(scale),
                                     transpose_rhs=trans),
                 jax_int8_matmul(jx, jnp.asarray(w), jnp.asarray(scale),
                                 transpose_rhs=trans, interpret=True)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_plain_int8_matmul_is_the_cpu_wrapper_and_checks_shapes():
    x, w, scale = (torch.from_numpy(a) for a in _case(3, 128, 64, False, 7))
    assert torch.equal(int8_matmul(x, w, scale), int8_matmul_ref(x, w, scale))
    with pytest.raises(ValueError, match="contraction"):
        int8_matmul(x[:, :100], w, scale)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(x, w.float(), scale)
    with pytest.raises(ValueError, match="scale"):
        int8_matmul(x, w, scale[:3])


@pytest.mark.parametrize("shape,axis", [((64, 96), -1), ((50, 32), 0),
                                        ((3, 8, 16), 1)])
def test_quantize_is_bit_identical_to_reference(shape, axis):
    w = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    w[0] = 0.0                         # an all-zero slice: the 1e-12 floor
    q, s = quantize(torch.from_numpy(w), axis=axis)
    jq, js = jquant.quantize(jnp.asarray(w), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_quantize_kv_is_bit_identical_to_reference(dtype):
    x = np.random.default_rng(3).normal(size=(2, 5, 3, 16)).astype(
        np.float32) * 4
    x[0, 0, 0] = 0.0
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(BF16), jx.astype(jnp.bfloat16)
    q, s = quantize_kv(tx)
    jq, js = jdecode.quantize_kv(jx)
    assert q.shape == (2, 5, 3, 16) and s.shape == (2, 5, 3)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))


def _qt_pair(shape, axis, seed):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jq, js = jquant.quantize(jnp.asarray(w), axis=axis)
    jqt = jquant.QTensor(jq, js.reshape(-1), scale_axis=axis % 2,
                         dtype=jnp.float32)
    tqt = QTensor(torch.from_numpy(np.array(jq)),
                  torch.from_numpy(np.array(js).reshape(-1)),
                  scale_axis=axis % 2, dtype=torch.float32)
    return jqt, tqt


def test_qtensor_matmul_matches_reference():
    jqt, tqt = _qt_pair((128, 256), -1, seed=1)
    x = np.random.default_rng(2).normal(size=(2, 7, 128)).astype(np.float32)
    got = torch.from_numpy(x) @ tqt           # Tensor.__matmul__ → QTensor
    assert isinstance(got, torch.Tensor) and got.shape == (2, 7, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.asarray(x) @ jqt),
                               rtol=1e-5, atol=1e-5)
    assert tqt.shape == (128, 256) and tqt.device.type == "cpu"
    np.testing.assert_allclose(tqt.dequantize().numpy(),
                               np.asarray(jqt.dequantize()), rtol=0, atol=0)


def test_qtensor_tied_head_and_gather_match_reference():
    jqt, tqt = _qt_pair((50, 32), 0, seed=5)
    idx = np.array([[3, 11], [0, 49]])
    np.testing.assert_array_equal(tqt[torch.from_numpy(idx)].numpy(),
                                  np.asarray(jqt[jnp.asarray(idx)]))
    assert tqt.T.shape == (32, 50) and tqt.T.q is tqt.q   # a view, no copy
    x = np.random.default_rng(6).normal(size=(4, 32)).astype(np.float32)
    np.testing.assert_allclose((torch.from_numpy(x) @ tqt.T).numpy(),
                               np.asarray(jnp.asarray(x) @ jqt.T),
                               rtol=1e-5, atol=1e-5)


def test_qtensor_refusals_match_reference():
    q = torch.zeros((16, 24), dtype=torch.int8)
    qt = QTensor(q, torch.ones((16,)), scale_axis=0, dtype=torch.float32)
    with pytest.raises(TypeError, match="contraction axis"):
        _ = torch.ones((2, 16)) @ qt
    with pytest.raises(TypeError, match="transposed"):
        _ = qt.T[torch.tensor([0])]
    cols = QTensor(q, torch.ones((24,)), scale_axis=1, dtype=torch.float32)
    with pytest.raises(TypeError, match="per-row"):
        _ = cols[torch.tensor([0])]
    with pytest.raises(ValueError, match="contraction mismatch"):
        _ = torch.ones((2, 15)) @ cols


def test_qtensor_takes_the_int8_matmul_only_at_decode_widths(monkeypatch):
    """``_kernel_ok``'s rule: M <= 64 with 128-multiple dims goes to the
    int8 matmul wrapper (K8 on the card), wider M to the plain version."""
    tq = sys.modules["nvidia_terraform_modules_tpu_torch.models.quantize"]
    calls = []
    monkeypatch.setattr(tq, "int8_matmul",
                        lambda *a, **k: calls.append("kernel")
                        or int8_matmul_ref(*a, **k))
    monkeypatch.setattr(tq, "int8_matmul_ref",
                        lambda *a, **k: calls.append("plain")
                        or int8_matmul_ref(*a, **k))
    _, tqt = _qt_pair((128, 256), -1, seed=3)
    torch.ones((4, 16, 128)) @ tqt            # M = 64
    torch.ones((65, 128)) @ tqt
    _, small = _qt_pair((32, 48), -1, seed=4)
    torch.ones((2, 32)) @ small               # dims not 128-multiples
    assert calls == ["kernel", "plain", "plain"]


def test_quantize_params_layout_matches_reference():
    kw = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=2,
              seq_len=8, batch=2)
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           BurnInConfig(**kw, dtype=torch.float32),
                           device="cpu")
    qp = quantize_params(tp, dtype=torch.float32)
    want = jax_qtree_to_numpy(jquant.quantize_params(jp, dtype=jnp.float32))
    assert isinstance(qp["embed"], QTensor) and qp["embed"].scale_axis == 0
    assert tuple(qp["embed"].scale.shape) == (64,)
    assert isinstance(qp["out_norm"], torch.Tensor)
    for got, ref in [(qp["embed"], want["embed"])] + [
            (layer[key], wl[key]) for layer, wl in zip(qp["layers"],
                                                      want["layers"])
            for key in ("wq", "wk", "wv", "wo", "up", "down")]:
        assert got.scale_axis == ref["scale_axis"]
        assert np.array_equal(got.q.numpy(), ref["q"])
        assert np.array_equal(got.scale.numpy(), ref["scale"])
    for layer in qp["layers"]:
        assert isinstance(layer["attn_norm"], torch.Tensor)
        assert layer["wq"].scale_axis == 1


def test_qparams_from_numpy_round_trip():
    """The reference's quantised tree loads into the port as the same int8
    values and scales, and its leaves compute the reference's products."""
    kw = dict(vocab=128, d_model=128, n_heads=2, n_kv_heads=1, d_ff=256,
              n_layers=1, seq_len=8, batch=2)
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(4), jcfg)
    jqp = jquant.quantize_params(jp, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    qp = qparams_from_numpy(jax_qtree_to_numpy(jqp), cfg, device="cpu")
    mine = quantize_params(params_from_numpy(jax.tree.map(np.asarray, jp),
                                             cfg, device="cpu"),
                           dtype=torch.float32)
    for key in ("embed", "out_norm"):
        a, b = qp[key], mine[key]
        if isinstance(a, QTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
            assert a.scale_axis == b.scale_axis and a.dtype == b.dtype
        else:
            assert torch.equal(a, b)
    layer, jlayer = qp["layers"][0], jqp["layers"][0]
    x = np.random.default_rng(9).normal(size=(3, 128)).astype(np.float32)
    for key in ("wq", "wk", "up"):
        assert torch.equal(layer[key].q, mine["layers"][0][key].q)
        np.testing.assert_allclose((torch.from_numpy(x) @ layer[key]).numpy(),
                                   np.asarray(jnp.asarray(x) @ jlayer[key]),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="int8"):
        qparams_from_numpy({**jax_qtree_to_numpy(jqp),
                            "embed": {"q": np.zeros((2, 2), np.float32),
                                      "scale": np.ones(2),
                                      "scale_axis": 0}}, cfg, device="cpu")


# --- K8's K split (the wrapper's pure helper; the kernel runs only on a
# card, where tests/test_torch_cuda_kernels.py reads the launched grid)

K8_SRC = (Path(__file__).resolve().parents[1] / "nvidia_terraform_modules_tpu_torch"
          / "csrc" / "int8_matmul.cu")


def test_int8_grid_constants_are_the_kernels():
    """The wrapper splits K in the kernel's own tile, and into the slice
    counts the kernel takes: the divisors of its channel block within its
    cluster limit."""
    src = K8_SRC.read_text()
    found = {name: int(v) for name, v in re.findall(
        r"constexpr int (kBN|kBK|kMaxSlices) = (\d+);", src)}
    assert (found["kBN"], found["kBK"]) == (K8_BN, K8_BK)
    assert K8_SLICES == tuple(d for d in range(1, found["kMaxSlices"] + 1)
                              if K8_BN % d == 0)


@pytest.mark.parametrize("k,n,want", [
    (2048, 2048, (16, 8)),     # the square projections: 8 slices of 2 tiles
    (2048, 8192, (64, 2)),     # up, and the tied head over [8192, 2048]
    (8192, 2048, (16, 8)),     # down: 8 slices of 8 tiles
    (384, 640, (5, 1)),        # three tiles: too few to split
    (2048, 192, (2, 8)),       # a half-filled last channel block
])
def test_int8_grid_at_the_flagship_shapes(k, n, want):
    """(channel blocks, K slices)"""
    assert (-(-n // K8_BN), int8_slices(k, n)) == want


@pytest.mark.parametrize("k", [128, 256, 384, 768, 1024, 2048, 3072, 8192,
                               16384])
@pytest.mark.parametrize("n", [64, 128, 640, 2048, 8192, 32768])
def test_int8_grid_split_follows_k_and_n_alone(k, n):
    """The K split takes K and N alone (never M, so a row's bits do not
    depend on it), is one of the slice counts the kernel takes, divides
    K's tiles, keeps the CTAs to one an SM and each slice to at least
    K8_MIN_TILES tiles — or does not split."""
    slices = int8_slices(k, n)
    blocks, tiles = -(-n // K8_BN), k // K8_BK
    assert slices in K8_SLICES and K8_BN % slices == 0
    assert tiles % slices == 0
    if slices > 1:
        assert blocks * slices <= K8_CTAS
        assert tiles // slices >= K8_MIN_TILES
    # the most such slices
    assert not any(tiles % d == 0 and blocks * d <= K8_CTAS
                   and tiles // d >= K8_MIN_TILES
                   for d in K8_SLICES if d > slices)
