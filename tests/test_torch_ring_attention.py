# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, sequence-parallel attention against the JAX reference:

- the plain K2 (``flash_partial``, which runs ``flash_partial_ref`` on a
  CPU tensor) against the reference's Pallas ``flash_partial`` in
  interpret mode, causal and full, q and k of equal and of unequal length;
- ``ring_self_attention`` (impl dense and flash) and
  ``ulysses_self_attention`` forward on meshes (dp, sp, tp) of repeated CPU
  devices against the reference's on its virtual 8-device CPU mesh;
- gradients through the ring (``RingFlash``, fused and split backward; the
  dense ring by autograd) and through Ulysses against ``jax.grad`` of the
  reference's;
- at the smallest shard the reference's flash path tiles (8 rows), the
  ring against the reference's own interpret-mode flash ring.

The larger comparisons use the reference's dense ring (``impl="dense"``),
its numerics reference; each reference output is computed once per module
(jitted). Tolerances (f32): 1e-5 · max(1, max|ref|) — summation order only.
K2 in bf16: acc within 2e-2 · max(1, max|ref|) (P rounds to bf16 per
16-key tile in the reference, per 64-key tile on the card, once per row
here), m and l within 1e-5 · max(1, |ref|).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nvidia_terraform_modules_tpu_torch.ops import (
    dense_reference_attention,
    flash_partial,
    ring_self_attention,
    ulysses_self_attention,
)
from nvidia_terraform_modules_tpu_torch.parallel import build_mesh, plan_mesh

jfa = importlib.import_module("nvidia_terraform_modules_tpu.ops.flash_attention")
jring = importlib.import_module(
    "nvidia_terraform_modules_tpu.ops.ring_attention")
july = importlib.import_module(
    "nvidia_terraform_modules_tpu.ops.ulysses_attention")
tring = importlib.import_module(
    "nvidia_terraform_modules_tpu_torch.ops.ring_attention")
tfa = importlib.import_module(
    "nvidia_terraform_modules_tpu_torch.ops.flash_attention")

MESHES = [(1, 1, 1), (1, 2, 1), (1, 4, 1), (2, 2, 2)]
SHAPE = (2, 32, 4, 16)          # B, S, H, D: an 8-row shard at sp = 4
TOL = 1e-5


def _jmesh(dp, sp, tp):
    devs = np.array(jax.devices()[: dp * sp * tp]).reshape(dp, sp, tp)
    return Mesh(devs, ("dp", "sp", "tp"))


def _tmesh(dp, sp, tp):
    n = dp * sp * tp
    return build_mesh(plan_mesh(n, tp=tp, sp=sp),
                      devices=[torch.device("cpu")] * n)


def _inputs(shape=SHAPE, seed=0):
    """q, k, v and the cotangent w, numpy f32."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def ref():
    """``ref(op, mesh, causal, impl="dense", grad=False, shape=SHAPE)``:
    the reference's output (or its (dq, dk, dv) for the loss
    ``sum(out · w)``), each computed once."""
    cache = {}

    def get(op, mesh, causal, impl="dense", grad=False, shape=SHAPE):
        key = (op, mesh, causal, impl, grad, shape)
        if key not in cache:
            q, k, v, w = (jnp.asarray(x) for x in _inputs(shape))
            fn = {"ring": jring.ring_self_attention,
                  "ulysses": july.ulysses_self_attention}[op]
            m = _jmesh(*mesh)

            def out(q, k, v):
                return fn(q, k, v, m, causal=causal, impl=impl)

            if grad:
                res = jax.jit(jax.grad(lambda q, k, v: jnp.sum(out(q, k, v) * w),
                                       argnums=(0, 1, 2)))(q, k, v)
            else:
                res = jax.jit(out)(q, k, v)
            cache[key] = jax.tree.map(np.asarray, res)
        return cache[key]

    return get


def _run(fn, mesh, causal, shape=SHAPE, grad=False, **kw):
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(shape))
    tm = _tmesh(*mesh)
    if not grad:
        return fn(q, k, v, tm, causal=causal, **kw)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    loss = (fn(q, k, v, tm, causal=causal, **kw) * w).sum()
    return torch.autograd.grad(loss, (q, k, v))


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("causal,sq,sk", [(True, 32, 32), (True, 48, 32),
                                          (False, 32, 32), (False, 32, 48)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_partial_matches_reference_kernel(causal, sq, sk, dtype):
    b, h, d = 2, 2, 16
    rng = np.random.default_rng(sq + sk + causal)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def bhsd(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, -1, d), jdt)

    o, m, l_ = jfa.flash_partial(bhsd(q), bhsd(k), bhsd(v), scale=d ** -0.5,
                                 causal=causal, block_q=16, block_k=16,
                                 interpret=True)
    want_acc = np.asarray(o, np.float32).reshape(b, h, sq, d).transpose(
        0, 2, 1, 3)
    want_m, want_l = (np.asarray(x, np.float32).reshape(b, h, sq)
                      for x in (m, l_))
    acc, tm, tl = flash_partial(*(torch.from_numpy(x).to(tdt)
                                  for x in (q, k, v)),
                                scale=d ** -0.5, causal=causal)
    assert acc.dtype == tm.dtype == tl.dtype == torch.float32
    assert acc.shape == (b, sq, h, d) and tm.shape == tl.shape == (b, h, sq)
    _close(acc, want_acc, TOL if dtype == "f32" else 2e-2)
    for got, want in ((tm, want_m), (tl, want_l)):
        err = np.abs(got.numpy() - want)
        assert (err <= TOL * np.maximum(1.0, np.abs(want))).all(), err.max()


# ---------------------------------------------------------------- ring

@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_ring_forward_matches_reference(ref, mesh, causal, impl):
    got = _run(ring_self_attention, mesh, causal, impl=impl)
    assert got.shape == SHAPE and got.dtype == torch.float32
    _close(got, ref("ring", mesh, causal))


@pytest.mark.parametrize("mesh", [(1, 4, 1), (2, 2, 2)], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl,backward", [("dense", "fused"),
                                           ("flash", "fused"),
                                           ("flash", "split")])
def test_ring_gradients_match_reference(ref, mesh, causal, impl, backward):
    got = _run(ring_self_attention, mesh, causal, grad=True, impl=impl,
               backward=backward)
    for g, w in zip(got, ref("ring", mesh, causal, grad=True)):
        _close(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_matches_reference_flash_ring(ref, causal):
    """At an 8-row shard the reference's ring runs its Pallas flash
    sweeps (interpret mode): K2 per visiting block against its
    ``flash_partial``, the backward against its ``flash_dqdkv``."""
    shape = (2, 32, 2, 16)
    got = _run(ring_self_attention, (1, 4, 1), causal, shape=shape,
               impl="flash")
    _close(got, ref("ring", (1, 4, 1), causal, impl="flash", shape=shape))
    if causal:
        grads = _run(ring_self_attention, (1, 4, 1), causal, shape=shape,
                     grad=True, impl="flash")
        for g, w in zip(grads, ref("ring", (1, 4, 1), causal, impl="flash",
                                   grad=True, shape=shape)):
            _close(g, w)


def test_ring_picks_dense_for_untileable_shards(monkeypatch):
    """``impl=None`` on CPU tensors takes the flash ring when the shard
    length tiles into 8-multiple blocks and the dense ring otherwise (the
    reference's ``pick_impl``): with K2 made to fail, the 12-row shard
    still runs. On a CUDA device ``impl=None`` is flash at every length
    (the kernels mask ragged tails; run on the card in
    ``test_torch_cuda_kernels.py``)."""
    for n in (12, 13, 16):
        assert tfa.pick_impl(None, n, "ring", torch.device("cuda")) \
            == "flash"
    assert tfa.pick_impl("dense", 12, "ring", torch.device("cuda")) \
        == "dense"
    def no_flash(*a, **k):
        raise AssertionError("flash_partial called")

    monkeypatch.setattr(tring, "flash_partial", no_flash)
    got = _run(ring_self_attention, (1, 4, 1), True, shape=(2, 48, 2, 16))
    want = _run(ring_self_attention, (1, 4, 1), True, shape=(2, 48, 2, 16),
                impl="dense")
    assert torch.equal(got, want)
    with pytest.raises(AssertionError, match="flash_partial called"):
        _run(ring_self_attention, (1, 4, 1), True)


def test_ring_and_ulysses_refuse_bad_arguments():
    args = [torch.zeros(SHAPE) for _ in range(3)] + [_tmesh(1, 2, 1)]
    for fn in (ring_self_attention, ulysses_self_attention):
        with pytest.raises(ValueError, match="impl"):
            fn(*args, impl="cuda")
        with pytest.raises(ValueError, match="backward"):
            fn(*args, backward="bogus")
        with pytest.raises(ValueError, match="sequence"):
            fn(*args, spec=("sp", "dp", "tp", None))
    with pytest.raises(ValueError, match="sp×tp"):
        ulysses_self_attention(*[torch.zeros((2, 32, 3, 16))] * 3,
                               _tmesh(1, 2, 1))


def test_dense_reference_matches_reference():
    q, k, v, _ = _inputs()
    for causal, window in ((True, None), (False, None), (True, 5)):
        want = jring.dense_reference_attention(
            *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
            window=window)
        got = dense_reference_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
            window=window)
        _close(got, want)


# ------------------------------------------------------------- Ulysses

@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_ulysses_forward_matches_reference(ref, mesh, causal, impl):
    got = _run(ulysses_self_attention, mesh, causal, impl=impl)
    assert got.shape == SHAPE
    _close(got, ref("ulysses", mesh, causal))


@pytest.mark.parametrize("mesh", [(1, 4, 1), (2, 2, 2)], ids=str)
@pytest.mark.parametrize("impl,backward", [("dense", "fused"),
                                           ("flash", "fused"),
                                           ("flash", "split")])
def test_ulysses_gradients_match_reference(ref, mesh, impl, backward):
    got = _run(ulysses_self_attention, mesh, True, grad=True, impl=impl,
               backward=backward)
    for g, w in zip(got, ref("ulysses", mesh, True, grad=True)):
        _close(g, w)
