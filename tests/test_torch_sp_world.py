# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the burn-in with the sequence sharded over processes
(``sp`` on a ``torch.distributed`` world) against the JAX reference's
``forward_and_aux``, loss and gradients on the jax8 mesh of the same
shape, from the same weights and global batch.

Two gloo worlds (``_torch_world.py``), several cases each:

- a world of 2 (sp 2): ``attn`` ring, Ulysses, flash and dense, all with
  RoPE; MoE (top-2, at a capacity that drops assignments) with sp 2; and
  the ring with every rank's RoPE offset planted at 0, which must fail
  the comparison;
- a world of 4: dp 2 × sp 2 and sp 2 × tp 2 with the ring, MoE over
  sp 2 × ep 2, and the multislice mesh slice 2 × sp 2.

Each rank's logits are its rows and sequence piece of the reference's;
the loss and every gathered gradient are the world's. Tolerances are
``tests/test_torch_parallel.py``'s (atol 1e-5, rtol 1e-4). Three SGD steps
lower each case's loss. Every case is held to the reference's unsharded
model and to the reference on the jax8 mesh of its shape; the mesh
comparisons that go through the reference's ring (~10 s each on the CPU)
are in the slow profile. In this process, ``shard_flash_attention`` (the
flash case's attention) is held to the one-process flash ring and to the
reference's dense attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_world import run_world

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.parallel import mesh as jmesh_mod
from nvidia_terraform_modules_tpu.parallel import multislice as jmultislice
from nvidia_terraform_modules_tpu.parallel import sharding as jsharding

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=4)
MOE = dict(attn="ring", n_experts=4, router_top_k=2, capacity_factor=0.5)
ATOL, RTOL = 1e-5, 1e-4
# name → (world size, plan keywords, config changes[, slices])
CASES = {
    "ring": (2, dict(tp=1, sp=2), dict(attn="ring", rope=True)),
    "ulysses": (2, dict(tp=1, sp=2), dict(attn="ulysses", rope=True)),
    "flash": (2, dict(tp=1, sp=2), dict(attn="flash", rope=True)),
    "dense": (2, dict(tp=1, sp=2), dict(attn="dense", rope=True)),
    "moe_sp2": (2, dict(tp=1, sp=2), MOE),
    "dp2xsp2": (4, dict(tp=1, sp=2), dict(attn="ring", rope=True)),
    "sp2xtp2": (4, dict(tp=2, sp=2), dict(attn="ring", rope=True)),
    "moe_sp2xep2": (4, dict(tp=1, sp=2, ep=2), MOE),
    "slice2xsp2": (4, dict(tp=1, sp=2), dict(attn="ring", rope=True), 2),
}
PLANTED = "ring_planted_rope"


def _inputs(name):
    """The case's reference weights (numpy) and global batch."""
    over = CASES[name][2]
    jcfg = jburnin.BurnInConfig(**BASE, **over, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(len(name)), jcfg)
    stream = np.random.default_rng(len(name)).integers(
        0, BASE["vocab"], size=(BASE["batch"], BASE["seq_len"] + 1),
        dtype=np.int32)
    return jcfg, jp, (stream[:, :-1], stream[:, 1:])


def _run(p, b, jcfg, jrules):
    logits, aux = jburnin.forward_and_aux(p, b[0], jcfg, jrules)
    loss, grads = jax.value_and_grad(jburnin.loss_fn)(p, b, jcfg, jrules)
    return logits, aux, loss, grads


# one compile per (config, rules): the unsharded cases of one config share it
_jit_run = jax.jit(_run, static_argnums=(2, 3))


def _reference(name, on_mesh: bool = False):
    """The reference's logits, aux, loss and gradients in one jitted call:
    unsharded, or on the jax8 mesh of the case's shape."""
    n, plan, _, *slices = CASES[name]
    jcfg, jp, batch = _inputs(name)
    jrules = None
    if on_mesh:
        devices = jax.devices()[:n]
        if slices:
            jmesh = jmultislice.build_multislice_mesh(
                jmultislice.plan_multislice(n, slices[0], **plan),
                devices=devices)
        else:
            jmesh = jmesh_mod.build_mesh(jmesh_mod.plan_mesh(n, **plan),
                                         devices=devices)
        jrules = jsharding.make_rules(jmesh)
    jb = tuple(jnp.asarray(x) for x in batch)
    logits, aux, loss, grads = _jit_run(jp, jb, jcfg, jrules)
    return (np.asarray(logits), float(aux), float(loss),
            jax.tree.map(np.asarray, grads))


def _world_args(names):
    cases = []
    for name in names:
        _, plan, over, *slices = CASES[name]
        _, jp, batch = _inputs(name)
        case = {"name": name, "plan": plan, "cfg": {**BASE, **over},
                "params": jax.tree.map(np.asarray, jp), "batch": batch}
        if slices:
            case["slices"] = slices[0]
        cases.append(case)
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax8):
    """Both worlds' results (one spawn each for the module)."""
    out = {}
    for n in (2, 4):
        names = [k for k, v in CASES.items() if v[0] == n]
        cases = _world_args(names)
        if n == 2:
            cases.append({**cases[0], "name": PLANTED, "planted_rope": True})
        ranks = run_world("sp_world", n, tmp_path_factory.mktemp(f"sp{n}"),
                          {"cases": cases, "lr": 0.05, "steps": 3},
                          timeout=150)
        for name in names + ([PLANTED] if n == 2 else []):
            out[name] = [r[name] for r in ranks]
    return out


def _close(got, want):
    return np.allclose(got, want, atol=ATOL, rtol=RTOL)


def _grads_close(got, want) -> list:
    """The leaves (paths) where ``got`` leaves the tolerance."""
    bad = []
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        if g.shape != w.shape or not _close(g, w):
            bad.append(jax.tree_util.keystr(path))
    return bad


def _check(ranks, name, reference):
    logits, aux, loss, grads = reference
    sp = CASES[name][1]["sp"]
    for r in ranks:
        assert r["sp"][1] == sp
        (d, n_data), (i, _) = r["data"], r["sp"]
        rows = BASE["batch"] // n_data
        s = BASE["seq_len"] // sp
        want = logits[d * rows:(d + 1) * rows, i * s:(i + 1) * s]
        assert r["logits"].shape == want.shape
        np.testing.assert_allclose(r["logits"], want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(r["aux"], aux, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(r["loss"], loss, atol=ATOL, rtol=RTOL)
        assert r["losses"][0] == pytest.approx(r["loss"], rel=1e-6)
        assert r["losses"][-1] < r["losses"][0]
    assert _grads_close(ranks[0]["grads"], grads) == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_sp_world_matches_reference(worlds, name):
    """Against the reference's unsharded model (which its own tests hold
    equal to every mesh layout)."""
    _check(worlds[name], name, _reference(name))


# the reference's ring on a mesh takes ~10 s a case to compile and run in
# interpret mode on the CPU: those cases run in the slow profile
@pytest.mark.parametrize("name", [
    pytest.param(name, marks=() if CASES[name][2].get("attn") in (
        "ulysses", "flash", "dense") else pytest.mark.slow)
    for name in sorted(CASES)])
def test_sp_world_matches_reference_on_mesh(worlds, name):
    """Against the reference on the jax8 mesh of the case's shape."""
    _check(worlds[name], name, _reference(name, on_mesh=True))


def test_planted_rope_offset_fails(worlds):
    """Every rank's RoPE positions started at 0 (its local positions): the
    comparison that passes for the ring above must fail here."""
    logits, _, _, grads = _reference("ring")
    ranks = worlds[PLANTED]
    assert ranks[0]["mesh"] == worlds["ring"][0]["mesh"]
    s = BASE["seq_len"] // 2
    far = [not _close(r["logits"], logits[:, r["sp"][0] * s:
                                         (r["sp"][0] + 1) * s])
           for r in ranks]
    assert far == [False, True]      # rank 1's positions are wrong
    assert _grads_close(ranks[0]["grads"], grads) != []


def test_meshes_are_the_cases(worlds):
    assert worlds["dp2xsp2"][0]["mesh"] == {"dp": 2, "sp": 2, "tp": 1}
    assert worlds["sp2xtp2"][0]["mesh"] == {"dp": 1, "sp": 2, "tp": 2}
    assert worlds["moe_sp2xep2"][0]["mesh"] == {"dp": 1, "ep": 2, "sp": 2,
                                                "tp": 1}
    assert worlds["slice2xsp2"][0]["mesh"] == {"slice": 2, "dp": 1, "sp": 2,
                                               "tp": 1}


@pytest.mark.parametrize("backward", ["fused", "split"])
def test_shard_flash_is_the_ring_member_without_hops(monkeypatch, backward):
    """``shard_flash_attention`` (flash over ``sp`` on a world mesh: a
    shard's queries against the gathered K/V) for each shard of 4: the
    output equals member ``i``'s of the one-process flash ring bit for bit,
    it runs K2 on blocks ``0 ... i`` only, and its output and gradients
    match the reference's dense causal attention on the whole sequence."""
    import torch

    from nvidia_terraform_modules_tpu.ops import ring_attention as jring
    from nvidia_terraform_modules_tpu_torch.ops import ring_attention as ra

    n, s, shape = 4, 8, (2, 32, 2, 16)
    rng = np.random.default_rng(7)
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    want = np.asarray(jax.jit(lambda q, k, v: jring.dense_reference_attention(
        q, k, v, causal=True))(q, k, v))
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    ring = ra.ring_flash_attention_kernel(
        list(tq.split(s, 1)), list(tk.split(s, 1)), list(tv.split(s, 1)),
        hop=lambda b: [b[-1]] + b[:-1], causal=True)
    calls = []
    real = ra.flash_partial
    monkeypatch.setattr(ra, "flash_partial",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for i in range(n):
        calls.clear()
        qi, kk, vv = (x.clone().requires_grad_(True)
                      for x in (tq[:, i * s:(i + 1) * s], tk, tv))
        out = ra.shard_flash_attention(qi, kk, vv, i, backward=backward)
        assert len(calls) == i + 1
        assert torch.equal(out, ring[i].detach())
        np.testing.assert_allclose(out.detach().numpy(),
                                   want[:, i * s:(i + 1) * s], atol=ATOL,
                                   rtol=RTOL)
        got = torch.autograd.grad((out * tw[:, i * s:(i + 1) * s]).sum(),
                                  (qi, kk, vv))
        ref_in = [x.clone().requires_grad_(True)
                  for x in (tq[:, i * s:(i + 1) * s], tk, tv)]
        ref_out = ra.dense_reference_attention(*ref_in, causal=True,
                                               q_offset=i * s)
        ref = torch.autograd.grad((ref_out * tw[:, i * s:(i + 1) * s]).sum(),
                                  ref_in)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=ATOL,
                                       rtol=RTOL)
        assert not got[1][:, (i + 1) * s:].any()
    with pytest.raises(ValueError, match="hold no shard 4"):
        ra.shard_flash_attention(tq[:, :s], tk, tv, 4)
