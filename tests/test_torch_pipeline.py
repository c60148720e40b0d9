# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, ``parallel/pipeline.py`` (GPipe and 1F1B, tp inside the
stages) against the JAX reference's ``parallel/pipeline.py``, on the same
weights (the reference's ``init_pipeline_params`` → numpy →
``pipeline_params_from_numpy``) and the same numpy batch, at f32:

- one-process meshes ``[cpu] * n`` of (pp, dp) ∈ {(2, 1), (4, 1), (4, 2)}
  and (pp, dp, tp) ∈ {(2, 1, 2), (2, 2, 2)}: GPipe's loss equals the
  reference's unpipelined ``reference_loss_fn`` (rel 1e-5) and its
  gradients ``jax.grad`` of it (rtol 2e-4, atol 2e-5); 1F1B's loss and
  gradients equal the microbatch-mean reference (rel 1e-5; rtol 1e-4,
  atol 1e-5) — the reference tests' own tolerances
  (``tests/test_pipeline.py``);
- gloo worlds (``_torch_world.py``), one process a stage: (pp, dp) =
  (2, 1) in a world of 2, (2, 2) and (pp, dp, tp) = (2, 1, 2) in a world
  of 4, both schedules, at the same tolerances;
- the config, mesh and batch checks with the reference's messages, the
  schedules' tick order against the reference's formulas, and three SGD
  steps of each schedule against the reference's SGD on the same
  gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_world import run_world

from nvidia_terraform_modules_tpu.parallel import pipeline as jpipe
from nvidia_terraform_modules_tpu_torch.models import (
    pipeline_params_from_numpy,
    pipeline_params_to_numpy,
)
from nvidia_terraform_modules_tpu_torch.parallel import (
    MeshPlan,
    PipelineConfig,
    build_mesh,
    make_pipeline_train_step,
    pipeline_loss_fn,
    pipeline_value_and_grad_1f1b,
    reference_loss_fn,
    stack_sharding,
)
from nvidia_terraform_modules_tpu_torch.parallel import pipeline as tpipe

CPU = torch.device("cpu")
SMALL = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=4,
             seq_len=16, microbatch=2, n_microbatches=4)
JCFG = jpipe.PipelineConfig(**SMALL)
CFG = PipelineConfig(**SMALL)
SHAPES = [(2, 1), (4, 1), (4, 2), (2, 1, 2), (2, 2, 2)]


def _names(shape):
    return ("pp", "dp", "tp")[:len(shape)]


def _mesh(shape):
    return build_mesh(MeshPlan(_names(shape), shape),
                      devices=[CPU] * int(np.prod(shape)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny and the test workers share the CPU: one
    intra-op thread a process (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jp = jpipe.init_pipeline_params(jax.random.PRNGKey(0), JCFG)
    return jp, jax.tree.map(np.asarray, jp)


def _batch(dp, seed=1):
    total = SMALL["n_microbatches"] * SMALL["microbatch"] * dp
    stream = np.random.default_rng(seed).integers(
        0, SMALL["vocab"], size=(total, SMALL["seq_len"] + 1))
    return stream[:, :-1], stream[:, 1:]


def _tb(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _jb(batch):
    return tuple(jnp.asarray(x) for x in batch)


@jax.jit
def _ref_value_and_grad(params, batch):
    return jax.value_and_grad(jpipe.reference_loss_fn)(params, batch, JCFG)


@jax.jit
def _ref_1f1b(params, batch):
    """The microbatch-mean reference the reference's 1F1B test holds its
    schedule to."""
    def loss(p, b):
        toks = b[0].reshape(-1, JCFG.microbatch, JCFG.seq_len)
        tgts = b[1].reshape(-1, JCFG.microbatch, JCFG.seq_len)
        return jax.vmap(lambda t, g: jpipe.reference_loss_fn(
            p, (t, g), JCFG))(toks, tgts).mean()
    return jax.value_and_grad(loss)(params, batch)


def _assert_grads(got, want, rtol, atol):
    got = pipeline_params_to_numpy(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gpipe_matches_reference(weights, shape):
    jp, pn = weights
    batch = _batch(shape[1])
    ref_loss, ref_grads = _ref_value_and_grad(jp, _jb(batch))
    params = pipeline_params_from_numpy(pn, CFG, device="cpu")
    mesh = _mesh(shape)
    loss = float(pipeline_loss_fn(params, _tb(batch), CFG, mesh))
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    got_loss, grads = tpipe._gpipe_value_and_grad(params, _tb(batch), CFG,
                                                  mesh)
    assert float(got_loss) == loss
    _assert_grads(grads, ref_grads, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_1f1b_matches_reference(weights, shape):
    jp, pn = weights
    batch = _batch(shape[1])
    ref_loss, ref_grads = _ref_1f1b(jp, _jb(batch))
    params = pipeline_params_from_numpy(pn, CFG, device="cpu")
    loss, grads = pipeline_value_and_grad_1f1b(params, _tb(batch), CFG,
                                               _mesh(shape))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    _assert_grads(grads, ref_grads, rtol=1e-4, atol=1e-5)


def test_reference_loss_fn_matches_reference(weights):
    jp, pn = weights
    batch = _batch(1, seed=3)
    want = float(_ref_value_and_grad(jp, _jb(batch))[0])
    got = float(reference_loss_fn(pipeline_params_from_numpy(
        pn, CFG, device="cpu"), _tb(batch), CFG))
    assert got == pytest.approx(want, rel=1e-5)


def test_pipeline_validates_config(weights):
    """The reference's messages: layers that do not divide into the
    stages, a batch of the wrong row count, a tp that does not divide the
    heads, a mesh without pp/dp; and ``schedule="interleaved"``."""
    _, pn = weights
    params = pipeline_params_from_numpy(pn, CFG, device="cpu")
    mesh = _mesh((4, 2))
    bad = PipelineConfig(**{**SMALL, "n_layers": 6})
    cases = [
        (lambda: pipeline_loss_fn(params, _tb(_batch(2)), bad, mesh),
         "does not divide into pp"),
        (lambda: pipeline_loss_fn(params, _tb(_batch(1)), CFG, mesh),
         "rows; pipeline needs"),
        (lambda: pipeline_loss_fn(params, _tb(_batch(1)), CFG,
                                  _mesh((2, 1, 4))), "must divide n_heads"),
        (lambda: pipeline_value_and_grad_1f1b(
            params, _tb(_batch(1)), CFG,
            build_mesh(MeshPlan(("dp", "tp"), (2, 1)), devices=[CPU] * 2)),
         "pipeline needs a"),
        (lambda: make_pipeline_train_step(CFG, mesh,
                                          schedule="interleaved"),
         "schedule"),
    ]
    for call, words in cases:
        with pytest.raises(ValueError, match=words):
            call()


@pytest.mark.parametrize("tp", [1, 2])
def test_layer_specs_match_reference(tp):
    want = jpipe._layer_specs(tp)
    got = tpipe._layer_specs(tp)
    assert {k: tuple(v) for k, v in want.items()} == got
    mesh = _mesh((2, 1, tp))
    specs = stack_sharding(mesh, {"layers": dict.fromkeys(got)})
    assert specs["embed"] == () and specs["layers"] == got


def test_schedules_run_the_references_valid_ticks():
    """The ticks run exactly the (stage, microbatch) pairs the reference's
    masks keep: GPipe ``f = t - i``; 1F1B ``f = t - i`` and ``b = t -
    2(pp - 1) + i``, over ``M + pp - 1`` and ``M + 2(pp - 1)`` ticks."""
    for pp, M in ((1, 3), (2, 4), (4, 2), (4, 8)):
        gp = [(t, i, f) for t, pairs in tpipe._gpipe_ticks(pp, M)
              for i, f in pairs]
        assert gp == [(t, i, t - i) for t in range(M + pp - 1)
                      for i in range(pp) if 0 <= t - i < M]
        fb = list(tpipe._1f1b_ticks(pp, M))
        assert len(fb) == M + 2 * (pp - 1)
        for t, pairs in fb:
            for i, f, b in pairs:
                assert f == (t - i if 0 <= t - i < M else None)
                b_ref = t - 2 * (pp - 1) + i
                assert b == (b_ref if 0 <= b_ref < M else None)
        # every microbatch's forward and backward run once on every stage,
        # and the ring buffer's read slot is the one its write used
        for i in range(pp):
            assert sorted(f for _, p in fb for j, f, _ in p
                          if j == i and f is not None) == list(range(M))
            writes = {f: t % (2 * pp - 1) for t, p in fb
                      for j, f, _ in p if j == i and f is not None}
            reads = {b: (b + i) % (2 * pp - 1) for _, p in fb
                     for j, _, b in p if j == i and b is not None}
            assert writes == reads


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_train_steps_match_reference(weights, schedule):
    """Three SGD steps on the (pp 2, dp 2) mesh: the losses and parameters
    equal the reference's SGD on its unpipelined gradients (for 1F1B the
    microbatch mean; the reference's own tests hold its pipelined steps to
    these), and the loss falls."""
    jp, pn = weights
    batch = _batch(2)
    ref = _ref_value_and_grad if schedule == "gpipe" else _ref_1f1b
    step = make_pipeline_train_step(CFG, _mesh((2, 2)), lr=5e-2,
                                    schedule=schedule)
    params = pipeline_params_from_numpy(pn, CFG, device="cpu")
    losses = []
    for _ in range(3):
        jloss, jgrads = ref(jp, _jb(batch))
        jp = jax.tree.map(lambda p, g: p - 5e-2 * g, jp, jgrads)
        params, loss = step(params, _tb(batch))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    _assert_grads(params, jax.tree.map(np.asarray, jp), rtol=1e-4,
                  atol=1e-5)


def test_convert_round_trip(weights):
    _, pn = weights
    params = pipeline_params_from_numpy(pn, CFG, device="cpu")
    assert params["layers"]["wq"].shape == (4, 32, 32)
    back = pipeline_params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pn)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="layers"):
        pipeline_params_from_numpy(pn, PipelineConfig(
            **{**SMALL, "n_layers": 2}), device="cpu")


# ------------------------------------------------- one process a stage

WORLD_CASES = {         # name → (world size, axis names, shape)
    "pp2": (2, ("pp", "dp"), (2, 1)),
    "pp2xdp2": (4, ("pp", "dp"), (2, 2)),
    "pp2xtp2": (4, ("pp", "dp", "tp"), (2, 1, 2)),
    # the first 2 ranks of the world of 4 (the Job's leg on an odd world)
    "pp2_of_4": (4, ("pp", "dp"), (2, 1)),
}
WORLD_STEPS, WORLD_LR = 3, 5e-2


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, weights):
    _, pn = weights
    out = {}
    for n in (2, 4):
        cases = [{"name": name, "names": names, "shape": shape,
                  "batch": _batch(shape[1]), "subset": size > np.prod(shape)}
                 for name, (size, names, shape) in WORLD_CASES.items()
                 if size == n]
        ranks = run_world("pipeline_world", n,
                          tmp_path_factory.mktemp(f"pipe{n}"),
                          {"cfg": SMALL, "params": pn, "cases": cases,
                           "lr": WORLD_LR, "steps": WORLD_STEPS},
                          timeout=150)
        for c in cases:
            out[c["name"]] = [r[c["name"]] for r in ranks]
    return out


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("name", sorted(WORLD_CASES))
def test_world_pipeline_matches_reference(weights, worlds, name, schedule):
    """Each rank (one stage of one data row and tp member) reports the
    world's loss; the gathered gradients equal the reference's; three SGD
    steps equal the one-process mesh's."""
    jp, pn = weights
    _, names, shape = WORLD_CASES[name]
    batch = _batch(shape[1])
    ref = _ref_value_and_grad if schedule == "gpipe" else _ref_1f1b
    ref_loss, ref_grads = ref(jp, _jb(batch))
    tol = dict(rtol=2e-4, atol=2e-5) if schedule == "gpipe" else \
        dict(rtol=1e-4, atol=1e-5)
    ranks = worlds[name]
    size = int(np.prod(shape))
    assert ranks[size:] == [None] * (WORLD_CASES[name][0] - size)
    ranks = ranks[:size]
    assert ranks[0]["mesh"] == dict(zip(names, shape))
    tp = dict(zip(names, shape)).get("tp", 1)
    assert ranks[0]["local_wq"] == (SMALL["n_layers"] // shape[0], 32,
                                    32 // tp)
    for r in ranks:
        assert r["forward"] == pytest.approx(float(ref_loss), rel=1e-5)
        assert r[schedule]["loss"] == pytest.approx(float(ref_loss),
                                                    rel=1e-5)
    got = ranks[0][schedule]["grads"]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref_grads),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))
    step = make_pipeline_train_step(CFG, _mesh(shape), lr=WORLD_LR,
                                    schedule=schedule)
    params = pipeline_params_from_numpy(pn, CFG, device="cpu")
    want = []
    for _ in range(WORLD_STEPS):
        params, loss = step(params, _tb(batch))
        want.append(float(loss))
    for r in ranks:
        np.testing.assert_allclose(r[schedule]["losses"], want, rtol=1e-5)
    assert want[-1] < want[0]
