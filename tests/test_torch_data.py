# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the host input pipeline (``utils/data.py``) against the
reference's: ``token_stream`` draws the reference's arrays (int64 here,
the reference's int32 values) for three seeds and both biases; the
reference's ``tests/test_data.py`` cases on the port — the bias check,
determinism and the next-token contract, prefetch transparency, finite
iterators, ``input_pipeline``'s bias — with the device steer (the card
unless ``device`` names the CPU, never a fallback); a one-process
``[cpu] * 4`` mesh's placement (leaves whole on its home device, the
lock-step form's rows per data coordinate, scalars replicated); and ten
SGD steps fed by the stream, whose losses equal the reference's
``make_train_step`` fed by its stream on the same weights within f32
tolerance (atol 1e-5, rtol 1e-4, as ``tests/test_torch_train.py``) and
end below ``ln(64) ≈ 4.16``, as the reference's test asks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.utils import data as jdata
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    make_train_step,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.parallel import (
    build_mesh,
    make_rules,
    plan_mesh,
)
from nvidia_terraform_modules_tpu_torch.parallel.sharding import Lockstep
from nvidia_terraform_modules_tpu_torch.utils import (
    input_pipeline,
    prefetch_to_device,
    token_stream,
)

KW = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=1, seq_len=16,
          batch=8)
CFG = BurnInConfig(**KW, dtype=torch.float32)
JCFG = jburnin.BurnInConfig(**KW, dtype=jnp.float32)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny and the test workers share the CPU: one
    intra-op thread a process (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bias", ["zipf", "uniform"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_token_stream_is_the_references_draw(seed, bias):
    ours, ref = token_stream(CFG, seed, bias), jdata.token_stream(JCFG, seed,
                                                                 bias)
    for _ in range(3):
        (t, y), (jt, jy) = next(ours), next(ref)
        assert t.dtype == y.dtype == np.int64
        assert t.shape == y.shape == (CFG.batch, CFG.seq_len)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(y, jy)


def test_token_stream_bias_validated():
    with pytest.raises(ValueError, match="bias"):
        next(token_stream(CFG, bias="gaussian"))
    t, _ = next(token_stream(CFG, bias="uniform"))
    assert t.min() >= 0 and t.max() < CFG.vocab


def test_token_stream_deterministic_and_varied():
    a, b, c = (token_stream(CFG, seed=s) for s in (3, 3, 4))
    for _ in range(3):
        ta, tb, tc = next(a), next(b), next(c)
        assert np.array_equal(ta[0], tb[0])
        assert not np.array_equal(ta[0], tc[0])
        assert np.array_equal(ta[0][:, 1:], ta[1][:, :-1])
    s = token_stream(CFG, seed=0)
    assert not np.array_equal(next(s)[0], next(s)[0])


def test_prefetch_is_transparent():
    """Prefetching reorders nothing — same batches, same order, as int64
    tensors on the device asked for."""
    raw = token_stream(CFG, seed=7)
    pre = prefetch_to_device(token_stream(CFG, seed=7), size=3, device="cpu")
    for _ in range(6):
        a, b = next(raw), next(pre)
        assert isinstance(b, tuple) and b[0].device == CPU
        assert b[0].dtype == torch.int64
        np.testing.assert_array_equal(a[0], b[0].numpy())
        np.testing.assert_array_equal(a[1], b[1].numpy())
    with pytest.raises(ValueError, match="size"):
        next(prefetch_to_device(token_stream(CFG), size=0, device="cpu"))


def test_prefetch_drains_finite_iterators():
    batches = list(prefetch_to_device(iter([1, 2, 3]), size=8, device="cpu"))
    assert [int(b) for b in batches] == [1, 2, 3]
    assert list(prefetch_to_device(iter([]), device="cpu")) == []


def test_the_card_is_the_default_and_nothing_falls_back():
    """Without ``device`` the pipeline targets the card; with none, it
    raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is met")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(input_pipeline(CFG))


def test_input_pipeline_forwards_bias():
    a = next(input_pipeline(CFG, seed=3, bias="uniform", prefetch=1,
                            device="cpu"))
    b = next(token_stream(CFG, seed=3, bias="uniform"))
    np.testing.assert_array_equal(a[0].numpy(), b[0])


def test_prefetch_places_mixed_ranks_on_a_one_process_mesh():
    """On a one-process ``[cpu] * 4`` mesh (dp 2 × tp 2) each leaf goes
    whole to the mesh's home device, the lock-step form cuts each
    data coordinate's rows from it (the spec truncated to the leaf's
    rank: tokens and per-example lengths by rows, a scalar replicated),
    and a train step of the mesh takes the batch."""
    rules = make_rules(build_mesh(plan_mesh(4, tp=2), devices=[CPU] * 4))
    tokens = np.arange(8 * 16, dtype=np.int64).reshape(8, 16)
    (placed,) = list(prefetch_to_device(iter([{
        "tokens": tokens, "lengths": np.full((8,), 16, np.int32),
        "step": np.int32(1)}]), rules))
    assert placed["tokens"].device == rules.mesh.devices.flat[0]
    assert placed["lengths"].dtype == torch.int32
    assert placed["step"].shape == () and int(placed["step"]) == 1
    lock = Lockstep(rules)
    assert lock.n_data == 2
    for c in range(lock.n_data):
        np.testing.assert_array_equal(
            lock.rows(placed["tokens"], c).numpy(), tokens[4 * c:4 * c + 4])
        assert lock.rows(placed["lengths"], c).shape == (4,)
    jp = jburnin.init_params(jax.random.PRNGKey(0), JCFG)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                               device="cpu")
    step = make_train_step(CFG, rules, lr=5e-2, device="cpu")
    batch = next(input_pipeline(CFG, rules, seed=1))
    _, loss = step(params, batch)
    assert np.isfinite(float(loss))


def test_stream_fed_steps_match_the_reference_and_learn():
    """Ten SGD steps on the stream (seed 1, Zipf): each loss equals the
    reference's step on its own stream from the same weights, within f32
    tolerance, and the model learns the marginal — the last loss falls
    below a uniform model's ln(64) ≈ 4.16."""
    jp = jburnin.init_params(jax.random.PRNGKey(0), JCFG)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                               device="cpu")
    jstep = jburnin.make_train_step(JCFG, lr=5e-2)
    step = make_train_step(CFG, lr=5e-2, device="cpu")
    jlosses, losses = [], []
    for _, jbatch, batch in zip(range(10), jdata.input_pipeline(JCFG, seed=1),
                                input_pipeline(CFG, seed=1, device="cpu")):
        np.testing.assert_array_equal(np.asarray(jbatch[0]),
                                      batch[0].numpy())
        jp, jloss = jstep(jp, jbatch)
        params, loss = step(params, batch)
        jlosses.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=1e-4)
    assert losses[-1] < 4.0, losses
