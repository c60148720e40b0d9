# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the continuous-batching engine on the CPU.

The engine's contract (the reference's ``models/serving.py:87-94``):
batching, paging, slot recycling and arrival schedules are SCHEDULING —
each request's tokens equal ``greedy_decode`` run alone. On top, on shared
f32 weights, the port's engine emits exactly the JAX engine's tokens — with
the bf16 pool, the int8 pool, and int8 weights through the phase split.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models.serving import (
    make_serve_engine as jax_engine,
)
from nvidia_terraform_modules_tpu_torch.models import (
    AdmissionSource,
    AotCompileCache,
    BurnInConfig,
    WarmChainStore,
    greedy_decode,
    make_serve_engine,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.telemetry import Registry

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2)


def _setup(n=5, seed=0, attn="dense", lens=None, **over):
    kw = {**BASE, "attn": attn, **over}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    rng = np.random.default_rng(seed + 1)
    lens = lens or [4 + (i % 3) * 2 for i in range(n)]
    prompts = [rng.integers(0, cfg.vocab, size=(ln,)).astype(np.int32)
               for ln in lens]
    return jcfg, jp, cfg, params, prompts


def _solo(params, prompts, n_new, cfg):
    return [greedy_decode(params, torch.from_numpy(p)[None], n_new, cfg,
                          device="cpu")[0] for p in prompts]


@pytest.mark.parametrize("paged_kernel", ["auto", "on", "off"])
def test_engine_matches_solo_greedy_with_recycling(paged_kernel):
    """5 requests through 2 slots: every slot recycles and every request's
    tokens equal its solo greedy decode, whichever read path runs."""
    _, _, cfg, params, prompts = _setup()
    engine = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                               paged_kernel=paged_kernel, device="cpu")
    got = engine(prompts, 6, slots=2)
    for g, w in zip(got, _solo(params, prompts, 6, cfg)):
        assert torch.equal(g, w)
    st = engine.last_stats
    assert st["requests"] == 5 and st["generated"] == 30
    assert st["waves"] >= 15 and st["kv"]["in_use"] == 0
    assert 0 < st["kv"]["utilisation"] <= 1


@pytest.mark.parametrize("attn,lens", [
    ("dense", None),
    ("flash", [8, 16, 8, 24, 16]),
])
def test_engine_tokens_equal_jax_engine(attn, lens):
    jcfg, jp, cfg, params, prompts = _setup(seed=3, attn=attn, lens=lens,
                                            n_kv_heads=2, rope=True)
    want = jax_engine(jp, jcfg, max_len=32, kv_block=4)(
        [jnp.asarray(p) for p in prompts], 5, slots=2)
    got = make_serve_engine(params, cfg, max_len=32, kv_block=4,
                            device="cpu")(prompts, 5, slots=2)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_eos_retirement_and_per_request_budgets():
    _, _, cfg, params, prompts = _setup(n=4, seed=5)
    solo = _solo(params, prompts, 8, cfg)
    eos = int(solo[1][3])             # request 1 stops at its 4th token
    engine = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                               device="cpu")
    got = engine(prompts, [8, 8, 3, 8], slots=2, eos_id=eos)
    for i, (g, w) in enumerate(zip(got, solo)):
        w = w[:3] if i == 2 else w
        hit = (w == eos).nonzero()
        n = int(hit[0]) + 1 if len(hit) else len(w)
        assert torch.equal(g, w[:n]), i
    assert len(got[1]) <= 4
    assert engine.last_stats["generated"] == sum(len(g) for g in got)


def test_kv_blocks_admission_control_holds_the_queue():
    """A pool that fits one request at a time serialises admission
    without changing a token; one too small for any request refuses."""
    _, _, cfg, params, prompts = _setup(n=4, seed=7)
    engine = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                               device="cpu")
    full = engine(prompts, 6, slots=3)
    tight = engine(prompts, 6, slots=3, kv_blocks=1 + 4)
    for a, b in zip(full, tight):
        assert torch.equal(a, b)
    assert engine.last_stats["kv"]["high_water"] <= 4
    with pytest.raises(ValueError, match="kv_blocks"):
        engine(prompts, 6, slots=3, kv_blocks=3)


def test_arrivals_and_static_batching_are_scheduling_only():
    _, _, cfg, params, prompts = _setup(n=4, seed=9)
    engine = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                               device="cpu")
    base = engine(prompts, 5, slots=2)
    late = engine(prompts, 5, slots=2, arrivals=[0.0, 0.02, 0.02, 0.05])
    static = engine(prompts, 5, slots=2, static_batching=True)
    for a, b, c in zip(base, late, static):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_engine_validation_and_unported_levers(tmp_path):
    _, _, cfg, params, prompts = _setup(n=2)
    engine = make_serve_engine(params, cfg, max_len=12, device="cpu")
    assert engine([], 4) == []
    assert engine.last_stats["requests"] == 0
    assert [len(o) for o in engine(prompts, 1, slots=1)] == [1, 1]
    with pytest.raises(ValueError, match="max_len"):
        engine(prompts, 12)
    with pytest.raises(ValueError, match="n_new"):
        engine(prompts, 0)
    # the ported levers build; the rest refuse, naming their item
    for lever, value in (("prefix", [1, 2]), ("prefill_chunk", 4),
                         ("policy", "sjf"), ("share_prefix", True),
                         ("lazy_growth", True), ("spec_k", 2),
                         ("sampler", {"top_k": 1}),
                         ("telemetry", Registry())):
        make_serve_engine(params, cfg, max_len=12, device="cpu",
                          **{lever: value})
    # the host KV tier builds beside the prefix index, and refuses without
    # it with the reference's message
    make_serve_engine(params, cfg, max_len=12, device="cpu",
                      host_spill=True, share_prefix=True)
    with pytest.raises(ValueError, match="share_prefix=True alongside"):
        make_serve_engine(params, cfg, max_len=12, device="cpu",
                          host_spill=True)
    # the shared store builds beside the prefix index, without the private
    # host tier, and refuses otherwise with the reference's messages; the
    # warm cache builds from a directory, activated and warmable
    store = WarmChainStore(cfg, 8, block_size=16, device="cpu")
    make_serve_engine(params, cfg, max_len=12, device="cpu",
                      share_prefix=True, shared_store=store)
    with pytest.raises(ValueError, match="CDN tier — enable share_prefix"):
        make_serve_engine(params, cfg, max_len=12, device="cpu",
                          shared_store=store)
    with pytest.raises(ValueError, match="replaces the private host tier"):
        make_serve_engine(params, cfg, max_len=12, device="cpu",
                          share_prefix=True, host_spill=True,
                          shared_store=store)
    warmed = make_serve_engine(params, cfg, max_len=12, device="cpu",
                               aot_cache=str(tmp_path / "aot"))
    try:
        assert isinstance(warmed.aot_cache, AotCompileCache)
        assert warmed.aot_cache.stats()["active"]
        st = warmed.warm(slots=1, prompt_lens=[len(p) for p in prompts],
                         n_new=1)
        assert st["registered"] >= 1 and not st["errors"]
        assert warmed.aot_cache.stats()["entries"] == st["registered"]
    finally:
        warmed.aot_cache.deactivate()

    # run(admission=) takes a source's warm bring-up chains: an engine
    # without a host tier drops each one and bills it
    class WarmSource(AdmissionSource):
        def __init__(self):
            self.left = [0, 1]

        def candidate(self):
            return self.left[0] if self.left else None

        def pop(self, req):
            self.left.remove(req)

        def exhausted(self):
            return not self.left

        def warm_chains(self):
            return [(((1, 2, 3, 4),), {})]

    got = engine(prompts, 2, admission=WarmSource())
    assert sorted(got) == [0, 1]
    assert engine.last_stats["prefix"]["warm"]["seed_dropped"] == 1
    with pytest.raises(TypeError):
        make_serve_engine(params, cfg, max_len=12, device="cpu", bogus=1)
    # the reference's baseline values of a lever are the engine as it is
    make_serve_engine(params, cfg, max_len=12, device="cpu", policy="fifo")


def _keyword_defaults(fn) -> dict:
    return {name: p.default
            for name, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


# keywords the port now serves, at a value other than the reference's
# default that leaves this traffic's tokens as they are (run's rules=
# needs a torch.distributed world: tests/test_torch_serving_sharded.py) (a top-k = 1
# sampler is the greedy engine; a telemetry registry records, it changes
# no token; speculation, greedy only and with per-trip eos checks, is
# served by an engine of its own)
_PORTED = {
    "make_serve_engine": {"aging": 4, "prefix_keep_blocks": 32,
                          "sampler": {"top_k": 1},
                          "telemetry": Registry(), "host_blocks": 8,
                          "host_swap": "sync"},
    "run": {"eos_check_every": 4, "rng": 0},
}
_PORTED_SPEC = {"spec_k": 2}


def test_reference_keywords_at_their_defaults_serve_the_same_tokens(
        tmp_path):
    """The port's engine takes every keyword of the reference's
    ``make_serve_engine`` and ``run`` (read from their signatures) at the
    reference's default and serves the same tokens as without them; a
    ported lever at another value serves them too — the warm cache
    (``aot_cache``, a directory) warmed first; a keyword the reference's
    function lacks is a TypeError."""
    jcfg, jp, cfg, params, prompts = _setup(n=3, seed=11)
    engine_kw = _keyword_defaults(jax_engine)
    run_kw = _keyword_defaults(jax_engine(jp, jcfg, max_len=16, kv_block=4))
    assert {"aging", "prefix_keep_blocks", "host_blocks",
            "host_swap"} <= set(engine_kw)
    assert {"rules", "rng", "eos_check_every", "priorities"} <= set(run_kw)
    base = make_serve_engine(params, cfg, max_len=16, device="cpu")
    want = base(prompts, 4)
    engine = make_serve_engine(params, cfg, max_len=16, device="cpu",
                               **engine_kw)
    got = engine(prompts, 4, **run_kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ported = make_serve_engine(params, cfg, max_len=16, device="cpu",
                               **_PORTED["make_serve_engine"])
    for g, w in zip(ported(prompts, 4, **_PORTED["run"]), want):
        assert torch.equal(g, w)
    speculative = make_serve_engine(params, cfg, max_len=16, device="cpu",
                                    **_PORTED_SPEC)
    for g, w in zip(speculative(prompts, 4), want):
        assert torch.equal(g, w)
    # the shared store serves beside the prefix index, tokens unchanged
    cdn = make_serve_engine(params, cfg, max_len=16, device="cpu",
                            share_prefix=True, shared_store=WarmChainStore(
                                cfg, 8, block_size=16, device="cpu"))
    for g, w in zip(cdn(prompts, 4), want):
        assert torch.equal(g, w)
    assert set(engine_kw) <= set(inspect.signature(
        make_serve_engine).parameters)
    cached = make_serve_engine(params, cfg, max_len=16, device="cpu",
                               aot_cache=str(tmp_path))
    try:
        st = cached.warm(slots=4, prompt_lens=[len(p) for p in prompts],
                         n_new=4)
        assert st["misses"] == st["registered"] >= 1 and not st["errors"]
        for g, w in zip(cached(prompts, 4), want):
            assert torch.equal(g, w)
    finally:
        cached.aot_cache.deactivate()
    with pytest.raises(TypeError):
        base(prompts, 4, aging=None)      # make_serve_engine's, not run's
    with pytest.raises(TypeError):
        make_serve_engine(params, cfg, max_len=16, device="cpu", rng=None)


@pytest.mark.parametrize("paged_kernel", ["auto", "on", "off"])
def test_int8_engine_matches_solo_int8_decode_and_jax_engine(paged_kernel):
    """The full int8 serving stack composes with batching: the engine
    quantises the same rows at the same positions as a solo int8-cache
    decode, so tokens are IDENTICAL, through every read path — and equal
    the reference's int8 engine on the same weights."""
    jcfg, jp, cfg, params, prompts = _setup(n=4, seed=11, n_kv_heads=2,
                                            rope=True)
    engine = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                               cache_dtype="int8",
                               paged_kernel=paged_kernel, device="cpu")
    got = engine(prompts, 5, slots=2)
    solo = [greedy_decode(params, torch.from_numpy(p)[None], 5, cfg,
                          cache_dtype="int8", device="cpu")[0]
            for p in prompts]
    want = jax_engine(jp, jcfg, max_len=16, kv_block=4, cache_dtype="int8")(
        [jnp.asarray(p) for p in prompts], 5, slots=2)
    for g, s, w in zip(got, solo, want):
        assert torch.equal(g, s)
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the int8 pool keeps the 256-row grain: one table spans 256 rows
    assert engine.last_stats["kv"]["dense_rows"] == 2 * 256


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_phase_split_engine_matches_solo_quantized_decode(cache_dtype):
    """Int8-weight params: admissions from the dequantised tree, waves from
    the int8 tree — at f32 compute dtype tokens EQUAL solo quantised greedy
    decode and the reference's phase-split engine."""
    from nvidia_terraform_modules_tpu.models import quantize as jquant
    from nvidia_terraform_modules_tpu_torch.models import (
        qparams_from_numpy,
        quantize_params,
    )
    from test_torch_int8_matmul import jax_qtree_to_numpy

    jcfg, jp, cfg, params, prompts = _setup(n=4, seed=13, n_kv_heads=2)
    jqp = jquant.quantize_params(jp, dtype=jnp.float32)
    qp = qparams_from_numpy(jax_qtree_to_numpy(jqp), cfg, device="cpu")
    mine = quantize_params(params, dtype=torch.float32)
    assert torch.equal(qp["layers"][0]["up"].q, mine["layers"][0]["up"].q)
    got = make_serve_engine(qp, cfg, max_len=16, kv_block=4,
                            cache_dtype=cache_dtype, device="cpu")(
        prompts, 5, slots=2)
    want = jax_engine(jqp, jcfg, max_len=16, kv_block=4,
                      cache_dtype=cache_dtype)(
        [jnp.asarray(p) for p in prompts], 5, slots=2)
    for p, g, w in zip(prompts, got, want):
        solo = greedy_decode(qp, torch.from_numpy(p)[None], 5, cfg,
                             cache_dtype=cache_dtype, device="cpu")[0]
        assert torch.equal(g, solo)
        assert np.array_equal(g.numpy(), np.asarray(w))
