# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the serve engine's host KV tier (``host_spill``) on the
CPU, against the JAX engine on the same f32 weights and the reference's
template traffic (``tests/test_serving.py``'s ``_template_prompts``: two
9-token templates, ragged suffixes, ``kv_block=4``).

With ``prefix_keep_blocks=0`` every retirement evicts, so the spill path
runs constantly. The spilling engine's tokens must EQUAL the JAX spilling
engine's, the port's engine without the tier and solo greedy decoding —
at slots 1 and 2, async and sync swaps, f32 and int8 caches — and its
``last_stats["prefix"]["spill"]`` counts (all but the host-clock
``swap_ms``) the JAX engine's. The compositions of the reference's tests
(sampled, chunked prefill, lazy growth at a tight pool, ``spec_k``) hold
the same. A byte flipped in a stored host block ends in the classified
drop: ``corrupt_dropped == 1``, the tokens unchanged. The keywords refuse
as the reference's do; the fleet's keywords still raise their
``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import hostkv as jhostkv
from nvidia_terraform_modules_tpu.models.serving import (
    make_serve_engine as jax_engine,
)
from nvidia_terraform_modules_tpu_torch.models import (
    AdmissionSource,
    BurnInConfig,
    WarmChainStore,
    greedy_decode,
    hostkv,
    make_serve_engine,
    params_from_numpy,
)

CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
           seq_len=16, batch=2)
BUDGETS = [3, 4, 2, 4, 3, 2]
SPILL = dict(kv_block=4, share_prefix=True, prefix_keep_blocks=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors on a shared CPU: one intra-op thread a process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    """``(jcfg, jp, cfg, params, prompts)``: the reference's weights and
    template prompts, and the port's copies."""
    jcfg = jburnin.BurnInConfig(**CFG, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = BurnInConfig(**CFG, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    tmpl = [jax.random.randint(jax.random.PRNGKey(90 + i), (9,), 0, 64)
            for i in range(2)]
    prompts = [np.array(jnp.concatenate([
        tmpl[i % 2], jax.random.randint(jax.random.PRNGKey(50 + i),
                                        (2 + i % 3,), 0, 64)]))
        for i in range(6)]
    return jcfg, jp, cfg, params, prompts


def max_len_of(prompts, budgets, extra=0):
    return max(len(p) + n for p, n in zip(prompts, budgets)) + extra


def counts(stats) -> dict:
    """The spill record without its host-clock time."""
    return {k: v for k, v in stats["prefix"]["spill"].items()
            if k != "swap_ms"}


def pair(model, engine_kw, run_kw, n_new=BUDGETS, slots=2):
    """The JAX and the port's spilling engines on the template traffic:
    ``(port tokens, port stats, JAX tokens, JAX stats)``."""
    jcfg, jp, cfg, params, prompts = model
    jeng = jax_engine(jp, jcfg, host_spill=True, **SPILL, **engine_kw)
    jrun = dict(run_kw)
    if "rng" in jrun:
        jrun["rng"] = jax.random.PRNGKey(jrun["rng"])
    want = jeng([jnp.asarray(p) for p in prompts], n_new, slots=slots,
                **jrun)
    eng = make_serve_engine(params, cfg, host_spill=True, device="cpu",
                            **SPILL, **engine_kw)
    got = eng(prompts, n_new, slots=slots, **run_kw)
    return ([t.tolist() for t in got], eng.last_stats,
            [np.asarray(t).tolist() for t in want], jeng.last_stats)


def port_plain(model, engine_kw, run_kw, n_new=BUDGETS, slots=2):
    """The port's engine on the same traffic without the tier."""
    _, _, cfg, params, prompts = model
    eng = make_serve_engine(params, cfg, device="cpu", **SPILL, **engine_kw)
    return [t.tolist() for t in eng(prompts, n_new, slots=slots, **run_kw)]


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("host_swap", ["async", "sync"])
@pytest.mark.parametrize("slots", [1, 2])
def test_spilling_engine_equals_jax_engine_and_solo(model, slots, host_swap,
                                                    cache_dtype):
    """THE tiered-KV gate: tokens equal the JAX spilling engine's, the
    engine without the tier and solo greedy decoding (the int8 cache's:
    solo int8-cache decoding); spill counts equal the JAX engine's; real
    spill traffic (sequential repeats come back through the host tier at
    slots 1), no corrupt drop, both pools drained."""
    _, _, cfg, params, prompts = model
    max_len = max_len_of(prompts, BUDGETS)
    kw = dict(max_len=max_len, host_swap=host_swap, cache_dtype=cache_dtype)
    got, st, want, jst = pair(model, kw, {}, slots=slots)
    assert got == want
    assert got == port_plain(model, dict(max_len=max_len,
                                         cache_dtype=cache_dtype), {},
                             slots=slots)
    assert counts(st) == counts(jst)
    sp = st["prefix"]["spill"]
    assert sp["enabled"] and sp["spilled_blocks"] > 0
    assert sp["swapins"] > 0 and sp["host_hit_blocks"] > 0
    assert sp["swap_tokens_saved"] > 0 and sp["swap_ms"] >= 0.0
    assert sp["corrupt_dropped"] == 0
    assert st["kv"]["in_use"] == 0 and sp["host_in_use"] == 0
    assert sp["host_high_water"] > 0 and sp["host_blocks"] == 64
    assert {k: v for k, v in st["prefix"].items() if k != "spill"} == \
        {k: v for k, v in jst["prefix"].items() if k != "spill"}
    if slots == 1:
        for p, n, g in zip(prompts, BUDGETS, got):
            solo = greedy_decode(params, torch.from_numpy(p)[None].long(), n,
                                 cfg, max_len=max_len,
                                 cache_dtype=cache_dtype, device="cpu")[0]
            assert g == solo.tolist()


COMPOSED = {
    # (engine keywords, run keywords, budgets, max_len extra)
    "sampled": ({"sampler": {"temperature": 5.0}}, {"rng": 7}, 5, 5),
    "chunked": ({"prefill_chunk": 3}, {}, BUDGETS, 4),
    "lazy_tight": ({"lazy_growth": True}, {"tight": True},
                   [3, 6, 2, 5, 4, 3], 0),
    "spec_k": ({"spec_k": 2}, {}, [3, 6, 2, 5, 4, 3], 2),
}


@pytest.mark.parametrize("name", sorted(COMPOSED))
def test_spill_composes_with_the_levers(model, name):
    """Sampled (request, position) draws over swapped-in blocks, chunked
    admission past the swap-restored coverage, reclaims at a tight pool
    that fund admissions by spilling, and ``spec_k`` over swapped-in
    chains: tokens and spill counts equal the JAX engine's, tokens the
    port's engine's without the tier."""
    _, _, cfg, params, prompts = model
    engine_kw, run_kw, n_new, extra = COMPOSED[name]
    engine_kw, run_kw = dict(engine_kw), dict(run_kw)
    budgets = n_new if isinstance(n_new, list) else [n_new] * len(prompts)
    max_len = max_len_of(prompts, budgets, extra)
    if run_kw.pop("tight", False):
        run_kw["kv_blocks"] = 1 + -(-max_len // 4) + 2
    if "sampler" in engine_kw:
        from nvidia_terraform_modules_tpu.models.decode import make_sampler
        from nvidia_terraform_modules_tpu_torch.models import (
            make_sampler as port_sampler,
        )
    kw = dict(engine_kw, max_len=max_len)
    jkw = dict(kw)
    if "sampler" in kw:
        jkw["sampler"] = make_sampler(**kw["sampler"])
        kw["sampler"] = port_sampler(**kw["sampler"])
    slots = 1 if name == "sampled" else 2
    jcfg, jp, _, _, _ = model
    jeng = jax_engine(jp, jcfg, host_spill=True, **SPILL, **jkw)
    jrun = dict(run_kw)
    if "rng" in jrun:
        jrun["rng"] = jax.random.PRNGKey(jrun["rng"])
    want = [np.asarray(t).tolist() for t in jeng(
        [jnp.asarray(p) for p in prompts], n_new, slots=slots, **jrun)]
    eng = make_serve_engine(params, cfg, host_spill=True, device="cpu",
                            **SPILL, **kw)
    got = [t.tolist() for t in eng(prompts, n_new, slots=slots, **run_kw)]
    assert got == want
    assert counts(eng.last_stats) == counts(jeng.last_stats)
    assert got == port_plain(model, kw, run_kw, n_new=n_new, slots=slots)
    st = eng.last_stats
    assert st["prefix"]["spill"]["spilled_blocks"] > 0
    assert st["kv"]["in_use"] == 0
    if name == "spec_k":
        assert st["accepted_per_step"] is not None
    if name == "lazy_tight":
        assert st["prefix"]["reclaim_blocked"] == \
            jeng.last_stats["prefix"]["reclaim_blocked"]


@pytest.mark.parametrize("host_swap", ["async", "sync"])
def test_flipped_host_byte_is_a_classified_drop(model, monkeypatch,
                                                host_swap):
    """One byte of the first stored host block flipped after its stamp:
    the next hit on that chain fails its crc (in the synchronous load, or
    in the staged future the admission consumes), the chain is dropped and
    the request prefills from tokens — ``corrupt_dropped == 1`` and every
    token equal to the engine's without the tier."""
    _, _, cfg, params, prompts = model
    store = hostkv.HostBlockPool.store
    planted = []

    def flipping(self, pool, dev_blocks):
        hids = store(self, pool, dev_blocks)
        if hids and not planted:
            self._bufs["k"][0][hids[0]].view(torch.uint8).view(-1)[0] ^= 1
            planted.append(hids[0])
        return hids

    monkeypatch.setattr(hostkv.HostBlockPool, "store", flipping)
    max_len = max_len_of(prompts, BUDGETS)
    eng = make_serve_engine(params, cfg, max_len=max_len, host_spill=True,
                            host_swap=host_swap, device="cpu", **SPILL)
    got = [t.tolist() for t in eng(prompts, BUDGETS, slots=1)]
    sp = eng.last_stats["prefix"]["spill"]
    assert planted and sp["corrupt_dropped"] == 1
    assert got == port_plain(model, dict(max_len=max_len), {}, slots=1)
    assert sp["host_in_use"] == 0 and eng.last_stats["kv"]["in_use"] == 0


def test_spill_validation_defaults_and_unported_keywords(model):
    """``host_spill`` without ``share_prefix``, a bad ``host_blocks`` and a
    bad ``host_swap`` refuse with the reference's messages; the engine
    without the tier bills it disabled, as the JAX engine does; the
    default host pool is ``max(4·prefix_keep_blocks, 64)`` blocks; the
    shared store's refusals are the reference's, the AOT cache still
    names its ROADMAP item, and a source's warm chains seed the tier."""
    jcfg, jp, cfg, params, prompts = model
    for kw in ({"host_spill": True},
               {"share_prefix": True, "host_spill": True, "host_blocks": 0},
               {"share_prefix": True, "host_spill": True,
                "host_swap": "eager"}):
        with pytest.raises(ValueError) as got:
            make_serve_engine(params, cfg, max_len=16, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            jax_engine(jp, jcfg, max_len=16, **kw)
        assert str(got.value) == str(want.value)
    eng = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                            share_prefix=True, device="cpu")
    jeng = jax_engine(jp, jcfg, max_len=16, kv_block=4, share_prefix=True)
    short = [p[:6] for p in prompts[:2]]
    eng(short, 3, slots=2)
    jeng([jnp.asarray(p) for p in short], 3, slots=2)
    assert eng.last_stats["prefix"]["spill"] == \
        jeng.last_stats["prefix"]["spill"]
    assert eng.last_stats["prefix"]["spill"]["enabled"] is False
    tier = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                             share_prefix=True, host_spill=True,
                             prefix_keep_blocks=20, device="cpu")
    assert tier([], 3) == []
    assert tier.last_stats["prefix"]["spill"]["host_blocks"] == 80
    assert tier.last_stats["prefix"]["spill"]["enabled"] is True
    # the shared store refuses beside the private tier and without the
    # index, with the reference's messages; the AOT cache names item 9d
    store = WarmChainStore(cfg, 8, block_size=4, device="cpu")
    jstore = jhostkv.WarmChainStore(jcfg, 8, block_size=4)
    for kw, jkw in (({"shared_store": store}, {"shared_store": jstore}),
                    ({"share_prefix": True, "host_spill": True,
                      "shared_store": store},
                     {"share_prefix": True, "host_spill": True,
                      "shared_store": jstore})):
        with pytest.raises(ValueError) as got:
            make_serve_engine(params, cfg, max_len=16, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            jax_engine(jp, jcfg, max_len=16, **jkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="item 9d"):
        make_serve_engine(params, cfg, max_len=16, device="cpu",
                          aot_cache="dir")

    class WarmSource(AdmissionSource):
        """The requests in order, and one warm chain for the host tier
        (tokens no prompt holds, so it seeds and is never hit)."""

        def __init__(self, n):
            self.left = list(range(n))

        def candidate(self):
            return self.left[0] if self.left else None

        def pop(self, req):
            self.left.remove(req)

        def exhausted(self):
            return not self.left

        def warm_chains(self):
            rows = {k: [torch.zeros((1, 4, cfg.kv_heads, cfg.head_dim))
                        for _ in range(cfg.n_layers)] for k in ("k", "v")}
            return [(((999,) * 4,), rows)]

    base = tier(short, 2)
    got = tier(short, 2, admission=WarmSource(len(short)))
    assert all(torch.equal(got[i], base[i]) for i in range(len(short)))
    warm = tier.last_stats["prefix"]["warm"]
    assert warm["seeded_chains"] == 1 and warm["seeded_blocks"] == 1
    assert tier.last_stats["prefix"]["spill"]["host_in_use"] == 0
