# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the serve engine's scheduler levers on the CPU.

The same numpy-made weights (``params_from_numpy``) and prompts go to the
JAX engine and the port's at f32, lever by lever and composed: the tokens
must be EQUAL (no tolerance), and so must the schedule the host keeps —
waves, admit waves, block accounting, prefix hits — since both run the same
host loop. On top, each lever keeps the reference's own contract: tokens
equal the unlevered engine and solo ``greedy_decode`` (``prefill="dense"``
where chunked or shared-suffix prefill resolves to the dense math).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import serving as jserving
from nvidia_terraform_modules_tpu.utils import traffic as jtraffic
from nvidia_terraform_modules_tpu_torch.models import (
    AdmissionSource,
    BurnInConfig,
    greedy_decode,
    make_serve_engine,
    params_from_numpy,
    serve,
)
from nvidia_terraform_modules_tpu_torch.models import serving as tserving
from nvidia_terraform_modules_tpu_torch.utils import traffic

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


def _template_prompts(vocab, n=6, tmpl_len=9, seed=90):
    """Prompts sharing two 9-token templates with ragged suffixes: the
    templates cover 2 full blocks of 4 rows, so sharing has hits."""
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(0, vocab, size=(tmpl_len,)) for _ in range(2)]
    return [np.concatenate([tmpl[i % 2],
                            rng.integers(0, vocab, size=(2 + i % 3,))])
            .astype(np.int32) for i in range(n)]


def _solo(params, prompts, budgets, cfg, prefix=None, **kw):
    out = []
    for p, n in zip(prompts, budgets):
        full = p if prefix is None else np.concatenate([prefix, p])
        out.append(greedy_decode(params, torch.from_numpy(full)[None].long(),
                                 n, cfg, device="cpu", **kw)[0])
    return out


def _pair(jp, jcfg, params, cfg, prompts, n_new, engine_kw, run_kw=None,
          prefix=None):
    """The same schedule through the JAX engine and the port's: asserts
    equal tokens and returns ``(tokens, port stats, JAX stats)``."""
    run_kw = run_kw or {}
    jkw = dict(engine_kw)
    if prefix is not None:
        jkw["prefix"] = jnp.asarray(prefix)
    jeng = jserving.make_serve_engine(jp, jcfg, **jkw)
    want = jeng([jnp.asarray(p) for p in prompts], n_new, **run_kw)
    eng = make_serve_engine(params, cfg, device="cpu", prefix=prefix,
                            **engine_kw)
    got = eng(prompts, n_new, **run_kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"request {i}"
    return got, eng.last_stats, jeng.last_stats


# the reference's prefix record: "spill" is the host tier's record, all
# zeros without host_spill; "cdn" (the shared store's) and "warm" (warm
# bring-up) are zeros and disabled outside a fleet
_PREFIX_KEYS = ("enabled", "hit_blocks", "prompt_blocks", "hit_frac",
                "tokens_saved", "lookups", "reclaim_blocked", "spill",
                "cdn", "warm")


def _same_schedule(mine, ref):
    """The host's schedule, key for key: waves, tokens emitted, the block
    accounting, the admission order and prefix sharing."""
    assert mine["waves"] == ref["waves"]
    assert mine["generated"] == ref["generated"]
    assert mine["kv"] == ref["kv"]
    assert mine["sched"] == ref["sched"]
    assert mine["prefix"] == {k: ref["prefix"][k] for k in _PREFIX_KEYS}


def _equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"request {i}"


# ------------------------------------------------------- eos_check_every

@pytest.mark.parametrize("every", [2, 3, 8])
def test_eos_check_every_matches_jax_and_per_wave_checks(every):
    """A lagged eos scan retires late but emits the per-wave engine's
    tokens, and the JAX engine's at the same W (5 requests, 2 slots)."""
    jcfg, jp, cfg, params, prompts = _setup(seed=0)
    solo = _solo(params, prompts, [8] * 5, cfg)
    eos = int(solo[0][2])
    per_wave = serve(params, prompts, 8, cfg, slots=2, eos_id=eos,
                     device="cpu")
    assert any(len(w) < 8 for w in per_wave)          # the eos fires
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 8,
                           dict(max_len=16),
                           dict(slots=2, eos_id=eos,
                                eos_check_every=every))
    _equal(got, per_wave)
    _same_schedule(mine, ref)


def test_eos_check_every_first_token_eos():
    """A first-token eos: the per-wave check retires at admission, the
    lagged one by the final truncation — the same tokens either way."""
    jcfg, jp, cfg, params, prompts = _setup(seed=0)
    first = int(_solo(params, prompts[:1], [1], cfg)[0][0])
    want = serve(params, prompts, 8, cfg, slots=2, eos_id=first,
                 device="cpu")
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 8,
                           dict(max_len=16),
                           dict(slots=2, eos_id=first, eos_check_every=4))
    _equal(got, want)
    assert len(got[0]) == 1
    _same_schedule(mine, ref)
    with pytest.raises(ValueError, match="eos_check_every"):
        serve(params, prompts, 4, cfg, slots=2, eos_id=first,
              eos_check_every=0, device="cpu")


# ------------------------------------------------------ admission policy

def test_sjf_matches_jax_and_beats_fifo_turnaround():
    """Bimodal budgets, longs at the head: shortest-job-first admits the
    shorts first, in the JAX engine's order wave for wave, and cuts mean
    and median turnaround without changing a token."""
    jcfg, jp, cfg, params, prompts = _setup(n=6, seed=2)
    budgets = [8, 1, 1, 1, 1, 8]
    fifo, f_mine, f_ref = _pair(jp, jcfg, params, cfg, prompts, budgets,
                                dict(max_len=24), dict(slots=1))
    sjf, s_mine, s_ref = _pair(jp, jcfg, params, cfg, prompts, budgets,
                               dict(max_len=24, policy="sjf"),
                               dict(slots=1))
    _same_schedule(f_mine, f_ref)
    _same_schedule(s_mine, s_ref)
    _equal(sjf, fifo)
    assert s_mine["sched"]["mean_turnaround_waves"] \
        < f_mine["sched"]["mean_turnaround_waves"]
    assert s_mine["sched"]["p50_turnaround_waves"] \
        < f_mine["sched"]["p50_turnaround_waves"]


def test_aging_bound_admits_the_starved_request_as_jax_does():
    jcfg, jp, cfg, params, prompts = _setup(n=6, seed=2)
    budgets = [8, 2, 2, 2, 2, 2]
    _, pure, pure_ref = _pair(jp, jcfg, params, cfg, prompts, budgets,
                              dict(max_len=24, policy="sjf"), dict(slots=1))
    _, aged, aged_ref = _pair(jp, jcfg, params, cfg, prompts, budgets,
                              dict(max_len=24, policy="sjf", aging=2),
                              dict(slots=1))
    _same_schedule(pure, pure_ref)
    _same_schedule(aged, aged_ref)
    assert aged["sched"]["admit_wave_of"][0] \
        < pure["sched"]["admit_wave_of"][0]


def test_priority_lane_matches_jax_and_validation():
    jcfg, jp, cfg, params, prompts = _setup(n=4, seed=4)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 4,
                           dict(max_len=16, policy="priority"),
                           dict(slots=1, priorities=[0.0, 0.0, 5.0, 0.0]))
    _same_schedule(mine, ref)
    assert mine["sched"]["admit_wave_of"][2] == 0     # the lane jumped
    _equal(got, _solo(params, prompts, [4] * 4, cfg))
    eng = make_serve_engine(params, cfg, max_len=16, policy="priority",
                            device="cpu")
    _equal(eng(prompts, 4, slots=1), got)             # no lane: fifo order
    fifo = make_serve_engine(params, cfg, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="priorities"):
        fifo(prompts, 4, slots=1, priorities=[0.0, 0.0, 5.0, 0.0])
    with pytest.raises(ValueError, match="priorities"):
        eng(prompts, 4, slots=1, priorities=[1.0])
    with pytest.raises(ValueError, match="policy"):
        make_serve_engine(params, cfg, max_len=16, policy="wfq",
                          device="cpu")
    with pytest.raises(ValueError, match="aging"):
        make_serve_engine(params, cfg, max_len=16, aging=0, device="cpu")


def test_scheduler_traces_equal_the_reference_scheduler():
    """The port's ``_Sched`` and the reference's, under one call sequence
    of every policy (candidate, pop, tick, requeue): the same requests in
    the same order. ``_Sched`` implements the ``AdmissionSource`` seam,
    whose required hooks the base leaves abstract."""
    lens = [9, 3, 7, 3, 5, 1]
    budgets = [4, 8, 1, 2, 6, 3]
    prompts = [jnp.zeros((n,), jnp.int32) for n in lens]
    prios = [0.0, 2.0, 1.0, 2.0, 0.0, 5.0]
    for policy in ("fifo", "sjf", "priority"):
        for aging in (1, 3, 512):
            pr = prios if policy == "priority" else None
            mine = tserving._Sched(lens, budgets, policy, aging, pr, None,
                                   0.0)
            ref = jserving._Sched(prompts, budgets, policy, aging, pr, None,
                                  0.0)
            trace, want = [], []
            for step in range(14):
                for sched, out in ((mine, trace), (ref, want)):
                    c = sched.candidate()
                    out.append(c)
                    if c is not None and step % 3 != 2:
                        sched.pop(c)
                    if c is not None and step == 4:
                        sched.requeue(c)          # a preemption
                    sched.tick()
                    out.append(list(sched.pending))
            assert trace == want, (policy, aging)
    assert isinstance(mine, AdmissionSource)
    for hook in ("candidate", "exhausted"):
        with pytest.raises(NotImplementedError):
            getattr(AdmissionSource(), hook)()


# ------------------------------------------------------- chunked prefill

@pytest.mark.parametrize("chunk", [1, 3, 4, 16])
def test_chunked_prefill_matches_jax_and_solo(chunk):
    """Chunk sizes that divide, split and exceed the prompts (4/6/8),
    including a final chunk of pure padding."""
    jcfg, jp, cfg, params, prompts = _setup(seed=0, rope=True)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 5,
                           dict(max_len=32, prefill_chunk=chunk),
                           dict(slots=2))
    _same_schedule(mine, ref)
    _equal(got, _solo(params, prompts, [5] * 5, cfg))


def test_chunked_prefill_on_flash_config_equals_dense_solo():
    """On a flash config chunked admission runs the exact dense math: its
    tokens equal a solo decode with ``prefill="dense"``."""
    lens = [7, 8, 9]
    jcfg, jp, cfg, params, prompts = _setup(seed=6, attn="flash",
                                            lens=lens)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 4,
                           dict(max_len=24, prefill_chunk=4),
                           dict(slots=2))
    _same_schedule(mine, ref)
    _equal(got, _solo(params, prompts, [4] * 3, cfg, prefill="dense"))


def test_chunked_prefill_validation():
    _, _, cfg, params, prompts = _setup(n=2)
    with pytest.raises(ValueError, match="prefill_chunk"):
        make_serve_engine(params, cfg, max_len=16, prefill_chunk=0,
                          device="cpu")
    engine = make_serve_engine(params, cfg, max_len=7, prefill_chunk=8,
                               device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        engine(prompts, 1, slots=2)
    tight = make_serve_engine(params, cfg, max_len=7, prefill_chunk=4,
                              device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        tight([np.zeros(4, np.int32), np.zeros(6, np.int32)], 1, slots=1)
    for kw in ({}, {"prefill_chunk": 4}):
        with pytest.raises(ValueError, match="at least one token"):
            serve(params, [np.zeros(0, np.int32)], 3, cfg, slots=1,
                  device="cpu", **kw)


# ------------------------------------------------------- template prefix

@pytest.mark.parametrize("chunk", [None, 4])
def test_template_prefix_matches_jax_and_full_decode(chunk):
    """The template prefills once per run; every request's tokens equal a
    solo decode of ``concat(prefix, prompt)``, alone and chunked. The
    prefix's blocks stay allocated for the run (its pool)."""
    jcfg, jp, cfg, params, prompts = _setup(n=4, seed=8)
    prefix = np.random.default_rng(42).integers(0, cfg.vocab, 6) \
        .astype(np.int32)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 5,
                           dict(max_len=32, prefill_chunk=chunk),
                           dict(slots=2), prefix=prefix)
    _same_schedule(mine, ref)
    _equal(got, _solo(params, prompts, [5] * 4, cfg, prefix=prefix,
                      max_len=32))
    assert mine["kv"]["in_use"] == 1          # the 6 rows' one block of 16


def test_template_prefix_validation():
    _, _, cfg, params, prompts = _setup(n=2)
    with pytest.raises(ValueError, match="prefix"):
        make_serve_engine(params, cfg, max_len=8, prefix=np.zeros(8, int),
                          device="cpu")
    engine = make_serve_engine(params, cfg, max_len=16,
                               prefix=np.zeros(6, int), device="cpu")
    with pytest.raises(ValueError, match="prefix"):
        engine(prompts, 8, slots=2)                   # 6 + len + 8 > 16


# ------------------------------------------------ cross-request sharing

def test_share_prefix_matches_jax_and_unshared():
    """The sharing gate: tokens equal the unshared engine, solo decodes
    and the JAX sharing engine; hits, saved tokens and the block accounting
    equal the JAX engine's; the pool drains (the leak check)."""
    jcfg, jp, cfg, params, _ = _setup(n=0)
    prompts = _template_prompts(cfg.vocab)
    budgets = [3, 6, 2, 5, 4, 3]
    max_len = max(len(p) + n for p, n in zip(prompts, budgets))
    base = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             device="cpu")(prompts, budgets, slots=2)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, budgets,
                           dict(max_len=max_len, kv_block=4,
                                share_prefix=True),
                           dict(slots=2))
    _same_schedule(mine, ref)
    _equal(got, base)
    _equal(got, _solo(params, prompts, budgets, cfg, max_len=max_len))
    assert mine["prefix"]["hit_blocks"] > 0
    assert mine["prefix"]["tokens_saved"] > 0
    assert mine["kv"]["in_use"] == 0


@pytest.mark.parametrize("lever", ["chunks", "template"])
def test_share_prefix_composes_as_jax_does(lever):
    """Sharing with chunked admission (the sweep starts at the first
    unshared token) and under a template prefix (own-block chains start at
    the prefix tail's offset)."""
    jcfg, jp, cfg, params, _ = _setup(n=0)
    prompts = _template_prompts(cfg.vocab)
    budgets = [3, 5, 2, 4, 3, 2]
    max_len = max(len(p) + n for p, n in zip(prompts, budgets)) + 6
    prefix = None
    kw = dict(max_len=max_len, kv_block=4, share_prefix=True)
    if lever == "chunks":
        kw["prefill_chunk"] = 3
    else:
        prefix = np.random.default_rng(42).integers(0, cfg.vocab, 6) \
            .astype(np.int32)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, budgets, kw,
                           dict(slots=2), prefix=prefix)
    _same_schedule(mine, ref)
    assert mine["prefix"]["hit_blocks"] > 0
    _equal(got, _solo(params, prompts, budgets, cfg, prefix=prefix,
                      max_len=max_len))


@pytest.mark.parametrize("keep", [0, 1, 64])
def test_prefix_keep_blocks_retention_matches_jax(keep):
    """The LRU cap on retained blocks: at 0 a retired template frees at
    once (sharing among LIVE requests only), at 64 it is kept; hits follow
    the JAX engine's at each cap, tokens never move."""
    jcfg, jp, cfg, params, _ = _setup(n=0)
    prompts = _template_prompts(cfg.vocab)
    budgets = [3, 4, 2, 4, 3, 2]
    max_len = max(len(p) + n for p, n in zip(prompts, budgets))
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, budgets,
                           dict(max_len=max_len, kv_block=4,
                                share_prefix=True,
                                prefix_keep_blocks=keep),
                           dict(slots=2))
    _same_schedule(mine, ref)
    assert mine["kv"]["in_use"] == 0
    _equal(got, _solo(params, prompts, budgets, cfg, max_len=max_len))
    if keep == 0:
        with pytest.raises(ValueError, match="prefix_keep_blocks"):
            make_serve_engine(params, cfg, max_len=16, device="cpu",
                              prefix_keep_blocks=-1)


# ---------------------------------------------------------- lazy growth

@pytest.mark.parametrize("extra", [2, 3])
def test_lazy_growth_tight_pool_stalls_and_preempts_as_jax_does(extra):
    """Lazy grants on a pool barely above the worst request: slots grow,
    stall when it runs dry, and every stalled request preempts the
    youngest — the JAX engine's schedule exactly, with the eager engine's
    tokens, and the pool drained."""
    jcfg, jp, cfg, params, _ = _setup(n=0)
    prompts = _template_prompts(cfg.vocab)
    budgets = [6] * 6
    max_len = max(len(p) for p in prompts) + 6
    tight = 1 + -(-max_len // 4) + extra
    base = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             device="cpu")(prompts, budgets, slots=2)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, budgets,
                           dict(max_len=max_len, kv_block=4,
                                lazy_growth=True),
                           dict(slots=4, kv_blocks=tight))
    _same_schedule(mine, ref)
    _equal(got, base)
    assert mine["kv"]["blocks_grown_lazy"] > 0
    assert mine["kv"]["in_use"] == 0
    assert mine["sched"]["preempted"] > 0


def test_lazy_growth_with_eos_and_validation():
    jcfg, jp, cfg, params, prompts = _setup(seed=0)
    eos = int(_solo(params, prompts[:1], [8], cfg)[0][2])
    want = serve(params, prompts, 8, cfg, slots=2, eos_id=eos,
                 device="cpu")
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, 8,
                           dict(max_len=16, kv_block=4, lazy_growth=True),
                           dict(slots=2, eos_id=eos))
    _same_schedule(mine, ref)
    _equal(got, want)
    eng = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                            lazy_growth=True, device="cpu")
    with pytest.raises(ValueError, match="lazy_growth"):
        eng(prompts, 8, slots=2, eos_id=eos, eos_check_every=4)


# -------------------------------------------------------------- composed

@pytest.mark.parametrize("lagged", [False, True])
def test_levers_composed_match_jax_and_solo(lagged):
    """``share_prefix`` + ``prefill_chunk`` + ``policy="sjf"`` with eos in
    one engine, with ``lazy_growth`` on a tight pool — or, since lazy
    growth needs per-wave eos checks, with ``eos_check_every=4`` instead:
    the JAX engine's schedule, the unlevered engine's tokens."""
    jcfg, jp, cfg, params, _ = _setup(n=0)
    prompts = _template_prompts(cfg.vocab, n=8)
    budgets = [3, 6, 2, 5, 4, 3, 6, 2]
    max_len = max(len(p) + n for p, n in zip(prompts, budgets)) + 3
    eos = int(_solo(params, prompts[:1], [6], cfg, max_len=max_len)[0][3])
    kw = dict(max_len=max_len, kv_block=4, share_prefix=True,
              prefill_chunk=3, policy="sjf")
    run_kw = dict(slots=3, eos_id=eos)
    if lagged:
        run_kw["eos_check_every"] = 4
    else:
        kw["lazy_growth"] = True
        run_kw["kv_blocks"] = 1 + -(-max_len // 4) + 3
    base = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             device="cpu")(prompts, budgets, slots=3,
                                           eos_id=eos)
    got, mine, ref = _pair(jp, jcfg, params, cfg, prompts, budgets, kw,
                           run_kw)
    _same_schedule(mine, ref)
    _equal(got, base)
    assert mine["prefix"]["hit_blocks"] > 0
    assert mine["kv"]["in_use"] == 0
    if not lagged:
        assert mine["kv"]["blocks_grown_lazy"] > 0


# ---------------------------------------------------------------- serve()

def test_serve_one_shot_matches_jax_serve():
    jcfg, jp, cfg, params, prompts = _setup(seed=10)
    assert serve(params, [], 4, cfg, device="cpu") == []
    for kw in ({}, {"prefill_chunk": 3}, {"kv_block": 4, "kv_blocks": 9},
               {"cache_dtype": "int8"}, {"spec_k": 2}):
        want = jserving.serve(jp, [jnp.asarray(p) for p in prompts],
                              [3, 5, 2, 4, 6], jcfg, slots=2, **kw)
        got = serve(params, prompts, [3, 5, 2, 4, 6], cfg, slots=2,
                    device="cpu", **kw)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), kw


# ----------------------------------------------------------- the traffic

@pytest.mark.parametrize("kind,kw", [
    ("poisson", {}),
    ("diurnal", {"amplitude": 0.8, "period": 30.0}),
    ("spike", {"spike_every": 5.0, "spike_duration": 1.0}),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_trace_copies_equal_the_reference(kind, kw, seed):
    want = jtraffic.make_trace(kind, 12.0, 64, seed, **kw)
    got = traffic.make_trace(kind, 12.0, 64, seed, **kw)
    assert got == want
    assert traffic.trace_summary(got) == jtraffic.trace_summary(want)
    assert traffic.trace_summary([]) == jtraffic.trace_summary([])
    with pytest.raises(ValueError, match="trace kind"):
        traffic.make_trace("weekly", 1.0, 3)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_templates=4, template_len=256, suffix_lo=16, suffix_hi=128,
         vocab=8192, block_size=16),
    dict(working_set_blocks=9, template_len=40, block_size=16, zipf_s=0.7),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_shared_prefix_prompts_copy_equals_the_reference(kw, seed):
    assert traffic.shared_prefix_prompts(16, seed, **kw) == \
        jtraffic.shared_prefix_prompts(16, seed, **kw)
    with pytest.raises(ValueError, match="template_len"):
        traffic.shared_prefix_prompts(2, working_set_blocks=4,
                                      template_len=8, block_size=16)
