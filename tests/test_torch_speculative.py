# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, speculative decoding and speculative serving on the CPU.

Against the reference on the same numpy-made weights at f32, exactly:
``_ngram_draft`` and ``accept_drafts`` on seeded contexts (integers);
``speculative_greedy_decode``'s tokens and its count of verification
forwards; the engine's ``spec_k`` tokens and its schedule statistics
(``waves``, ``slot_steps``, ``accepted_per_step``, the block and scheduler
accounting) for each composition the reference's tests pin
(``tests/test_serving.py:384-480``, ``:1191-1260``). On top, the
reference's contract: the tokens are greedy decode's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import serving as jserving
from nvidia_terraform_modules_tpu.models import speculative as jspec
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    greedy_decode,
    make_serve_engine,
    params_from_numpy,
    serve,
)
from nvidia_terraform_modules_tpu_torch.models import speculative as spec
from nvidia_terraform_modules_tpu_torch.models.decode import make_sampler
from nvidia_terraform_modules_tpu_torch.telemetry import Registry

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=2)


def _setup(seed=0, **over):
    kw = {**BASE, "attn": "dense", **over}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jcfg, jp, cfg, params


def _repetitive(n=5, seed=1):
    """Periodic prompts (``tests/test_serving.py:397``): the bigram
    continuation is usually right, so drafts get accepted."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, 64, size=(3,)), 4)[:8 + i % 3]
            .astype(np.int32) for i in range(n)]


def _template_prompts(vocab, n=6, seed=90):
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(0, vocab, size=(9,)) for _ in range(2)]
    return [np.concatenate([tmpl[i % 2],
                            rng.integers(0, vocab, size=(2 + i % 3,))])
            .astype(np.int32) for i in range(n)]


def _solo(params, prompts, budgets, cfg, prefix=None):
    out = []
    for p, n in zip(prompts, budgets):
        full = p if prefix is None else np.concatenate([prefix, p])
        out.append(greedy_decode(params, torch.from_numpy(full)[None].long(),
                                 n, cfg, device="cpu")[0])
    return out


_STATS = ("waves", "generated", "slot_steps", "accepted_per_step", "kv",
          "sched")


def _pair(jp, jcfg, params, cfg, prompts, n_new, engine_kw, run_kw,
          prefix=None):
    """The JAX engine and the port's, one speculative schedule: equal
    tokens and equal schedule statistics."""
    jkw = dict(engine_kw)
    if prefix is not None:
        jkw["prefix"] = jnp.asarray(prefix)
    jeng = jserving.make_serve_engine(jp, jcfg, **jkw)
    want = jeng([jnp.asarray(p) for p in prompts], n_new, **run_kw)
    eng = make_serve_engine(params, cfg, device="cpu", prefix=prefix,
                            **engine_kw)
    got = eng(prompts, n_new, **run_kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"request {i}"
    mine, ref = eng.last_stats, jeng.last_stats
    for key in _STATS:
        assert mine[key] == ref[key], key
    assert mine["prefix"]["hit_blocks"] == ref["prefix"]["hit_blocks"]
    # a preempted request's steps leave its count (its output is the
    # re-admission's) but stay in the engine's
    assert sum(mine["decode_steps"]) <= mine["slot_steps"]
    if not mine["sched"]["preempted"]:
        assert sum(mine["decode_steps"]) == mine["slot_steps"]
    assert mine["trips"] >= mine["waves"]
    return got, mine


def _equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"request {i}"


# ------------------------------------------------------ the draft core

def test_ngram_draft_equals_reference_on_seeded_contexts():
    """Random short contexts over a 4-token alphabet (many bigram
    matches), every cur_len from 0 to L (no match, cur_len < 3), and the
    batched form over rows."""
    rng = np.random.default_rng(0)
    for _ in range(150):
        length = int(rng.integers(3, 20))
        ctx = rng.integers(0, 4, size=length).astype(np.int32)
        k = int(rng.integers(1, 6))
        for cur in range(length + 1):
            want = np.asarray(jspec._ngram_draft(jnp.asarray(ctx), cur, k,
                                                 3))
            got = spec._ngram_draft(torch.from_numpy(ctx).long(), cur, k, 3)
            assert np.array_equal(got.numpy(), want), (ctx, cur, k)
    ctxs = rng.integers(0, 4, size=(6, 12)).astype(np.int32)
    curs = np.array([0, 1, 2, 5, 9, 12])
    want = np.stack([np.asarray(jspec._ngram_draft(jnp.asarray(c), int(n),
                                                   4, 64))
                     for c, n in zip(ctxs, curs)])
    got = spec._ngram_draft(torch.from_numpy(ctxs).long(),
                            torch.from_numpy(curs), 4, 64)
    assert np.array_equal(got.numpy(), want)


def test_accept_drafts_equals_reference():
    rng = np.random.default_rng(1)
    drafts, preds = [], []
    for _ in range(300):
        k = int(rng.integers(1, 6))
        d = rng.integers(0, 3, size=k)
        p = rng.integers(0, 3, size=k + 1)
        if rng.random() < 0.3:
            p[:k] = d                      # every draft accepted
        a_toks, a_n = jspec.accept_drafts(jnp.asarray(d), jnp.asarray(p))
        b_toks, b_n = spec.accept_drafts(torch.from_numpy(d),
                                         torch.from_numpy(p))
        assert np.array_equal(b_toks.numpy(), np.asarray(a_toks))
        assert int(b_n) == int(a_n)
        if k == 4:
            drafts.append(d)
            preds.append(p)
    b_toks, b_n = spec.accept_drafts(torch.from_numpy(np.stack(drafts)),
                                     torch.from_numpy(np.stack(preds)))
    for i, (d, p) in enumerate(zip(drafts, preds)):
        a_toks, a_n = jspec.accept_drafts(jnp.asarray(d), jnp.asarray(p))
        assert np.array_equal(b_toks[i].numpy(), np.asarray(a_toks))
        assert int(b_n[i]) == int(a_n)


# ------------------------------------------- speculative_greedy_decode

@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_greedy_decode_equals_reference_and_greedy(k):
    jcfg, jp, cfg, params = _setup()
    rng = np.random.default_rng(2)
    prompts = _repetitive(3) + [rng.integers(0, 64, size=(7,)).astype(
        np.int32)]
    for p in prompts:
        want, jsteps = jspec.speculative_greedy_decode(
            jp, jnp.asarray(p)[None], 20, jcfg, k=k)
        got, steps = spec.speculative_greedy_decode(
            params, torch.from_numpy(p)[None], 20, cfg, k=k, device="cpu")
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert steps == int(jsteps)
        assert torch.equal(got, greedy_decode(params, torch.from_numpy(p)[
            None], 20, cfg, device="cpu"))


def test_make_speculative_decoder_and_guards():
    jcfg, jp, cfg, params = _setup()
    p = torch.from_numpy(_repetitive(1)[0])[None]
    dec = spec.make_speculative_decoder(cfg, n_new=12, k=3, device="cpu")
    toks, steps = dec(params, p)
    jt, js = jspec.make_speculative_decoder(jcfg, n_new=12, k=3)(
        jp, jnp.asarray(p.numpy()))
    assert np.array_equal(toks.numpy(), np.asarray(jt))
    assert steps == int(js) and steps < 12
    reg = Registry()
    toks_t, steps_t = spec.make_speculative_decoder(
        cfg, n_new=12, k=3, telemetry=reg, device="cpu")(params, p)
    assert torch.equal(toks_t, toks) and steps_t == steps
    assert reg.counter("spec_verify_steps").value == steps
    with pytest.raises(ValueError, match="batch must be 1"):
        spec.speculative_greedy_decode(params, p.repeat(2, 1), 4, cfg,
                                       device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        spec.speculative_greedy_decode(params, p, 4, cfg, k=0, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        spec.speculative_greedy_decode(params, p, 4, cfg, k=3, max_len=10,
                                       device="cpu")


# --------------------------------------------------------- the engine

@pytest.mark.parametrize("slots", [1, 2, 4])
def test_spec_engine_equals_jax_and_solo_greedy(slots):
    """``tests/test_serving.py:384``: 5 requests, any slot count."""
    jcfg, jp, cfg, params = _setup()
    prompts = _repetitive()
    got, mine = _pair(jp, jcfg, params, cfg, prompts, 6,
                      dict(max_len=24, kv_block=4, spec_k=3),
                      dict(slots=slots))
    _equal(got, _solo(params, prompts, [6] * 5, cfg))


def test_spec_engine_accepts_on_repetitive_prompts():
    """``tests/test_serving.py:397``: periodic prompts, decode steps below
    the tokens generated, accepted_per_step above the plain engine's 1."""
    jcfg, jp, cfg, params = _setup()
    prompts = [np.array(([3, 7, 11] * 4)[:10 + i], np.int32)
               for i in range(3)]
    got, mine = _pair(jp, jcfg, params, cfg, prompts, 8,
                      dict(max_len=64, spec_k=4), dict(slots=2))
    _equal(got, _solo(params, prompts, [8] * 3, cfg))
    assert mine["generated"] == 24
    assert mine["slot_steps"] < mine["generated"] - 3
    assert mine["accepted_per_step"] > 1.0


def test_spec_engine_eos_and_budgets():
    """``tests/test_serving.py:417``: an eos inside an accepted block
    truncates there; per-request budgets cap emission."""
    jcfg, jp, cfg, params = _setup()
    prompts = _repetitive()
    full = _solo(params, prompts, [8] * 5, cfg)
    eos = int(full[0][2])
    got, _ = _pair(jp, jcfg, params, cfg, prompts, [8, 5, 8, 2, 7],
                   dict(max_len=24, kv_block=4, spec_k=3),
                   dict(slots=2, eos_id=eos))
    for g, f, n in zip(got, full, [8, 5, 8, 2, 7]):
        f = f[:n]
        hit = (f == eos).nonzero()
        assert torch.equal(g, f[:int(hit[0]) + 1] if len(hit) else f)


def test_spec_engine_prefix_and_chunking():
    """``tests/test_serving.py:441``: speculation, a template prefix and
    chunked admission (swept in one call) in one engine."""
    jcfg, jp, cfg, params = _setup()
    prompts = _repetitive(3)
    prefix = np.random.default_rng(42).integers(0, 64, size=(6,)).astype(
        np.int32)
    got, _ = _pair(jp, jcfg, params, cfg, prompts, 5,
                   dict(max_len=40, prefill_chunk=4, spec_k=3),
                   dict(slots=2), prefix=prefix)
    _equal(got, _solo(params, prompts, [5] * 3, cfg, prefix=prefix))


def test_spec_engine_int8_pool_and_weights():
    """``tests/test_serving.py:458``: the int8 pool's spec tokens equal the
    plain int8 engine's; int8 weights verify through the int8 product
    (M = slots x (k + 1)) and equal the JAX engine's."""
    from nvidia_terraform_modules_tpu.models import quantize as jquantize
    from nvidia_terraform_modules_tpu_torch.models import qparams_from_numpy
    from test_torch_int8_matmul import jax_qtree_to_numpy

    jcfg, jp, cfg, params = _setup()
    prompts = _repetitive(3)
    got, _ = _pair(jp, jcfg, params, cfg, prompts, 5,
                   dict(max_len=24, cache_dtype="int8", spec_k=3),
                   dict(slots=2))
    _equal(got, serve(params, prompts, 5, cfg, slots=2, cache_dtype="int8",
                      device="cpu"))
    jq = jquantize.quantize_params(jp, dtype=jnp.float32)
    qp = qparams_from_numpy(jax_qtree_to_numpy(jq), cfg, device="cpu")
    _pair(jq, jcfg, qp, cfg, prompts, 5, dict(max_len=24, spec_k=3),
          dict(slots=2))


def test_spec_engine_share_prefix_and_lazy_growth():
    """``tests/test_serving.py:1191``: sharing and lazy growth compose with
    speculation: the plain spec engine's tokens and solo greedy's, both
    levers engaged, the pool drained."""
    jcfg, jp, cfg, params = _setup()
    prompts = _template_prompts(cfg.vocab)
    budgets = [3, 6, 2, 5, 4, 3]
    k = 2
    max_len = max(len(p) + n for p, n in zip(prompts, budgets)) + k
    want = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             spec_k=k, device="cpu")(prompts, budgets,
                                                     slots=2)
    got, mine = _pair(jp, jcfg, params, cfg, prompts, budgets,
                      dict(max_len=max_len, kv_block=4, spec_k=k,
                           share_prefix=True, lazy_growth=True),
                      dict(slots=2))
    _equal(got, want)
    _equal(got, _solo(params, prompts, budgets, cfg))
    assert mine["prefix"]["hit_blocks"] > 0
    assert mine["kv"]["blocks_grown_lazy"] > 0 and mine["kv"]["in_use"] == 0


def test_spec_engine_lazy_growth_tight_pool_stalls_and_preempts():
    """``tests/test_serving.py:1221``: a pool barely above the worst
    request stalls and preempts; the preempted requests regenerate the
    same tokens, on the JAX engine's schedule."""
    jcfg, jp, cfg, params = _setup()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, size=(4 + (i % 3) * 2,)).astype(np.int32)
               for i in range(5)]
    n_new, k = 6, 2
    want = serve(params, prompts, n_new, cfg, slots=2, spec_k=k,
                 device="cpu")
    worst = max(len(p) for p in prompts) + n_new + k
    got, mine = _pair(jp, jcfg, params, cfg, prompts, n_new,
                      dict(max_len=16 + k, kv_block=4, spec_k=k,
                           lazy_growth=True),
                      dict(slots=2, kv_blocks=1 + -(-worst // 4) + 1))
    _equal(got, want)
    assert mine["kv"]["blocks_grown_lazy"] > 0
    assert mine["sched"]["preempted"] > 0
    assert mine["kv"]["in_use"] == 0


def test_spec_engine_share_prefix_with_chunked_prefill():
    """``tests/test_serving.py:1246``: the chunked spec admission under
    sharing prefills only the unshared suffix."""
    jcfg, jp, cfg, params = _setup()
    prompts = _template_prompts(cfg.vocab)
    budgets = [3, 5, 2, 4, 3, 2]
    want = make_serve_engine(params, cfg, max_len=20, kv_block=4, spec_k=2,
                             prefill_chunk=4, device="cpu")(
        prompts, budgets, slots=2)
    got, mine = _pair(jp, jcfg, params, cfg, prompts, budgets,
                      dict(max_len=20, kv_block=4, spec_k=2,
                           prefill_chunk=4, share_prefix=True),
                      dict(slots=2))
    _equal(got, want)
    assert mine["prefix"]["hit_blocks"] > 0


def test_spec_engine_n_new_one_and_refusals():
    """``tests/test_serving.py:476``, and the port's refusals."""
    jcfg, jp, cfg, params = _setup()
    prompts = _repetitive(3)
    got = serve(params, prompts, 1, cfg, slots=2, spec_k=3, device="cpu")
    for g, w in zip(got, _solo(params, prompts, [1] * 3, cfg)):
        assert g.shape == (1,) and torch.equal(g, w)
    with pytest.raises(ValueError, match="spec_k"):
        make_serve_engine(params, cfg, max_len=16, spec_k=0, device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        make_serve_engine(params, cfg, max_len=16, spec_k=2, device="cpu",
                          sampler=make_sampler(temperature=2.0))
    engine = make_serve_engine(params, cfg, max_len=12, spec_k=4,
                               device="cpu")
    with pytest.raises(ValueError, match="headroom"):
        engine(prompts, 4, slots=2)             # 10 + 4 + 4 > 12
    engine = make_serve_engine(params, cfg, max_len=24, spec_k=2,
                               device="cpu")
    with pytest.raises(ValueError, match="eos_check_every"):
        engine(prompts, 4, slots=2, eos_id=3, eos_check_every=2)
    with pytest.raises(ValueError, match="static_batching"):
        engine(prompts, 4, slots=2, static_batching=True)


def test_spec_trip_after_the_loop_ends_changes_nothing():
    """One replayed trip is one test and one body of the reference's
    loop, the body gated on the test: once the test fails, a further trip
    leaves the context, the counts, the report and every pool row outside
    the garbage block as they were."""
    from nvidia_terraform_modules_tpu_torch.models import init_paged_cache

    _, _, cfg, params = _setup()
    engine = make_serve_engine(params, cfg, max_len=24, kv_block=4,
                               spec_k=3, device="cpu")
    pool = init_paged_cache(cfg, 2, 24, block_size=4, num_blocks=13,
                            device="cpu")
    pool["block_tables"][0] = torch.arange(1, 7, dtype=torch.int32)
    pool["block_tables"][1] = torch.arange(7, 13, dtype=torch.int32)
    graph = engine.capture(pool, on_card=False)
    st = graph.state
    prompt = torch.tensor([3, 7, 11, 3, 7, 11, 3, 7])
    for slot in range(2):
        st.ctx[slot, :8] = prompt
        st.ctx[slot, 8] = 11
        st.cur[slot] = 9
        pool["pos"][slot] = 8
    st.n_out.fill_(1)
    st.active.fill_(True)
    st.n_new.copy_(torch.tensor([6, 9]))
    st.granted.fill_(24)
    st.eos.fill_(-1)
    st.stop.fill_(2)
    report = graph.multi_step()
    assert report[0].tolist() == [1, 1] and report[1].tolist() == [6, 9]
    assert int(report[5, 0]) == 0
    before = ([t.clone() for t in (st.ctx, st.cur, st.n_out, st.fin,
                                   st.steps, st.report, pool["pos"])],
              [t[1:].clone() for t in pool["k"] + pool["v"]])
    graph.replay()
    after = ([st.ctx, st.cur, st.n_out, st.fin, st.steps, st.report,
              pool["pos"]], [t[1:] for t in pool["k"] + pool["v"]])
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)
