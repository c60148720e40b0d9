# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the decode entry points under ``rules`` in gloo worlds
(``_torch_world.py``) against the JAX functions UNSHARDED on the same
weights (reference ``init_params`` → numpy) and prompts, at f32.

Worlds: 2 (``plan_mesh(2, tp=2)``), 4 (``plan_mesh(4, tp=2)``: dp 2 × tp
2) and 4 with ``sp`` 2 (a replicated axis on the decode path) for the
dense model; for MoE, 4 (``plan_mesh(4, ep=2, tp=2)``) and 2
(``plan_mesh(2, ep=2, tp=1)``). Each rank holds its shards and its rows
of a 4-row prompt batch (cut over the data axes). Tokens must EQUAL the
reference's rows — ``greedy_decode``, ``make_decoder`` and
``sample_decode`` (keys as the reference's), each over the f32 and the
int8 cache; ``make_quantized_decoder(cfg, rules)`` with the int8 cache;
``speculative_greedy_decode(rules=)`` and ``make_speculative_decoder(
rules=)`` with the reference's count of verification steps — for MHA,
for grouped-query attention with rope (2 KV heads, which tp 2 divides)
and for one KV head (which it does not: each rank's cache holds it
whole), and for MoE with 2 experts top-1 and 4 experts top-2. The logits
of ``init_cache`` + ``forward_cached(rules=)`` (a prefill, then one T=1
step) must be within 1e-5 of the reference's ``forward``; with int8
weights (``quantize_params(shards, rules=)``: the whole tree's scales,
checked bit for bit against slices of the unsharded quantisation) within
1e-4 of the reference's quantised ``forward_cached``, and a planted fault
— each shard quantised alone — must miss that bound.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_world import run_world

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import decode as jdecode
from nvidia_terraform_modules_tpu.models import quantize as jquant
from nvidia_terraform_modules_tpu.models import speculative as jspec
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    check_serve_rules,
)
from nvidia_terraform_modules_tpu_torch.parallel import (
    build_mesh,
    make_rules,
    plan_mesh,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16, batch=4, attn="dense")
N_NEW, T, BATCH, SEED = 5, 6, 4, 3
TOL, TOL_INT8 = 1e-5, 1e-4
# case → (config changes, the runs beyond greedy_decode and the logits)
CASES = {
    "mha": ({}, ("decoder", "sample", "int8_weights", "spec")),
    "gqa_rope": (dict(n_kv_heads=2, rope=True), ("decoder", "sample")),
    "kv_one": (dict(n_kv_heads=1),
               ("decoder", "int8_weights", "spec", "gathers")),
    # a capacity factor at which the reference's training forward drops no
    # assignment, as the serve path's drop-free capacity never does
    "moe_e2_top1": (dict(n_experts=2, router_top_k=1, capacity_factor=4.0),
                    ("decoder", "spec", "gathers")),
    "moe_e4_top2": (dict(n_experts=4, router_top_k=2, capacity_factor=4.0),
                    ("decoder", "int8_weights")),
}
DENSE = ("mha", "gqa_rope", "kv_one")
MOE = ("moe_e2_top1", "moe_e4_top2")
# world → (ranks, plan_mesh keywords, cases)
WORLDS = {
    "tp2": (2, dict(tp=2), DENSE),
    "dp2xtp2": (4, dict(tp=2), DENSE),
    "sp2xtp2": (4, dict(tp=2, sp=2), ("mha",)),
    "ep2xtp2": (4, dict(tp=2, ep=2), MOE),
    "ep2": (2, dict(tp=1, ep=2), MOE),
}
PAIRS = [(w, c) for w, (_, _, cases) in WORLDS.items() for c in cases]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors on a shared CPU: one intra-op thread a process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _case(name):
    over = CASES[name][0]
    jcfg = jburnin.BurnInConfig(**BASE, **over, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(len(name)), jcfg)
    rng = np.random.default_rng(len(name))
    prompts = rng.integers(0, BASE["vocab"], size=(BATCH, T)).astype(
        np.int32)
    # a repetitive first row, so that speculation accepts drafts
    prompts[0] = np.tile(prompts[0, :2], T // 2)
    return jcfg, jp, prompts


@functools.lru_cache(maxsize=None)
def _want(name, what):
    """The reference's result for ``what``, unsharded, whole batch."""
    jcfg, jp, prompts = _case(name)
    p = jnp.asarray(prompts)
    if what.startswith("greedy_"):          # jax.jit over greedy_decode
        return np.asarray(jdecode.make_decoder(
            jcfg, None, N_NEW, cache_dtype=what.split("_")[1])(jp, p))
    if what.startswith("sample_"):
        return np.asarray(jdecode.sample_decode(
            jp, p, N_NEW, jcfg, jax.random.PRNGKey(SEED), temperature=2.0,
            top_k=40, cache_dtype=what.split("_")[1]))
    if what == "logits":
        return np.asarray(jburnin.forward(jp, p, jcfg))
    jq = jquant.quantize_params(jp, dtype=jnp.float32)
    if what == "int8_logits":
        @jax.jit
        def prefill_and_step(jq, p):
            cache = jdecode.init_cache(jcfg, BATCH, T)
            head, cache = jdecode.forward_cached(jq, p[:, :-1], cache, jcfg)
            last, _ = jdecode.forward_cached(jq, p[:, -1:], cache, jcfg)
            return jnp.concatenate([head, last], axis=1)
        return np.asarray(prefill_and_step(jq, p))
    if what == "int8_weights":
        return np.asarray(jquant.make_quantized_decoder(
            jcfg, None, N_NEW, dtype=jnp.float32, cache_dtype="int8")(jq, p))
    assert what == "spec"
    toks, steps = jspec.speculative_greedy_decode(jp, p[:1], N_NEW, jcfg,
                                                  k=2)
    return np.asarray(toks).tolist(), int(steps)


def _references(name) -> list[str]:
    """The reference results the tests read for case ``name``."""
    runs = CASES[name][1]
    out = ["greedy_bf16", "greedy_int8", "logits"]
    out += ["sample_bf16", "sample_int8"] if "sample" in runs else []
    out += ["int8_logits", "int8_weights"] if "int8_weights" in runs else []
    return out + (["spec"] if "spec" in runs else [])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results; the reference's are computed in this
    process while the worlds run in theirs."""
    jobs = []
    for world, (n, plan, names) in WORLDS.items():
        cases = []
        for name in names:
            jcfg, jp, prompts = _case(name)
            cases.append({"name": name, "cfg": {**BASE, **CASES[name][0]},
                          "params": jax.tree.map(np.asarray, jp),
                          "prompts": prompts, "n_new": N_NEW,
                          "runs": CASES[name][1]})
        jobs.append((world, n, tmp_path_factory.mktemp(world),
                     {"plan": plan, "cases": cases, "seed": SEED}))

    def run_all():
        return {world: run_world("decode_sharded", n, tmp, args,
                                 timeout=150)
                for world, n, tmp, args in jobs}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_all)
        for name in CASES:
            for what in _references(name):
                _want(name, what)
        return future.result()


@pytest.mark.parametrize("world,name", [
    (w, c) for w, c in PAIRS if "gathers" in CASES[c][1]])
def test_decoders_gather_once_a_call(worlds, world, name):
    """Where the cache holds every KV head (one KV head, tp 2),
    ``greedy_decode``, the decoder's graph (its steps run uncaptured on
    the CPU, two calls) and the speculative decoder gather the whole
    ``wk``/``wv`` once a call — 2 leaves a layer — and never in a step;
    the graph's tokens equal the reference's. Under ``ep`` the greedy
    decode's data-sharded rows are gathered over ``ep`` for the experts,
    and the speculative decoder's batch, the same on every rank, never
    is."""
    whole_kv = CASES[name][0].get("n_kv_heads") == 1
    leaves = 2 * BASE["n_layers"] if whole_kv else 0
    for r in worlds[world]:
        lo, hi = r["rows"]
        g = r[name]["gathers"]
        assert g["greedy"]["leaves"] == g["spec"]["leaves"] == leaves
        for toks, calls in g["graph"]:
            assert toks == _want(name, "greedy_bf16")[lo:hi].tolist()
            assert calls["leaves"] == leaves
        assert g["spec"]["rows"] == 0
        assert (g["greedy"]["rows"] > 0) == (r["mesh"].get("ep", 1) > 1)


@pytest.mark.parametrize("world,name", PAIRS)
def test_greedy_and_decoder_equal_reference_rows(worlds, world, name):
    runs = CASES[name][1]
    for r in worlds[world]:
        lo, hi = r["rows"]
        for cache_dtype in ("bf16", "int8"):
            want = _want(name, f"greedy_{cache_dtype}")[lo:hi].tolist()
            assert r[name][f"greedy_{cache_dtype}"] == want, cache_dtype
            if "decoder" in runs:
                assert r[name][f"decoder_{cache_dtype}"] == want, cache_dtype


@pytest.mark.parametrize("world,name", PAIRS)
def test_forward_cached_logits_match_reference(worlds, world, name):
    """A prefill of all but the last token and one T=1 step through
    ``forward_cached(rules=)``, against the reference's ``forward``."""
    want = _want(name, "logits")
    for r in worlds[world]:
        lo, hi = r["rows"]
        np.testing.assert_allclose(r[name]["logits"], want[lo:hi],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world,name", PAIRS)
def test_cache_holds_this_ranks_kv_heads(worlds, world, name):
    """``tp`` divides the KV heads: ``kv / tp`` a rank; it does not (one
    KV head, tp 2): all of them."""
    plan = WORLDS[world][1]
    kv = CASES[name][0].get("n_kv_heads", BASE["n_heads"])
    tp = plan["tp"]
    local = kv // tp if kv % tp == 0 else kv
    for r in worlds[world]:
        lo, hi = r["rows"]
        assert r[name]["cache"] == (hi - lo, T, local,
                                    BASE["d_model"] // BASE["n_heads"])


@pytest.mark.parametrize("world,name",
                         [p for p in PAIRS if "sample" in CASES[p[1]][1]])
def test_sample_decode_equals_reference_rows(worlds, world, name):
    """Each row drawn at its place in the whole batch: the reference's
    keys."""
    for r in worlds[world]:
        lo, hi = r["rows"]
        for cache_dtype in ("bf16", "int8"):
            want = _want(name, f"sample_{cache_dtype}")[lo:hi].tolist()
            assert r[name][f"sample_{cache_dtype}"] == want, cache_dtype


@pytest.mark.parametrize("world,name",
                         [p for p in PAIRS
                          if "int8_weights" in CASES[p[1]][1]])
def test_int8_weights_under_rules_equal_reference(worlds, world, name):
    """``quantize_params(shards, rules=)`` is the slice of the whole tree's
    quantisation; its logits are within 1e-4 of the reference's quantised
    path and ``make_quantized_decoder(cfg, rules)``'s tokens (int8 cache)
    equal the reference's."""
    want_logits = _want(name, "int8_logits")
    want = _want(name, "int8_weights")
    for r in worlds[world]:
        lo, hi = r["rows"]
        assert r[name]["q_is_slice"] is True
        np.testing.assert_allclose(r[name]["int8_logits"],
                                   want_logits[lo:hi], rtol=TOL_INT8,
                                   atol=TOL_INT8)
        assert r[name]["int8_weights"] == want[lo:hi].tolist()


@pytest.mark.parametrize("world,name",
                         [p for p in PAIRS
                          if "int8_weights" in CASES[p[1]][1]
                          and WORLDS[p[0]][1]["tp"] > 1])
def test_planted_per_shard_scales_miss_the_bound(worlds, world, name):
    """The planted fault: each rank quantises its shards alone, so ``wo``,
    ``down`` and ``embed`` carry scales of their own — the int8 parity
    check above must see it."""
    want = _want(name, "int8_logits")
    for r in worlds[world]:
        lo, hi = r["rows"]
        err = np.abs(r[name]["int8_planted_logits"] - want[lo:hi]).max()
        assert err > TOL_INT8, err


@pytest.mark.parametrize("world,name",
                         [p for p in PAIRS if "spec" in CASES[p[1]][1]])
def test_speculative_under_rules_equals_reference(worlds, world, name):
    """Every rank passes the same prompt (the batch of one): tokens and
    verification steps equal the reference's, on every rank, from the
    function and from the decoder."""
    toks, steps = _want(name, "spec")
    assert steps < N_NEW                       # drafts were accepted
    for r in worlds[world]:
        for key in ("spec", "spec_decoder"):
            assert r[name][key] == (toks, steps), key


def test_worlds_meshes(worlds):
    want = {"tp2": {"dp": 1, "sp": 1, "tp": 2},
            "dp2xtp2": {"dp": 2, "sp": 1, "tp": 2},
            "sp2xtp2": {"dp": 1, "sp": 2, "tp": 2},
            "ep2xtp2": {"dp": 1, "ep": 2, "sp": 1, "tp": 2},
            "ep2": {"dp": 1, "ep": 2, "sp": 1, "tp": 1}}
    for world, mesh in want.items():
        for r in worlds[world]:
            assert r["mesh"] == mesh


def test_check_serve_rules_refuses_a_one_process_mesh():
    """A one-process mesh (one CPU named twice or four times) is no longer
    refused on the decode path: the lock-step form (``tp`` members in
    turn, ``sp`` and the data axes replicated) gives the reference's
    tokens — ``greedy_decode`` and ``make_decoder`` over the bf16 and the
    int8 cache, ``sample_decode``, int8 weights through
    ``make_quantized_decoder`` and the speculative decoder's tokens and
    verification steps — for MHA and one KV head (which tp 2 does not
    divide: each member's cache holds it whole) on tp 2, on dp 2 × tp 2,
    and for MoE on ep 2 × tp 2. A ``tp`` that does not divide the heads
    is still a ValueError."""
    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        make_decoder,
        make_quantized_decoder,
        params_from_numpy,
        quantize_params,
        sample_decode,
        speculative_greedy_decode,
    )

    cpu = torch.device("cpu")
    for n, plan, name in ((2, dict(tp=2), "mha"), (2, dict(tp=2), "kv_one"),
                          (4, dict(tp=2), "mha"),
                          (4, dict(tp=2, ep=2), "moe_e4_top2")):
        rules = make_rules(build_mesh(plan_mesh(n, **plan),
                                      devices=[cpu] * n))
        runs = CASES[name][1]
        cfg = BurnInConfig(**BASE, **CASES[name][0], dtype=torch.float32)
        check_serve_rules(rules, cfg)
        _, jp, prompts = _case(name)
        params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
        prompt = torch.from_numpy(prompts).long()
        for cache_dtype in ("bf16", "int8"):
            want = _want(name, f"greedy_{cache_dtype}").tolist()
            assert greedy_decode(params, prompt, N_NEW, cfg, rules,
                                 cache_dtype=cache_dtype,
                                 device=cpu).tolist() == want
            assert make_decoder(cfg, rules, N_NEW, cache_dtype=cache_dtype,
                                device=cpu)(params, prompt).tolist() == want
        if "sample" in runs:
            assert sample_decode(
                params, prompt, N_NEW, cfg, SEED, rules, temperature=2.0,
                top_k=40, device=cpu).tolist() == _want(
                name, "sample_bf16").tolist()
        if "int8_weights" in runs:
            q = quantize_params(params, torch.float32, rules)
            assert make_quantized_decoder(
                cfg, rules, N_NEW, dtype=torch.float32, cache_dtype="int8",
                device=cpu)(q, prompt).tolist() == _want(
                name, "int8_weights").tolist()
        if "spec" in runs:
            toks, steps = speculative_greedy_decode(
                params, prompt[:1], N_NEW, cfg, rules, k=2, device=cpu)
            assert (toks.tolist(), steps) == tuple(_want(name, "spec"))
    bad = BurnInConfig(**{**BASE, "n_heads": 2}, dtype=torch.float32)
    with pytest.raises(ValueError, match="tp = 4 must divide"):
        check_serve_rules(make_rules(build_mesh(
            plan_mesh(4, tp=4), devices=[cpu] * 4)), bad)