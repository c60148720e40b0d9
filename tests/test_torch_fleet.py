# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the fleet router (``models/fleet.py``) on the CPU, against
the JAX package on the reference's own configs (``tests/test_fleet.py``).

Placement is scheduling, never a different model: whatever the placement —
one replica, affinity or random routing, stolen requests, the
disaggregated prefill→decode handoff, arrival gating, eos, a sampled
engine — every served request's tokens EQUAL the JAX single engine's on
the same f32 weights and the port's solo greedy decode. Routing itself is
held to the JAX fleet's: each request's replica, the affinity-routed
fraction and the SLO shed set are equal, and ``affinity_key`` /
``HashRing`` targets are the reference's byte for byte. Counts that depend
on thread timing (steals) are held by their invariants. The engine's
``run(admission=)`` seam and ``prefill_session`` are covered here too:
a ``kv_import`` admission runs no prefill, and the elastic plane's and
the AOT cache's keywords raise ``NotImplementedError`` naming ROADMAP
items 9c and 9d. Each JAX reference is computed once (``lru_cache``).
"""

import dataclasses
import functools
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import fleet as jfleet
from nvidia_terraform_modules_tpu.models.serving import (
    make_serve_engine as jax_engine,
)
from nvidia_terraform_modules_tpu.utils import traffic as jtraffic
from nvidia_terraform_modules_tpu_torch.models import (
    AdmissionSource,
    BurnInConfig,
    greedy_decode,
    make_fleet,
    make_sampler,
    make_serve_engine,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.models import fleet as pfleet
from nvidia_terraform_modules_tpu_torch.models import serving as pserving
from nvidia_terraform_modules_tpu_torch.telemetry import Registry
from nvidia_terraform_modules_tpu_torch.utils import traffic

CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
           seq_len=16, batch=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors on a shared CPU: one intra-op thread a process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(jcfg_kw, jp):
    cfg = BurnInConfig(**jcfg_kw, dtype=torch.float32)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")


@functools.lru_cache(maxsize=None)
def _setup():
    """``tests/test_fleet.py``'s ``_setup``: six ragged prompts."""
    jcfg = jburnin.BurnInConfig(**CFG, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(0), jcfg)
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    prompts = tuple(np.asarray(jax.random.randint(
        k, (4 + (i % 3) * 2,), 0, jcfg.vocab)) for i, k in enumerate(keys))
    cfg, params = _port(CFG, jp)
    return jcfg, jp, cfg, params, prompts


@functools.lru_cache(maxsize=None)
def _zipf_setup(n=10):
    """``_zipf_setup``: the shared-template Zipf workload."""
    kw = {**CFG, "seq_len": 32}
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(2), jcfg)
    pairs = traffic.shared_prefix_prompts(n, seed=0, n_templates=3,
                                          template_len=8, suffix_lo=1,
                                          suffix_hi=4, vocab=jcfg.vocab)
    prompts = tuple(np.asarray(p, np.int32) for _t, p in pairs)
    max_len = max(len(p) for p in prompts) + 5
    cfg, params = _port(kw, jp)
    return jcfg, jp, cfg, params, prompts, max_len


@functools.lru_cache(maxsize=None)
def _jax_tokens(which: str, n_new: int, max_len: int, sampled=False):
    """The JAX single engine's tokens on a setup (greedy, or the
    reference test's sampler at ``PRNGKey(7)``)."""
    s = _setup() if which == "setup" else _zipf_setup()
    jcfg, jp, prompts = s[0], s[1], s[4]
    kw = {"sampler": jax_sampler()} if sampled else {}
    run = {"rng": jax.random.PRNGKey(7)} if sampled else {}
    outs = jax_engine(jp, jcfg, max_len=max_len, kv_block=4, **kw)(
        [jnp.asarray(p) for p in prompts], n_new, slots=2, **run)
    return tuple(tuple(int(t) for t in np.asarray(o)) for o in outs)


def jax_sampler():
    from nvidia_terraform_modules_tpu.models import make_sampler as jms

    return jms(temperature=0.8, top_k=4)


def _solo(params, prompts, n_new, cfg):
    return [greedy_decode(params, torch.tensor(np.asarray(p))[None],
                          n_new, cfg, device="cpu")[0].tolist()
            for p in prompts]


def _tokens(outs):
    return [None if o is None else o.tolist() for o in outs]


def _assert_all_equal(got, want, label=""):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None, f"{label} request {i} unserved"
        assert list(g) == list(w), f"{label} request {i} diverged"


# ------------------------------------------------------------- exactness


def test_fleet_single_replica_bit_matches_bare_engine_tier1():
    """One replica: each request equals the bare engine's, the JAX
    engine's and solo greedy; the pool drains."""
    _, _, cfg, params, prompts = _setup()
    want = _solo(params, prompts, 6, cfg)
    bare = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                             device="cpu")
    fleet = make_fleet(params, cfg, max_len=16, replicas=1, kv_block=4)
    got = _tokens(fleet(prompts, 6, slots=2))
    _assert_all_equal(got, _tokens(bare(prompts, 6, slots=2)), "bare:")
    _assert_all_equal(got, _jax_tokens("setup", 6, 16), "jax:")
    _assert_all_equal(got, want, "solo:")
    st = fleet.last_stats["fleet"]
    assert st["served"] == len(prompts) and st["shed"] == 0
    assert fleet.last_stats["replica_stats"][0]["kv"]["in_use"] == 0


@functools.lru_cache(maxsize=None)
def _jax_routing(routing: str):
    """The JAX fleet's placement of the Zipf trace (2 replicas, no
    steals): ``routed_to`` and ``affinity_routed_frac``."""
    jcfg, jp, _, _, prompts, max_len = _zipf_setup()
    fl = jfleet.make_fleet(jp, jcfg, max_len=max_len, replicas=2,
                           kv_block=4, share_prefix=True, routing=routing,
                           steal=False)
    fl([jnp.asarray(p) for p in prompts], 5, slots=2)
    st = fl.last_stats["fleet"]
    return st["routed_to"], st["affinity_routed_frac"]


@pytest.mark.parametrize("routing", ["affinity", "random"])
def test_fleet_routing_places_as_the_jax_fleet_and_stays_exact(routing):
    """Affinity and seeded-random routing on the Zipf trace: every request
    equals the JAX engine and solo greedy whatever its replica, and each
    request's replica and the affinity-routed fraction equal the JAX
    fleet's."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    fleet = make_fleet(params, cfg, max_len=max_len, replicas=2,
                       kv_block=4, share_prefix=True, routing=routing,
                       steal=False)
    got = _tokens(fleet(prompts, 5, slots=2))
    _assert_all_equal(got, _jax_tokens("zipf", 5, max_len), routing)
    _assert_all_equal(got, _solo(params, prompts, 5, cfg), routing)
    st = fleet.last_stats["fleet"]
    routed_to, frac = _jax_routing(routing)
    assert st["routed_to"] == routed_to
    assert st["affinity_routed_frac"] == frac


def test_fleet_affinity_routing_earns_hits_over_random():
    """Affinity beats seeded-random placement on the prefix hit fraction
    (the reference's acceptance bar)."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    hit = {}
    for routing in ("affinity", "random"):
        fleet = make_fleet(params, cfg, max_len=max_len, replicas=2,
                           kv_block=4, share_prefix=True, routing=routing,
                           steal=False)
        fleet(prompts, 5, slots=2)
        hit[routing] = fleet.last_stats["fleet"]["affinity_hit_frac"]
    assert hit["affinity"] > 0
    assert hit["affinity"] > hit["random"], hit


def test_fleet_disaggregated_bit_matches_colocated_and_solo():
    """Prefill workers hand paged blocks to decode workers: the outputs
    equal the colocated fleet's, the JAX engine's and solo greedy; the
    prefill side's index shares templates; the decode pools drain."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    colo = make_fleet(params, cfg, max_len=max_len, replicas=2, kv_block=4,
                      share_prefix=True, steal=False)
    want_colo = _tokens(colo(prompts, 5, slots=2))
    dis = make_fleet(params, cfg, max_len=max_len, replicas=3, kv_block=4,
                     share_prefix=True, disaggregate=True,
                     prefill_workers=1, steal=False)
    got = _tokens(dis(prompts, 5, slots=2))
    _assert_all_equal(got, want_colo, "vs colocated:")
    _assert_all_equal(got, _jax_tokens("zipf", 5, max_len), "vs jax:")
    st = dis.last_stats["fleet"]
    assert st["mode"] == "disaggregated" and st["prefill_workers"] == 1
    assert {r["role"] for r in st["per_replica"]} == {"prefill", "decode"}
    pre = [r for r in st["per_replica"] if r["role"] == "prefill"]
    assert sum(r["requests"] for r in pre) == len(prompts)
    assert st["affinity_hit_frac"] > 0
    for rs in dis.last_stats["replica_stats"]:
        assert rs["kv"]["in_use"] == 0


def test_fleet_workers_record_their_prefills_and_imports():
    """Each worker's own records: the engine counts its flash prefills
    (the prompts whose prefill choice is flash) and the ms from the call's
    start to each retirement; a disaggregated decode worker's admissions
    are all imports and none of them a prefill, the prefill workers count
    the flash ones; the device ms of exports and imports are None off the
    card."""
    from nvidia_terraform_modules_tpu_torch.models.decode import (
        _select_prefill_impl,
    )

    _, _, cfg, params, prompts = _setup()
    cfg = dataclasses.replace(cfg, attn="flash")
    n_flash = sum(_select_prefill_impl(cfg, len(p), "auto",
                                       torch.device("cpu")) == "flash"
                  for p in prompts)
    assert 0 < n_flash < len(prompts)
    eng = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                            device="cpu")
    eng([torch.tensor(p) for p in prompts], 6, slots=2)
    st = eng.last_stats
    assert st["flash_prefills"] == n_flash
    assert st["kv_imports"] == 0 and st["import_ms"] is None
    done, lat = st["retired_ms"], st["latency_ms"]
    assert 0 < done["p50"] <= done["p99"] <= done["max"]
    assert done["max"] >= lat["max"]
    dis = make_fleet(params, cfg, max_len=16, replicas=3, kv_block=4,
                     disaggregate=True, prefill_workers=1, steal=False)
    dis(prompts, 6, slots=2)
    workers = dis.last_stats["fleet"]["per_replica"]
    pre = [r for r in workers if r["role"] == "prefill"]
    dec = [r for r in workers if r["role"] == "decode"]
    assert sum(r["flash_prefills"] for r in pre) == n_flash
    assert all(r["export_ms"] is None for r in pre)
    assert sum(r["kv_imports"] for r in dec) == len(prompts)
    for r in dec:
        assert r["flash_prefills"] == 0 and r["import_ms"] is None
        assert r["kv_imports"] == r["requests"]


@functools.lru_cache(maxsize=None)
def _slo_trace():
    n = len(_setup()[4])
    arrivals = traffic.poisson_trace(500.0, n, seed=4)
    budgets = [6] * n
    deadlines = traffic.slo_deadlines(budgets, seed=5, base_s=0.08,
                                      per_token_s=0.01, jitter=0.2)
    return arrivals, budgets, deadlines


@functools.lru_cache(maxsize=None)
def _jax_shed():
    jcfg, jp, _, _, prompts = _setup()
    arrivals, budgets, deadlines = _slo_trace()
    fl = jfleet.make_fleet(jp, jcfg, max_len=16, replicas=1, kv_block=4,
                           est_token_s=0.02)
    fl([jnp.asarray(p) for p in prompts], budgets, slots=2,
       arrivals=arrivals, deadlines=deadlines)
    return fl.last_stats["fleet"]["shed_requests"]


def test_fleet_slo_shedding_is_deterministic_and_partial():
    """Deadline admission: the shed set is the JAX fleet's, a strict
    non-empty subset, ``None`` at exactly its indexes, the rest solo
    exact, attainment billed; a replay sheds the same set."""
    _, _, cfg, params, prompts = _setup()
    n = len(prompts)
    arrivals, budgets, deadlines = _slo_trace()
    fleet = make_fleet(params, cfg, max_len=16, replicas=1, kv_block=4,
                       est_token_s=0.02)
    got = fleet(prompts, budgets, slots=2, arrivals=arrivals,
                deadlines=deadlines)
    st = fleet.last_stats["fleet"]
    assert st["shed_requests"] == _jax_shed()
    assert 0 < st["shed"] < n, st
    assert all(got[r] is None for r in st["shed_requests"])
    want = _solo(params, prompts, 6, cfg)
    for req in range(n):
        if req not in st["shed_requests"]:
            assert got[req].tolist() == want[req], req
    assert st["deadline_attainment"] is not None
    assert st["served"] + st["shed"] == n
    fleet(prompts, budgets, slots=2, arrivals=arrivals, deadlines=deadlines)
    assert fleet.last_stats["fleet"]["shed_requests"] == st["shed_requests"]


def _one_template(seed, n, lens):
    """``n`` prompts on one 4-token template (the reference's keys)."""
    tmpl = jax.random.randint(jax.random.PRNGKey(seed), (4,), 0, 64)
    return [np.asarray(jnp.concatenate(
        [tmpl, jax.random.randint(jax.random.PRNGKey(lens[0] + i),
                                  (1 + i % lens[1],), 0, 64)]))
        for i in range(n)]


def test_fleet_work_stealing_rebalances_a_backed_up_queue():
    """Every request on one template → one replica; the other steals, the
    outputs stay solo exact, both serve."""
    _, _, cfg, params, _ = _setup()
    prompts = _one_template(9, 8, (20, 3))
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       steal=True, steal_poll_s=0.001)
    got = _tokens(fleet(prompts, 6, slots=1))
    _assert_all_equal(got, _solo(params, prompts, 6, cfg))
    st = fleet.last_stats["fleet"]
    assert st["stolen"] >= 1, st
    assert all(r["requests"] > 0 for r in st["per_replica"])


def test_fleet_disaggregated_with_stealing_stays_exact():
    """Handoffs land while the monitor steals between decode queues:
    every request served once, solo exact (steal counts by invariant)."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    fleet = make_fleet(params, cfg, max_len=max_len, replicas=4,
                       kv_block=4, share_prefix=True, disaggregate=True,
                       prefill_workers=2, steal=True, steal_poll_s=0.0005)
    got = _tokens(fleet(prompts, 5, slots=1))
    _assert_all_equal(got, _solo(params, prompts, 5, cfg))
    st = fleet.last_stats["fleet"]
    assert st["served"] == len(prompts) and st["shed"] == 0
    assert st["served"] + st["shed"] == len(prompts)


def test_fleet_affinity_queue_bound_overrides_to_least_loaded():
    """A tight ``affinity_queue_bound`` on a one-template trace diverts the
    overflow at routing time (steal off): both serve, fewer than all by
    affinity."""
    _, _, cfg, params, _ = _setup()
    prompts = _one_template(10, 6, (30, 2))
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       affinity_queue_bound=2, est_token_s=0.05,
                       steal=False)
    got = _tokens(fleet(prompts, 4, slots=2))
    _assert_all_equal(got, _solo(params, prompts, 4, cfg))
    st = fleet.last_stats["fleet"]
    assert all(r["requests"] > 0 for r in st["per_replica"])
    assert st["affinity_routed_frac"] < 1.0


def test_fleet_sampled_colocated_placement_invariant():
    """Sampled serving: keys follow (request, position), so the 2-replica
    fleet equals the single sampled engine and the JAX sampled engine."""
    _, _, cfg, params, prompts = _setup()
    sampler = make_sampler(temperature=0.8, top_k=4)
    single = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                               sampler=sampler, device="cpu")
    want = _tokens(single(prompts, 5, slots=2, rng=7))
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       sampler=sampler)
    got = _tokens(fleet(prompts, 5, slots=2, rng=7))
    _assert_all_equal(got, want)
    _assert_all_equal(got, _jax_tokens("setup", 5, 16, sampled=True), "jax:")


def test_fleet_arrival_gated_matches_all_at_once():
    _, _, cfg, params, prompts = _setup()
    arrivals = traffic.poisson_trace(300.0, len(prompts), seed=6)
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4)
    got = _tokens(fleet(prompts, 6, slots=2, arrivals=arrivals))
    _assert_all_equal(got, _solo(params, prompts, 6, cfg))


def test_fleet_eos_early_stopping_matches_solo():
    """eos retirement through the router: each request equals its solo
    decode cut at its first eos."""
    _, _, cfg, params, prompts = _setup()
    full = _solo(params, prompts, 8, cfg)
    eos = int(full[0][0])
    want = [f[:f.index(eos) + 1] if eos in f else f for f in full]
    assert any(len(w) < 8 for w in want)
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4)
    _assert_all_equal(_tokens(fleet(prompts, 8, slots=2, eos_id=eos)), want)


def test_fleet_stats_schema_and_telemetry():
    """The reference's stats schema; with a registry, one ``fleet_route``
    span a request beside the engines' spans."""
    _, _, cfg, params, prompts = _setup()
    reg = Registry()
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       telemetry=reg)
    fleet(prompts, 4, slots=2)
    st = fleet.last_stats
    assert set(st) == {"fleet", "replica_stats"}
    f = st["fleet"]
    for key in ("replicas", "mode", "prefill_workers", "routing",
                "requests", "served", "shed", "shed_requests",
                "stolen", "affinity_routed_frac",
                "affinity_hit_blocks", "affinity_hit_frac",
                "prefill_tokens_saved", "deadline_attainment",
                "goodput_tokens", "latency_ms", "per_replica",
                "routed_to", "launches"):
        assert key in f, key
    assert f["latency_ms"]["p99"] >= f["latency_ms"]["p50"] > 0
    assert len(f["per_replica"]) == 2
    for r in f["per_replica"]:
        for key in ("role", "replica", "requests", "waves",
                    "occupancy", "kv_peak_blocks", "preempted"):
            assert key in r, key
    assert len(st["replica_stats"]) == 2
    assert f["goodput_tokens"] == 4 * len(prompts)
    # on the CPU the wrappers run their plain versions: no launch counted
    assert f["launches"] == {"replica-0": {}, "replica-1": {}}
    spans = [e for e in reg.events if e["kind"] == "span"]
    routes = [e for e in spans if e["name"] == "fleet_route"]
    assert sorted(e["args"]["request"] for e in routes) == list(
        range(len(prompts)))
    assert any(e["name"] == "serve_request" for e in spans)


def test_fleet_validation():
    _, _, cfg, params, prompts = _setup()
    with pytest.raises(ValueError, match="replicas"):
        make_fleet(params, cfg, max_len=16, replicas=0)
    with pytest.raises(ValueError, match="routing"):
        make_fleet(params, cfg, max_len=16, routing="sticky")
    with pytest.raises(ValueError, match="2 replicas"):
        make_fleet(params, cfg, max_len=16, replicas=1, disaggregate=True)
    with pytest.raises(ValueError, match="prefill_workers"):
        make_fleet(params, cfg, max_len=16, replicas=2, disaggregate=True,
                   prefill_workers=2)
    with pytest.raises(ValueError, match="greedy-only"):
        make_fleet(params, cfg, max_len=16, replicas=2, disaggregate=True,
                   sampler=make_sampler(top_k=2))
    with pytest.raises(ValueError, match="spec_k"):
        make_fleet(params, cfg, max_len=24, replicas=2, disaggregate=True,
                   spec_k=2)
    with pytest.raises(ValueError, match="host_spill"):
        make_fleet(params, cfg, max_len=16, replicas=2, disaggregate=True,
                   share_prefix=True, host_spill=True)
    with pytest.raises(ValueError, match="est_token_s"):
        make_fleet(params, cfg, max_len=16, est_token_s=0.0)
    fleet = make_fleet(params, cfg, max_len=16, replicas=1, kv_block=4)
    with pytest.raises(ValueError, match="est_token_s"):
        fleet(prompts, 4, deadlines=[1.0] * len(prompts))
    with pytest.raises(ValueError, match="deadlines"):
        make_fleet(params, cfg, max_len=16, replicas=1, kv_block=4,
                   est_token_s=0.01)(prompts, 4, deadlines=[1.0])
    with pytest.raises(ValueError, match="arrivals"):
        fleet(prompts, 4, arrivals=[0.0])
    assert fleet([], 4) == []
    # the elastic plane's keywords: the reference's defaults pass, a fleet
    # without the tiered index takes warm_join / warm_blocks / cdn_blocks
    # and ignores them as the reference's does, and the refusals are the
    # reference's messages
    make_fleet(params, cfg, max_len=16, replicas=1, autoscale=None,
               warm_join=True, warm_blocks=None, disk_spill=None,
               cdn_blocks=None)
    make_fleet(params, cfg, max_len=16, replicas=1, warm_join=False,
               warm_blocks=8, cdn_blocks=8)
    jcfg, jp = _setup()[:2]
    for kw in ({"autoscale": object()}, {"warm_blocks": 0},
               {"cdn_blocks": 0}, {"disk_spill": "unused"},
               {"disk_spill": "unused", "share_prefix": True,
                "routing": "random"}):
        with pytest.raises(ValueError) as got:
            make_fleet(params, cfg, max_len=16, replicas=1, **kw)
        with pytest.raises(ValueError) as want:
            jfleet.make_fleet(jp, jcfg, max_len=16, replicas=1, **kw)
        assert str(got.value) == str(want.value)


def test_fleet_consistent_hash_ring_equals_the_reference():
    """``affinity_key`` and ``HashRing`` targets are the reference's byte
    for byte; growing 3 → 4 moves a minority of keys."""
    keys = [pfleet.affinity_key(list(range(i, i + 8)), 4) for i in range(64)]
    assert keys == [jfleet.affinity_key(list(range(i, i + 8)), 4)
                    for i in range(64)]
    for n in (1, 2, 3, 4, 7):
        ring, ref = pfleet.HashRing(n), jfleet.HashRing(n)
        assert [ring.target(k) for k in keys] == [ref.target(k)
                                                  for k in keys]
    r3, r4 = pfleet.HashRing(3), pfleet.HashRing(4)
    moved = sum(r3.target(k) != r4.target(k) for k in keys)
    assert moved < len(keys) // 2, f"{moved}/{len(keys)} keys moved"
    assert pfleet.affinity_key([1, 2, 3, 4, 9], 4) \
        == pfleet.affinity_key(torch.tensor([1, 2, 3, 4, 7, 7]), 4)
    assert pfleet.affinity_key([1, 2], 4) == jfleet.affinity_key([1, 2], 4)
    assert pfleet.affinity_key([1, 2], 4) != pfleet.affinity_key([1, 3], 4)


def test_fleet_hash_ring_removal_symmetry():
    """Removing a target moves only its keyspace (as the reference's ring
    does, target for target); adding it back restores the assignment."""
    keys = [pfleet.affinity_key(list(range(i, i + 8)), 4)
            for i in range(128)]
    before = {k: pfleet.HashRing(4).target(k) for k in keys}
    for victim in range(4):
        ring, ref = pfleet.HashRing(4), jfleet.HashRing(4)
        ring.remove(victim)
        ref.remove(victim)
        assert ring.targets() == {0, 1, 2, 3} - {victim}
        for k in keys:
            t = ring.target(k)
            assert t == ref.target(k) and t != victim
            if before[k] != victim:
                assert t == before[k]
        ring.add(victim)
        assert {k: ring.target(k) for k in keys} == before
    with pytest.raises(ValueError, match="last ring target"):
        pfleet.HashRing(1).remove(0)
    with pytest.raises(ValueError, match="not on the ring"):
        pfleet.HashRing(2).remove(5)
    with pytest.raises(ValueError, match="already on the ring"):
        pfleet.HashRing(2).add(1)


@pytest.mark.parametrize("fn,args,kw", [
    ("slo_deadlines", ([1, 6, 30, 200],), {}),
    ("slo_deadlines", ([6] * 8,), {"seed": 5, "base_s": 0.08,
                                  "per_token_s": 0.01, "jitter": 0.2}),
    ("fault_times", (traffic.poisson_trace(500.0, 8, seed=4),),
     {"n": 3, "seed": 6, "lo": 0.4, "hi": 0.6}),
    ("fault_times", ([0.0, 0.5, 2.0],), {}),
])
def test_traffic_fleet_draws_equal_the_reference(fn, args, kw):
    """``slo_deadlines`` and ``fault_times`` are the reference's, value for
    value."""
    assert getattr(traffic, fn)(*args, **kw) == getattr(jtraffic, fn)(
        *args, **kw)


# ------------------------------------------------- the engine's seam


class _Queue(AdmissionSource):
    """A minimal external source: every request at once, in order, with
    optional handoff payloads; records retirements."""

    def __init__(self, reqs, payloads=None):
        self.pending = list(reqs)
        self.payloads = payloads or {}
        self.retired_ = {}

    def candidate(self):
        return self.pending[0] if self.pending else None

    def pop(self, req):
        self.pending.remove(req)

    def requeue(self, req):
        self.pending.insert(0, req)

    def exhausted(self):
        return not self.pending

    def kv_import(self, req):
        return self.payloads.get(req)

    def retired(self, req, tokens):
        self.retired_[req] = tokens


def test_admission_seam_serves_a_subset_as_a_dict():
    """``run(admission=)`` serves only what the source yields, returns a
    dict keyed by request, notifies ``retired`` with the token counts, and
    refuses the knobs the source owns."""
    _, _, cfg, params, prompts = _setup()
    eng = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                            device="cpu")
    want = _solo(params, prompts, 5, cfg)
    q = _Queue([1, 3, 4])
    got = eng(prompts, 5, slots=2, admission=q)
    assert sorted(got) == [1, 3, 4]
    for r, o in got.items():
        assert o.tolist() == want[r]
    assert q.retired_ == {1: 5, 3: 5, 4: 5}
    assert eng.last_stats["requests"] == 3
    assert eng([], 5, admission=_Queue([])) == {}
    for kw, match in (({"arrivals": [0.0] * 6}, "arrivals"),
                      ({"static_batching": True}, "static_batching"),
                      ({"priorities": [1.0] * 6}, "priorities")):
        with pytest.raises(ValueError, match=match):
            eng(prompts, 5, admission=_Queue([0]), **kw)


def test_kv_import_admissions_run_no_prefill(monkeypatch):
    """A decode engine fed ``prefill_session`` payloads imports the rows
    and runs no prefill forward (every forward it makes is a one-token
    wave); its tokens equal solo greedy."""
    _, _, cfg, params, prompts = _setup()
    pre = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                            share_prefix=True, device="cpu")
    session = pre.prefill_session()
    payloads = {r: session.prefill(torch.from_numpy(np.asarray(p)))
                for r, p in enumerate(prompts)}
    session.close()
    assert session.stats["requests"] == len(prompts)
    dec = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                            device="cpu")
    widths = []
    orig = pserving.forward_paged

    def counting(p, tokens, *a, **k):
        widths.append(int(tokens.shape[-1]))
        return orig(p, tokens, *a, **k)

    monkeypatch.setattr(pserving, "forward_paged", counting)
    got = dec(prompts, 5, slots=2,
              admission=_Queue(range(len(prompts)), payloads))
    monkeypatch.setattr(pserving, "forward_paged", orig)
    assert widths and set(widths) == {1}
    want = _solo(params, prompts, 5, cfg)
    for r in range(len(prompts)):
        assert got[r].tolist() == want[r], r
    assert dec.last_stats["kv"]["in_use"] == 0


def test_prefill_session_refusals_and_the_elastic_hooks():
    """``prefill_session`` refuses what the reference's refuses; a source's
    warm chains (no host tier: dropped, billed) and its chain sink (the
    retained chains published at close) are served; ``aot_cache`` still
    names ROADMAP item 9d."""
    _, _, cfg, params, prompts = _setup()
    for kw, match in (({"sampler": make_sampler(top_k=2)}, "greedy-only"),
                      ({"spec_k": 2, "max_len": 24}, "spec_k"),
                      ({"prefix": [1, 2]}, "prefix=None"),
                      ({"prefill_chunk": 4}, "prefill_chunk"),
                      ({"share_prefix": True, "host_spill": True},
                       "host_spill")):
        kw = {"max_len": 16, **kw}
        eng = make_serve_engine(params, cfg, kv_block=4, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            eng.prefill_session()
    eng = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                            device="cpu")
    with pytest.raises(ValueError, match="prefill session needs"):
        eng.prefill_session(kv_blocks=2)

    class Warm(_Queue):
        def warm_chains(self):
            return [(((1, 2, 3, 4),), {})]

    published = []

    class Sink(_Queue):
        def chain_sink(self):
            return types.SimpleNamespace(
                publish=lambda chains: published.extend(chains) or 0)

    eng(prompts, 2, admission=Warm([0]))
    assert eng.last_stats["prefix"]["warm"]["seed_dropped"] == 1
    shared = make_serve_engine(params, cfg, max_len=16, kv_block=4,
                               share_prefix=True, device="cpu")
    shared(prompts[:2], 2, admission=Sink([0, 1]))
    # two prompts of 4 and 6 tokens: one full block each, two chains
    assert sorted(len(c) for c, _p in published) == [1, 1]
    assert all(p["k"][0].shape[0] == 1 for _c, p in published)
    with pytest.raises(NotImplementedError, match="item 9d"):
        make_serve_engine(params, cfg, max_len=16, device="cpu",
                          aot_cache="dir")


def test_fleet_replicas_run_in_their_own_threads():
    """The in-process replicas are threads of this process named after
    their labels, and none outlives the call."""
    _, _, cfg, params, prompts = _setup()
    seen = set()
    orig = pfleet._FleetQueue.candidate

    def note(self):
        seen.add(threading.current_thread().name)
        return orig(self)

    pfleet._FleetQueue.candidate = note
    try:
        fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4)
        fleet(prompts, 3, slots=2)
    finally:
        pfleet._FleetQueue.candidate = orig
    assert seen == {"fleet-decode-0", "fleet-decode-1"}
    assert not [t for t in threading.enumerate()
                if t.name.startswith("fleet-")]


def _params_of(fn) -> list[tuple[str, str]]:
    import inspect

    return [(p.name, p.kind.name)
            for p in inspect.signature(fn).parameters.values()]


def test_fleet_entry_points_take_the_reference_keywords():
    """``make_fleet``, the fleet call and ``run`` take the reference's
    parameters in its order and kinds (``run``'s keyword-only parameters as
    a set: the port orders ``rules`` later)."""
    from nvidia_terraform_modules_tpu.models.fleet import (
        make_fleet as jax_fleet,
    )

    assert _params_of(make_fleet) == _params_of(jax_fleet)
    _, jp, cfg, params, _ = _setup()
    jcfg = _setup()[0]
    mine = make_fleet(params, cfg, max_len=16, replicas=1, kv_block=4)
    ref = jax_fleet(jp, jcfg, max_len=16, replicas=1, kv_block=4)
    assert _params_of(mine) == _params_of(ref)
    run = make_serve_engine(params, cfg, max_len=16, device="cpu")
    jrun = jax_engine(jp, jcfg, max_len=16)
    assert set(_params_of(run)) == set(_params_of(jrun))
