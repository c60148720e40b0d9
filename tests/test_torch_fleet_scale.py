# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the fleet's elastic plane on the CPU, against the JAX
package on the reference's own cases (``tests/test_fleet_scale.py``).

The autoscaler is placement, never a different model: every request of an
autoscaled fleet equals its solo greedy decode and the JAX fleet's tokens
on the same f32 weights (``params_from_numpy``), and the scale schedule —
a pure function of (policy, seed, trace, ``est_token_s``, fault schedule)
— equals the JAX fleet's event for event, with the same placements, the
same warm joins and primed chains, the same per-replica warm stats and the
same warm-store ledger. ``WarmChainStore`` keeps the reference's ledger on
the same published rows (the capacity squeeze, the shared-prefix dedup,
the corrupt chain). Each JAX fleet runs once (``lru_cache``). The
reference's slow matrix stays slow here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import fleet as jfleet
from nvidia_terraform_modules_tpu.models import hostkv as jhostkv
from nvidia_terraform_modules_tpu_torch.models import (
    AutoscalePolicy,
    BurnInConfig,
    MultiProcTransport,
    WarmChainStore,
    greedy_decode,
    make_fleet,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.models.fleet import (
    FleetFault,
    FleetFaultProfile,
    HashRing,
    affinity_key,
)
from nvidia_terraform_modules_tpu_torch.models.paging import (
    chain_chunks,
    chain_key,
)

CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
           seq_len=16, batch=2)
# the reference's policies: the warm-inherit gate's, the churn gate's
UP = dict(min_replicas=1, max_replicas=3, up_backlog=2.0, down_backlog=0.25,
          cooldown_s=0.0, seed=0)
CHURN = dict(min_replicas=1, max_replicas=4, up_backlog=2.0,
             down_backlog=0.4, cooldown_s=0.05, seed=0)
CHURN_ARRIVALS = tuple([0.0] * 6 + [0.6 + 0.05 * i for i in range(4)]
                       + [1.4 + 0.03 * i for i in range(5)]
                       + [2.2 + 0.2 * i for i in range(5)])
WARM_KW = dict(max_len=16, replicas=1, kv_block=4, est_token_s=0.01,
               steal=False, share_prefix=True, host_spill=True,
               host_blocks=64, prefix_keep_blocks=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors on a shared CPU: one intra-op thread a process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _setup(n=12, templates=4):
    """The reference's multi-template workload: distinct first-block keys
    spread the keyspace over the ring targets."""
    jcfg = jburnin.BurnInConfig(**CFG, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(0), jcfg)
    tmpls = [jax.random.randint(jax.random.PRNGKey(3 + t), (4,), 0,
                                jcfg.vocab) for t in range(templates)]
    prompts = tuple(np.asarray(jnp.concatenate(
        [tmpls[i % templates],
         jax.random.randint(jax.random.PRNGKey(40 + i), (1 + i % 3,), 0,
                            jcfg.vocab)])) for i in range(n))
    cfg = BurnInConfig(**CFG, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jcfg, jp, cfg, params, prompts


@functools.lru_cache(maxsize=None)
def _want(n=12, templates=4, n_new=6):
    _, _, cfg, params, prompts = _setup(n, templates)
    return tuple(tuple(greedy_decode(params, torch.from_numpy(p)[None],
                                     n_new, cfg, max_len=16,
                                     device="cpu")[0].tolist())
                 for p in prompts)


def _tokens(outs):
    return [None if o is None else [int(t) for t in np.asarray(o)]
            for o in outs]


def _assert_all_equal(outs, want, label=""):
    for i, (g, w) in enumerate(zip(_tokens(outs), want)):
        assert g is not None, f"{label} request {i} unserved"
        assert g == list(w), f"{label} request {i} diverged"


def _warm(stats):
    """Each replica's warm stats, and the chains the replicas published
    summed (which replica's close files a shared chain first is thread
    timing; the sum is not)."""
    warm = [None if rs is None else rs["prefix"]["warm"]
            for rs in stats["replica_stats"]]
    return ([None if w is None else
             {k: v for k, v in w.items() if k != "published_chains"}
             for w in warm],
            sum(w["published_chains"] for w in warm if w is not None))


# the scale ledger's keys that follow from the plan and the store, not
# from thread timing
_SCALE_KEYS = ("events", "initial", "final_live", "ups_planned",
               "ups_executed", "downs", "downs_planned", "warm_joins",
               "cold_joins", "warm_chains_primed", "spawn_failures",
               "scaled_down")


@functools.lru_cache(maxsize=None)
def _jax_warm_rounds():
    """The reference's warm-inherit gate, two rounds on one fleet: each
    round's tokens, scale ledger, placements, warm stats and store."""
    jcfg, jp, _, _, prompts = _setup(n=18, templates=6)
    fleet = jfleet.make_fleet(jp, jcfg,
                              autoscale=jfleet.AutoscalePolicy(**UP),
                              **WARM_KW)
    out = []
    for _ in range(2):
        toks = _tokens(fleet([jnp.asarray(p) for p in prompts], 6, slots=2))
        st = fleet.last_stats
        out.append((toks, st["fleet"]["scale"], st["fleet"]["routed_to"],
                    _warm(st)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_churn():
    jcfg, jp, _, _, prompts = _setup(n=20)
    fleet = jfleet.make_fleet(
        jp, jcfg, max_len=16, replicas=2, kv_block=4, est_token_s=0.02,
        autoscale=jfleet.AutoscalePolicy(**CHURN), steal=False,
        faults=jfleet.FleetFaultProfile(
            [jfleet.FleetFault("drain_replica", target=0, at_s=0.05),
             jfleet.FleetFault("kill_replica", target=2, at_s=0.06)],
            seed=1))
    toks = _tokens(fleet([jnp.asarray(p) for p in prompts], 6, slots=2,
                         arrivals=CHURN_ARRIVALS))
    st = fleet.last_stats["fleet"]
    return toks, st["scale"], st["faults"]


# --------------------------------------------------------- policy plane


def test_autoscale_policy_validation():
    """The policy refuses what the reference's refuses, with its
    messages; the defaults are the reference's."""
    assert AutoscalePolicy() == AutoscalePolicy(**{
        f: getattr(jfleet.AutoscalePolicy(), f)
        for f in AutoscalePolicy.__dataclass_fields__})
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
               {"up_backlog": 1.0, "down_backlog": 1.0},
               {"down_backlog": -0.5, "up_backlog": 1.0},
               {"cooldown_s": -1.0}):
        with pytest.raises(ValueError) as got:
            AutoscalePolicy(**kw)
        with pytest.raises(ValueError) as want:
            jfleet.AutoscalePolicy(**kw)
        assert str(got.value) == str(want.value)


def test_make_fleet_autoscale_validation():
    """A policy needs ``est_token_s``, refuses disaggregation and wants the
    initial size inside its bounds; ``warm_blocks`` must be positive — each
    refusal the reference's message."""
    jcfg, jp, cfg, params, _ = _setup()
    pol = dict(min_replicas=2, max_replicas=4)
    for kw in (dict(replicas=2, autoscale=pol),
               dict(replicas=1, est_token_s=0.01, autoscale=pol),
               dict(replicas=2, est_token_s=0.01, autoscale="yes"),
               dict(replicas=3, est_token_s=0.01, disaggregate=True,
                    prefill_workers=1,
                    autoscale=dict(min_replicas=1, max_replicas=4)),
               dict(replicas=2, est_token_s=0.01, warm_blocks=0,
                    autoscale=dict(min_replicas=1, max_replicas=4))):
        mine, ref = dict(kw), dict(kw)
        if isinstance(kw["autoscale"], dict):
            mine["autoscale"] = AutoscalePolicy(**kw["autoscale"])
            ref["autoscale"] = jfleet.AutoscalePolicy(**kw["autoscale"])
        with pytest.raises(ValueError) as got:
            make_fleet(params, cfg, max_len=16, **mine)
        with pytest.raises(ValueError) as want:
            jfleet.make_fleet(jp, jcfg, max_len=16, **ref)
        assert str(got.value) == str(want.value)


def test_hash_ring_add_after_remove_restores_assignment():
    """Remove a target and add it back: every key routes as before, as on
    the reference's ring (a rejoining replica inherits its own keyspace)."""
    ring, jring = HashRing(4), jfleet.HashRing(4)
    keys = [affinity_key(np.arange(i, i + 6), 4) for i in range(64)]
    before = [ring.target(k) for k in keys]
    for r in (ring, jring):
        r.remove(2)
    during = [ring.target(k) for k in keys]
    assert during == [jring.target(k) for k in keys]
    for b, d in zip(before, during):
        assert b == d or b == 2
    for r in (ring, jring):
        r.add(2)
    assert [ring.target(k) for k in keys] == before \
        == [jring.target(k) for k in keys]


# ----------------------------------------------------- warm chain store


def _stores(host_blocks):
    """A port store and a reference store over the same config."""
    jcfg = jburnin.BurnInConfig(**CFG, dtype=jnp.float32)
    cfg = BurnInConfig(**CFG, dtype=torch.float32)
    return (WarmChainStore(cfg, host_blocks, block_size=4, device="cpu"),
            jhostkv.WarmChainStore(jcfg, host_blocks, block_size=4))


def _chain_payload(store, n_blocks, seed=0):
    """Random rows of ``n_blocks`` blocks in ``store``'s layout (numpy, as
    ``export_block_rows`` gives them to the reference)."""
    rng = np.random.default_rng(seed)
    return {key: [rng.standard_normal(
        (n_blocks,) + tuple(buf.shape[1:])).astype(np.float32)
        for buf in bufs] for key, bufs in store.pool._bufs.items()}


def _ledgers_equal(pair):
    a, b = (s.stats() for s in pair)
    assert {k: v for k, v in a.items() if k != "host_bytes"} == \
        {k: v for k, v in b.items() if k != "host_bytes"}
    with pair[0]._lock, pair[1]._lock:
        assert list(pair[0]._chains) == list(pair[1]._chains)
        assert pair[0]._rows == pair[1]._rows


def test_warm_chain_store_publish_take_roundtrip():
    """Published chains come back bit for bit from ``take`` for the owner,
    takes copy, a re-publish refreshes — the reference's ledger at every
    step."""
    pair = _stores(8)
    chunks = tuple(tuple(c) for c in chain_chunks(list(range(8)), 4))
    payload = _chain_payload(pair[0], 2, seed=1)
    assert [s.publish([(chunks, payload)]) for s in pair] == [1, 1]
    assert [s.publish([(chunks, payload)]) for s in pair] == [0, 0]
    _ledgers_equal(pair)
    root = chain_key(chunks, 1)
    assert pair[0].take(lambda r: r != root) == []
    for _ in range(2):
        got = pair[0].take(lambda r: r == root)
        pair[1].take(lambda r: r == root)
        assert len(got) == 1 and got[0][0] == chunks
        for key in payload:
            for a, b in zip(payload[key], got[0][1][key]):
                assert np.array_equal(a, b.numpy())
    _ledgers_equal(pair)
    assert pair[0].stats()["taken_chains"] == 2
    for s in pair:
        s.clear()
    assert pair[0].pool.in_use == 0


def test_warm_chain_store_capacity_keeps_hot_head_drops_cold_tail():
    """Three one-block chains, hottest first, into a two-block store keep
    the hot head; a chain bigger than the pool is refused and billed — as
    the reference's store does."""
    pair = _stores(2)
    named = [tuple(tuple(c) for c in chain_chunks([t] * 4, 4))
             for t in (1, 2, 3)]
    batch = [(c, _chain_payload(pair[0], 1, i + 1))
             for i, c in enumerate(named)]
    assert [s.publish(batch) for s in pair] == [3, 3]
    with pair[0]._lock:
        assert set(pair[0]._chains) == {chain_key(named[0]),
                                        chain_key(named[1])}
    big = tuple(tuple(c) for c in chain_chunks(list(range(12)), 4))
    assert [s.publish([(big, _chain_payload(pair[0], 3, 4))])
            for s in pair] == [0, 0]
    _ledgers_equal(pair)
    assert pair[0].stats()["store_full_drops"] == 1


def test_warm_chain_store_dedups_shared_template_prefix():
    """Chains sharing a template prefix share its rows: three two-block
    chains over one shared head cost four rows; dropping one frees its
    suffix row only."""
    pair = _stores(8)
    tmpl = [7] * 4
    chains = [(tuple(tuple(c) for c in chain_chunks(tmpl + [sfx] * 4, 4)),
               _chain_payload(pair[0], 2, sfx)) for sfx in (1, 2, 3)]
    assert [s.publish(chains) for s in pair] == [3, 3]
    assert pair[0].pool.in_use == 4
    got = pair[0].take(lambda r: True)
    assert [c for c, _p in got] == [c for c, _p in
                                    pair[1].take(lambda r: True)]
    for s in pair:
        with s._lock:
            s._drop_chain_locked(next(iter(s._chains)))
    _ledgers_equal(pair)
    assert pair[0].pool.in_use == 3


def test_warm_chain_store_corrupt_chain_never_migrates():
    """A stored row whose bytes moved under its crc: ``take`` drops the
    chain and bills it, rows released — as the reference's store does."""
    pair = _stores(4)
    chunks = tuple(tuple(c) for c in chain_chunks(list(range(4)), 4))
    payload = _chain_payload(pair[0], 1, 4)
    for s in pair:
        s.publish([(chunks, payload)])
        hid = next(iter(s._rows.values()))[0]
        s.pool._bufs["k"][0][hid, 0, 0, 0] += 1
        assert s.take(lambda r: True) == []
    _ledgers_equal(pair)
    assert pair[0].stats()["corrupt_dropped"] == 1
    assert pair[0].pool.in_use == 0


# ------------------------------------------------------ tier-1 gates


def test_fleet_no_scale_event_schedule_matches_fixed_fleet_tier1():
    """An armed policy that never fires reproduces the fixed fleet: same
    tokens, placements and (empty) shed set as the fixed fleet and the JAX
    elastic fleet, and an all-zero scale ledger equal to the JAX one's."""
    jcfg, jp, cfg, params, prompts = _setup()
    want = _want()
    base = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                      est_token_s=0.01, steal=False)
    _assert_all_equal(base(prompts, 6, slots=2), want, "fixed:")
    bst = base.last_stats["fleet"]
    assert bst["scale"] is None
    pol = dict(min_replicas=2, max_replicas=4, up_backlog=1e9,
               down_backlog=0.0, seed=3)
    kw = dict(max_len=16, replicas=2, kv_block=4, est_token_s=0.01,
              steal=False)
    elastic = make_fleet(params, cfg, autoscale=AutoscalePolicy(**pol), **kw)
    _assert_all_equal(elastic(prompts, 6, slots=2), want, "no-event:")
    ref = jfleet.make_fleet(jp, jcfg, autoscale=jfleet.AutoscalePolicy(
        **pol), **kw)
    ref([jnp.asarray(p) for p in prompts], 6, slots=2)
    est, rst = elastic.last_stats["fleet"], ref.last_stats["fleet"]
    assert est["routed_to"] == bst["routed_to"] == rst["routed_to"]
    assert est["shed_requests"] == [] == rst["shed_requests"]
    assert {k: est["scale"][k] for k in _SCALE_KEYS} == \
        {k: rst["scale"][k] for k in _SCALE_KEYS}
    assert est["scale"]["events"] == [] and est["scale"]["final_live"] == 2


def test_fleet_scale_up_warm_inherit_bit_exact_tier1():
    """The seeded scale-up gate: a one-replica fleet joins two replicas
    under the burst, equal to solo decoding and to the JAX fleet's tokens,
    events, placements and warm stats; the pools drain; the second round
    replays the same events and its joiners take their share warm (seeded
    chains turning into host-tier hits), the store's ledger the JAX
    fleet's."""
    _, _, cfg, params, prompts = _setup(n=18, templates=6)
    want = _want(n=18, templates=6)
    ref = _jax_warm_rounds()
    fleet = make_fleet(params, cfg, autoscale=AutoscalePolicy(**UP),
                       device="cpu", **WARM_KW)
    for rnd, (jtoks, jscale, jrouted, jwarm) in enumerate(ref):
        outs = fleet(prompts, 6, slots=2)
        _assert_all_equal(outs, want, f"round {rnd}:")
        assert _tokens(outs) == jtoks
        st = fleet.last_stats
        sc = st["fleet"]["scale"]
        assert {k: sc[k] for k in _SCALE_KEYS} == \
            {k: jscale[k] for k in _SCALE_KEYS}
        assert sc["warm_store"] == jscale["warm_store"]
        assert st["fleet"]["routed_to"] == jrouted
        assert _warm(st) == jwarm
        assert all(rs["kv"]["in_use"] == 0
                   for rs in st["replica_stats"] if rs is not None)
    assert sc["ups_executed"] == 2 and sc["warm_joins"] >= 1
    assert [e["trigger"] for e in sc["events"]] == ["backlog", "backlog"]
    assert st["fleet"]["spill"]["host_hit_blocks"] >= 1


def test_fleet_scale_churn_with_faults_bit_exact_tier1():
    """The seeded churn gate: burst → idle → burst arrivals drive joins
    and drains while a fault profile drains base replica 0 and kills
    joiner 2 during its bring-up; every request equals solo decoding and
    the JAX fleet's tokens, the scale events and the fault record (killed,
    drained) are the JAX fleet's, and a second call replays them."""
    _, _, cfg, params, prompts = _setup(n=20)
    want = _want(n=20)
    jtoks, jscale, jfaults = _jax_churn()
    fleet = make_fleet(
        params, cfg, max_len=16, replicas=2, kv_block=4, est_token_s=0.02,
        autoscale=AutoscalePolicy(**CHURN), steal=False,
        faults=FleetFaultProfile(
            [FleetFault("drain_replica", target=0, at_s=0.05),
             FleetFault("kill_replica", target=2, at_s=0.06)], seed=1))
    for label in ("churn", "replay"):
        outs = fleet(prompts, 6, slots=2, arrivals=CHURN_ARRIVALS)
        _assert_all_equal(outs, want, f"{label}:")
        assert _tokens(outs) == jtoks
        st = fleet.last_stats["fleet"]
        sc, fr = st["scale"], st["faults"]
        assert sc["events"] == jscale["events"]
        assert (fr["killed"], fr["drained"]) == (jfaults["killed"],
                                                 jfaults["drained"]) \
            == (["replica-2"], ["replica-0"])
        assert st["served"] == len(prompts) and st["shed"] == 0
        assert sc["ups_executed"] >= 2 and sc["downs"] >= 1
        assert len(sc["scaled_down"]) == sc["downs"]
        assert fr["redriven"] >= 1


def test_fleet_scale_up_proc_warm_inherit_bit_exact_tier1():
    """The elastic loop over real processes: the joiners are spawned
    children, the warm chains cross the pipe crc-stamped, and every request
    equals solo decoding, with the JAX fleet's events and the in-process
    fleet's warm stats; the second round's joiners come up warm."""
    _, _, cfg, params, prompts = _setup(n=18, templates=6)
    want = _want(n=18, templates=6)
    ref = _jax_warm_rounds()
    tr = MultiProcTransport()
    fleet = make_fleet(params, cfg, autoscale=AutoscalePolicy(**UP),
                       transport=tr, join_timeout_s=240.0, device="cpu",
                       **WARM_KW)
    try:
        for rnd, (_jt, jscale, _jr, jwarm) in enumerate(ref):
            _assert_all_equal(fleet(prompts, 6, slots=2), want,
                              f"proc round {rnd}:")
            st = fleet.last_stats
            sc = st["fleet"]["scale"]
            assert sc["events"] == jscale["events"]
            assert sc["warm_store"]["chains"] == \
                jscale["warm_store"]["chains"] > 0
            assert _warm(st) == jwarm
        assert sorted(tr._children) == [0, 1, 2]
        assert sc["warm_joins"] >= 1 and sc["warm_chains_primed"] >= 1
        assert st["fleet"]["spill"]["host_hit_blocks"] >= 1
    finally:
        fleet.close()
    assert tr._children == {}


# ------------------------------------------------------- slow matrix


@pytest.mark.slow
def test_fleet_autoscaled_equals_fixed_fleet_per_request():
    """The autoscaled fleet's outputs equal the fixed fleet's on the same
    trace, shed sets included."""
    _, _, cfg, params, prompts = _setup()
    fixed = make_fleet(params, cfg, max_len=16, replicas=3, kv_block=4,
                       est_token_s=0.01, steal=False)
    got_fixed = _tokens(fixed(prompts, 6, slots=2))
    elastic = make_fleet(params, cfg, max_len=16, replicas=1, kv_block=4,
                         est_token_s=0.01, autoscale=AutoscalePolicy(**UP),
                         steal=False)
    assert _tokens(elastic(prompts, 6, slots=2)) == got_fixed
    assert elastic.last_stats["fleet"]["scale"]["ups_executed"] >= 1


@pytest.mark.slow
def test_fleet_spawn_failure_is_classified_and_redrives(monkeypatch):
    """A joiner whose engine build fails every retry is classified dead,
    its planned requests redrive to survivors bit for bit, and the failure
    is billed."""
    from nvidia_terraform_modules_tpu_torch.models import transport

    _, _, cfg, params, prompts = _setup()
    want = _want()
    fleet = make_fleet(params, cfg, max_len=16, replicas=1, kv_block=4,
                       est_token_s=0.01, steal=False,
                       autoscale=AutoscalePolicy(
                           min_replicas=1, max_replicas=2, up_backlog=2.0,
                           down_backlog=0.25, cooldown_s=0.0, seed=0))

    def boom(self, i):
        raise RuntimeError("planted spawn failure")

    monkeypatch.setattr(transport.InProcTransport, "ensure_engine", boom)
    _assert_all_equal(fleet(prompts, 6, slots=2), want, "spawn failure:")
    sc = fleet.last_stats["fleet"]["scale"]
    assert sc["spawn_failures"] == sc["ups_planned"] >= 1
    assert sc["spawn_retries"] == 2 * sc["spawn_failures"]
