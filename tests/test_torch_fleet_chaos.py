# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the fleet's fault plane on the CPU, against the JAX
package on the reference's chaos configs (``tests/test_fleet_chaos.py``).

A replica kill loses no unshed request: the dead replica's queued and
in-flight requests redrive to survivors and every output EQUALS the JAX
single engine's and solo greedy decode; an empty profile reproduces the
fault-free fleet's placements; a planned drain finishes in-flight work; a
stalling replica opens the circuit breaker and loses nothing; a corrupt
handoff retries from prefill once. The shed set under a capacity schedule
and the profile's resolved schedule equal the JAX fleet's. The monitor's
failure joins every worker, and a kill and its redrive run clean under the
port's lock-order watchdog (``analysis.lockwatch``).

The port serves this config in a few milliseconds a wave, so a kill at
``at_s=0.05`` could find its victim done; each kill case therefore also
stalls the victim's first wave past the kill (a ``slow_replica`` on the
same target), so the kill always lands mid-run. The kill matrix is slow,
as the reference's.
"""

import functools
import threading

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
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    greedy_decode,
    make_fleet,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.models import fleet as pfleet
from nvidia_terraform_modules_tpu_torch.models.fleet import (
    FleetFault,
    FleetFaultProfile,
    HashRing,
    affinity_key,
)
from nvidia_terraform_modules_tpu_torch.utils.traffic import (
    fault_times,
    poisson_trace,
    slo_deadlines,
)

CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
           seq_len=16, batch=2)
KILL_S = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _setup(n=8):
    """The reference's chaos setup: one shared template, so affinity puts
    every request on one replica (the kill target that owns the queue)."""
    jcfg = jburnin.BurnInConfig(**CFG, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(0), jcfg)
    tmpl = jax.random.randint(jax.random.PRNGKey(3), (4,), 0, jcfg.vocab)
    prompts = tuple(np.asarray(jnp.concatenate(
        [tmpl, jax.random.randint(jax.random.PRNGKey(40 + i),
                                  (1 + i % 3,), 0, jcfg.vocab)]))
        for i in range(n))
    cfg = BurnInConfig(**CFG, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jcfg, jp, cfg, params, prompts


@functools.lru_cache(maxsize=None)
def _want(n_new: int):
    """Solo greedy, checked equal to the JAX single engine once."""
    jcfg, jp, cfg, params, prompts = _setup()
    solo = [greedy_decode(params, torch.tensor(p)[None], n_new, cfg,
                          max_len=16, device="cpu")[0].tolist()
            for p in prompts]
    jax_outs = jax_engine(jp, jcfg, max_len=16, kv_block=4)(
        [jnp.asarray(p) for p in prompts], n_new, slots=2)
    assert solo == [np.asarray(o).tolist() for o in jax_outs]
    return solo


def _assert_all_equal(outs, want, label=""):
    for i, (g, w) in enumerate(zip(outs, want)):
        assert g is not None, f"{label} request {i} unserved"
        assert g.tolist() == w, f"{label} request {i} diverged"


def _victim(prompts, n_targets, kv_block=4):
    return HashRing(n_targets).target(affinity_key(prompts[0], kv_block))


def _kill(kind, target, at_s=KILL_S):
    """A kill (or drain) of ``target`` at ``at_s``, its first wave stalled
    past it so it lands mid-run."""
    return [FleetFault(kind, target=target, at_s=at_s),
            FleetFault("slow_replica", target=target, at_s=0.0,
                       stall_s=2 * at_s + 0.05, waves=1)]


def test_fleet_chaos_one_replica_kill_redrives_bit_exact_tier1():
    """A 3-replica fleet with a seeded mid-run kill of the loaded replica
    serves every request equal to solo greedy and the JAX engine; exactly
    that replica is down, its requests redriven, the survivors drained; a
    replay reproduces the outputs."""
    _, _, cfg, params, prompts = _setup()
    want = _want(6)
    victim = _victim(prompts, 3)
    profile = FleetFaultProfile(_kill("kill_replica", victim), seed=0)
    fleet = make_fleet(params, cfg, max_len=16, replicas=3, kv_block=4,
                       faults=profile, steal=False)
    got = fleet(prompts, 6, slots=2)
    _assert_all_equal(got, want, "after kill:")
    st = fleet.last_stats["fleet"]
    assert st["served"] == len(prompts) and st["shed"] == 0
    fr = st["faults"]
    assert fr["replica_down"] == 1
    assert fr["killed"] == [f"replica-{victim}"]
    assert fr["redriven"] >= 1
    assert fr["degraded"] is True and fr["drained"] == []
    assert fr["profile_seed"] == "0"
    assert [r["replica"] for r in st["per_replica"] if r["dead"]] \
        == [f"replica-{victim}"]
    assert fleet.last_stats["replica_stats"][victim] is None
    for rs in fleet.last_stats["replica_stats"]:
        if rs is not None:
            assert rs["kv"]["in_use"] == 0
    _assert_all_equal(fleet(prompts, 6, slots=2), want, "replay:")
    assert fleet.last_stats["fleet"]["faults"]["replica_down"] == 1


def test_fleet_chaos_empty_profile_reproduces_fault_free_fleet():
    """An armed, empty profile serves the fault-free fleet's tokens and
    placements and bills an all-zero fault record."""
    _, _, cfg, params, prompts = _setup()
    base = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                      steal=False)
    want = [o.tolist() for o in base(prompts, 5, slots=2)]
    bst = base.last_stats["fleet"]
    assert bst["faults"] is None
    armed = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       faults=FleetFaultProfile([], seed=7), steal=False)
    _assert_all_equal(armed(prompts, 5, slots=2), want, "empty profile:")
    ast = armed.last_stats["fleet"]
    assert ast["routed_to"] == bst["routed_to"]
    assert ast["shed_requests"] == bst["shed_requests"] == []
    fr = ast["faults"]
    assert fr["replica_down"] == 0 and fr["redriven"] == 0
    assert fr["drained"] == [] and fr["killed"] == []
    assert fr["handoff_retries"] == 0 and fr["degraded"] is False


def test_fleet_chaos_planned_drain_finishes_in_flight_work():
    """A planned drain: the replica stops admitting, finishes what it
    started (never dead), only its queued requests move, all exact."""
    _, _, cfg, params, prompts = _setup()
    victim = _victim(prompts, 2)
    profile = FleetFaultProfile(_kill("drain_replica", victim), seed=1)
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       faults=profile, steal=False)
    _assert_all_equal(fleet(prompts, 6, slots=2), _want(6), "after drain:")
    st = fleet.last_stats["fleet"]
    fr = st["faults"]
    assert st["served"] == len(prompts) and st["shed"] == 0
    assert fr["drained"] == [f"replica-{victim}"]
    assert fr["replica_down"] == 0 and fr["killed"] == []
    assert fr["redriven"] >= 1 and fr["degraded"] is True
    by_label = {r["replica"]: r for r in st["per_replica"]}
    v = by_label[f"replica-{victim}"]
    assert v["dead"] is False and v["requests"] >= 1
    assert by_label[f"replica-{1 - victim}"]["requests"] >= 1
    moved = [w for w in st["routed_to"].values()
             if w.startswith("drained->")]
    assert len(moved) == fr["redriven"] >= 1


def test_fleet_chaos_slow_replica_trips_breaker_stays_exact():
    """A replica stalling past ``health_timeout_s`` opens the breaker,
    loses no capacity and no request, and stays exact."""
    _, _, cfg, params, prompts = _setup()
    victim = _victim(prompts, 2)
    profile = FleetFaultProfile(
        [FleetFault("slow_replica", target=victim, at_s=0.0,
                    stall_s=0.12, waves=3)], seed=2)
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       faults=profile, steal=True, steal_poll_s=0.001,
                       health_timeout_s=0.04, quarantine_polls=4)
    _assert_all_equal(fleet(prompts, 6, slots=2), _want(6), "slow:")
    st = fleet.last_stats["fleet"]
    fr = st["faults"]
    assert st["served"] == len(prompts)
    assert fr["circuit_open"] >= 1
    assert fr["replica_down"] == 0 and fr["killed"] == []
    assert fr["degraded"] is False


def test_fleet_chaos_corrupt_handoff_retries_from_prefill():
    """A corrupted handoff fails its crc (``paging.transfer_crc``), retries
    from prefill once, and the decode output stays exact."""
    _, _, cfg, params, prompts = _setup()
    profile = FleetFaultProfile(
        [FleetFault("corrupt_handoff", target=0, nth=2)], seed=3)
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       share_prefix=True, disaggregate=True,
                       prefill_workers=1, faults=profile, steal=False)
    _assert_all_equal(fleet(prompts, 5, slots=2), _want(5), "corrupt:")
    st = fleet.last_stats["fleet"]
    fr = st["faults"]
    assert st["served"] == len(prompts)
    assert fr["handoff_retries"] == 1
    assert fr["replica_down"] == 0 and fr["redriven"] == 0
    for rs in fleet.last_stats["replica_stats"]:
        assert rs["kv"]["in_use"] == 0


@functools.lru_cache(maxsize=None)
def _capacity_trace():
    n = len(_setup()[4])
    arrivals = poisson_trace(500.0, n, seed=4)
    budgets = [6] * n
    deadlines = slo_deadlines(budgets, seed=5, base_s=0.2,
                              per_token_s=0.02, jitter=0.2)
    kill_at = fault_times(arrivals, 1, seed=6, lo=0.4, hi=0.6)[0]
    return arrivals, budgets, deadlines, kill_at


@functools.lru_cache(maxsize=None)
def _jax_capacity_shed():
    jcfg, jp, _, _, prompts = _setup()
    arrivals, budgets, deadlines, kill_at = _capacity_trace()
    fl = jfleet.make_fleet(
        jp, jcfg, max_len=16, replicas=2, kv_block=4, est_token_s=0.02,
        steal=False, faults=jfleet.FleetFaultProfile(
            [jfleet.FleetFault("kill_replica", target=None,
                               at_s=kill_at)], seed=8))
    fl([jnp.asarray(p) for p in prompts], budgets, slots=2,
       arrivals=arrivals, deadlines=deadlines)
    return fl.last_stats["fleet"]["shed_requests"]


def test_fleet_chaos_shed_set_deterministic_under_capacity_schedule():
    """With deadlines and a kill in the schedule, two fleets with one
    (seed, profile) shed the JAX fleet's set; the rest are exact."""
    _, _, cfg, params, prompts = _setup()
    n = len(prompts)
    arrivals, budgets, deadlines, kill_at = _capacity_trace()
    want = _want(6)

    def run():
        profile = FleetFaultProfile(
            [FleetFault("kill_replica", target=None, at_s=kill_at)], seed=8)
        fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                           est_token_s=0.02, faults=profile, steal=False)
        got = fleet(prompts, budgets, slots=2, arrivals=arrivals,
                    deadlines=deadlines)
        return got, fleet.last_stats["fleet"]

    got_a, st_a = run()
    got_b, st_b = run()
    assert st_a["shed_requests"] == st_b["shed_requests"] \
        == _jax_capacity_shed()
    assert 0 < st_a["shed"] < n, st_a
    for req in range(n):
        if req in st_a["shed_requests"]:
            assert got_a[req] is None and got_b[req] is None
        else:
            assert got_a[req].tolist() == want[req], req
            assert got_b[req].tolist() == want[req], req
    assert st_a["served"] + st_a["shed"] == n


def test_fleet_fault_profile_validation_is_loud():
    _, _, cfg, params, _ = _setup()
    with pytest.raises(ValueError, match="unknown fault kind"):
        FleetFault("explode")
    with pytest.raises(ValueError, match="stall_s"):
        FleetFault("slow_replica")
    with pytest.raises(ValueError, match="waves"):
        FleetFault("slow_replica", stall_s=0.1, waves=0)
    with pytest.raises(ValueError, match="nth"):
        FleetFault("corrupt_handoff", nth=0)
    with pytest.raises(ValueError, match="at_s"):
        FleetFault("kill_replica", at_s=-1.0)
    with pytest.raises(ValueError, match="target"):
        FleetFault("kill_replica", target=-1)
    with pytest.raises(ValueError, match="FleetFault"):
        FleetFaultProfile(["kill_replica"])
    with pytest.raises(ValueError, match="FleetFaultProfile"):
        make_fleet(params, cfg, max_len=16, replicas=2, faults=object())
    with pytest.raises(ValueError, match="health_timeout_s"):
        make_fleet(params, cfg, max_len=16, replicas=2,
                   health_timeout_s=0.0)
    with pytest.raises(ValueError, match="quarantine_polls"):
        make_fleet(params, cfg, max_len=16, replicas=2, quarantine_polls=0)
    for faults, match in (
            ([FleetFault("kill_prefill", target=0)], "disaggregate=True"),
            ([FleetFault("kill_replica", target=5)], "only 2"),
            ([FleetFault("kill_replica", target=0),
              FleetFault("drain_replica", target=0)], "already scheduled"),
            ([FleetFault("kill_replica", target=0),
              FleetFault("kill_replica", target=1)], "survivor")):
        with pytest.raises(ValueError, match=match):
            make_fleet(params, cfg, max_len=16, replicas=2,
                       faults=FleetFaultProfile(faults))
    with pytest.raises(ValueError, match="surviving prefill"):
        make_fleet(params, cfg, max_len=16, replicas=2, disaggregate=True,
                   faults=FleetFaultProfile(
                       [FleetFault("kill_prefill", target=0)]))
    with pytest.raises(ValueError, match="duplicate slow_replica"):
        FleetFaultProfile(
            [FleetFault("slow_replica", target=0, stall_s=0.1),
             FleetFault("slow_replica", target=0, stall_s=0.2)]
        ).resolve(2, 0)


_SPECS = [
    [("kill_replica", None, 0.1), ("slow_replica", None, 0.2)],
    [("kill_replica", 1, 0.1), ("slow_replica", None, 0.2)],
    [("drain_replica", None, 0.3), ("kill_prefill", None, 0.1),
     ("corrupt_handoff", None, 0.0)],
]


@pytest.mark.parametrize("seed", ["chaos", 0, 11])
@pytest.mark.parametrize("spec", range(len(_SPECS)))
def test_fleet_fault_profile_resolution_equals_the_reference(seed, spec):
    """``target=None`` draws from ONE string-seeded stream in spec order:
    the resolved schedule equals the JAX fleet's for the same (seed,
    faults, shape), and replays."""
    def faults(mod):
        return [mod.FleetFault(k, target=t, at_s=a,
                               stall_s=0.05 if k == "slow_replica" else 0.0)
                for k, t, a in _SPECS[spec]]

    n_dec, n_pre = 4, (2 if spec == 2 else 0)
    got = pfleet.FleetFaultProfile(faults(pfleet),
                                   seed=seed).resolve(n_dec, n_pre)
    want = jfleet.FleetFaultProfile(faults(jfleet),
                                    seed=seed).resolve(n_dec, n_pre)
    assert got == want
    assert got == pfleet.FleetFaultProfile(faults(pfleet),
                                           seed=seed).resolve(n_dec, n_pre)


@pytest.mark.slow
def test_fleet_chaos_kill_matrix():
    """Seeds × kill times × colocated/disaggregated: every cell serves all
    requests exactly with one replica down."""
    _, _, cfg, params, prompts = _setup()
    want = _want(5)
    cases = [("colocated", seed, frac, "kill_replica")
             for seed in (0, 1, 2) for frac in (0.1, 0.5)]
    cases += [("disaggregated", 0, 0.3, "kill_replica"),
              ("disaggregated", 1, 0.3, "kill_prefill")]
    for mode, seed, frac, kind in cases:
        label = f"{mode}/seed={seed}/frac={frac}/{kind}"
        at_s = 0.02 + frac * 0.3
        n_dec = 3 if mode == "colocated" else 2
        target = FleetFaultProfile([FleetFault(kind, at_s=at_s)],
                                   seed=seed).resolve(
            n_dec, 0 if mode == "colocated" else 2)
        t = next(iter(target["kills_pre" if kind == "kill_prefill"
                             else "kills_dec"]))
        faults = [FleetFault(kind, target=t, at_s=at_s)]
        if kind == "kill_replica":
            faults = _kill(kind, t, at_s)
        profile = FleetFaultProfile(faults, seed=seed)
        if mode == "colocated":
            fleet = make_fleet(params, cfg, max_len=16, replicas=3,
                               kv_block=4, faults=profile, steal=True,
                               steal_poll_s=0.001)
        else:
            fleet = make_fleet(params, cfg, max_len=16, replicas=4,
                               kv_block=4, share_prefix=True,
                               disaggregate=True, prefill_workers=2,
                               faults=profile, steal=False)
        _assert_all_equal(fleet(prompts, 5, slots=2), want, label)
        st = fleet.last_stats["fleet"]
        fr = st["faults"]
        assert st["served"] == len(prompts), label
        assert st["served"] + st["shed"] == len(prompts), label


def test_fleet_monitor_failure_propagates_and_joins_workers(monkeypatch):
    """An exception in the router's monitor loop (the depth gauge's
    backend exploding) closes every queue, joins every worker and reaches
    the caller."""
    from nvidia_terraform_modules_tpu_torch.telemetry import Registry
    from nvidia_terraform_modules_tpu_torch.telemetry.core import Gauge

    _, _, cfg, params, prompts = _setup()
    fleet = make_fleet(params, cfg, max_len=16, replicas=2, kv_block=4,
                       telemetry=Registry(), steal=True, steal_poll_s=0.001)
    orig = Gauge.set

    def boom(self, v):
        if not threading.current_thread().name.startswith("fleet-"):
            raise RuntimeError("telemetry backend exploded")
        return orig(self, v)

    monkeypatch.setattr(Gauge, "set", boom)
    with pytest.raises(RuntimeError, match="telemetry backend exploded"):
        fleet(prompts, 5, slots=2)
    monkeypatch.setattr(Gauge, "set", orig)
    assert [t.name for t in threading.enumerate()
            if t.name.startswith("fleet-")] == []


# the port's modules, by the package-relative path lockwatch names their
# locks with
_PORT_MODULES = ("models/fleet.py", "models/transport.py",
                 "models/serving.py", "models/hostkv.py", "models/decode.py",
                 "models/paging.py", "ops/_build.py")


def test_fleet_chaos_kill_redrive_under_lockwatch_tier1():
    """The seeded kill and its redrive under the port's lock-order
    watchdog: the port's locks are watched, and the run has no ordering
    cycle and no ``time.sleep`` while holding one — and stays exact."""
    from nvidia_terraform_modules_tpu_torch.analysis import lockwatch

    _, _, cfg, params, prompts = _setup()
    want = _want(6)
    victim = _victim(prompts, 3)
    profile = FleetFaultProfile(_kill("kill_replica", victim), seed=0)
    with lockwatch.armed() as watch:
        fleet = make_fleet(params, cfg, max_len=16, replicas=3,
                           kv_block=4, faults=profile, steal=False)
        got = fleet(prompts, 6, slots=2)
    _assert_all_equal(got, want, "under lockwatch:")
    assert fleet.last_stats["fleet"]["faults"]["replica_down"] == 1

    def ours(name):
        path = name.split(":")[0]
        return path.startswith("nvidia_terraform_modules_tpu_torch/") and \
            path.endswith(_PORT_MODULES)

    assert [n for n in watch.lock_names if ours(n)], \
        "no port lock observed under the watchdog"
    assert watch.acquisitions > 0
    assert [c for c in watch.cycles() if any(ours(n) for n in c)] == []
    assert [h for h in watch.held_sleeps if ours(h[0])] == []
