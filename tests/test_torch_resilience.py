# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the preemption-tolerant runtime's building blocks
(``models/resilience.py``, ``utils/retry.py``): the reference's
``tests/test_resilience.py`` cases against the port's modules — retry
policy shapes, the SIGTERM drain, heartbeat liveness classification, the
supervised loop's checkpoint cadence over the port's ``Checkpointer``,
the elastic world plan — plus what the port adds: a peer that stops
heartbeating ends a process hung in a collective with ``os._exit`` and
the classified code, and the SIGTERM guard is inert off the main thread.
The end-to-end kill-and-resume story is ``test_torch_chaos_resume.py``.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from nvidia_terraform_modules_tpu_torch.models import (
    Checkpointer,
    Heartbeat,
    HeartbeatMonitor,
    PeerFailure,
    PreemptionGuard,
    ResilienceConfig,
    SupervisedLoop,
    resilience_from_env,
)
from nvidia_terraform_modules_tpu_torch.parallel import ShapeDtypeStruct
from nvidia_terraform_modules_tpu_torch.utils.retry import (
    RetriesExhausted,
    RetryPolicy,
    retry_call,
)

ROOT = Path(__file__).resolve().parent.parent

# ================================================================== retry


def test_retry_policy_deterministic_schedule_without_jitter():
    """jitter=False reproduces the tfsim control-plane shape exactly:
    1 → 2 → 4 → … capped at cap_s."""
    p = RetryPolicy(initial_s=1.0, multiplier=2.0, cap_s=5.0,
                    max_attempts=6, jitter=False)
    assert list(p.delays()) == [1.0, 2.0, 4.0, 5.0, 5.0]


def test_retry_policy_jitter_bounded_and_seedable():
    p = RetryPolicy(initial_s=2.0, multiplier=2.0, cap_s=6.0,
                    max_attempts=5, jitter=True)
    a = list(p.delays(random.Random(7)))
    b = list(p.delays(random.Random(7)))
    assert a == b                       # seedable
    caps = [2.0, 4.0, 6.0, 6.0]
    assert all(0.0 <= d <= cap for d, cap in zip(a, caps))


def test_retry_call_retries_then_succeeds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    slept = []
    out = retry_call(flaky,
                     policy=RetryPolicy(max_attempts=3, jitter=False,
                                        initial_s=0.01, cap_s=0.02),
                     retryable=(OSError,), sleep=slept.append)
    assert out == "ok" and len(calls) == 3 and len(slept) == 2


def test_retry_call_exhaustion_is_classified():
    with pytest.raises(RetriesExhausted) as ei:
        retry_call(lambda: (_ for _ in ()).throw(OSError("gone")),
                   policy=RetryPolicy(max_attempts=2, jitter=False,
                                      initial_s=0.0),
                   what="read manifest", retryable=(OSError,),
                   sleep=lambda _s: None)
    assert ei.value.attempts == 2
    assert "read manifest" in str(ei.value)
    assert isinstance(ei.value.last, OSError)


def test_retry_call_terminal_errors_fail_fast():
    """Non-retryable exceptions must propagate on the FIRST attempt —
    the retryable-vs-terminal split the simulator enforces."""
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("terminal")

    with pytest.raises(ValueError):
        retry_call(boom, policy=RetryPolicy(max_attempts=5),
                   retryable=(OSError,), sleep=lambda _s: None)
    assert len(calls) == 1


# ============================================================== preemption


def test_preemption_guard_drains_not_dies():
    """SIGTERM inside the guard sets the flag (the loop drains); the
    previous disposition comes back on exit."""
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard(grace_seconds=30.0) as guard:
        assert guard.installed and not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
        assert 0.0 < guard.remaining_s <= 30.0
        # a repeated notice (kubernetes re-signals) must not reset the
        # deadline or kill the drain
        first_remaining = guard.remaining_s
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
        assert guard.remaining_s <= first_remaining + 1e-3
    assert signal.getsignal(signal.SIGTERM) is before


def test_preemption_guard_remaining_budget_decays():
    with PreemptionGuard(grace_seconds=0.2) as guard:
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.25)
        assert guard.remaining_s == 0.0


# ================================================================ liveness


def test_heartbeat_stamps_step_and_monitor_reads_it(tmp_path):
    hb = Heartbeat(str(tmp_path), process_id=1, interval_s=0.05)
    with hb:
        hb.beat(7)
        mon = HeartbeatMonitor(str(tmp_path), num_processes=2,
                               timeout_s=5.0, self_id=0)
        seen = mon.read()
        assert seen[1]["step"] == 7 and seen[1]["pid"] == os.getpid()
        assert mon.check() == []        # fresh heartbeat: everyone lives


def test_monitor_classifies_stale_peer(tmp_path):
    """A peer whose heartbeat goes stale AFTER being seen alive is a
    classified PeerFailure carrying process id, staleness, and last-seen
    step — the bounded replacement for an indefinite collective hang."""
    hbdir = tmp_path / "heartbeats"
    hbdir.mkdir()
    beat = hbdir / "p00001.json"
    mon = HeartbeatMonitor(str(tmp_path), num_processes=2,
                           timeout_s=10.0, self_id=0)
    beat.write_text(json.dumps(
        {"process": 1, "step": 41, "time": time.time()}))
    assert mon.check() == []           # alive: armed, not classified
    beat.write_text(json.dumps(        # the peer dies; its clock stops
        {"process": 1, "step": 41, "time": time.time() - 120.0}))
    failures = mon.check()
    assert len(failures) == 1
    f = failures[0]
    assert isinstance(f, PeerFailure)
    assert f.process == 1 and f.last_step == 41 and f.age_s > 100
    assert "dead peer" in str(f)


def test_monitor_ignores_heartbeats_from_a_previous_attempt(tmp_path):
    """A stale heartbeat file surviving pod replacement on the shared
    checkpoint PVC must NOT classify a slow-to-restart peer as dead —
    only heartbeats stamped within this monitor's lifetime arm."""
    hbdir = tmp_path / "heartbeats"
    hbdir.mkdir()
    (hbdir / "p00001.json").write_text(json.dumps(
        {"process": 1, "step": 41, "time": time.time() - 300.0}))
    mon = HeartbeatMonitor(str(tmp_path), num_processes=2,
                           timeout_s=10.0, self_id=0)
    assert mon.check() == []           # pre-existing file: never armed
    # the peer finally comes up and stamps: arms, lives
    (hbdir / "p00001.json").write_text(json.dumps(
        {"process": 1, "step": 41, "time": time.time()}))
    assert mon.check() == []


def test_monitor_never_arms_absent_peers(tmp_path):
    """A peer that never heartbeat is the INIT timeout's failure, not a
    liveness one — absent files must not classify as dead."""
    mon = HeartbeatMonitor(str(tmp_path), num_processes=4, timeout_s=0.01,
                           self_id=0)
    assert mon.check() == []


def test_monitor_excludes_self(tmp_path):
    hbdir = tmp_path / "heartbeats"
    hbdir.mkdir()
    mon = HeartbeatMonitor(str(tmp_path), num_processes=1, timeout_s=1.0,
                           self_id=0)
    (hbdir / "p00000.json").write_text(json.dumps(
        {"process": 0, "step": 1, "time": time.time()}))
    assert mon.check() == []           # armed…
    (hbdir / "p00000.json").write_text(json.dumps(
        {"process": 0, "step": 1, "time": time.time() - 999.0}))
    assert mon.check() == []           # …but self is never classified


def test_monitor_watch_invokes_callback(tmp_path):
    hbdir = tmp_path / "heartbeats"
    hbdir.mkdir()
    got = []
    mon = HeartbeatMonitor(str(tmp_path), num_processes=2, timeout_s=1.0,
                           self_id=0)
    # seen alive within the monitor's lifetime, then the clock stops
    (hbdir / "p00001.json").write_text(json.dumps(
        {"process": 1, "step": 3, "time": time.time()}))
    assert mon.check() == []
    (hbdir / "p00001.json").write_text(json.dumps(
        {"process": 1, "step": 3, "time": time.time() - 60.0}))
    mon.watch(got.append, interval_s=0.02)
    try:
        deadline = time.monotonic() + 5.0
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        mon.stop()
    assert got and got[0].process == 1


# ================================================================== config


def test_resilience_config_from_env_and_validation():
    cfg = resilience_from_env({
        "TPU_SMOKETEST_GRACE_SECONDS": "12.5",
        "TPU_HEARTBEAT_INTERVAL_S": "0.5",
        "TPU_HEARTBEAT_TIMEOUT_S": "9",
    })
    assert cfg.grace_seconds == 12.5
    assert cfg.heartbeat_interval_s == 0.5
    assert cfg.heartbeat_timeout_s == 9.0
    assert resilience_from_env({}).grace_seconds == 30.0
    with pytest.raises(ValueError):
        ResilienceConfig(grace_seconds=0)
    with pytest.raises(ValueError):
        ResilienceConfig(heartbeat_interval_s=5.0, heartbeat_timeout_s=2.0)


# ========================================================= supervised loop


def _counting_step():
    trail = []

    def step_fn(state, step):
        trail.append(step)
        return state + 1

    return trail, step_fn


def test_supervised_loop_completes_and_checkpoints(tmp_path):
    trail, step_fn = _counting_step()
    with Checkpointer(str(tmp_path), max_to_keep=3) as ckpt:
        loop = SupervisedLoop(ckpt, ResilienceConfig(), total_steps=4,
                              heartbeat_dir=str(tmp_path))
        state, outcome = loop.run(torch.tensor(0.0), step_fn)
        assert outcome.status == "completed" and outcome.step == 4
        assert trail == [1, 2, 3, 4]
        assert float(state) == 4.0
        assert ckpt.latest_step() == 4
        # heartbeat carries the final step for the supervisor to read
        mon = HeartbeatMonitor(str(tmp_path), num_processes=1)
        assert mon.read()[0]["step"] == 4


def test_supervised_loop_save_every_and_final_step(tmp_path):
    _trail, step_fn = _counting_step()
    with Checkpointer(str(tmp_path), max_to_keep=8) as ckpt:
        loop = SupervisedLoop(ckpt, ResilienceConfig(), total_steps=5,
                              save_every=2)
        _state, outcome = loop.run(torch.tensor(0.0), step_fn)
        assert outcome.status == "completed"
        # cadence steps 2 and 4, plus the final step 5 always commits
        assert ckpt.all_steps() == [2, 4, 5]


def test_supervised_loop_drains_and_emergency_saves(tmp_path):
    """SIGTERM mid-run: the in-flight step completes, an emergency
    checkpoint commits at the drained step (not a save_every multiple),
    and the outcome is classified 'preempted'."""
    def step_fn(state, step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)   # preemption notice
        return state + 1

    with Checkpointer(str(tmp_path), max_to_keep=8) as ckpt:
        loop = SupervisedLoop(ckpt, ResilienceConfig(grace_seconds=20.0),
                              total_steps=10, save_every=5)
        state, outcome = loop.run(torch.tensor(0.0), step_fn)
        assert outcome.status == "preempted"
        assert outcome.step == 3 and outcome.emergency_saved
        assert float(state) == 3.0                 # the step was DRAINED
        assert ckpt.latest_step() == 3             # …and committed

    # the restart resumes exactly where the drain stopped
    with Checkpointer(str(tmp_path)) as ckpt:
        abstract = ShapeDtypeStruct((), torch.float32, torch.device("cpu"))
        tree, step, _meta = ckpt.restore_tree(abstract)
        assert step == 3 and float(tree) == 3.0


def test_supervised_loop_without_checkpointer(tmp_path):
    trail, step_fn = _counting_step()
    loop = SupervisedLoop(None, ResilienceConfig(), total_steps=3)
    _state, outcome = loop.run(torch.tensor(0.0), step_fn)
    assert outcome.status == "completed" and trail == [1, 2, 3]


def test_supervised_loop_resume_contract(tmp_path):
    """start_step/resumed_from flow through: a resumed loop runs only the
    remaining steps and reports where it came from."""
    trail, step_fn = _counting_step()
    with Checkpointer(str(tmp_path)) as ckpt:
        loop = SupervisedLoop(ckpt, ResilienceConfig(), total_steps=6)
        _state, outcome = loop.run(torch.tensor(2.0), step_fn,
                                   start_step=2, resumed_from=2)
        assert outcome.status == "completed"
        assert outcome.step == 6 and outcome.resumed_from == 2
        assert trail == [3, 4, 5, 6]


# ------------------------------------------------------- elastic worlds
# (shape-shifting resume: the world size is a variable, not a constant)


def test_elastic_config_validation_and_env():
    from nvidia_terraform_modules_tpu_torch.models import (
        ElasticConfig,
        elastic_from_env,
    )

    cfg = elastic_from_env(4, env={})
    assert cfg == ElasticConfig(desired_world=4, min_world=1,
                                grow_back=True)
    cfg = elastic_from_env(4, env={"TPU_ELASTIC_MIN_WORLD": "2",
                                   "TPU_ELASTIC_GROW_BACK": "0"})
    assert cfg.min_world == 2 and cfg.grow_back is False
    with pytest.raises(ValueError):
        ElasticConfig(desired_world=2, min_world=3)
    with pytest.raises(ValueError):
        ElasticConfig(desired_world=0)
    with pytest.raises(ValueError):
        ElasticConfig(desired_world=2, min_world=0)


def test_plan_world_size_shrinks_grows_and_floors():
    from nvidia_terraform_modules_tpu_torch.models import (
        ElasticConfig,
        ElasticWorldError,
        plan_world_size,
    )

    cfg = ElasticConfig(desired_world=4, min_world=2)
    assert plan_world_size(3, cfg, current=4) == 3      # shrink
    assert plan_world_size(2, cfg, current=3) == 2      # to the floor
    assert plan_world_size(4, cfg, current=2) == 4      # capacity back
    assert plan_world_size(9, cfg, current=4) == 4      # never overgrow
    with pytest.raises(ElasticWorldError):
        plan_world_size(1, cfg, current=2)              # below the floor
    pinned = ElasticConfig(desired_world=4, min_world=1, grow_back=False)
    assert plan_world_size(4, pinned, current=2) == 2   # growth pinned
    assert plan_world_size(1, pinned, current=2) == 1   # shrink still ok


def test_classify_exit_maps_the_protocol_codes():
    from nvidia_terraform_modules_tpu_torch.models import classify_exit
    from nvidia_terraform_modules_tpu_torch.models.resilience import (
        EXIT_ELASTIC_PAUSE,
        EXIT_PEER_DEAD,
        EXIT_PREEMPTED,
    )

    assert classify_exit(0) == "completed"
    assert classify_exit(EXIT_PREEMPTED) == "preempted"
    assert classify_exit(EXIT_PEER_DEAD) == "peer_dead"
    assert classify_exit(EXIT_ELASTIC_PAUSE) == "elastic_pause"
    assert classify_exit(-9) == "error"    # raw SIGKILL death
    assert classify_exit(1) == "error"


def test_supervised_loop_restore_retries_transient_then_succeeds():
    """The restart-policy fix: a classified transient checkpoint failure
    during RESTORE (rendezvous timeout — a peer slow to restart) costs
    backoff-spaced retries, not the attempt."""
    from nvidia_terraform_modules_tpu_torch.models import (
        ResilienceConfig,
        SupervisedLoop,
    )
    from nvidia_terraform_modules_tpu_torch.models.checkpoint import (
        CheckpointError,
    )
    from nvidia_terraform_modules_tpu_torch.utils.retry import RetryPolicy

    calls = []

    class FlakyCkpt:
        def restore_tree(self, abstract, step=None):
            calls.append(step)
            if len(calls) < 3:
                raise CheckpointError("checkpoint rendezvous timed out")
            return ({"w": 1}, 7, {})

    cfg = ResilienceConfig(restore_policy=RetryPolicy(
        initial_s=0.001, multiplier=2.0, cap_s=0.002, max_attempts=4,
        jitter=False))
    loop = SupervisedLoop(FlakyCkpt(), cfg, total_steps=1)
    assert loop.restore(object()) == ({"w": 1}, 7, {})
    assert len(calls) == 3


def test_supervised_loop_restore_corrupt_is_terminal():
    """A corrupt step must NOT be hammered: quarantine-and-fallback owns
    that path, and an explicit-step corruption escalates immediately."""
    from nvidia_terraform_modules_tpu_torch.models import (
        ResilienceConfig,
        SupervisedLoop,
    )
    from nvidia_terraform_modules_tpu_torch.models.checkpoint import (
        CorruptCheckpointError,
    )
    from nvidia_terraform_modules_tpu_torch.utils.retry import RetryPolicy

    calls = []

    class CorruptCkpt:
        def restore_tree(self, abstract, step=None):
            calls.append(step)
            raise CorruptCheckpointError(3, "crc32 mismatch")

    cfg = ResilienceConfig(restore_policy=RetryPolicy(
        initial_s=0.001, cap_s=0.002, max_attempts=5, jitter=False))
    loop = SupervisedLoop(CorruptCkpt(), cfg, total_steps=1)
    with pytest.raises(CorruptCheckpointError):
        loop.restore(object(), step=3)
    assert len(calls) == 1


def test_supervised_loop_restore_missing_explicit_step_is_terminal():
    """An explicitly requested step that retention pruned is a
    deterministic outcome — surface it immediately, never burn the
    backoff budget on it."""
    from nvidia_terraform_modules_tpu_torch.models import (
        MissingStepError,
        ResilienceConfig,
        SupervisedLoop,
    )
    from nvidia_terraform_modules_tpu_torch.utils.retry import RetryPolicy

    calls = []

    class PrunedCkpt:
        def restore_tree(self, abstract, step=None):
            calls.append(step)
            raise MissingStepError(f"checkpoint step {step} does not "
                                   f"exist")

    cfg = ResilienceConfig(restore_policy=RetryPolicy(
        initial_s=0.001, cap_s=0.002, max_attempts=5, jitter=False))
    loop = SupervisedLoop(PrunedCkpt(), cfg, total_steps=1)
    with pytest.raises(MissingStepError):
        loop.restore(object(), step=9)
    assert calls == [9]


def test_retry_call_giveup_predicate_overrides_retryable():
    from nvidia_terraform_modules_tpu_torch.utils.retry import (
        RetryPolicy,
        retry_call,
    )

    class Transient(RuntimeError):
        pass

    class Terminal(Transient):
        pass

    attempts = []

    def fn():
        attempts.append(1)
        raise Terminal("no point retrying")

    with pytest.raises(Terminal):
        retry_call(fn, policy=RetryPolicy(initial_s=0.001, cap_s=0.002,
                                          max_attempts=5, jitter=False),
                   retryable=(Transient,),
                   giveup=lambda e: isinstance(e, Terminal),
                   sleep=lambda s: None)
    assert len(attempts) == 1


def test_liveness_breaker_state_machine_and_quarantine():
    """The serving-side liveness classification: a stale
    observation opens the circuit (billed once per open, via the hook),
    a fresh one starts the quarantine countdown, and only
    ``quarantine_polls`` consecutive clean polls re-admit — flapping
    mid-quarantine re-opens and restarts the sentence. Per-key state:
    one sick replica never poisons another's circuit."""
    from nvidia_terraform_modules_tpu_torch.models.resilience import (
        LivenessBreaker,
    )

    opened = []
    b = LivenessBreaker(quarantine_polls=3, on_open=opened.append)
    assert b.healthy("a") and b.state("a") == "ok"
    # fresh polls keep the circuit closed, no opens billed
    assert b.observe("a", False) == "ok"
    assert b.opens == 0 and opened == []
    # stale → suspect: ONE open, steals/redrives stop landing here
    assert b.observe("a", True) == "suspect"
    assert b.opens == 1 and opened == ["a"]
    # still stale → still suspect, not billed again
    assert b.observe("a", True) == "suspect"
    assert b.opens == 1
    # fresh → quarantine, and the sentence must be served in full
    assert b.observe("a", False) == "quarantine"
    assert not b.healthy("a")
    assert b.observe("a", False) == "quarantine"
    # flap mid-quarantine: re-open (billed) and restart the sentence
    assert b.observe("a", True) == "suspect"
    assert b.opens == 2 and opened == ["a", "a"]
    assert b.observe("a", False) == "quarantine"
    assert b.observe("a", False) == "quarantine"
    assert b.observe("a", False) == "quarantine"
    assert b.observe("a", False) == "ok"
    assert b.healthy("a")
    # keys are independent
    assert b.healthy("b")
    b.observe("b", True)
    assert not b.healthy("b") and b.healthy("a")
    assert b.opens == 3
    with pytest.raises(ValueError, match="quarantine_polls"):
        LivenessBreaker(quarantine_polls=0)


# ------------------------------------------------------- the port's own

_HUNG_PEER = """
import json, os, sys, time
from nvidia_terraform_modules_tpu_torch.models import (
    ResilienceConfig, SupervisedLoop)
d = sys.argv[1]
os.makedirs(os.path.join(d, "heartbeats"), exist_ok=True)
def step_fn(state, step):
    if step == 1:   # the peer is seen alive once...
        with open(os.path.join(d, "heartbeats", "p00001.json"), "w") as fh:
            json.dump({"process": 1, "step": 1, "time": time.time()}, fh)
        return state
    if sys.argv[2] == "hang":   # ...then this rank hangs in a collective
        time.sleep(60)
    raise RuntimeError("Connection closed by peer")   # or gloo raises
cfg = ResilienceConfig(heartbeat_interval_s=0.2, heartbeat_timeout_s=1.5)
SupervisedLoop(None, cfg, total_steps=3, process_id=0, num_processes=2,
               heartbeat_dir=d).run(0, step_fn)
print("unreachable")
"""


@pytest.mark.parametrize("how", ["hang", "raise"])
def test_dead_peer_ends_a_broken_step_with_the_classified_exit(tmp_path,
                                                               how):
    """A rank blocked in a collective whose peer stopped heartbeating —
    or whose collective raised, as gloo does when the peer's process is
    gone — ends with ``os._exit(EXIT_PEER_DEAD)`` within the timeout,
    leaving the classification on disk; it never waits on the broken
    group."""
    from nvidia_terraform_modules_tpu_torch.models.resilience import (
        EXIT_PEER_DEAD,
    )

    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", _HUNG_PEER, str(tmp_path),
                          how],
                         cwd=ROOT, env={**os.environ,
                                        "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=50)
    assert out.returncode == EXIT_PEER_DEAD, out.stderr[-2000:]
    assert time.monotonic() - t0 < 40
    assert "unreachable" not in out.stdout
    crumb = json.loads((tmp_path / "peer_failure_p00000.json").read_text())
    assert crumb["process"] == 1 and crumb["last_step"] == 1
    assert crumb["observed_by"] == 0 and crumb["age_s"] > 1.5


def test_a_raising_step_with_live_peers_still_raises(tmp_path):
    """The wait for a verdict is bounded: with every peer heartbeating,
    the step's own error gets out."""
    hbdir = tmp_path / "heartbeats"
    hbdir.mkdir()
    cfg = ResilienceConfig(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5)
    stop = threading.Event()

    def peer():
        while not stop.wait(0.05):
            (hbdir / "p00001.json").write_text(json.dumps(
                {"process": 1, "step": 1, "time": time.time()}))

    t = threading.Thread(target=peer)
    t.start()

    def step_fn(state, step):
        raise ValueError("a bug in the step")

    try:
        loop = SupervisedLoop(None, cfg, total_steps=2, num_processes=2,
                              heartbeat_dir=str(tmp_path),
                              on_peer_dead=lambda f: pytest.fail(str(f)))
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="a bug"):
            loop.run(0, step_fn)
        assert time.monotonic() - t0 < 10
    finally:
        stop.set()
        t.join(timeout=5)


def test_preemption_guard_is_inert_off_the_main_thread():
    """Signals are a main-thread facility: a guard entered on another
    thread installs nothing and leaves the disposition as it was."""
    before = signal.getsignal(signal.SIGTERM)
    seen = {}

    def run():
        with PreemptionGuard(grace_seconds=5.0) as guard:
            seen["installed"] = guard.installed
            seen["handler"] = signal.getsignal(signal.SIGTERM)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen == {"installed": False, "handler": before}
    assert signal.getsignal(signal.SIGTERM) is before
