# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the kill-and-resume chaos gate
(``nvidia_terraform_modules_tpu_torch/smoketest/chaos.py``): the
reference's ``tests/test_chaos_resume.py`` against the port's harness,
layered the same way — case validation, the evidence-driven elastic
schedule, ONE seeded elastic one-peer kill (2 → 1 → 2 gloo processes),
ONE seeded SIGKILL resume, the corrupt newest checkpoint and a loud
invariant violation stay tier-1; the reference's matrices (seeds ×
signal × kill step × world, the 2-process SIGTERM and dead-peer cases,
the elastic matrix, the floor, the CLI smokes) are ``slow``, as the
reference marks them.

Every case asserts the exact-resume invariants inside
``smoketest.chaos.run_case``: final parameters and ZeRO-1 AdamW state
bit-match an uninterrupted run, the step count is exact, no quarantined
checkpoint is ever restored, and repeated kill-at-step-k replays are
deterministic.
"""

import dataclasses
import glob
import os

import pytest

from nvidia_terraform_modules_tpu_torch.smoketest.chaos import (
    ChaosCase,
    ChaosInvariantError,
    Supervisor,
    run_case,
)


def test_chaos_case_validation():
    with pytest.raises(ValueError):
        ChaosCase(seed=0, kill_signal="SIGSTOP")
    with pytest.raises(ValueError):
        ChaosCase(seed=0, kill_signal="SIGKILL", kill_scope="one", nprocs=1)
    with pytest.raises(ValueError):
        ChaosCase(seed=0, kill_signal="SIGKILL", kill_scope="some")


def test_elastic_case_validation():
    # elastic needs an armed ONE-peer kill (a whole-world kill leaves no
    # survivors) and room to pause before the configured total
    with pytest.raises(ValueError, match="one-peer"):
        ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=3, nprocs=2,
                  total_steps=6, elastic=True)
    with pytest.raises(ValueError, match="one-peer"):
        ChaosCase(seed=0, kill_signal="", nprocs=2, kill_scope="one",
                  elastic=True)
    with pytest.raises(ValueError, match="total_steps"):
        ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=4, nprocs=2,
                  total_steps=5, kill_scope="one", elastic=True)
    # a kill before the first commit would leave nothing to re-shard —
    # reject the config up front, not as a misleading invariant failure
    with pytest.raises(ValueError, match="save_every"):
        ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=1, nprocs=2,
                  total_steps=6, kill_scope="one", elastic=True)
    with pytest.raises(ValueError, match="save_every"):
        ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=2, nprocs=2,
                  total_steps=6, save_every=2, kill_scope="one",
                  elastic=True)
    ok = ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=3, nprocs=2,
                   total_steps=6, kill_scope="one", elastic=True)
    assert ok.pause_step == 4


def test_elastic_restart_schedule_is_evidence_driven(tmp_path):
    """The shrink decision needs evidence a peer is GONE — the
    survivor's classified EXIT_PEER_DEAD or a signal death. Transient
    failures with every peer alive (positive exit codes: a corruption
    retry, an init timeout) keep the current shape; the classified
    pause grows back."""
    from nvidia_terraform_modules_tpu_torch.models.resilience import (
        EXIT_ELASTIC_PAUSE,
        EXIT_PEER_DEAD,
    )

    case = ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=3, nprocs=2,
                     total_steps=6, kill_scope="one", elastic=True)
    sup = Supervisor(case, str(tmp_path))
    assert sup._plan_attempt(None, 2) == (2, 0)            # attempt 0
    assert sup._plan_attempt([-9, EXIT_PEER_DEAD], 2) == (1, 4)  # kill
    assert sup._plan_attempt([EXIT_PEER_DEAD], 2) == (1, 4)
    assert sup._plan_attempt([1, 1], 2) == (2, 0)          # transient
    assert sup._plan_attempt([1], 1) == (1, 4)             # stay reduced
    assert sup._plan_attempt([EXIT_ELASTIC_PAUSE], 1) == (2, 0)  # grow
    # non-elastic: always the configured shape
    plain = Supervisor(dataclasses.replace(
        case, elastic=False, kill_scope="world"), str(tmp_path))
    assert plain._plan_attempt([-9], 1) == (2, 0)


def test_elastic_one_peer_kill_shrinks_then_grows_back_tier1(tmp_path):
    """THE elastic acceptance gate, tier-1: a seeded one-peer SIGKILL in
    a 2-process gloo world. The survivor classifies the dead peer, the
    supervisor re-forms a 1-process world that elastic-restores the
    2-process checkpoint and CONTINUES (its pause-step params bit-match
    a fresh 1-process restore from the same checkpoint — asserted inside
    run_elastic_case), then grows back to 2 processes with the exact
    step count, no quarantined checkpoint restored, and a deterministic
    seed replay of the whole elastic leg."""
    report = run_case(
        ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=3, nprocs=2,
                  total_steps=6, kill_scope="one", elastic=True),
        str(tmp_path))
    assert report["converged"] is True
    # the world sequence: full → survivors (paused at kill+1) → full
    assert [(w, s) for _, w, s in report["worlds"]] == \
        [(2, 0), (1, 4), (2, 0)]
    assert report["quarantined"] == []   # clean kill: no bad bytes


def test_seeded_sigkill_resume_exact_tier1(tmp_path):
    """THE acceptance gate, tier-1: a seeded SIGKILL at step 3 of 6, the
    supervisor restarts, and the resumed run reaches the uninterrupted
    run's final params/opt-state exactly, with exact step count and a
    deterministic replay."""
    report = run_case(
        ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=3,
                  nprocs=1, total_steps=6),
        str(tmp_path))
    assert report["converged"] is True
    assert report["attempts"]["killed"] == 2   # death + one resume
    assert report["attempts"]["baseline"] == 1
    assert report["quarantined"] == []         # clean kill: no bad bytes


def test_corrupted_newest_checkpoint_quarantined_on_resume_tier1(tmp_path):
    """Tier-1 corruption leg of the gate: the checkpoint that would be
    resumed is truncated between death and restart. The engine must
    quarantine it, resume from the step before, and STILL reach the
    uninterrupted run's final state — and the journal must prove the
    quarantined step was never restored."""
    case = ChaosCase(seed=1, kill_signal="SIGKILL", kill_step=4,
                     nprocs=1, total_steps=6)
    baseline_dir = tmp_path / "baseline"
    killed_dir = tmp_path / "killed"
    baseline = Supervisor(
        ChaosCase(seed=1, kill_signal="", nprocs=1, total_steps=6),
        str(baseline_dir)).run_to_completion()

    def corrupt_newest(attempt):
        if attempt != 1:
            return
        shards = sorted(glob.glob(
            str(killed_dir / "step_*" / "shards_p*.bin")))
        newest = shards[-1]
        with open(newest, "r+b") as fh:
            fh.truncate(8)

    killed = Supervisor(case, str(killed_dir),
                        on_restart=corrupt_newest).run_to_completion()

    # exact final state despite losing the newest checkpoint to rot
    assert {v["digest"] for v in killed["verdicts"]} == \
        {v["digest"] for v in baseline["verdicts"]}
    assert {v["step"] for v in killed["verdicts"]} == {6}
    # step 3 (the newest commit at death) was quarantined, resume came
    # from step 2, and no journal entry ever restored a quarantined step
    assert any(q.startswith("step_00000003") for q in killed["quarantined"])
    resumes = [e["resumed_from"] for e in killed["journal"]
               if e["attempt"] == 1]
    assert resumes == [2]
    for entry in killed["journal"]:
        r = entry.get("resumed_from")
        if r is not None:
            assert not any(
                q.startswith(f"step_{r:08d}")
                for q in entry.get("quarantined", []))


def test_invariant_violation_is_loud(tmp_path):
    """The gate must FAIL when the invariant fails: a case whose killed
    run cannot complete inside the restart budget raises, it does not
    return a green report."""
    case = ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=1,
                     nprocs=1, total_steps=3)
    sup = Supervisor(case, str(tmp_path), max_restarts=0)
    with pytest.raises(ChaosInvariantError):
        sup.run_to_completion()


# ----------------------------------------------------------- slow matrix

_MATRIX = [
    ChaosCase(seed=s, kill_signal=sig, kill_step=k, nprocs=1,
              total_steps=6)
    for s in (0, 1)
    for sig in ("SIGTERM", "SIGKILL")
    for k in (2, 5)
]


@pytest.mark.slow
@pytest.mark.parametrize(
    "case", _MATRIX,
    ids=[f"seed{c.seed}-{c.kill_signal}@{c.kill_step}" for c in _MATRIX])
def test_kill_matrix_single_process(case, tmp_path):
    report = run_case(case, str(tmp_path))
    assert report["converged"] is True


@pytest.mark.slow
def test_sigterm_drain_with_sparse_saves(tmp_path):
    """save_every=3 + SIGTERM at a non-multiple step: the drain's
    emergency checkpoint carries the killed step, so the resume loses
    nothing even between cadence saves."""
    report = run_case(
        ChaosCase(seed=4, kill_signal="SIGTERM", kill_step=4,
                  nprocs=1, total_steps=6, save_every=3),
        str(tmp_path))
    assert report["converged"] is True
    assert report["attempts"]["killed"] == 2


@pytest.mark.slow
def test_two_process_world_sigterm(tmp_path):
    """The 2-process gloo world: a whole-slice preemption (both workers
    SIGTERMed at the same step — exactly how GKE reclaims a spot slice)
    drains, emergency-saves collectively, and resumes exactly."""
    report = run_case(
        ChaosCase(seed=2, kill_signal="SIGTERM", kill_step=3,
                  nprocs=2, total_steps=6),
        str(tmp_path))
    assert report["converged"] is True


@pytest.mark.slow
def test_two_process_sigkill_one_peer_dead_classified(tmp_path):
    """Kill ONE worker of two with SIGKILL: the survivor's heartbeat
    monitor must convert its collective hang into the classified
    EXIT_PEER_DEAD (never an indefinite gloo wait), and the restarted
    world must still resume exactly."""
    report = run_case(
        ChaosCase(seed=3, kill_signal="SIGKILL", kill_step=3,
                  nprocs=2, total_steps=6, kill_scope="one"),
        str(tmp_path))
    assert report["converged"] is True


@pytest.mark.slow
def test_chaos_cli_smoke(tmp_path):
    """The CLI sweep drives the same gate (1 seed × 1 signal × 1 step
    to keep the smoke cheap)."""
    from nvidia_terraform_modules_tpu_torch.smoketest.chaos import main

    assert main(["-seeds", "1", "-steps", "5", "-kill-steps", "2",
                 "-signals", "SIGKILL"]) == 0


# ------------------------------------------- slow elastic shrink/grow matrix

_ELASTIC_MATRIX = [
    ChaosCase(seed=s, kill_signal=sig, kill_step=k, nprocs=2,
              total_steps=7, kill_scope="one", elastic=True)
    for s, sig, k in (
        (0, "SIGTERM", 2),
        (0, "SIGTERM", 4),
        (0, "SIGKILL", 2),
        (0, "SIGKILL", 4),
        (1, "SIGKILL", 3),
    )
]


@pytest.mark.slow
@pytest.mark.parametrize(
    "case", _ELASTIC_MATRIX,
    ids=[f"seed{c.seed}-{c.kill_signal}@{c.kill_step}"
         for c in _ELASTIC_MATRIX])
def test_elastic_matrix_two_process(case, tmp_path):
    """The full shrink/continue/grow-back matrix: both signals (SIGTERM
    drains the killed step, SIGKILL loses it), early and late kills,
    a second seed — every case must shrink to 1, bit-match the fresh
    shrink reference, grow back to 2, and replay deterministically."""
    report = run_case(case, str(tmp_path))
    assert report["converged"] is True
    assert [w for _, w, _ in report["worlds"]] == [2, 1, 2]


@pytest.mark.slow
def test_elastic_min_world_floor_escalates(tmp_path):
    """TPU_ELASTIC_MIN_WORLD above the survivor count must refuse to
    re-form a too-small world — the supervisor escalates loudly instead
    of limping below the floor."""
    import os

    from nvidia_terraform_modules_tpu_torch.models.resilience import (
        ElasticWorldError,
    )

    case = ChaosCase(seed=0, kill_signal="SIGKILL", kill_step=3, nprocs=2,
                     total_steps=6, kill_scope="one", elastic=True)
    os.environ["TPU_ELASTIC_MIN_WORLD"] = "2"
    try:
        with pytest.raises(ElasticWorldError):
            Supervisor(case, str(tmp_path)).run_to_completion()
    finally:
        del os.environ["TPU_ELASTIC_MIN_WORLD"]


@pytest.mark.slow
def test_chaos_cli_elastic_smoke(tmp_path):
    """-elastic drives the shrink/grow gate through the CLI."""
    from nvidia_terraform_modules_tpu_torch.smoketest.chaos import main

    assert main(["-seeds", "1", "-steps", "6", "-kill-steps", "3",
                 "-signals", "SIGKILL", "-elastic"]) == 0
