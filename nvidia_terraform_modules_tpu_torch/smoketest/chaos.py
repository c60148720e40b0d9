# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Kill-and-resume chaos harness — the port of the reference's
``smoketest/chaos.py``: the training-stack mirror of ``tfsim chaos``.

A supervisor launches the real supervised training job (1 or 2 processes
of a ``torch.distributed`` gloo world on the CPU, one device a process —
the same choreography as the gke-tpu indexed Job), kills workers with
SIGTERM or SIGKILL at a seeded step, restarts them, and asserts the
**exact-resume invariants**:

- the resumed run's final params AND optimizer state (ZeRO-1 AdamW)
  match an uninterrupted run of the same seed bit for bit — the same
  eager operations in the same order from identical restored bytes: the
  worker pins one intra-op thread, and a world of the same shape runs
  its gloo reductions in the same order;
- the step count is exact: every kill-and-restart sequence executes the
  configured total, never one more or one fewer;
- no quarantined checkpoint is ever restored (each attempt journals
  what it resumed from and what sat in quarantine);
- repeated kill-at-step-k replays are deterministic: same case, fresh
  directory → identical resume steps and identical final digests.

Determinism discipline: the kill is **self-delivered** — the supervisor
arms ``TPU_CHAOS_KILL_AT_STEP``/``TPU_CHAOS_KILL_SIGNAL`` and the worker
raises the signal against itself at the exact step boundary (SIGTERM
before the step, so the drain must complete it; SIGKILL before the
step, so the last commit is the previous step). The supervisor reads
heartbeat files for progress, enforces a hard wall-clock bound per
attempt, and restarts on ANY non-zero exit — including the classified
``EXIT_PREEMPTED`` (drained), ``EXIT_PEER_DEAD`` (the heartbeat monitor
converted a collective hang) and checkpoint rendezvous timeouts — so the
restart loop itself is the retry policy.

``-elastic`` arms the shape-shifting leg instead: a one-peer kill in a
2-process world, and the supervisor re-forms the *survivor* as a
1-process world (which restores the 2-process checkpoint, re-sharded —
``models/checkpoint.py``), runs it to a deterministic pause step, then
grows back to 2 processes for the rest of the run. Every attempt forms a
fresh world on a free port. :func:`run_elastic_case` asserts the elastic
invariants: the shrunken segment bit-matches a *fresh* 1-process restore
of the same checkpoint, the grown world finishes at the exact configured
step, the journal shows the re-shard crossing world sizes both ways, no
quarantined step is restored, and the whole world sequence replays
deterministically from the seed.

CLI::

    python -m nvidia_terraform_modules_tpu_torch.smoketest.chaos \\
        -seeds 3 -steps 8 -kill-steps 2,5 -signals SIGTERM,SIGKILL
    python -m nvidia_terraform_modules_tpu_torch.smoketest.chaos \\
        -seeds 1 -steps 6 -kill-steps 3 -signals SIGKILL -elastic

Tests: ``tests/test_torch_chaos_resume.py`` (the reference's tier-1 cases
tier-1, its matrices ``slow``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Optional

import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

RESUME_JOURNAL = "resume_log.jsonl"

# the worker's training shape: tiny on purpose (the invariants are about
# the checkpoint/signal/restart machinery, not the model), f32 so CPU
# replays are exact, batch sized for up to 4-way data sharding
_CHAOS_MODEL = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=1,
                    seq_len=16, batch=8)


class ChaosInvariantError(AssertionError):
    """An exact-resume invariant failed; the message names which."""


# ================================================================= worker


def _digest(tree) -> str:
    """sha256 over this rank's tensors, in leaf-path order — comparable
    across runs with the same world shape."""
    from ..models.checkpoint import _flatten

    h = hashlib.sha256()
    for path, leaf in _flatten(tree):
        h.update(path.encode())
        t = leaf.detach().cpu().contiguous()
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def worker_main(env: Optional[dict] = None) -> int:
    """One supervised training worker (the chaos harness's payload).

    Env contract (all ``TPU_CHAOS_*`` set by the supervisor; the
    standard ``TPU_SMOKETEST_*`` multi-host vars come along unchanged):

    - ``TPU_CHAOS_CKPT_DIR`` — checkpoint + heartbeat directory;
    - ``TPU_CHAOS_TOTAL_STEPS`` / ``TPU_CHAOS_SAVE_EVERY`` /
      ``TPU_CHAOS_SEED`` — the training run;
    - ``TPU_CHAOS_KILL_AT_STEP`` / ``TPU_CHAOS_KILL_SIGNAL`` /
      ``TPU_CHAOS_KILL_PROCESS`` — the armed self-kill (first attempt
      only: ``TPU_CHAOS_ATTEMPT`` gates it);
    - ``TPU_CHAOS_STOP_AT_STEP`` — the elastic pause point: a *reduced*
      world runs to this step boundary, commits, and yields with the
      classified ``EXIT_ELASTIC_PAUSE`` so the supervisor can grow the
      world back (deterministic stand-in for "capacity returned").

    The restore path is the full elastic machinery: the checkpoint on
    disk may have been written by a *different* world size (the dead
    peer's world, or the reduced world the grow-back resumes from) —
    ``SupervisedLoop.restore`` re-shards it onto this world's mesh,
    retrying classified-transient failures with backoff.

    A process is one device (``parallel/multihost.py``): the world is
    ``plan_mesh(world size)`` over gloo, brought up from the indexed Job's
    variables (or a world of one without them).

    Exits 0 on completion (final JSON line carries step + digests),
    ``EXIT_ELASTIC_PAUSE`` at the elastic pause, ``EXIT_PREEMPTED``
    after a SIGTERM drain + emergency checkpoint.
    """
    e = dict(os.environ if env is None else env)
    from ..models import (
        AdamWConfig,
        BurnInConfig,
        Checkpointer,
        SupervisedLoop,
        abstract_train_state,
        init_params,
        instrument_step,
        make_adamw_train_step,
        resilience_from_env,
        synthetic_batch,
    )
    from ..models.resilience import EXIT_ELASTIC_PAUSE, EXIT_PREEMPTED
    from ..parallel import (
        build_mesh,
        make_rules,
        maybe_initialize_distributed,
        plan_mesh,
    )

    # one intra-op thread: a resumed process and an uninterrupted one
    # must reduce in the same order
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    job = maybe_initialize_distributed(e, device=cpu)

    pid = job.process_id if job else 0
    nprocs = job.num_processes if job else 1
    seed = int(e.get("TPU_CHAOS_SEED", "0"))
    total = int(e.get("TPU_CHAOS_TOTAL_STEPS", "8"))
    save_every = int(e.get("TPU_CHAOS_SAVE_EVERY", "1"))
    ckpt_dir = e["TPU_CHAOS_CKPT_DIR"]
    kill_step = int(e.get("TPU_CHAOS_KILL_AT_STEP", "0"))
    kill_signal = e.get("TPU_CHAOS_KILL_SIGNAL", "")
    kill_process = e.get("TPU_CHAOS_KILL_PROCESS", "")
    attempt = int(e.get("TPU_CHAOS_ATTEMPT", "0"))
    stop_at = int(e.get("TPU_CHAOS_STOP_AT_STEP", "0"))

    cfg = BurnInConfig(dtype=torch.float32, **_CHAOS_MODEL)
    rules = make_rules(build_mesh(plan_mesh(nprocs)))
    init_state, adamw_step = make_adamw_train_step(
        cfg, rules, AdamWConfig(lr=1e-2), device=cpu)
    # per-step spans/histogram for the kill-and-resume timeline (no-op
    # unless TPU_TELEMETRY_DIR is set in the supervisor's environment)
    adamw_step = instrument_step(adamw_step, cfg, rules=rules, device=cpu)
    batch = synthetic_batch(torch.Generator().manual_seed(seed + 1), cfg,
                            device=cpu, rules=rules)

    rcfg = resilience_from_env(e)
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = Checkpointer(ckpt_dir, max_to_keep=4)
    # a reduced world pauses at the stop step; anything beyond it is the
    # grown-back world's work
    loop_total = min(total, stop_at) if stop_at else total
    loop = SupervisedLoop(
        ckpt, rcfg, total_steps=loop_total, save_every=save_every,
        process_id=pid, num_processes=nprocs, heartbeat_dir=ckpt_dir)
    # restore through the supervised retry policy: a rendezvous timeout
    # left by a peer killed mid-restart costs backoff, not the attempt
    restored = loop.restore(abstract_train_state(cfg, rules, device=cpu))
    quarantined = ckpt.quarantined()
    if restored is not None:
        state, start_step, _meta = restored
        resumed_from: Optional[int] = start_step
        stored_world = ckpt.stored_world(start_step)
    else:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             device=cpu, rules=rules)
        state = {"params": params, "opt": init_state(params)}
        start_step, resumed_from, stored_world = 0, None, None
    # the journal the supervisor audits: what this attempt resumed from,
    # at which world size (elastic re-shard evidence: stored_world is the
    # WRITING world's size), and what sat in quarantine (invariant:
    # disjoint from the resumed step). Emitted through the telemetry
    # EVENT layer — same records as before, now on the one schema every
    # producer shares, so an elastic-resume journal and a tfsim chaos
    # sweep merge into one timeline (telemetry/export.py reads any
    # *.jsonl sharing the envelope).
    from ..telemetry import EventLog, get_registry

    record = dict(attempt=attempt, process=pid, world=nprocs,
                  resumed_from=resumed_from, stored_world=stored_world,
                  quarantined=quarantined)
    journal = EventLog(os.path.join(ckpt_dir, RESUME_JOURNAL),
                       process=pid)
    journal.event("chaos.resume", **record)
    journal.close()
    # mirror the record onto the telemetry timeline too: the journal
    # lives in the (often throwaway) checkpoint dir, but the exported
    # trace must carry the restart markers wherever TPU_TELEMETRY_DIR
    # points — same event, same schema, second destination
    reg = get_registry()
    if reg.enabled:
        reg.event("chaos.resume", **record)

    armed = (attempt == 0 and kill_step > start_step and
             kill_signal and kill_process in ("", str(pid)))

    def step_fn(st, step_no):
        if armed and step_no == kill_step:
            # the deterministic kill point: SIGTERM right BEFORE the
            # step (the drain must complete it — the step is never
            # lost); SIGKILL right before it (instant death; the last
            # commit is step k-1)
            os.kill(os.getpid(), getattr(signal, kill_signal))
        p, s, _loss = adamw_step(st["params"], st["opt"], batch)
        return {"params": p, "opt": s}

    try:
        state, outcome = loop.run(state, step_fn, start_step=start_step,
                                  resumed_from=resumed_from)
    finally:
        ckpt.close()
    paused = outcome.status == "completed" and loop_total < total
    verdict = {
        "status": "paused" if paused else outcome.status,
        "step": outcome.step,
        "process": pid,
        "num_processes": nprocs,
        "resumed_from": resumed_from,
        "stored_world": stored_world,
        "quarantined": quarantined,
        "emergency_saved": outcome.emergency_saved,
    }
    if outcome.status == "completed":
        verdict["digest"] = _digest(state)
    print(json.dumps(verdict), flush=True)
    if paused:
        return EXIT_ELASTIC_PAUSE
    return 0 if outcome.status == "completed" else EXIT_PREEMPTED


# ============================================================== supervisor


@dataclasses.dataclass(frozen=True)
class ChaosCase:
    """One seeded (signal, kill-step) scenario.

    ``elastic=True`` (needs ``kill_scope="one"``) changes the restart
    policy from shape-preserving to shape-shifting: after the one-peer
    death the supervisor re-forms the *survivors* as a smaller world
    (which elastic-restores the bigger world's checkpoint), runs it to a
    deterministic pause step (``pause_step``), then grows back to the
    full world for the rest of the run — the spot-fleet
    shrink/continue/grow-back cycle, replayable from the seed.
    """

    seed: int
    kill_signal: str          # "SIGTERM" | "SIGKILL" | "" (no kill)
    kill_step: int = 0
    nprocs: int = 1
    total_steps: int = 6
    save_every: int = 1
    kill_scope: str = "world"  # "world" | "one" (process 1 only)
    elastic: bool = False      # shrink to the survivors, then grow back

    def __post_init__(self):
        if self.kill_signal not in ("", "SIGTERM", "SIGKILL"):
            raise ValueError(f"unknown signal {self.kill_signal!r}")
        if self.kill_scope not in ("world", "one"):
            raise ValueError(f"unknown kill scope {self.kill_scope!r}")
        if self.kill_scope == "one" and self.nprocs < 2:
            raise ValueError("kill_scope='one' needs nprocs >= 2")
        if self.elastic:
            if self.kill_scope != "one" or not self.kill_signal:
                raise ValueError(
                    "elastic cases need an armed one-peer kill "
                    "(kill_scope='one'): a whole-world kill leaves no "
                    "survivors to re-form")
            if self.total_steps < self.kill_step + 2:
                raise ValueError(
                    f"elastic case needs total_steps >= kill_step + 2 "
                    f"(pause at {self.kill_step + 1}, grow back after), "
                    f"got total={self.total_steps} kill={self.kill_step}")
            if self.kill_step <= self.save_every:
                raise ValueError(
                    f"elastic case needs kill_step > save_every so at "
                    f"least one checkpoint commits before the peer dies "
                    f"(the shrunken world must RE-SHARD the full "
                    f"world's checkpoint, not start fresh), got "
                    f"kill={self.kill_step} save_every={self.save_every}")

    @property
    def pause_step(self) -> int:
        """Where the reduced world yields for grow-back: one step past
        the kill — late enough that the shrunken world provably trained
        (resume is at most ``kill_step``), early enough that the grown
        world still has steps to run."""
        return self.kill_step + 1


_BOOTSTRAP = (
    "import sys;"
    "sys.path.insert(0, {root!r});"
    "from nvidia_terraform_modules_tpu_torch.smoketest.chaos import "
    "worker_main;"
    "sys.exit(worker_main())"
)
# launcher variables of an enclosing world: a worker's world is the
# supervisor's alone
_WORLD_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "TPU_SMOKETEST_HOSTS",
               "JOB_COMPLETION_INDEX", "TPU_WORKER_ID",
               "TPU_SMOKETEST_PROCESS_BASE", "TPU_SMOKETEST_COORDINATOR",
               "TPU_WORKER_HOSTNAMES")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Supervisor:
    """Launch, observe, kill-arm, and restart the training world.

    The restart loop treats EVERY non-zero exit as restartable — the
    classified drain (75), the classified dead-peer (76), the elastic
    pause (77), a raw SIGKILL death, a checkpoint rendezvous timeout —
    because that is exactly the Job controller's contract on GKE
    (``backoff_limit`` with the disruption-exempt pod failure policy).
    A hard per-attempt wall-clock bound converts any genuine hang into
    a failed attempt.

    For an elastic case the restart is additionally **shape-shifting**:
    the next attempt's world size comes from
    ``models.resilience.plan_world_size`` over the classified exits —
    a dead peer re-forms the survivors as a smaller world (bounded
    distributed init with the new process set, elastic re-sharding
    restore inside the worker), the classified pause grows it back when
    "capacity returns". The schedule is a pure function of the exit
    codes, so seed replays re-form identical world sequences.
    """

    def __init__(self, case: ChaosCase, ckpt_dir: str,
                 max_restarts: int = 4, attempt_timeout_s: float = 240.0,
                 on_restart=None):
        self.case = case
        self.ckpt_dir = ckpt_dir
        self.max_restarts = max_restarts
        self.attempt_timeout_s = attempt_timeout_s
        # test hook: runs before each RESTART attempt (attempt >= 1) —
        # the chaos tests use it to corrupt the newest checkpoint between
        # death and resume, proving the quarantine path end to end
        self.on_restart = on_restart

    def _env(self, proc_id: int, attempt: int, port: int,
             world: int, stop_at: int) -> dict:
        c = self.case
        env = {k: v for k, v in os.environ.items() if k not in _WORLD_VARS}
        env.update(
            TPU_SMOKETEST_PLATFORM="cpu",
            OMP_NUM_THREADS="1",
            TPU_CHAOS_CKPT_DIR=self.ckpt_dir,
            TPU_CHAOS_TOTAL_STEPS=str(c.total_steps),
            TPU_CHAOS_SAVE_EVERY=str(c.save_every),
            TPU_CHAOS_SEED=str(c.seed),
            TPU_CHAOS_ATTEMPT=str(attempt),
            # tight-but-safe supervision: heartbeats keep stamping from a
            # timer thread during compiles, so staleness == death
            TPU_HEARTBEAT_INTERVAL_S="0.5",
            TPU_HEARTBEAT_TIMEOUT_S="8",
            TPU_SMOKETEST_GRACE_SECONDS="60",
            TPU_CHECKPOINT_SYNC_TIMEOUT_S="20",
        )
        if stop_at:
            env["TPU_CHAOS_STOP_AT_STEP"] = str(stop_at)
        if attempt == 0 and c.kill_signal:
            env.update(
                TPU_CHAOS_KILL_AT_STEP=str(c.kill_step),
                TPU_CHAOS_KILL_SIGNAL=c.kill_signal,
                TPU_CHAOS_KILL_PROCESS="1" if c.kill_scope == "one"
                else "",
            )
        if world > 1:
            env.update(
                TPU_SMOKETEST_HOSTS=str(world),
                JOB_COMPLETION_INDEX=str(proc_id),
                TPU_SMOKETEST_COORDINATOR=f"localhost:{port}",
                TPU_SMOKETEST_INIT_TIMEOUT="60",
            )
        return env

    def _launch(self, attempt: int, world: int,
                stop_at: int) -> list[subprocess.Popen]:
        # liveness state belongs to ONE attempt: a dead worker's stale
        # heartbeat surviving into the restart would let a peer's monitor
        # re-classify it dead before it stamps its first beat
        hbdir = os.path.join(self.ckpt_dir, "heartbeats")
        if os.path.isdir(hbdir):
            for name in os.listdir(hbdir):
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(hbdir, name))
        port = _free_port()
        return [
            subprocess.Popen(
                [sys.executable, "-c",
                 _BOOTSTRAP.format(root=_REPO_ROOT)],
                env=self._env(i, attempt, port, world, stop_at),
                cwd=_REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(world)
        ]

    def _plan_attempt(self, last_exits: Optional[list[int]],
                      current_world: int) -> tuple[int, int]:
        """Next attempt's ``(world size, stop-at step)`` from the last
        attempt's classified exits — the elastic restart policy.

        Non-elastic cases always re-form the configured world (the
        shape-preserving behaviour, byte-for-byte). Elastic: evidence
        that a peer is *gone* — the survivor's classified
        ``EXIT_PEER_DEAD``, or a signal death (negative returncode) —
        re-forms the survivors; the classified pause re-forms the full
        world ("capacity returned"); any other failure (a corruption
        retry, a transient init timeout — positive exit codes with
        every peer alive) keeps the current shape and simply retries.
        A reduced world always carries the pause step so growth has a
        deterministic boundary.
        """
        from ..models.resilience import (
            classify_exit,
            elastic_from_env,
            plan_world_size,
        )

        c = self.case
        if not c.elastic or last_exits is None:
            return c.nprocs, 0
        ecfg = elastic_from_env(c.nprocs)
        statuses = [classify_exit(rc) for rc in last_exits]
        peer_gone = "peer_dead" in statuses or any(
            rc < 0 for rc in last_exits)
        world = current_world
        if "elastic_pause" in statuses:
            world = plan_world_size(c.nprocs, ecfg, current=current_world)
        elif current_world == c.nprocs and peer_gone:
            world = plan_world_size(c.nprocs - 1, ecfg,
                                    current=current_world)
        return world, (c.pause_step if world < c.nprocs else 0)

    def run_to_completion(self) -> dict:
        """Attempt/restart until every process completes; returns the
        case report (final verdicts, per-attempt exits + worlds +
        interim verdicts, journal)."""
        from ..telemetry import get_registry

        reg = get_registry()
        attempts: list[dict] = []
        last_exits: Optional[list[int]] = None
        world = self.case.nprocs
        for attempt in range(self.max_restarts + 1):
            world, stop_at = self._plan_attempt(last_exits, world)
            if attempt and self.on_restart is not None:
                self.on_restart(attempt)
            if reg.enabled and attempt:
                # the supervisor-restart marker on the one timeline:
                # which attempt, at what (possibly re-formed) world size
                reg.event("supervisor.restart_attempt", attempt=attempt,
                          world=world, stop_at=stop_at,
                          last_exits=last_exits)
            t_attempt = reg.clock() if reg.enabled else 0.0
            procs = self._launch(attempt, world, stop_at)
            results = []
            deadline = time.monotonic() + self.attempt_timeout_s
            hung = False
            for p in procs:
                budget = max(1.0, deadline - time.monotonic())
                try:
                    out, err = p.communicate(timeout=budget)
                except subprocess.TimeoutExpired:
                    hung = True
                    p.kill()
                    out, err = p.communicate()
                results.append((p.returncode, out, err))
            last_exits = [rc for rc, _, _ in results]
            if reg.enabled:
                reg.emit_span("supervisor_attempt", t_attempt,
                              reg.clock(), attempt=attempt, world=world,
                              exits=last_exits, stop_at=stop_at)
            attempts.append({
                "attempt": attempt,
                "world": world,
                "stop_at": stop_at,
                "hung": hung,
                "exits": last_exits,
                # interim verdicts (paused workers emit one too) — the
                # elastic invariants audit the reduced world's digest
                "verdicts": [_maybe_json(out) for _, out, _ in results],
            })
            if hung:
                raise ChaosInvariantError(
                    f"attempt {attempt} exceeded the "
                    f"{self.attempt_timeout_s:.0f}s wall-clock bound — "
                    f"supervision failed to convert a hang into a "
                    f"classified exit; stderr tails: "
                    f"{[err[-500:] for _, _, err in results]}")
            if all(rc == 0 for rc, _, _ in results):
                return {
                    "verdicts": [_last_json(out) for _, out, _ in results],
                    "attempts": attempts,
                    "journal": self._journal(),
                    "quarantined": self._quarantined(),
                }
        raise ChaosInvariantError(
            f"case {self.case} did not complete within "
            f"{self.max_restarts + 1} attempts: {attempts}")

    def _journal(self) -> list[dict]:
        """The resume records, extracted from the telemetry-schema
        journal: each line is a ``chaos.resume`` event whose ``args``
        carry exactly the record the invariants audit."""
        path = os.path.join(self.ckpt_dir, RESUME_JOURNAL)
        if not os.path.isfile(path):
            return []
        out = []
        with open(path) as fh:
            for line in fh:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec.get("name") == "chaos.resume":
                    out.append(rec["args"])
        return out

    def _quarantined(self) -> list[str]:
        qdir = os.path.join(self.ckpt_dir, "quarantine")
        return sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []


def _last_json(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if not lines:
        raise ChaosInvariantError(f"worker emitted no JSON verdict: "
                                  f"{out[-500:]!r}")
    return json.loads(lines[-1])


def _maybe_json(out: str) -> Optional[dict]:
    """A worker killed mid-flight emits no verdict — that is data, not
    an error, for the per-attempt record."""
    try:
        return _last_json(out)
    except (ChaosInvariantError, json.JSONDecodeError):
        return None


# ============================================================ invariants


def run_case(case: ChaosCase, workdir: str) -> dict:
    """Run one seeded case end to end and assert every invariant.

    Three runs share nothing but the seed: an uninterrupted baseline, the
    killed-and-resumed run, and a replay of the killed run in a fresh
    directory. Raises :class:`ChaosInvariantError` on any violation;
    returns the full report for logging. Elastic cases dispatch to
    :func:`run_elastic_case` (a different invariant set: the world
    changes shape mid-run, so "bit-match the uninterrupted baseline"
    is replaced by the shrink-reference equivalence).
    """
    if case.elastic:
        return run_elastic_case(case, workdir)
    def run(tag: str, c: ChaosCase) -> dict:
        d = os.path.join(workdir, tag)
        os.makedirs(d, exist_ok=True)
        return Supervisor(c, d).run_to_completion()

    baseline = run("baseline", dataclasses.replace(
        case, kill_signal="", kill_step=0))
    killed = run("killed", case)
    replay = run("replay", case)

    def digests(report: dict) -> dict[int, str]:
        return {v["process"]: v["digest"] for v in report["verdicts"]}

    def steps(report: dict) -> set[int]:
        return {v["step"] for v in report["verdicts"]}

    # exact step count, everywhere
    for tag, rep in (("baseline", baseline), ("killed", killed),
                     ("replay", replay)):
        if steps(rep) != {case.total_steps}:
            raise ChaosInvariantError(
                f"{tag}: final step {steps(rep)} != configured "
                f"{case.total_steps}")

    # bit-exact final params + opt state vs the uninterrupted run
    if digests(killed) != digests(baseline):
        raise ChaosInvariantError(
            f"killed run diverged from uninterrupted baseline: "
            f"{digests(killed)} vs {digests(baseline)}")

    # no quarantined checkpoint is ever restored
    for rep in (baseline, killed, replay):
        _assert_no_quarantined_resume(rep)

    # deterministic replay: identical resume trajectory AND final bytes
    def trajectory(report: dict) -> list:
        return sorted(
            (e["attempt"], e["process"], e["resumed_from"])
            for e in report["journal"])

    if trajectory(replay) != trajectory(killed):
        raise ChaosInvariantError(
            f"replay resume trajectory diverged: {trajectory(replay)} "
            f"vs {trajectory(killed)}")
    if digests(replay) != digests(killed):
        raise ChaosInvariantError(
            f"replay final digests diverged: {digests(replay)} vs "
            f"{digests(killed)}")

    kills = 1 if case.kill_signal else 0
    return {
        "case": dataclasses.asdict(case),
        "attempts": {"baseline": len(baseline["attempts"]),
                     "killed": len(killed["attempts"]),
                     "replay": len(replay["attempts"])},
        "kills": kills,
        "digest": sorted(digests(killed).items()),
        "quarantined": killed["quarantined"],
        "converged": True,
    }


def _assert_no_quarantined_resume(report: dict) -> None:
    for entry in report["journal"]:
        resumed = entry.get("resumed_from")
        if resumed is None:
            continue
        bad = [q for q in entry.get("quarantined", [])
               if q.startswith(f"step_{resumed:08d}")]
        if bad:
            raise ChaosInvariantError(
                f"attempt {entry['attempt']} restored step {resumed} "
                f"which sits in quarantine: {bad}")


def run_elastic_case(case: ChaosCase, workdir: str) -> dict:
    """The elastic gate: kill one peer, CONTINUE smaller, grow back.

    Four runs, and what each proves:

    1. **killed** — the elastic supervisor run. Attempt 0 arms the
       one-peer kill; the survivor's heartbeat monitor classifies the
       hang; the supervisor re-forms the survivors as a ``nprocs-1``
       world which elastic-restores the full world's checkpoint
       (re-sharding N→M), trains to ``case.pause_step``, and yields with
       the classified pause; the grown-back full world re-shards the
       reduced world's checkpoint (M→N) and finishes. The moment before
       the shrunken world launches, the checkpoint directory is
       snapshotted (``on_restart``).
    2. **shrink reference** — a FRESH ``nprocs-1`` world started from
       that snapshot, run to the same pause step. Its final params/opt
       must bit-match the shrunken segment's pause digest: the elastic
       resume is exactly "a fresh smaller world restoring the same
       checkpoint", nothing leaked from the dead world.
    3. **replay** — the whole elastic run again in a fresh directory:
       identical world sequence, resume trajectory, pause digest, and
       final digests (seed replay of the elastic leg is deterministic).

    Plus the standing invariants: exact final step count at the full
    world size, re-shard evidence in the journal (``stored_world``
    crosses the world sizes both ways), and no quarantined checkpoint
    ever restored.
    """
    import shutil

    if not case.elastic:
        raise ValueError("run_elastic_case needs an elastic ChaosCase")
    reduced = case.nprocs - 1

    def run_killed(tag: str, take_snapshot: bool) -> tuple[dict, str]:
        d = os.path.join(workdir, tag)
        snap = os.path.join(workdir, f"{tag}_shrink_ref")
        os.makedirs(d, exist_ok=True)

        def snapshot(attempt):
            # freeze the checkpoint exactly as the dead world left it,
            # the instant before the survivors re-form — the shrink
            # reference restores from THIS copy
            if attempt == 1 and not os.path.isdir(snap):
                os.makedirs(snap)
                for name in os.listdir(d):
                    if name.startswith("step_"):
                        shutil.copytree(os.path.join(d, name),
                                        os.path.join(snap, name))

        report = Supervisor(
            case, d, on_restart=snapshot if take_snapshot else None,
        ).run_to_completion()
        return report, snap

    killed, snap_dir = run_killed("killed", take_snapshot=True)
    # the replay leg audits determinism only — no reference run reads a
    # snapshot of it, so don't pay the copytree
    replay, _ = run_killed("replay", take_snapshot=False)

    def shrink_attempt(report: dict) -> dict:
        reduced_attempts = [a for a in report["attempts"] if a["stop_at"]]
        if not reduced_attempts:
            raise ChaosInvariantError(
                "elastic case never re-formed a reduced world — the "
                "one-peer death did not shrink the fleet")
        a = reduced_attempts[0]
        if a["world"] != reduced:
            raise ChaosInvariantError(
                f"reduced world has size {a['world']}, expected the "
                f"{reduced} survivor(s)")
        paused = [v for v in a["verdicts"]
                  if v and v.get("status") == "paused"]
        if len(paused) != reduced:
            raise ChaosInvariantError(
                f"reduced world: {len(paused)} paused verdict(s), "
                f"expected {reduced}: {a['verdicts']}")
        for v in paused:
            if v["step"] != case.pause_step:
                raise ChaosInvariantError(
                    f"reduced world paused at step {v['step']}, not the "
                    f"deterministic {case.pause_step}")
            if v.get("stored_world") != case.nprocs:
                raise ChaosInvariantError(
                    f"reduced world resumed a checkpoint written by "
                    f"world {v.get('stored_world')}, expected the dead "
                    f"{case.nprocs}-process world (no re-shard happened)")
        return a

    shrink = shrink_attempt(killed)

    # 2. the shrink reference: a fresh reduced world from the snapshot
    ref_case = dataclasses.replace(
        case, kill_signal="", kill_step=0, kill_scope="world",
        elastic=False, nprocs=reduced, total_steps=case.pause_step)
    ref = Supervisor(ref_case, snap_dir).run_to_completion()

    def by_process(verdicts) -> dict[int, str]:
        return {v["process"]: v["digest"] for v in verdicts}

    shrink_digests = by_process(
        [v for v in shrink["verdicts"] if v and v.get("status") == "paused"])
    ref_digests = by_process(ref["verdicts"])
    if shrink_digests != ref_digests:
        raise ChaosInvariantError(
            f"the shrunken world diverged from a fresh {reduced}-process "
            f"restore of the same checkpoint: {shrink_digests} vs "
            f"{ref_digests}")
    if {v["resumed_from"] for v in ref["verdicts"]} != \
            {v["resumed_from"] for v in shrink["verdicts"] if v}:
        raise ChaosInvariantError(
            "shrink reference resumed from a different step than the "
            "elastic shrink")

    # 3. grow-back: the final world is the full one, exact step count,
    # and its restore re-sharded the REDUCED world's checkpoint (M→N)
    for rep, tag in ((killed, "killed"), (replay, "replay")):
        for v in rep["verdicts"]:
            if v["step"] != case.total_steps:
                raise ChaosInvariantError(
                    f"{tag}: final step {v['step']} != configured "
                    f"{case.total_steps}")
            if v["num_processes"] != case.nprocs:
                raise ChaosInvariantError(
                    f"{tag}: finished at world size {v['num_processes']}, "
                    f"never grew back to {case.nprocs}")
        grow_attempts = [a for a in rep["attempts"]
                         if a["world"] == case.nprocs and a["attempt"] > 0]
        if not grow_attempts:
            raise ChaosInvariantError(f"{tag}: no grow-back attempt ran")
        grow_no = grow_attempts[0]["attempt"]
        grow_entries = [e for e in rep["journal"]
                        if e["attempt"] == grow_no]
        for e in grow_entries:
            if e.get("stored_world") != reduced or \
                    e.get("resumed_from") != case.pause_step:
                raise ChaosInvariantError(
                    f"{tag}: grow-back resumed step "
                    f"{e.get('resumed_from')} written by world "
                    f"{e.get('stored_world')}; expected step "
                    f"{case.pause_step} from the {reduced}-process world")
        _assert_no_quarantined_resume(rep)

    # 4. deterministic replay: identical world sequence, trajectory,
    # pause digest, final bytes
    def worlds(report: dict) -> list:
        return [(a["attempt"], a["world"], a["stop_at"])
                for a in report["attempts"]]

    def trajectory(report: dict) -> list:
        return sorted(
            (e["attempt"], e["process"], e["world"], e["resumed_from"])
            for e in report["journal"])

    if worlds(replay) != worlds(killed):
        raise ChaosInvariantError(
            f"replay world sequence diverged: {worlds(replay)} vs "
            f"{worlds(killed)}")
    if trajectory(replay) != trajectory(killed):
        raise ChaosInvariantError(
            f"replay resume trajectory diverged: {trajectory(replay)} "
            f"vs {trajectory(killed)}")
    if by_process(killed["verdicts"]) != by_process(replay["verdicts"]):
        raise ChaosInvariantError(
            f"replay final digests diverged: "
            f"{by_process(replay['verdicts'])} vs "
            f"{by_process(killed['verdicts'])}")
    if by_process([v for v in shrink_attempt(replay)["verdicts"]
                   if v and v.get("status") == "paused"]) != shrink_digests:
        raise ChaosInvariantError("replay pause digests diverged")

    return {
        "case": dataclasses.asdict(case),
        "attempts": {"killed": len(killed["attempts"]),
                     "shrink_ref": len(ref["attempts"]),
                     "replay": len(replay["attempts"])},
        "worlds": worlds(killed),
        "pause_digest": sorted(shrink_digests.items()),
        "digest": sorted(by_process(killed["verdicts"]).items()),
        "quarantined": killed["quarantined"],
        "converged": True,
    }


# ===================================================================== CLI


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m nvidia_terraform_modules_tpu_torch.smoketest.chaos",
        description="kill-and-resume chaos sweep over the supervised "
                    "training runtime")
    ap.add_argument("-seeds", type=int, default=2)
    ap.add_argument("-steps", type=int, default=6)
    ap.add_argument("-kill-steps", default="2,4", dest="kill_steps")
    ap.add_argument("-signals", default="SIGTERM,SIGKILL")
    ap.add_argument("-nprocs", type=int, default=1, choices=(1, 2))
    ap.add_argument("-save-every", type=int, default=1, dest="save_every")
    ap.add_argument("-elastic", action="store_true",
                    help="one-peer kills with shape-shifting resume: "
                         "continue at the surviving world size, then "
                         "grow back (forces nprocs=2, kill_scope=one)")
    ap.add_argument("-json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    nprocs = 2 if args.elastic else args.nprocs
    cases = [
        ChaosCase(seed=s, kill_signal=sig, kill_step=k,
                  nprocs=nprocs, total_steps=args.steps,
                  save_every=args.save_every,
                  kill_scope="one" if args.elastic else "world",
                  elastic=args.elastic)
        for s in range(args.seeds)
        for sig in args.signals.split(",")
        for k in (int(x) for x in args.kill_steps.split(","))
    ]
    ok = 0
    for case in cases:
        with tempfile.TemporaryDirectory(prefix="chaos_") as workdir:
            report = run_case(case, workdir)
        ok += 1
        if args.as_json:
            print(json.dumps(report), flush=True)
        else:
            print(f"chaos: seed={case.seed} {case.kill_signal}@"
                  f"{case.kill_step} nprocs={case.nprocs}: exact resume "
                  f"ok ({report['attempts']['killed']} attempt(s))",
                  flush=True)
    print(f"chaos: {ok}/{len(cases)} case(s) resumed exactly", flush=True)
    from ..telemetry import get_registry

    reg = get_registry()
    if reg.enabled:
        # the kill-and-resume timeline: worker train-step/checkpoint
        # spans (the workers inherit TPU_TELEMETRY_DIR) + the
        # supervisor's attempt/restart spans, merged into one trace
        reg.gauge("chaos_case_attainment").set(ok / max(len(cases), 1))
        paths = reg.export()
        print(f"chaos: telemetry exported to {paths['trace']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
