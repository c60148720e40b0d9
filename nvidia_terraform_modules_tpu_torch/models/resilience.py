# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The preemption-tolerant training runtime: supervision around the loop —
the port of the reference's ``models/resilience.py`` (which imports no
JAX; the port keeps its own copy, wired to its ``utils/retry.py`` and
``telemetry/``).

On spot capacity the preemption notice is routine, not exceptional.
Three mechanisms:

- :class:`PreemptionGuard` — a SIGTERM/preemption-notice handler that
  *drains* instead of dying: the in-flight train step completes, an
  emergency checkpoint commits inside a configurable grace budget
  (``ResilienceConfig.grace_seconds``, sized against the pod's
  ``termination_grace_period_seconds``), and the process exits with a
  *restartable* code instead of losing the step;
- :class:`Heartbeat` + :class:`HeartbeatMonitor` — per-process liveness
  files next to the checkpoints. A peer that dies inside a collective
  can leave everyone else blocked in gloo or NCCL; the monitor converts
  that hang into a bounded, **classified** failure (:class:`PeerFailure`
  written to disk, ``os._exit(EXIT_PEER_DEAD)`` — it never waits on the
  broken process group) that a supervisor restarts;
- capped exponential backoff with jitter (``utils/retry.py``) around
  distributed init (``parallel/multihost.py``) and restore-time reads
  (``models/checkpoint.py``), so transient infrastructure noise costs
  milliseconds, not attempts.

:class:`SupervisedLoop` composes the three around any ``step_fn`` — the
burn-in smoke test and the chaos harness's training worker both run
through it, so the kill-and-resume invariants the harness asserts are
properties of the same code path production uses.
:class:`LivenessBreaker` is the classified-liveness state machine (stale
⇒ circuit opens, fresh ⇒ a bounded quarantine before re-entry — slow and
dead never conflated) in a thread-free form.

**Elastic worlds.** :class:`ElasticConfig` carries the floor
(``TPU_ELASTIC_MIN_WORLD``) and grow-back posture
(``TPU_ELASTIC_GROW_BACK``); :func:`plan_world_size` is the one
re-forming decision — on a dead peer the supervisor relaunches the
*survivors* as a smaller world (a fresh process group over the remaining
processes and an elastic **re-sharding** restore of the larger world's
checkpoint), and when capacity returns the next restart grows the world
back the same way. :func:`classify_exit` maps the process exit codes to
those decisions without parsing logs. The restore phase itself is
retried under ``ResilienceConfig.restore_policy``: a peer that is merely
*slow to restart* surfaces as a classified checkpoint rendezvous timeout,
which costs a backoff-spaced retry, not a restart attempt.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Any, Callable, Optional

from ..utils.retry import RetryPolicy, retry_call

# process exit codes a supervisor can classify without parsing logs:
# preempted-and-drained (restart me, my checkpoint is committed) vs
# peer-dead (restart the world; one of us stopped heartbeating) vs
# elastic-paused (a reduced world yielded because capacity returned —
# restart me at the grown world size)
EXIT_PREEMPTED = 75    # EX_TEMPFAIL: transient, retry the job
EXIT_PEER_DEAD = 76    # EX_PROTOCOL: the collective world is broken
EXIT_ELASTIC_PAUSE = 77  # EX_NOPERM+: yielded for a world-size change

_HEARTBEAT_DIR = "heartbeats"


def classify_exit(returncode: int) -> str:
    """Map a worker's exit code to the supervisor's restart decision.

    ``completed`` — done, don't restart. ``preempted`` — drained with a
    committed checkpoint; restart at the same world size. ``peer_dead``
    — the collective world broke; re-form it from the *survivors*
    (:func:`plan_world_size`). ``elastic_pause`` — a reduced world
    yielded at a step boundary so the supervisor can grow the world
    back. ``error`` — everything else (raw SIGKILL death shows up here
    as a negative returncode); restartable, same world.
    """
    if returncode == 0:
        return "completed"
    if returncode == EXIT_PREEMPTED:
        return "preempted"
    if returncode == EXIT_PEER_DEAD:
        return "peer_dead"
    if returncode == EXIT_ELASTIC_PAUSE:
        return "elastic_pause"
    return "error"


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for the supervised loop (env-overridable, see
    :func:`resilience_from_env`; operational guidance in
    ``gke-tpu/README.md`` "Preemption & resume runbook")."""

    # emergency-checkpoint budget after the preemption notice: the drain
    # (finish the in-flight step) plus the final save must fit here. Size
    # the pod's termination_grace_period_seconds ABOVE this value.
    grace_seconds: float = 30.0
    # liveness: how often each process stamps its heartbeat file, and how
    # stale a previously-seen peer heartbeat may grow before the hang is
    # classified as a dead peer. The timeout must exceed the longest
    # legitimate silent stretch (one train step + one checkpoint save).
    heartbeat_interval_s: float = 2.0
    heartbeat_timeout_s: float = 60.0
    # distributed init / restore-read retry shapes (control-plane mirror)
    init_policy: RetryPolicy = RetryPolicy(
        initial_s=1.0, multiplier=2.0, cap_s=30.0, max_attempts=3)
    # restore-phase retries: a classified checkpoint failure during
    # RESTORE (rendezvous timeout — peer-dead territory, but the peer is
    # usually just slow to restart) retries with backoff before it
    # escalates; a corrupt step is terminal here (quarantine handles it)
    restore_policy: RetryPolicy = RetryPolicy(
        initial_s=0.5, multiplier=2.0, cap_s=10.0, max_attempts=4)

    def __post_init__(self):
        if self.grace_seconds <= 0:
            raise ValueError(
                f"grace_seconds must be > 0, got {self.grace_seconds}")
        if self.heartbeat_timeout_s <= self.heartbeat_interval_s:
            raise ValueError(
                f"heartbeat_timeout_s ({self.heartbeat_timeout_s}) must "
                f"exceed heartbeat_interval_s "
                f"({self.heartbeat_interval_s}) — a timeout inside the "
                f"stamping interval declares every live peer dead")


def resilience_from_env(env: Optional[dict] = None) -> ResilienceConfig:
    """Build the config from the Job env (all optional):

    - ``TPU_SMOKETEST_GRACE_SECONDS`` — emergency-checkpoint budget;
    - ``TPU_HEARTBEAT_INTERVAL_S`` / ``TPU_HEARTBEAT_TIMEOUT_S`` —
      liveness stamping/staleness.
    """
    e = os.environ if env is None else env
    kw: dict[str, Any] = {}
    if "TPU_SMOKETEST_GRACE_SECONDS" in e:
        kw["grace_seconds"] = float(e["TPU_SMOKETEST_GRACE_SECONDS"])
    if "TPU_HEARTBEAT_INTERVAL_S" in e:
        kw["heartbeat_interval_s"] = float(e["TPU_HEARTBEAT_INTERVAL_S"])
    if "TPU_HEARTBEAT_TIMEOUT_S" in e:
        kw["heartbeat_timeout_s"] = float(e["TPU_HEARTBEAT_TIMEOUT_S"])
    return ResilienceConfig(**kw)


# --------------------------------------------------------- elastic worlds


class ElasticWorldError(RuntimeError):
    """The surviving process set is below the elastic floor — no world
    size satisfies ``TPU_ELASTIC_MIN_WORLD``, so the job must escalate
    instead of limping on a world too small to make progress."""


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elastic-resume posture: how far the world may shrink, and whether
    it grows back when capacity returns.

    ``desired_world`` is the world's full size (the Job's ranks); ``min_world`` is the floor below which
    continuing is worse than waiting (throughput, or a batch that no
    longer shards). Env knobs: ``TPU_ELASTIC_MIN_WORLD``,
    ``TPU_ELASTIC_GROW_BACK`` (see :func:`elastic_from_env` and the
    "Preemption & resume runbook" in ``gke-tpu/README.md``).
    """

    desired_world: int = 1
    min_world: int = 1
    grow_back: bool = True

    def __post_init__(self):
        if self.desired_world < 1:
            raise ValueError(
                f"desired_world must be >= 1, got {self.desired_world}")
        if not 1 <= self.min_world <= self.desired_world:
            raise ValueError(
                f"min_world must be in [1, desired_world="
                f"{self.desired_world}], got {self.min_world}")


def elastic_from_env(desired_world: int,
                     env: Optional[dict] = None) -> ElasticConfig:
    """Build the elastic posture from the Job env (all optional):

    - ``TPU_ELASTIC_MIN_WORLD`` — smallest world worth running
      (default 1: train on the last survivor rather than die);
    - ``TPU_ELASTIC_GROW_BACK`` — ``0`` pins a shrunken world until the
      run ends (default ``1``: re-expand as capacity returns).
    """
    e = os.environ if env is None else env
    kw: dict[str, Any] = {"desired_world": desired_world}
    if "TPU_ELASTIC_MIN_WORLD" in e:
        kw["min_world"] = int(e["TPU_ELASTIC_MIN_WORLD"])
    if "TPU_ELASTIC_GROW_BACK" in e:
        kw["grow_back"] = e["TPU_ELASTIC_GROW_BACK"] not in (
            "0", "false", "False", "")
    return ElasticConfig(**kw)


def plan_world_size(alive: int, cfg: ElasticConfig,
                    current: Optional[int] = None) -> int:
    """The one elastic decision: the world size to (re-)form next.

    ``alive`` is how many processes can join the next attempt (survivors
    after a dead peer, or the full fleet once capacity returned);
    ``current`` is the world size of the attempt that just ended (None
    for the first). Shrink follows the survivors immediately; growth
    only happens when ``grow_back`` allows it — a fleet pinned small by
    policy re-forms at ``current`` even when more capacity shows up.
    Raises :class:`ElasticWorldError` below the floor.
    """
    if alive < cfg.min_world:
        raise ElasticWorldError(
            f"only {alive} process(es) can join the next world — below "
            f"the elastic floor TPU_ELASTIC_MIN_WORLD={cfg.min_world} "
            f"(desired {cfg.desired_world}); escalating instead of "
            f"limping")
    target = min(alive, cfg.desired_world)
    if current is not None and target > current and not cfg.grow_back:
        return current
    return target


# ------------------------------------------------------------- preemption


class PreemptionGuard:
    """Convert SIGTERM into a drain request with a grace deadline.

    Use as a context manager around the train loop. The handler only
    sets state — the *loop* decides when to stop (after the in-flight
    step), which is the whole point: a mid-step kill loses the step, a
    drained stop commits it. Installing from a non-main thread (pytest
    workers, library use) degrades to an inert guard (``installed`` is
    False) rather than crashing — signals are a main-thread facility.

    A second SIGTERM while draining is left to the default disposition
    of the *restored* handler on exit; inside the guard it is absorbed
    (Kubernetes repeats the signal; repeats must not kill the drain).
    """

    def __init__(self, grace_seconds: float = 30.0,
                 signals: tuple = (signal.SIGTERM,)):
        self.grace_seconds = grace_seconds
        self._signals = signals
        self._previous: dict = {}
        self.installed = False
        self._preempted_at: Optional[float] = None

    def __enter__(self) -> "PreemptionGuard":
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._on_signal)
            self.installed = True
        except ValueError:   # not the main thread
            self._previous.clear()
            self.installed = False
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self.installed = False

    def _on_signal(self, signum, frame) -> None:  # noqa: ARG002
        if self._preempted_at is None:
            self._preempted_at = time.monotonic()

    @property
    def preempted(self) -> bool:
        return self._preempted_at is not None

    @property
    def remaining_s(self) -> float:
        """Grace budget left for the emergency checkpoint (0 when not
        preempted — callers gate on :attr:`preempted` first)."""
        if self._preempted_at is None:
            return 0.0
        used = time.monotonic() - self._preempted_at
        return max(0.0, self.grace_seconds - used)


# -------------------------------------------------------------- liveness


class PeerFailure(Exception):
    """A peer stopped heartbeating: the collective world is broken.

    Carries enough to classify the failure without logs: which process,
    how stale, and at which step it was last seen alive.
    """

    def __init__(self, process: int, age_s: float, last_step: int):
        super().__init__(
            f"peer process {process} last heartbeat {age_s:.1f}s ago "
            f"(at step {last_step}) — classifying the collective hang "
            f"as a dead peer")
        self.process = process
        self.age_s = age_s
        self.last_step = last_step


class Heartbeat:
    """Per-process liveness file, stamped on every step and on a timer.

    The timer thread covers long silent stretches (compile, big
    collective) so a *slow* step is distinguishable from a *dead*
    process; :meth:`beat` stamps synchronously with the current step so
    a supervisor can also read training progress from the same file.
    """

    def __init__(self, directory: str, process_id: int,
                 interval_s: float = 2.0, clock=time.time):
        self.path = os.path.join(directory, _HEARTBEAT_DIR,
                                 f"p{process_id:05d}.json")
        self.process_id = process_id
        self.interval_s = interval_s
        # epoch clock, injected: stamps are compared across PROCESSES,
        # so the default must be wallclock — tests inject a virtual one
        self._clock = clock
        self._step = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.beat(0)
        self._thread = threading.Thread(
            target=self._run, name="heartbeat", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._stamp()

    def beat(self, step: int) -> None:
        self._step = step
        self._stamp()

    def _stamp(self) -> None:
        tmp = f"{self.path}.tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump({"process": self.process_id, "step": self._step,
                           "time": self._clock(), "pid": os.getpid()}, fh)
            os.replace(tmp, self.path)
        except OSError:
            pass   # liveness is best-effort; the monitor handles absence

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class HeartbeatMonitor:
    """Watch every peer's heartbeat file; classify the dead ones.

    A peer only *arms* once a heartbeat stamped AFTER this monitor was
    born has been seen: a pod that never scheduled is the init timeout's
    failure, not a liveness one, and a stale file surviving a pod
    replacement on the shared checkpoint PVC must not let a resumed
    world re-classify a merely *slow-to-restart* peer as dead (the peer
    keeps stamping once alive, so it arms on the next check). After
    arming, a heartbeat older than ``timeout_s`` is a
    :class:`PeerFailure`. :meth:`watch` runs the check on a background
    thread and invokes ``on_dead`` — the supervised loop's callback
    writes the classification next to the checkpoints and exits
    ``EXIT_PEER_DEAD``, bounding what would otherwise be an indefinite
    gloo or NCCL collective hang.
    """

    def __init__(self, directory: str, num_processes: int,
                 timeout_s: float = 60.0, self_id: Optional[int] = None,
                 telemetry=None, clock=time.time):
        self.directory = os.path.join(directory, _HEARTBEAT_DIR)
        self.num_processes = num_processes
        self.timeout_s = timeout_s
        self.self_id = self_id
        if telemetry is None:
            from ..telemetry import get_registry

            telemetry = get_registry()
        self._telemetry = telemetry
        # epoch clock, injected: ages are computed against peer stamps
        # written by Heartbeat with the same default
        self._clock = clock
        self._born = self._clock()
        self._armed: dict[int, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._interval_s = 1.0

    def read(self) -> dict[int, dict]:
        """Current heartbeat payloads by process id (missing = absent)."""
        out: dict[int, dict] = {}
        for k in range(self.num_processes):
            path = os.path.join(self.directory, f"p{k:05d}.json")
            try:
                with open(path) as fh:
                    out[k] = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue
        return out

    def check(self, now: Optional[float] = None) -> list[PeerFailure]:
        """Dead peers as classified failures (empty = everyone lives)."""
        now = self._clock() if now is None else now
        for k, payload in self.read().items():
            # arm only on a heartbeat from THIS attempt's lifetime;
            # once armed, always track the latest payload
            if k in self._armed or payload.get("time", 0.0) >= self._born:
                self._armed[k] = payload
        failures = []
        worst = 0.0
        for k, last in self._armed.items():
            if k == self.self_id:
                continue
            age = now - last.get("time", 0.0)
            worst = max(worst, age)
            if age > self.timeout_s:
                failures.append(
                    PeerFailure(k, age, int(last.get("step", 0))))
        if self._telemetry.enabled:
            # the liveness headroom dashboarded: how stale the WORST
            # armed peer heartbeat is right now (0 = nothing armed yet)
            self._telemetry.gauge("heartbeat_lag_s").set(worst)
        return failures

    def watch(self, on_dead: Callable[[PeerFailure], None],
              interval_s: float = 1.0) -> "HeartbeatMonitor":
        def run():
            while not self._stop.wait(interval_s):
                failures = self.check()
                if failures:
                    on_dead(failures[0])
                    return
        self._thread = threading.Thread(
            target=run, name="heartbeat-monitor", daemon=True)
        self._thread.start()
        return self

    def wait_for_verdict(self) -> bool:
        """Block until :meth:`watch` has delivered a dead peer to its
        callback, or a peer's heartbeat could no longer be fresh (the
        timeout and two check intervals); True if it delivered one."""
        if self._thread is None:
            return False
        self._thread.join(self.timeout_s + 2 * self._interval_s + 1.0)
        return not self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class LivenessBreaker:
    """Classified-liveness circuit breaker: the staleness→quarantine
    state machine shared by everything that watches poll stamps.

    :class:`HeartbeatMonitor` classifies a peer as DEAD when its stamp
    goes stale past a timeout; this is the milder classification next
    to it — a target that is *alive but sick* (stale, then stamping
    again). Slow and dead must never be conflated: dead means redrive
    the work somewhere else, sick means stop SENDING new work until the
    target proves itself. Each key runs ``ok → suspect`` on a stale
    observation (the circuit OPENS — billed via ``on_open``),
    ``suspect → quarantine`` on the first fresh one, and only
    ``quarantine_polls`` consecutive fresh observations later does it
    re-enter ``ok``; flapping (stale again mid-quarantine) re-opens and
    restarts the sentence. The reference's serving fleet
    (``models/fleet.py``, ROADMAP Queue A item 9 in the port) runs one
    over its replica queues' poll stamps.

    Pure state machine on purpose: no threads, no clocks, no files —
    the caller decides what "stale" means (heartbeat age, poll-stamp
    age, missed acks) and when to observe, so it is testable and
    reusable as-is.
    """

    def __init__(self, quarantine_polls: int = 16,
                 on_open: Optional[Callable[[object], None]] = None):
        if quarantine_polls < 1:
            raise ValueError(
                f"quarantine_polls must be >= 1, got {quarantine_polls}")
        self.quarantine_polls = quarantine_polls
        self._on_open = on_open
        self._state: dict = {}
        self.opens = 0

    def _open(self, key) -> None:
        self.opens += 1
        if self._on_open is not None:
            self._on_open(key)

    def observe(self, key, stale: bool) -> str:
        """Feed one liveness observation for ``key``; returns the new
        state (``"ok"`` | ``"suspect"`` | ``"quarantine"``)."""
        st = self._state.setdefault(key, ["ok", 0])
        if st[0] == "ok":
            if stale:
                st[0] = "suspect"
                self._open(key)
        elif st[0] == "suspect":
            if not stale:
                st[0] = "quarantine"
                st[1] = self.quarantine_polls
        else:                            # quarantine
            if stale:                    # flapped again: re-open
                st[0] = "suspect"
                self._open(key)
            else:
                st[1] -= 1
                if st[1] <= 0:
                    st[0] = "ok"
        return st[0]

    def state(self, key) -> str:
        return self._state.get(key, ["ok"])[0]

    def healthy(self, key) -> bool:
        """True when the circuit for ``key`` is closed (``"ok"``)."""
        return self.state(key) == "ok"


# ------------------------------------------------------- supervised loop


@dataclasses.dataclass
class LoopOutcome:
    """What the supervised loop did: ``completed`` (reached
    ``total_steps``) or ``preempted`` (drained + emergency checkpoint).
    ``resumed_from`` is the restored step (None for a fresh start)."""

    status: str
    step: int
    resumed_from: Optional[int]
    emergency_saved: bool = False


class SupervisedLoop:
    """Drive ``step_fn`` to ``total_steps`` under full supervision.

    One object owns the composition: restore-or-init, per-step
    checkpoints every ``save_every`` steps, heartbeats, the SIGTERM
    drain with an emergency checkpoint inside the grace budget, and the
    dead-peer monitor. A collective over gloo or NCCL raises when its
    peer dies (where the reference's fabric hangs): a step that raises in
    a world of more than one waits for the monitor's verdict first, so a
    dead peer still ends the process with ``EXIT_PEER_DEAD``. The burn-in smoke test and the chaos harness's
    worker both run through here — the harness's kill-and-resume
    invariants hold for the production path because they ARE the
    production path.
    """

    def __init__(self, ckpt, cfg: ResilienceConfig, *,
                 total_steps: int, save_every: int = 1,
                 process_id: int = 0, num_processes: int = 1,
                 heartbeat_dir: Optional[str] = None,
                 on_peer_dead: Optional[Callable] = None,
                 telemetry=None):
        if save_every < 1:
            raise ValueError(f"save_every must be >= 1, got {save_every}")
        self.ckpt = ckpt
        self.cfg = cfg
        self.total_steps = total_steps
        self.save_every = save_every
        self.process_id = process_id
        self.num_processes = num_processes
        self.heartbeat_dir = heartbeat_dir
        self.on_peer_dead = on_peer_dead
        if telemetry is None:
            from ..telemetry import get_registry

            telemetry = get_registry()
        self.telemetry = telemetry

    def restore(self, abstract: Any, step: Optional[int] = None):
        """Restore ``abstract`` through the restart policy fix: a
        *classified, transient* checkpoint failure during restore — the
        rendezvous timeout a peer killed mid-restart leaves behind, the
        same hang the heartbeat monitor classifies ``EXIT_PEER_DEAD``
        during training — is retried with backoff
        (``cfg.restore_policy``) instead of escalated immediately, so a
        slow-to-reschedule peer costs seconds, not a whole restart
        attempt. Corrupt steps stay terminal here: quarantine-and-
        fallback inside ``restore_tree`` already owns that path, and a
        :class:`CorruptCheckpointError` that still escapes (an explicit
        ``step=``) must not be hammered, and neither must the
        deterministic missing-explicit-step error."""
        from .checkpoint import (
            CheckpointError,
            CorruptCheckpointError,
            MissingStepError,
        )

        return retry_call(
            lambda: self.ckpt.restore_tree(abstract, step),
            policy=self.cfg.restore_policy,
            what="checkpoint restore",
            retryable=(CheckpointError, OSError),
            giveup=lambda exc: isinstance(
                exc, (CorruptCheckpointError, MissingStepError)))

    # the default dead-peer action: leave a classification on disk where
    # the supervisor (and the next attempt) can read it, then exit with
    # the protocol code — never hang in the collective
    def _default_peer_dead(self, failure: PeerFailure) -> None:
        if self.telemetry.enabled:
            # the event layer flushes per record, so the classification
            # is on the timeline before os._exit skips every atexit hook
            self.telemetry.counter("supervisor_exit_peer_dead").inc()
            self.telemetry.event(
                "supervisor.exit", status="peer_dead",
                dead_process=failure.process,
                age_s=round(failure.age_s, 1),
                observed_by=self.process_id)
        if self.heartbeat_dir:
            # atomic (tmp + os.replace): the supervisor reads this
            # breadcrumb after our os._exit, so it must see the whole
            # classification or none of it — never a torn JSON
            dst = os.path.join(
                self.heartbeat_dir,
                f"peer_failure_p{self.process_id:05d}.json")
            try:
                tmp = f"{dst}.tmp.{os.getpid()}"
                with open(tmp, "w") as fh:
                    json.dump({"process": failure.process,
                               "age_s": round(failure.age_s, 1),
                               "last_step": failure.last_step,
                               "observed_by": self.process_id}, fh)
                os.replace(tmp, dst)
            except OSError:
                pass
        os._exit(EXIT_PEER_DEAD)

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            start_step: int = 0,
            resumed_from: Optional[int] = None,
            meta: Optional[Callable[[int, Any], dict]] = None,
            ) -> tuple[Any, LoopOutcome]:
        """Run from ``start_step`` (exclusive) to ``total_steps``.

        ``step_fn(state, step) -> state`` is one train step (1-indexed
        ``step``). Returns the final state and a :class:`LoopOutcome`;
        on preemption the caller decides the exit path (the module-level
        workers exit ``EXIT_PREEMPTED``).
        """
        hb = None
        monitor = None
        step = start_step
        emergency_saved = False
        reg = self.telemetry
        if reg.enabled:
            reg.counter("supervisor_runs").inc()
            if resumed_from is not None:
                # this attempt is a RESTART: it resumed a prior attempt's
                # checkpoint — the counter a fleet dashboard alarms on
                reg.counter("supervisor_restart_attempts").inc()
                reg.event("supervisor.restart",
                          resumed_from=resumed_from,
                          process=self.process_id,
                          world=self.num_processes)
        try:
            if self.heartbeat_dir and self.num_processes >= 1:
                hb = Heartbeat(self.heartbeat_dir, self.process_id,
                               self.cfg.heartbeat_interval_s).start()
                hb.beat(step)
            if self.heartbeat_dir and self.num_processes > 1:
                monitor = HeartbeatMonitor(
                    self.heartbeat_dir, self.num_processes,
                    timeout_s=self.cfg.heartbeat_timeout_s,
                    self_id=self.process_id, telemetry=reg,
                ).watch(self.on_peer_dead or self._default_peer_dead)
            with PreemptionGuard(self.cfg.grace_seconds) as guard:
                while step < self.total_steps:
                    try:
                        state = step_fn(state, step + 1)
                    except Exception:
                        # gloo and NCCL raise where a peer's death leaves
                        # other fabrics hung: give the monitor its bound
                        # to classify the peer (EXIT_PEER_DEAD) before
                        # the error itself gets out
                        if monitor is not None:
                            monitor.wait_for_verdict()
                        raise
                    step += 1
                    if hb is not None:
                        hb.beat(step)
                    saved_this_step = False
                    if self.ckpt is not None and (
                            step % self.save_every == 0 or
                            step == self.total_steps):
                        self.ckpt.save(
                            step, state,
                            meta=meta(step, state) if meta else
                            {"step": step})
                        saved_this_step = True
                    if guard.preempted and step < self.total_steps:
                        # drained: the in-flight step finished. Commit an
                        # emergency checkpoint inside the grace budget so
                        # the restart loses nothing — flush first so a
                        # pending async save cannot race the final one.
                        if self.ckpt is not None and not saved_this_step:
                            self.ckpt.save(
                                step, state,
                                meta=meta(step, state) if meta else
                                {"step": step, "emergency": True})
                            emergency_saved = True
                        if self.ckpt is not None:
                            self.ckpt.flush()
                        if reg.enabled:
                            reg.counter("supervisor_exit_preempted").inc()
                            reg.event("supervisor.exit",
                                      status="preempted", step=step,
                                      emergency_saved=emergency_saved,
                                      process=self.process_id)
                        return state, LoopOutcome(
                            "preempted", step, resumed_from,
                            emergency_saved)
                if self.ckpt is not None:
                    self.ckpt.flush()
                if reg.enabled:
                    reg.event("supervisor.exit", status="completed",
                              step=step, process=self.process_id)
                return state, LoopOutcome(
                    "completed", step, resumed_from, emergency_saved)
        finally:
            if monitor is not None:
                monitor.stop()
            if hb is not None:
                hb.stop()
