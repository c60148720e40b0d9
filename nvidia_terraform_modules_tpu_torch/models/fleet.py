# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The fleet router — the port of the reference's ``models/fleet.py``:
prefix-affinity routing over several serve engines, SLO shedding, work
stealing, disaggregated prefill/decode and the fault plane.

``N`` engine replicas (threads of this process, or spawned processes:
``models/transport.py``) sit behind a router that decides which replica
serves which request and when, driving each through the engine's
``AdmissionSource`` seam (``run(admission=)``):

- **Affinity routing.** A prompt's routing key is the head of its
  ``PrefixIndex`` chain (the index's own key for its first full block),
  consistent-hashed onto a ring of virtual nodes (:class:`HashRing`), so
  prompts of one template land where that template's blocks are. Keys and
  ring targets are the reference's byte for byte. ``affinity_queue_bound``
  sends a request to the least-loaded replica when its target's predicted
  backlog reaches the bound.
- **SLO shedding.** Per-request ``deadlines`` and ``est_token_s`` drive a
  deterministic virtual clock a replica; a request whose predicted
  completion blows its deadline is shed before any device work (``None``
  in its place). The shed set is a pure function of the trace.
- **Stealing.** While replicas run, a queue holding two or more pending
  requests gives its TAIL to an empty one.
- **Disaggregated prefill/decode** (``disaggregate=True``): prefill workers
  run ``prefill_session`` (K1 on the card) and hand each prompt's blocks to
  the least-loaded decode worker as a ``kv_import`` payload; decode
  workers run waves only (K7) and never a prefill.
- **The fault plane** (``faults=``, off by default): a seeded
  :class:`FleetFaultProfile` of replica kills, prefill kills, slow
  replicas, planned drains and corrupt handoffs on the fleet's clock. A
  kill is raised out of the replica's own admission poll
  (:class:`ReplicaKilled`), or is a real ``SIGKILL`` under
  ``transport="multiproc"``; a health monitor (``resilience.
  LivenessBreaker``) classifies slow replicas, takes dead ones off the ring
  and redrives their queued and in-flight requests to survivors from the
  original prompt. Tokens are schedule-invariant, so a redriven request's
  tokens equal the undisturbed run's.

- **The elastic plane** (``autoscale=``, off by default): a string-seeded
  :class:`AutoscalePolicy` evaluated on the routing plan's virtual clock
  emits a deterministic scale schedule (the reference's, event for event),
  executed at monitor polls as kills are. A scale-up spawns the joiner
  (``utils/retry``; a spawn that fails every attempt is classified dead
  and its requests redrive), adds it to the ring and, with the engines'
  tiered index, seeds its host tier with its keyspace share of the
  fleet-shared :class:`~.hostkv.WarmChainStore` (a warm join). A
  scale-down is a planned drain; the drained replica publishes its
  retained chains into the store.
- **The durable prefix CDN** (``disk_spill=<dir>``): one fleet-shared
  store (``cdn_blocks`` rows) with a crash-safe
  :class:`~.hostkv.DiskChainStore` under ``<dir>``. In-process replicas
  mount it (``shared_store``); process replicas run a private host tier
  seeded from it at bring-up and publish back at close. A new fleet over
  the same directory comes up warm from disk, and a store-resident chain
  may leave a backlogged affinity target (``_CDN_QUEUE_BOUND``).

The router is scheduling, never a different model: a 1-replica fleet
equals the bare engine request for request, and N replicas equal solo
greedy decoding whatever the placement, steals, kills, drains or scale
events. Telemetry: a ``fleet_route`` span a request on the registry the
engines share, the ``fleet_queue_depth``/``fleet_affinity_hit_frac``
gauges, the ``fleet_shed_total``/``fleet_steal_total``/
``fleet_replica_down``/``fleet_redrive_total``/``fleet_circuit_open_total``
counters and, with ``autoscale``, the ``fleet_size`` gauge, the
``fleet_scale_up_total``/``fleet_scale_down_total`` counters and a
``fleet_scale`` span an executed event.

Each call's ``last_stats["fleet"]["launches"]`` holds every worker's kernel
launches (``ops._build`` names; a killed process's are lost with it).

With ``aot_cache`` among the engine levers, every bring-up — a base
replica at the call's start, a joiner at its poll — warms its engine
against the call's schedule (``Transport.warm_replica``,
``models/aotcache.py``) before its first wave; the scale ledger counts
``warm_compiles`` and ``warm_compile_errors`` and the ``fleet_scale`` span
carries ``warm_compile=``.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import random
import threading
import time
import zlib
from typing import Any, Sequence

import numpy as np
import torch

from ..ops import _build
from ..utils.retry import RetryPolicy, retry_call
from .burnin import BurnInConfig, tree_leaves
from .paging import PrefixIndex, chain_chunks, transfer_crc
from .resilience import LivenessBreaker
from .serving import AdmissionSource
from .transport import (
    InProcTransport,
    MultiProcTransport,
    Transport,
    _on_stream,
    start_worker,
)

_ROUTINGS = ("affinity", "random")

# the CDN's residency routing: how deep an affinity target's predicted
# backlog may grow before a STORE-RESIDENT chain goes least-loaded (any
# replica admits it warm from the store); affinity_queue_bound= overrides
# it for every chain
_CDN_QUEUE_BOUND = 4


def _blake_int(data: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big")


def _host_tokens(tokens) -> torch.Tensor:
    """A prompt as a flat int64 tensor on the host."""
    if isinstance(tokens, torch.Tensor):
        return tokens.detach().reshape(-1).long().cpu()
    return torch.tensor(np.asarray(tokens), dtype=torch.long).reshape(-1)


def affinity_key(tokens, block_size: int) -> bytes:
    """A prompt's routing key: ``PrefixIndex``'s key for its first full
    ``block_size`` chunk, so two prompts share a key exactly when the index
    could share their first block; a prompt shorter than a block keys on
    its whole token string."""
    toks = _host_tokens(tokens).tolist()
    chunks = chain_chunks(toks, block_size)
    if chunks:
        return PrefixIndex._key(None, chunks[0])
    return hashlib.blake2b(
        ("short:" + ",".join(str(t) for t in toks)).encode(),
        digest_size=16).digest()


class HashRing:
    """Consistent-hash ring with virtual nodes: each target owns ``vnodes``
    seeded points on a 64-bit ring and a key routes to the first point
    clockwise. :meth:`remove` moves only the removed target's keyspace and
    :meth:`add` of it restores the assignment exactly."""

    def __init__(self, n_targets: int, vnodes: int = 16):
        if n_targets < 1:
            raise ValueError(f"need >= 1 target, got {n_targets}")
        self.vnodes = vnodes
        self._members: set[int] = set(range(n_targets))
        self._rebuild()

    def _rebuild(self) -> None:
        pts = sorted(
            (_blake_int(f"fleet-target-{t}-vnode-{v}".encode()), t)
            for t in self._members for v in range(self.vnodes))
        self._points = [p for p, _ in pts]
        self._targets = [t for _, t in pts]

    def add(self, target: int) -> None:
        if target in self._members:
            raise ValueError(f"target {target} already on the ring")
        self._members.add(target)
        self._rebuild()

    def remove(self, target: int) -> None:
        if target not in self._members:
            raise ValueError(f"target {target} is not on the ring")
        if len(self._members) == 1:
            raise ValueError("cannot remove the last ring target")
        self._members.remove(target)
        self._rebuild()

    def targets(self) -> set[int]:
        return set(self._members)

    def target(self, key: bytes) -> int:
        i = bisect.bisect_right(self._points, _blake_int(key)) \
            % len(self._points)
        return self._targets[i]


# --------------------------------------------------------- elastic plane


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The fleet's deterministic autoscaler (the reference's, field for
    field): evaluated on the routing plan's virtual clock at every arrival,
    after the arrival lands, against the mean backlog a live replica (its
    queued-but-unfinished virtual jobs).

    - ``up_backlog``: a mean at or above it (live count below
      ``max_replicas``) joins a new replica — trigger ``"backlog"``; with
      deadlines and ``deadline_slack``, an arrival that would be shed joins
      one first — ``"deadline_slack"``.
    - ``down_backlog``: a mean at or below it (live count above
      ``min_replicas``) drains the least-loaded replica — ``"low_load"``;
      ties draw from the policy's seeded stream.

    ``cooldown_s`` (virtual seconds) spaces events. The schedule is a pure
    function of (policy, seed, trace, ``est_token_s``, fault capacity
    schedule); an up spawns its replica at the first monitor poll past its
    time, a down drains it through ``AdmissionSource.draining()``."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_backlog: float = 3.0
    down_backlog: float = 0.5
    cooldown_s: float = 0.05
    deadline_slack: bool = True
    seed: str | int = 0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        if self.up_backlog <= self.down_backlog:
            raise ValueError(
                f"up_backlog ({self.up_backlog}) must exceed "
                f"down_backlog ({self.down_backlog}) — equal or "
                f"inverted thresholds oscillate")
        if self.down_backlog < 0:
            raise ValueError(
                f"down_backlog must be >= 0, got {self.down_backlog}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {self.cooldown_s}")


# a joiner's spawn retried with backoff: a transient build failure costs a
# retry; one that fails every attempt classifies the target dead
_SPAWN_RETRY = RetryPolicy(initial_s=0.002, multiplier=2.0,
                           cap_s=0.05, max_attempts=3, jitter=False)


# ------------------------------------------------------------ fault plane


class ReplicaKilled(RuntimeError):
    """Fault-injected replica death, raised out of the replica's own
    admission poll: its wave loop dies mid-run, outputs lost. The router
    classifies the death and redrives; nothing above the fleet sees it."""

    def __init__(self, label: str, at_s: float):
        super().__init__(
            f"{label} killed by fault injection at t={at_s:.3f}s")
        self.label = label
        self.at_s = at_s


class HandoffCorruptError(RuntimeError):
    """A disaggregated handoff payload failed its crc — classified and
    RETRYABLE: the handoff re-runs from prefill."""


class FleetWorkerHung(RuntimeError):
    """A fleet worker did not join within ``join_timeout_s``: process
    workers are SIGKILLed, thread workers abandoned (daemons), and the
    hang is reported with every hung worker named."""

    def __init__(self, workers: Sequence[str], timeout_s: float):
        super().__init__(
            f"fleet worker(s) {', '.join(workers)} failed to join "
            f"within join_timeout_s={timeout_s:.1f}s — classified "
            f"HUNG (process workers SIGKILLed, thread workers "
            f"abandoned); raise join_timeout_s if the workload "
            f"legitimately runs longer")
        self.workers = list(workers)
        self.timeout_s = timeout_s


_FAULT_KINDS = (
    "kill_replica",      # kill a decode replica mid-wave (poll boundary)
    "kill_prefill",      # kill a prefill worker (disaggregated only)
    "slow_replica",      # stall a decode replica's waves (trips the breaker)
    "drain_replica",     # planned removal of a decode replica (no recompute)
    "drain_prefill",     # planned removal of a prefill worker
    "corrupt_handoff",   # corrupt a prefill worker's nth handoff payload
)


@dataclasses.dataclass(frozen=True)
class FleetFault:
    """One scheduled fault. ``target`` is the role-relative replica index
    (``None``: drawn from the profile's seeded stream); ``at_s`` the
    trigger on the fleet's clock. Kills and drains land at the replica's
    next poll past ``at_s``; ``slow_replica`` stalls ``waves`` waves by
    ``stall_s`` each; ``corrupt_handoff`` corrupts the worker's ``nth``
    handoff."""

    kind: str
    target: int | None = None
    at_s: float = 0.0
    stall_s: float = 0.0
    waves: int = 4
    nth: int = 1

    def __post_init__(self):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}: "
                f"use {' | '.join(_FAULT_KINDS)}")
        if self.target is not None and self.target < 0:
            raise ValueError(f"target must be >= 0, got {self.target}")
        if self.at_s < 0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s}")
        if self.kind == "slow_replica":
            if self.stall_s <= 0:
                raise ValueError(
                    "slow_replica needs stall_s > 0 (the per-wave stall)")
            if self.waves < 1:
                raise ValueError(
                    f"slow_replica needs waves >= 1, got {self.waves}")
        if self.kind == "corrupt_handoff" and self.nth < 1:
            raise ValueError(f"nth must be >= 1, got {self.nth}")


class FleetFaultProfile:
    """A seeded fault schedule: every unresolved target draws from ONE
    string-seeded stream in spec order, so identical ``(seed, faults)``
    resolve to the identical schedule (the reference's, value for value).
    ``resolve`` validates against the fleet shape: a schedule may never
    take the last replica of a role."""

    def __init__(self, faults: Sequence[FleetFault],
                 seed: str | int = 0):
        faults = tuple(faults)
        for i, f in enumerate(faults):
            if not isinstance(f, FleetFault):
                raise ValueError(
                    f"faults[{i}] must be a FleetFault, got {type(f)}")
        self.faults = faults
        self.seed = str(seed)

    def resolve(self, n_dec: int, n_pre: int, *,
                elastic_dec: bool = False) -> dict:
        """The concrete schedule: ``kills_dec``/``drains_dec``/
        ``kills_pre``/``drains_pre`` (target → at_s), ``slow_dec`` (target →
        (at_s, stall_s, waves)) and ``corrupt`` (prefill target → nth).
        ``elastic_dec`` (an autoscaled fleet): explicit decode targets may
        name scale-up joiners beyond ``n_dec``, checked per call against
        the realised fleet; seeded draws still come from the base range."""
        rnd = random.Random(f"fleet-fault-{self.seed}")
        out: dict[str, dict] = {
            "kills_dec": {}, "drains_dec": {},
            "kills_pre": {}, "drains_pre": {},
            "slow_dec": {}, "corrupt": {},
        }
        for i, f in enumerate(self.faults):
            pre_side = f.kind in ("kill_prefill", "drain_prefill",
                                  "corrupt_handoff")
            pool = n_pre if pre_side else n_dec
            # one draw a spec whatever its targeting: the stream depends on
            # the seed and the spec order only
            drawn = rnd.randrange(max(pool, 1))
            if pre_side and pool == 0:
                raise ValueError(
                    f"faults[{i}] ({f.kind}) needs disaggregate=True "
                    f"(there are no prefill workers to target)")
            t = f.target if f.target is not None else drawn
            if t >= pool and not (elastic_dec and not pre_side):
                raise ValueError(
                    f"faults[{i}] ({f.kind}) targets replica {t} but "
                    f"the role has only {pool}")
            key = {"kill_replica": "kills_dec",
                   "drain_replica": "drains_dec",
                   "kill_prefill": "kills_pre",
                   "drain_prefill": "drains_pre",
                   "slow_replica": "slow_dec",
                   "corrupt_handoff": "corrupt"}[f.kind]
            if f.kind == "slow_replica":
                if t in out["slow_dec"]:
                    raise ValueError(
                        f"faults[{i}]: duplicate slow_replica on {t}")
                out["slow_dec"][t] = (f.at_s, f.stall_s, f.waves)
            elif f.kind == "corrupt_handoff":
                if t in out["corrupt"]:
                    raise ValueError(
                        f"faults[{i}]: duplicate corrupt_handoff on {t}")
                out["corrupt"][t] = f.nth
            else:
                side = "pre" if pre_side else "dec"
                if t in out[f"kills_{side}"] \
                        or t in out[f"drains_{side}"]:
                    raise ValueError(
                        f"faults[{i}]: replica {t} already scheduled "
                        f"to die/drain")
                out[key][t] = f.at_s
        gone_dec = set(out["kills_dec"]) | set(out["drains_dec"])
        if gone_dec and len(gone_dec) >= n_dec and not elastic_dec:
            raise ValueError(
                f"the fault schedule removes all {n_dec} decode "
                f"replica(s) — the fleet must keep >= 1 survivor to "
                f"redrive onto")
        gone_pre = set(out["kills_pre"]) | set(out["drains_pre"])
        if gone_pre and len(gone_pre) >= n_pre:
            raise ValueError(
                f"the fault schedule removes all {n_pre} prefill "
                f"worker(s) — redrives need a surviving prefill side")
        return out


def _payload_crc(payload: dict) -> int:
    """crc32 over a handoff payload: the token count and the first token
    (as the reference's int32) chained onto ``paging.transfer_crc`` of the
    block buffers."""
    crc = zlib.crc32(str(int(payload["n_tokens"])).encode())
    crc = zlib.crc32(np.asarray(int(payload["first"]), np.int32).tobytes(),
                     crc)
    return zlib.crc32(
        transfer_crc(payload["blocks"]).to_bytes(4, "big"), crc)


def _corrupt_payload(payload: dict) -> dict:
    """Add one to the first element of the first transferred buffer — the
    wire corruption the crc exists to catch. A shallow copy; the clean
    retry exports again."""
    blocks = {k: list(v) for k, v in payload["blocks"].items()}
    k0 = sorted(blocks)[0]
    buf = blocks[k0][0].clone()
    buf.view(-1)[0] += 1
    blocks[k0][0] = buf
    return dict(payload, blocks=blocks)


# corruption is detected at once (crc): the budget matters, not the backoff
_HANDOFF_RETRY = RetryPolicy(initial_s=0.001, multiplier=2.0,
                             cap_s=0.01, max_attempts=3, jitter=False)


class _FleetQueue(AdmissionSource):
    """One replica's admission stream, owned by the router: thread-safe
    (the engine polls from its run thread, the router primes, steals and
    closes from its own), arrival-ordered, with optional per-request
    ``kv_import`` payloads. ``exhausted()`` is closed AND empty: an open,
    empty queue keeps its engine's wave loop alive so a steal or a late
    handoff can still land.

    It is also the replica's FAULT SEAM: each engine-facing poll stamps
    ``last_poll`` (the health monitor's liveness signal), an armed kill
    raises :class:`ReplicaKilled` at the first poll past its trigger, a
    slow fault stalls ``tick()`` and ``set_draining`` stops admission."""

    def __init__(self, t0: float, poll_s: float, on_retire, *,
                 label: str = "", kill_at: float | None = None,
                 stall: tuple | None = None, sink=None):
        self._lock = threading.Lock()
        # warm bring-up chains the router primes before the spawn (read
        # once, at the run's start) and the store the retained chains
        # publish into at close
        self._warm: list | None = None
        self._sink = sink
        self._pending: list[int] = []            # arrival-ascending
        self._arrival: dict[int, float] = {}
        self._payload: dict[int, Any] = {}
        self._closed = False
        self._claimed: int | None = None         # candidate in flight
        self.t0 = t0
        self.poll_s = poll_s
        self._on_retire = on_retire
        self.admitted = 0
        self.label = label
        self.dead = False
        self.halted = False
        self.killed_at: float | None = None
        self._kill_at = kill_at
        self._stall = stall                      # (at_s, stall_s, waves)
        self._stalled = 0
        self._draining = False
        self._popped: set[int] = set()
        self.last_poll = time.monotonic()
        # flips once the replica has finished its first unit of work: until
        # then a poll gap is a build or a capture, not sickness
        self.work_done = False

    def _pulse(self) -> float:
        """Heartbeat and kill trigger, at every engine-facing poll."""
        now = time.monotonic()
        self.last_poll = now
        rel = now - self.t0
        if self._kill_at is not None and rel >= self._kill_at:
            with self._lock:
                # again under the lock: once disarm() returns no kill fires
                armed = self._kill_at is not None
                if armed:
                    self.dead = True
                    if self.killed_at is None:
                        self.killed_at = rel
            if armed:
                raise ReplicaKilled(self.label, rel)
        return rel

    def _insort(self, req: int) -> None:
        bisect.insort(self._pending, req,
                      key=lambda r: (self._arrival[r], r))

    # ---- router-facing -------------------------------------------
    def add(self, req: int, arrival: float = 0.0, payload=None) -> None:
        with self._lock:
            self._arrival[req] = arrival
            if payload is not None:
                self._payload[req] = payload
            self._insort(req)

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def halt(self) -> None:
        """The process is exiting: the next engine-facing poll raises
        :class:`ReplicaKilled`, so the worker polling this queue returns
        (``transport.start_worker``)."""
        with self._lock:
            self.halted = True
            self._kill_at = float("-inf")

    def disarm(self) -> None:
        """Clear armed faults: the run ended before they could fire."""
        with self._lock:
            self._kill_at = None
            self._stall = None

    def set_draining(self) -> None:
        """Planned removal: stop yielding candidates; in-flight work
        finishes, the router sweeps what is pending."""
        with self._lock:
            self._draining = True

    def drain_pending(self):
        """Remove and return every pending ``(req, arrival, payload)`` but
        a mid-claim candidate (repeat until :meth:`pending_count` is 0)."""
        with self._lock:
            moved = [(r, self._arrival[r], self._payload.pop(r, None))
                     for r in self._pending if r != self._claimed]
            self._pending = [r for r in self._pending
                             if r == self._claimed]
            return moved

    def take_lost(self):
        """What a dead replica takes with it: its pending entries and the
        admitted request ids whose outputs died in its run. Closes the
        stream."""
        with self._lock:
            pend = [(r, self._arrival[r], self._payload.pop(r, None))
                    for r in self._pending]
            self._pending.clear()
            popped = sorted(self._popped)
            self._popped.clear()
            self._closed = True
            return pend, popped

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def steal_tail(self):
        """Remove and return the latest-arrival pending entry — only with
        two or more pending and the tail not the claimed candidate."""
        with self._lock:
            if len(self._pending) < 2 \
                    or self._pending[-1] == self._claimed:
                return None
            req = self._pending.pop()
            return (req, self._arrival[req],
                    self._payload.pop(req, None))

    # ---- engine-facing (AdmissionSource) -------------------------
    def candidate(self):
        self._pulse()
        now = time.monotonic() - self.t0
        with self._lock:
            if self._draining or not self._pending:
                self._claimed = None
                return None
            head = self._pending[0]
            if self._arrival[head] > now:
                self._claimed = None
                return None
            # claimed under the lock the stealer takes: not stolen until
            # pop() or the next candidate()
            self._claimed = head
            return head

    def pop(self, req) -> None:
        # an admission is proof of life
        self.last_poll = time.monotonic()
        with self._lock:
            self._pending.remove(req)
            if self._claimed == req:
                self._claimed = None
            self._popped.add(req)
            self.admitted += 1

    def requeue(self, req) -> None:
        with self._lock:
            self._insort(req)
            self._popped.discard(req)

    def tick(self) -> None:
        """Per wave: heartbeat, and the slow fault's stall."""
        self._pulse()
        self.work_done = True
        st = self._stall
        if st is not None and self._stalled < st[2] \
                and time.monotonic() - self.t0 >= st[0]:
            self._stalled += 1
            time.sleep(st[1])

    def draining(self) -> bool:
        return self._draining

    def waiting(self) -> int:
        now = time.monotonic() - self.t0
        with self._lock:
            return sum(1 for r in self._pending
                       if self._arrival[r] <= now)

    def exhausted(self) -> bool:
        self._pulse()
        with self._lock:
            return self._closed and not self._pending

    def idle_wait(self) -> None:
        self._pulse()
        now = time.monotonic() - self.t0
        with self._lock:
            nxt = (self._arrival[self._pending[0]]
                   if self._pending else None)
        if nxt is not None and nxt > now:
            time.sleep(min(nxt - now, self.poll_s))
        else:
            time.sleep(self.poll_s)

    def wait_s(self, req) -> float:
        return max(0.0, time.monotonic() - self.t0
                   - self._arrival.get(req, 0.0))

    def kv_import(self, req):
        return self._payload.get(req)

    def set_warm(self, chains) -> None:
        with self._lock:
            self._warm = chains

    def warm_chains(self):
        """One-shot: the engine reads the primed chains at its run's start
        (a second run through the same queue starts cold)."""
        with self._lock:
            warm, self._warm = self._warm, None
            return warm

    def chain_sink(self):
        return self._sink

    def retired(self, req, tokens: int) -> None:
        with self._lock:
            self._payload.pop(req, None)
        self._on_retire(req, tokens)


def _take_next(q: _FleetQueue):
    """Blocking pull for the prefill-worker loop: the next request, or
    None once the router closes the (empty or draining) queue."""
    while True:
        req = q.candidate()
        if req is not None:
            q.pop(req)
            return req
        if q.exhausted():
            return None
        q.idle_wait()


def make_fleet(params, cfg: BurnInConfig, *, max_len: int,
               replicas: int = 2, routing: str = "affinity",
               affinity_queue_bound: int | None = None,
               disaggregate: bool = False, prefill_workers: int = 1,
               steal: bool = True, steal_poll_s: float = 0.002,
               est_token_s: float | None = None,
               telemetry=None, route_seed: int = 0,
               faults: FleetFaultProfile | None = None,
               health_timeout_s: float = 0.25,
               quarantine_polls: int = 16,
               autoscale: AutoscalePolicy | None = None,
               warm_join: bool = True,
               warm_blocks: int | None = None,
               disk_spill: str | None = None,
               cdn_blocks: int | None = None,
               transport: str | Transport = "inproc",
               join_timeout_s: float = 600.0,
               **engine_kw):
    """Build the fleet: ``replicas`` serve engines behind the router, on
    the device of ``params`` (or ``device=`` in ``engine_kw``).

    Returns ``fleet(prompts, n_new, *, slots=4, eos_id=None, rng=None,
    arrivals=None, deadlines=None, kv_blocks=None) → list``: one token
    tensor a request in request order, ``None`` where SLO admission shed
    it. ``fleet.last_stats`` then holds ``"replica_stats"`` (each decode
    engine's stats; ``None`` for a replica killed mid-run) and the router's
    ``"fleet"`` record: request counts, occupancy, waves and KV peaks a
    replica (each worker's flash prefills; a decode worker's handoff imports
    and a prefill worker's exports, with their device ms on the card), the
    affinity hit fraction, shed and steal counts, deadline attainment,
    arrival → completion latency, the ``"faults"`` record when a profile
    is armed, and each worker's kernel ``"launches"``. A replica thread's
    outputs reach the caller's current stream (it waits on the replica's),
    so the caller reads them without a synchronize.

    ``routing`` (``"affinity"`` | ``"random"``), ``affinity_queue_bound``,
    ``deadlines`` + ``est_token_s`` (SLO shedding), ``disaggregate`` /
    ``prefill_workers`` (greedy only), ``steal`` / ``steal_poll_s``,
    ``faults`` / ``health_timeout_s`` / ``quarantine_polls`` (the fault
    plane), ``transport`` (``"inproc"`` | ``"multiproc"`` | a
    :class:`~.transport.Transport` kept across calls) and
    ``join_timeout_s`` (a worker that does not join raises
    :class:`FleetWorkerHung`) are the reference's. ``**engine_kw`` goes to
    every ``make_serve_engine``; an engine driven by the router never uses
    its own ``policy``. ``telemetry`` (default the process registry) is
    shared with every engine.

    ``autoscale`` (an :class:`AutoscalePolicy`; colocated fleets, needs
    ``est_token_s``) makes ``replicas`` the initial size inside the
    policy's bounds; the plan's scale schedule runs at monitor polls. With
    ``share_prefix`` + ``host_spill`` engines, affinity routing and
    ``warm_join``, a joiner's host tier is seeded with its keyspace share
    of the fleet's warm store (``warm_blocks`` rows, default
    ``max(4·prefix_keep_blocks, 64)``). ``last_stats["fleet"]["scale"]``
    holds the events, joins (warm and cold), drains and the store's
    ledger.

    ``disk_spill=<dir>`` (``share_prefix``, affinity routing, colocated;
    without ``host_spill``/``shared_store`` in ``engine_kw``) arms the
    durable prefix CDN: one shared store of ``cdn_blocks`` rows (default as
    ``warm_blocks``) with its disk tier under ``<dir>``, restored at build;
    ``last_stats["fleet"]["cdn"]`` holds its ledger, the residency
    reroutes and the host-bytes bill, and ``fleet.cdn_store`` is the
    store.

    ``aot_cache=<dir>`` (an engine lever) warms every replica bring-up —
    a base replica at the call's start, an elastic joiner at its poll —
    against the call's schedule (its slots, ``kv_blocks``, prompt lengths
    and largest budget) through ``Transport.warm_replica`` before its
    first wave, so the wave replays graphs the warm captured and the
    library comes from the cache. The ``fleet_scale`` span carries
    ``warm_compile=`` and the scale ledger counts ``warm_compiles`` /
    ``warm_compile_errors``; a warm that fails is recorded there and the
    replica launches cold, never dead."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if routing not in _ROUTINGS:
        raise ValueError(f"unknown routing {routing!r}: "
                         f"use {' | '.join(_ROUTINGS)}")
    if affinity_queue_bound is not None and affinity_queue_bound < 1:
        raise ValueError(f"affinity_queue_bound must be >= 1, got "
                         f"{affinity_queue_bound}")
    if est_token_s is not None and est_token_s <= 0:
        raise ValueError(f"est_token_s must be > 0, got {est_token_s}")
    if health_timeout_s <= 0:
        raise ValueError(
            f"health_timeout_s must be > 0, got {health_timeout_s}")
    if quarantine_polls < 1:
        raise ValueError(
            f"quarantine_polls must be >= 1, got {quarantine_polls}")
    if faults is not None and not isinstance(faults, FleetFaultProfile):
        raise ValueError(
            f"faults must be a FleetFaultProfile, got {type(faults)}")
    if autoscale is not None:
        if not isinstance(autoscale, AutoscalePolicy):
            raise ValueError(
                f"autoscale must be an AutoscalePolicy, got "
                f"{type(autoscale)}")
        if disaggregate:
            raise ValueError(
                "autoscale applies to colocated fleets — the elastic "
                "ring is the decode ring; run disaggregated pools at "
                "fixed size (scale the colocated fleet instead)")
        if est_token_s is None:
            raise ValueError(
                "autoscale needs est_token_s — the policy's virtual "
                "clock predicts backlog as est_token_s × budget, "
                "exactly like SLO shedding")
        if not (autoscale.min_replicas <= replicas
                <= autoscale.max_replicas):
            raise ValueError(
                f"replicas ({replicas}) must start inside the "
                f"autoscale bounds [{autoscale.min_replicas}, "
                f"{autoscale.max_replicas}]")
    if warm_blocks is not None and warm_blocks < 1:
        raise ValueError(f"warm_blocks must be >= 1, got {warm_blocks}")
    if cdn_blocks is not None and cdn_blocks < 1:
        raise ValueError(f"cdn_blocks must be >= 1, got {cdn_blocks}")
    cdn_on = disk_spill is not None
    if cdn_on:
        if routing != "affinity":
            raise ValueError(
                "disk_spill arms the prefix CDN — its residency map is "
                "keyed on the affinity chain key; use routing='affinity'")
        if disaggregate:
            raise ValueError(
                "disk_spill applies to colocated fleets — the prefix "
                "CDN rides the decode replicas' tiered index (see "
                "host_spill × disaggregate)")
        if not engine_kw.get("share_prefix"):
            raise ValueError(
                "disk_spill is the prefix index's CDN tier — pass "
                "share_prefix=True (there is nothing to publish "
                "without an index)")
        if engine_kw.get("host_spill") or \
                engine_kw.get("shared_store") is not None:
            raise ValueError(
                "disk_spill owns the tier wiring: the fleet decides "
                "per transport whether replicas mount the shared store "
                "directly (in-proc) or run a seeded private host tier "
                "(process-isolated) — drop host_spill/shared_store "
                "from engine_kw")
    if join_timeout_s <= 0:
        raise ValueError(
            f"join_timeout_s must be > 0, got {join_timeout_s}")
    if isinstance(transport, str):
        if transport == "inproc":
            tr: Transport = InProcTransport()
        elif transport == "multiproc":
            tr = MultiProcTransport()
        else:
            raise ValueError(
                f"unknown transport {transport!r}: use 'inproc' | "
                f"'multiproc' | a Transport instance")
    elif isinstance(transport, Transport):
        tr = transport
    else:
        raise ValueError(
            f"transport must be 'inproc', 'multiproc' or a "
            f"Transport instance, got {type(transport)}")
    if disaggregate:
        if replicas < 2:
            raise ValueError(
                "disaggregate=True needs >= 2 replicas (at least one "
                "prefill worker AND one decode worker)")
        if not 1 <= prefill_workers <= replicas - 1:
            raise ValueError(
                f"prefill_workers must be in [1, replicas-1] = "
                f"[1, {replicas - 1}], got {prefill_workers}")
        if engine_kw.get("sampler") is not None:
            raise ValueError(
                "disaggregated serving is greedy-only: the prefill "
                "handoff carries a greedily picked first token")
        for k in ("spec_k", "prefix", "prefill_chunk"):
            if engine_kw.get(k) is not None:
                raise ValueError(
                    f"disaggregate=True does not compose with {k} "
                    f"(see prefill_session)")
        if engine_kw.get("host_spill"):
            raise ValueError(
                "disaggregate=True does not compose with host_spill — "
                "the prefill→decode handoff donates device-resident "
                "blocks and a spilled chain has no device rows to "
                "export; run the tiered KV cache on colocated "
                "replicas (see prefill_session)")
    from ..telemetry import get_registry

    engine_kw.setdefault("device", tree_leaves(params)[0].device)
    dev = torch.device(engine_kw["device"])
    reg = telemetry if telemetry is not None else get_registry()
    kv_block = engine_kw.get("kv_block", 16)
    n_pre = prefill_workers if disaggregate else 0
    n_dec = replicas - n_pre
    scale_on = autoscale is not None
    # a fixed fleet resolves its faults now; an elastic one per call
    # (explicit targets may name joiners the plan realises)
    resolved = (faults.resolve(n_dec, n_pre)
                if faults is not None and not scale_on else None)

    def _route_events(res):
        """The capacity schedule the plan's clock degrades against: kills
        and drains of the routing side's targets, in time order."""
        if res is None:
            return []
        side = "pre" if disaggregate else "dec"
        return sorted(
            [(ts, t, "kill") for t, ts in res[f"kills_{side}"].items()]
            + [(ts, t, "drain") for t, ts in res[f"drains_{side}"].items()])
    default_blocks = max(4 * engine_kw.get("prefix_keep_blocks", 64), 64)
    cache_dtype = engine_kw.get("cache_dtype", "bf16")
    # the durable prefix CDN: one shared store with its disk tier, built
    # (and restored from disk) before the engines, whose levers it sets
    cdn_store = None
    if cdn_on:
        from .hostkv import DiskChainStore, WarmChainStore

        cb = (cdn_blocks if cdn_blocks is not None
              else warm_blocks if warm_blocks is not None
              else default_blocks)
        cdn_store = WarmChainStore(
            cfg, cb, block_size=kv_block, cache_dtype=cache_dtype,
            disk=DiskChainStore(disk_spill, telemetry=reg), device=dev)
        if tr.process_isolated:
            # the store does not cross the pipe: children run a private
            # host tier seeded from it at bring-up, published back at close
            engine_kw = dict(engine_kw, host_spill=True)
        else:
            # replicas mount the store: one copy of the working set
            engine_kw = dict(engine_kw, shared_store=cdn_store)
    # the transport builds the engines (in-process: here, all of them;
    # processes: at the first launch, kept across calls)
    tr.configure(params=params, cfg=cfg, max_len=max_len,
                 engine_kw=engine_kw, registry=reg, n_dec=n_dec,
                 n_pre=n_pre)
    # the fleet's warm store: replicas publish their retained chains at
    # close or drain, joiners take their keyspace share at bring-up; kept
    # across calls. With the CDN it is the CDN's store.
    warm_store = cdn_store
    if not cdn_on and scale_on and warm_join and routing == "affinity" \
            and engine_kw.get("share_prefix") \
            and engine_kw.get("host_spill"):
        from .hostkv import WarmChainStore

        warm_store = WarmChainStore(
            cfg, warm_blocks if warm_blocks is not None else default_blocks,
            block_size=kv_block, cache_dtype=cache_dtype, device=dev)
    # each prefill worker's stream on the card, kept across calls
    pre_streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
                   for _ in range(n_pre)]
    if reg.enabled:
        _g_depth = reg.gauge("fleet_queue_depth")
        _g_hitf = reg.gauge("fleet_affinity_hit_frac")
        _c_shed = reg.counter("fleet_shed_total")
        _c_steal = reg.counter("fleet_steal_total")
        _c_down = reg.counter("fleet_replica_down")
        _c_redrive = reg.counter("fleet_redrive_total")
        _c_circuit = reg.counter("fleet_circuit_open_total")
        _g_size = reg.gauge("fleet_size")
        _c_scale_up = reg.counter("fleet_scale_up_total")
        _c_scale_down = reg.counter("fleet_scale_down_total")

    def _plan(prompts, budgets, arrivals, deadlines, route_events,
              cdn_res=None):
        """Deterministic routing, shed and SCALE plan — a pure function of
        the trace, the route seed, the fault profile's capacity schedule
        and the autoscale policy (the reference's, placement for placement
        and event for event). The virtual clock runs each target as a
        serial server at ``est_token_s`` a budgeted token; under a fault
        schedule a killed target takes no arrivals after its death and its
        unfinished virtual work re-places on the least-loaded survivor (a
        drain moves only what it had not started), deadlines checked again.
        Under a policy every arrival is a tick that may join a target (ids
        never reused) or drain the least-loaded one; a fault aimed at a
        joiner not yet joined waits for its join. With ``cdn_res`` (the
        store's residency at the call's start) a store-resident chain may
        leave a backlogged affinity target."""
        n0 = n_pre if disaggregate else n_dec
        rnd = random.Random(f"fleet-route-{route_seed}")
        ring_plan = HashRing(n0)
        busy_until = [0.0] * n0
        finishes: list[list[float]] = [[] for _ in range(n0)]
        live_jobs: list[list[list]] = [[] for _ in range(n0)]
        live: set[int] = set(range(n0))
        placed: dict[int, tuple[int, bool]] = {}
        shed: list[int] = []
        dead_plan: set[int] = set()
        ev = sorted(route_events)
        pending_ev: dict[int, list[tuple[float, str]]] = {}
        scale_events: list[dict] = []
        res_routed = [0]
        last_scale = [float("-inf")]
        rnd_scale = (random.Random(f"fleet-scale-{autoscale.seed}")
                     if scale_on else None)

        def arr(req):
            return arrivals[req] if arrivals is not None else 0.0

        def svc(req):
            return (est_token_s or 0.0) * budgets[req]

        def least_loaded(ready):
            if not live:
                raise ValueError(
                    "the capacity schedule removed every live replica "
                    "mid-trace — keep >= 1 survivor (or raise "
                    "max_replicas so the policy can rejoin)")
            return min(live, key=lambda j: (max(busy_until[j], ready), j))

        def backlog(j, now):
            return sum(1 for f in finishes[j] if f > now)

        def replace(req, ready):
            t = least_loaded(ready)
            start = max(arr(req), ready, busy_until[t])
            finish = start + svc(req)
            if deadlines is not None and finish - arr(req) \
                    > deadlines[req]:
                placed.pop(req, None)
                shed.append(req)
                return
            busy_until[t] = finish
            finishes[t].append(finish)
            live_jobs[t].append([req, start, finish])

        def take_down(t, ts, kind):
            """A kill loses even started work (it restarts on survivors);
            a drain keeps what it started and moves only the queued."""
            if t in dead_plan:
                return
            dead_plan.add(t)
            live.discard(t)
            if t in ring_plan.targets() and len(ring_plan.targets()) > 1:
                ring_plan.remove(t)
            victims = [j for j in live_jobs[t]
                       if (j[2] > ts if kind == "kill" else j[1] > ts)]
            live_jobs[t] = []
            for req, _s, _f in sorted(victims, key=lambda j: (j[1], j[0])):
                replace(req, ts)

        def advance(now):
            while ev and ev[0][0] <= now:
                ts, t, kind = ev.pop(0)
                if t >= len(busy_until):
                    # aimed at a joiner not yet joined: wait for its join
                    pending_ev.setdefault(t, []).append((ts, kind))
                    continue
                take_down(t, ts, kind)

        def join(a, trigger):
            t = len(busy_until)
            busy_until.append(0.0)
            finishes.append([])
            live_jobs.append([])
            live.add(t)
            ring_plan.add(t)
            scale_events.append({"ts": a, "kind": "up", "target": t,
                                 "trigger": trigger})
            last_scale[0] = a
            for ts, kind in sorted(pending_ev.pop(t, [])):
                if ts <= a:
                    take_down(t, a, kind)    # dies during its bring-up
                else:
                    bisect.insort(ev, (ts, t, kind))
            return t

        def can_up(a):
            return (scale_on and len(live) < autoscale.max_replicas
                    and a - last_scale[0] >= autoscale.cooldown_s)

        def eval_policy(a):
            """One tick an arrival: the thresholds against the mean
            backlog a live target."""
            if not scale_on \
                    or a - last_scale[0] < autoscale.cooldown_s \
                    or not live:
                return
            b = {j: backlog(j, a) for j in live}
            nlive = len(b)
            mean_b = sum(b.values()) / nlive
            if nlive < autoscale.max_replicas \
                    and mean_b >= autoscale.up_backlog:
                join(a, "backlog")
            elif nlive > autoscale.min_replicas \
                    and mean_b <= autoscale.down_backlog:
                # the least-loaded live target; ties from the seeded stream
                min_b = min(b.values())
                ties = sorted(j for j in b if b[j] == min_b)
                t = ties[rnd_scale.randrange(len(ties))]
                take_down(t, a, "drain")
                scale_events.append({"ts": a, "kind": "down", "target": t,
                                     "trigger": "low_load"})
                last_scale[0] = a

        for req in range(len(prompts)):
            a = arr(req)
            advance(a)
            aff_ok = routing == "affinity"
            root_key = None
            if routing == "affinity":
                root_key = affinity_key(prompts[req], kv_block)
                t_aff = ring_plan.target(root_key)
                if t_aff not in live:
                    # churn can leave the ring's last entry a dead target
                    t_aff = least_loaded(a)
                    aff_ok = False
            else:
                t_aff = rnd.randrange(len(busy_until))
                if t_aff not in live:
                    t_aff = least_loaded(a)
            t, by_aff = t_aff, aff_ok
            if affinity_queue_bound is not None:
                backlog_t = sum(1 for f in finishes[t_aff] if f > a)
                if backlog_t >= affinity_queue_bound:
                    t = least_loaded(a)
                    by_aff = by_aff and t == t_aff
            elif (cdn_res is not None and root_key is not None
                  and root_key in cdn_res):
                # the chain is warm in the shared store: any replica admits
                # it without a prefill, so a backlogged target may be left
                backlog_t = sum(1 for f in finishes[t_aff] if f > a)
                if backlog_t >= _CDN_QUEUE_BOUND:
                    t2 = least_loaded(a)
                    if t2 != t_aff:
                        t, by_aff = t2, False
                        res_routed[0] += 1
            start = max(a, busy_until[t])
            finish = start + svc(req)
            if deadlines is not None and finish - a > deadlines[req]:
                if scale_on and autoscale.deadline_slack and can_up(a):
                    # capacity before a blown deadline: join, place on the
                    # least-loaded target, shed only if still late
                    join(a, "deadline_slack")
                    t, by_aff = least_loaded(a), False
                    start = max(a, busy_until[t])
                    finish = start + svc(req)
                if finish - a > deadlines[req]:
                    shed.append(req)
                    eval_policy(a)
                    continue
            busy_until[t] = finish
            finishes[t].append(finish)
            live_jobs[t].append([req, start, finish])
            placed[req] = (t, by_aff)
            # the tick after the arrival lands: an arrival is load too
            eval_policy(a)
        advance(float("inf"))
        plan = [(req, *placed[req]) for req in sorted(placed)]
        return (plan, sorted(shed), scale_events, len(busy_until),
                res_routed[0])

    def fleet(prompts: Sequence[Any], n_new, *, slots: int = 4,
              eos_id: int | None = None, rng=None, arrivals=None,
              deadlines=None, kv_blocks: int | None = None) -> list:
        fleet.last_stats = None
        n = len(prompts)
        if n == 0:
            return []
        budgets = ([n_new] * n if isinstance(n_new, int)
                   else [int(x) for x in n_new])
        if len(budgets) != n:
            raise ValueError(
                f"per-request n_new has {len(budgets)} entries for "
                f"{n} prompts")
        if arrivals is not None:
            arrivals = [float(a) for a in arrivals]
            if len(arrivals) != n:
                raise ValueError(
                    f"arrivals has {len(arrivals)} entries for "
                    f"{n} prompts")
        if deadlines is not None:
            deadlines = [float(d) for d in deadlines]
            if len(deadlines) != n:
                raise ValueError(
                    f"deadlines has {len(deadlines)} entries for "
                    f"{n} prompts")
            if est_token_s is None:
                raise ValueError(
                    "SLO shedding needs est_token_s (predicted "
                    "service per budgeted token) — calibrate it from "
                    "a measured run of this config")
        # host copies: routing keys and prefill workers read tokens
        host_prompts = [_host_tokens(p) for p in prompts]
        # an elastic fleet resolves its faults per call (explicit targets
        # may name joiners the plan realises); a fixed one reuses its own
        resolved_call = (faults.resolve(n_dec, n_pre, elastic_dec=True)
                         if scale_on and faults is not None else resolved)
        # the store's residency, read once: placements replay exactly for
        # a given store state
        plan, shed, scale_events, n_total, res_routed_n = _plan(
            host_prompts, budgets, arrivals, deadlines,
            _route_events(resolved_call),
            cdn_res=cdn_store.residency() if cdn_on else None)
        if scale_on and resolved_call is not None:
            targeted = (set(resolved_call["kills_dec"])
                        | set(resolved_call["drains_dec"])
                        | set(resolved_call["slow_dec"]))
            bad = sorted(t for t in targeted if t >= n_total)
            if bad:
                raise ValueError(
                    f"fault schedule targets decode replica(s) {bad} "
                    f"but this call realises only {n_total} (base "
                    f"{n_dec} + {n_total - n_dec} scale-up joiner(s))")
            gone = (set(resolved_call["kills_dec"])
                    | set(resolved_call["drains_dec"]))
            if gone and len(gone) >= n_total:
                raise ValueError(
                    f"the fault schedule removes all {n_total} decode "
                    f"replica(s) this call realises — the fleet must "
                    f"keep >= 1 survivor to redrive onto")
        n_dec_run = n_total if scale_on else n_dec
        scale_ups = sorted((e for e in scale_events if e["kind"] == "up"),
                           key=lambda e: (e["ts"], e["target"]))
        scale_downs = [e for e in scale_events if e["kind"] == "down"]
        n_planned = len(plan)
        fault_on = resolved_call is not None
        # a process replica can die for real with no profile armed: the
        # recovery runtime always runs then
        managed = fault_on or scale_on or tr.process_isolated
        t0 = time.monotonic()
        retire_at: dict[int, float] = {}
        retire_tok: dict[int, int] = {}
        retired_by: dict[int, str] = {}
        r_lock = threading.Lock()

        def arr_of(req):
            return arrivals[req] if arrivals is not None else 0.0

        def make_on_retire(label):
            def on_retire(req, tokens):
                with r_lock:
                    retire_at[req] = time.monotonic() - t0
                    retire_tok[req] = tokens
                    retired_by[req] = label
            return on_retire

        def q_for(role, i, label):
            kill_at = stall = None
            if fault_on:
                if role == "dec":
                    kill_at = resolved_call["kills_dec"].get(i)
                    stall = resolved_call["slow_dec"].get(i)
                else:
                    kill_at = resolved_call["kills_pre"].get(i)
            return _FleetQueue(t0, steal_poll_s, make_on_retire(label),
                               label=label, kill_at=kill_at, stall=stall,
                               sink=warm_store)

        dec_queues = [q_for("dec", i, f"decode-{i}" if disaggregate
                            else f"replica-{i}")
                      for i in range(n_dec_run)]
        pre_queues = [q_for("pre", i, f"prefill-{i}")
                      for i in range(n_pre)]
        routed_to: dict[int, str] = {}
        by_aff_n = 0
        for req, t, by_aff in plan:
            label = (f"prefill-{t}" if disaggregate else f"replica-{t}")
            (pre_queues if disaggregate else dec_queues)[t].add(
                req, arr_of(req))
            routed_to[req] = label
            by_aff_n += by_aff
            if reg.enabled:
                tc = reg.clock()
                reg.emit_span("fleet_route", tc, tc, request=req,
                              replica=label, affinity=bool(by_aff),
                              shed=False)
        for req in shed:
            if reg.enabled:
                tc = reg.clock()
                reg.emit_span("fleet_route", tc, tc, request=req,
                              replica=None, affinity=False, shed=True)
        if reg.enabled and shed:
            _c_shed.inc(len(shed))
        if not fault_on:
            for q in pre_queues:
                q.close()                # routing is final for prefill
        # under a fault schedule the prefill side stays open: a decode death
        # redrives back through prefill; the router closes everything once
        # every planned request has retired

        sessions: list[Any] = [None] * n_pre
        pre_launches: list[dict] = [{} for _ in range(n_pre)]
        errors: list[tuple] = []
        stolen = [0]
        handoff_retries = [0]

        def _abort_all():
            for q in pre_queues + dec_queues:
                q.close()

        run_kw = dict(prompts=prompts, budgets=budgets, slots=slots,
                      eos_id=eos_id, rng=rng, kv_blocks=kv_blocks)

        # the warm of a bring-up (models/aotcache.py): with an aot_cache
        # among the engine levers, every bring-up warms against THIS call's
        # schedule before its first wave. Advisory: a failure is recorded
        # in the scale ledger and the replica launches cold, never dead.
        aot_on = engine_kw.get("aot_cache") is not None
        warm_kw = dict(
            slots=slots, kv_blocks=kv_blocks,
            prompt_lens=tuple(sorted({len(p) for p in host_prompts})),
            n_new=max(budgets) if budgets else 2)
        warm_compiles = [0]
        warm_compile_errors: list[str] = []

        def _warm_compile(i) -> bool:
            if not aot_on:
                return False
            try:
                info = tr.warm_replica(i, warm_kw)
            except Exception as exc:     # noqa: BLE001 — classified
                warm_compile_errors.append(f"{type(exc).__name__}: {exc}")
                return False
            if info.get("error"):
                warm_compile_errors.append(str(info["error"]))
                return False
            # a piece whose first use raised: the warm is not done, and
            # the ledger names the replica and the piece
            piece_errors = [f"replica-{i}: {e}" for e in info.get("errors", ())]
            warm_compile_errors.extend(piece_errors)
            if info.get("registered") and not piece_errors:
                warm_compiles[0] += 1
                return True
            return False

        def _on_dec_error(label, exc):
            errors.append((label, exc))
            _abort_all()

        def _transfer(i, req, corrupt_nth, served):
            """One prefill→decode handoff. Under the fault plane a
            scheduled corruption is caught by the payload's crc and the
            handoff retries from prefill (classified, never imported)."""
            served[0] += 1
            nth = served[0]
            state = {"attempt": 0}

            def attempt():
                state["attempt"] += 1
                payload = sessions[i].prefill(host_prompts[req])
                if corrupt_nth != nth:
                    # the injector is the only corruption source here: a
                    # handoff with none scheduled skips both crc passes
                    return payload
                crc = _payload_crc(payload)
                wire = payload
                if state["attempt"] == 1:
                    wire = _corrupt_payload(payload)
                if _payload_crc(wire) != crc:
                    handoff_retries[0] += 1
                    raise HandoffCorruptError(
                        f"prefill-{i} handoff for request {req} "
                        f"failed its crc — retrying from prefill")
                return wire

            if not fault_on:
                return attempt()
            return retry_call(attempt, policy=_HANDOFF_RETRY,
                              what=f"prefill-{i} handoff",
                              retryable=(HandoffCorruptError,))

        def pre_worker(i):
            corrupt_nth = (resolved_call["corrupt"].get(i) if fault_on
                           else None)
            served = [0]
            try:
                with _build.tally() as own, _on_stream(pre_streams[i]):
                    pre_launches[i] = own
                    sessions[i] = tr.prefill_engine(i).prefill_session()
                    while True:
                        req = _take_next(pre_queues[i])
                        if req is None:
                            break
                        payload = _transfer(i, req, corrupt_nth, served)
                        pre_queues[i].work_done = True
                        # the least-loaded live, undrained decode queue
                        # (ties: the lowest index)
                        j = min((d for d in range(n_dec)
                                 if not dec_queues[d].dead
                                 and not dec_queues[d].draining()),
                                key=lambda d: (dec_queues[d].pending_count(),
                                               d))
                        dec_queues[j].add(req, arr_of(req), payload)
                        if reg.enabled:
                            tc = reg.clock()
                            reg.emit_span("fleet_route", tc, tc,
                                          request=req,
                                          replica=f"decode-{j}",
                                          affinity=False, shed=False,
                                          handoff=True)
            except ReplicaKilled:
                pass
            except Exception as exc:     # noqa: BLE001 — re-raised below
                errors.append((f"prefill-{i}", exc))
                _abort_all()
            finally:
                if sessions[i] is not None:
                    sessions[i].close()

        pre_threads = [start_worker(pre_worker, f"fleet-pre-{i}", (i,),
                                    queue=pre_queues[i])
                       for i in range(n_pre)]
        dec_handles: list[Any] = [None] * n_dec_run
        base_seeded = [0]
        if cdn_on and tr.process_isolated:
            # the store cannot be mounted across the pipe: each base
            # replica's private host tier is seeded with its keyspace share
            # before launch (take copies; the store keeps its rows)
            ring_seed = HashRing(n_dec)
            for i in range(n_dec):
                chains = warm_store.take(
                    lambda root, i=i: ring_seed.target(root) == i)
                if chains:
                    dec_queues[i].set_warm(chains)
                    base_seeded[0] += len(chains)
        try:
            tr.bring_up(range(n_dec))
            for i in range(n_dec):
                _warm_compile(i)
                dec_handles[i] = tr.launch_decode(
                    i, dec_queues[i], run_kw, on_error=_on_dec_error)
        except BaseException:
            _abort_all()
            raise
        spawned: set[int] = set(range(n_dec))

        # ---- the fault plane's and the elastic plane's recovery runtime
        # (router-side state; it stays empty on the fixed, fault-free path)
        ring_run = (HashRing(n_pre if disaggregate else n_dec)
                    if managed else None)
        down_seen: set[tuple[str, int]] = set()
        redriven: list[int] = []
        killed_labels: list[str] = []
        drained_labels: list[str] = []
        scaled_down_labels: list[str] = []
        drain_state: dict[tuple[str, int], str] = {}
        drain_why: dict[tuple[str, int], str] = {}
        drain_specs = ((
            [("dec", t, ts, "fault")
             for t, ts in resolved_call["drains_dec"].items()]
            + [("pre", t, ts, "fault")
               for t, ts in resolved_call["drains_pre"].items()]
        ) if fault_on else []) + [("dec", e["target"], e["ts"], "scale")
                                  for e in scale_downs]
        breaker = LivenessBreaker(
            quarantine_polls,
            on_open=((lambda _key: _c_circuit.inc())
                     if reg.enabled else None)) if managed else None
        degraded = [False]
        degraded_clk = [None]
        closed_out = [False]
        up_idx = [0]
        live_size = [n_dec]
        spawn_retries = [0]
        spawn_failures = [0]
        warm_joins = [0]
        cold_joins = [0]
        warm_chains_primed = [0]

        def _set_size():
            if reg.enabled and scale_on:
                _g_size.set(live_size[0])

        def _spawn_dec(ev_):
            """One scale-UP at a monitor poll: build (or reuse) the joiner
            under ``utils/retry``, add it to the run ring, prime its warm
            chains from the fleet store and launch it. A spawn that fails
            every attempt classifies the target dead (its planned requests
            redrive); a joiner enters the health monitor like any replica
            (its build and captures excused until its first wave)."""
            i, trigger = ev_["target"], ev_["trigger"]
            q = dec_queues[i]
            attempts = [0]

            def build():
                attempts[0] += 1
                tr.ensure_engine(i)

            clk0 = reg.clock() if reg.enabled else None
            try:
                retry_call(build, policy=_SPAWN_RETRY,
                           what=f"{q.label} spawn", retryable=(Exception,))
            except Exception:            # noqa: BLE001 — classified
                spawn_retries[0] += max(attempts[0] - 1, 0)
                spawn_failures[0] += 1
                q.dead = True            # _process_downs redrives
                return
            spawn_retries[0] += attempts[0] - 1
            if ring_run is not None and i not in ring_run.targets():
                ring_run.add(i)
            chains = (warm_store.take(lambda root: ring_run.target(root) == i)
                      if warm_store is not None
                      and (not cdn_on or tr.process_isolated) else [])
            if chains:
                q.set_warm(chains)
                warm_joins[0] += 1
                warm_chains_primed[0] += len(chains)
            else:
                cold_joins[0] += 1
            warm_compiled = _warm_compile(i)
            dec_handles[i] = tr.launch_decode(i, q, run_kw,
                                              on_error=_on_dec_error)
            spawned.add(i)
            live_size[0] += 1
            if reg.enabled:
                _c_scale_up.inc()
                tc = reg.clock()
                reg.emit_span("fleet_scale",
                              clk0 if clk0 is not None else tc, tc,
                              kind="up", replica=q.label, trigger=trigger,
                              warm=bool(chains),
                              warm_compile=warm_compiled,
                              transport=tr.name)
            _set_size()

        def _mark_degraded():
            degraded[0] = True
            if reg.enabled and degraded_clk[0] is None:
                degraded_clk[0] = reg.clock()

        def _health_ok(role, i):
            return breaker is None or breaker.healthy((role, i))

        def _avail(role, i):
            q = (dec_queues if role == "dec" else pre_queues)[i]
            return not q.dead and drain_state.get((role, i)) \
                not in ("draining", "done")

        def _pick(role, req):
            """A redrive target: the ring's pick when healthy, else the
            least-loaded healthy survivor (any live one when all are
            quarantined; a joiner still spawning when every spawned one is
            down)."""
            queues = dec_queues if role == "dec" else pre_queues
            cands = [j for j in range(len(queues)) if _avail(role, j)
                     and (role != "dec" or j in spawned)]
            if not cands and role == "dec":
                cands = [j for j in range(len(queues)) if _avail(role, j)]
            if not cands:
                raise RuntimeError(
                    f"no live {role} replica to redrive onto — every "
                    f"candidate is dead or draining (the fault schedule "
                    f"plus failed spawns removed the last survivor; keep "
                    f">= 1 spawnable replica)")
            healthy = [j for j in cands if _health_ok(role, j)] or cands
            if routing == "affinity" \
                    and role == ("pre" if disaggregate else "dec"):
                t = ring_run.target(affinity_key(host_prompts[req],
                                                 kv_block))
                if t in healthy:
                    return t
            return min(healthy,
                       key=lambda j: (queues[j].pending_count(), j))

        def _redrive(role, lost, why):
            for req, a, payload in lost:
                if disaggregate:
                    if role == "dec" and payload is not None:
                        # the payload survived (never imported): re-place it
                        # on a live decode queue, no recompute
                        j = _pick("dec", req)
                        dec_queues[j].add(req, a, payload)
                        lbl = f"decode-{j}"
                    else:
                        # back through a surviving prefill worker
                        j = _pick("pre", req)
                        pre_queues[j].add(req, a)
                        lbl = f"prefill-{j}"
                else:
                    j = _pick("dec", req)
                    dec_queues[j].add(req, a)
                    lbl = f"replica-{j}"
                routed_to[req] = f"{why}->{lbl}"
                redriven.append(req)
                if reg.enabled:
                    _c_redrive.inc()
                    tc = reg.clock()
                    reg.emit_span("fleet_route", tc, tc, request=req,
                                  replica=lbl, affinity=False,
                                  shed=False, redrive=True)

        def _ring_remove(role, i):
            if role == ("pre" if disaggregate else "dec") \
                    and i in ring_run.targets() \
                    and len(ring_run.targets()) > 1:
                ring_run.remove(i)

        def _process_downs():
            for role, queues, nn in (("dec", dec_queues, n_dec_run),
                                     ("pre", pre_queues, n_pre)):
                for i in range(nn):
                    q = queues[i]
                    if not q.dead:
                        continue
                    if (role, i) in down_seen:
                        # a handoff that picked this queue just before the
                        # kill lands after take_lost: sweep it on
                        if q.pending_count():
                            late, _ = q.take_lost()
                            _redrive(role, late, "redrive")
                        continue
                    down_seen.add((role, i))
                    killed_labels.append(q.label)
                    if role == "dec" and i in spawned:
                        # fleet_size is the LIVE count (a failed spawn
                        # never entered it)
                        live_size[0] -= 1
                        _set_size()
                    pend, popped = q.take_lost()
                    if role == "pre":
                        # a popped prefill request was handed off already
                        popped = []
                    # retirements that died with the replica: their outputs
                    # lived in the dead run and never came back
                    with r_lock:
                        for req in [r for r, lab in retired_by.items()
                                    if lab == q.label]:
                            retired_by.pop(req)
                            retire_at.pop(req, None)
                            retire_tok.pop(req, None)
                    _ring_remove(role, i)
                    _mark_degraded()
                    if reg.enabled:
                        _c_down.inc()
                    lost = pend + [(r, arr_of(r), None) for r in popped]
                    _redrive(role, lost, "redrive")

        def _process_drains(rel_now):
            if closed_out[0]:
                return
            for role, i, at, why in drain_specs:
                key = (role, i)
                q = (dec_queues if role == "dec" else pre_queues)[i]
                st = drain_state.get(key, "armed")
                if q.dead:
                    continue
                if role == "dec" and i not in spawned:
                    # a joiner not up yet (the spawns run first each poll)
                    continue
                if st == "done":
                    # a handoff that picked this queue just before the
                    # drain lands after the close: sweep it on
                    leak = q.drain_pending()
                    if leak:
                        _redrive(role, leak, "drained")
                    continue
                if st == "armed":
                    if rel_now < at:
                        continue
                    q.set_draining()
                    drain_state[key] = "draining"
                    # a fault drain and a scale-down may name one replica:
                    # the spec that armed it owns the accounting
                    drain_why[key] = why
                    _ring_remove(role, i)
                    if why == "fault":
                        _mark_degraded()   # a scale-down is planned
                moved = q.drain_pending()
                if moved:
                    _redrive(role, moved, "drained")
                if q.pending_count() == 0:
                    q.close()
                    drain_state[key] = "done"
                    if role == "dec" and i in spawned:
                        live_size[0] -= 1
                        _set_size()
                    if drain_why[key] == "scale":
                        scaled_down_labels.append(q.label)
                        if reg.enabled:
                            _c_scale_down.inc()
                            tc = reg.clock()
                            reg.emit_span("fleet_scale", tc, tc,
                                          kind="down", replica=q.label,
                                          trigger="low_load",
                                          transport=tr.name)
                    else:
                        drained_labels.append(q.label)

        def _check_health():
            """One ``LivenessBreaker`` observation a live replica that has
            done its first unit of work: a poll stamp staler than
            ``health_timeout_s`` opens the circuit (no steals or redrives
            to it until ``quarantine_polls`` clean polls). Death is
            classified apart (the worker exits with ReplicaKilled, or the
            process is gone)."""
            now = time.monotonic()
            for role, queues, workers, nn in (
                    ("dec", dec_queues, dec_handles, n_dec_run),
                    ("pre", pre_queues, pre_threads, n_pre)):
                for i in range(nn):
                    q = queues[i]
                    if workers[i] is None or q.dead \
                            or not workers[i].is_alive() \
                            or not q.work_done:
                        continue
                    breaker.observe(
                        (role, i), now - q.last_poll > health_timeout_s)

        def _all_retired():
            with r_lock:
                return len(retire_at) >= n_planned

        def _pending_downs():
            return managed and any(
                qq.dead and (role, j) not in down_seen
                for role, qs in (("dec", dec_queues), ("pre", pre_queues))
                for j, qq in enumerate(qs))

        # ---- the router's monitor loop: scale-ups, the depth gauge,
        # stealing, fault recovery, and the close once no add can come. An
        # exception here closes every queue and is raised after the workers
        # are joined.
        _set_size()
        hung_workers: list[str] = []
        try:
            while True:
                # scale-ups first each poll: a joiner is up before its own
                # drain or kill can arm
                rel_now = time.monotonic() - t0
                while up_idx[0] < len(scale_ups) \
                        and scale_ups[up_idx[0]]["ts"] <= rel_now:
                    _spawn_dec(scale_ups[up_idx[0]])
                    up_idx[0] += 1
                if managed:
                    _process_downs()
                    _process_drains(time.monotonic() - t0)
                    _check_health()
                depths = [q.pending_count() for q in dec_queues]
                if reg.enabled:
                    _g_depth.set(sum(depths)
                                 + sum(q.pending_count()
                                       for q in pre_queues))
                if not managed:
                    adds_done = not any(th.is_alive()
                                        for th in pre_threads)
                    if adds_done and sum(depths) == 0:
                        for q in dec_queues:
                            q.close()
                        break
                elif not closed_out[0] and _all_retired() \
                        and not _pending_downs():
                    # the run's end: disarm first (a kill past the last
                    # retirement is a no-op; so are scale events), then
                    # close — unless a kill fired during the disarm sweep,
                    # which the next pass redrives onto open survivors
                    for q in pre_queues + dec_queues:
                        q.disarm()
                    up_idx[0] = len(scale_ups)
                    if not _pending_downs():
                        for q in pre_queues + dec_queues:
                            q.close()
                        closed_out[0] = True
                if steal and n_dec_run > 1:
                    receivers = [i for i, d in enumerate(depths)
                                 if d == 0 and i in spawned
                                 and _avail("dec", i)
                                 and _health_ok("dec", i)
                                 and dec_handles[i] is not None
                                 and dec_handles[i].is_alive()]
                    donors = [i for i in range(n_dec_run)
                              if _avail("dec", i)]
                    if receivers and donors:
                        donor = max(donors, key=lambda i: depths[i])
                        if depths[donor] >= 2 and donor not in receivers:
                            got = dec_queues[donor].steal_tail()
                            if got is not None:
                                req, a, payload = got
                                dec_queues[receivers[0]].add(req, a,
                                                             payload)
                                routed_to[req] = f"stolen->{receivers[0]}"
                                stolen[0] += 1
                                if reg.enabled:
                                    _c_steal.inc()
                if not any(h is not None and h.is_alive()
                           for h in dec_handles) \
                        and not _pending_downs() \
                        and up_idx[0] >= len(scale_ups):
                    break
                time.sleep(steal_poll_s)
        except BaseException:
            _abort_all()
            raise
        finally:
            # BOUNDED joins: a wedged worker never hangs the caller
            deadline = time.monotonic() + join_timeout_s
            for i, th in enumerate(pre_threads):
                th.join(max(0.0, deadline - time.monotonic()))
                if th.is_alive():
                    hung_workers.append(f"prefill-{i}")
            for h in dec_handles:
                if h is None:
                    continue
                if not h.join(max(0.0, deadline - time.monotonic())):
                    hung_workers.append(h.label)
                    h.kill()
        if hung_workers:
            raise FleetWorkerHung(hung_workers, join_timeout_s)
        if managed:
            _process_downs()             # a death racing the exit
        if errors:
            where, exc = errors[0]
            raise RuntimeError(
                f"fleet worker {where} failed: {exc}") from exc

        merged: dict[int, Any] = {}
        dup: set[int] = set()
        for h in dec_handles:
            r = h.result() if h is not None else None
            for k, v in (r or {}).items():
                if k in merged:
                    dup.add(k)
                else:
                    merged[k] = v
        if dup:
            # the redrive's dedupe failed: a router bug, never merged over
            raise RuntimeError(
                f"fleet served requests {sorted(dup)} more than once")
        missing = set(range(n)) - set(shed) - set(merged)
        if missing:
            raise RuntimeError(
                f"fleet lost requests {sorted(missing)} — served "
                f"{len(merged)}, shed {len(shed)} of {n}")
        if fault_on and degraded[0] and reg.enabled \
                and degraded_clk[0] is not None:
            reg.emit_span("fleet_degraded", degraded_clk[0], reg.clock(),
                          nominal=replicas,
                          replicas_down=len(killed_labels),
                          drained=len(drained_labels))

        # ---- stats -----------------------------------------------
        per_replica = []
        hit_b = prompt_b = saved = 0
        spill_agg = {"spilled_blocks": 0, "host_hit_blocks": 0,
                     "swapins": 0, "swapped_blocks": 0, "swap_ms": 0.0,
                     "swap_tokens_saved": 0, "spill_dropped": 0,
                     "corrupt_dropped": 0}
        spill_on = bool(engine_kw.get("host_spill"))
        launches: dict[str, dict] = {}
        for i in range(n_dec_run):
            h = dec_handles[i]
            label = (f"decode-{i}" if disaggregate else f"replica-{i}")
            if i not in spawned or h is None:
                # a joiner whose spawn never ran (the run ended first, or
                # every attempt failed): no engine, no stats
                launches[label] = {}
                per_replica.append({
                    "role": "decode", "replica": label,
                    "requests": 0, "waves": None, "occupancy": None,
                    "kv_peak_blocks": None, "preempted": 0,
                    "dead": dec_queues[i].dead, "spawned": False,
                    "flash_prefills": None, "kv_imports": None,
                    "import_ms": None,
                })
                continue
            launches[label] = h.launches()
            st = h.stats()
            if st is None:
                # killed mid-run: the engine assembled no stats
                per_replica.append({
                    "role": "decode", "replica": label,
                    "requests": 0, "waves": None, "occupancy": None,
                    "kv_peak_blocks": None, "preempted": 0,
                    "dead": True, "flash_prefills": None,
                    "kv_imports": None, "import_ms": None,
                })
                continue
            rec = {
                "role": "decode", "replica": label,
                "requests": st["requests"], "waves": st["waves"],
                "occupancy": st["sched"]["mean_live_requests"],
                "kv_peak_blocks": st["kv"]["high_water"],
                "preempted": st["sched"]["preempted"],
                "dead": dec_queues[i].dead,
                "flash_prefills": st["flash_prefills"],
                "kv_imports": st["kv_imports"],
                "import_ms": st["import_ms"],
            }
            sp = st["prefix"].get("spill")
            if spill_on and sp is not None:
                rec["spill"] = {k: sp[k] for k in spill_agg}
                for k in spill_agg:
                    spill_agg[k] += sp[k]
            per_replica.append(rec)
            hit_b += st["prefix"]["hit_blocks"]
            prompt_b += st["prefix"]["prompt_blocks"]
            saved += st["prefix"]["tokens_saved"]
        for i, s in enumerate(sessions):
            launches[f"prefill-{i}"] = dict(pre_launches[i])
            if s is None:
                continue
            per_replica.append({
                "role": "prefill", "replica": f"prefill-{i}",
                "requests": s.stats["requests"], "waves": None,
                "occupancy": None, "kv_peak_blocks": s.alloc.high_water,
                "preempted": 0, "dead": pre_queues[i].dead,
                "flash_prefills": s.stats["flash_prefills"],
                "export_ms": s.export_ms(),
            })
            hit_b += s.stats["hit_blocks"]
            prompt_b += s.stats["prompt_blocks"]
            saved += s.stats["tokens_saved"]
        hit_frac = round(hit_b / max(prompt_b, 1), 4)

        met = with_dl = 0
        goodput_tokens = 0
        lat_ms: list[float] = []         # arrival → completion, per req
        for req in merged:
            tok = retire_tok.get(req, int(merged[req].shape[0]))
            a = arr_of(req)
            done = retire_at.get(req)
            if done is not None:
                lat_ms.append(max(0.0, done - a) * 1e3)
            if deadlines is None:
                goodput_tokens += tok
                continue
            with_dl += 1
            ok = (done if done is not None else float("inf")) - a \
                <= deadlines[req]
            met += ok
            if ok:
                goodput_tokens += tok
        lat_ms.sort()

        def _q(p):
            return (round(lat_ms[min(len(lat_ms) - 1,
                                     int(p * len(lat_ms)))], 3)
                    if lat_ms else None)
        if reg.enabled:
            _g_hitf.set(hit_frac)
            _g_depth.set(0)

        fleet.last_stats = {
            "fleet": {
                "replicas": replicas,
                "mode": ("disaggregated" if disaggregate
                         else "colocated"),
                "prefill_workers": n_pre,
                "routing": routing,
                "requests": n,
                "served": len(merged),
                "shed": len(shed),
                "shed_requests": sorted(shed),
                "stolen": stolen[0],
                "affinity_routed_frac": round(
                    by_aff_n / max(len(plan), 1), 4),
                "affinity_hit_blocks": hit_b,
                "affinity_hit_frac": hit_frac,
                "prefill_tokens_saved": saved,
                "deadline_attainment": (round(met / with_dl, 4)
                                        if with_dl else None),
                "goodput_tokens": goodput_tokens,
                "latency_ms": {"p50": _q(0.5), "p99": _q(0.99),
                               "max": (round(lat_ms[-1], 3)
                                       if lat_ms else None)},
                "per_replica": per_replica,
                "routed_to": routed_to,
                "spill": ({**spill_agg,
                           "swap_ms": round(spill_agg["swap_ms"], 3)}
                          if spill_on else None),
                # the prefix CDN (None without disk_spill): the store's
                # ledger, the residency reroutes, and the host bytes of one
                # shared store against n private pools of its size
                "cdn": (None if not cdn_on else {
                    "residency_routed": res_routed_n,
                    "base_seeded_chains": base_seeded[0],
                    "host_bytes_shared": cdn_store.pool.nbytes,
                    "host_bytes_private_equiv":
                        n_dec_run * cdn_store.pool.nbytes,
                    "store": cdn_store.stats(),
                }),
                "faults": (None if not fault_on else {
                    "profile_seed": faults.seed,
                    "replica_down": len(killed_labels),
                    "killed": sorted(killed_labels),
                    "redriven": len(redriven),
                    "redriven_requests": sorted(set(redriven)),
                    "drained": sorted(drained_labels),
                    "circuit_open": breaker.opens,
                    "handoff_retries": handoff_retries[0],
                    "degraded": degraded[0],
                }),
                # the elastic plane's ledger (None on a fixed fleet)
                "scale": (None if not scale_on else {
                    "policy_seed": str(autoscale.seed),
                    "initial": n_dec,
                    "final_live": live_size[0],
                    "min": autoscale.min_replicas,
                    "max": autoscale.max_replicas,
                    "events": scale_events,
                    "ups_planned": len(scale_ups),
                    "ups_executed": len(spawned) - n_dec,
                    # executed drains only: a planned down whose target was
                    # killed first never ran
                    "downs": len(scaled_down_labels),
                    "downs_planned": len(scale_downs),
                    "warm_joins": warm_joins[0],
                    "cold_joins": cold_joins[0],
                    "warm_chains_primed": warm_chains_primed[0],
                    "warm_compiles": warm_compiles[0],
                    "warm_compile_errors": list(warm_compile_errors),
                    "spawn_retries": spawn_retries[0],
                    "spawn_failures": spawn_failures[0],
                    "scaled_down": sorted(scaled_down_labels),
                    "warm_store": (warm_store.stats()
                                   if warm_store is not None else None),
                }),
                "launches": launches,
            },
            "replica_stats": [
                dec_handles[i].stats()
                if i in spawned and dec_handles[i] is not None
                else None for i in range(n_dec_run)],
        }
        out: list[Any] = [None] * n
        for req, toks in merged.items():
            out[req] = toks
        return out

    fleet.last_stats = None
    # the transport is public: a shared instance keeps replicas warm across
    # make_fleet calls, close() reaps them
    fleet.transport = tr
    fleet.close = tr.close
    # the CDN's store (None without disk_spill)
    fleet.cdn_store = cdn_store
    return fleet
