# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Continuous-batching serve engine on the paged KV cache — the port of the
reference's ``models/serving.py``: greedy, sampled and speculative serving.

Requests join in-flight decode at wave boundaries the moment a slot AND
enough KV blocks are free (an optional per-request arrival time gates
admission); each admission prefills its prompt through its own blocks and
picks its first token; then every wave advances ALL busy slots with one
batched ``[slots, 1]`` paged forward (:func:`make_serve_step`), reading the
cache through the block tables with the paged decode kernel on the card. A
request retires at its own ``n_new`` or at ``eos_id``, its blocks return to
the free list and its slot re-admits at the next wave. Dead slots keep
computing (the static batch) but their writes are fenced to the garbage
block.

On a CUDA device each wave is ONE replay of a CUDA graph
(:class:`WaveGraph`), the counterpart of the reference's jitted step with
the pool donated: the engine keeps one pool per ``(slots, kv_blocks)``
across runs, captures the wave over it once, and resets the pool in place
(zeros, as a fresh pool) at the start of each run. The graph reads the
pool's own tensors, so the host's in-place writes between waves — table
rows, positions, the slots' tokens and active mask in the graph's static
buffers — reach the next replay. A capture or replay that fails raises:
the card never falls back to eager waves. Admissions and prefill chunks
stay eager (they are not the per-wave cost). On the CPU the eager wave is
the path.

Sampled serving (``sampler=``, ``run(rng=)``): every token's key is the
reference's ``fold_in(fold_in(rng, request), position)`` (threefry-2x32,
``ops/sampling``), so a request's tokens never depend on the schedule and
equal the JAX engine's at f32. The sampled wave keeps each slot's
``(request, position)`` in a static ``[slots, 2]`` buffer beside the
tokens and advances the positions of active slots itself; the host writes
a slot's row only at admission, stall, resumption and retirement. The draw
is D1 (``csrc/sample.cu``) inside the graph.

Speculative serving (``spec_k``, greedy only): each slot drafts ``k``
tokens by bigram lookup in its own context and one ``[slots, k+1]``
forward verifies them (:func:`make_spec_step`). The reference loops on
the device until enough slots finish; here one trip of that loop — the
loop's test, then its body, gated on the test — is one replay of a
captured graph over static context, position and count buffers, and the
host replays it until the test fails, reading back one ``[6, slots]``
report a trip.

Host/device split: the host owns WHICH request sits in a slot and WHICH
blocks it holds (plain integers); the device owns the math. Without
``eos_id`` the wave loop never waits on the device: tokens stay on the card
and outputs are assembled after the schedule. With ``eos_id`` the loop
reads back one ``[slots]`` vector a wave, or one ``[W, slots]`` block every
``eos_check_every=W`` waves (retirement then lags an eos by up to W - 1
waves; the outputs are truncated at the first eos either way).

The scheduler levers (each off by default, reproducing the baseline engine
exactly):

- ``policy="sjf"|"priority"`` with ``aging`` and ``run(priorities=)``:
  admission order over the arrived requests (:class:`_Sched`);
- ``prefill_chunk``: a prompt admits one ``[1, C]`` chunk per wave,
  interleaved with the decode waves;
- ``prefix``: a template prefix prefilled once per run into its own
  blocks, mapped into every table (only its partial tail block is copied);
- ``share_prefix`` with ``prefix_keep_blocks``: cross-request sharing of
  full leading prompt blocks through a refcounted
  :class:`..paging.PrefixIndex`;
- ``lazy_growth``: admission grants the prompt's blocks plus one decode
  block; a slot's table grows as it crosses block boundaries, stalls when
  the pool is dry, and the youngest request is preempted (its tokens
  regenerate identically) when every live request stalls.

Int8 serving: ``cache_dtype="int8"`` keeps the pool int8 with f32 scale
sidecars riding the block tables (the wave then reads through the int8
paged kernel), and int8-weight params (``quantize_params`` trees with
``QTensor`` leaves) serve through the PREFILL/DECODE PHASE SPLIT: the
engine dequantises them once at build into a compute-dtype tree that every
admission runs from, while the wave runs from the int8 tree (the int8
matmul kernel).

Exactness contract (the reference's, ``models/serving.py:87-94``): each
request's tokens EQUAL ``greedy_decode`` run alone on that request —
batching, paging, slot recycling, arrival schedules, admission order,
chunking, sharing, growth stalls and preemption are scheduling, never a
different model. Chunked and shared-suffix prefills run the exact cached
(dense) math, so on a flash config they equal a solo decode with
``prefill="dense"``. Under an int8 cache the engine quantises the same rows
at the same positions as a solo int8-cache decode.

Keyword arguments of the reference engine that are not ported yet are
accepted at the reference's default value; any other value raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..ops.sampling import MASK32, key_data, threefry2x32
from ..telemetry import get_registry
from .burnin import BurnInConfig, check_device, tree_leaves
from .decode import (
    Sampler,
    _check_params,
    _Replayed,
    _select_prefill_impl,
    check_cache_dtype,
    forward_paged,
    make_sampler,
)
from .paging import (
    BlockAllocator,
    PrefixIndex,
    blocks_for_rows,
    chain_chunks,
    chunk_tokens_covered,
    init_paged_cache,
    paged_pool_spec,
)
from .quantize import QTensor, dequantize_params
from .speculative import _ngram_draft, accept_drafts

_POLICIES = ("fifo", "sjf", "priority")
_DEFAULT_AGING = 512                   # waves; bounds starvation by default

# keyword arguments of the reference engine that this port does not serve
# yet: name → (the reference's default, its ROADMAP item). The default is
# the engine as it is and passes; any other value raises
# NotImplementedError naming the item. make_serve_engine's and run's are
# apart, as in the reference's signatures; any other keyword is a
# TypeError.
_FLEET = "Queue A item 9 (fleet stack)"
_ENGINE_LATER = {
    "host_spill": (False, f"{_FLEET}: host KV tier"),
    "host_blocks": (None, f"{_FLEET}: host KV tier"),
    "host_swap": ("async", f"{_FLEET}: host KV tier"),
    "shared_store": (None, f"{_FLEET}: prefix CDN"),
    "aot_cache": (None, f"{_FLEET}: warm compile cache"),
}
_RUN_LATER = {
    "rules": (None, "Queue A item 6 (rules= on the decode and serve "
                    "entry points)"),
    "admission": (None, f"{_FLEET}: the AdmissionSource seam"),
}


def _refuse_levers(levers: dict, later: dict, where: str) -> None:
    for name, value in levers.items():
        if name not in later:
            raise TypeError(f"{where}() got an unexpected keyword argument "
                            f"{name!r}")
        default, item = later[name]
        if default is None or isinstance(default, bool):
            same = value is default
        else:
            same = type(value) is type(default) and value == default
        if not same:
            raise NotImplementedError(
                f"{where}({name}=...) is not ported yet — ROADMAP.md, "
                f"{item}")


def _request_key(rng, req: int, pos: int) -> torch.Tensor:
    """THE sampled-token key contract, as the reference's: ``fold_in(
    fold_in(rng, request), position)`` — ``[2]`` int64 key data, computed
    on the host's integers. The admissions draw with it; the wave folds
    the same contract inside D1 (``ops/sampling.draw``'s ``fold``), so
    the keys follow the request stream, never the schedule."""
    k0, k1 = key_data(rng).tolist()
    for data in (req, pos):
        k0, k1 = threefry2x32(k0, k1, 0, int(data) & MASK32)
    return torch.tensor([k0, k1], dtype=torch.int64)


def _make_pick(sampler: Sampler | None):
    """The admissions' token pick: ``pick(logits_row [V], key) → token`` —
    the argmax when greedy (``key`` unused), the sampler over that one row
    otherwise."""
    if sampler is None:
        def pick(logits_row, key):
            return logits_row.argmax(dim=-1)
    else:
        def pick(logits_row, key):
            return sampler(logits_row[None], key)[0]
    return pick


def make_serve_step(params, cfg: BurnInConfig, sampler: Sampler | None = None,
                    *, paged_kernel: str = "auto"):
    """The all-slots wave step, one batched ``[slots, 1]`` ``forward_paged``
    that updates the pool in place. ``paged_kernel`` picks the read path
    (``"auto"``: the paged decode kernel on the card; ``"off"``: the gather
    reference).

    Greedy (``sampler=None``): ``(tokens [slots], active [slots] bool,
    pool) → next tokens [slots]``. Sampled: ``(tokens, active, fold
    [slots, 2], key [2], pool) → next tokens``, slot ``s`` drawn with
    ``fold_in(fold_in(key, fold[s, 0]), fold[s, 1])`` — its request and
    position — after which the step advances the active slots' positions
    in place (``fold[:, 1] += active``)."""

    def last_logits(tokens, active, pool):
        logits, _ = forward_paged(params, tokens[:, None], pool, cfg,
                                  prefill_impl="cached", active=active,
                                  paged_kernel=paged_kernel)
        return logits[:, -1]

    if sampler is None:
        def wave(tokens, active, pool):
            return last_logits(tokens, active, pool).argmax(dim=-1)
        return wave

    def sampled_wave(tokens, active, fold, key, pool):
        toks = sampler.rows(last_logits(tokens, active, pool), key, fold)
        fold[:, 1].add_(active.long())
        return toks

    return sampled_wave


class SpecState:
    """The speculative iteration's static buffers over ``slots`` slots and
    a context row of ``width`` tokens: ``ctx`` (prefix + prompt +
    generated), ``cur`` (valid length), ``n_out`` (tokens generated),
    ``fin`` and ``steps`` (per multi-step), the host's inputs ``n_new``,
    ``eos`` (``-1``: none), ``active``, ``stop`` and ``granted`` (rows each
    slot's table covers), and ``report``, which each trip fills with
    ``fin``, ``n_out``, ``steps``, ``need_grow``, the pool's positions and
    whether another trip would run."""

    def __init__(self, slots: int, width: int, dev):
        def z(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.ctx = z(slots, width)
        self.cur, self.n_out, self.steps = z(slots), z(slots), z(slots)
        self.n_new, self.granted = z(slots), z(slots)
        self.fin = z(slots, dtype=torch.bool)
        self.active = z(slots, dtype=torch.bool)
        self.eos, self.stop = z(), z()
        self.report = z(6, slots)


def make_spec_step(params, cfg: BurnInConfig, k: int, *,
                   paged_kernel: str = "auto"):
    """The all-slots SPECULATIVE trip on the paged pool: ``trip(state:
    SpecState, pool)``, in place. One trip is one test and one body of the
    reference's device loop (``make_spec_step``'s ``while_loop``): the loop
    runs while fewer than ``stop`` active slots have finished and some
    unfinished active slot is not growth-blocked, and the body runs gated
    on that test — a trip after the test fails changes nothing — so the
    host can replay trips until ``report[5]`` reads false.

    The body: each slot drafts ``k`` tokens (:func:`_ngram_draft` in its
    own context row), ONE ``[slots, k+1]`` ``forward_paged`` verifies them
    (T = k + 1: the gather read path, as in the reference), and
    :func:`accept_drafts` keeps the longest agreeing prefix plus the
    model's token, capped at the slot's budget and cut after the first eos.
    Frozen slots — finished, inactive, or growth-blocked (their grant does
    not cover ``pos + k + 1`` rows) — write to the garbage block and keep
    their state. The rollback ``pos = cur - 1`` is written into the pool's
    own ``pos`` in place."""

    def blocked_of(s, pos):
        # the next verification writes pos..pos+k: a slot whose grant does
        # not cover them waits for the host
        return (pos.long() + (k + 1) > s.granted) & s.active & ~s.fin

    def cond(s, pos):
        runnable = s.active & ~s.fin & ~blocked_of(s, pos)
        return ((s.fin & s.active).sum() < s.stop) & runnable.any()

    def trip(s: SpecState, pool) -> None:
        pos = pool["pos"]
        go = cond(s, pos)
        blocked = blocked_of(s, pos)
        frozen = s.fin | ~s.active | blocked | ~go
        last = torch.gather(s.ctx, 1, (s.cur - 1).clamp_min(0)[:, None])
        draft = _ngram_draft(s.ctx, s.cur, k, cfg.vocab)        # [S, k]
        logits, _ = forward_paged(params, torch.cat([last, draft], 1), pool,
                                  cfg, prefill_impl="cached", active=~frozen,
                                  paged_kernel=paged_kernel)
        new_toks, n_acc = accept_drafts(draft, logits.argmax(dim=-1))
        idx = torch.arange(k + 1, device=pos.device)
        emit = torch.minimum(n_acc + 1, (s.n_new - s.n_out).clamp_min(0))
        is_eos = (new_toks == s.eos) & (s.eos >= 0) & (idx < emit[:, None])
        hit = is_eos.any(dim=1)
        emit = torch.where(hit, is_eos.int().argmax(dim=1) + 1, emit)
        # the window at cur, clamped into the row as the reference's
        # dynamic slice is
        at = s.cur.clamp(0, s.ctx.shape[1] - (k + 1))[:, None] + idx
        keep = (idx < emit[:, None]) & ~frozen[:, None]
        s.ctx.scatter_(1, at, torch.where(keep, new_toks,
                                          torch.gather(s.ctx, 1, at)))
        n_done = s.n_out + emit
        done = (n_done >= s.n_new) | hit
        cur = torch.where(frozen, s.cur, s.cur + emit)
        s.cur.copy_(cur)
        s.n_out.copy_(torch.where(frozen, s.n_out, n_done))
        # the rollback, in place: the new last token is not forwarded yet
        pos.copy_(torch.where(frozen, pos.long(), cur - 1))
        # a slot's finishing trip counts; frozen trips do not
        live = s.active & ~s.fin & ~blocked & go
        s.steps.add_(live.long())
        s.fin.logical_or_(done & live)
        s.report.copy_(torch.stack([
            s.fin.long(), s.n_out, s.steps, blocked_of(s, pos).long(),
            pos.long(), cond(s, pos).long().expand_as(s.cur)]))

    return trip


class WaveGraph(_Replayed):
    """The wave ``step`` over one pool, captured once as a CUDA graph and
    replayed each wave (``capture=False``: run eagerly, the CPU path).

    The graph reads the slots' tokens from :attr:`tokens` and the active
    mask from :attr:`active` — and, sampled, their ``(request, position)``
    rows from :attr:`fold` and the run's key from :attr:`key` — static
    buffers the host writes in place between waves, and the pool's own
    tensors; it writes the next tokens back into :attr:`tokens` (and
    advances :attr:`fold`'s positions). A caller that keeps a wave's tokens
    must copy them, since the next replay overwrites them."""

    def __init__(self, step, pool: dict, *, sampled: bool = False,
                 capture: bool = True):
        dev = pool["pos"].device
        slots = pool["pos"].shape[0]
        self.tokens = torch.zeros((slots,), dtype=torch.long, device=dev)
        self.active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self.fold = self.key = None
        args = (self.tokens, self.active)
        if sampled:
            self.fold = torch.zeros((slots, 2), dtype=torch.long, device=dev)
            self.key = torch.zeros((2,), dtype=torch.long, device=dev)
            args += (self.fold, self.key)

        def wave():
            self.tokens.copy_(step(*args, pool))

        super().__init__(wave, dev, capture)


class SpecGraph(_Replayed):
    """The speculative trip (:func:`make_spec_step`) over one pool and one
    :class:`SpecState` (:attr:`state`), captured once as a CUDA graph
    (``capture=False``: run eagerly, the CPU path)."""

    def __init__(self, trip, pool: dict, width: int, *,
                 capture: bool = True):
        dev = pool["pos"].device
        self.state = SpecState(pool["pos"].shape[0], width, dev)
        self.trips = 0
        super().__init__(lambda: trip(self.state, pool), dev, capture)

    def multi_step(self):
        """The reference's device multi-step: trips until the loop's test
        fails, one ``[6, slots]`` readback a trip. Returns the last
        report on the host (``fin``, ``n_out``, ``steps``, ``need_grow``,
        ``pos``, ``cont``)."""
        self.state.fin.zero_()
        self.state.steps.zero_()
        while True:
            self.replay()
            self.trips += 1
            report = self.state.report.to("cpu", copy=True)
            if not int(report[5, 0]):
                return report


class AdmissionSource:
    """The engine's admission/queue head as an interface (the reference's
    ``AdmissionSource``): the engine polls :meth:`candidate` at every wave
    boundary, :meth:`pop`\\ s what it admits, :meth:`requeue`\\ s what a
    lazy-growth preemption returns, and keeps its wave loop alive until
    :meth:`exhausted` says no candidate will ever come again.

    - ``candidate()`` → the request index to try next, or ``None`` (empty,
      or nothing has arrived). A candidate whose block grant does not fit
      is HELD: the engine stops admitting for the wave without popping it.
    - ``pop(req)``: the engine admitted ``req``.
    - ``requeue(req)``: a preempted request goes back; its tokens
      regenerate identically on re-admission.
    - ``tick()``: one wave passed (aging hooks).
    - ``waiting()`` → arrived, unadmitted requests (the speculative loop
      sizes its multi-step by it; the queue-depth gauge reads it).
    - ``wait_s(req)`` → seconds ``req`` has waited since its arrival (the
      ``serve_request`` span's ``queue_wait_ms``).
    - ``exhausted()`` → True only when no candidate will ever come again.
    - ``idle_wait()``: nothing admissible and nothing computing — block
      until the next arrival instead of spinning.

    The built-in :class:`_Sched` implements it. Handing the engine an
    external source (the reference's ``run(admission=)``), and the hooks
    only such a source needs (queue waits, retirement and drain
    notifications, prefill→decode imports, warm chains), belong to the
    fleet stack and are not ported."""

    def candidate(self):
        raise NotImplementedError

    def pop(self, req):
        raise NotImplementedError

    def requeue(self, req):
        raise NotImplementedError

    def tick(self):
        pass

    def waiting(self) -> int:
        return 0

    def wait_s(self, req) -> float:
        return 0.0

    def exhausted(self) -> bool:
        raise NotImplementedError

    def idle_wait(self) -> None:
        pass


class _Sched(AdmissionSource):
    """Host-side admission ORDER over a fixed request list. ``fifo`` is
    strict arrival order with head-of-line blocking; ``sjf`` picks the
    shortest known job (prompt length + ``n_new`` budget) among ARRIVED
    requests; ``priority`` the highest caller-supplied priority. Both
    non-fifo policies run under an aging bound: a request that has waited
    ``aging`` waves past its arrival jumps to the front (FIFO among the
    aged). Whatever the policy, a candidate whose block grant does not fit
    HOLDS admission for the wave (no skip-ahead)."""

    def __init__(self, lens, n_new_of, policy, aging, priorities,
                 arrivals, t0):
        self.pending = list(range(len(lens)))     # arrival order
        self.cost = [lens[i] + n_new_of[i] for i in range(len(lens))]
        self.policy = policy
        self.aging = aging
        self.prio = priorities
        self.arrivals = arrivals
        self.t0 = t0
        self.age = [0] * len(lens)                # waves arrived-unadmitted

    def _now(self):
        """One clock read per scan."""
        return None if self.arrivals is None else \
            time.monotonic() - self.t0

    def _arrived(self, req, now):
        return self.arrivals is None or self.arrivals[req] <= now

    def candidate(self):
        if not self.pending:
            return None
        now = self._now()
        if self.policy == "fifo":
            head = self.pending[0]
            return head if self._arrived(head, now) else None
        arrived = [r for r in self.pending if self._arrived(r, now)]
        if not arrived:
            return None
        aged = [r for r in arrived if self.age[r] >= self.aging]
        if aged:
            return aged[0]                        # FIFO among the aged
        if self.policy == "sjf":
            return min(arrived, key=lambda r: (self.cost[r], r))
        return min(arrived, key=lambda r: (-self.prio[r], r))

    def pop(self, req):
        self.pending.remove(req)

    def requeue(self, req):
        """Re-insert a preempted request at its arrival-order position
        (age kept: a preemption does not reset its aging)."""
        bisect.insort(self.pending, req)

    def tick(self):
        now = self._now()
        for r in self.pending:
            if self._arrived(r, now):
                self.age[r] += 1

    def waiting(self) -> int:
        """Arrived-but-unadmitted requests (one clock read)."""
        if self.arrivals is None:
            return len(self.pending)
        now = self._now()
        return sum(1 for r in self.pending if self.arrivals[r] <= now)

    def wait_s(self, req) -> float:
        """Queue wait against the request's arrival (the run's start when
        there is no trace)."""
        return max(0.0, time.monotonic() - self.t0
                   - (self.arrivals[req] if self.arrivals is not None
                      else 0.0))

    def next_arrival(self):
        """The request whose arrival unblocks admission: fifo's head, or
        the earliest arrival under the other policies."""
        if self.arrivals is None or self.policy == "fifo":
            return self.pending[0]
        return min(self.pending, key=lambda r: self.arrivals[r])

    def exhausted(self) -> bool:
        return not self.pending

    def idle_wait(self) -> None:
        """Sleep until the blocking request arrives instead of spinning."""
        if self.arrivals is None or not self.pending:
            return
        wait = self.arrivals[self.next_arrival()] \
            - (time.monotonic() - self.t0)
        if wait > 0:
            time.sleep(wait)


class _ServeTelemetry:
    """The engine's emissions into a telemetry registry (the reference's
    ``_gauges``/``_note_*`` hooks, ``models/serving.py:1769-1896``), for
    the levers the port has. Every timestamp comes from the registry's
    clock; the host-stats latencies stay on ``time.monotonic``. Disabled
    (the null registry) each hook returns at its first test. Nothing here
    synchronises with the card or reads a tensor back: ``paged_decode_ms``
    is the host time around a wave (wall time where the wave ends in a
    readback — an eos check, the speculative trip's report — dispatch
    time otherwise), as the reference documents it."""

    def __init__(self, reg, share_prefix: bool, lazy_growth: bool):
        self.reg = reg
        self.enabled = reg.enabled
        self.share_prefix = share_prefix
        self.lazy_growth = lazy_growth
        self.meta: dict[int, dict] = {}
        self.join_clk0 = None
        if self.enabled:
            # handles resolved once: a per-wave gauge() call would take the
            # registry's lock for nothing
            self.g_queue = reg.gauge("serve_queue_depth")
            self.g_occ = reg.gauge("serve_slot_occupancy")
            self.g_kv = reg.gauge("kv_blocks_in_use")
            self.g_hit = reg.gauge("prefix_hit_blocks")
            self.g_hitf = reg.gauge("prefix_hit_frac")
            self.g_lazy = reg.gauge("blocks_grown_lazy")
            self.g_paged = reg.gauge("paged_decode_ms")

    def start(self) -> None:
        """A run begins: per-request records reset, and the join → first
        token clock is armed (fired by the run's first prefill)."""
        if self.enabled:
            self.meta = {}
            self.join_clk0 = self.reg.clock()

    def clock(self):
        return self.reg.clock() if self.enabled else None

    def gauges(self, rstate, sched, busy: int) -> None:
        """The per-wave gauges (``sched`` None: the run's end, nothing
        waits)."""
        if not self.enabled:
            return
        self.g_queue.set(0 if sched is None else sched.waiting())
        self.g_occ.set(busy / rstate.slots)
        self.g_kv.set(rstate.alloc.in_use)
        if self.share_prefix:
            ps = rstate.prefix_stats
            self.g_hit.set(ps["hit_blocks"])
            self.g_hitf.set(round(ps["hit_blocks"]
                                  / max(ps["prompt_blocks"], 1), 4))
        if self.lazy_growth:
            self.g_lazy.set(rstate.grown_lazy)

    def admit(self, req: int, sched) -> None:
        if self.enabled:
            self.meta[req] = {"clk": self.reg.clock(), "prefill_ms": 0.0,
                              "queue_wait_ms": round(sched.wait_s(req) * 1e3,
                                                     3)}
            self.reg.counter("serve_admissions").inc()

    def prefill(self, req: int, start_clk, prompt_len: int,
                chunks: int | None = None) -> None:
        """One ``serve_prefill`` span, from ``start_clk`` (the clock before
        the admission's first launch) to now."""
        if not self.enabled:
            return
        t1 = self.reg.clock()
        if self.join_clk0 is not None:
            self.reg.gauge("join_first_token_ms").set(
                round((t1 - self.join_clk0) * 1e3, 3))
            self.join_clk0 = None
        self.meta[req]["prefill_ms"] += round((t1 - start_clk) * 1e3, 3)
        args = {"prompt_len": prompt_len}
        if chunks is not None:
            args["chunks"] = chunks
        self.reg.emit_span("serve_prefill", start_clk, t1, **args)

    def drop(self, req: int) -> None:
        """A preempted request: its record restarts at re-admission."""
        self.meta.pop(req, None)

    def retire(self, req: int, ntok: int, decode_steps: int) -> None:
        """One ``serve_request`` span (admission → retirement) and its
        ``serve_request_ms`` sample."""
        m = self.meta.pop(req, None) if self.enabled else None
        if m is None:
            return
        t1 = self.reg.clock()
        self.reg.emit_span("serve_request", m["clk"], t1, request=req,
                           tokens=int(ntok),
                           queue_wait_ms=m["queue_wait_ms"],
                           prefill_ms=round(m["prefill_ms"], 3),
                           decode_steps=int(decode_steps))
        self.reg.histogram("serve_request_ms").record((t1 - m["clk"]) * 1e3)
        self.reg.counter("serve_generated_tokens").inc(int(ntok))

    def wave_start(self) -> float:
        return time.monotonic() if self.enabled else 0.0

    def wave_end(self, t0: float) -> None:
        if self.enabled:
            self.g_paged.set(round((time.monotonic() - t0) * 1e3, 3))

    def spec_totals(self, generated: int, admitted: int,
                    slot_steps: int) -> None:
        """The speculative run's draft counters: each verification
        slot-step emits one model token plus its accepted drafts."""
        if self.enabled:
            self.reg.counter("serve_accepted_draft_tokens").inc(
                max(0, (generated - admitted) - slot_steps))
            self.reg.counter("serve_verify_slot_steps").inc(slot_steps)


def make_serve_engine(params, cfg: BurnInConfig, *, max_len: int,
                      cache_dtype: str = "bf16", prefix=None, sampler=None,
                      prefill_chunk: int | None = None,
                      spec_k: int | None = None, kv_block: int = 16,
                      policy: str = "fifo", aging: int | None = None,
                      share_prefix: bool = False, lazy_growth: bool = False,
                      prefix_keep_blocks: int = 64,
                      paged_kernel: str = "auto", telemetry=None,
                      device="cuda", **levers):
    """Reusable engine: ``run(prompts, n_new, *, slots, eos_id,
    eos_check_every, arrivals, kv_blocks, static_batching, priorities) →
    list of [n_i] int64 token tensors``.

    The pool has ``kv_blocks`` blocks of ``kv_block`` rows (default: one
    full table per slot, plus the prefix's blocks and the garbage block, at
    which admission never waits on memory); a smaller ``kv_blocks`` turns
    into admission control. ``n_new`` is an int or one budget per request;
    ``arrivals`` (seconds from the run's start, e.g. ``utils/traffic``'s
    traces) gates admission; ``static_batching`` admits only when the
    engine is idle (the run-to-completion baseline). After each call
    ``run.last_stats`` holds ``requests``, ``generated``, ``waves``,
    ``latency_ms`` (admission → retirement, host clock), ``kv`` (allocator
    high-water, physical and logical blocks, utilisation against the dense
    ``slots × max_len`` reservation, lazily grown blocks), ``sched``
    (policy, preemptions, admit and turnaround waves) and ``prefix``
    (sharing's hit blocks and saved tokens).

    ``prefix`` (``[L_p]`` tokens): every request decodes
    ``concat(prefix, prompt)``; the prefix prefills once per run.
    ``prefill_chunk``: chunked admission interleaved with the waves.
    ``policy``/``aging``: admission order. ``share_prefix`` /
    ``prefix_keep_blocks``: cross-request prefix-block sharing and the LRU
    cap on retained blocks. ``lazy_growth``: per-wave block grants (needs
    ``eos_check_every == 1``). See the module docstring.

    ``sampler`` (:func:`..decode.make_sampler`'s, or the dict of its
    keyword arguments) makes the engine sampled; ``run`` then needs
    ``rng`` (an int seed or ``[2]`` key data). Keys follow (request,
    position), never the schedule, so slot count, arrivals, admission
    order and preemption change no token; ``make_sampler(top_k=1)`` is the
    greedy engine.

    ``spec_k`` serves greedily through speculation (:func:`make_spec_step`;
    not with ``sampler``): ``max_len`` must leave ``spec_k`` rows of
    verification headroom, ``eos_check_every`` stays 1 and
    ``static_batching`` off; ``run.last_stats`` adds ``slot_steps`` (the
    verification slot-steps), ``accepted_per_step`` (tokens a slot-step,
    admission tokens excluded), ``decode_steps`` (each request's) and
    ``trips`` (replays, one readback each). It composes with ``prefix``,
    ``prefill_chunk`` (admitted in one sweep, not interleaved),
    ``share_prefix`` and ``lazy_growth`` (a slot whose next ``k + 1``-row
    window leaves its grant freezes and the host grows it).

    ``cache_dtype="int8"`` serves from an int8 pool; ``QTensor`` params
    serve through the phase split. ``params`` must live on ``device``
    (``"cuda"`` unless the caller asks for the CPU). On a CUDA device the
    waves (or speculative trips) replay a captured graph (``run.captures``
    counts the captures, one per ``(slots, kv_blocks)``;
    ``run.capture(pool)`` captures the wave over a caller's pool, for
    timing).

    ``telemetry`` injects a telemetry registry (default: the process
    registry — the no-op unless ``TPU_TELEMETRY_DIR`` is set). When
    enabled, every admission emits a ``serve_prefill`` span (with
    ``chunks`` under chunked prefill), every retirement a
    ``serve_request`` span (admission → retirement, recorded in the
    ``serve_request_ms`` histogram) carrying ``request``, ``tokens``,
    ``queue_wait_ms``, ``prefill_ms`` and ``decode_steps``; every wave
    sets the queue, slot, KV-block, prefix-hit, lazy-growth and
    ``paged_decode_ms`` gauges; ``serve_admissions``,
    ``serve_generated_tokens`` and, under ``spec_k``,
    ``serve_accepted_draft_tokens`` / ``serve_verify_slot_steps`` count.
    Spans clock the host's view of the schedule (on the card a prefill
    span covers its launches, a request span closes at the wave the host
    retired it), and telemetry adds no synchronise or readback: the card
    runs the same work either way."""
    _refuse_levers(levers, _ENGINE_LATER, "make_serve_engine")
    tel = _ServeTelemetry(
        telemetry if telemetry is not None else get_registry(),
        share_prefix, lazy_growth)
    if isinstance(sampler, dict):
        sampler = make_sampler(**sampler)
    if sampler is not None and not isinstance(sampler, Sampler):
        raise TypeError(f"sampler must come from make_sampler (or be the "
                        f"dict of its arguments), got {type(sampler)}")
    if spec_k is not None:
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if sampler is not None:
            raise ValueError(
                "speculative serving is greedy-only: acceptance tests the "
                "model's argmax chain — drop sampler or spec_k")
    dev = check_device(device)
    _check_params(params, dev)
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    if kv_block < 1:
        raise ValueError(f"kv_block must be >= 1, got {kv_block}")
    if paged_kernel not in ("auto", "on", "off"):
        raise ValueError(f"unknown paged_kernel {paged_kernel!r}: "
                         f"use auto|on|off")
    if policy not in _POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}: use {' | '.join(_POLICIES)}")
    if aging is not None and aging < 1:
        raise ValueError(f"aging must be >= 1 waves, got {aging}")
    aging = _DEFAULT_AGING if aging is None else aging
    if prefix_keep_blocks < 0:
        raise ValueError(
            f"prefix_keep_blocks must be >= 0, got {prefix_keep_blocks}")
    quant = check_cache_dtype(cache_dtype)
    geom = paged_pool_spec(cfg, max_len, kv_block, cache_dtype)
    bs, nt = kv_block, geom["tables"]
    pool_keys = ("k", "v") + (("k_scale", "v_scale") if quant else ())
    step = make_serve_step(params, cfg, sampler, paged_kernel=paged_kernel)
    trip = (None if spec_k is None else
            make_spec_step(params, cfg, spec_k, paged_kernel=paged_kernel))
    headroom = spec_k or 0
    spec_width = max_len + headroom + 1     # the window at cur always fits
    # the phase split: admissions from a dequantised copy, built once
    prefill_params = params
    if any(isinstance(x, QTensor) for x in tree_leaves(params)):
        prefill_params = dequantize_params(params)

    prefix_len = full_blocks = tail_rows = 0
    if prefix is not None:
        prefix = torch.as_tensor(prefix, device=dev).long().reshape(-1)
        prefix_len = int(prefix.shape[0])
        if prefix_len >= max_len:
            raise ValueError(
                f"prefix ({prefix_len}) must leave room under max_len "
                f"({max_len})")
        full_blocks = prefix_len // bs          # shared read-only
        tail_rows = prefix_len % bs             # copied per admission
        prefix_impl = _select_prefill_impl(cfg, prefix_len, "auto", dev)
    need_prefix = full_blocks + (1 if tail_rows else 0)

    # one pool and its wave (on the card captured) per (slots, kv_blocks)
    pools: dict[tuple[int, int], tuple[dict, Any]] = {}

    def capture(pool: dict, on_card: bool = True):
        """The engine's wave (the speculative trip under ``spec_k``) over
        ``pool``: a :class:`WaveGraph` or :class:`SpecGraph`, captured on
        the card — what a run replays, for timing it alone."""
        if trip is not None:
            return SpecGraph(trip, pool, spec_width, capture=on_card)
        return WaveGraph(step, pool, sampled=sampler is not None,
                         capture=on_card)

    def pool_for(slots: int, kv_blocks: int):
        """The run's pool, zeroed as a fresh one would be, and its wave."""
        key = (slots, kv_blocks)
        if key not in pools:
            pool = init_paged_cache(cfg, slots, max_len, block_size=bs,
                                    num_blocks=kv_blocks,
                                    cache_dtype=cache_dtype, device=dev)
            pools[key] = (pool, capture(pool, dev.type == "cuda"))
            run.captures += dev.type == "cuda"
        pool, graph = pools[key]
        for buf in tree_leaves(pool):
            buf.zero_()
        return pool, graph

    def to_device(values, dtype):
        """Host values on the engine's device. On the card the copy goes
        from pinned memory without blocking: a pageable copy would make the
        host wait for every wave it has queued (as would assigning a
        Python number into a device tensor: single values go by
        ``fill_``)."""
        t = torch.as_tensor(values, dtype=dtype)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    # ------------------------------------------------ admission pieces

    def tail_copy(pool, src: int, dst: int) -> None:
        """The prefix's partial tail block into an admission's first own
        block — the only per-admission prefix bytes."""
        for key in pool_keys:
            for buf in pool[key]:
                buf[dst] = buf[src]

    def slot_view(pool, slot: int) -> dict:
        """The one-row pool of ``slot``: its table row and a view of its
        position, which ``forward_paged`` advances in place."""
        return dict(pool, block_tables=pool["block_tables"][slot:slot + 1],
                    pos=pool["pos"][slot:slot + 1])

    def admit_table(pool, slot: int, row, tail, start: int) -> None:
        """Map the slot's table row, copy the prefix tail (when the
        admission shares no block carrying it), set the start position."""
        pool["block_tables"][slot] = to_device(row, torch.int32)
        if tail is not None:
            tail_copy(pool, *tail)
        pool["pos"][slot].fill_(start)

    @torch.no_grad()
    def admit_full(pool, slot: int, prompt, impl: str, row, tail,
                   start: int):
        """One full admission: table, prefill of ``prompt`` (the unshared
        suffix under sharing) from ``start``; the last position's
        logits."""
        admit_table(pool, slot, row, tail, start)
        logits, _ = forward_paged(prefill_params, prompt[None],
                                  slot_view(pool, slot), cfg,
                                  prefill_impl=impl, paged_kernel="off")
        return logits[0, -1]

    pick = _make_pick(sampler)

    def pick_first(logits_row, req: int, rng):
        """An admission's first token from its last prompt position's
        logits, keyed at (request, position 0)."""
        key = None if sampler is None else to_device(
            _request_key(rng, req, 0), torch.long)
        return pick(logits_row, key)

    @torch.no_grad()
    def chunk_step(pool, slot: int, chunk):
        """One ``[1, C]`` prefill chunk at the slot's position. Pad rows of
        the final chunk land in the cache but stay unreachable: the mask
        hides keys past a query, and ``pos`` rewinds to the true length."""
        logits, _ = forward_paged(prefill_params, chunk,
                                  slot_view(pool, slot), cfg,
                                  prefill_impl="cached", paged_kernel="off")
        return logits[0]

    def check_chunk_bound(length: int, start: int | None = None) -> int:
        start = prefix_len if start is None else start
        n = -(-length // prefill_chunk)
        if start + n * prefill_chunk > max_len:
            raise ValueError(
                f"chunked prefill pads the prompt ({length}) to "
                f"{n * prefill_chunk} rows, which after the start "
                f"position ({start}) exceeds max_len ({max_len}) — "
                f"raise max_len to >= {start + n * prefill_chunk} or "
                f"shrink prefill_chunk")
        return n

    def chunk_split(prompt, length: int, start: int):
        """Pad-to-C chunks of ``prompt`` (the tokens actually prefilled),
        the true last token's offset in the final chunk, and the position
        after the rewind."""
        c = prefill_chunk
        nc = check_chunk_bound(length, start)
        padded = torch.zeros((nc * c,), dtype=torch.long, device=dev)
        padded[:length] = prompt
        chunks = [padded[i * c:(i + 1) * c][None] for i in range(nc)]
        return chunks, length - 1 - (nc - 1) * c, start + length

    def rows_needed(length: int, n_new_i: int) -> int:
        rows = prefix_len + length + n_new_i + headroom
        if prefill_chunk is not None:
            padded = prefix_len + check_chunk_bound(length) * prefill_chunk
            rows = max(rows, padded)
        return min(rows, geom["rows"])

    class _Run:
        """Per-run scheduler state: the pool, the allocator, the prefix
        index and the host-side request bookkeeping."""

        def __init__(self, slots, kv_blocks, n_new_of, lens, host_toks):
            self.slots = slots
            self.n_new_of = n_new_of
            self.host_toks = host_toks
            if kv_blocks is None:
                kv_blocks = 1 + need_prefix + slots * nt
            # feasibility is the FULL budget, lazy growth or not: a request
            # left alone in the pool (the preemption's end state) must be
            # able to grow to its worst case
            worst = max(blocks_for_rows(
                rows_needed(lens[i], n_new_of[i]) - full_blocks * bs, bs)
                for i in range(len(lens)))
            if kv_blocks < 1 + need_prefix + worst:
                raise ValueError(
                    f"kv_blocks ({kv_blocks}) cannot hold the largest "
                    f"request ({worst} blocks of {bs} rows"
                    + (f" + {need_prefix} prefix blocks" if need_prefix
                       else "")
                    + " + the reserved garbage block) — the queue would "
                    "deadlock; raise kv_blocks")
            self.alloc = BlockAllocator(kv_blocks)
            self.index = (PrefixIndex(self.alloc, prefix_keep_blocks)
                          if share_prefix else None)
            self.pool, self.graph = pool_for(slots, kv_blocks)
            self.owned: dict[int, list[int]] = {}     # req → blocks
            self.prefix_blocks: list[int] = []
            self.tail_src = 0
            self.in_use_sum = self.in_use_n = 0       # per-loop samples
            self.logical: dict[int, int] = {}         # req → table blocks
            self.logical_now = self.logical_peak = 0
            self.logical_sum = self.live_sum = 0
            self.grown_lazy = 0
            self.preempted = 0
            self.admit_wave: dict[int, int] = {}
            self.retire_wave: dict[int, int] = {}
            self.prefix_stats = {"hit_blocks": 0, "lookups": 0,
                                 "prompt_blocks": 0, "tokens_saved": 0,
                                 "reclaim_blocked_live": 0,
                                 "reclaim_blocked_empty": 0}
            self._row_np: dict[int, np.ndarray] = {}
            if prefix is not None:
                blocks = self.alloc.alloc(need_prefix)
                self.prefix_blocks = blocks
                row = torch.zeros((1, nt), dtype=torch.int32)
                row[0, :need_prefix] = torch.tensor(blocks)
                if tail_rows:
                    self.tail_src = blocks[-1]
                sub = dict(self.pool, block_tables=row.to(dev),
                           pos=torch.zeros((1,), dtype=torch.int32,
                                           device=dev))
                forward_paged(prefill_params, prefix[None], sub, cfg,
                              prefill_impl=prefix_impl, paged_kernel="off")

        def _chunks_for(self, req: int, length: int) -> list:
            """The prompt's candidate chain chunks; at least one prompt
            token stays to forward (its logits pick the first token)."""
            chunks = chain_chunks(self.host_toks[req], bs, tail_rows)
            while chunks and chunk_tokens_covered(
                    len(chunks), bs, tail_rows) > length - 1:
                chunks.pop()
            return chunks

        def admit_blocks(self, req: int, length: int):
            """Allocate the request's blocks, sharing indexed full leading
            prompt blocks first (refcount++, read-only for this request);
            None = hold in queue. Returns ``(row, tail, start, covered,
            entries)``: the table row, the prefix tail copy ``(src, dst)``
            or None, the prefill start position, the prompt tokens the
            shared blocks cover, and the table entries granted."""
            shared: list[int] = []
            cov = n_chunks = 0
            if self.index is not None:
                chunks = self._chunks_for(req, length)
                n_chunks = len(chunks)
                shared = self.index.match(chunks)
                cov = chunk_tokens_covered(len(shared), bs, tail_rows)
                if prefill_chunk is not None:
                    # the PADDED unshared suffix must stay within the
                    # table: un-share blocks until it fits
                    while shared and (prefix_len + cov + -(-(
                            length - cov) // prefill_chunk)
                            * prefill_chunk) > max_len:
                        self.alloc.free([shared.pop()])
                        cov = chunk_tokens_covered(len(shared), bs,
                                                   tail_rows)
            k = len(shared)
            # a lazy grant covers the first write window: one decode row,
            # or the k + 1-row verification window under speculation
            grant = prefix_len + length + headroom + (
                1 if lazy_growth else self.n_new_of[req])
            if prefill_chunk is not None:
                padded_end = prefix_len + cov + -(-(
                    length - cov) // prefill_chunk) * prefill_chunk
                grant = max(grant, padded_end)
            grant = min(grant, geom["rows"])
            own_rows = grant - full_blocks * bs - k * bs
            blocks = self._alloc_reclaiming(blocks_for_rows(own_rows, bs))
            if blocks is None:
                if shared:
                    self.alloc.free(shared)       # undo the shares
                return None
            # stats count admissions, not the probes of a held request
            if self.index is not None:
                ps = self.prefix_stats
                ps["lookups"] += 1
                ps["prompt_blocks"] += n_chunks
                ps["hit_blocks"] += k
                ps["tokens_saved"] += cov
            self.owned[req] = shared + blocks
            row = np.zeros((nt,), np.int32)
            row[:full_blocks] = self.prefix_blocks[:full_blocks]
            row[full_blocks:full_blocks + k] = shared
            row[full_blocks + k:full_blocks + k + len(blocks)] = blocks
            # the template tail copy applies only when no shared block
            # already carries those rows
            tail = (self.tail_src, blocks[0]) if tail_rows and not k \
                else None
            entries = full_blocks + k + len(blocks)
            self.logical[req] = entries
            self.logical_now += entries
            self.logical_peak = max(self.logical_peak, self.logical_now)
            self._row_np[req] = row
            return row, tail, prefix_len + cov, cov, entries

        def register_prefix(self, req: int) -> None:
            """Index the request's prefilled FULL prompt blocks so later
            admissions can share them (no-op when sharing is off)."""
            if self.index is None:
                return
            chunks = chain_chunks(self.host_toks[req], bs, tail_rows)
            row = self._row_np[req]
            self.index.register(
                chunks, [int(row[full_blocks + j])
                         for j in range(len(chunks))])

        def _alloc_reclaiming(self, n: int):
            """``alloc`` that evicts retained-but-unreferenced prefix
            blocks under allocation pressure before giving up."""
            blocks = self.alloc.alloc(n)
            while blocks is None and self.index is not None:
                if not self.index.reclaim(n - self.alloc.free_blocks):
                    why = self.index.reclaim_blocked
                    if why is not None:
                        self.prefix_stats[f"reclaim_blocked_{why}"] += 1
                    return None
                blocks = self.alloc.alloc(n)
            return blocks

        def grow_block(self, req: int) -> int | None:
            """One more block for a lazily granted request (None: the pool
            is dry — the caller stalls the slot)."""
            b = self._alloc_reclaiming(1)
            if b is None:
                return None
            self.owned[req].append(b[0])
            self.logical[req] += 1
            self.logical_now += 1
            self.logical_peak = max(self.logical_peak, self.logical_now)
            self.grown_lazy += 1
            return b[0]

        def retire_blocks(self, req: int) -> None:
            self.alloc.free(self.owned.pop(req))
            self.logical_now -= self.logical.pop(req)
            self._row_np.pop(req, None)
            if self.index is not None:
                self.index.trim()

        def close(self) -> None:
            """End of run: the index's retained blocks go back, so the
            pool drains to its prefix blocks."""
            if self.index is not None:
                self.index.release()

        def sample(self, live: int) -> None:
            self.in_use_sum += self.alloc.in_use
            self.in_use_n += 1
            self.logical_sum += self.logical_now
            self.live_sum += live

        def kv_stats(self) -> dict:
            s = self.alloc.stats()
            dense = self.slots * geom["rows"]
            mean_blocks = self.in_use_sum / max(self.in_use_n, 1)
            return {
                **s, "block_size": bs,
                "peak_rows": s["high_water"] * bs,
                "dense_rows": dense,
                "utilisation": round(s["high_water"] * bs / max(dense, 1),
                                     4),
                "mean_utilisation": round(mean_blocks * bs / max(dense, 1),
                                          4),
                "kv_blocks_physical": s["high_water"],
                "kv_blocks_logical": self.logical_peak,
                "mean_logical_blocks": round(
                    self.logical_sum / max(self.in_use_n, 1), 3),
                "blocks_grown_lazy": self.grown_lazy,
            }

        def sched_stats(self) -> dict:
            rw = sorted(self.retire_wave.values())
            aw = sorted(self.admit_wave.values())

            def mean(xs):
                return round(sum(xs) / len(xs), 3) if xs else None

            return {
                "policy": policy,
                "preempted": self.preempted,
                "mean_admit_wave": mean(aw),
                "mean_turnaround_waves": mean(rw),
                "p50_turnaround_waves": rw[len(rw) // 2] if rw else None,
                "mean_live_requests": round(
                    self.live_sum / max(self.in_use_n, 1), 3),
                "admit_wave_of": dict(self.admit_wave),
            }

        def prefix_summary(self) -> dict:
            ps = self.prefix_stats
            return {
                "enabled": share_prefix,
                "hit_blocks": ps["hit_blocks"],
                "prompt_blocks": ps["prompt_blocks"],
                "hit_frac": round(ps["hit_blocks"]
                                  / max(ps["prompt_blocks"], 1), 4),
                "tokens_saved": ps["tokens_saved"],
                "lookups": ps["lookups"],
                "reclaim_blocked": {"live": ps["reclaim_blocked_live"],
                                    "empty": ps["reclaim_blocked_empty"]},
            }

    def empty_stats() -> dict:
        return {"requests": 0, "generated": 0, "waves": 0,
                "latency_ms": {"p50": None, "p99": None, "max": None},
                "kv": {"num_blocks": 0, "reserved": 0, "in_use": 0,
                       "free": 0, "high_water": 0, "refs_total": 0,
                       "block_size": bs, "peak_rows": 0, "dense_rows": 0,
                       "utilisation": 0.0, "mean_utilisation": 0.0,
                       "kv_blocks_physical": 0, "kv_blocks_logical": 0,
                       "mean_logical_blocks": 0.0, "blocks_grown_lazy": 0},
                "sched": {"policy": policy, "preempted": 0,
                          "mean_admit_wave": None,
                          "mean_turnaround_waves": None,
                          "p50_turnaround_waves": None,
                          "mean_live_requests": 0.0, "admit_wave_of": {}},
                "prefix": {"enabled": share_prefix, "hit_blocks": 0,
                           "prompt_blocks": 0, "hit_frac": 0.0,
                           "tokens_saved": 0, "lookups": 0,
                           "reclaim_blocked": {"live": 0, "empty": 0}}}

    def admit_spec(rstate, sched, slot: int, req: int, prompt, length: int):
        """A speculative admission (greedy): a whole prefill, or the chunks
        swept one after another in this call (the speculative loop has no
        per-wave boundary to interleave them into). Returns ``(first,
        entries)``, or None when the blocks do not fit (hold)."""
        got = rstate.admit_blocks(req, length)
        if got is None:
            return None
        row, tail, start, cov, entries = got
        tel.admit(req, sched)
        clk0 = tel.clock()
        suffix = prompt[cov:]
        chunks = None
        if prefill_chunk is None:
            impl = ("cached" if prefix is not None or cov else
                    _select_prefill_impl(cfg, length, "auto", dev))
            logits_row = admit_full(rstate.pool, slot, suffix, impl, row,
                                    tail, start)
        else:
            admit_table(rstate.pool, slot, row, tail, start)
            chunks, last_idx, true_pos = chunk_split(suffix, length - cov,
                                                     start)
            for chunk in chunks:
                logits_c = chunk_step(rstate.pool, slot, chunk)
            rstate.pool["pos"][slot].fill_(true_pos)     # past the pad
            logits_row = logits_c[last_idx]
        first = logits_row.argmax(dim=-1)
        rstate.register_prefix(req)
        tel.prefill(req, clk0, length,
                    chunks=None if chunks is None else len(chunks))
        return first, entries

    def run_spec(rstate, sched, toks, lens, n_new_of, eos_id):
        """The speculative schedule: the plain loop's admission and
        retirement bookkeeping, but the tokens live in the device's context
        rows (the draft source) and each trip may emit up to ``spec_k + 1``
        tokens a slot. The host syncs once a trip; a multi-step ends when
        enough slots finish — one while requests wait for a slot (so a slot
        recycles promptly), as many as are waiting, or all active ones when
        the queue is empty — or, under ``lazy_growth``, when every
        unfinished slot needs blocks, which the host then grants ``spec_k +
        1`` rows at a time (stalling a slot the pool cannot cover, and
        preempting the youngest when all stall)."""
        pool, graph = rstate.pool, rstate.graph
        sb = graph.state
        for buf in (sb.ctx, sb.cur, sb.n_out):
            buf.zero_()
        sb.eos.fill_(-1 if eos_id is None else eos_id)
        slots = rstate.slots
        active: dict[int, int] = {}
        start_of: dict[int, int] = {}            # req → first output index
        out: dict[int, Any] = {}
        admitted_at: dict[int, float] = {}
        latencies: list[float] = []
        req_steps: dict[int, int] = {}           # req → its slot-steps
        granted: dict[int, int] = {}             # slot → table entries
        pos_h: dict[int, int] = {}               # slot → its device pos
        stalled: dict[int, int] = {}             # slot → req
        admit_seq: dict[int, int] = {}
        admit_counter = slot_steps = waves = generated = admitted = 0
        trips0 = graph.trips
        ctx_pre = (prefix if prefix is not None
                   else torch.zeros((0,), dtype=torch.long, device=dev))

        def grow_to(slot: int, req: int, target_rows: int) -> bool:
            """Grant blocks until the slot's table covers ``target_rows``
            (False: the pool is dry — the caller stalls the slot)."""
            while granted[slot] * bs < target_rows:
                b = rstate.grow_block(req)
                if b is None:
                    return False
                pool["block_tables"][slot, granted[slot]].fill_(b)
                granted[slot] += 1
            return True

        def retire(req: int, ntok: int) -> None:
            rstate.retire_wave[req] = waves
            rstate.retire_blocks(req)
            latencies.append((time.monotonic() - admitted_at.pop(req)) * 1e3)
            tel.retire(req, ntok, req_steps.get(req, 0))

        while not sched.exhausted() or active or stalled:
            if lazy_growth and stalled:
                # stalled slots resume before admission: freed blocks reach
                # the oldest stalled request first
                for slot in list(stalled):
                    req = stalled[slot]
                    if grow_to(slot, req, pos_h[slot] + spec_k + 1):
                        active[slot] = req
                        del stalled[slot]
            for slot in range(slots):
                if slot in active or slot in stalled or sched.exhausted():
                    continue
                req = sched.candidate()
                if req is None:
                    break                 # nothing arrived yet
                length = lens[req]
                got = admit_spec(rstate, sched, slot, req, toks[req], length)
                if got is None:
                    break                 # blocks exhausted: hold
                first, entries = got
                sched.pop(req)
                admitted_at[req] = time.monotonic()
                rstate.admit_wave[req] = waves
                admit_seq[req] = admit_counter
                admit_counter += 1
                start_of[req] = prefix_len + length
                granted[slot] = entries
                pos_h[slot] = prefix_len + length
                # the slot's context row: prefix, prompt, first token
                row = torch.cat([ctx_pre, toks[req], first.reshape(1)])
                sb.ctx[slot].zero_()
                sb.ctx[slot, :row.shape[0]] = row
                sb.cur[slot].fill_(row.shape[0])
                sb.n_out[slot].fill_(1)
                generated += 1
                admitted += 1
                # the prefill token may already satisfy the request
                if n_new_of[req] == 1 or (eos_id is not None
                                          and int(first) == eos_id):
                    out[req] = first.reshape(1)
                    req_steps[req] = 0
                    retire(req, 1)
                    continue
                active[slot] = req
            waiting = sched.waiting()
            sched.tick()
            rstate.sample(len(active) + len(stalled))
            tel.gauges(rstate, sched, len(active) + len(stalled))
            if not active:
                if lazy_growth and stalled:
                    # every live request is stalled: preempt the YOUNGEST
                    # back to the queue (its tokens regenerate identically)
                    slot = max(stalled, key=lambda s_: admit_seq[stalled[s_]])
                    req = stalled.pop(slot)
                    rstate.preempted += 1
                    rstate.retire_blocks(req)
                    sched.requeue(req)
                    admitted_at.pop(req, None)
                    start_of.pop(req, None)
                    granted.pop(slot, None)
                    req_steps.pop(req, None)
                    tel.drop(req)
                    continue
                if not sched.exhausted() and sched.candidate() is None:
                    sched.idle_wait()
                continue
            sb.active.copy_(to_device([s_ in active for s_ in range(slots)],
                                      torch.bool))
            sb.n_new.copy_(to_device(
                [n_new_of[active[s_]] if s_ in active else 0
                 for s_ in range(slots)], torch.long))
            sb.granted.copy_(to_device(
                [granted.get(s_, 0) * bs if lazy_growth else nt * bs
                 for s_ in range(slots)], torch.long))
            # the multi-step's size follows the backlog: as many finishers
            # as requests wait (at least one), all when none is queued
            sb.stop.fill_(min(len(active), max(1, waiting))
                          if not sched.exhausted() else len(active))
            tw0 = tel.wave_start()
            report = graph.multi_step().tolist()
            tel.wave_end(tw0)
            fin_h, n_out_h, steps_h, need_h, pos_now = report[:5]
            waves += 1
            slot_steps += sum(steps_h)
            for slot, req in active.items():
                req_steps[req] = req_steps.get(req, 0) + steps_h[slot]
                pos_h[slot] = pos_now[slot]
            for slot, req in list(active.items()):
                if fin_h[slot]:
                    n, start = n_out_h[slot], start_of[req]
                    out[req] = sb.ctx[slot, start:start + n].clone()
                    generated += n - 1           # the first counted above
                    retire(req, n)
                    del active[slot]
            if lazy_growth:
                # growth after retirements: a slot at its boundary sees the
                # blocks this wave's finishers freed
                for slot, req in list(active.items()):
                    if need_h[slot] and not grow_to(
                            slot, req, pos_h[slot] + spec_k + 1):
                        stalled[slot] = req       # state frozen meanwhile
                        del active[slot]
        rstate.close()
        tel.gauges(rstate, None, 0)
        tel.spec_totals(generated, admitted, slot_steps)
        lat = sorted(latencies)

        def q(p_):
            return round(lat[min(len(lat) - 1, int(p_ * len(lat)))], 3)

        run.last_stats = {
            "requests": len(toks), "generated": generated, "waves": waves,
            "latency_ms": {"p50": q(0.5), "p99": q(0.99),
                           "max": round(lat[-1], 3)},
            "kv": rstate.kv_stats(), "sched": rstate.sched_stats(),
            "prefix": rstate.prefix_summary(),
            "slot_steps": slot_steps,
            # tokens a verification slot-step, admission tokens excluded:
            # no accepted draft reads exactly 1.0
            "accepted_per_step": (round((generated - admitted) / slot_steps,
                                        3) if slot_steps else None),
            "decode_steps": [req_steps[i] for i in range(len(toks))],
            "trips": graph.trips - trips0,
        }
        return [out[i] for i in range(len(toks))]

    @torch.no_grad()
    def run(prompts: Sequence[Any], n_new, *, slots: int = 4,
            eos_id: int | None = None, rng=None, eos_check_every: int = 1,
            arrivals=None, kv_blocks: int | None = None,
            static_batching: bool = False, priorities=None, **run_levers):
        _refuse_levers(run_levers, _RUN_LATER, "run")
        run.last_stats = None
        tel.start()
        if not prompts:
            run.last_stats = empty_stats()
            return []
        if eos_check_every < 1:
            raise ValueError(
                f"eos_check_every must be >= 1, got {eos_check_every}")
        if spec_k is not None and eos_check_every != 1:
            raise ValueError(
                "eos_check_every applies to the plain engine only — the "
                "speculative loop checks eos on the device and reads back "
                "once a trip already")
        if sampler is not None and rng is None:
            raise ValueError("a sampled engine needs rng (a PRNG key)")
        n_new_of = ([int(n_new)] * len(prompts)
                    if isinstance(n_new, (int, np.integer))
                    else [int(n) for n in n_new])
        if len(n_new_of) != len(prompts):
            raise ValueError(f"per-request n_new has {len(n_new_of)} "
                             f"entries for {len(prompts)} prompts")
        if any(n < 1 for n in n_new_of):
            raise ValueError(f"n_new must be >= 1, got {min(n_new_of)}")
        if arrivals is not None:
            arrivals = [float(a) for a in arrivals]
            if len(arrivals) != len(prompts):
                raise ValueError(f"arrivals has {len(arrivals)} entries "
                                 f"for {len(prompts)} prompts")
        if priorities is not None:
            if policy != "priority":
                raise ValueError(
                    f"priorities only apply to policy='priority' "
                    f"(engine built with {policy!r})")
            priorities = [float(p_) for p_ in priorities]
            if len(priorities) != len(prompts):
                raise ValueError(f"priorities has {len(priorities)} "
                                 f"entries for {len(prompts)} prompts")
        elif policy == "priority":
            priorities = [0.0] * len(prompts)     # arrival order under aging
        if lazy_growth and eos_check_every != 1:
            raise ValueError(
                "lazy_growth needs per-wave retirement accounting "
                "(eos_check_every=1): the lagged scan's wave→token mapping "
                "assumes uninterrupted slot tenancy, which a growth stall "
                "breaks")
        flat = [torch.as_tensor(p).long().reshape(-1) for p in prompts]
        lens = [int(t.shape[0]) for t in flat]
        for i, length in enumerate(lens):
            if length < 1:
                raise ValueError("prompts must have at least one token")
            if prefix_len + length + n_new_of[i] + headroom > max_len:
                raise ValueError(
                    f"prefix ({prefix_len}) + prompt ({length}) + n_new "
                    f"({n_new_of[i]})"
                    + (f" + spec_k ({spec_k}) verification headroom"
                       if headroom else "")
                    + f" exceeds max_len ({max_len})")
            if prefill_chunk is not None:
                check_chunk_bound(length)      # before any work
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if static_batching and spec_k is not None:
            raise ValueError(
                "static_batching is the plain loop's run-to-completion "
                "A/B baseline — drop spec_k to use it")
        toks = [t.to(dev) for t in flat]
        rstate = _Run(slots, kv_blocks, n_new_of, lens,
                      [t.tolist() for t in flat] if share_prefix else None)
        sched = _Sched(lens, n_new_of, policy, aging, priorities, arrivals,
                       time.monotonic())
        if spec_k is not None:
            return run_spec(rstate, sched, toks, lens, n_new_of, eos_id)
        pool, graph = rstate.pool, rstate.graph
        # the slots' current tokens: the wave's static buffer, written in
        # place (hist holds copies)
        tokens = graph.tokens
        tokens.zero_()
        if sampler is not None:
            rng = key_data(rng)
            graph.key.copy_(to_device(rng, torch.long))
            # every slot dead: request len(prompts), position 0
            dead = to_device([len(prompts), 0], torch.long)
            graph.fold.copy_(dead.expand(slots, 2))

        def set_fold(slot: int, req: int | None) -> None:
            """Slot ``slot``'s (request, position) row: ``req``'s next
            position, or the dead row (``req`` None)."""
            if sampler is not None:
                graph.fold[slot].copy_(dead if req is None else to_device(
                    [req, count[req]], torch.long))
        active: dict[int, int] = {}              # slot → request
        firsts: dict[int, Any] = {}              # req → prefill token
        span: dict[int, tuple] = {}              # req → (slot, first wave)
        count: dict[int, int] = {}               # req → tokens so far
        done_at: dict[int, int] = {}             # req → final token count
        admitted_at: dict[int, float] = {}
        latencies: list[float] = []
        filling: dict[int, dict] = {}            # slot → chunked admission
        granted: dict[int, int] = {}             # slot → table entries
        stalled: dict[int, tuple] = {}           # slot → (req, token)
        frag: dict[int, list] = {}               # req → its wave indices
        admit_seq: dict[int, int] = {}           # req → admission order
        admit_counter = 0
        mask_key = None
        hist: list = []                          # one [slots] vector a wave

        def retire(req: int, ntok: int, steps: int) -> None:
            done_at[req] = ntok
            rstate.retire_wave[req] = len(hist)
            rstate.retire_blocks(req)
            latencies.append((time.monotonic() - admitted_at.pop(req)) * 1e3)
            tel.retire(req, ntok, steps)
            set_fold(span[req][0], None)

        def activate(slot: int, req: int, first, entries: int) -> None:
            nonlocal admit_counter
            tokens[slot] = first
            firsts[req] = first
            span[req] = (slot, len(hist))
            count[req] = 1
            set_fold(slot, req)
            granted[slot] = entries
            rstate.admit_wave[req] = len(hist)
            admit_seq[req] = admit_counter
            admit_counter += 1
            # a request the prefill token already satisfies retires before
            # any step, or it would collect an extra token
            if n_new_of[req] == 1 or (eos_id is not None
                                      and eos_check_every == 1
                                      and int(first) == eos_id):
                retire(req, 1, 0)
                return
            active[slot] = req

        def mark_frag(req: int) -> None:
            """A stall breaks the request's contiguous wave span: from now
            on its emissions are listed wave by wave."""
            if req not in frag:
                sw = span[req][1]
                frag[req] = list(range(sw, sw + count[req] - 1))

        def try_grow(slot: int, req: int) -> bool:
            """Make sure the slot's next write has a granted block; grow by
            one when it crosses into a new one. False: the pool is dry."""
            nxt = prefix_len + lens[req] + count[req] - 1
            if nxt // bs < granted[slot]:
                return True
            b = rstate.grow_block(req)
            if b is None:
                return False
            pool["block_tables"][slot, granted[slot]].fill_(b)
            granted[slot] += 1
            return True

        eos_pending = 0                   # waves since the last eos scan
        while not sched.exhausted() or active or filling or stalled:
            if lazy_growth and stalled:
                # stalled slots resume before admission: freed blocks reach
                # the oldest stalled request first (or re-admissions could
                # starve it)
                for slot in list(stalled):
                    req, tok = stalled[slot]
                    if try_grow(slot, req):
                        tokens[slot] = tok
                        set_fold(slot, req)
                        active[slot] = req
                        del stalled[slot]
            admit_ok = not static_batching or (not active and not filling
                                               and not stalled)
            for slot in range(slots):
                if not admit_ok or slot in active or slot in filling \
                        or slot in stalled:
                    continue
                req = sched.candidate()
                if req is None:
                    break                 # empty, or nothing arrived yet
                length = lens[req]
                got = rstate.admit_blocks(req, length)
                if got is None:
                    break                 # blocks exhausted: hold
                row, tail, start, cov, entries = got
                sched.pop(req)
                admitted_at[req] = time.monotonic()
                tel.admit(req, sched)
                clk0 = tel.clock()
                suffix = toks[req][cov:]
                if prefill_chunk is None:
                    impl = ("cached" if prefix is not None or cov else
                            _select_prefill_impl(cfg, length, "auto", dev))
                    first = pick_first(admit_full(pool, slot, suffix, impl,
                                                  row, tail, start), req, rng)
                    rstate.register_prefix(req)
                    tel.prefill(req, clk0, length)
                    activate(slot, req, first, entries)
                else:
                    admit_table(pool, slot, row, tail, start)
                    chunks, last_idx, true_pos = chunk_split(
                        suffix, length - cov, start)
                    # the span of an interleaved admission covers the
                    # waves between its chunks (the host's view)
                    filling[slot] = {"req": req, "chunks": chunks,
                                     "last_idx": last_idx,
                                     "true_pos": true_pos,
                                     "entries": entries, "next": 0,
                                     "len": length, "clk0": clk0}
            # chunked prefill interleaved: ONE chunk per filling slot a
            # wave, while the active slots keep decoding
            for slot in list(filling):
                f = filling[slot]
                logits_c = chunk_step(pool, slot, f["chunks"][f["next"]])
                f["next"] += 1
                if f["next"] == len(f["chunks"]):
                    pool["pos"][slot].fill_(f["true_pos"])  # past the pad
                    first = pick_first(logits_c[f["last_idx"]], f["req"],
                                       rng)
                    req = f["req"]
                    del filling[slot]
                    tel.prefill(req, f["clk0"], f["len"], chunks=f["next"])
                    rstate.register_prefix(req)
                    activate(slot, req, first, f["entries"])
            if lazy_growth:
                # a slot whose next write crosses into an ungranted block
                # grows, or stalls when the pool is dry (writes fenced,
                # position frozen, token saved)
                for slot, req in list(active.items()):
                    if not try_grow(slot, req):
                        mark_frag(req)
                        stalled[slot] = (req, tokens[slot].clone())
                        set_fold(slot, None)
                        del active[slot]
            sched.tick()
            busy = len(active) + len(filling) + len(stalled)
            rstate.sample(busy)
            tel.gauges(rstate, sched, busy)
            if not active:
                if stalled and not filling:
                    # every live request is stalled and nothing else can
                    # free blocks: preempt the YOUNGEST back to the queue
                    slot = max(stalled,
                               key=lambda s: admit_seq[stalled[s][0]])
                    req, _tok = stalled.pop(slot)
                    rstate.preempted += 1
                    rstate.retire_blocks(req)
                    sched.requeue(req)
                    del count[req], span[req]
                    firsts.pop(req, None)
                    frag.pop(req, None)
                    admitted_at.pop(req, None)
                    granted.pop(slot, None)
                    tel.drop(req)
                    continue
                if not filling and not sched.exhausted() \
                        and sched.candidate() is None:
                    sched.idle_wait()
                continue
            live = tuple(sorted(active))
            if live != mask_key:
                mask_key = live
                graph.active.copy_(to_device(
                    [s in active for s in range(slots)], torch.bool))
            tw0 = tel.wave_start()
            graph.replay()
            hist.append(tokens.clone())
            for slot, req in active.items():
                if req in frag:
                    frag[req].append(len(hist) - 1)
            for slot, req in list(active.items()):
                count[req] += 1
                if count[req] >= n_new_of[req]:
                    retire(req, count[req], count[req] - 1)
                    del active[slot]          # the slot recycles next wave
            if eos_id is not None:
                eos_pending += 1
                if eos_check_every == 1:
                    tok_h = hist[-1].cpu()
                    eos_pending = 0
                    for slot, req in list(active.items()):
                        if int(tok_h[slot]) == eos_id:
                            retire(req, count[req], count[req] - 1)
                            del active[slot]
                elif eos_pending >= eos_check_every:
                    # one [W, slots] readback: each active request's FIRST
                    # eos since its admission fixes its length; only the
                    # retirement is late
                    block = torch.stack(hist[-eos_pending:]).cpu()
                    base = len(hist) - eos_pending
                    eos_pending = 0
                    for slot, req in list(active.items()):
                        sw = span[req][1]
                        for j in range(block.shape[0]):
                            h = base + j
                            if h >= sw and int(block[j, slot]) == eos_id:
                                retire(req, h - sw + 2, h - sw + 1)
                                del active[slot]
                                break
            tel.wave_end(tw0)
        rstate.close()
        tel.gauges(rstate, None, 0)

        waves = torch.stack(hist) if hist else None      # [W, slots]
        outs = []
        for req in range(len(toks)):
            n, (slot, sw) = done_at[req], span[req]
            head = firsts[req].reshape(1)
            if n == 1:
                outs.append(head)
            elif req in frag:
                idx = torch.tensor(frag[req][:n - 1], device=dev)
                outs.append(torch.cat([head, waves[idx, slot]]))
            else:
                # the n - 1 waves while req held its slot: one emission each
                outs.append(torch.cat([head, waves[sw:sw + n - 1, slot]]))
        if eos_id is not None and eos_check_every > 1:
            # a count-cap retirement can precede the scan that would have
            # seen an eos (and a first-token eos is never scanned): cut at
            # the first eos, as the per-wave check would have
            for i, o in enumerate(outs):
                vals = o.tolist()
                n = next((j + 1 for j, t in enumerate(vals) if t == eos_id),
                         len(vals))
                outs[i] = o[:n]
        lat = sorted(latencies)

        def q(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 3)

        run.last_stats = {
            "requests": len(outs),
            "generated": sum(int(o.shape[0]) for o in outs),
            "waves": len(hist),
            "latency_ms": {"p50": q(0.5), "p99": q(0.99),
                           "max": round(lat[-1], 3)},
            "kv": rstate.kv_stats(),
            "sched": rstate.sched_stats(),
            "prefix": rstate.prefix_summary(),
        }
        return outs

    run.last_stats = None
    run.step = step
    run.captures = 0
    run.capture = capture
    return run


def serve(params, prompts: Sequence[Any], n_new, cfg: BurnInConfig, *,
          slots: int = 4, max_len: int | None = None, rules=None,
          cache_dtype: str = "bf16", eos_id: int | None = None,
          eos_check_every: int = 1, prefill_chunk: int | None = None,
          spec_k: int | None = None, kv_block: int = 16,
          kv_blocks: int | None = None, arrivals=None,
          static_batching: bool = False, device="cuda") -> list[Any]:
    """Serve ``prompts`` (each ``[L_i]``) with continuous batching: one
    token tensor per prompt, in request order (``[n_new]`` each, shorter
    when ``eos_id`` fires). A one-shot convenience over
    :func:`make_serve_engine` (which a caller timing or re-running
    schedules should build once instead); ``max_len`` defaults to the
    longest prompt (padded to ``prefill_chunk``) plus the largest
    budget."""
    if not prompts:
        return []
    if max_len is None:
        n_max = n_new if isinstance(n_new, (int, np.integer)) \
            else max(n_new)
        longest = max(int(torch.as_tensor(p).reshape(-1).shape[0])
                      for p in prompts)
        if prefill_chunk:
            longest = -(-longest // prefill_chunk) * prefill_chunk
        max_len = longest + int(n_max) + (spec_k or 0)
    engine = make_serve_engine(params, cfg, max_len=max_len,
                               cache_dtype=cache_dtype,
                               prefill_chunk=prefill_chunk, spec_k=spec_k,
                               kv_block=kv_block, device=device)
    return engine(prompts, n_new, slots=slots, rules=rules, eos_id=eos_id,
                  eos_check_every=eos_check_every, kv_blocks=kv_blocks,
                  arrivals=arrivals, static_batching=static_batching)
