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
  regenerate identically) when every live request stalls;
- ``host_spill`` (with ``share_prefix``): the prefix index's host-RAM tier
  (``models/hostkv.py``). An evicted chain is copied into a host block pool
  (crc-stamped) instead of dropped; a later hit on it grants fresh device
  blocks, re-checks the rows' crc and imports them in place, then prefills
  only the rest of the prompt. A crc failure drops the chain and the
  request prefills from tokens (billed in ``corrupt_dropped``). Under
  ``host_swap="async"`` the next queued request's spilled rows are staged
  (verified and copied to the card on a worker thread) while the wave
  runs.
- ``shared_store`` (with ``share_prefix``, not with ``host_spill``): the
  fleet-shared prefix CDN (``hostkv.WarmChainStore``, its disk tier
  behind it). Evictions publish whole root→leaf chains into the store
  (``hostkv.ChainSpill``); an admission whose device match ends early
  fetches the chain's next rows from the store (RAM, or the disk's
  verified frame), imports them in place and registers them. Tokens equal
  the engine's without it.

Sharded serving (``run(rules=)``, the rules of a ``torch.distributed``
world, one process a device): every rank runs the same host scheduler;
admissions and prefill chunks run on every rank, its heads over ``tp``
(``decode.forward_paged(rules=, replicated=True)``), each rank's pool
holding its KV heads (``paging.init_paged_cache(rules=)``); each wave runs
each data rank's slots (``slots`` split in order over the data axes,
which must divide it) and all-gathers the wave's tokens over the data
axes, so every rank's scheduler sees every slot's token and takes the
same decisions. The engine's ``params`` are then this rank's shards
(``burnin.init_params(rules=)``; int8 weights: ``quantize_params(shards,
rules=)``, the whole tree's scales, whose dequantised admission tree is
this rank's shard of the whole dequantisation). MoE layers run their
experts over ``ep`` (``decode._moe_ffn``: an admission's tokens are the
same on every rank, a wave's rows are gathered over the ``ep`` line).
Speculative serving keeps the :class:`SpecState` whole on every rank:
each trip verifies this data rank's slots and all-gathers their
predictions, so the acceptance, the stop rule (finished slots counted
over all slots, as the reference counts them) and the number of trips
are the same everywhere. The reference demotes its paged kernel (K7,
K7-int8) to the gather path under ``rules``, since a ``pallas_call``
cannot take a mesh-sharded operand; here each rank's pool is a plain
local tensor, so the wave keeps K7 on the rank's heads — a difference of
mechanism, not of result. On the card the wave (and the speculative
trip) is still captured and replayed (the world of one runs no
collective).

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

The warm surface (``aot_cache``, ``models/aotcache.py``): ``run.warm()``
moves a bring-up's first-use work — the kernel library's load, each
piece's first launch, the graph captures — ahead of the first request,
and ``run.aot_registrations()`` enumerates that work piece by piece. A
warmed engine's first ``run()`` at the warmed geometry captures nothing
and serves the tokens an unwarmed engine serves.

The engine takes every keyword argument of the reference's.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..ops import _build
from ..ops.sampling import MASK32, key_data, threefry2x32
from ..parallel.collectives import gather_dim
from ..telemetry import get_registry
from .burnin import BurnInConfig, check_device, tree_leaves
from .aotcache import (
    KERNEL_LIBRARY,
    AotCompileCache,
    engine_fingerprint,
    library_key,
    warm_engine,
)
from .decode import (
    Sampler,
    _check_params,
    _data_line,
    _Replayed,
    _select_prefill_impl,
    check_cache_dtype,
    check_serve_rules,
    forward_paged,
    make_sampler,
    paged_params,
    pool_kv_heads,
)
from .hostkv import (
    ChainSpill,
    HostBlockPool,
    HostSpillCorruptError,
    IndexSpill,
)
from .paging import (
    BlockAllocator,
    PrefixIndex,
    blocks_for_rows,
    chain_chunks,
    chunk_tokens_covered,
    export_block_rows,
    import_block_rows,
    init_paged_cache,
    paged_pool_spec,
)
from .quantize import QTensor, dequantize_params
from .speculative import _ngram_draft, accept_drafts

_POLICIES = ("fifo", "sjf", "priority")
_DEFAULT_AGING = 512                   # waves; bounds starvation by default

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
                    *, paged_kernel: str = "auto", rules=None):
    """The all-slots wave step, one batched ``[slots, 1]`` ``forward_paged``
    that updates the pool in place. ``paged_kernel`` picks the read path
    (``"auto"``: the paged decode kernel on the card; ``"off"``: the gather
    reference).

    Greedy (``sampler=None``): ``(tokens [slots], active [slots] bool,
    pool) → next tokens [slots]``. Sampled: ``(tokens, active, fold
    [slots, 2], key [2], pool) → next tokens``, slot ``s`` drawn with
    ``fold_in(fold_in(key, fold[s, 0]), fold[s, 1])`` — its request and
    position — after which the step advances the active slots' positions
    in place (``fold[:, 1] += active``).

    ``rules`` (a world mesh; ``params`` are ``decode.paged_params`` of this
    rank's shards, the pool ``init_paged_cache(rules=)``'s): this data
    rank runs its own slots — the ``i``-th of ``n`` equal runs of them —
    on its heads, and the next tokens are all-gathered over the data axes,
    so every rank returns every slot's."""
    group, n, i = _data_line(rules)

    def own(x):
        """This data rank's slots of a ``[slots, ...]`` tensor."""
        m = x.shape[0] // n
        return x if group is None else x[i * m:(i + 1) * m]

    def last_logits(tokens, active, pool):
        mine = pool
        if group is not None:
            # copies of this rank's table rows and positions (a kernel's
            # operands start aligned); the advanced positions go back
            mine = dict(pool, block_tables=own(pool["block_tables"]).clone(),
                        pos=own(pool["pos"]).clone())
        logits, _ = forward_paged(params, own(tokens)[:, None], mine, cfg,
                                  rules, prefill_impl="cached",
                                  active=own(active),
                                  paged_kernel=paged_kernel)
        if mine is not pool:
            own(pool["pos"]).copy_(mine["pos"])
        return logits[:, -1]

    if sampler is None:
        def wave(tokens, active, pool):
            return gather_dim(last_logits(tokens, active, pool).argmax(
                dim=-1), group, n, 0)
        return wave

    def sampled_wave(tokens, active, fold, key, pool):
        toks = sampler.rows(last_logits(tokens, active, pool), key,
                            own(fold))
        fold[:, 1].add_(active.long())
        return gather_dim(toks, group, n, 0)

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
                   paged_kernel: str = "auto", rules=None):
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
    own ``pos`` in place.

    ``rules`` (a world mesh; ``params`` are ``decode.paged_params`` of this
    rank's shards): the state stays whole on every rank; the verification
    runs this data rank's slots (copies of their table rows and positions)
    and its argmax chains are all-gathered over the data axes, so every
    rank takes the same decisions."""
    group, n, i = _data_line(rules)

    def verify(tokens, pool, active):
        """The model's argmax chain ``[slots, k+1]`` after ``tokens``."""
        if group is None:
            logits, _ = forward_paged(params, tokens, pool, cfg, rules,
                                      prefill_impl="cached", active=active,
                                      paged_kernel=paged_kernel)
            return logits.argmax(dim=-1)
        m = tokens.shape[0] // n
        own = slice(i * m, (i + 1) * m)
        # the pool's own positions are rolled back by the trip itself
        mine = dict(pool, block_tables=pool["block_tables"][own].clone(),
                    pos=pool["pos"][own].clone())
        logits, _ = forward_paged(params, tokens[own], mine, cfg, rules,
                                  prefill_impl="cached", active=active[own],
                                  paged_kernel=paged_kernel)
        return gather_dim(logits.argmax(dim=-1), group, n, 0)

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
        new_toks, n_acc = accept_drafts(
            draft, verify(torch.cat([last, draft], 1), pool, ~frozen))
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
    - ``kv_import(req)`` → ``None`` for a normal admission, or a
      prefill→decode handoff payload (``prefill_session``'s): the engine
      allocates the request's blocks, imports the payload's rows in place
      (``paging.import_block_rows``) and decodes from the payload's first
      token at its position — no prefill here. The source keeps the
      payload until retirement (a preempted import imports again).
    - ``retired(req, tokens)``: the engine retired ``req`` after
      ``tokens`` tokens (the router's completion signal).
    - ``draining()`` → True: stop admitting, finish what is in flight (a
      planned removal).
    - ``warm_chains()`` → ``None`` for a cold start, or ``(chunks,
      payload)`` prefix chains the engine seeds into its HOST tier before
      the first admission (``HostBlockPool.adopt`` +
      ``PrefixIndex.seed_host``; needs ``share_prefix`` + ``host_spill``,
      else each chain is dropped and billed in
      ``last_stats["prefix"]["warm"]``). Read once a run.
    - ``chain_sink()`` → ``None``, or an object with ``publish(chains) →
      stored`` (a ``hostkv.WarmChainStore``) that takes the index's
      retained chains at the end of the run, before the pools are
      released.

    The built-in :class:`_Sched` implements it; ``run(admission=source)``
    takes any other (the fleet's router queues, ``models/fleet.py``).
    FAULT SEAM: the engine does not catch what these hooks raise — a
    ``candidate()`` or ``tick()`` that raises ends the run mid-wave with
    its outputs lost, as a dead process would (the fleet's fault plane
    injects replica deaths that way and redrives the requests)."""

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

    def kv_import(self, req):
        return None

    def retired(self, req, tokens: int) -> None:
        pass

    def draining(self) -> bool:
        return False

    def warm_chains(self):
        return None

    def chain_sink(self):
        return None


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

    def __init__(self, reg, share_prefix: bool, lazy_growth: bool,
                 host_spill: bool, cdn: bool = False):
        self.reg = reg
        self.enabled = reg.enabled
        self.share_prefix = share_prefix
        self.lazy_growth = lazy_growth
        self.host_spill = host_spill
        self.cdn = cdn
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
            # the host tier's: blocks spilled, swap-in time, and the share
            # of prompt blocks the host tier served
            self.g_spill = reg.gauge("prefix_spilled_blocks")
            self.g_swapms = reg.gauge("prefix_swapin_ms")
            self.g_hosthitf = reg.gauge("prefix_host_hit_frac")
            # the shared store's (shared_store): the disk tail's share of
            # prompt blocks and its swap-in time
            self.g_diskhitf = reg.gauge("prefix_disk_hit_frac")
            self.g_diskms = reg.gauge("prefix_disk_swapin_ms")
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
            if self.host_spill:
                self.g_spill.set(rstate.index.spilled_blocks)
                self.g_swapms.set(round(ps["swap_ms"], 3))
                self.g_hosthitf.set(round(ps["host_hit_blocks"]
                                          / max(ps["prompt_blocks"], 1), 4))
            if self.cdn:
                self.g_spill.set(rstate.index.spilled_blocks)
                self.g_swapms.set(round(ps["swap_ms"], 3))
                self.g_diskhitf.set(round(ps["disk_hit_blocks"]
                                          / max(ps["prompt_blocks"], 1), 4))
                self.g_diskms.set(round(ps["disk_swap_ms"], 3))
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

    def disk_swap(self, start_clk, blocks: int) -> None:
        """A ``prefix_disk_swap`` span: a chain swapped in off the shared
        store's disk tier."""
        if self.enabled:
            self.reg.emit_span("prefix_disk_swap", start_clk,
                               self.reg.clock(), blocks=blocks)

    def handoff(self, start_clk, prompt_len: int) -> None:
        """A prefill session's ``serve_prefill`` span (``handoff=True``)."""
        if self.enabled:
            self.reg.emit_span("serve_prefill", start_clk, self.reg.clock(),
                               prompt_len=prompt_len, handoff=True)

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
                      paged_kernel: str = "auto", host_spill: bool = False,
                      host_blocks: int | None = None,
                      host_swap: str = "async", shared_store=None,
                      telemetry=None, aot_cache=None, device="cuda"):
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
    ``latency_ms`` (admission → retirement, host clock), ``retired_ms``
    (the call's start → retirement, host clock), ``flash_prefills`` (the
    prefills through flash attention: K1 once a layer each on the card),
    ``kv_imports`` and ``import_ms`` (handoff admissions and their device
    ms on the card, else None), ``kv`` (allocator
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

    ``host_spill`` (needs ``share_prefix``) turns on the tiered KV cache:
    the index's evictions spill into a host block pool of ``host_blocks``
    blocks (default ``max(4·prefix_keep_blocks, 64)``; built once here,
    pinned on the card, holding the run's KV heads) and a later hit swaps
    the rows back in, crc-verified. ``host_swap="async"`` (default) stages
    the next queued request's spilled rows while the wave runs;
    ``"sync"`` loads them at its admission. The tier is a cache: tokens
    equal the engine's without it. ``last_stats["prefix"]["spill"]``
    carries the spill, host-hit and swap-in counts and ``swap_ms`` (host
    clock).

    ``shared_store`` (a ``hostkv.WarmChainStore``; with ``share_prefix``,
    without ``host_spill``) mounts the fleet-shared prefix CDN in place of
    a private host tier; ``last_stats["prefix"]["cdn"]`` carries the
    blocks it served, the disk tail's share and its swap ms, and the
    store's ledger. ``run(admission=)``'s ``warm_chains()`` seed the host
    tier before the first admission and its ``chain_sink()`` takes the
    retained chains at close (``last_stats["prefix"]["warm"]``).

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
    runs the same work either way.

    ``aot_cache`` (a ``models/aotcache.AotCompileCache``, or its directory
    as a string) is attached as ``run.aot_cache`` and activated at build:
    process-wide and sticky, the kernel library's build installs from it
    and banks into it. ``run.warm(slots=, kv_blocks=, prompt_lens=,
    n_new=)`` warms the engine at that geometry against it
    (``aotcache.warm_engine``: hits, misses and ``warm_ms``; a no-op
    without a cache); ``run.aot_registrations`` lists the pieces,
    ``run.aot_prime`` drives the priming schedule and ``run.aot_scope`` is
    the key scope (computed with or without a cache)."""
    reg = telemetry if telemetry is not None else get_registry()
    tel = _ServeTelemetry(reg, share_prefix, lazy_growth, host_spill,
                          shared_store is not None)
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
    if host_swap not in ("async", "sync"):
        raise ValueError(
            f"unknown host_swap {host_swap!r}: use async|sync")
    if host_blocks is not None and host_blocks < 1:
        raise ValueError(f"host_blocks must be >= 1, got {host_blocks}")
    if host_spill and not share_prefix:
        raise ValueError(
            "host_spill is the prefix index's second tier — enable "
            "share_prefix=True alongside it (there is nothing to spill "
            "without an index)")
    if shared_store is not None:
        if host_spill:
            raise ValueError(
                "shared_store replaces the private host tier — a "
                "replica cannot spill both to its own HostBlockPool "
                "and to the fleet CDN; drop host_spill")
        if not share_prefix:
            raise ValueError(
                "shared_store is the prefix index's CDN tier — enable "
                "share_prefix=True alongside it (there is nothing to "
                "publish without an index)")
    if host_blocks is None:
        # the tier exists because the working set dwarfs the device cap
        host_blocks = max(4 * prefix_keep_blocks, 64)
    quant = check_cache_dtype(cache_dtype)
    geom = paged_pool_spec(cfg, max_len, kv_block, cache_dtype)
    bs, nt = kv_block, geom["tables"]
    pool_keys = ("k", "v") + (("k_scale", "v_scale") if quant else ())

    def steps_for(tree, rules=None) -> dict:
        """The wave step and the speculative trip over ``tree``."""
        return {"step": make_serve_step(tree, cfg, sampler,
                                        paged_kernel=paged_kernel,
                                        rules=rules),
                "trip": None if spec_k is None else make_spec_step(
                    tree, cfg, spec_k, paged_kernel=paged_kernel,
                    rules=rules)}

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

    # the warm cache (models/aotcache.py): a string is its directory (the
    # form a process transport ships). Activation is sticky by design: a
    # fleet child puts the shared directory behind its kernel build once.
    if isinstance(aot_cache, str):
        aot_cache = AotCompileCache(aot_cache, telemetry=reg)
    if aot_cache is not None:
        aot_cache.activate()
    # the cache SCOPE, from the reference's levers (computed without a
    # cache too, so warm_engine(engine, cache) can warm any engine); the
    # sampler by its parameters, never a repr carrying an address
    sampler_fp = "none" if sampler is None else (
        f"spec(temperature={sampler.temperature!r},top_k={sampler.top_k!r},"
        f"top_p={sampler.top_p!r})")
    aot_scope = engine_fingerprint(cfg, max_len, dict(
        cache_dtype=cache_dtype, sampler=sampler_fp,
        prefill_chunk=prefill_chunk, spec_k=spec_k, kv_block=kv_block,
        policy=policy, aging=aging, share_prefix=share_prefix,
        lazy_growth=lazy_growth, prefix_keep_blocks=prefix_keep_blocks,
        paged_kernel=paged_kernel, host_spill=host_spill,
        host_blocks=host_blocks, host_swap=host_swap,
        # the CDN lever as a boolean: the store's repr carries an address
        shared_store=shared_store is not None,
        prefix_len=prefix_len,
        quant_weights=prefill_params is not params), device=dev)

    # one pool and its wave (on the card captured) per (slots, kv_blocks,
    # rules)
    pools: dict[tuple, tuple[dict, Any]] = {}
    # the host tier's pool, one per KV-head count a run's rules give: built
    # here for the unsharded run (an oversized host_blocks fails now, not
    # mid-serving), reset at each run
    host_pools: dict[int, HostBlockPool] = {}
    if host_spill:
        host_pools[pool_kv_heads(cfg)] = HostBlockPool(
            cfg, host_blocks, block_size=bs, cache_dtype=cache_dtype,
            device=dev)

    def host_pool_for(rules, device) -> HostBlockPool:
        heads = pool_kv_heads(cfg, rules)
        if heads not in host_pools:
            host_pools[heads] = HostBlockPool(
                cfg, host_blocks, block_size=bs, cache_dtype=cache_dtype,
                rules=rules, device=device)
        return host_pools[heads]
    # the run's sharding: its rules, the trees its admissions and its wave
    # run from (this rank's shards under rules), its wave step and trip
    unsharded = {"rules": None, "prefill": prefill_params,
                 **steps_for(params)}
    cur: dict[str, Any] = dict(unsharded)
    step = unsharded["step"]
    sharded: dict[int, dict] = {}

    def use_rules(rules) -> None:
        """Point the run at ``rules`` (None: unsharded), building the
        sharded trees, wave step and trip once per rules object."""
        if rules is None:
            cur.update(unsharded)
            return
        if id(rules) not in sharded:
            tree = paged_params(params, cfg, rules)
            sharded[id(rules)] = {
                "rules": rules,
                "prefill": (tree if prefill_params is params else
                            paged_params(prefill_params, cfg, rules)),
                **steps_for(tree, rules)}
        cur.update(sharded[id(rules)])

    def capture(pool: dict, on_card: bool = True):
        """The engine's wave (the speculative trip under ``spec_k``) over
        ``pool``: a :class:`WaveGraph` or :class:`SpecGraph`, captured on
        the card — what a run replays, for timing it alone."""
        if spec_k is not None:
            return SpecGraph(cur["trip"], pool, spec_width, capture=on_card)
        return WaveGraph(cur["step"], pool, sampled=sampler is not None,
                         capture=on_card)

    def pool_for(slots: int, kv_blocks: int):
        """The run's pool, zeroed as a fresh one would be, and its wave."""
        rules = cur["rules"]
        key = (slots, kv_blocks, None if rules is None else id(rules))
        if key not in pools:
            pool = init_paged_cache(cfg, slots, max_len, block_size=bs,
                                    num_blocks=kv_blocks, rules=rules,
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
        logits, _ = forward_paged(cur["prefill"], prompt[None],
                                  slot_view(pool, slot), cfg, cur["rules"],
                                  prefill_impl=impl, paged_kernel="off",
                                  replicated=True)
        return logits[0, -1]

    pick = _make_pick(sampler)

    def pick_first(logits_row, req: int, rng):
        """An admission's first token from its last prompt position's
        logits, keyed at (request, position 0)."""
        key = None if sampler is None else to_device(
            _request_key(rng, req, 0), torch.long)
        return pick(logits_row, key)

    def admit_imported(rstate, slot: int, req: int, length: int, payload):
        """An admission from a prefill→decode handoff payload (another
        engine's ``prefill_session``): the full block grant, the table with
        the position at the payload's length, and the payload's rows
        imported in place into the first ``ceil(length / kv_block)``
        blocks — no prefill. Returns ``(first token, entries)``, or None
        when the blocks do not fit (hold; the source keeps the payload)."""
        if prefix is not None:
            raise ValueError(
                "imported admissions need an engine without a template "
                "prefix= — the payload's rows start at position 0")
        if sampler is not None:
            raise ValueError(
                "imported admissions are greedy-only: the handoff "
                "payload's first token was picked by the (greedy) "
                "prefill worker")
        if int(payload["n_tokens"]) != length:
            raise ValueError(
                f"handoff payload covers {payload['n_tokens']} tokens "
                f"for a {length}-token prompt — foreign payload?")
        got = rstate.admit_blocks(req, length, share=False)
        if got is None:
            return None
        row, tail, _start, _cov, entries = got
        first = torch.as_tensor(payload["first"])
        ready = payload.get("ready")
        timed = None
        if dev.type == "cuda":
            here = torch.cuda.current_stream(dev)
            if ready is not None:
                # the exporting worker's stream wrote the rows and the
                # token: this stream waits for them, and the allocator
                # keeps their memory until this stream's reads are done
                here.wait_event(ready)
            for buf in [first, *(b for bufs in payload["blocks"].values()
                                 for b in bufs)]:
                if buf.is_cuda:
                    buf.record_stream(here)
            timed = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
            timed[0].record(here)
        admit_table(rstate.pool, slot, row, tail, length)
        nb = blocks_for_rows(length, bs)
        import_block_rows(rstate.pool, rstate.owned[req][:nb],
                          payload["blocks"])
        rstate.n_imports += 1
        if timed is not None:
            timed[1].record(here)
            rstate.imports.append(timed)
        return (first.to(dev, non_blocking=True) if first.device != dev
                else first), entries

    @torch.no_grad()
    def chunk_step(pool, slot: int, chunk):
        """One ``[1, C]`` prefill chunk at the slot's position. Pad rows of
        the final chunk land in the cache but stay unreachable: the mask
        hides keys past a query, and ``pos`` rewinds to the true length."""
        logits, _ = forward_paged(cur["prefill"], chunk,
                                  slot_view(pool, slot), cfg, cur["rules"],
                                  prefill_impl="cached", paged_kernel="off",
                                  replicated=True)
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
            self.pool, self.graph = pool_for(slots, kv_blocks)
            # the tiered index: evictions spill into the host pool
            self.host = spill = None
            self.store = shared_store
            if host_spill:
                self.host = host_pool_for(cur["rules"],
                                          self.pool["k"][0].device)
                self.host.reset()
                spill = IndexSpill(self.host, lambda: self.pool)
            elif self.store is not None:
                # the fleet-shared CDN: evictions hand whole root→leaf
                # chains to the store (no host-tier entries); a later hit
                # comes back at admission (_cdn_swap_in)
                spill = ChainSpill(self.store, lambda: self.pool)
            self.index = (PrefixIndex(self.alloc, prefix_keep_blocks,
                                      spill=spill)
                          if share_prefix else None)
            # the async swap-in's staging: at most one prefetched chain,
            # keyed by its exact (key, host id) tail, so a chain that moved
            # under the prefetch falls back to the synchronous load
            self._staged_sig: tuple | None = None
            self._staged_fut = None
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
            # the call's start (every arrival's origin) and each
            # retirement's ms from it; the prefills run through flash
            # attention (K1 once a layer each on the card); the handoff
            # imports and, on the card, their (start, end) events
            self.t0 = time.monotonic()
            self.retired_ms: list[float] = []
            self.flash_prefills = 0
            self.imports: list = []
            self.n_imports = 0
            self.prefix_stats = {"hit_blocks": 0, "lookups": 0,
                                 "prompt_blocks": 0, "tokens_saved": 0,
                                 "reclaim_blocked_live": 0,
                                 "reclaim_blocked_empty": 0,
                                 # the host tier: blocks served from it,
                                 # the swap-ins, their blocks and host
                                 # time, the prefill tokens they saved,
                                 # and the chains dropped for a bad crc
                                 "host_hit_blocks": 0, "swapins": 0,
                                 "swapped_blocks": 0, "swap_ms": 0.0,
                                 "swap_tokens_saved": 0,
                                 "corrupt_dropped": 0,
                                 # warm bring-up: chains seeded into the
                                 # host tier, seeds refused, and chains
                                 # published to a drain sink at close
                                 "warm_chains": 0, "warm_blocks": 0,
                                 "warm_dropped": 0, "published_chains": 0,
                                 # the shared store: blocks swapped in from
                                 # it, those off its disk tail, and their
                                 # host time
                                 "cdn_hit_blocks": 0, "disk_hit_blocks": 0,
                                 "disk_swap_ms": 0.0}
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
                forward_paged(cur["prefill"], prefix[None], sub, cfg,
                              cur["rules"], prefill_impl=prefix_impl,
                              paged_kernel="off", replicated=True)
                self.flash_prefills += prefix_impl == "flash"

        def _chunks_for(self, req: int, length: int) -> list:
            """The prompt's candidate chain chunks; at least one prompt
            token stays to forward (its logits pick the first token)."""
            chunks = chain_chunks(self.host_toks[req], bs, tail_rows)
            while chunks and chunk_tokens_covered(
                    len(chunks), bs, tail_rows) > length - 1:
                chunks.pop()
            return chunks

        def admit_blocks(self, req: int, length: int, *, share: bool = True):
            """Allocate the request's blocks, sharing indexed full leading
            prompt blocks first (refcount++, read-only for this request);
            None = hold in queue. Returns ``(row, tail, start, covered,
            entries)``: the table row, the prefix tail copy ``(src, dst)``
            or None, the prefill start position, the prompt tokens the
            shared blocks cover, and the table entries granted.
            ``share=False`` leaves the index out (an imported admission's
            rows arrive as bytes, not as tokens this engine hashed)."""
            shared: list[int] = []
            cov = n_chunks = dev_k = 0
            if share and self.index is not None:
                chunks = self._chunks_for(req, length)
                n_chunks = len(chunks)
                if self.host is not None:
                    # the device-resident prefix is shared like any match;
                    # a spilled continuation swaps back in, extending the
                    # hit (or stays host-side when the pool cannot spare
                    # the blocks)
                    shared, tail = self.index.match_tiered(chunks)
                    dev_k = len(shared)
                    if tail:
                        shared = shared + self._swap_in(tail)
                else:
                    shared = self.index.match(chunks)
                    dev_k = len(shared)
                    if self.store is not None and dev_k < n_chunks:
                        # the shared store (its disk tail behind it) may
                        # hold the rest of the chain: swap it in and
                        # register it, so the next admission hits it here
                        shared = shared + self._cdn_swap_in(chunks, dev_k,
                                                            shared)
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
            if share and self.index is not None:
                ps = self.prefix_stats
                ps["lookups"] += 1
                ps["prompt_blocks"] += n_chunks
                ps["hit_blocks"] += k
                ps["tokens_saved"] += cov
                if k > dev_k:
                    # hits the device cap alone would have missed, and the
                    # prefill tokens the host tier saved past the device
                    # prefix
                    ps["host_hit_blocks"] += k - dev_k
                    ps["swap_tokens_saved"] += cov - chunk_tokens_covered(
                        dev_k, bs, tail_rows)
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

        def _swap_in(self, tail: list) -> list[int]:
            """Swap a spilled chain continuation back to the device tier:
            grant fresh blocks, import the host rows in place (the staged
            payload when the prefetch named this chain, else a synchronous
            crc-verified load — the same bytes either way) and promote the
            entries. Returns the blocks, carrying this request's reference
            like matched ones; ``[]`` when the pool cannot spare them (the
            chain stays host-side) or the rows failed their crc (the chain
            is dropped and the request prefills from tokens)."""
            keys = [key for key, _hid in tail]
            blocks = self._alloc_reclaiming(len(tail))
            if blocks is None:
                return []
            staged = None
            if self._staged_sig == tuple(tail) and \
                    self._staged_fut is not None:
                # consume the prefetch; one for another chain stays staged
                # for the admission it belongs to
                staged = self._staged_fut
                self._staged_sig, self._staged_fut = None, None
            t0 = time.monotonic()
            try:
                payload = (staged.result() if staged is not None
                           else self.host.load([h for _k, h in tail],
                                               device=self.host.device))
            except HostSpillCorruptError:
                self.alloc.free(blocks)
                self.index.discard(keys[0])       # quarantine the chain
                self.prefix_stats["corrupt_dropped"] += 1
                return []
            import_block_rows(self.pool, blocks, payload)
            self.index.promote(keys, blocks)
            ps = self.prefix_stats
            ps["swapins"] += 1
            ps["swapped_blocks"] += len(blocks)
            ps["swap_ms"] += (time.monotonic() - t0) * 1e3
            return blocks

        def _cdn_swap_in(self, chunks: list, dev_k: int,
                         shared: list[int]) -> list[int]:
            """Swap a chain continuation in from the shared store: fetch
            its crc-verified rows (RAM, or the disk tail's verified frame —
            the store promotes disk hits itself), grant fresh blocks,
            import the rows in place and ``register`` the chain (the index
            then holds one reference past this request, as a host-tier
            swap-in's ``promote`` leaves it). Returns the blocks, carrying
            this request's reference; ``[]`` on a miss, a corrupt drop or a
            dry pool (the request prefills from tokens)."""
            t0 = time.monotonic()
            clk0 = tel.clock()
            got = self.store.fetch(chunks, start=dev_k)
            if got is None:
                return []
            n, payload, from_disk = got
            blocks = self._alloc_reclaiming(n)
            if blocks is None:
                return []
            import_block_rows(self.pool, blocks, payload)
            self.index.register(chunks[:dev_k + n], shared + blocks)
            ms = (time.monotonic() - t0) * 1e3
            ps = self.prefix_stats
            ps["swapins"] += 1
            ps["swapped_blocks"] += n
            ps["swap_ms"] += ms
            ps["cdn_hit_blocks"] += n
            if from_disk:
                ps["disk_hit_blocks"] += n
                ps["disk_swap_ms"] += ms
                tel.disk_swap(clk0, n)
            return blocks

        def prefetch_swap(self, req: int, length: int) -> None:
            """The double buffer (``host_swap="async"``): probe the next
            admission's spilled continuation read-only and stage its rows
            on the host pool's worker, so the verification and the copy to
            the card overlap this wave."""
            if self.host is None or self.index is None:
                return
            tail = self.index.peek_host_tail(self._chunks_for(req, length))
            if not tail or self._staged_sig == tuple(tail):
                return
            self._staged_fut = self.host.stage([h for _k, h in tail])
            self._staged_sig = tuple(tail)

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

        def seed_warm(self, chains) -> None:
            """Warm bring-up: adopt ``(chunks, payload)`` chains into the
            HOST tier and index them (``PrefixIndex.seed_host``) before the
            first admission. A chain the host pool cannot hold (or an
            engine with no host tier) is dropped and billed; seeded rows
            swap in through the crc-verified tiered path like spilled
            ones."""
            ps = self.prefix_stats
            for chunks, payload in chains:
                if self.host is None or self.index is None:
                    ps["warm_dropped"] += 1
                    continue
                hids = self.host.adopt(payload)
                if hids is None:
                    ps["warm_dropped"] += 1
                    continue
                ps["warm_blocks"] += self.index.seed_host(
                    [tuple(c) for c in chunks], hids)
                ps["warm_chains"] += 1

        def publish_chains(self, sink) -> None:
            """The close-time publish: every retained indexed chain (device
            rows exported from the live pool, host rows loaded
            crc-verified) into ``sink`` (``publish(chains) → stored``).
            Read-only against the index: no reference moves and no
            eviction is billed; a chain whose host rows fail their crc is
            left out (``corrupt_dropped``)."""
            if self.index is None:
                return
            chains = []
            for chunks, ids in self.index.export_chains():
                dev_ids = [b for t, b in ids if t == "dev"]
                host_ids = [b for t, b in ids if t == "host"]
                parts = []
                if dev_ids:
                    parts.append(export_block_rows(self.pool, dev_ids))
                if host_ids:
                    try:
                        parts.append(self.host.load(host_ids,
                                                    device=self.host.device))
                    except HostSpillCorruptError:
                        self.prefix_stats["corrupt_dropped"] += 1
                        continue
                if not parts:
                    continue
                payload = parts[0] if len(parts) == 1 else {
                    k: [torch.cat([a, b]) for a, b in zip(parts[0][k],
                                                          parts[1][k])]
                    for k in parts[0]}
                chains.append((chunks, payload))
            if chains:
                self.prefix_stats["published_chains"] += sink.publish(chains)

        def close(self, sink=None) -> None:
            """End of run: the retained chains go to the drain ``sink``
            when one is wired (before the release tears the tiers down);
            the index's retained blocks and host copies go back, so both
            pools drain (the device pool to its prefix blocks), and the
            swap worker shuts down."""
            if sink is not None and self.index is not None:
                self.publish_chains(sink)
            if self.index is not None:
                self.index.release()
            self._staged_sig, self._staged_fut = None, None
            if self.host is not None:
                self.host.close()

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

        def retired(self) -> None:
            self.retired_ms.append((time.monotonic() - self.t0) * 1e3)

        def run_stats(self) -> dict:
            """The call's own records: call start → retirement ms
            (arrival → completion when every request arrives at the
            start), the flash prefills, and the handoff imports with
            their device ms (None off the card)."""
            done = sorted(self.retired_ms)

            def q(p):
                return (round(done[min(len(done) - 1, int(p * len(done)))],
                              3) if done else None)

            import_ms = None
            if self.imports:
                self.imports[-1][1].synchronize()
                import_ms = round(sum(a.elapsed_time(b)
                                      for a, b in self.imports), 3)
            return {"retired_ms": {"p50": q(0.5), "p99": q(0.99),
                                   "max": (round(done[-1], 3) if done
                                           else None)},
                    "flash_prefills": self.flash_prefills,
                    "kv_imports": self.n_imports, "import_ms": import_ms}

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
            idx, host = self.index, self.host
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
                "spill": {
                    "enabled": host is not None,
                    "host_blocks": (host.host_blocks if host is not None
                                    else 0),
                    "spilled_blocks": (idx.spilled_blocks if idx is not None
                                       else 0),
                    "spill_dropped": (idx.spill_dropped if idx is not None
                                      else 0),
                    "host_hit_blocks": ps["host_hit_blocks"],
                    "host_hit_frac": round(ps["host_hit_blocks"]
                                           / max(ps["prompt_blocks"], 1),
                                           4),
                    "swapins": ps["swapins"],
                    "swapped_blocks": ps["swapped_blocks"],
                    "swap_ms": round(ps["swap_ms"], 3),
                    "swap_tokens_saved": ps["swap_tokens_saved"],
                    "corrupt_dropped": ps["corrupt_dropped"],
                    "host_in_use": host.in_use if host is not None else 0,
                    "host_high_water": (host.high_water if host is not None
                                        else 0),
                },
                # the shared store: blocks it served, the disk tail's
                # share, and the store's own ledger
                "cdn": {
                    "enabled": self.store is not None,
                    "hit_blocks": ps["cdn_hit_blocks"],
                    "disk_hit_blocks": ps["disk_hit_blocks"],
                    "disk_hit_frac": round(ps["disk_hit_blocks"]
                                           / max(ps["prompt_blocks"], 1),
                                           4),
                    "disk_swap_ms": round(ps["disk_swap_ms"], 3),
                    "store": (self.store.stats() if self.store is not None
                              else None),
                },
                # warm bring-up (zeros outside a scale event)
                "warm": {
                    "seeded_chains": ps["warm_chains"],
                    "seeded_blocks": ps["warm_blocks"],
                    "seed_dropped": ps["warm_dropped"],
                    "published_chains": ps["published_chains"],
                },
            }

    def empty_stats() -> dict:
        return {"requests": 0, "generated": 0, "waves": 0,
                "latency_ms": {"p50": None, "p99": None, "max": None},
                "retired_ms": {"p50": None, "p99": None, "max": None},
                "flash_prefills": 0, "kv_imports": 0, "import_ms": None,
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
                           "reclaim_blocked": {"live": 0, "empty": 0},
                           "spill": {"enabled": host_spill,
                                     "host_blocks": (host_blocks
                                                     if host_spill else 0),
                                     "spilled_blocks": 0,
                                     "spill_dropped": 0,
                                     "host_hit_blocks": 0,
                                     "host_hit_frac": 0.0,
                                     "swapins": 0, "swapped_blocks": 0,
                                     "swap_ms": 0.0,
                                     "swap_tokens_saved": 0,
                                     "corrupt_dropped": 0,
                                     "host_in_use": 0,
                                     "host_high_water": 0},
                           "cdn": {"enabled": shared_store is not None,
                                   "hit_blocks": 0, "disk_hit_blocks": 0,
                                   "disk_hit_frac": 0.0,
                                   "disk_swap_ms": 0.0,
                                   "store": (shared_store.stats()
                                             if shared_store is not None
                                             else None)},
                           "warm": {"seeded_chains": 0, "seeded_blocks": 0,
                                    "seed_dropped": 0,
                                    "published_chains": 0}}}

    def prefetch_next(rstate, sched, lens) -> None:
        """Between admission and the wave: stage the next queued request's
        spilled rows (async swaps only; the scheduler's ``candidate()`` and
        the index's probe are read-only)."""
        if not host_spill or host_swap != "async" or sched.exhausted():
            return
        req = sched.candidate()
        if req is not None:
            rstate.prefetch_swap(req, lens[req])

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
            rstate.flash_prefills += impl == "flash"
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
            rstate.retired()
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
            prefetch_next(rstate, sched, lens)
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
            **rstate.run_stats(),
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
            static_batching: bool = False, priorities=None, rules=None,
            admission: AdmissionSource | None = None):
        check_serve_rules(rules, cfg)
        run.last_stats = None
        tel.start()
        if admission is not None:
            # an injected source owns order, timing and the imports: the
            # knobs that overlap it must be absent, not ignored
            if arrivals is not None:
                raise ValueError(
                    "admission= owns arrival gating — drop arrivals")
            if static_batching:
                raise ValueError(
                    "admission= replaces the engine's scheduler; "
                    "static_batching configures the built-in one")
            if priorities is not None:
                raise ValueError(
                    "admission= replaces the engine's policy order; "
                    "priorities configure the built-in one")
            if spec_k is not None:
                raise ValueError(
                    "external admission drives the plain wave loop "
                    "only — drop spec_k")
        if not prompts:
            run.last_stats = empty_stats()
            return {} if admission is not None else []
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
        data_shards = _data_line(rules)[1]
        if slots % data_shards:
            # the wave batch IS the data-parallel dim at serve time
            raise ValueError(
                f"slots ({slots}) must divide over the data axes "
                f"({data_shards} shards) — pad the pool")
        if static_batching and spec_k is not None:
            raise ValueError(
                "static_batching is the plain loop's run-to-completion "
                "A/B baseline — drop spec_k to use it")
        toks = [t.to(dev) for t in flat]
        if shared_store is not None and rules is not None \
                and pool_kv_heads(cfg, rules) != pool_kv_heads(cfg):
            raise ValueError(
                "shared_store holds every KV head; a run whose rules "
                "split the pool's heads cannot publish into it")
        use_rules(rules)
        rstate = _Run(slots, kv_blocks, n_new_of, lens,
                      [t.tolist() for t in flat] if share_prefix else None)
        sched = admission if admission is not None else _Sched(
            lens, n_new_of, policy, aging, priorities, arrivals,
            time.monotonic())
        if admission is not None:
            # warm bring-up chains seed the host tier before any admission
            # (the hooks through getattr: a minimal source stays valid)
            warm = getattr(sched, "warm_chains", lambda: None)()
            if warm:
                rstate.seed_warm(warm)
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
            rstate.retired()
            tel.retire(req, ntok, steps)
            set_fold(span[req][0], None)
            sched.retired(req, ntok)

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
            # the drain hook: no new admissions, the active slots step on
            admit_ok = admit_ok and not sched.draining()
            for slot in range(slots):
                if not admit_ok or slot in active or slot in filling \
                        or slot in stalled:
                    continue
                req = sched.candidate()
                if req is None:
                    break                 # empty, or nothing arrived yet
                length = lens[req]
                payload = sched.kv_import(req)
                if payload is not None:
                    # a prefill→decode handoff: import, no prefill here
                    got = admit_imported(rstate, slot, req, length, payload)
                    if got is None:
                        break             # blocks exhausted: hold
                    sched.pop(req)
                    admitted_at[req] = time.monotonic()
                    tel.admit(req, sched)
                    activate(slot, req, *got)
                    continue
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
                    rstate.flash_prefills += impl == "flash"
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
            prefetch_next(rstate, sched, lens)
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
                    # graftlint: ignore[graft-host-sync-in-loop] — exact eos
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
                    # graftlint: ignore[graft-host-sync-in-loop] — amortised
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
        rstate.close(sink=(getattr(sched, "chain_sink", lambda: None)()
                           if admission is not None else None))
        tel.gauges(rstate, None, 0)

        waves = torch.stack(hist) if hist else None      # [W, slots]
        # an injected source's run serves only what it yielded: a dict
        # keyed by request (the router merges its replicas')
        outs: dict[int, Any] = {}
        for req in sorted(done_at):
            n, (slot, sw) = done_at[req], span[req]
            head = firsts[req].reshape(1)
            if n == 1:
                outs[req] = head
            elif req in frag:
                idx = torch.tensor(frag[req][:n - 1], device=dev)
                outs[req] = torch.cat([head, waves[idx, slot]])
            else:
                # the n - 1 waves while req held its slot: one emission each
                outs[req] = torch.cat([head, waves[sw:sw + n - 1, slot]])
        if eos_id is not None and eos_check_every > 1:
            # a count-cap retirement can precede the scan that would have
            # seen an eos (and a first-token eos is never scanned): cut at
            # the first eos, as the per-wave check would have
            for i, o in outs.items():
                vals = o.tolist()
                n = next((j + 1 for j, t in enumerate(vals) if t == eos_id),
                         len(vals))
                outs[i] = o[:n]
        lat = sorted(latencies)

        def q(p):
            return (round(lat[min(len(lat) - 1, int(p * len(lat)))], 3)
                    if lat else None)

        run.last_stats = {
            "requests": len(outs),
            "generated": sum(int(o.shape[0]) for o in outs.values()),
            "waves": len(hist),
            "latency_ms": {"p50": q(0.5), "p99": q(0.99),
                           "max": round(lat[-1], 3) if lat else None},
            **rstate.run_stats(),
            "kv": rstate.kv_stats(),
            "sched": rstate.sched_stats(),
            "prefix": rstate.prefix_summary(),
        }
        if admission is not None:
            return outs
        return [outs[i] for i in range(len(toks))]

    class _PrefillSession:
        """A prefill worker's state for the disaggregated fleet
        (``models/fleet.py``): a one-slot paged pool that prefills one
        prompt a call and exports its blocks as a handoff payload
        (``paging.export_block_rows``) for a decode engine's ``kv_import``
        admission. Under ``share_prefix`` its index keeps template blocks
        across calls (up to ``prefix_keep_blocks``), so a repeated template
        prefills once a worker."""

        def __init__(self, kv_blocks: int | None):
            if kv_blocks is None:
                kv_blocks = 1 + nt + (prefix_keep_blocks if share_prefix
                                      else 0)
            if kv_blocks < 1 + nt:
                raise ValueError(
                    f"prefill session needs >= {1 + nt} blocks (one full "
                    f"table + the garbage block), got {kv_blocks}")
            self.alloc = BlockAllocator(kv_blocks)
            self.index = (PrefixIndex(self.alloc, prefix_keep_blocks)
                          if share_prefix else None)
            self.pool = init_paged_cache(cfg, 1, max_len, block_size=bs,
                                         num_blocks=kv_blocks,
                                         cache_dtype=cache_dtype, device=dev)
            self.stats = {"requests": 0, "hit_blocks": 0,
                          "prompt_blocks": 0, "tokens_saved": 0,
                          "flash_prefills": 0}
            self._exports: list = []      # (start, ready) on the card

        def _alloc_reclaiming(self, n: int) -> list[int]:
            blocks = self.alloc.alloc(n)
            while blocks is None and self.index is not None:
                if not self.index.reclaim(n - self.alloc.free_blocks):
                    break
                blocks = self.alloc.alloc(n)
            if blocks is None:
                # sized for a full table, so only a caller-shrunk pool gets
                # here: loud, there is no queue to hold in
                raise ValueError(
                    f"prefill session pool exhausted allocating {n} "
                    f"blocks — raise its kv_blocks")
            return blocks

        @torch.no_grad()
        def prefill(self, prompt) -> dict:
            """Prefill ``prompt`` (``[L]`` tokens) and return the handoff
            payload ``{"first", "n_tokens", "blocks"}`` — the whole blocks
            over rows ``0..L-1`` and the greedy first token — plus, on the
            card, ``"ready"``: an event on this thread's stream after the
            export, which the importer's stream waits on. The math of a
            colocated admission (the same prefill choice, the same
            unshared-suffix start), so the importer continues exactly."""
            prompt = torch.as_tensor(prompt).long().reshape(-1)
            length = int(prompt.shape[0])
            if length < 1:
                raise ValueError("prompts must have at least one token")
            if length >= max_len:
                raise ValueError(
                    f"prompt ({length}) must leave room for at least one "
                    f"generated token under max_len ({max_len})")
            shared: list[int] = []
            cov = 0
            chunks: list = []
            if self.index is not None:
                chunks = chain_chunks(prompt.tolist(), bs)
                # one prompt token stays to forward: its logits pick the
                # first generated token
                while chunks and chunk_tokens_covered(
                        len(chunks), bs) > length - 1:
                    chunks.pop()
                shared = self.index.match(chunks)
                cov = chunk_tokens_covered(len(shared), bs)
            k = len(shared)
            own = self._alloc_reclaiming(blocks_for_rows(length - k * bs,
                                                         bs))
            row = np.zeros((nt,), np.int32)
            row[:k] = shared
            row[k:k + len(own)] = own
            impl = ("cached" if cov
                    else _select_prefill_impl(cfg, length, "auto", dev))
            clk0 = tel.clock()
            first = admit_full(self.pool, 0, prompt.to(dev)[cov:], impl, row,
                               None, cov).argmax(dim=-1)
            self.stats["flash_prefills"] += impl == "flash"
            if self.index is not None:
                self.index.register(
                    chunks, [int(row[j]) for j in range(len(chunks))])
                self.stats["hit_blocks"] += k
                self.stats["prompt_blocks"] += len(chunks)
                self.stats["tokens_saved"] += cov
            self.stats["requests"] += 1
            tel.handoff(clk0, length)
            nb = blocks_for_rows(length, bs)
            if dev.type == "cuda":
                here = torch.cuda.current_stream(dev)
                start = torch.cuda.Event(enable_timing=True)
                start.record(here)
            payload = {"first": first, "n_tokens": length,
                       "blocks": export_block_rows(
                           self.pool, [int(row[j]) for j in range(nb)])}
            if dev.type == "cuda":
                payload["ready"] = torch.cuda.Event(enable_timing=True)
                payload["ready"].record(here)
                self._exports.append((start, payload["ready"]))
            # this request's references drop; registered template blocks
            # stay through the index's own (LRU capped)
            self.alloc.free(shared + own)
            if self.index is not None:
                self.index.trim()
            return payload

        def export_ms(self) -> float | None:
            """Device ms of this session's exports, summed (None off the
            card)."""
            if not self._exports:
                return None
            self._exports[-1][1].synchronize()
            return round(sum(a.elapsed_time(b) for a, b in self._exports),
                         3)

        def close(self) -> None:
            if self.index is not None:
                self.index.release()

    def prefill_session(*, kv_blocks: int | None = None):
        """Open a prefill-worker session (:class:`_PrefillSession`): greedy
        engines without ``prefix``, ``prefill_chunk``, ``spec_k`` or
        ``host_spill`` — the payload carries one greedy first token and
        device rows from position 0. It prefills through the unsharded
        tree, with the colocated admission's prefill choice (K1 on the
        card)."""
        if sampler is not None:
            raise ValueError("prefill sessions are greedy-only — the "
                             "payload's first token has no rng lane")
        if spec_k is not None:
            raise ValueError("prefill sessions prefill and hand off — "
                             "spec_k belongs to the decode engine")
        if prefix is not None:
            raise ValueError("prefill sessions need prefix=None: the "
                             "payload's rows must start at position 0")
        if prefill_chunk is not None:
            raise ValueError(
                "prefill sessions use the one-forward prefill — "
                "prefill_chunk's interleaving needs the wave loop; build "
                "the prefill-worker engine without it")
        if host_spill:
            # a payload exports DEVICE rows; a spilled chain's bytes live on
            # the host, so its donation would export whatever now sits in
            # the recycled device blocks
            raise ValueError(
                "prefill sessions hand off device-resident blocks — a "
                "host-spilled chain has no device rows to export, so "
                "host_spill does not compose with kv_import donation; "
                "build the prefill-worker engine without host_spill "
                "(decode-side engines may still spill)")
        use_rules(None)
        return _PrefillSession(kv_blocks)

    # ------------------------------------------------ the warm surface
    # (models/aotcache.py): the engine's first-use work, enumerable as
    # (name, fn, example args) so warm_engine can do it ahead of the first
    # request. Nothing below runs unless something calls it: an unwarmed
    # engine is the engine as it was.

    def aot_registrations(*, slots: int = 4, kv_blocks=None, prompt_lens=(),
                          n_new: int = 2):
        """The engine's warm family at a serving geometry, under the
        reference's names and conditions, plus ``kernel_library`` on the
        card (its args: the library's key and the sources' digest). The
        example args are the pieces' abstract signatures (meta tensors for
        the pool), which key their entries. A piece's ``fn`` is the work a
        bring-up cannot leave to the call path: the library's load, and
        for the wave (the sampled wave, the speculative trip) the capture
        into the engine's pool cache, which the next ``run()`` at
        ``(slots, kv_blocks)`` replays. Every other piece's first use is
        the call path's, which :func:`aot_prime` drives through the real
        ``run()``. Admissions are registered at full length; the unsharded
        steps only."""
        del n_new                       # a runtime value, not a geometry
        kvb = (1 + need_prefix + slots * nt if kv_blocks is None
               else int(kv_blocks))
        lens = sorted({int(x) for x in prompt_lens})
        pool_av = init_paged_cache(cfg, slots, max_len, block_size=bs,
                                   num_blocks=kvb, cache_dtype=cache_dtype,
                                   device="meta")

        def av(shape, dtype=torch.long):
            return torch.empty(shape, dtype=dtype, device="meta")
        one, row_av, key_av, tail_av = av(()), av((nt,)), av((2,)), av((2,))
        s_long, s_bool = av((slots,)), av((slots,), torch.bool)

        def captured() -> None:
            """The geometry's unsharded pool and its wave (on the card:
            captured) into the pool cache."""
            use_rules(None)
            pool_for(slots, kvb)

        def call_path() -> None:
            """A piece whose first use the prime's ``run()`` makes."""

        regs: list[tuple] = []
        if dev.type == "cuda":
            digest = _build.library_digest()
            regs.append((KERNEL_LIBRARY, _build.lib,
                         (library_key(digest), digest)))
        if prefill_chunk is None:
            for length in lens:
                impl = ("cached" if prefix is not None else
                        _select_prefill_impl(cfg, length, "auto", dev))
                regs.append((f"admit_full_L{length}", call_path,
                             (prefill_params, av((1, length)), impl, one,
                              row_av, key_av, tail_av, one, pool_av)))
        else:
            c = prefill_chunk
            regs.append(("admit_table", call_path,
                         (one, row_av, tail_av, one, pool_av)))
            if spec_k is None:
                regs.append(("chunk_step", call_path,
                             (prefill_params, av((1, c)), one, pool_av)))
                regs.append(("chunk_finish", call_path,
                             (av((c, cfg.vocab), cfg.dtype), one, key_av,
                              one, pool_av, one)))
            else:
                mc = max(1, (max_len - prefix_len) // c)
                regs.append(("chunk_sweep", call_path,
                             (prefill_params, av((1, mc, c)), one, one,
                              pool_av, one, key_av, one)))
        if lazy_growth:
            regs.append(("grow_table", call_path, (one, one, one, pool_av)))
        if prefix is not None:
            regs.append(("prefix_fill", call_path,
                         (prefill_params, av((1, prefix_len)), row_av,
                          pool_av)))
        if spec_k is not None:
            ctx_av = av((slots, spec_width))
            for length in lens:
                regs.append((f"spec_admit_row_L{length}", call_path,
                             (av((length,)), one, one, ctx_av, s_long,
                              s_long)))
            regs.append(("spec_step", captured,
                         (params, ctx_av, s_long, s_long, s_long, one,
                          s_bool, one, s_long, pool_av)))
        elif sampler is None:
            regs.append(("wave_step", captured,
                         (params, s_long, s_bool, pool_av)))
        else:
            regs.append(("wave_step_sampled", captured,
                         (params, s_long, s_bool, s_long, s_long, key_av,
                          pool_av)))
        # the fleet handoff pair: the block export and the in-place
        # import, per distinct block count the prompt lengths export
        if lens:
            bufs = [pool_av[k][layer] for k in pool_keys
                    for layer in range(cfg.n_layers)]
            for nxf in sorted({blocks_for_rows(x, bs) for x in lens}):
                payload = [av((nxf,) + tuple(b.shape[1:]), b.dtype)
                           for b in bufs]
                ids = av((nxf,))
                regs.append((f"xfer_export_N{nxf}", call_path, (bufs, ids)))
                regs.append((f"xfer_import_N{nxf}", call_path,
                             (bufs, ids, payload)))
        return regs

    def aot_prime(*, slots: int = 4, kv_blocks=None, prompt_lens=(),
                  n_new: int = 2) -> int:
        """The call-path warm: ONE tiny seeded schedule through the real
        ``run()`` — each length's admission, the eager waves and the
        captures an earlier hit skipped. Lengths and budget are clamped
        into the engine's envelope as the reference clamps them (the
        caller hands the serving schedule's; priming needs the call path,
        not the whole decode). Leaves no cross-run state but the pool
        cache (every ``run()`` zeroes its pool), so a primed engine's
        later runs serve an unprimed engine's tokens. Returns the prompts
        run."""
        lens = sorted({int(x) for x in prompt_lens
                       if prefix_len + int(x) < max_len})
        if not lens:
            return 0
        n_new = max(1, min(int(n_new), max_len - prefix_len - lens[-1]))
        prompts = [torch.arange(1, x + 1, dtype=torch.long) % cfg.vocab
                   for x in lens]
        run(prompts, n_new, slots=slots, kv_blocks=kv_blocks,
            rng=0 if sampler is not None else None)
        return len(prompts)

    def warm(cache=None, *, slots: int = 4, kv_blocks=None, prompt_lens=(),
             n_new: int = 2, prime: bool = True) -> dict:
        """One-call cold-start warm (:func:`..aotcache.warm_engine`); a
        no-op stats dict when the engine has no cache and none is
        passed."""
        return warm_engine(
            run, cache if cache is not None else aot_cache, slots=slots,
            kv_blocks=kv_blocks, prompt_lens=prompt_lens, n_new=n_new,
            prime=prime, telemetry=reg)

    run.last_stats = None
    run.step = step
    run.captures = 0
    run.capture = capture
    run.prefill_session = prefill_session
    run.aot_scope = aot_scope
    run.aot_cache = aot_cache
    run.aot_registrations = aot_registrations
    run.aot_prime = aot_prime
    run.warm = warm
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
