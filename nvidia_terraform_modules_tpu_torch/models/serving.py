# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Continuous-batching serve engine on the paged KV cache — the port of the
core of the reference's ``models/serving.py``.

Requests join in-flight decode at wave boundaries the moment a slot AND
enough KV blocks are free (an optional per-request arrival time gates
admission); each admission prefills its prompt alone, through its own
freshly allocated blocks, and picks its first token; then every wave
advances ALL busy slots with one batched ``[slots, 1]`` paged forward
(:func:`make_serve_step`), reading the cache through the block tables with
the paged decode kernel on the card. A request retires at its own
``n_new`` or at ``eos_id``, its blocks return to the free list and its
slot re-admits at the next wave. Dead slots keep computing (the static
batch) but their writes are fenced to the garbage block.

Host/device split: the host owns WHICH request sits in a slot and WHICH
blocks it holds (plain integers); the device owns the math. Without
``eos_id`` the wave loop never waits on the device: tokens stay on the
card and outputs are assembled after the schedule. With ``eos_id`` each
wave reads its ``[slots]`` token vector back.

Int8 serving: ``cache_dtype="int8"`` keeps the pool int8 with f32 scale
sidecars riding the block tables (the wave step then reads through the
int8 paged kernel), and int8-weight params (``quantize_params`` trees with
``QTensor`` leaves) serve through the PREFILL/DECODE PHASE SPLIT: the
engine dequantises them once at build into a compute-dtype tree that every
admission runs from (prompt-width products are compute-bound), while the
wave steps run from the int8 tree (weight-bound: the int8 matmul kernel).

Exactness contract (the reference's, ``models/serving.py:87-94``): each
request's tokens EQUAL ``greedy_decode`` run alone on that request —
batching, paging, slot recycling and arrival schedules are scheduling,
never a different model. Under an int8 cache the engine quantises the same
rows at the same positions as a solo int8-cache decode, so this holds int8
against int8; with int8 weights it holds at f32 compute dtype wherever the
solo prefill also takes the dequantised product (prompts longer than 64
tokens: ``quantize._kernel_ok``).

The reference engine's other levers are not ported yet; passing one
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from .burnin import BurnInConfig, check_device, tree_leaves
from .decode import (
    _check_params,
    _select_prefill_impl,
    check_cache_dtype,
    forward_paged,
)
from .paging import (
    BlockAllocator,
    blocks_for_rows,
    init_paged_cache,
    paged_pool_spec,
)
from .quantize import QTensor, dequantize_params

# levers of the reference engine this slice leaves out → their ROADMAP item
_LATER = {
    "prefix": "Queue A item 3 (serve levers): template prefix caching",
    "sampler": "Queue A item 3 (serve levers): sampled serving",
    "prefill_chunk": "Queue A item 3 (serve levers): chunked prefill",
    "spec_k": "Queue A item 4 (speculative serving: models/speculative.py)",
    "share_prefix": "Queue A item 3 (serve levers): prefix sharing",
    "lazy_growth": "Queue A item 3 (serve levers): lazy block growth",
    "host_spill": "Queue A item 9 (fleet stack): host KV tier",
    "shared_store": "Queue A item 9 (fleet stack): prefix CDN",
    "aot_cache": "Queue A item 9 (fleet stack): warm compile cache",
    "telemetry": "Queue A item 10 (bench + tracing)",
    "policy": "Queue A item 3 (serve levers): sjf/priority policies",
    "admission": "Queue A item 3 (serve levers): the AdmissionSource seam",
}


def _refuse_levers(levers: dict, where: str) -> None:
    for name, value in levers.items():
        if name not in _LATER:
            raise TypeError(f"{where}() got an unexpected keyword argument "
                            f"{name!r}")
        if name == "policy" and value == "fifo":
            continue
        if value is None or value is False:
            continue
        raise NotImplementedError(
            f"{where}({name}=...) is not ported yet — ROADMAP.md, "
            f"{_LATER[name]}")


def make_serve_step(params, cfg: BurnInConfig, *,
                    paged_kernel: str = "auto"):
    """The all-slots greedy wave step: ``(tokens [slots], active [slots]
    bool, pool) → next tokens [slots]``, one batched ``[slots, 1]``
    ``forward_paged`` that updates the pool in place. ``paged_kernel``
    picks the read path (``"auto"``: the paged decode kernel on the card;
    ``"off"``: the gather reference)."""

    def wave(tokens, active, pool):
        logits, _ = forward_paged(params, tokens[:, None], pool, cfg,
                                  prefill_impl="cached", active=active,
                                  paged_kernel=paged_kernel)
        return logits[:, -1].argmax(dim=-1)

    return wave


class _Sched:
    """FIFO admission order with optional arrival gating: the head is the
    only candidate, and only once it has arrived (head-of-line blocking —
    the reference's ``policy="fifo"`` exactly)."""

    def __init__(self, n: int, arrivals, t0: float):
        self.pending = list(range(n))
        self.arrivals = arrivals
        self.t0 = t0

    def _arrived(self, req: int) -> bool:
        return self.arrivals is None or \
            self.arrivals[req] <= time.monotonic() - self.t0

    def candidate(self):
        if not self.pending:
            return None
        head = self.pending[0]
        return head if self._arrived(head) else None

    def pop(self, req: int) -> None:
        self.pending.remove(req)

    def exhausted(self) -> bool:
        return not self.pending

    def idle_wait(self) -> None:
        """Nothing to compute and the head has not arrived: sleep until it
        does instead of spinning."""
        if self.arrivals is None or not self.pending:
            return
        wait = self.arrivals[self.pending[0]] - (time.monotonic() - self.t0)
        if wait > 0:
            time.sleep(wait)


def make_serve_engine(params, cfg: BurnInConfig, *, max_len: int,
                      kv_block: int = 16, paged_kernel: str = "auto",
                      cache_dtype: str = "bf16", device="cuda", **levers):
    """Reusable engine: ``run(prompts, n_new, *, slots, eos_id, arrivals,
    kv_blocks, static_batching) → list of [n_i] int64 token tensors``.

    Every run builds a paged pool of ``kv_blocks`` blocks of ``kv_block``
    rows (default: one full table per slot plus the garbage block, at
    which admission never waits on memory); a smaller ``kv_blocks`` turns
    into admission control — the queue holds requests until blocks free.
    ``n_new`` is an int or one budget per request; ``arrivals`` (seconds
    from the run's start, e.g. ``utils/traffic.poisson_trace``) gates
    admission; ``static_batching`` admits only when the engine is idle
    (the run-to-completion baseline). After each call ``run.last_stats``
    holds ``requests``, ``generated``, ``waves``, ``latency_ms``
    (admission → retirement, host clock) and ``kv`` (allocator high-water
    and utilisation against the dense ``slots × max_len`` reservation).

    ``cache_dtype="int8"`` serves from an int8 pool; ``QTensor`` params
    serve through the phase split (module docstring). ``params`` must live
    on ``device`` (``"cuda"`` unless the caller asks for the CPU)."""
    _refuse_levers(levers, "make_serve_engine")
    dev = check_device(device)
    _check_params(params, dev)
    if kv_block < 1:
        raise ValueError(f"kv_block must be >= 1, got {kv_block}")
    if paged_kernel not in ("auto", "on", "off"):
        raise ValueError(f"unknown paged_kernel {paged_kernel!r}: "
                         f"use auto|on|off")
    check_cache_dtype(cache_dtype)
    geom = paged_pool_spec(cfg, max_len, kv_block, cache_dtype)
    bs, nt = kv_block, geom["tables"]
    step = make_serve_step(params, cfg, paged_kernel=paged_kernel)
    # the phase split: admissions from a dequantised copy, built once
    prefill_params = params
    if any(isinstance(x, QTensor) for x in tree_leaves(params)):
        prefill_params = dequantize_params(params)

    @torch.no_grad()
    def admit(pool, slot: int, prompt, row: np.ndarray):
        """One admission: map the slot's table row, prefill the prompt
        through its blocks at position 0, return the first token."""
        length = int(prompt.shape[0])
        pool["block_tables"][slot] = torch.as_tensor(row, device=dev)
        sub = dict(pool, block_tables=pool["block_tables"][slot:slot + 1],
                   pos=torch.zeros((1,), dtype=torch.int32, device=dev))
        impl = _select_prefill_impl(cfg, length, "auto", dev)
        logits, sub = forward_paged(prefill_params, prompt[None, :], sub,
                                    cfg, prefill_impl=impl,
                                    paged_kernel="off")
        pool["pos"][slot] = sub["pos"][0]
        return logits[0, -1].argmax(dim=-1)

    def empty_stats() -> dict:
        return {"requests": 0, "generated": 0, "waves": 0,
                "latency_ms": {"p50": None, "p99": None, "max": None},
                "kv": {"num_blocks": 0, "reserved": 0, "in_use": 0,
                       "free": 0, "high_water": 0, "refs_total": 0,
                       "block_size": bs, "peak_rows": 0, "dense_rows": 0,
                       "utilisation": 0.0, "mean_utilisation": 0.0}}

    @torch.no_grad()
    def run(prompts: Sequence[Any], n_new, *, slots: int = 4,
            eos_id: int | None = None, arrivals=None,
            kv_blocks: int | None = None, static_batching: bool = False,
            **run_levers):
        _refuse_levers(run_levers, "run")
        run.last_stats = None
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if not prompts:
            run.last_stats = empty_stats()
            return []
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
        toks = [torch.as_tensor(p, device=dev).long().reshape(-1)
                for p in prompts]
        lens = [int(t.shape[0]) for t in toks]
        for i, length in enumerate(lens):
            if length < 1:
                raise ValueError("prompts must have at least one token")
            if length + n_new_of[i] > max_len:
                raise ValueError(f"prompt ({length}) + n_new "
                                 f"({n_new_of[i]}) exceeds max_len "
                                 f"({max_len})")
        need = [blocks_for_rows(min(lens[i] + n_new_of[i], geom["rows"]),
                                bs) for i in range(len(toks))]
        if kv_blocks is None:
            kv_blocks = 1 + slots * nt
        if kv_blocks < 1 + max(need):
            raise ValueError(
                f"kv_blocks ({kv_blocks}) cannot hold the largest request "
                f"({max(need)} blocks of {bs} rows + the reserved garbage "
                f"block) — the queue would deadlock; raise kv_blocks")

        alloc = BlockAllocator(kv_blocks)
        pool = init_paged_cache(cfg, slots, max_len, block_size=bs,
                                num_blocks=kv_blocks,
                                cache_dtype=cache_dtype, device=dev)
        sched = _Sched(len(toks), arrivals, time.monotonic())
        tokens = torch.zeros((slots,), dtype=torch.long, device=dev)
        owned: dict[int, list[int]] = {}         # req → blocks
        active: dict[int, int] = {}              # slot → req
        firsts: dict[int, Any] = {}              # req → prefill token
        span: dict[int, tuple] = {}              # req → (slot, first wave)
        count: dict[int, int] = {}               # req → tokens so far
        done_at: dict[int, int] = {}             # req → final token count
        admitted_at: dict[int, float] = {}
        latencies: list[float] = []
        hist: list = []                          # one [slots] vector a wave
        in_use_sum = in_use_n = 0                # per-loop occupancy samples
        mask_key: list = [None, None]

        def retire(req: int, ntok: int) -> None:
            done_at[req] = ntok
            alloc.free(owned.pop(req))
            latencies.append((time.monotonic() - admitted_at.pop(req)) * 1e3)

        while not sched.exhausted() or active:
            admit_ok = not static_batching or not active
            for slot in range(slots):
                if not admit_ok or slot in active:
                    continue
                req = sched.candidate()
                if req is None:
                    break                 # empty, or the head not arrived
                blocks = alloc.alloc(need[req])
                if blocks is None:
                    break                 # blocks exhausted: hold the head
                sched.pop(req)
                owned[req] = blocks
                admitted_at[req] = time.monotonic()
                row = np.zeros((nt,), np.int32)
                row[:len(blocks)] = blocks
                first = admit(pool, slot, toks[req], row)
                # out of place: the previous vector is already in hist
                tokens = tokens.clone()
                tokens[slot] = first
                firsts[req] = first
                span[req] = (slot, len(hist))
                count[req] = 1
                # a request the prefill token already satisfies retires
                # before any step, or it would collect an extra token
                if n_new_of[req] == 1 or (eos_id is not None
                                          and int(first) == eos_id):
                    retire(req, 1)
                else:
                    active[slot] = req
            in_use_sum += alloc.in_use
            in_use_n += 1
            if not active:
                if not sched.exhausted() and sched.candidate() is None:
                    sched.idle_wait()
                continue
            key = tuple(sorted(active))
            if key != mask_key[0]:
                mask_key[0] = key
                mask_key[1] = torch.tensor(
                    [s in active for s in range(slots)], device=dev)
            tokens = step(tokens, mask_key[1], pool)
            hist.append(tokens)
            for slot, req in list(active.items()):
                count[req] += 1
                if count[req] >= n_new_of[req]:
                    retire(req, count[req])
                    del active[slot]
            if eos_id is not None:
                tok_h = hist[-1].cpu()
                for slot, req in list(active.items()):
                    if int(tok_h[slot]) == eos_id:
                        retire(req, count[req])
                        del active[slot]

        waves = torch.stack(hist) if hist else None      # [W, slots]
        outs = []
        for req in range(len(toks)):
            n, (slot, sw) = done_at[req], span[req]
            head = firsts[req].reshape(1)
            outs.append(head if n == 1 else
                        torch.cat([head, waves[sw:sw + n - 1, slot]]))
        lat = sorted(latencies)

        def q(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 3)

        st = alloc.stats()
        dense = slots * geom["rows"]
        run.last_stats = {
            "requests": len(outs),
            "generated": sum(int(o.shape[0]) for o in outs),
            "waves": len(hist),
            "latency_ms": {"p50": q(0.5), "p99": q(0.99),
                           "max": round(lat[-1], 3)},
            "kv": {**st, "block_size": bs,
                   "peak_rows": st["high_water"] * bs,
                   "dense_rows": dense,
                   "utilisation": round(st["high_water"] * bs
                                        / max(dense, 1), 4),
                   "mean_utilisation": round(
                       in_use_sum / max(in_use_n, 1) * bs / max(dense, 1),
                       4)},
        }
        return outs

    run.last_stats = None
    run.step = step
    return run
