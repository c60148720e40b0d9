#!/usr/bin/env python3
# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Chip smoke test of the PyTorch / H100 port (``nvidia_terraform_modules_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` with nvcc (into
``build/torch_kernels/``), and drives the port's three main paths:

- serve: holds K1 (flash forward) and K7 (paged decode) against their plain
  PyTorch versions at the serve path's shapes, checks the engine's
  exactness contract on the card, holds the wave replayed from its
  captured CUDA graph against the eager wave (tokens and pool bytes, bf16
  and int8 pools; a second run captures nothing new), serves at the
  flagship width — every wave one replay (the launch counts, the capture's
  tally times the replays, show it went through both kernels), timed
  beside the eager wave — and profiles one more run of the same traffic
  (device time by kernel against the host clock; K7 by name);
- sampled and speculative serving: holds D1 (the keyed Gumbel-max draw,
  not a TPU kernel: the reference draws in XLA) against the plain draw,
  tokens and Gumbel scores bit for bit; checks the sampled engine's
  contracts on the card (top-k = 1 is greedy, slots 1 = slots 3, the
  replayed sampled wave = the eager one, a preempted request draws the
  same tokens again) and the speculative engine's (greedy decode's
  tokens, composed with sharing, chunking and lazy growth, int8); serves
  the flagship traffic sampled (top-p, then top-k; D1 in every wave and
  admission, timed beside the wave with the plain draw captured in its
  place) and with ``spec_k=4`` on the template traffic beside the greedy
  engine;
- serve levers: each of ``eos_check_every``, sjf/priority admission,
  chunked prefill, the template prefix, cross-request prefix sharing and
  lazy growth alone and composed, at f32 on the card, against the
  unlevered engine and solo decode; then all of them composed at the
  flagship width on Zipf template traffic with a pool at ~60 % of full
  provisioning;
- the host KV tier (``host_spill``): at f32 on template traffic with a
  keep-cap of 0 (every retirement spills), slots 1 and 2, async and sync
  swaps, the f32 pool and the int8 cache, tokens equal to the engine's
  without the tier and solo decoding bit for bit, with swap-ins, both
  pools drained, K7/K7-int8 once a layer a wave and every import in place
  (the captured wave's pool addresses); a planted flipped host byte must
  end in one classified drop with the tokens unchanged. At the flagship
  width on the lever traffic: the spilling engine (async and sync swaps,
  a 512-block pinned host pool), the engine without the tier and one
  that keeps the whole working set, in turns — swap and spill ms a block,
  crc ms a block, prefill device ms an admission, tokens/s and latency,
  and which requests equal the keep-everything engine's;
- int8 serving: holds K8 (int8-weight matmul), K6 (contiguous int8
  decode) and K7-int8 (the paged kernel on an int8 pool) against their
  plain versions, and the decode kernels' split at its seams (positions on
  either side of a span boundary; the paged kernel equal to the contiguous
  one on the gathered view, and a row alone equal to the same row in a
  batch, bit for bit), checks the int8 engine's exactness on the card, serves
  the flagship traffic with int8 weights and an int8 pool (the launch
  counts show every wave went through K7-int8 and K8), profiles it (one
  K8 kernel a weight product);
- decode: holds ``make_decoder`` (an eager prefill, then ONE replay of a
  captured CUDA graph of the steps a call) against the eager loop at f32,
  bit for bit, for both cache and weight dtypes, and across a params swap
  (each tree its own capture); times the replayed decoder beside the eager
  loop at the flagship's decode shape (batch 8, prompt 512, 64 new tokens;
  K6 and K8 on every step) and at 3584 + 32, each rate the median of
  DECODE_RUNS turns with its min-max;
- MoE serving (``models/moe.py``'s routed FFN, 8 experts, top-1): checks
  at f32, top-1 and top-2, that the MoE engine equals solo decode and a
  full re-forward, the replayed MoE wave the eager one (tokens and pool
  bytes), ``make_decoder`` the eager loop, a 150-token prompt routed in
  chunks the unchunked forward, and the int8 MoE engine its solo int8
  decode; serves the flagship traffic on the flagship MoE configuration
  (bf16; then int8 weights and pool: K1 each admission, K7 or K7-int8 and
  33 K8 each wave, counted) beside the dense wave, with a profile of each;
  and times ``make_decoder`` at ``bench.py``'s MoE decode shape (batch 8,
  prompt 512, 64 new; K6 over the int8 cache, and the bf16 cache),
  replayed and eager;
- instruments: the probes (``ops/probes``: bf16 products, HBM read and
  triad, as shares of ``utils/device``'s peaks, which every bound here
  reads); the flagship traffic again through an engine with an enabled
  telemetry registry, in turns with the untraced engine (equal tokens,
  the tokens/s ratio, the Prometheus exposition); the flagship train step
  under ``instrument_step`` (the flash probe, ``train_mfu``);
- train: prints the registers, spills and CTAs per SM of each instance of
  the bf16 key-block kernel that K5 and K4 share and of K3's query-block
  kernel; holds K5 (fused flash backward) and K3/K4 (the split pair)
  against their plain versions, up to the flagship's per-layer
  ``[2, 4096, 16, 128]``, and K3 to its own bits on a second call and for
  a row run alone; checks the train step's gradients on the card
  against the dense model, fused against split, remat and accumulation;
  runs SGD and AdamW steps of the flagship burn-in step at full width and
  depth (the launch counts show it went through K1 and K5, or K3 + K4);
  and profiles one step;
- sequence-parallel train: holds K2 (the partial flash forward of ring
  attention) against its plain version at the ring's flagship block
  ``[2, 1024, 16, 128]`` (and, normalised, against K1 bit for bit there
  and at the train step's causal ``[2, 4096, 16, 128]``), and
  K5/K3/K4 with the f32 outputs the ring takes, timed beside bf16 ones;
  checks the f32 ring (K2 + K5, and K2 + K3 + K4) and Ulysses (K1 + K5)
  on meshes of sp = 2 and 4 against dense attention, forward and
  gradients, with planted faults that the check must catch; runs the
  flagship step with ``attn="ring"`` on a mesh of sp = 4 (four ring
  members on the one card: the launch counts show every layer went
  through K2 and K5, or K3 + K4) and profiles one step;
- the validation Job's payload: runs ``python -m
  nvidia_terraform_modules_tpu_torch.smoketest`` as the Job does, at
  ``burnin`` with one expected device (a world of one over NCCL), and
  requires every leg of its JSON line (the all-reduce, the sharded
  burn-in, decode, the serve engine, its levers, the paged decode kernel
  against the gather path); runs the same in this process under
  ``torch.profiler``, its launch counts set to 0 first, where the
  ``paged_decode`` leg must have launched K7; and runs the flagship SGD
  step through ``make_train_step(cfg, rules)`` on the world-1 mesh
  against the unsharded step (the split backward's parameters bit for
  bit after 3 steps; the fused step's within the bf16 tolerance, K5's dQ
  atomics varying its bits between runs), timing both and counting K1
  and K5;
- the Job's ``full`` level: the MoE train step's f32 gradients (4
  experts, top-2) against the dense-attention model; the flagship MoE
  configuration (8 experts, top-1, 2.30 B parameters) trained through
  ``make_train_step(cfg, rules)`` on the world-1 mesh — equal to the
  unsharded step bit for bit with the split backward, then timed with the
  fused one (step ms median and min–max, MFU, peak memory, K1 and K5
  counted, the loss falling); the dense flagship engine under
  ``run(rules=)``, its tokens equal to the ``rules=None`` engine's bit for
  bit (K1 and K7 counted, its replayed wave timed), and at f32 equal to
  solo decode; and the CLI at ``--level full`` as a world of one, which
  skips the fabric legs with ``full_skipped``, lists no full-level leg as
  not ported and decodes on the trained shards (no ``decode_sharding``);
- ``rules=`` on the other decode entry points and the engine's levers
  (the NCCL world of one): ``make_decoder(cfg, rules)`` over the bf16
  cache and ``make_quantized_decoder(cfg, rules, cache_dtype="int8")`` at
  the flagship decode shape, tokens equal to the ``rules=None`` decoders'
  bit for bit, one call's K1/K6/K8 counted, tokens/s beside the unsharded
  decoder's; the flagship MoE, int8-weight and ``spec_k=4`` engines under
  ``run(rules=)``, tokens and K1/K7/K7-int8/K8 launches equal to the
  ``rules=None`` runs', and their f32 configurations equal to solo
  ``greedy_decode(..., rules)``; K8 and K6 at the shapes a tp 2 or tp 4
  rank gives them (``kernel_shard_shapes``), against their plain
  versions;
- the pipeline and the sequence over processes: GPipe and 1F1B
  (``parallel/pipeline.py``) at f32 on ``[cuda:0] * pp`` for pp 2 and 4
  and on a world of one over NCCL, against the unpipelined model through
  the same kernels (K1 and K5, counted by name), with planted faults (a
  stage's layers reversed, a microbatch dropped) that the check must
  catch; the flagship-width pipeline step (8 microbatches of one 4,096-row
  sequence over 2 stages on the card: step ms, peak memory and K1/K5
  launches of GPipe and 1F1B beside the unpipelined step, a falling
  loss, MFU); and ``attn="ring"``/``"ulysses"`` through the world-of-one
  rules (K2 and K5 with f32 outputs, or K1 and K5, by name; the f32 loss
  equal to the flash step's bit for bit). One card holds one NCCL rank,
  so the multi-rank hops are proven in gloo worlds on the CPU;
- the fleet's elastic plane and durable prefix CDN (``fleet_scale_exact``,
  f32): the Job's ``fleet_scale_ok`` and ``prefix_cdn_ok`` legs, an
  autoscaled fleet with no event equal to the fixed fleet byte for byte, a
  seeded up → down run and its replay with warm joins (K1/K7 counted a
  worker), a process fleet's warm join with a planted corrupt chain, and
  2-replica ``disk_spill=`` fleets restarted over their directory (one
  planted corrupt frame) at the f32 pool and the int8 cache; at the
  flagship width (``serve_cdn_flagship``): the cold, restarted and
  store-less fleets in turns and an autoscaled fleet's warm joiner —
  restore seconds, disk bytes, swap ms a MiB off disk and off the store,
  tokens/s, latency and flash prefills.

Every phase prints one JSON line; any failure raises and the script exits
non-zero. Without a CUDA device it exits 1 and prints no result; it
imports nothing of JAX.

The last three lines are: the kernels' JSON record (times, bounds, launch
counts), the card's ``name, power.limit`` as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N_REQUESTS, SLOTS, KV_BLOCK, N_NEW, SEED = 8, 4, 16, 32, 0
# the flagship lever traffic: utils/traffic.shared_prefix_prompts' Zipf
# templates, ragged budgets, chunked prefill and the pool's share of full
# provisioning
LEVER_REQUESTS, LEVER_CHUNK, LEVER_POOL_SHARE = 16, 64, 0.6
# the host KV tier at the flagship: the host pool's blocks (1 MiB each at
# bf16) and the turns of its four engines
SPILL_HOST_BLOCKS, SPILL_TURNS = 512, 3
# the flagship's SGD rate: at make_train_step's default of 1e-3, lr·g is
# below half a bf16 step of most weights (a weight near 0.02 moves only for
# |g| > 0.06), so most of the update rounds away
TRAIN_LR = 0.1
WARM_STEPS, TIMED_STEPS, ADAMW_STEPS = 2, 10, 3
# make_quantized_decoder at bench.py section_decode_int8's shape, and its
# long-context pair
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 8, 512, 64
LONG_PROMPT, LONG_NEW = 3584, 32
# turns of each decode rate (replayed and eager): the median and min-max
DECODE_RUNS = 5
# the int8 kernels' limits: max-abs error over max(1, max|ref|) — an int8
# decode output over a few keys reaches |out| > 2, where one bf16 rounding
# is 0.0156, and the int8 matmul's plain version scales before the
# product, the kernel after it
INT8_TOL = {"bf16": 1e-2, "f32": 1e-5}
# the int8 weight products of one flagship wave or decode step:
# (name, K, N, transposed storage, calls) — per layer wq/wk/wv/wo, up,
# down, and once the tied head x @ embed.T over the [8192, 2048] embedding
WAVE_MATMULS = [("square", 2048, 2048, False, 32), ("up", 2048, 8192, False, 8),
                ("down", 8192, 2048, False, 8), ("head", 2048, 8192, True, 1)]
# the backward kernels' FLOPs as multiples of the forward's (tile products:
# 5, 3 and 4 against the forward's 2) and the [B, S, H, D] tensors each
# writes
BWD_FACTOR = {"flash_bwd_fused": 2.5, "flash_dq": 1.5, "flash_dkv": 2.0}
BWD_OUTPUTS = {"flash_bwd_fused": 3, "flash_dq": 1, "flash_dkv": 2}
# the backward kernels' limits: max-abs error over max(1, max|ref|), and
# the relative L2 error ||got - ref|| / ||ref||, which holds the many small
# gradients of a long sequence that the max-abs limit is loose for
BWD_TOL = {"bf16": (2e-2, 1e-2), "f32": (1e-4, 1e-4)}
# K2's limits on acc, m and l: max-abs error over max(1, max|plain|) — the
# kernel rounds P to bf16 per 64-key tile against its running max, the
# plain version once per row against the row's max
PARTIAL_TOL = {"bf16": 1e-2, "f32": 1e-5}
# the flash forward's one tiling (csrc/flash_fwd.cu), bf16 and f32 alike
FWD_TILING = "64 q rows x 64 keys, 4 warps"
# the sequence-parallel flagship: a ring of RING_SP members (on one card),
# each holding seq_len / RING_SP rows; the f32 exactness shape
RING_SP = 4
RING_EXACT_SHAPE = (2, 512, 4, 128)
# the flagship ring step's bf16 gradients: each no further (relative L2)
# from the f32 step's than this many times the flash step's
RING_VS_FLASH = 1.5
# D1's operations an element, for its bound: threefry's 20 rounds and 5 key
# injections (~80 integer operations), two libdevice logf (~30), the
# uniform's bit steps and the running argmax (~15); counted at the CUDA
# cores' f32 rate
DRAW_OPS_PER_ELEMENT = 125
# the flagship MoE configuration: bench.py section_decode_moe's experts and
# top-k on FLAGSHIP_TRAIN (d_ff stays 8,192 an expert)
MOE_EXPERTS, MOE_TOP_K = 8, 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_spec():
    """The card's published peaks (``utils/device.PEAK_SPECS``): the dense
    bf16 tensor-core rate, the f32 CUDA-core rate (the f32 kernels'
    route) and the HBM rate. A card the table does not name fails the run:
    its bounds would be the nominal stub's."""
    from nvidia_terraform_modules_tpu_torch.utils.device import (
        PEAK_SPECS,
        device_spec,
    )

    spec = device_spec()
    if spec.kind not in PEAK_SPECS:
        raise RuntimeError(f"utils/device.PEAK_SPECS has no entry for "
                           f"{spec.kind!r}: no bound can be computed")
    return spec


def bound(flops: float, nbytes: float, kind: str) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak rate for their type (``"bf16"``:
    tensor cores; ``"f32"``: CUDA cores)."""
    spec = card_spec()
    tflops = spec.bf16_tflops if kind == "bf16" else spec.f32_tflops
    t_ops = flops / (tflops * 1e12)
    t_bytes = nbytes / (spec.hbm_gbps * 1e9)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def achieved(flops: float, ms: float, bound_ms: float) -> dict:
    """The rate a kernel reached and the share of its bound."""
    return {"tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}


def profile_summary(prof, wall_ms: float) -> dict:
    """Device time summed by kernel name from a ``torch.profiler`` run,
    against the run's wall clock. An empty trace means the profiler saw no
    device activity: the device numbers are then "not measured" (null)."""
    kernels_us: dict[str, list] = {}
    host_us: dict[str, list] = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            acc = kernels_us.setdefault(evt.key, [0.0, 0])
            acc[0] += evt.self_device_time_total
            acc[1] += evt.count
        elif evt.self_cpu_time_total > 0:
            acc = host_us.setdefault(evt.key, [0.0, 0])
            acc[0] += evt.self_cpu_time_total
            acc[1] += evt.count
    device_ms = (sum(us for us, _ in kernels_us.values()) / 1e3
                 if kernels_us else None)
    top = sorted(kernels_us.items(), key=lambda kv_: -kv_[1][0])[:12]
    # cuBLAS's GEMM kernels on Hopper are named nvjet_*, older ones *gemm*
    gemm_us = sum(us for name, (us, _) in kernels_us.items()
                  if name.startswith("nvjet") or "gemm" in name.lower())
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share_profiled=(device_ms / wall_ms
                                     if device_ms is not None else None),
                gemm_ms=gemm_us / 1e3 if kernels_us else None,
                kernel_launches=sum(c for _, c in kernels_us.values()),
                top_kernels=[{"name": k[:90], "ms": us / 1e3, "count": c}
                             for k, (us, c) in top],
                # host time by operator (self time; under the profiler,
                # which adds its own cost per operator)
                top_host_ops=[{"name": k[:60], "ms": us / 1e3, "count": c}
                              for k, (us, c) in sorted(
                                  host_us.items(),
                                  key=lambda kv_: -kv_[1][0])[:10]])


def kernel_counts(prof, name: str) -> dict:
    """Launches by device kernel whose name holds ``name`` in a
    ``torch.profiler`` run (graph replays included)."""
    return {evt.key[:90]: evt.count for evt in prof.key_averages()
            if str(getattr(evt, "device_type", "")).endswith("CUDA")
            and name in evt.key}


def profiled(run, name: str, expect, what: str, roles=None,
             warm: bool = False) -> tuple[dict, dict, list]:
    """``run()`` under ``torch.profiler`` (CPU and CUDA; ending in a
    synchronise): its :func:`profile_summary`, the launches of the device
    kernels whose name holds ``name``, and what each attempt counted:
    ``roles`` of those launches, by default their sum. That must equal
    ``expect()``; an empty trace leaves the check "not measured". A trace
    short of them is taken once more: one MoE serve profile on an H100
    held 248 of its 496 replayed K7 records, where another run of the
    same code held all 496 and the launch counts were right, so the
    tracer can drop a block of records — a path that skipped the kernel
    would fall short in both traces. ``warm``: ``run()`` once first in the
    profiler's warm-up step, whose records are not kept — without it, each
    of two profiles of one GPipe step on an H100 held 15 of its 16 K1
    records, and a ring step's 7 of its 8 K2, though the wrappers counted
    every launch."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    attempts = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1) if warm else None) as prof:
            if warm:
                run()
                sync()
                prof.step()
            t0 = time.monotonic()
            run()
            sync()
            wall_ms = (time.monotonic() - t0) * 1e3
        summary = profile_summary(prof, wall_ms)
        by_name = kernel_counts(prof, name)
        attempts.append(roles(by_name) if roles else sum(by_name.values()))
        if summary["device_ms"] is None or attempts[-1] == expect():
            return summary, by_name, attempts
    raise AssertionError(f"{what}: {name} kernels {by_name} in each of two "
                         f"profiles {attempts}, expected {expect()}")


def max_rel_err(got, want, floor: float | None = 1.0) -> float:
    """Max over the leaves of two params-shaped trees of
    ``max|got - want| / max(floor, max|want|)`` (``floor=None``: purely
    relative)."""
    from nvidia_terraform_modules_tpu_torch.models import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        mag = b.float().abs().max().item()
        den = mag if floor is None else max(floor, mag)
        err = (a.float() - b.float()).abs().max().item()
        worst = max(worst, err / den if den else err)
    return worst


def grad_errors(got, ref, kind: str, what: str) -> tuple[float, float]:
    """The max-abs and the relative L2 error of each output of ``got``
    against ``ref``; raises where either passes its ``BWD_TOL`` limit.
    Returns the largest of each."""
    tol_abs, tol_l2 = BWD_TOL[kind]
    worst_abs, worst_l2 = 0.0, 0.0
    for i, (a, r) in enumerate(zip(got, ref)):
        diff, r = a.float() - r.float(), r.float()
        err = diff.abs().max().item()
        lim = tol_abs * max(1.0, r.abs().max().item())
        l2 = (diff.norm() / r.norm()).item()
        if not (err <= lim and l2 <= tol_l2):
            raise AssertionError(f"{what} output {i}: max-abs err {err} "
                                 f"(limit {lim}), relative L2 {l2} "
                                 f"(limit {tol_l2})")
        worst_abs, worst_l2 = max(worst_abs, err), max(worst_l2, l2)
    return worst_abs, worst_l2


def planted_faults(got, ref, kind: str) -> list[dict]:
    """The check of :func:`grad_errors` against known faults: each of dQ,
    dK and dV with its rows from S/2 on halved (a kernel wrong only far
    along the sequence) must fail it. Records, for each, the max-abs error
    against its limit and the relative L2 error."""
    tol_abs = BWD_TOL[kind][0]
    out = []
    for i, name in enumerate(("dq", "dk", "dv")):
        bad = [g.clone() for g in got]
        bad[i][:, bad[i].shape[1] // 2:] *= 0.5
        r = ref[i].float()
        diff = bad[i].float() - r
        rec = dict(fault=f"{name} x 0.5 on rows >= S/2",
                   max_abs_err=diff.abs().max().item(),
                   max_abs_limit=tol_abs * max(1.0, r.abs().max().item()),
                   rel_l2=(diff.norm() / r.norm()).item())
        try:
            grad_errors(bad, ref, kind, "planted fault")
        except AssertionError:
            out.append({**rec, "caught": True})
            continue
        raise AssertionError(f"planted fault not caught: {rec}")
    return out


def limit_err(got, ref, kind: str, what: str) -> float:
    """Max-abs error of ``got`` against ``ref``; raises past the int8
    kernels' limit ``INT8_TOL[kind] · max(1, max|ref|)``."""
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    lim = INT8_TOL[kind] * max(1.0, ref.abs().max().item())
    if not err <= lim:
        raise AssertionError(f"{what}: max-abs err {err} (limit {lim})")
    return err


def kernel_int8_matmul(randn, dev) -> tuple[dict, dict]:
    """K8 against its plain version at the wave's shapes (M = 4) and the
    decode step's (M = 8), and off the path (M = 1, M = 64, f32 x), rows of
    each call with M > 1 against M = 1 calls bit for bit, and a K the
    kernel cannot take, which must raise. Each record carries the grid the
    kernel launches (``int8_grid``, read from the kernel: its K split is
    the wrapper's ``int8_slices``), the host's µs to issue one call and
    the instance's registers, shared memory and CTAs per SM. Returns the
    main-path records of the wave and of the decode step, by shape name."""
    import torch

    from nvidia_terraform_modules_tpu_torch.ops.int8_matmul import (
        int8_grid,
        int8_matmul,
        int8_matmul_ref,
        int8_matmul_resources,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        host_ms,
        sync,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, m, k, n, trans, bf16, path)
             for path, m in (("wave", SLOTS), ("decode", DECODE_BATCH))
             for name, k, n, trans, _ in WAVE_MATMULS]
    cases += [("square", 1, 2048, 2048, False, bf16, None),
              ("square", 64, 2048, 2048, False, bf16, None),
              ("square", 4, 2048, 2048, False, f32, None),
              # 24 tiles: 8 slices of 3 (not a power of two)
              ("k3072", 4, 3072, 2048, False, bf16, None)]
    main: dict = {"wave": {}, "decode": {}}
    for name, m, k, n, trans, dtype, path in cases:
        w = torch.randint(-127, 128, (n, k) if trans else (k, n),
                          generator=randn.gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((n,), generator=randn.gen, device=dev) * 2e-3 \
            + 1e-4
        x = randn((m, k), dtype)

        def call(x=x, w=w, scale=scale, trans=trans):
            return int8_matmul(x, w, scale, transpose_rhs=trans)
        out = call()
        ref = int8_matmul_ref(x, w, scale, transpose_rhs=trans)
        sync()
        kind = "bf16" if dtype == bf16 else "f32"
        err = limit_err(out, ref, kind, f"int8_matmul {name} M={m}")
        if m > 1:
            rows = torch.cat([int8_matmul(x[i:i + 1], w, scale,
                                          transpose_rhs=trans)
                              for i in range(m)])
            if not torch.equal(rows, out):
                raise AssertionError(f"int8_matmul {name} M={m}: rows "
                                     f"differ from M=1 calls")
        ms = cuda_median_ms(call)
        plain_ms = cuda_median_ms(lambda: int8_matmul_ref(
            x, w, scale, transpose_rhs=trans))
        # yardstick: cuBLAS on the dequantised weight (dequant untimed)
        wd = (w.float() * scale.reshape((-1, 1) if trans else (1, -1))
              ).to(dtype)
        wd_op = wd.T if trans else wd
        library_ms = cuda_median_ms(lambda: torch.matmul(x, wd_op))
        elt = x.element_size()
        nbytes = k * n + 4 * n + m * k * elt + m * n * elt
        bound_ms, bound_by = bound(2.0 * m * k * n, nbytes, kind)
        blocks, slices, groups = int8_grid(m, k, n)
        rec = dict(shape=name, m=m, k=k, n=n, transposed=trans,
                   dtype=str(dtype), main_path=path, max_abs_err=err,
                   rows_bitwise=m > 1, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, slices=slices,
                   ctas=blocks * slices * groups,
                   host_us=host_ms(call, iters=50) * 1e3,
                   **int8_matmul_resources(transpose_rhs=trans,
                                           dtype=dtype))
        emit("kernel_int8_matmul", **rec)
        if path:
            main[path][name] = rec
        del w, wd, wd_op
    x = randn((4, 2048), bf16)
    w = torch.zeros((2048, 2048), dtype=torch.int8, device=dev)
    s = torch.ones((2048,), device=dev)
    try:
        int8_matmul(x[:, :100].contiguous(), w[:100], s)
    except ValueError as exc:
        emit("kernel_int8_matmul_refusal", k=100, raised=str(exc)[:80])
    else:
        raise AssertionError("int8_matmul took K = 100")
    return main["wave"], main["decode"]


def wave_mean(main: dict, key: str) -> float:
    """The mean per launch of a wave's 49 int8 products."""
    calls = {name: c for name, _, _, _, c in WAVE_MATMULS}
    return (sum(calls[n] * main[n][key] for n in calls)
            / sum(calls.values()))


def kernel_kv_decode(randn, dev) -> dict:
    """K6 against its plain version at the flagship decode step (batch 8,
    16 heads, int8 over 768 rows at positions 512-575, and over 3840 rows
    at 3584-3615) and off the path (GQA, ragged positions with 0, bf16
    and f32 caches); rows past each position hold planted values (int8
    127 with scale 1e4, or 1e4) that a read would show. Returns the
    main-path records."""
    import torch
    import torch.nn.functional as F

    from nvidia_terraform_modules_tpu_torch.models import quantize_kv
    from nvidia_terraform_modules_tpu_torch.ops.decode_attention import (
        decode_spans,
        kv_decode_attention,
        kv_decode_attention_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        sync,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    b = DECODE_BATCH
    mid = [DECODE_PROMPT + 8 * i for i in range(b)]          # 512 .. 568
    long_pos = [LONG_PROMPT + 4 * i for i in range(b)]       # 3584 .. 3612
    # (batch, heads, kv heads, rows, positions, q dtype, int8, main path)
    cases = [(b, 16, 16, 768, mid, bf16, True, "step"),
             (b, 16, 16, 3840, long_pos, bf16, True, "long"),
             (3, 8, 2, 300, [0, 131, 299], bf16, True, False),
             (2, 8, 2, 300, [17, 0], f32, True, False),
             (3, 8, 2, 300, [0, 131, 299], bf16, False, False),
             (2, 4, 4, 200, [199, 0], f32, False, False)]
    main: dict = {}
    d = 128
    for bb, h, kv, s, pos_list, dtype, quant, on_path in cases:
        q = randn((bb, h, d), dtype)
        k, v = randn((bb, s, kv, d), f32), randn((bb, s, kv, d), f32)
        ks = vs = None
        if quant:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        else:
            k, v = k.to(dtype), v.to(dtype)
        for i, p in enumerate(pos_list):       # rows past pos: planted
            for t in (k, v):
                t[i, p + 1:] = 127 if quant else 1e4
            if quant:
                ks[i, p + 1:] = 1e4
                vs[i, p + 1:] = 1e4
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        kw = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)
        out = kv_decode_attention(q, k, v, pos, **kw)
        ref = kv_decode_attention_ref(q, k, v, pos, **kw)
        sync()
        kind = "bf16" if dtype == bf16 else "f32"
        err = limit_err(out, ref, kind, f"kv_decode S={s} int8={quant}")
        ms = cuda_median_ms(lambda: kv_decode_attention(q, k, v, pos, **kw))
        plain_ms = cuda_median_ms(lambda: kv_decode_attention_ref(
            q, k, v, pos, **kw), iters=5, warmup=1)
        # yardstick: SDPA over the dequantised cache (dequant untimed)
        # with the position mask
        kd, vd = k.float(), v.float()
        if quant:
            kd, vd = kd * ks[..., None], vd * vs[..., None]
        kd, vd = (t.to(dtype).transpose(1, 2).contiguous() for t in (kd, vd))
        amask = (torch.arange(s, device=dev)[None, :]
                 <= pos.long()[:, None])[:, None, None, :]
        library_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=amask, scale=d ** -0.5,
            enable_gqa=kv != h))
        live = int((pos.long() + 1).sum())
        elt = q.element_size()
        row_bytes = d * (1 if quant else elt) + (4 if quant else 0)
        nbytes = 2 * live * kv * row_bytes + 2 * bb * h * d * elt + bb * 4
        bound_ms, bound_by = bound(4.0 * h * d * live, nbytes, kind)
        rec = dict(b=bb, heads=h, kv_heads=kv, d=d, rows=s, pos=pos_list,
                   dtype=str(dtype), int8=quant, main_path=on_path,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, ctas=bb * kv * decode_spans(s),
                   live_ctas=kv * sum(decode_spans(p + 1)
                                      for p in pos_list))
        emit("kernel_kv_decode", **rec)
        if on_path:
            main[on_path] = rec
        del k, v, kd, vd, ks, vs
    return main


def kernel_decode_spans(randn, dev) -> None:
    """The decode kernels' split at its seams, at the flagship's widths (16
    heads, 16 KV heads, d = 128, blocks of KV_BLOCK): K7 (bf16 pool), K7-int8
    and K6 (int8 and bf16 caches) with rows at positions 0, S - 1, S and
    S + 1 for a span of S keys, each against its plain version and K7
    against K6 on the gathered view bit for bit; then one row run alone and
    inside a batch of 4 unrelated rows, with equal bits (K7, K7-int8)."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import quantize_kv
    from nvidia_terraform_modules_tpu_torch.ops.decode_attention import (
        DECODE_SPAN,
        gather_logical,
        kv_decode_attention,
        kv_decode_attention_ref,
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    bf16 = torch.bfloat16
    h, kv, d, bs = 16, 16, 128, KV_BLOCK
    span = DECODE_SPAN
    nt = -(-max(600, 2 * span) // bs)
    rows = nt * bs
    for quant in (False, True):
        for pos_list in ([0, span - 1, span, span + 1], [559, 63, 64, 300]):
            b = len(pos_list)
            nb = 1 + b * nt
            k_pool, v_pool = (randn((nb, bs, kv, d), torch.float32)
                              for _ in range(2))
            ks = vs = None
            if quant:
                (k_pool, ks), (v_pool, vs) = (quantize_kv(t) for t in
                                              (k_pool, v_pool))
                k_pool[0] = 127          # garbage block and its sidecars:
                v_pool[0] = 127          # a read would show
                ks[0] = 1e4
                vs[0] = 1e4
            else:
                k_pool, v_pool = k_pool.to(bf16), v_pool.to(bf16)
                k_pool[0] = 1e4
                v_pool[0] = 1e4
            pos = torch.tensor(pos_list, dtype=torch.int32)
            tables = torch.zeros((b, nt), dtype=torch.int32)
            for i in range(b):
                n_live = int(pos[i]) // bs + 1
                tables[i, :n_live] = 1 + i * nt + torch.randperm(
                    nt, generator=torch.Generator().manual_seed(i))[:n_live]
            tables, pos = tables.to(dev), pos.to(dev)
            q = randn((b, h, d), bf16)
            kw = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)
            out = paged_decode_attention(q, k_pool, v_pool, tables, pos, **kw)
            ref = paged_decode_attention_ref(q, k_pool, v_pool, tables, pos,
                                             **kw)
            flat_kw = dict(scale=d ** -0.5)
            if quant:
                flat_kw.update(k_scale=gather_logical(ks, tables, rows),
                               v_scale=gather_logical(vs, tables, rows))
            fk = gather_logical(k_pool, tables, rows)
            fv = gather_logical(v_pool, tables, rows)
            flat = kv_decode_attention(q, fk, fv, pos, **flat_kw)
            flat_ref = kv_decode_attention_ref(q, fk, fv, pos, **flat_kw)
            alone = [paged_decode_attention(
                q[i:i + 1].clone(), k_pool, v_pool, tables[i:i + 1].clone(),
                pos[i:i + 1].clone(), **kw) for i in range(b)]
            sync()
            name = "paged_decode_int8" if quant else "paged_decode"
            err = limit_err(out, ref, "bf16", f"{name} pos={pos_list}")
            err6 = limit_err(flat, flat_ref, "bf16",
                             f"kv_decode int8={quant} pos={pos_list}")
            if not torch.equal(out, flat):
                raise AssertionError(f"{name} pos={pos_list}: differs from "
                                     f"kv_decode on the gathered view")
            for i in range(b):
                if not torch.equal(alone[i][0], out[i]):
                    raise AssertionError(f"{name} pos={pos_list}: row {i} "
                                         f"alone differs from the batch")
            emit("kernel_decode_spans", kernel=name, span=span,
                 pos=pos_list, block_size=bs, table_width=nt,
                 max_abs_err=err, kv_decode_max_abs_err=err6,
                 paged_equals_contiguous=True, row_alone_equals_batch=True)
            del k_pool, v_pool, ks, vs, fk, fv, flat_kw


def serve_int8_exact(dev) -> None:
    """The int8 engine's exactness on the card at f32 (serve_exact's
    config): int8 weights (``quantize_params``) and an int8 pool. The
    engine through K7-int8, the engine through the gather path (K6), and
    solo ``greedy_decode`` (K6) must give EQUAL tokens, for two prompt
    sets. Prompts longer than 64 tokens take the same dequantised product
    in the solo prefill as in the engine's admissions (``_kernel_ok``:
    M > 64), so those are equal by construction; the short prompts' solo
    prefill runs K8 where the admission runs cuBLAS, so theirs hold only
    while that difference moves no token."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        greedy_decode,
        init_params,
        make_serve_engine,
        quantize_params,
    )

    f32 = torch.float32
    cfg = BurnInConfig(vocab=512, d_model=256, n_heads=2, n_kv_heads=1,
                       d_ff=512, n_layers=2, dtype=f32, attn="flash")
    qparams = quantize_params(init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), device=dev),
        dtype=f32)
    pg = torch.Generator().manual_seed(2)
    sets = {"long": [torch.randint(0, cfg.vocab, (n,), generator=pg)
                     for n in (80, 96, 72, 128, 88)],
            "short": [torch.randint(0, cfg.vocab, (n,), generator=pg)
                      for n in (16, 24, 8, 32, 16)]}
    rec = {}
    for name, prompts in sets.items():
        kw = dict(max_len=144, kv_block=KV_BLOCK, cache_dtype="int8",
                  device=dev)
        with_kernels = make_serve_engine(qparams, cfg, **kw)(prompts, 8,
                                                             slots=2)
        gather = make_serve_engine(qparams, cfg, paged_kernel="off", **kw)(
            prompts, 8, slots=2)
        solo = [greedy_decode(qparams, p[None], 8, cfg, cache_dtype="int8",
                              device=dev)[0] for p in prompts]
        rec[name] = [torch.equal(a, c) and torch.equal(g, c)
                     for a, g, c in zip(with_kernels, gather, solo)]
    emit("serve_int8_exact", requests=len(sets["long"]), equal=rec["long"],
         short_prompts_equal=rec["short"])
    if not all(rec["long"] + rec["short"]):
        raise AssertionError(f"serve_int8_exact: tokens differ {rec}")


def _exact_cfg(attn: str = "flash"):
    """serve_exact's f32 configuration (head_dim 128, the kernels' widths
    at a small size)."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import BurnInConfig

    return BurnInConfig(vocab=512, d_model=256, n_heads=2, n_kv_heads=1,
                        d_ff=512, n_layers=2, dtype=torch.float32, attn=attn)


def _seeded_pool(cfg, dev, slots, max_len, cache_dtype, seed):
    """A pool of seeded rows (int8 rows and scales in an int8 pool), slot i
    mapped to its own blocks, one spare block, ragged positions."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        init_paged_cache,
        paged_pool_spec,
    )

    nt = paged_pool_spec(cfg, max_len, KV_BLOCK, cache_dtype)["tables"]
    pool = init_paged_cache(cfg, slots, max_len, block_size=KV_BLOCK,
                            num_blocks=2 + slots * nt,
                            cache_dtype=cache_dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for key in ("k", "v"):
        for buf in pool[key]:
            if buf.dtype == torch.int8:
                buf.copy_(torch.randint(-127, 128, buf.shape, generator=g,
                                        device=dev))
            else:
                buf.copy_(torch.randn(buf.shape, generator=g, device=dev))
    for key in ("k_scale", "v_scale"):
        for buf in pool.get(key, []):
            buf.copy_(torch.rand(buf.shape, generator=g, device=dev) / 64)
    for i in range(slots):
        pool["block_tables"][i] = torch.arange(1 + i * nt, 1 + (i + 1) * nt,
                                               dtype=torch.int32)
    pool["pos"].copy_(torch.arange(slots, dtype=torch.int32) * 13 + 5)
    return pool


def serve_graph_exact(dev) -> None:
    """The wave replayed from its captured CUDA graph against the eager
    wave, at f32 (serve_exact's config), with a bf16 pool and with int8
    weights and an int8 pool. (1) The captured wave and the eager step on a
    copy of the pool, fed the same tokens, a change of the active set and
    a table rewrite between waves: equal tokens every wave, equal pool
    bytes after. (2) The engine (every wave a replay) equals the gather
    engine and solo ``greedy_decode``. (3) A second run of the engine
    captures nothing new and gives the same tokens."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        init_params,
        make_serve_engine,
        quantize_params,
    )

    cfg = _exact_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    pg = torch.Generator().manual_seed(2)
    cases = {
        "bf16": (params, "bf16", 48,
                 [torch.randint(0, cfg.vocab, (n,), generator=pg)
                  for n in (16, 24, 8, 32, 16)]),
        "int8": (quantize_params(params, dtype=torch.float32), "int8", 144,
                 [torch.randint(0, cfg.vocab, (n,), generator=pg)
                  for n in (80, 96, 72, 128, 88)])}
    for name, (p, cache_dtype, max_len, prompts) in cases.items():
        kw = dict(max_len=max_len, kv_block=KV_BLOCK, cache_dtype=cache_dtype,
                  device=dev)
        engine = make_serve_engine(p, cfg, **kw)
        pool = _seeded_pool(cfg, dev, 4, max_len, cache_dtype, seed=3)
        graph = engine.capture(pool)   # its warm-up writes the garbage block
        twin = {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone()) for k, v in pool.items()}
        toks = torch.tensor([3, 77, 501, 9], device=dev)
        active = torch.tensor([True, True, False, True], device=dev)
        graph.tokens.copy_(toks)
        graph.active.copy_(active)
        waves_equal = []
        for wave in range(8):
            if wave == 3:
                active = torch.tensor([False, True, True, True], device=dev)
                graph.active.copy_(active)
            if wave == 5:
                spare = pool["block_tables"].shape[1] * 4 + 1
                for q in (pool, twin):
                    q["block_tables"][1, 2] = spare
            graph.replay()
            toks = engine.step(toks, active, twin)
            waves_equal.append(torch.equal(graph.tokens, toks))
        pool_equal = all(
            torch.equal(a, b)
            for key, val in pool.items()
            for a, b in zip(val if isinstance(val, list) else [val],
                            twin[key] if isinstance(val, list)
                            else [twin[key]]))
        got = engine(prompts, 8, slots=2)
        captures = engine.captures
        again = engine(prompts, 8, slots=2)
        gather = make_serve_engine(p, cfg, paged_kernel="off", **kw)(
            prompts, 8, slots=2)
        solo = [greedy_decode(p, x[None], 8, cfg, cache_dtype=cache_dtype,
                              device=dev)[0] for x in prompts]
        equal = [torch.equal(a, c) and torch.equal(g, c)
                 and torch.equal(b, c)
                 for a, b, g, c in zip(got, again, gather, solo)]
        emit("serve_graph_exact", pool=name, replay_launches=graph.launches,
             waves_equal=waves_equal, pool_bytes_equal=pool_equal,
             engine_equal=equal, captures_after_first_run=captures,
             captures_after_second_run=engine.captures)
        if not (all(waves_equal) and pool_equal and all(equal)
                and captures == engine.captures == 1):
            raise AssertionError(f"serve_graph_exact {name}: replay differs "
                                 f"from the eager wave")
        del engine, pool, twin, graph


def serve_levers_exact(dev) -> None:
    """Each scheduler lever alone, and composed, at f32 on the card (every
    wave a graph replay). On a dense-attention config every prefill path —
    whole, chunked, shared-suffix, after a template — is the same exact
    dense math, so each run's tokens must EQUAL the unlevered engine's and
    solo ``greedy_decode``'s (the template prefix's: of ``concat(prefix,
    prompt)``); on the flash config chunked prefill equals a solo decode
    with ``prefill="dense"``. The pool drains (to the template's blocks
    with a prefix); sharing must hit."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        init_params,
        make_serve_engine,
    )

    cfg = _exact_cfg("dense")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                         device=dev)
    pg = torch.Generator().manual_seed(5)
    tmpl = [torch.randint(0, cfg.vocab, (40,), generator=pg)
            for _ in range(2)]
    prompts = [torch.cat([tmpl[i % 2], torch.randint(
        0, cfg.vocab, (3 + 7 * (i % 4),), generator=pg)]) for i in range(8)]
    budgets = [6, 12, 4, 9, 7, 12, 5, 10]
    max_len = 96
    prefix = torch.randint(0, cfg.vocab, (21,), generator=pg)

    def solo(prompt, n, eos=None, pre=None, prefill="auto", c=cfg, p=params):
        full = prompt if pre is None else torch.cat([pre, prompt])
        out = greedy_decode(p, full[None], n, c, prefill=prefill,
                            device=dev)[0]
        if eos is not None:
            hit = (out == eos).nonzero()
            out = out[:int(hit[0]) + 1] if len(hit) else out
        return out

    base = make_serve_engine(params, cfg, max_len=max_len, kv_block=KV_BLOCK,
                             device=dev)
    plain = base(prompts, budgets, slots=3)
    eos = int(plain[1][4])
    plain_eos = base(prompts, budgets, slots=3, eos_id=eos)
    full = 1 + 3 * -(-max_len // KV_BLOCK)
    tight = 1 + -(-max_len // KV_BLOCK) + 2
    levers = {
        "eos_check_every": ({}, dict(eos_id=eos, eos_check_every=4)),
        "sjf": ({"policy": "sjf"}, {}),
        "priority": ({"policy": "priority", "aging": 3},
                     dict(priorities=[0, 0, 5, 1, 0, 9, 0, 2])),
        "prefill_chunk": ({"prefill_chunk": 16}, {}),
        "prefix": ({"prefix": prefix}, {}),
        "prefix_chunked": ({"prefix": prefix, "prefill_chunk": 16}, {}),
        "share_prefix": ({"share_prefix": True}, {}),
        "prefix_keep_blocks_0": ({"share_prefix": True,
                                  "prefix_keep_blocks": 0}, {}),
        "lazy_growth": ({"lazy_growth": True}, dict(kv_blocks=tight)),
        "composed": ({"share_prefix": True, "prefill_chunk": 16,
                      "lazy_growth": True, "policy": "sjf"},
                     dict(kv_blocks=tight, eos_id=eos)),
        "composed_lagged": ({"share_prefix": True, "prefill_chunk": 16,
                             "policy": "sjf"},
                            dict(eos_id=eos, eos_check_every=4,
                                 kv_blocks=(full + tight) // 2)),
    }
    records = {}
    for name, (ekw, rkw) in levers.items():
        engine = make_serve_engine(params, cfg, max_len=max_len + 32
                                   if "prefix" in ekw else max_len,
                                   kv_block=KV_BLOCK, device=dev, **ekw)
        got = engine(prompts, budgets, slots=3, **rkw)
        st = engine.last_stats
        e = rkw.get("eos_id")
        if "prefix" in ekw:
            want = [solo(x, n, e, pre=prefix) for x, n in zip(prompts,
                                                               budgets)]
            drained = st["kv"]["in_use"] == -(-len(prefix) // KV_BLOCK)
        else:
            want = plain_eos if e is not None else plain
            drained = st["kv"]["in_use"] == 0
            solo_eq = all(torch.equal(g, solo(x, n, e)) for g, x, n in
                          zip(got, prompts, budgets))
        equal = [torch.equal(g, w) for g, w in zip(got, want)]
        rec = dict(equal=equal, drained=drained, waves=st["waves"],
                   hit_blocks=st["prefix"]["hit_blocks"],
                   blocks_grown_lazy=st["kv"]["blocks_grown_lazy"],
                   preempted=st["sched"]["preempted"],
                   high_water=st["kv"]["high_water"])
        if "prefix" not in ekw:
            rec["solo_equal"] = solo_eq
        records[name] = rec
        ok = all(equal) and drained and rec.get("solo_equal", True) and (
            not ekw.get("share_prefix") or rec["hit_blocks"] > 0)
        if not ok:
            emit("serve_levers_exact", levers=records)
            raise AssertionError(f"serve_levers_exact {name}: {rec}")
    # the reference's flash-config gate: chunked admission runs the exact
    # dense math, so it equals solo decode with the dense prefill
    fcfg = _exact_cfg("flash")
    fparams = init_params(fcfg, torch.Generator(device=dev).manual_seed(6),
                          device=dev)
    got = make_serve_engine(fparams, fcfg, max_len=max_len,
                            kv_block=KV_BLOCK, prefill_chunk=16,
                            device=dev)(prompts, budgets, slots=3)
    records["flash_chunked_vs_dense_solo"] = dict(equal=[
        torch.equal(g, solo(x, n, prefill="dense", c=fcfg, p=fparams))
        for g, x, n in zip(got, prompts, budgets)])
    emit("serve_levers_exact", requests=len(prompts), eos_id=eos,
         tight_kv_blocks=tight, levers=records)
    if not all(records["flash_chunked_vs_dense_solo"]["equal"]):
        raise AssertionError("serve_levers_exact: flash-config chunked "
                             "prefill differs from dense solo decode")


def serve_levers_flagship(params, cfg, dev) -> dict:
    """All greedy levers composed at the flagship width (bf16): Zipf
    template traffic (``shared_prefix_prompts``), ragged budgets, 4 slots,
    a pool at ``LEVER_POOL_SHARE`` of full provisioning, cross-request
    sharing, chunked prefill of ``LEVER_CHUNK``, lazy growth and sjf;
    against the same traffic through the unlevered engine. bf16 products
    differ between a chunked and a whole prefill, so the share of equal
    tokens is reported, not held; the structure is held: every budget
    served, tokens in the vocabulary, the pool drained, K7 once a layer a
    wave."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        make_serve_engine,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync
    from nvidia_terraform_modules_tpu_torch.utils.traffic import (
        ragged_lengths,
        shared_prefix_prompts,
    )

    pairs = shared_prefix_prompts(LEVER_REQUESTS, SEED, n_templates=4,
                                  template_len=256, suffix_lo=16,
                                  suffix_hi=128, vocab=cfg.vocab,
                                  block_size=KV_BLOCK)
    prompts = [torch.tensor(p, device=dev) for _, p in pairs]
    budgets = ragged_lengths(LEVER_REQUESTS, SEED, lo=16, hi=64)
    max_len = max(max(len(p) + n, -(-len(p) // LEVER_CHUNK) * LEVER_CHUNK)
                  for (_, p), n in zip(pairs, budgets))
    nt = -(-max_len // KV_BLOCK)
    full = 1 + SLOTS * nt
    kv_blocks = max(round(LEVER_POOL_SHARE * full), 1 + nt)
    engine = make_serve_engine(params, cfg, max_len=max_len,
                               kv_block=KV_BLOCK, share_prefix=True,
                               prefill_chunk=LEVER_CHUNK, lazy_growth=True,
                               policy="sjf", device=dev)
    engine(prompts[:SLOTS], 4, slots=SLOTS, kv_blocks=kv_blocks)  # warm-up
    sync()
    _build.reset_launches()
    t0 = time.monotonic()
    outs = engine(prompts, budgets, slots=SLOTS, kv_blocks=kv_blocks)
    sync()
    wall_s = time.monotonic() - t0
    launches = dict(_build.launches)
    st = engine.last_stats
    base = make_serve_engine(params, cfg, max_len=max_len,
                             kv_block=KV_BLOCK, device=dev)
    plain = base(prompts, budgets, slots=SLOTS)
    if launches["paged_decode"] != st["waves"] * cfg.n_layers:
        raise AssertionError(f"serve_levers_flagship: paged_decode launched "
                             f"{launches['paged_decode']} times, expected "
                             f"{st['waves']} waves x {cfg.n_layers} layers")
    for o, n in zip(outs, budgets):
        if o.shape != (n,) or int(o.min()) < 0 or int(o.max()) >= cfg.vocab:
            raise AssertionError(f"serve_levers_flagship: bad output "
                                 f"{o.shape} for budget {n}")
    if st["kv"]["in_use"] != 0 or st["prefix"]["hit_blocks"] <= 0:
        raise AssertionError(f"serve_levers_flagship: pool {st['kv']}, "
                             f"prefix {st['prefix']}")
    tok_eq = sum(int((a == b).sum()) for a, b in zip(outs, plain))
    return dict(params=sum(p.numel() for p in tree_leaves(params)),
                requests=st["requests"], generated=st["generated"],
                prompt_lens=[len(p) for _, p in pairs],
                templates=[t for t, _ in pairs], budgets=budgets,
                max_len=max_len, kv_blocks=kv_blocks,
                kv_blocks_full=full, waves=st["waves"], wall_s=wall_s,
                tokens_per_s=st["generated"] / wall_s,
                latency_ms=st["latency_ms"], prefix=st["prefix"],
                kv=st["kv"], sched={k: v for k, v in st["sched"].items()
                                    if k != "admit_wave_of"},
                launches=launches,
                tokens_equal_unlevered_frac=tok_eq / sum(budgets),
                requests_equal_unlevered=sum(
                    torch.equal(a, b) for a, b in zip(outs, plain)))


def _watch(module, owner: str, name: str, wrap):
    """Replace ``module.owner.name`` (a class attribute) by ``wrap(orig)``;
    returns a function that puts the original back."""
    cls = getattr(module, owner)
    orig = getattr(cls, name)
    setattr(cls, name, wrap(orig))
    return lambda: setattr(cls, name, orig)


def serve_spill_exact(dev) -> dict:
    """The host KV tier at f32 on the card (dense-attention config, where
    every prefill path is the same exact math): the reference's gate —
    template traffic, ``prefix_keep_blocks=0`` so every retirement spills —
    at slots 1 and 2, async and sync swaps, the f32 pool and the int8
    cache. Each run's tokens must equal the engine's without the tier and
    solo greedy decoding (int8: solo int8-cache decoding) bit for bit, with
    swap-ins and spilled blocks, both pools drained, K7 (K7-int8) launched
    once a layer a wave, and the pool's tensors at the addresses the
    captured wave reads (checked at every import). Then a planted fault:
    one byte of the first stored host block flipped after its stamp must
    end in ``corrupt_dropped == 1`` with the tokens unchanged. Returns the
    record (with the int8 runs' K7-int8 launches)."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        hostkv,
        init_params,
        make_serve_engine,
    )
    from nvidia_terraform_modules_tpu_torch.models import serving as smod
    from nvidia_terraform_modules_tpu_torch.ops import _build

    cfg = _exact_cfg("dense")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(8),
                         device=dev)
    pg = torch.Generator().manual_seed(9)
    tmpl = [torch.randint(0, cfg.vocab, (40,), generator=pg)
            for _ in range(2)]
    prompts = [torch.cat([tmpl[i % 2], torch.randint(
        0, cfg.vocab, (3 + 5 * (i % 3),), generator=pg)]).to(dev)
        for i in range(6)]
    budgets = [6, 9, 4, 8, 5, 7]
    max_len = 80
    spill = dict(max_len=max_len, kv_block=KV_BLOCK, share_prefix=True,
                 prefix_keep_blocks=0, device=dev)
    # every import must write into the pool's own tensors
    in_place = []
    orig_import = smod.import_block_rows

    def watched(pool, ids, payload):
        ptrs = [b.data_ptr() for k in ("k", "v") for b in pool[k]]
        out = orig_import(pool, ids, payload)
        in_place.append(out is pool and ptrs == [
            b.data_ptr() for k in ("k", "v") for b in pool[k]])
        return out
    smod.import_block_rows = watched
    records, k7i8 = {}, 0
    try:
        for cache_dtype in ("bf16", "int8"):
            kernel = "paged_decode" + ("_int8" if cache_dtype == "int8"
                                       else "")
            solo = [greedy_decode(params, p[None], n, cfg,
                                  cache_dtype=cache_dtype, device=dev)[0]
                    for p, n in zip(prompts, budgets)]
            base = make_serve_engine(params, cfg, cache_dtype=cache_dtype,
                                     **spill)
            for host_swap in ("async", "sync"):
                engine = make_serve_engine(
                    params, cfg, cache_dtype=cache_dtype, host_spill=True,
                    host_swap=host_swap, **spill)
                for slots in (1, 2):
                    plain = base(prompts, budgets, slots=slots)
                    engine(prompts[:1], 2, slots=slots)   # capture, warm-up
                    before = _build.launches[kernel]
                    got = engine(prompts, budgets, slots=slots)
                    st = engine.last_stats
                    sp = st["prefix"]["spill"]
                    k7 = _build.launches[kernel] - before
                    if cache_dtype == "int8":
                        k7i8 += k7
                    rec = dict(
                        equal_no_spill=[torch.equal(a, b)
                                        for a, b in zip(got, plain)],
                        equal_solo=[torch.equal(a, b)
                                    for a, b in zip(got, solo)],
                        waves=st["waves"], launches=k7,
                        **{k: sp[k] for k in (
                            "spilled_blocks", "swapins", "swapped_blocks",
                            "host_hit_blocks", "corrupt_dropped",
                            "host_in_use", "host_high_water")},
                        kv_in_use=st["kv"]["in_use"])
                    records[f"{cache_dtype}_{host_swap}_slots{slots}"] = rec
                    if not (all(rec["equal_no_spill"])
                            and all(rec["equal_solo"])
                            and sp["swapins"] >= 1
                            and sp["spilled_blocks"] > 0
                            and sp["corrupt_dropped"] == 0
                            and sp["host_in_use"] == 0
                            and st["kv"]["in_use"] == 0
                            and k7 == st["waves"] * cfg.n_layers
                            and in_place and all(in_place)):
                        emit("serve_spill_exact", runs=records)
                        raise AssertionError(
                            f"serve_spill_exact {cache_dtype} {host_swap} "
                            f"slots {slots}: {rec}, imports in place "
                            f"{in_place}")
                del engine
        # the planted fault: one byte of the first stored block flipped
        planted = []

        def flipping(store):
            def wrapped(self, pool, dev_blocks):
                hids = store(self, pool, dev_blocks)
                if hids and not planted:
                    self._bufs["k"][0][hids[0]].view(torch.uint8).view(
                        -1)[0] ^= 1
                    planted.append(hids[0])
                return hids
            return wrapped
        faults = {}
        base = make_serve_engine(params, cfg, **spill)
        plain = base(prompts, budgets, slots=1)
        for host_swap in ("async", "sync"):
            planted.clear()
            restore = _watch(hostkv, "HostBlockPool", "store", flipping)
            try:
                engine = make_serve_engine(params, cfg, host_spill=True,
                                           host_swap=host_swap, **spill)
                got = engine(prompts, budgets, slots=1)
            finally:
                restore()
            sp = engine.last_stats["prefix"]["spill"]
            faults[host_swap] = dict(
                planted=bool(planted), corrupt_dropped=sp["corrupt_dropped"],
                equal_no_spill=[torch.equal(a, b)
                                for a, b in zip(got, plain)],
                swapins=sp["swapins"])
            if not (planted and sp["corrupt_dropped"] == 1
                    and all(faults[host_swap]["equal_no_spill"])):
                emit("serve_spill_exact", runs=records, faults=faults)
                raise AssertionError(f"serve_spill_exact: the planted crc "
                                     f"fault was not classified: {faults}")
    finally:
        smod.import_block_rows = orig_import
    return dict(requests=len(prompts), budgets=budgets,
                imports_in_place=len(in_place), runs=records,
                planted_faults=faults, int8_launches=k7i8)


def serve_spill_flagship(params, cfg, dev, smi: str) -> tuple[dict, dict]:
    """The host KV tier at the flagship width (bf16, nothing cut) on
    ``serve_levers_flagship``'s traffic (16 requests, 4 Zipf templates of
    256 tokens, suffixes of 16–128, budgets 16–64), 4 slots, a pool at
    ``LEVER_POOL_SHARE`` of full provisioning, ``prefix_keep_blocks=0`` so
    every eviction crosses the tier, ``host_blocks=512``. Four engines in
    turns, ``SPILL_TURNS`` times: the spilling engine (async, then sync
    swaps), the same engine without the tier (every repeat prefilled
    again) and one whose index keeps the whole working set (keep 512, a
    pool that holds it). Each run's launch counts start at 0; held: every
    budget served, tokens in the vocabulary, both pools drained, no
    corrupt drop, swap-ins, K7 once a layer a wave. Reported: the tier's
    counts, ms a block swapped in (host clock, the engine's ``swap_ms``)
    and spilled (timed around the index's spill adapter), crc ms a block,
    device ms of prefill an admission (CUDA events around each prefill
    forward), tokens/s and latency of each engine (median and min–max),
    and which requests equal the keep-everything engine's, with the blocks
    each matched in both. Returns the record and the spilling engine's
    last launch counts."""
    import threading

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        hostkv,
        make_serve_engine,
        paging,
    )
    from nvidia_terraform_modules_tpu_torch.models import serving as smod
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync
    from nvidia_terraform_modules_tpu_torch.utils.traffic import (
        ragged_lengths,
        shared_prefix_prompts,
    )

    pairs = shared_prefix_prompts(LEVER_REQUESTS, SEED, n_templates=4,
                                  template_len=256, suffix_lo=16,
                                  suffix_hi=128, vocab=cfg.vocab,
                                  block_size=KV_BLOCK)
    prompts = [torch.tensor(p, device=dev) for _, p in pairs]
    budgets = ragged_lengths(LEVER_REQUESTS, SEED, lo=16, hi=64)
    max_len = max(len(p) + n for (_, p), n in zip(pairs, budgets))
    nt = -(-max_len // KV_BLOCK)
    full = 1 + SLOTS * nt
    kv_blocks = max(round(LEVER_POOL_SHARE * full), 1 + nt)
    kw = dict(max_len=max_len, kv_block=KV_BLOCK, share_prefix=True,
              device=dev)
    engines = {
        "spill_async": (make_serve_engine(
            params, cfg, prefix_keep_blocks=0, host_spill=True,
            host_blocks=SPILL_HOST_BLOCKS, host_swap="async", **kw),
            kv_blocks),
        "spill_sync": (make_serve_engine(
            params, cfg, prefix_keep_blocks=0, host_spill=True,
            host_blocks=SPILL_HOST_BLOCKS, host_swap="sync", **kw),
            kv_blocks),
        "no_spill": (make_serve_engine(params, cfg, prefix_keep_blocks=0,
                                       **kw), kv_blocks),
        # every request's whole table can stay retained
        "keep_all": (make_serve_engine(params, cfg,
                                       prefix_keep_blocks=SPILL_HOST_BLOCKS,
                                       **kw),
                     full + LEVER_REQUESTS * nt)}
    # instruments: the spill adapter's host time and blocks, the crc's
    # host time and blocks (store stamps and load checks, the worker's
    # too), each prefill forward's device time, each match's blocks
    lock = threading.Lock()
    meter = {"spill_ms": 0.0, "spill_blocks": 0, "crc_ms": 0.0,
             "crc_blocks": 0}
    events: list = []
    matched: dict = {}

    def time_spill(store):
        def wrapped(self, dev_blocks):
            t0 = time.monotonic()
            hids = store(self, dev_blocks)
            if hids:
                meter["spill_ms"] += (time.monotonic() - t0) * 1e3
                meter["spill_blocks"] += len(hids)
            return hids
        return wrapped

    def time_crc(crc):
        def wrapped(self, bufs, i):
            t0 = time.monotonic()
            out = crc(self, bufs, i)
            with lock:
                meter["crc_ms"] += (time.monotonic() - t0) * 1e3
                meter["crc_blocks"] += 1
            return out
        return wrapped

    def note_match(match_tiered):
        def wrapped(self, chunks, *, host=True):
            blocks, tail = match_tiered(self, chunks, host=host)
            matched[tuple(chunks)] = (len(blocks), len(tail))
            return blocks, tail
        return wrapped

    orig_fp = smod.forward_paged

    def timed_forward(p, tokens, *a, **k):
        if tokens.shape[-1] == 1:
            return orig_fp(p, tokens, *a, **k)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        out = orig_fp(p, tokens, *a, **k)
        end.record()
        events.append((start, end))
        return out

    restores = [_watch(hostkv, "IndexSpill", "store", time_spill),
                _watch(hostkv, "HostBlockPool", "_block_crc", time_crc),
                _watch(paging, "PrefixIndex", "match_tiered", note_match)]
    smod.forward_paged = timed_forward
    try:
        for name, (engine, blocks) in engines.items():
            engine(prompts[:SLOTS], 4, slots=SLOTS, kv_blocks=blocks)
        sync()
        runs = {name: [] for name in engines}
        last = {}
        for _turn in range(SPILL_TURNS):
            for name, (engine, blocks) in engines.items():
                for key in meter:
                    meter[key] = 0 if isinstance(meter[key], int) else 0.0
                events.clear()
                matched.clear()
                _build.reset_launches()
                t0 = time.monotonic()
                outs = engine(prompts, budgets, slots=SLOTS,
                              kv_blocks=blocks)
                sync()
                wall_s = time.monotonic() - t0
                launches = dict(_build.launches)
                st = engine.last_stats
                prefill_ms = sum(a.elapsed_time(b) for a, b in events)
                sp = st["prefix"]["spill"]
                for o, n in zip(outs, budgets):
                    if o.shape != (n,) or int(o.min()) < 0 \
                            or int(o.max()) >= cfg.vocab:
                        raise AssertionError(f"serve_spill_flagship {name}: "
                                             f"bad output {o.shape}")
                if st["kv"]["in_use"] != 0 or sp["host_in_use"] != 0 \
                        or sp["corrupt_dropped"] != 0 \
                        or launches["paged_decode"] != \
                        st["waves"] * cfg.n_layers \
                        or launches["flash_fwd"] <= 0 \
                        or (sp["enabled"] and sp["swapins"] < 1):
                    raise AssertionError(
                        f"serve_spill_flagship {name}: kv {st['kv']}, "
                        f"spill {sp}, launches {launches}")
                runs[name].append(dict(
                    wall_s=wall_s, tokens_per_s=st["generated"] / wall_s,
                    latency_ms=st["latency_ms"], waves=st["waves"],
                    prefill_ms_per_admission=prefill_ms / len(events),
                    prefill_forwards=len(events),
                    tokens_saved=st["prefix"]["tokens_saved"],
                    hit_blocks=st["prefix"]["hit_blocks"],
                    launches=launches, spill=sp, **{
                        k: meter[k] for k in meter}))
                last[name] = (outs, dict(matched))
    finally:
        for restore in restores:
            restore()
        smod.forward_paged = orig_fp
        del engines

    def chunks_of(p):
        toks = [int(t) for t in p]
        chunks = paging.chain_chunks(toks, KV_BLOCK)
        while chunks and len(chunks) * KV_BLOCK > len(toks) - 1:
            chunks.pop()
        return tuple(chunks)

    keep_outs, keep_match = last["keep_all"]
    per_request = {}
    for name in ("spill_async", "spill_sync", "no_spill"):
        outs, m = last[name]
        rows = []
        for i, (p, a, b) in enumerate(zip(prompts, outs, keep_outs)):
            c = chunks_of(p)
            rows.append(dict(request=i, equal=bool(torch.equal(a, b)),
                             matched=sum(m.get(c, (0, 0))),
                             matched_keep_all=keep_match.get(c, (0, 0))[0]))
        per_request[name] = rows

    def summary(name):
        recs = runs[name]

        def med(key, sub=None):
            vals = sorted(r[key] if sub is None else r[key][sub]
                          for r in recs)
            return {"median": vals[len(vals) // 2], "min": vals[0],
                    "max": vals[-1]}
        out = dict(tokens_per_s=med("tokens_per_s"),
                   p50_ms=med("latency_ms", "p50"),
                   p99_ms=med("latency_ms", "p99"),
                   prefill_ms_per_admission=med("prefill_ms_per_admission"),
                   tokens_saved=recs[-1]["tokens_saved"],
                   hit_blocks=recs[-1]["hit_blocks"],
                   prefill_forwards=recs[-1]["prefill_forwards"],
                   waves=recs[-1]["waves"], launches=recs[-1]["launches"])
        if name != "keep_all":
            rows = per_request[name]
            out["tokens_equal_keep_all_frac"] = sum(
                int((a == b).sum()) for a, b in zip(
                    last[name][0], keep_outs)) / sum(budgets)
            out["requests_equal_keep_all"] = sum(r["equal"] for r in rows)
            out["same_match_not_equal"] = [
                r["request"] for r in rows
                if r["matched"] == r["matched_keep_all"] and not r["equal"]]
        if name.startswith("spill"):
            sp = recs[-1]["spill"]
            out.update(
                {k: sp[k] for k in ("spilled_blocks", "spill_dropped",
                                    "swapins", "swapped_blocks",
                                    "host_hit_blocks", "host_hit_frac",
                                    "swap_tokens_saved",
                                    "host_high_water")},
                swap_ms_per_block=med("spill", "swap_ms"),
                spill_ms_per_block=sorted(
                    r["spill_ms"] / max(r["spill_blocks"], 1)
                    for r in recs)[len(recs) // 2],
                crc_ms_per_block=sorted(
                    r["crc_ms"] / max(r["crc_blocks"], 1)
                    for r in recs)[len(recs) // 2])
            out["swap_ms_per_block"] = {
                k: v / max(sp["swapped_blocks"], 1)
                for k, v in out["swap_ms_per_block"].items()}
        return out

    rec = dict(nvidia_smi=smi, requests=LEVER_REQUESTS, budgets=budgets,
               prompt_lens=[len(p) for _, p in pairs],
               templates=[t for t, _ in pairs], max_len=max_len,
               kv_blocks=kv_blocks, kv_blocks_full=full,
               host_blocks=SPILL_HOST_BLOCKS,
               host_block_bytes=2 * cfg.n_layers * KV_BLOCK * cfg.kv_heads
               * cfg.head_dim * 2, turns=SPILL_TURNS,
               engines={name: summary(name) for name in runs},
               per_request=per_request)
    return rec, runs["spill_async"][-1]["launches"]


# the fleet phases: the requests of fleet_exact's flash wave, its budgets,
# and the kill of its chaos fleets (the victim's first wave stalled past
# it, so the kill lands mid-run however fast the card serves)
FLEET_BUDGETS = [6, 9, 4, 7, 5, 8, 3, 6]
FLEET_KILL_S = 0.05
FLEET_TURNS = 3


def _fleet_equal(outs, want) -> list[bool]:
    """Request by request: the fleet's tokens (on the card, or on the host
    from a process fleet) equal ``want``'s."""
    import torch

    return [o is not None and bool(torch.equal(o.to(w.device), w))
            for o, w in zip(outs, want)]


def _bring_up_behind(fleet, replicas: int):
    """Start a process fleet's children in a thread (their interpreter
    start, device set-up and weight stream overlap the work before the
    fleet's first call); join it before that call."""
    import threading

    thread = threading.Thread(target=fleet.transport.bring_up,
                              args=(range(replicas),), daemon=True)
    thread.start()
    return thread


def _fleet_sum(launches_by_fleet: dict, kernel: str) -> int:
    """A kernel's launches summed over every worker of every fleet."""
    return sum(t.get(kernel, 0) for per in launches_by_fleet.values()
               if per for t in per.values())


def _fleet_kernels(where: str, st: dict, n_layers: int, *, warm: int = 0,
                   all_flash: bool = False, need_k1: bool = True) -> int:
    """Hold a fleet's per-worker launch tallies against its workers' own
    records (``per_replica``): each decode worker K7 (or K7-int8) once a
    layer a wave (plus ``warm`` eager warm-up waves of a first call), a
    prefill worker none; every worker K1 once a layer a flash prefill it
    recorded, a disaggregated decode worker none (each of its admissions an
    import) and, with ``all_flash``, every prefilled admission a flash
    one. A killed worker's counts died with it. Returns K1 summed, which
    must not be 0 unless ``need_k1`` is off (a fleet whose every admission
    hit a store)."""
    per = st["fleet"]["launches"]
    dis = st["fleet"]["mode"] == "disaggregated"
    k1 = 0
    for rec in st["fleet"]["per_replica"]:
        if rec["flash_prefills"] is None:
            continue
        mine = per[rec["replica"]]
        k7 = mine.get("paged_decode", 0) + mine.get("paged_decode_int8", 0)
        decode = rec["role"] == "decode"
        prefilled = 0 if decode and dis else rec["requests"]
        ok = (k7 == ((rec["waves"] + warm) * n_layers if decode else 0)
              and mine.get("flash_fwd", 0) == rec["flash_prefills"] * n_layers
              and rec["flash_prefills"] <= prefilled
              and (not all_flash or rec["flash_prefills"] == prefilled)
              and (not (decode and dis)
                   or rec["kv_imports"] == rec["requests"]))
        if not ok:
            raise AssertionError(f"{where} {rec['replica']}: launches "
                                 f"{mine}, record {rec} (+{warm} warm "
                                 f"waves)")
        k1 += mine.get("flash_fwd", 0)
    if k1 == 0 and need_k1:
        raise AssertionError(f"{where}: no K1 launch")
    return k1


def fleet_exact(dev) -> tuple[dict, dict]:
    """The fleet router on the card at f32, exact. First the validation
    Job's two fleet legs on the reference's config (``serve_fleet_leg``,
    ``fleet_chaos_leg``). Then, on ``serve_exact``'s flash config (K1 in
    every whole-prompt prefill) and 8 two-template requests: a 2-replica
    affinity fleet, a disaggregated 1 + 1 fleet, a 3-replica fleet with a
    seeded ``kill_replica``, a 2-replica ``transport="multiproc"`` fleet
    whose replica 0 takes a real ``SIGKILL`` (its children brought up
    while the others run; then a single engine on the same card must still
    serve exactly), and an int8-cache 2-replica fleet
    (K7-int8). Each request's tokens must equal the single engine's and
    its solo greedy decode; each pool drains; the per-worker launch
    tallies hold (``_fleet_kernels``; in-process fleets on their second
    call, when the graphs exist). Returns the record and the launch
    tallies by fleet."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        greedy_decode,
        init_params,
        make_fleet,
        make_serve_engine,
    )
    from nvidia_terraform_modules_tpu_torch.models.fleet import (
        FleetFault,
        FleetFaultProfile,
        HashRing,
        affinity_key,
    )
    from nvidia_terraform_modules_tpu_torch.smoketest.runner import (
        fleet_chaos_leg,
        serve_fleet_leg,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    t_phase = time.monotonic()
    cfg = _exact_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(8),
                         device=dev)
    pg = torch.Generator().manual_seed(9)
    tmpl = [torch.randint(0, cfg.vocab, (32,), generator=pg)
            for _ in range(2)]
    prompts = [torch.cat([tmpl[i % 2], torch.randint(
        0, cfg.vocab, (3 + i % 5,), generator=pg)]).to(dev)
        for i in range(len(FLEET_BUDGETS))]
    budgets = FLEET_BUDGETS
    max_len = max(len(p) + n for p, n in zip(prompts, budgets))
    kw = dict(max_len=max_len, kv_block=16, device=dev)

    def kill(target):
        return FleetFaultProfile(
            [FleetFault("kill_replica", target=target, at_s=FLEET_KILL_S),
             FleetFault("slow_replica", target=target, at_s=0.0,
                        stall_s=2 * FLEET_KILL_S + 0.05, waves=1)], seed=0)

    # the process fleet's children come up while the rest runs (its victim
    # stalls too: with its child up before the call, the kill must still
    # find it mid-run)
    sigkill = make_fleet(params, cfg, **kw, replicas=2, steal=False,
                         transport="multiproc", join_timeout_s=300.0,
                         faults=kill(0))
    spawning = _bring_up_behind(sigkill, 2)

    jcfg = BurnInConfig(vocab=128, d_model=32, n_heads=4, d_ff=64,
                        n_layers=2, seq_len=16, batch=2, dtype=torch.float32)
    jparams = init_params(jcfg, torch.Generator(device=dev).manual_seed(13),
                          device=dev)
    ok_fleet, rec_fleet, state = serve_fleet_leg(jparams, jcfg, dev)
    ok_chaos, rec_chaos = fleet_chaos_leg(jparams, jcfg, dev,
                                          state["prompts"], state["base"])
    record = {"job_legs": {"serve_fleet_ok": ok_fleet,
                           "fleet_chaos_ok": ok_chaos, **rec_fleet,
                           **rec_chaos}}
    if not (ok_fleet and ok_chaos):
        raise AssertionError(f"fleet_exact: the Job's fleet legs {record}")

    want = {}
    for cache in ("bf16", "int8"):
        single = make_serve_engine(params, cfg, cache_dtype=cache, **kw)(
            prompts, budgets, slots=2)
        solo = [greedy_decode(params, p[None], n, cfg, cache_dtype=cache,
                              device=dev)[0]
                for p, n in zip(prompts, budgets)]
        if not all(torch.equal(a, b) for a, b in zip(single, solo)):
            raise AssertionError(f"fleet_exact: the single {cache} engine "
                                 f"differs from solo decoding")
        want[cache] = single
    victim = HashRing(3).target(affinity_key(prompts[0], 16))
    fleets = {
        "affinity": (dict(replicas=2, steal=False), "bf16", 2),
        "disaggregated": (dict(replicas=2, disaggregate=True), "bf16", 2),
        "kill": (dict(replicas=3, steal=False, faults=kill(victim)), "bf16",
                 2),
        "multiproc_sigkill": (sigkill, "bf16", 1),
        "int8_cache": (dict(replicas=2, steal=False, cache_dtype="int8"),
                       "int8", 2),
    }
    launches = {}
    for name, (spec, cache, calls) in fleets.items():
        t0 = time.monotonic()
        if isinstance(spec, dict):
            fleet = make_fleet(params, cfg, **kw, **spec)
        else:                                    # the process fleet
            fleet = spec
            spawning.join()
        try:
            # no synchronize: the outputs reach this stream through the
            # fleet's own stream join
            for _ in range(calls):
                outs = fleet(prompts, budgets, slots=2)
            st = fleet.last_stats
            spawns = list(getattr(fleet.transport, "spawns", []))
        finally:
            fleet.close()
        equal = _fleet_equal(outs, want[cache])
        fst = st["fleet"]
        drained = all(rs["kv"]["in_use"] == 0
                      for rs in st["replica_stats"] if rs is not None)
        down = (fst["faults"] or {}).get("replica_down", 0)
        record[name] = dict(
            seconds=time.monotonic() - t0, calls=calls, equal=equal,
            served=fst["served"], drained=drained, replica_down=down,
            killed=(fst["faults"] or {}).get("killed"),
            redriven=(fst["faults"] or {}).get("redriven"),
            launches=fst["launches"],
            waves=[None if rs is None else rs["waves"]
                   for rs in st["replica_stats"]],
            spawn_s=[s["spawn_s"] for s in spawns])
        if not all(equal) or not drained or fst["served"] != len(prompts) \
                or down != (1 if "kill" in name else 0):
            emit("fleet_exact", **record)
            raise AssertionError(f"fleet_exact {name}: {record[name]}")
        _fleet_kernels(f"fleet_exact {name}", st, cfg.n_layers,
                       warm=2 if calls == 1 else 0, all_flash=True)
        launches[name] = fst["launches"]
        if name == "multiproc_sigkill":
            # the killed child held a context on this card: the card must
            # still serve, exactly
            again = make_serve_engine(params, cfg, **kw)(prompts, budgets,
                                                         slots=2)
            sync()
            record[name]["card_serves_after_sigkill"] = all(
                torch.equal(a, b) for a, b in zip(again, want["bf16"]))
            if not record[name]["card_serves_after_sigkill"]:
                raise AssertionError("fleet_exact: the card serves "
                                     "differently after the SIGKILL")
    record["seconds"] = time.monotonic() - t_phase
    return record, launches


def serve_fleet_flagship(params, cfg, dev, smi: str) -> tuple[dict, dict]:
    """The fleet at the flagship width (bf16, nothing cut) on
    ``serve_spill_flagship``'s traffic (16 requests, 4 Zipf templates of
    256 tokens, suffixes 16–128, budgets 16–64, ``kv_block=16``), 4 slots a
    replica, ``share_prefix=True``. Five runs: the single engine, a
    2-replica affinity fleet, a 2-replica ``routing="random"`` fleet, a
    disaggregated 1 + 1 fleet and a 2-replica ``transport="multiproc"``
    fleet; each warmed once (every replica captures its wave; the process
    fleet spawns its children, their seconds and the weight stream's
    recorded), then ``FLEET_TURNS`` timed turns in rotation. Reported:
    tokens/s (median and min–max), p50/p99 latency from the call's start
    to each request's completion (every request arrives at the start: the
    fleet's arrival → completion, the single engine's ``retired_ms``), hit
    blocks and stolen requests, the share of tokens equal to the single
    engine's, the handoff's device ms a request (export and import, as the
    prefill session and the decode engine record them) and host ms of its
    crc (``_payload_crc``, the rows read back), each worker's launch
    tally, and one more turn of the single engine and of the affinity
    fleet under the profiler (device ms and busy share). Held: every
    budget served with tokens in the vocabulary, pools drained, and the
    launch tallies against the workers' records (``_fleet_kernels``)."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        make_fleet,
        make_serve_engine,
    )
    from nvidia_terraform_modules_tpu_torch.models import fleet as fmod
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync
    from nvidia_terraform_modules_tpu_torch.utils.traffic import (
        ragged_lengths,
        shared_prefix_prompts,
    )

    t_phase = time.monotonic()
    pairs = shared_prefix_prompts(LEVER_REQUESTS, SEED, n_templates=4,
                                  template_len=256, suffix_lo=16,
                                  suffix_hi=128, vocab=cfg.vocab,
                                  block_size=KV_BLOCK)
    prompts = [torch.tensor(p, device=dev) for _, p in pairs]
    budgets = ragged_lengths(LEVER_REQUESTS, SEED, lo=16, hi=64)
    max_len = max(len(p) + n for (_, p), n in zip(pairs, budgets))
    kw = dict(max_len=max_len, kv_block=KV_BLOCK, share_prefix=True)
    single = make_serve_engine(params, cfg, device=dev, **kw)
    runners = {"single": None,
               "affinity": make_fleet(params, cfg, replicas=2, **kw),
               "random": make_fleet(params, cfg, replicas=2,
                                    routing="random", **kw),
               "disaggregated": make_fleet(params, cfg, replicas=2,
                                           disaggregate=True, **kw),
               "multiproc": make_fleet(params, cfg, replicas=2,
                                       transport="multiproc",
                                       join_timeout_s=600.0, **kw)}

    def run(name, prompts_, budgets_):
        if name == "single":
            return single(prompts_, budgets_, slots=SLOTS), \
                single.last_stats
        fl = runners[name]
        return fl(prompts_, budgets_, slots=SLOTS), fl.last_stats

    turns = {name: [] for name in runners}
    last = {}
    try:
        # the process fleet's children come up behind the other warm-ups
        spawning = _bring_up_behind(runners["multiproc"], 2)
        warm = {}
        for name in runners:
            if name == "multiproc":
                spawning.join()
            t0 = time.monotonic()
            run(name, prompts, [4] * len(prompts))
            sync()
            warm[name] = time.monotonic() - t0
        spawns = list(runners["multiproc"].transport.spawns)
        for _turn in range(FLEET_TURNS):
            for name in runners:
                sync()
                t0 = time.monotonic()
                outs, st = run(name, prompts, budgets)
                sync()
                wall_s = time.monotonic() - t0
                gen = sum(int(o.shape[0]) for o in outs)
                for o, n in zip(outs, budgets):
                    if o is None or o.shape != (n,) or int(o.min()) < 0 \
                            or int(o.max()) >= cfg.vocab:
                        raise AssertionError(f"serve_fleet_flagship {name}: "
                                             f"bad output")
                lat = (st["retired_ms"] if name == "single"
                       else st["fleet"]["latency_ms"])
                rec = dict(wall_s=wall_s, tokens_per_s=gen / wall_s,
                           p50_ms=lat["p50"], p99_ms=lat["p99"])
                if name != "single":
                    fst = st["fleet"]
                    workers = fst["per_replica"]
                    rec.update(hit_blocks=fst["affinity_hit_blocks"],
                               hit_frac=fst["affinity_hit_frac"],
                               stolen=fst["stolen"],
                               launches=fst["launches"],
                               waves=[rs["waves"]
                                      for rs in st["replica_stats"]],
                               flash_prefills=sum(
                                   r["flash_prefills"] for r in workers))
                    if name == "disaggregated":
                        n_imp = sum(r["kv_imports"] for r in workers
                                    if r["role"] == "decode")
                        rec["export_ms"] = sum(
                            r["export_ms"] for r in workers
                            if r["role"] == "prefill") / n_imp
                        rec["import_ms"] = sum(
                            r["import_ms"] for r in workers
                            if r["role"] == "decode") / n_imp
                    _fleet_kernels(f"serve_fleet_flagship {name}", st,
                                   cfg.n_layers)
                    if any(rs["kv"]["in_use"] for rs in st["replica_stats"]):
                        raise AssertionError(f"serve_fleet_flagship {name}: "
                                             f"a pool did not drain")
                else:
                    rec.update(hit_blocks=st["prefix"]["hit_blocks"],
                               waves=st["waves"],
                               flash_prefills=st["flash_prefills"])
                turns[name].append(rec)
                last[name] = outs
        # where the time goes: the single engine and the affinity fleet
        # once more each under the profiler (device time summed over the
        # replicas' streams, against the wall clock)
        from torch.profiler import ProfilerActivity, profile

        profiles = {}
        for name in ("single", "affinity"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                run(name, prompts, budgets)
                sync()
                wall_ms = (time.monotonic() - t0) * 1e3
            summary = profile_summary(prof, wall_ms)
            profiles[name] = {k: summary[k] for k in (
                "wall_ms", "device_ms", "busy_share_profiled", "gemm_ms")}
            profiles[name]["top_kernels"] = summary["top_kernels"][:5]
            profiles[name]["top_host_ops"] = summary["top_host_ops"][:6]
        # the handoff's crc, as the fault plane checks it: one session's
        # payloads, each crc read back to the host and summed
        session = runners["disaggregated"].transport.prefill_engine(
            0).prefill_session()
        crc_ms, payload_bytes = [], []
        for p in prompts:
            payload = session.prefill(p)
            payload["ready"].synchronize()
            t0 = time.monotonic()
            fmod._payload_crc(payload)
            crc_ms.append((time.monotonic() - t0) * 1e3)
            payload_bytes.append(sum(b.numel() * b.element_size()
                                     for bufs in payload["blocks"].values()
                                     for b in bufs))
        session.close()
    finally:
        runners["multiproc"].close()
    ref = last["single"]

    def med(vals):
        vals = sorted(vals)
        return {"median": vals[len(vals) // 2], "min": vals[0],
                "max": vals[-1]}

    summary = {}
    for name, recs in turns.items():
        outs = last[name]
        summary[name] = dict(
            tokens_per_s=med([r["tokens_per_s"] for r in recs]),
            p50_ms=med([r["p50_ms"] for r in recs]),
            p99_ms=med([r["p99_ms"] for r in recs]),
            hit_blocks=recs[-1]["hit_blocks"], waves=recs[-1]["waves"],
            flash_prefills=recs[-1]["flash_prefills"], warm_s=warm[name],
            tokens_equal_single_frac=sum(
                int((a.to(dev) == b).sum()) for a, b in zip(outs, ref))
            / sum(budgets),
            requests_equal_single=sum(_fleet_equal(outs, ref)),
            **({k: recs[-1][k] for k in ("stolen", "launches")}
               if name != "single" else {}))
    dis = turns["disaggregated"]
    summary["disaggregated"]["handoff_ms"] = {
        "export": med([r["export_ms"] for r in dis]),
        "import": med([r["import_ms"] for r in dis]),
        "crc": med(crc_ms), "payload_bytes_mean":
            sum(payload_bytes) / len(payload_bytes)}
    summary["multiproc"]["spawns"] = spawns
    rec = dict(nvidia_smi=smi, requests=LEVER_REQUESTS, budgets=budgets,
               prompt_lens=[len(p) for _, p in pairs], max_len=max_len,
               slots=SLOTS, turns=FLEET_TURNS, runs=summary,
               profiles=profiles, seconds=time.monotonic() - t_phase)
    return rec, {name: turns[name][-1].get("launches") for name in runners}


# the elastic plane's and the prefix CDN's phases: the Job's burst → sparse
# arrivals for the autoscaled fleets, and the flagship CDN store's RAM rows
# (fewer than the working set's, so a restarted fleet reads its tail off
# the disk tier)
SCALE_POLICY = dict(min_replicas=1, max_replicas=3, up_backlog=2.0,
                    down_backlog=0.5, cooldown_s=0.05, seed=0)
CDN_FLAGSHIP_BLOCKS, CDN_TURNS = 32, 3


def _filesystem(path: str) -> str:
    """The filesystem type ``path`` lies on, from ``/proc/mounts`` (the
    longest mount point that prefixes it)."""
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) > 2 and path.startswith(parts[1]) \
                        and len(parts[1]) > len(best):
                    best, kind = parts[1], parts[2]
    except OSError:
        pass
    return f"{kind} ({best})"


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, n))
               for root, _dirs, names in os.walk(path) for n in names)


def _joiner_hits(st: dict) -> int:
    reps = st["replica_stats"]
    initial = st["fleet"]["scale"]["initial"]
    return sum(rs["prefix"]["hit_blocks"] for i, rs in enumerate(reps)
               if rs is not None and i >= initial)


def fleet_scale_exact(dev) -> tuple[dict, dict]:
    """The elastic plane and the durable prefix CDN on the card at f32,
    exact (``fleet_exact``'s flash config and 8 two-template requests).
    First the Job's two legs (``fleet_scale_leg``, ``prefix_cdn_leg``).
    Then: an autoscaled fleet whose policy emits no event equals the fixed
    fleet byte for byte; a seeded up → down run (burst, then a sparse tail)
    equals solo decoding, and a second identical call replays the same
    events with a warm join (warm blocks seeded, joiner hits), each
    worker's K1 = flash prefills × layers and K7 = waves × layers, the
    joiners prefilling fewer of their admissions; a process fleet's warm
    join with one chain corrupted on the wire (planted: dropped and billed
    in ``seed_dropped``, tokens equal); the CDN — 2 replicas with
    ``disk_spill=`` in a temp dir, a brand-new fleet over the same dir
    restoring chains and hitting more, then one frame bitflipped (planted:
    quarantined with its reason, its chain prefilled again) — at the f32
    pool and the int8 cache (K7-int8), on ``serve_levers_exact``'s
    dense-attention config, each fleet equal to a single engine over a
    copy of its store directory (the same hits) and, at the f32 pool, to
    solo decoding. No ``degraded`` or ``quarantined`` count but the
    planted one. Returns the record and the launch tallies by fleet."""
    import shutil
    import tempfile

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        AutoscalePolicy,
        BurnInConfig,
        DiskChainStore,
        WarmChainStore,
        greedy_decode,
        init_params,
        make_fleet,
        make_serve_engine,
    )
    from nvidia_terraform_modules_tpu_torch.models import transport as tmod
    from nvidia_terraform_modules_tpu_torch.smoketest.runner import (
        fleet_scale_leg,
        prefix_cdn_leg,
    )

    t_phase = time.monotonic()
    cfg = _exact_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(8),
                         device=dev)
    pg = torch.Generator().manual_seed(9)
    tmpl = [torch.randint(0, cfg.vocab, (32,), generator=pg)
            for _ in range(2)]
    prompts = [torch.cat([tmpl[i % 2], torch.randint(
        0, cfg.vocab, (3 + i % 5,), generator=pg)]).to(dev)
        for i in range(len(FLEET_BUDGETS))]
    budgets = FLEET_BUDGETS
    max_len = max(len(p) + n for p, n in zip(prompts, budgets))
    arrivals = [0.0] * 6 + [0.4, 0.6]
    kw = dict(max_len=max_len, kv_block=16, device=dev, steal=False)
    warm_kw = dict(kw, share_prefix=True, host_spill=True, host_blocks=64,
                   prefix_keep_blocks=16, est_token_s=0.02,
                   autoscale=AutoscalePolicy(**SCALE_POLICY))
    # the process fleet's children (the base and the plan's two joiners)
    # come up while the rest runs; each joiner's spawn then finds its
    # child live
    proc = make_fleet(params, cfg, **dict(warm_kw, autoscale=AutoscalePolicy(
        **dict(SCALE_POLICY, max_replicas=2))), transport="multiproc",
        join_timeout_s=300.0)
    spawning = _bring_up_behind(proc, 3)

    jcfg = BurnInConfig(vocab=128, d_model=32, n_heads=4, d_ff=64,
                        n_layers=2, seq_len=16, batch=2, dtype=torch.float32)

    def small(seed):
        return init_params(jcfg, torch.Generator(device=dev).manual_seed(
            seed), device=dev)

    ok_scale, rec_scale = fleet_scale_leg(small(13), jcfg, dev)
    ok_cdn, rec_cdn = prefix_cdn_leg(small(23), jcfg, dev)
    record = {"job_legs": {"fleet_scale_ok": ok_scale,
                           "prefix_cdn_ok": ok_cdn, **rec_scale, **rec_cdn}}
    if not (ok_scale and ok_cdn):
        raise AssertionError(f"fleet_scale_exact: the Job's legs {record}")

    # the CDN fleets run serve_levers_exact's dense-attention config: a
    # store hit prefills its suffix by the cached math, which equals a
    # dense solo decode, a cold admission on a flash config runs K1 — at
    # the int8 cache the two round apart
    dcfg = _exact_cfg("dense")
    dparams = init_params(dcfg, torch.Generator(device=dev).manual_seed(8),
                          device=dev)
    want = {}
    for attn, c_, p_ in (("flash", cfg, params), ("dense", dcfg, dparams)):
        for cache in ("bf16", "int8"):
            single = make_serve_engine(p_, c_, cache_dtype=cache,
                                       **{k: v for k, v in kw.items()
                                          if k != "steal"})(
                prompts, budgets, slots=2)
            solo = [greedy_decode(p_, p[None], n, c_, cache_dtype=cache,
                                  device=dev)[0]
                    for p, n in zip(prompts, budgets)]
            if not all(torch.equal(a, b) for a, b in zip(single, solo)):
                raise AssertionError(f"fleet_scale_exact: the single "
                                     f"{attn} {cache} engine differs from "
                                     f"solo decoding")
            want[attn, cache] = single
    launches = {}

    def check(name, outs, cache="bf16", attn="flash"):
        equal = _fleet_equal(outs, want[attn, cache])
        if not all(equal):
            emit("fleet_scale_exact", **record)
            raise AssertionError(f"fleet_scale_exact {name}: {equal}")
        return equal

    # an armed policy that never fires: the fixed fleet, byte for byte
    t0 = time.monotonic()
    fixed = make_fleet(params, cfg, replicas=2, est_token_s=0.02, **kw)
    still = make_fleet(params, cfg, replicas=2, est_token_s=0.02,
                       autoscale=AutoscalePolicy(
                           min_replicas=2, max_replicas=4, up_backlog=1e9,
                           down_backlog=0.0, seed=3), **kw)
    a, b = fixed(prompts, budgets, slots=2), still(prompts, budgets, slots=2)
    same = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
    sst = still.last_stats["fleet"]
    record["no_event"] = dict(
        seconds=time.monotonic() - t0, equal_fixed=same,
        routed_equal=sst["routed_to"] == fixed.last_stats["fleet"][
            "routed_to"], events=sst["scale"]["events"])
    check("no_event", b)
    if not all(same) or sst["scale"]["events"] \
            or not record["no_event"]["routed_equal"]:
        raise AssertionError(f"fleet_scale_exact no_event: "
                             f"{record['no_event']}")

    # up → down, twice: the second call replays the events, joiners warm
    t0 = time.monotonic()
    elastic = make_fleet(params, cfg, replicas=1, **warm_kw)
    rounds = []
    for _ in range(2):
        outs = elastic(prompts, budgets, slots=2, arrivals=arrivals)
        st = elastic.last_stats
        sc = st["fleet"]["scale"]
        rounds.append(dict(
            equal=check("elastic", outs), events=sc["events"],
            ups=sc["ups_executed"], downs=sc["downs"],
            warm_joins=sc["warm_joins"],
            warm_blocks=sum(rs["prefix"]["warm"]["seeded_blocks"]
                            for rs in st["replica_stats"] if rs),
            joiner_hits=_joiner_hits(st),
            flash_prefills={r["replica"]: r["flash_prefills"]
                            for r in st["fleet"]["per_replica"]},
            admissions={r["replica"]: r["requests"]
                        for r in st["fleet"]["per_replica"]},
            drained=all(rs["kv"]["in_use"] == 0
                        and rs["prefix"]["spill"]["host_in_use"] == 0
                        for rs in st["replica_stats"] if rs)))
    r1, r2 = rounds
    joiners = [f"replica-{i}" for i in range(1, SCALE_POLICY[
        "max_replicas"])]
    record["elastic"] = dict(seconds=time.monotonic() - t0, rounds=rounds)
    if not (r1["ups"] >= 1 and r1["downs"] >= 1 and r2["events"]
            == r1["events"] and r2["warm_joins"] >= 1
            and r2["warm_blocks"] >= 1 and r2["joiner_hits"] > 0
            and r1["drained"] and r2["drained"]
            and sum(r2["flash_prefills"].get(j, 0) for j in joiners)
            < sum(r2["admissions"].get(j, 0) for j in joiners)):
        raise AssertionError(f"fleet_scale_exact elastic: "
                             f"{record['elastic']}")
    _fleet_kernels("fleet_scale_exact elastic", st, cfg.n_layers)
    launches["elastic"] = st["fleet"]["launches"]

    # the process fleet's warm join, one chain corrupted on the wire
    t0 = time.monotonic()
    encode = tmod.encode_warm_chains
    planted = []

    def corrupt_first(chains):
        wire = encode(chains)
        if wire and not planted:
            data = bytearray(wire[0][1]["data"][0])
            data[0] ^= 0x10
            wire[0][1]["data"][0] = bytes(data)
            planted.append(wire[0][0])
        return wire

    spawning.join()
    try:
        proc(prompts, budgets, slots=2, arrivals=arrivals)   # seeds store
        tmod.encode_warm_chains = corrupt_first
        try:
            outs = proc(prompts, budgets, slots=2, arrivals=arrivals)
        finally:
            tmod.encode_warm_chains = encode
        st = proc.last_stats
        spawns = list(proc.transport.spawns)
    finally:
        proc.close()
    sc = st["fleet"]["scale"]
    dropped = sum(rs["prefix"]["warm"]["seed_dropped"]
                  for rs in st["replica_stats"] if rs)
    record["multiproc_warm"] = dict(
        seconds=time.monotonic() - t0, equal=check("multiproc_warm", outs),
        warm_joins=sc["warm_joins"], primed=sc["warm_chains_primed"],
        seed_dropped=dropped, planted=len(planted),
        spawn_s=[(s["replica"], s["spawn_s"]) for s in spawns])
    if not (planted and dropped == 1 and sc["warm_joins"] >= 1):
        raise AssertionError(f"fleet_scale_exact multiproc_warm: "
                             f"{record['multiproc_warm']}")
    _fleet_kernels("fleet_scale_exact multiproc_warm", st, cfg.n_layers)
    launches["multiproc_warm"] = st["fleet"]["launches"]

    # the CDN: a fleet over a temp dir, a brand-new fleet over it, then a
    # planted bitflip in one frame. Each fleet equals a single engine over
    # a copy of the same store state (the same chains resident, so the same
    # hits); at the f32 pool that is solo decoding too. At the int8 cache a
    # hit's suffix prefill reads the prefix's quantised rows where a cold
    # whole-prompt prefill reads full-precision ones (the reference's
    # _prompt_attention): a request's tokens follow its hits.
    def single_over(cache, root):
        store = WarmChainStore(dcfg, 64, block_size=16, cache_dtype=cache,
                               disk=DiskChainStore(root), device=dev)
        return make_serve_engine(
            dparams, dcfg, max_len=max_len, kv_block=16, share_prefix=True,
            prefix_keep_blocks=0, cache_dtype=cache, shared_store=store,
            device=dev)(prompts, budgets, slots=2)

    def cdn_check(name, outs, ref, cache):
        equal = [bool(torch.equal(a.to(b.device), b))
                 for a, b in zip(outs, ref)]
        if cache == "bf16":
            equal = [e and s_ for e, s_ in zip(
                equal, _fleet_equal(outs, want["dense", cache]))]
        if not all(equal):
            emit("fleet_scale_exact", **record)
            raise AssertionError(f"fleet_scale_exact {name}: {equal}")

    for cache in ("bf16", "int8"):
        t0 = time.monotonic()
        spill = tempfile.mkdtemp(prefix="chip_cdn_")
        fleet_dir = os.path.join(spill, "fleet")
        ckw = dict(kw, replicas=2, share_prefix=True, prefix_keep_blocks=0,
                   cache_dtype=cache, disk_spill=fleet_dir)

        def twin(name):
            """A copy of the fleet's store directory, for a single engine."""
            root = os.path.join(spill, name)
            shutil.copytree(os.path.join(fleet_dir, "objects"),
                            os.path.join(root, "objects"))
            return root

        try:
            first = make_fleet(dparams, dcfg, **ckw)
            cdn_check(f"cdn_{cache}", first(prompts, budgets, slots=2),
                      single_over(cache, os.path.join(spill, "single0")),
                      cache)
            st1 = first.last_stats
            _fleet_kernels(f"fleet_scale_exact cdn_{cache} first", st1,
                           dcfg.n_layers, warm=2, need_k1=False)
            ref_restart = single_over(cache, twin("single1"))
            again = make_fleet(dparams, dcfg, **ckw)
            restored = again.cdn_store.disk_restored
            outs = again(prompts, budgets, slots=2)
            cdn_check(f"cdn_{cache}_restart", outs, ref_restart, cache)
            st = again.last_stats
            store = st["fleet"]["cdn"]["store"]
            frames = sorted(os.path.join(root, n)
                            for root, _d, names in os.walk(
                                os.path.join(fleet_dir, "objects"))
                            for n in names if n.endswith(".pcd"))
            raw = bytearray(open(frames[0], "rb").read())
            raw[-8] ^= 0x40
            open(frames[0], "wb").write(bytes(raw))
            ref_quarantine = single_over(cache, twin("single2"))
            third = make_fleet(dparams, dcfg, **ckw)
            cdn_check(f"cdn_{cache}_quarantine",
                      third(prompts, budgets, slots=2), ref_quarantine,
                      cache)
            disk3 = third.last_stats["fleet"]["cdn"]["store"]["disk"]
        finally:
            shutil.rmtree(spill, ignore_errors=True)
        # the blocks the admissions shared (a restored template is a hit
        # from the first admission on): more after the restart
        hits = [sum(rs["prefix"]["hit_blocks"]
                    for rs in x["replica_stats"] if rs) for x in (st1, st)]
        record[f"cdn_{cache}"] = dict(
            seconds=time.monotonic() - t0, restored=restored,
            hit_blocks_first_restart=hits,
            fetch_blocks=store["fetch_blocks"],
            disk_quarantined=store["disk"]["quarantined"],
            disk_degraded=store["disk"]["degraded"],
            planted_quarantined=disk3["quarantined"],
            planted_reasons=disk3["quarantine_reasons"],
            planted_degraded=disk3["degraded"], filesystem=_filesystem(
                tempfile.gettempdir()))
        if not (restored > 0 and store["fetch_blocks"] > 0
                and store["disk"]["quarantined"] == 0
                and store["disk"]["degraded"] == 0
                and disk3["quarantined"] == 1 and disk3["degraded"] == 0
                and "crc mismatch" in disk3["quarantine_reasons"][0]
                and hits[1] > hits[0]):
            raise AssertionError(f"fleet_scale_exact cdn_{cache}: "
                                 f"{record[f'cdn_{cache}']}")
        _fleet_kernels(f"fleet_scale_exact cdn_{cache} restart", st,
                       dcfg.n_layers, warm=2, need_k1=False)
        launches[f"cdn_{cache}"] = st["fleet"]["launches"]
    record["seconds"] = time.monotonic() - t_phase
    return record, launches


def serve_cdn_flagship(params, cfg, dev, smi: str) -> tuple[dict, dict]:
    """The durable prefix CDN and the warm join at the flagship width
    (bf16, nothing cut) on ``serve_fleet_flagship``'s traffic (16 requests,
    4 Zipf templates of 256 tokens, suffixes 16–128, budgets 16–64,
    ``kv_block=16``, 4 slots a replica). Fleets of 2 in-process replicas
    (both on this one card — no deployment's layout): with ``disk_spill=``
    in a temp dir and a ``CDN_FLAGSHIP_BLOCKS``-block RAM store, run cold
    once (it files the chains); then ``CDN_TURNS`` brand-new fleets over
    the same dir (the restart: restored from disk, the tail fetched off
    it), each warmed on unrelated prompts (its graphs captured) before its
    timed call; against the same fleet without ``disk_spill`` (warmed once,
    ``CDN_TURNS`` timed calls). Then an autoscaled fleet (1 to 2 replicas,
    ``host_spill`` engines) called twice, its second joiner warm. Reported:
    restore seconds and frames, bytes on disk and the filesystem, ms a
    1 MiB block swapped in from disk and from the RAM store (the engines'
    host clock), disk hit blocks, tokens/s and p50/p99 from the call's
    start (median and min–max), flash prefills of each fleet, the joiner's
    seconds from its spawn to its first admission, the tokens equal to the
    single engine's, and the host seconds of the disk tier's writes and
    reads and of the store's publishes and fetches (class-level wrappers,
    the cold call and the last restart). Held: every budget served in the vocabulary,
    pools drained, no quarantine or degraded op, the launch tallies."""
    import shutil
    import tempfile

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        AutoscalePolicy,
        make_fleet,
        make_serve_engine,
    )
    from nvidia_terraform_modules_tpu_torch.models import fleet as fmod
    from nvidia_terraform_modules_tpu_torch.models import transport as tmod
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync
    from nvidia_terraform_modules_tpu_torch.utils.traffic import (
        ragged_lengths,
        shared_prefix_prompts,
    )

    t_phase = time.monotonic()
    pairs = shared_prefix_prompts(LEVER_REQUESTS, SEED, n_templates=4,
                                  template_len=256, suffix_lo=16,
                                  suffix_hi=128, vocab=cfg.vocab,
                                  block_size=KV_BLOCK)
    prompts = [torch.tensor(p, device=dev) for _, p in pairs]
    budgets = ragged_lengths(LEVER_REQUESTS, SEED, lo=16, hi=64)
    max_len = max(len(p) + n for (_, p), n in zip(pairs, budgets))
    pg = torch.Generator().manual_seed(SEED + 7)
    # unrelated prompts for the warm-ups: they capture each engine's graph
    # and share no block with the timed traffic
    warmups = [torch.randint(0, cfg.vocab, (48,), generator=pg).to(dev)
               for _ in range(2)]
    kw = dict(max_len=max_len, kv_block=KV_BLOCK, share_prefix=True,
              steal=False)
    block_bytes = (cfg.n_layers * 2 * KV_BLOCK * cfg.kv_heads
                   * cfg.head_dim * 2)
    single = make_serve_engine(params, cfg, max_len=max_len,
                               kv_block=KV_BLOCK, share_prefix=True,
                               device=dev)(prompts, budgets, slots=SLOTS)
    sync()

    def run(fleet):
        sync()
        t0 = time.monotonic()
        outs = fleet(prompts, budgets, slots=SLOTS)
        sync()
        wall_s = time.monotonic() - t0
        st = fleet.last_stats
        for o, n in zip(outs, budgets):
            if o is None or o.shape != (n,) or int(o.min()) < 0 \
                    or int(o.max()) >= cfg.vocab:
                raise AssertionError("serve_cdn_flagship: bad output")
        if any(rs["kv"]["in_use"] for rs in st["replica_stats"] if rs):
            raise AssertionError("serve_cdn_flagship: a pool did not drain")
        lat = st["fleet"]["latency_ms"]
        cdn = [rs["prefix"]["cdn"] for rs in st["replica_stats"] if rs]
        spill = [rs["prefix"]["spill"] for rs in st["replica_stats"] if rs]
        return outs, st, dict(
            wall_s=wall_s,
            tokens_per_s=sum(int(o.shape[0]) for o in outs) / wall_s,
            p50_ms=lat["p50"], p99_ms=lat["p99"],
            flash_prefills=sum(r["flash_prefills"]
                               for r in st["fleet"]["per_replica"]),
            hit_blocks=st["fleet"]["affinity_hit_blocks"],
            disk_hit_blocks=sum(c["disk_hit_blocks"] for c in cdn),
            disk_swap_ms=sum(c["disk_swap_ms"] for c in cdn),
            store_blocks=sum(s["swapped_blocks"] for s in spill)
            - sum(c["disk_hit_blocks"] for c in cdn),
            store_swap_ms=sum(s["swap_ms"] for s in spill)
            - sum(c["disk_swap_ms"] for c in cdn),
            tokens_equal_single=sum(int((a.to(dev) == b).sum())
                                    for a, b in zip(outs, single)))

    def med(vals):
        vals = sorted(vals)
        return {"median": vals[len(vals) // 2], "min": vals[0],
                "max": vals[-1]}

    def per_mib(ms, blocks):
        return ms / blocks / (block_bytes / 2 ** 20) if blocks else None

    # where the CDN's host time goes: the disk tier's writes (pickle, crc,
    # write, fsync, rename) and verified reads, and the RAM store's publishes
    # (the rows' copy to pinned memory, adopt and crc stamps) and fetches
    from nvidia_terraform_modules_tpu_torch.models import hostkv

    meter: dict = {}

    def timed(key):
        def wrap(fn):
            def inner(*a, **k):
                t0 = time.monotonic()
                try:
                    return fn(*a, **k)
                finally:
                    meter[key] = meter.get(key, 0.0) + time.monotonic() - t0
            return inner
        return wrap

    undo = [_watch(hostkv, "DiskChainStore", "put", timed("disk_put_s")),
            _watch(hostkv, "DiskChainStore", "get", timed("disk_get_s")),
            _watch(hostkv, "WarmChainStore", "publish", timed("publish_s")),
            _watch(hostkv, "WarmChainStore", "fetch", timed("fetch_s"))]
    host_s = {}
    spill = tempfile.mkdtemp(prefix="chip_cdn_flagship_")
    launches = {}
    try:
        cdn_kw = dict(kw, disk_spill=spill, cdn_blocks=CDN_FLAGSHIP_BLOCKS)
        cold = make_fleet(params, cfg, **cdn_kw)
        cold(warmups, 4, slots=SLOTS)
        meter.clear()
        _outs, st, cold_rec = run(cold)
        host_s["cold"] = dict(meter)
        _fleet_kernels("serve_cdn_flagship cold", st, cfg.n_layers)
        launches["cold"] = st["fleet"]["launches"]
        disk_bytes = _dir_bytes(spill)
        frames = st["fleet"]["cdn"]["store"]["disk"]["chains"]
        del cold
        restart, restore_s, restored = [], [], []
        for _turn in range(CDN_TURNS):
            t0 = time.monotonic()
            fleet = make_fleet(params, cfg, **cdn_kw)
            restore_s.append(time.monotonic() - t0)
            restored.append(fleet.cdn_store.disk_restored)
            fleet(warmups, 4, slots=SLOTS)
            meter.clear()
            _outs, st, rec = run(fleet)
            host_s["restart"] = dict(meter)
            disk = st["fleet"]["cdn"]["store"]["disk"]
            if disk["quarantined"] or disk["degraded"]:
                raise AssertionError(f"serve_cdn_flagship restart: {disk}")
            _fleet_kernels("serve_cdn_flagship restart", st, cfg.n_layers,
                           need_k1=False)
            restart.append(rec)
            launches["restart"] = st["fleet"]["launches"]
            del fleet
        plain = make_fleet(params, cfg, **kw)
        plain(warmups, 4, slots=SLOTS)
        baseline = []
        for _turn in range(CDN_TURNS):
            _outs, st, rec = run(plain)
            baseline.append(rec)
        del plain
    finally:
        for put_back in undo:
            put_back()
        shutil.rmtree(spill, ignore_errors=True)
    torch.cuda.empty_cache()

    # the warm join: spawn and first admission of the joiner, timed
    marks: dict = {}
    ensure = tmod.InProcTransport.ensure_engine
    pop = fmod._FleetQueue.pop

    def timed_ensure(self, i):
        marks.setdefault(("spawn", i), time.monotonic())
        return ensure(self, i)

    def timed_pop(self, req):
        marks.setdefault(("admit", self.label), time.monotonic())
        return pop(self, req)

    elastic = make_fleet(params, cfg, replicas=1, host_spill=True,
                         host_blocks=SPILL_HOST_BLOCKS,
                         prefix_keep_blocks=64, est_token_s=0.01,
                         autoscale=AutoscalePolicy(min_replicas=1,
                                                   max_replicas=2,
                                                   up_backlog=2.0,
                                                   down_backlog=0.25,
                                                   cooldown_s=0.0, seed=0),
                         **kw)
    joins = []
    tmod.InProcTransport.ensure_engine = timed_ensure
    fmod._FleetQueue.pop = timed_pop
    try:
        for _call in range(2):
            marks.clear()
            _outs, st, rec = run(elastic)
            sc = st["fleet"]["scale"]
            joins.append(dict(
                rec, warm_joins=sc["warm_joins"],
                primed=sc["warm_chains_primed"], events=sc["events"],
                joiner_hits=_joiner_hits(st),
                spawn_to_admit_s=(marks[("admit", "replica-1")]
                                  - marks[("spawn", 1)]
                                  if ("spawn", 1) in marks
                                  and ("admit", "replica-1") in marks
                                  else None)))
    finally:
        tmod.InProcTransport.ensure_engine = ensure
        fmod._FleetQueue.pop = pop
    if not (joins[1]["warm_joins"] >= 1 and joins[1]["events"]
            == joins[0]["events"]):
        raise AssertionError(f"serve_cdn_flagship elastic: {joins}")
    _fleet_kernels("serve_cdn_flagship elastic", st, cfg.n_layers)
    launches["elastic"] = st["fleet"]["launches"]
    del elastic
    torch.cuda.empty_cache()

    def summary(recs):
        last = recs[-1]
        return dict(
            tokens_per_s=med([r["tokens_per_s"] for r in recs]),
            p50_ms=med([r["p50_ms"] for r in recs]),
            p99_ms=med([r["p99_ms"] for r in recs]),
            flash_prefills=[r["flash_prefills"] for r in recs],
            hit_blocks=last["hit_blocks"],
            disk_hit_blocks=[r["disk_hit_blocks"] for r in recs],
            tokens_equal_single=[r["tokens_equal_single"] for r in recs])

    rec = dict(
        nvidia_smi=smi, layout="2 replicas on one card (no deployment's)",
        requests=LEVER_REQUESTS, budgets=budgets,
        prompt_lens=[len(p) for _, p in pairs], max_len=max_len,
        slots=SLOTS, tokens=sum(budgets), block_bytes=block_bytes,
        cdn_blocks=CDN_FLAGSHIP_BLOCKS,
        filesystem=_filesystem(tempfile.gettempdir()),
        disk_bytes=disk_bytes, frames=frames,
        restore_s=med(restore_s), restored_chains=restored,
        disk_ms_per_mib=per_mib(sum(r["disk_swap_ms"] for r in restart),
                                sum(r["disk_hit_blocks"] for r in restart)),
        store_ms_per_mib=per_mib(sum(r["store_swap_ms"] for r in restart),
                                 sum(r["store_blocks"] for r in restart)),
        cold=summary([cold_rec]), restart=summary(restart),
        host_s=host_s,
        no_disk=summary(baseline),
        elastic=[{k: j[k] for k in (
            "tokens_per_s", "p50_ms", "p99_ms", "flash_prefills",
            "warm_joins", "primed", "joiner_hits", "spawn_to_admit_s",
            "tokens_equal_single")} for j in joins],
        seconds=time.monotonic() - t_phase)
    return rec, launches


def kernel_sample_draw(dev, card: str) -> dict:
    """D1 (the keyed Gumbel-max draw) against the plain draw on the card:
    seeded logits with -inf entries, a row of -inf only and an exact tie of
    +inf logits, at the flagship wave's ``[4, 8192]``, at ``[8, 8192]``,
    and at ``[1, 8192]`` with a row offset past 2^32; with a key a row and
    with the engine's (request, position) fold. Tokens must be equal, and
    the plain version's Gumbel scores must equal D1's debug copy bit for
    bit (the first differing element is reported otherwise). Both timed;
    returns the wave shape's record."""
    import torch

    from nvidia_terraform_modules_tpu_torch.ops import sampling
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        sync,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    main = None
    for rows, offset, on_path in ((SLOTS, 0, True), (8, 0, False),
                                  (1, 3 * 2 ** 32 - 5, False)):
        v = 8192
        lg = torch.randn((rows, v), generator=g, device=dev) * 3
        lg[:, 5:50] = -torch.inf
        lg[0, 100] = lg[0, 300] = torch.inf       # an exact tie → 100
        if rows > 1:
            lg[1] = -torch.inf                    # all -inf → 0
        offs = torch.arange(rows, device=dev, dtype=torch.int64) * v + offset
        keys = torch.tensor([[7, 1000 + i] for i in range(rows)], device=dev)
        fold = torch.stack([torch.arange(rows), torch.arange(rows) + 9],
                           1).to(dev)
        for form, k, f in (("key_a_row", keys, None),
                           ("fold", keys[0].contiguous(), fold)):
            tok, sc = sampling.draw_scores(lg, k, offs, f)
            ref, ref_sc = sampling.draw_ref(lg, k, offs, f, scores=True)
            sync()
            diff = (sc != ref_sc).nonzero()
            if diff.numel() or not torch.equal(tok, ref) or tok[0] != 100 \
                    or (rows > 1 and tok[1] != 0):
                first = diff[0].tolist() if diff.numel() else None
                raise AssertionError(
                    f"sample_draw [{rows}, {v}] {form}: tokens {tok.tolist()}"
                    f" vs plain {ref.tolist()}; first differing score "
                    f"{first}" + (f" ({sc[tuple(first)].item()} vs "
                                  f"{ref_sc[tuple(first)].item()})"
                                  if first else ""))
        ms = cuda_median_ms(lambda: sampling.draw(lg, keys[0].contiguous(),
                                                  None, fold))
        plain_ms = cuda_median_ms(lambda: sampling.draw_ref(
            lg, keys[0].contiguous(), None, fold))
        nbytes = rows * v * 4 + rows * (8 + 16 + 8)
        bound_ms, bound_by = bound(DRAW_OPS_PER_ELEMENT * rows * v, nbytes,
                                   "f32")
        rec = dict(card=card, shape=[rows, v], offset=offset,
                   main_path=on_path, tokens_equal=True, scores_equal=True,
                   max_abs_err=0.0,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        emit("kernel_sample_draw", **rec)
        if on_path:
            main = rec
    return main


def serve_sampled_exact(dev) -> None:
    """The sampled engine on the card at f32 (serve_exact's config), bf16
    and int8 pools: a top-k = 1 sampler gives the greedy engine's tokens;
    at temperature 5 slots 1 and 3 give the same tokens; the captured
    sampled wave equals the eager sampled step on a copy of the pool
    (tokens, (request, position) rows and pool bytes); a second run gives
    the same tokens and captures nothing new; lazy growth with a
    preemption on a tight pool gives the ample pool's tokens."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        init_params,
        make_sampler,
        make_serve_engine,
        quantize_params,
    )

    cfg = _exact_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    pg = torch.Generator().manual_seed(2)
    cases = {
        "bf16": (params, "bf16", 48,
                 [torch.randint(0, cfg.vocab, (n,), generator=pg)
                  for n in (16, 24, 8, 32, 16)]),
        "int8": (quantize_params(params, dtype=torch.float32), "int8", 144,
                 [torch.randint(0, cfg.vocab, (n,), generator=pg)
                  for n in (80, 96, 72, 128, 88)])}
    for name, (p, cache_dtype, max_len, prompts) in cases.items():
        kw = dict(max_len=max_len, kv_block=KV_BLOCK,
                  cache_dtype=cache_dtype, device=dev)
        greedy = make_serve_engine(p, cfg, **kw)(prompts, 8, slots=2)
        k1 = make_serve_engine(p, cfg, sampler=make_sampler(top_k=1), **kw)(
            prompts, 8, slots=2, rng=3)
        hot = make_serve_engine(p, cfg, sampler={"temperature": 5.0}, **kw)
        one = hot(prompts, 8, slots=1, rng=3)
        three = hot(prompts, 8, slots=3, rng=3)
        captures = hot.captures
        again = hot(prompts, 8, slots=3, rng=3)
        second = hot.captures
        # lazy growth: five 15-token prompts take one block each at
        # admission and all cross into a second at the same wave; a pool
        # of four blocks stalls them all, and the youngest is preempted
        lazy_prompts = [torch.randint(0, cfg.vocab, (15,), generator=pg)
                        for _ in range(5)]
        ample = hot(lazy_prompts, 8, slots=SLOTS, rng=3)
        lazy = make_serve_engine(p, cfg, sampler={"temperature": 5.0},
                                 lazy_growth=True, **kw)
        tight = lazy(lazy_prompts, 8, slots=SLOTS, rng=3, kv_blocks=1 + 4)
        preempted = lazy.last_stats["sched"]["preempted"]
        # the captured sampled wave against the eager one on a twin pool
        pool = _seeded_pool(cfg, dev, 4, max_len, cache_dtype, seed=3)
        graph = hot.capture(pool)
        twin = {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone()) for k, v in pool.items()}
        toks = torch.tensor([3, 77, 501, 9], device=dev)
        active = torch.tensor([True, True, False, True], device=dev)
        fold = torch.tensor([[0, 1], [1, 4], [5, 0], [2, 2]], device=dev)
        key = torch.tensor([0, 3], device=dev)
        for buf, val in ((graph.tokens, toks), (graph.active, active),
                         (graph.fold, fold), (graph.key, key)):
            buf.copy_(val)
        waves_equal = []
        for wave in range(8):
            if wave == 3:
                active = torch.tensor([False, True, True, True], device=dev)
                graph.active.copy_(active)
            graph.replay()
            toks = hot.step(toks, active, fold, key, twin)
            waves_equal.append(torch.equal(graph.tokens, toks)
                               and torch.equal(graph.fold, fold))
        pool_equal = all(
            torch.equal(a, b) for k_, val in pool.items()
            for a, b in zip(val if isinstance(val, list) else [val],
                            twin[k_] if isinstance(val, list)
                            else [twin[k_]]))
        rec = dict(pool=name, replay_launches=graph.launches,
                   top_k1_equals_greedy=[torch.equal(a, b)
                                         for a, b in zip(k1, greedy)],
                   slots1_equals_slots3=[torch.equal(a, b)
                                         for a, b in zip(one, three)],
                   second_run_equal=[torch.equal(a, b)
                                     for a, b in zip(three, again)],
                   captures_after_first_runs=captures,
                   captures_after_second_run=second,
                   lazy_preempted=preempted,
                   lazy_equals_ample=[torch.equal(a, b)
                                      for a, b in zip(tight, ample)],
                   differs_from_greedy=sum(not torch.equal(a, b)
                                           for a, b in zip(three, greedy)),
                   waves_equal=waves_equal, pool_bytes_equal=pool_equal)
        emit("serve_sampled_exact", **rec)
        ok = all(rec["top_k1_equals_greedy"] + rec["slots1_equals_slots3"]
                 + rec["second_run_equal"] + rec["lazy_equals_ample"]
                 + waves_equal) and pool_equal and preempted > 0 \
            and captures == second == 2 \
            and rec["differs_from_greedy"] > 0
        if not ok:
            raise AssertionError(f"serve_sampled_exact {name}: {rec}")
        del hot, lazy, pool, twin, graph


def serve_sampled_flagship(params, cfg, dev, prompts, max_len,
                           greedy: dict, draw_ms: float, card: str) -> dict:
    """The flagship traffic sampled (bf16, 4 slots), with
    ``make_sampler(temperature=0.8, top_p=0.95)`` and then ``top_k=50``:
    tokens/s, the wave's device and host ms beside the greedy wave's
    (``greedy``, this call's serve_flagship), D1's share of the wave's
    device time, and the wave with the plain draw captured in D1's place
    (a debug graph, ``utils/kernel_ab.sampled_waves``). Launches: K7 once a
    layer a wave, D1 once a wave and once an admission."""
    import torch

    from nvidia_terraform_modules_tpu_torch import models
    from nvidia_terraform_modules_tpu_torch.models import make_serve_engine
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils import kernel_ab, timing

    out = {"card": card}
    for name, spec in (("top_p", {"temperature": 0.8, "top_p": 0.95}),
                       ("top_k", {"temperature": 0.8, "top_k": 50})):
        engine = make_serve_engine(params, cfg, max_len=max_len,
                                   kv_block=KV_BLOCK, sampler=spec,
                                   device=dev)
        engine(prompts[:SLOTS], 4, slots=SLOTS, rng=SEED)   # warm-up
        timing.sync()
        _build.reset_launches()
        t0 = time.monotonic()
        outs = engine(prompts, N_NEW, slots=SLOTS, rng=SEED)
        timing.sync()
        wall_s = time.monotonic() - t0
        launches = dict(_build.launches)
        st = engine.last_stats
        want = {**{k: 0 for k in launches},
                "flash_fwd": st["requests"] * cfg.n_layers,
                "paged_decode": st["waves"] * cfg.n_layers,
                "sample_draw": st["waves"] + st["requests"]}
        if launches != want:
            raise AssertionError(f"serve_sampled_flagship {name} launched "
                                 f"{launches}, expected {want}")
        for o in outs:
            if o.shape != (N_NEW,) or int(o.min()) < 0 \
                    or int(o.max()) >= cfg.vocab:
                raise AssertionError(f"bad sampled output {o.shape} {o}")
        again = engine(prompts, N_NEW, slots=2, rng=SEED)
        waves = kernel_ab.sampled_waves(models, timing, dev, params, cfg,
                                        tuple(spec.items()))
        out[name] = dict(
            sampler=spec, requests=st["requests"],
            generated=st["generated"], waves=st["waves"], wall_s=wall_s,
            tokens_per_s=st["generated"] / wall_s,
            greedy_tokens_per_s=greedy["tokens_per_s"],
            ms_per_wave=waves["d1_ms_per_wave"],
            host_ms_per_wave=(waves["d1_host_ms_per_wave_1"]
                              + waves["d1_host_ms_per_wave_2"]) / 2,
            plain_draw_ms_per_wave=waves["plain_ms_per_wave"],
            plain_draw_host_ms_per_wave=(waves["plain_host_ms_per_wave_0"]
                                         + waves["plain_host_ms_per_wave_3"])
            / 2,
            greedy_ms_per_wave=waves["greedy_ms_per_wave"],
            greedy_host_ms_per_wave=waves["greedy_host_ms_per_wave"],
            wave_turns_ms={k: v for k, v in waves.items()
                           if "_ms_per_wave_" in k},
            d1_share_of_wave=draw_ms / waves["d1_ms_per_wave"],
            draw_d1_ms=waves["draw_d1_ms"],
            draw_plain_ms=waves["draw_plain_ms"],
            replay_launches_per_wave=waves["d1_launches_per_wave"],
            plain_replay_launches_per_wave=waves["plain_launches_per_wave"],
            launches=launches, captures=engine.captures,
            schedule_invariant_slots2=sum(torch.equal(a, b)
                                          for a, b in zip(outs, again))
            / len(outs),
            latency_ms=st["latency_ms"])
        if out[name]["schedule_invariant_slots2"] != 1.0:
            raise AssertionError(f"serve_sampled_flagship {name}: slots 2 "
                                 f"changed tokens")
        del engine
    return out


def serve_spec_exact(dev) -> None:
    """The speculative engine on the card at f32 (every trip a replay),
    on periodic prompts: tokens equal the greedy engine's and solo
    ``greedy_decode``'s, with fewer verification slot-steps than tokens;
    composed with ``share_prefix``, ``prefill_chunk`` and ``lazy_growth``
    on a tight pool (dense config: every prefill path is the same dense
    math); int8 pool and int8 weights against the int8 greedy engine on
    the gather path."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        init_params,
        make_serve_engine,
        quantize_params,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build

    records = {}
    for attn in ("flash", "dense"):
        cfg = _exact_cfg(attn)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                             device=dev)
        pg = torch.Generator().manual_seed(8)
        # a periodic 32-token template (two full blocks: sharing hits) and
        # a periodic suffix a request
        tmpl = torch.randint(0, cfg.vocab, (4,), generator=pg).repeat(8)
        prompts = [torch.cat([tmpl, torch.randint(
            0, cfg.vocab, (3,), generator=pg).repeat(4)[:4 + 3 * i]])
            for i in range(5)]
        budgets = [16, 24, 12, 20, 16]
        max_len = max(len(x) + n for x, n in zip(prompts, budgets)) + 4
        kw = dict(max_len=max_len, kv_block=KV_BLOCK, device=dev)
        greedy = make_serve_engine(params, cfg, **kw)(prompts, budgets,
                                                      slots=2)
        solo = [greedy_decode(params, x[None], n, cfg, device=dev,
                              prefill="dense" if attn == "dense" else "auto"
                              )[0] for x, n in zip(prompts, budgets)]
        full = -(-max_len // KV_BLOCK)
        variants = {"plain": ({}, {})}
        if attn == "dense":
            variants.update({
                "share_prefix": ({"share_prefix": True}, {}),
                "prefill_chunk": ({"prefill_chunk": 16}, {}),
                "lazy_growth": ({"lazy_growth": True},
                                {"kv_blocks": 1 + full + 2}),
                "composed": ({"share_prefix": True, "prefill_chunk": 16,
                              "lazy_growth": True},
                             {"kv_blocks": 1 + full + 2})})
        for name, (ekw, rkw) in variants.items():
            eng = make_serve_engine(params, cfg, spec_k=4, **kw, **ekw)
            got = eng(prompts, budgets, slots=2, **rkw)
            st = eng.last_stats
            rec = dict(equal_greedy_engine=[torch.equal(a, b) for a, b in
                                            zip(got, greedy)],
                       equal_solo=[torch.equal(a, b)
                                   for a, b in zip(got, solo)],
                       slot_steps=st["slot_steps"],
                       generated=st["generated"],
                       accepted_per_step=st["accepted_per_step"],
                       trips=st["trips"], waves=st["waves"],
                       preempted=st["sched"]["preempted"],
                       hit_blocks=st["prefix"]["hit_blocks"],
                       grown=st["kv"]["blocks_grown_lazy"],
                       drained=st["kv"]["in_use"] == 0,
                       captures=eng.captures)
            records[f"{attn}_{name}"] = rec
            if not (all(rec["equal_greedy_engine"] + rec["equal_solo"])
                    and rec["drained"]
                    and (not ekw.get("share_prefix") or rec["hit_blocks"])
                    and (not ekw.get("lazy_growth") or rec["grown"])
                    and st["slot_steps"] < st["generated"] - len(prompts)):
                emit("serve_spec_exact", cases=records)
                raise AssertionError(f"serve_spec_exact {attn} {name}: "
                                     f"{rec}")
    # int8 weights and an int8 pool
    qparams = quantize_params(params, dtype=torch.float32)
    kw = dict(max_len=max_len, kv_block=KV_BLOCK, cache_dtype="int8",
              device=dev)
    want = make_serve_engine(qparams, cfg, paged_kernel="off", **kw)(
        prompts, budgets, slots=2)
    eng = make_serve_engine(qparams, cfg, spec_k=4, **kw)
    before = _build.launches["int8_matmul"]
    got = eng(prompts, budgets, slots=2)
    records["int8"] = dict(
        equal_int8_greedy_engine=[torch.equal(a, b)
                                  for a, b in zip(got, want)],
        int8_matmul_launches=_build.launches["int8_matmul"] - before,
        slot_steps=eng.last_stats["slot_steps"],
        accepted_per_step=eng.last_stats["accepted_per_step"])
    emit("serve_spec_exact", requests=len(prompts), budgets=budgets,
         cases=records)
    if not all(records["int8"]["equal_int8_greedy_engine"]) \
            or records["int8"]["int8_matmul_launches"] == 0:
        raise AssertionError(f"serve_spec_exact int8: {records['int8']}")


def serve_spec_flagship(params, cfg, dev, card: str) -> dict:
    """``spec_k=4`` at the flagship width (bf16) on serve_levers_flagship's
    template traffic (16 ``shared_prefix_prompts`` requests, ragged
    budgets), beside the greedy engine on the same traffic in this call:
    tokens/s, accepted tokens a verification slot-step, the trip's device
    and host ms (``utils/kernel_ab.spec_trip``), trips and readbacks, and
    one more run of the traffic under the profiler. bf16
    ``[slots, k+1]`` and ``[slots, 1]`` products round differently, so
    tokens equal to the greedy engine's are reported as a share, not
    held."""
    import torch

    from nvidia_terraform_modules_tpu_torch import models
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils import kernel_ab, timing
    from nvidia_terraform_modules_tpu_torch.utils.traffic import (
        ragged_lengths,
        shared_prefix_prompts,
    )

    k = 4
    pairs = shared_prefix_prompts(LEVER_REQUESTS, SEED, n_templates=4,
                                  template_len=256, suffix_lo=16,
                                  suffix_hi=128, vocab=cfg.vocab,
                                  block_size=KV_BLOCK)
    prompts = [torch.tensor(p, device=dev) for _, p in pairs]
    budgets = ragged_lengths(LEVER_REQUESTS, SEED, lo=16, hi=64)
    max_len = max(len(p) + n for (_, p), n in zip(pairs, budgets)) + k
    runs = {}
    for name, kw in (("greedy", {}), ("spec", {"spec_k": k})):
        engine = models.make_serve_engine(params, cfg, max_len=max_len,
                                          kv_block=KV_BLOCK, device=dev,
                                          **kw)
        engine(prompts[:SLOTS], 4, slots=SLOTS)          # warm-up
        timing.sync()
        _build.reset_launches()
        t0 = time.monotonic()
        outs = engine(prompts, budgets, slots=SLOTS)
        timing.sync()
        wall_s = time.monotonic() - t0
        runs[name] = (outs, engine.last_stats, wall_s,
                      dict(_build.launches))
        if name == "spec":
            # where a run's time goes: the same traffic under the profiler
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                engine(prompts, budgets, slots=SLOTS)
                timing.sync()
                prof_wall_ms = (time.monotonic() - t0) * 1e3
            spec_profile = profile_summary(prof, prof_wall_ms)
        del engine
    outs, st, wall_s, launches = runs["spec"]
    g_outs, g_st, g_wall, _ = runs["greedy"]
    for o, n in zip(outs, budgets):
        if o.shape != (n,) or int(o.min()) < 0 or int(o.max()) >= cfg.vocab:
            raise AssertionError(f"serve_spec_flagship: bad output "
                                 f"{o.shape} for budget {n}")
    want = {**{name: 0 for name in launches},
            "flash_fwd": st["requests"] * cfg.n_layers}
    if launches != want or st["kv"]["in_use"] != 0:
        raise AssertionError(f"serve_spec_flagship launched {launches}, "
                             f"expected {want}; kv {st['kv']}")
    trip = kernel_ab.spec_trip(models, timing, dev, params, cfg, k)
    tok_eq = sum(int((a == b).sum()) for a, b in zip(outs, g_outs))
    return dict(card=card, spec_k=k, requests=st["requests"],
                generated=st["generated"], budgets=budgets,
                prompt_lens=[len(p) for _, p in pairs], max_len=max_len,
                wall_s=wall_s, tokens_per_s=st["generated"] / wall_s,
                greedy_tokens_per_s=g_st["generated"] / g_wall,
                greedy_waves=g_st["waves"],
                accepted_per_step=st["accepted_per_step"],
                slot_steps=st["slot_steps"], multi_steps=st["waves"],
                trips=st["trips"], readbacks_per_trip=1,
                trip_ms=trip["spec_trip_ms"],
                trip_host_ms=trip["spec_trip_host_ms"],
                trip_launches=trip["spec_trip_launches"],
                launches=launches, latency_ms=st["latency_ms"],
                greedy_latency_ms=g_st["latency_ms"],
                tokens_equal_greedy_frac=tok_eq / sum(budgets),
                requests_equal_greedy=sum(torch.equal(a, b)
                                          for a, b in zip(outs, g_outs)),
                profile=spec_profile)


def card_probes(smi: str) -> dict:
    """``ops/probes``: chained bf16 ``[4096, 4096]`` products (cuBLAS) and
    HBM streaming over two 512 MiB f32 vectors, read (a two-stream dot)
    and triad (``acc = y + c·acc``), as shares of ``utils/device``'s
    peaks — the card's own ceilings beside which the kernels' bounds
    read."""
    from nvidia_terraform_modules_tpu_torch.ops.probes import (
        hbm_probe,
        matmul_probe,
    )

    return dict(matmul=matmul_probe(), hbm_read=hbm_probe(mode="read"),
                hbm_triad=hbm_probe(mode="triad"), nvidia_smi=smi)


def serve_telemetry(engine, params, cfg, dev, prompts, max_len,
                    outs) -> dict:
    """``serve_flagship``'s traffic through an engine with an enabled
    telemetry registry, in turns with the untraced engine (untraced,
    traced, traced, untraced, …): tokens equal to the untraced run's
    (``outs``), tokens/s of each (the median of the turns) and their
    ratio, the instruments' counts and the Prometheus exposition's line
    count, and the three artifacts ``export_all`` writes."""
    import tempfile

    import torch

    from nvidia_terraform_modules_tpu_torch.models import make_serve_engine
    from nvidia_terraform_modules_tpu_torch.telemetry import (
        Registry,
        export_all,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    reg = Registry()
    traced = make_serve_engine(params, cfg, max_len=max_len,
                               kv_block=KV_BLOCK, telemetry=reg, device=dev)
    traced(prompts[:SLOTS], 4, slots=SLOTS)       # capture, warm
    sync()
    walls = {"untraced": [], "traced": []}
    equal = True
    for turn in ("untraced", "traced", "traced", "untraced") * 2:
        eng = traced if turn == "traced" else engine
        t0 = time.monotonic()
        got = eng(prompts, N_NEW, slots=SLOTS)
        sync()
        walls[turn].append(time.monotonic() - t0)
        equal = equal and all(torch.equal(a, b) for a, b in zip(got, outs))
    if not equal:
        raise AssertionError("serve_telemetry: the traced engine's tokens "
                             "differ from the untraced run's")
    tps = {k: sorted(N_REQUESTS * N_NEW / w for w in v)
           for k, v in walls.items()}
    counters, gauges, hists = reg.instruments()
    spans = [e["name"] for e in reg.events if e["kind"] == "span"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = export_all(reg, tmp)
        sizes = {k: os.path.getsize(v) for k, v in paths.items()}
    prom = reg.prometheus_text()
    want_requests = len(walls["traced"]) * len(prompts) + SLOTS
    if spans.count("serve_request") != want_requests or \
            hists["serve_request_ms"].count != want_requests:
        raise AssertionError(f"serve_telemetry: {spans.count('serve_request')}"
                             f" request spans, expected {want_requests}")
    mid = {k: v[len(v) // 2] for k, v in tps.items()}
    return dict(tokens_equal_untraced=equal, turns=len(walls["traced"]),
                untraced_tokens_per_s=mid["untraced"],
                traced_tokens_per_s=mid["traced"],
                untraced_tokens_per_s_min_max=[tps["untraced"][0],
                                               tps["untraced"][-1]],
                traced_tokens_per_s_min_max=[tps["traced"][0],
                                             tps["traced"][-1]],
                traced_over_untraced=mid["traced"] / mid["untraced"],
                counters={k: c.value for k, c in counters.items()},
                gauges={k: g.value for k, g in gauges.items()},
                serve_request_ms_p50=hists["serve_request_ms"].quantile(0.5),
                serve_request_ms_p99=hists["serve_request_ms"].quantile(
                    0.99),
                spans={n: spans.count(n) for n in sorted(set(spans))},
                prometheus_lines=len(prom.splitlines()),
                artifact_bytes=sizes)


def train_telemetry(params, dev) -> dict:
    """The flagship SGD step wrapped by ``instrument_step`` with an enabled
    registry: the one-shot flash probe (K1 and K5 at the step's per-layer
    shape, two-point chains) before the first of three steps, then each
    step's ``train_step_ms``, ``train_mfu`` and ``train_tokens_per_s``."""
    from nvidia_terraform_modules_tpu_torch.models import (
        instrument_step,
        make_train_step,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.telemetry import Registry

    cfg, batch = _flagship_train(dev)
    reg = Registry()
    step = instrument_step(make_train_step(cfg, lr=TRAIN_LR, device=dev),
                           cfg, reg, device=dev)
    _build.reset_launches()
    p = params
    losses = []
    for _ in range(3):
        p, loss = step(p, batch)
        losses.append(loss.item())
    probe_launches = {k: n for k, n in _build.launches.items() if n}
    counters, gauges, hists = reg.instruments()
    if hists["train_step_ms"].count != 3 or \
            hists["flash_fwd_ms"].count != 1 or \
            not probe_launches.get("flash_bwd_fused"):
        raise AssertionError(f"train_telemetry: {reg.summary()}")
    return dict(
        train_step_ms_p50=hists["train_step_ms"].quantile(0.5),
        train_step_ms=hists["train_step_ms"].snapshot()["sum"] / 3,
        **{k: g.value for k, g in gauges.items()},
        flash_fwd_ms=hists["flash_fwd_ms"].quantile(0.5),
        flash_bwd_ms=hists["flash_bwd_ms"].quantile(0.5),
        train_steps=counters["train_steps"].value, losses=losses,
        launches=probe_launches,
        spans=sum(e["name"] == "train_step" for e in reg.events))


def decode_graph_exact(dev) -> None:
    """``make_decoder`` (an eager prefill, then one replay of the captured
    steps) against the eager loop (``greedy_decode``) at f32, serve_exact's
    config: bf16 and int8 caches, f32 and int8 weights, tokens equal bit
    for bit on the capturing call and on a replay; the capture's tally is
    ``n_new - 1`` times one step's K6 and K8 launches. Then a params swap —
    another output norm, the int8 tree, back to the first — each call its
    own tree's tokens, each tree its own capture."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        init_params,
        make_decoder,
        quantize_params,
    )

    cfg = _exact_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    qparams = quantize_params(params, dtype=torch.float32)
    # batch 4 x 40: the prefill's M = 160 takes the plain int8 product
    prompt = torch.randint(0, cfg.vocab, (4, 40),
                           generator=torch.Generator().manual_seed(4)).to(dev)
    n_new = 12
    for cache_dtype in ("bf16", "int8"):
        for weights, p in (("f32", params), ("int8", qparams)):
            want = greedy_decode(p, prompt, n_new, cfg,
                                 cache_dtype=cache_dtype, device=dev)
            dec = make_decoder(cfg, n_new=n_new, cache_dtype=cache_dtype,
                               device=dev)
            got = [dec(p, prompt) for _ in range(2)]
            (graph,) = dec.graphs.values()
            step = {}
            if cache_dtype == "int8":
                step["kv_decode"] = cfg.n_layers
            if weights == "int8":
                step["int8_matmul"] = 6 * cfg.n_layers + 1
            tally = {k: (n_new - 1) * n for k, n in step.items()}
            equal = [torch.equal(g, want) for g in got]
            emit("decode_graph_exact", cache=cache_dtype, weights=weights,
                 n_new=n_new, equal_capture_call=equal[0],
                 equal_replay_call=equal[1], replay_launches=graph.launches,
                 expected_launches=tally)
            if not all(equal) or graph.launches != tally:
                raise AssertionError(f"decode_graph_exact {cache_dtype} "
                                     f"cache, {weights} weights: {equal}, "
                                     f"tally {graph.launches} != {tally}")
            del dec, graph
    swapped = {**params, "out_norm": -params["out_norm"]}
    dec = make_decoder(cfg, n_new=n_new, cache_dtype="int8", device=dev)
    trees = (("first", params), ("swapped", swapped), ("int8", qparams),
             ("first", params))
    want = {name: greedy_decode(p, prompt, n_new, cfg, cache_dtype="int8",
                                device=dev) for name, p in trees}
    seen, equal = [], []
    for name, p in trees:
        equal.append(torch.equal(dec(p, prompt), want[name]))
        seen.append(next(iter(dec.graphs.values())))
    fresh = len({id(g) for g in seen}) == len(seen)
    distinct = not torch.equal(want["first"], want["swapped"])
    emit("decode_graph_exact", params_swap=[n for n, _ in trees],
         equal=equal, capture_per_call=fresh, trees_differ=distinct)
    if not (all(equal) and fresh and distinct):
        raise AssertionError(f"decode_graph_exact swap: equal {equal}, "
                             f"a capture per call {fresh}, trees differ "
                             f"{distinct}")


def decode_profile(run, prompt, launches: dict, decoder_ms: float) -> dict:
    """One replayed decoder call traced by ``utils/profiling.trace_once``
    (its Chrome trace read back): device time by kernel against the call's
    median host-clock time, and K6 and K8 by name — one kernel a launch
    the wrappers counted, replayed from the graph (an empty trace leaves
    them "not measured")."""
    import tempfile

    from nvidia_terraform_modules_tpu_torch.utils.profiling import (
        trace_artifacts,
        trace_once,
    )

    with tempfile.TemporaryDirectory() as tmp:
        _, path = trace_once(run, DECODE_NEW, prompt, log_dir=tmp)
        (trace,) = trace_artifacts(path)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return {"device_ms": None, "note": "not measured: no kernel in the "
                                          "trace"}
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
    k6 = sum(len(v) for n, v in by_name.items() if "kv_decode_kernel" in n)
    k8 = sum(len(v) for n, v in by_name.items() if "int8_mm" in n)
    if (k6, k8) != (launches["kv_decode"], launches["int8_matmul"]):
        raise AssertionError(f"decode_profile: K6 {k6} and K8 {k8} kernels "
                             f"in the trace, expected {launches}")
    device_ms = sum(sum(v) for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    return dict(device_ms=device_ms, decoder_ms=decoder_ms,
                busy_share=device_ms / decoder_ms, kernels=len(kernels),
                kv_decode_kernels=k6, int8_matmul_kernels=k8,
                top_kernels=[{"name": n[:90], "ms": sum(v), "count": len(v)}
                             for n, v in top])


def decode_rates(run, n_new, prompt) -> dict:
    """Decode tokens/s of DECODE_RUNS turns of ``run(n, prompt)``, each the
    call at ``n_new`` and its prefill twin at ``n = 1`` back to back (after
    one warm call of each): the median, min and max, with the median call
    and twin ms."""
    from nvidia_terraform_modules_tpu_torch.utils.timing import synced_ms

    synced_ms(lambda: run(n_new, prompt), 1)
    synced_ms(lambda: run(1, prompt), 1)
    turns = []
    for _ in range(DECODE_RUNS):
        _, total = synced_ms(lambda: run(n_new, prompt), 1)
        _, pre = synced_ms(lambda: run(1, prompt), 1)
        turns.append((prompt.shape[0] * (n_new - 1)
                      / ((total - pre) / 1e3), total, pre))
    tps, total, pre = (sorted(col) for col in zip(*turns))
    mid = len(turns) // 2
    return dict(tokens_per_s=tps[mid], tokens_per_s_min=tps[0],
                tokens_per_s_max=tps[-1], decoder_ms=total[mid],
                prefill_ms=pre[mid], runs=len(turns))


def decode_int8_flagship(params, cfg, dev) -> tuple[dict, dict]:
    """Greedy decode at the flagship's decode shape (batch 8, prompt 512,
    64 new tokens, dense prefill) with int8 weights (``make_quantized_
    decoder``) over the int8 and the bf16 cache, and with bf16 weights
    (``make_decoder``): each through the replayed decoder (a prefill and
    one replay a call) and through the eager loop (``greedy_decode``, a
    host loop a token), in the same call. Decode tokens/s by the two-point
    method (a call at ``n_new`` minus its prefill-only twin at ``n_new =
    1``, back to back), the median of DECODE_RUNS turns with its min-max;
    the launch counts of one replayed call; the replayed tokens against
    the eager loop's. Then the long-context pair (prompt 3584, 32 new,
    flash prefill), int8 weights, bf16 cache against int8 cache. Returns
    the phase record and the replayed int8 run's launch counts."""
    import dataclasses

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        make_decoder,
        make_quantized_decoder,
        quantize_params,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build

    bf16 = torch.bfloat16
    qparams = quantize_params(params, dtype=bf16)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    steps_per_wave = len(params["layers"]) * 6 + 1
    decoders: dict = {}

    def counted(run, n_new, prompt):
        _build.reset_launches()
        toks = run(n_new, prompt)
        torch.cuda.synchronize()
        return dict(_build.launches), toks

    def weights_of(weights):
        return params if weights == "bf16" else qparams

    def replayed(cfg_, cache_dtype, weights):
        """The compiled decoder, built once per (config, cache, weights,
        n_new) and kept, as a caller keeps ``jax.jit``'s."""
        def run(n, p):
            key = (cfg_, cache_dtype, weights, n)
            if key not in decoders:
                decoders[key] = (
                    make_decoder(cfg_, n_new=n, cache_dtype=cache_dtype,
                                 device=dev) if weights == "bf16" else
                    make_quantized_decoder(cfg_, n_new=n, dtype=bf16,
                                           cache_dtype=cache_dtype,
                                           device=dev))
            return decoders[key](weights_of(weights), p)
        return run

    def eager(cfg_, cache_dtype, weights):
        return lambda n, p: greedy_decode(weights_of(weights), p, n, cfg_,
                                          cache_dtype=cache_dtype, device=dev)

    dcfg = dataclasses.replace(cfg, attn="dense", batch=DECODE_BATCH)
    prompt = torch.randint(0, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT),
                           generator=g, device=dev)
    rec: dict = {"batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
                 "n_new": DECODE_NEW, "runs": DECODE_RUNS}
    toks = {}
    int8_launches = None
    for name, cache_dtype, weights in (("int8_weights_int8_cache", "int8",
                                        "int8"),
                                       ("int8_weights_bf16_cache", "bf16",
                                        "int8"),
                                       ("bf16_weights_bf16_cache", "bf16",
                                        "bf16")):
        run = replayed(dcfg, cache_dtype, weights)
        run(DECODE_NEW, prompt)            # the capture, outside the count
        launches, toks[name] = counted(run, DECODE_NEW, prompt)
        graphs = decoders[(dcfg, cache_dtype, weights, DECODE_NEW)].graphs
        steps = DECODE_NEW - 1
        want = {"int8_matmul": steps * steps_per_wave if weights == "int8"
                else 0,
                "kv_decode": steps * dcfg.n_layers
                if cache_dtype == "int8" else 0}
        got = {k_: launches[k_] for k_ in want}
        if got != want or launches["flash_fwd"] or launches["paged_decode"] \
                or launches["paged_decode_int8"] or len(graphs) != 1:
            raise AssertionError(f"decode {name} launched {launches}, "
                                 f"expected {want} from one graph "
                                 f"({len(graphs)} captured)")
        eager_toks = eager(dcfg, cache_dtype, weights)(DECODE_NEW, prompt)
        rep = decode_rates(run, DECODE_NEW, prompt)
        eag = decode_rates(eager(dcfg, cache_dtype, weights), DECODE_NEW,
                           prompt)
        rec[name] = dict(
            replayed=rep, eager=eag, launches=got,
            replayed_over_eager=rep["tokens_per_s"] / eag["tokens_per_s"],
            tokens_equal_eager_frac=(toks[name] == eager_toks)
            .float().mean().item())
        if cache_dtype == "int8" and weights == "int8":
            int8_launches = launches
            rec[name]["profile"] = decode_profile(run, prompt, launches,
                                                  rep["decoder_ms"])
    rec["int8_cache_tokens_match_bf16_cache_frac"] = (
        toks["int8_weights_int8_cache"] == toks["int8_weights_bf16_cache"]
    ).float().mean().item()
    rec["int8_weights_tokens_match_bf16_weights_frac"] = (
        toks["int8_weights_bf16_cache"] == toks["bf16_weights_bf16_cache"]
    ).float().mean().item()
    decoders.clear()
    torch.cuda.empty_cache()
    lcfg = dataclasses.replace(cfg, attn="flash", batch=DECODE_BATCH)
    lprompt = torch.randint(0, cfg.vocab, (DECODE_BATCH, LONG_PROMPT),
                            generator=g, device=dev)
    for cache_dtype in ("bf16", "int8"):
        rep = decode_rates(replayed(lcfg, cache_dtype, "int8"), LONG_NEW,
                           lprompt)
        eag = decode_rates(eager(lcfg, cache_dtype, "int8"), LONG_NEW,
                           lprompt)
        rec[f"long_{cache_dtype}_cache"] = dict(
            prompt=LONG_PROMPT, n_new=LONG_NEW, replayed=rep, eager=eag,
            replayed_over_eager=rep["tokens_per_s"] / eag["tokens_per_s"])
        decoders.clear()
        torch.cuda.empty_cache()
    return rec, int8_launches


def decode_rates_ab(run_a, run_b, n_new, prompt) -> dict:
    """:func:`decode_rates` of two decoders in turns (a b, then b a, ...)
    within one call, DECODE_RUNS turns each after one warm call of each:
    each decoder's median tokens/s with its min-max, and the median (min,
    max) of the turns' b ÷ a ratios — a comparison the card's drift
    between two back-to-back series would blur."""
    from nvidia_terraform_modules_tpu_torch.utils.timing import synced_ms

    def rate(run):
        _, total = synced_ms(lambda: run(n_new, prompt), 1)
        _, pre = synced_ms(lambda: run(1, prompt), 1)
        return prompt.shape[0] * (n_new - 1) / ((total - pre) / 1e3)

    for run in (run_a, run_b):
        rate(run)
    turns = []
    for i in range(DECODE_RUNS):
        if i % 2:
            b = rate(run_b)
            a = rate(run_a)
        else:
            a = rate(run_a)
            b = rate(run_b)
        turns.append((a, b, b / a))
    cols = [sorted(col) for col in zip(*turns)]
    mid = len(turns) // 2
    return {key: {"median": col[mid], "min": col[0], "max": col[-1]}
            for key, col in zip(("a_tokens_per_s", "b_tokens_per_s",
                                 "b_over_a"), cols)}


def _moe_exact_cfg(top_k: int):
    """serve_exact's f32 configuration with 4 experts, top-``top_k``, at
    ``capacity_factor=4.0``: the factor's capacity drops nothing there, so
    the full ``forward`` routes as the drop-free cached paths do."""
    import dataclasses

    return dataclasses.replace(_exact_cfg(), n_experts=4, router_top_k=top_k,
                               capacity_factor=4.0)


def moe_exact(dev) -> None:
    """The routed serve path's contracts at f32 on the card, top-1 and
    top-2: (1) the engine's tokens equal solo ``greedy_decode`` and the
    argmax of one full ``forward`` over each prompt and its tokens; (2) the
    wave replayed from its captured graph equals the eager wave, tokens
    every wave and pool bytes after; (3) ``make_decoder`` equals the eager
    loop bit for bit, on the capturing call and a replay; (4) a 150-token
    prompt, routed in two chunks, gives the unchunked ``forward``'s logits
    within 1e-4; (5) the int8-weight engine over an int8 pool equals its
    own solo int8 decode (prompts over 64 tokens: the solo prefill and the
    admissions take the same dequantised product)."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        forward,
        forward_cached,
        greedy_decode,
        init_cache,
        init_params,
        make_decoder,
        make_serve_engine,
        quantize_params,
    )

    pg = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 512, (n,), generator=pg)
               for n in (16, 24, 8, 32, 16)]
    long_prompts = [torch.randint(0, 512, (n,), generator=pg)
                    for n in (80, 96, 72, 128, 88)]
    batch_prompt = torch.randint(0, 512, (4, 40), generator=pg).to(dev)
    chunked = torch.randint(0, 512, (1, 150), generator=pg).to(dev)
    for top_k in (1, 2):
        cfg = _moe_exact_cfg(top_k)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
        engine = make_serve_engine(params, cfg, max_len=48, kv_block=KV_BLOCK,
                                   device=dev)
        got = engine(prompts, 8, slots=2)
        solo_eq, full_eq = [], []
        for p, toks in zip(prompts, got):
            solo = greedy_decode(params, p[None], 8, cfg, device=dev)[0]
            seq = torch.cat([p.to(dev), toks[:-1]])[None]
            full = forward(params, seq, cfg)[0, p.shape[0] - 1:].argmax(-1)
            solo_eq.append(torch.equal(toks, solo))
            full_eq.append(torch.equal(toks, full))

        pool = _seeded_pool(cfg, dev, 4, 48, "bf16", seed=3)
        graph = engine.capture(pool)
        twin = {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone()) for k, v in pool.items()}
        toks = torch.tensor([3, 77, 501, 9], device=dev)
        active = torch.tensor([True, True, False, True], device=dev)
        graph.tokens.copy_(toks)
        graph.active.copy_(active)
        waves_equal = []
        for wave in range(6):
            if wave == 3:
                active = torch.tensor([False, True, True, True], device=dev)
                graph.active.copy_(active)
            graph.replay()
            toks = engine.step(toks, active, twin)
            waves_equal.append(torch.equal(graph.tokens, toks))
        pool_equal = all(
            torch.equal(a, b)
            for key, val in pool.items()
            for a, b in zip(val if isinstance(val, list) else [val],
                            twin[key] if isinstance(val, list)
                            else [twin[key]]))
        tally = graph.launches
        del engine, graph, pool, twin

        want = greedy_decode(params, batch_prompt, 12, cfg, device=dev)
        dec = make_decoder(cfg, n_new=12, device=dev)
        dec_eq = [torch.equal(dec(params, batch_prompt), want)
                  for _ in range(2)]
        del dec

        got_l, _ = forward_cached(params, chunked,
                                  init_cache(cfg, 1, 150, device=dev), cfg,
                                  prefill_impl="flash")
        chunk_err = (got_l - forward(params, chunked, cfg)).abs().max().item()

        qparams = quantize_params(params, dtype=torch.float32)
        got8 = make_serve_engine(qparams, cfg, max_len=144, kv_block=KV_BLOCK,
                                 cache_dtype="int8", device=dev)(
            long_prompts, 8, slots=2)
        int8_eq = [torch.equal(g, greedy_decode(qparams, p[None], 8, cfg,
                                                cache_dtype="int8",
                                                device=dev)[0])
                   for g, p in zip(got8, long_prompts)]
        emit("moe_exact", top_k=top_k, experts=cfg.n_experts,
             engine_equal_solo=solo_eq, engine_equal_full_forward=full_eq,
             replay_launches=tally,
             waves_equal=waves_equal, pool_bytes_equal=pool_equal,
             decoder_equal_eager_loop=dec_eq,
             chunked_prefill_logit_max_abs_err=chunk_err,
             int8_engine_equal_solo=int8_eq)
        if not (all(solo_eq + full_eq + waves_equal + dec_eq + int8_eq)
                and pool_equal and chunk_err <= 1e-4
                and tally == {"paged_decode": cfg.n_layers}):
            raise AssertionError(f"moe_exact top-{top_k}: a contract fails")


def serve_moe_flagship(dev, lens, max_len, dense: dict,
                       smi: str) -> tuple[dict, tuple, dict]:
    """``serve_flagship``'s traffic on the flagship MoE configuration
    (``FLAGSHIP_TRAIN`` with MOE_EXPERTS experts, top-1, bf16: the flagship
    width, ``d_ff`` 8,192 an expert, nothing cut), first with bf16 weights
    and pool, then with ``quantize_params`` and an int8 pool. Each run
    counts its launches (K1 per admission and layer; K7, or K7-int8 and K8
    for the 4 attention products a layer and the head, per wave and layer:
    the capture's tally times the replays) and prints tokens/s, latency,
    the replayed wave's device and host ms beside the eager step's and
    ``dense``'s (the dense flagship wave of this call), and a profile of
    one more run (top kernels, busy share; K7 or K8 by name). The bf16 run
    adds the prefill ms an admission, the prefill logits of the flash
    kernel against the plain masked softmax, and the share of requests
    equal to their solo decode. Returns the record, the flagship MoE params
    and config (for ``decode_moe_flagship``), and the launch counts of the
    two runs."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        FLAGSHIP_TRAIN,
        BurnInConfig,
        cache_rows,
        forward_cached,
        forward_paged,
        greedy_decode,
        init_cache,
        init_paged_cache,
        init_params,
        make_serve_engine,
        quantize_params,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        host_ms,
        sync,
    )

    bf16 = torch.bfloat16
    cfg = BurnInConfig(**FLAGSHIP_TRAIN, dtype=bf16, n_experts=MOE_EXPERTS,
                       router_top_k=MOE_TOP_K)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    pg = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=pg).to(dev)
               for n in lens]
    mean_len = sum(lens) // len(lens)
    toks = torch.zeros((SLOTS,), dtype=torch.long, device=dev)
    active = torch.ones((SLOTS,), dtype=torch.bool, device=dev)
    rec: dict = {"card": smi, "params": sum(p.numel() for p in
                                            tree_leaves(params)),
                 "experts": MOE_EXPERTS, "top_k": MOE_TOP_K,
                 "expert_bytes": sum(
                     layer["moe"][k].numel() * layer["moe"][k].element_size()
                     for layer in params["layers"]
                     for k in ("experts_up", "experts_down")),
                 "prompt_lens": lens}
    counts = {}
    for name, p, cache_dtype in (("bf16", params, "bf16"),
                                 ("int8", quantize_params(params, dtype=bf16),
                                  "int8")):
        quant = cache_dtype == "int8"
        engine = make_serve_engine(p, cfg, max_len=max_len,
                                   kv_block=KV_BLOCK, cache_dtype=cache_dtype,
                                   device=dev)
        engine(prompts[:SLOTS], 4, slots=SLOTS)    # warm-up, not counted
        sync()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.monotonic()
        outs = engine(prompts, N_NEW, slots=SLOTS)
        sync()
        wall_s = time.monotonic() - t0
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        st = engine.last_stats
        adm, waves = st["requests"], st["waves"]
        k7 = "paged_decode_int8" if quant else "paged_decode"
        tally = {k7: cfg.n_layers}
        if quant:
            tally["int8_matmul"] = 4 * cfg.n_layers + 1
        want = {**{k: 0 for k in launches},
                "flash_fwd": adm * cfg.n_layers,
                **{k: n * waves for k, n in tally.items()}}
        if launches != want:
            raise AssertionError(f"serve_moe_flagship {name} launched "
                                 f"{launches}, expected {want}")
        for o in outs:
            if o.shape != (N_NEW,) or int(o.min()) < 0 \
                    or int(o.max()) >= cfg.vocab:
                raise AssertionError(f"bad MoE output {o.shape} {o}")
        if st["generated"] != N_REQUESTS * N_NEW:
            raise AssertionError(f"generated {st['generated']}")

        nt = -(-cache_rows(max_len, cache_dtype) // KV_BLOCK)
        pool = init_paged_cache(cfg, SLOTS, max_len, block_size=KV_BLOCK,
                                num_blocks=1 + SLOTS * nt,
                                cache_dtype=cache_dtype, device=dev)
        for i in range(SLOTS):
            pool["block_tables"][i] = torch.arange(
                1 + i * nt, 1 + (i + 1) * nt, dtype=torch.int32)
        graph = engine.capture(pool)
        graph.active.fill_(True)
        if graph.launches != tally:
            raise AssertionError(f"serve_moe_flagship {name}: the wave's "
                                 f"capture holds {graph.launches}, expected "
                                 f"{tally}")

        def wave_once():
            pool["pos"].fill_(mean_len + N_NEW // 2)
            engine.step(toks, active, pool)

        def replay_once():
            pool["pos"].fill_(mean_len + N_NEW // 2)
            graph.replay()
        eager_ms = cuda_median_ms(wave_once)
        wave_ms = cuda_median_ms(replay_once)
        r = dict(requests=adm, generated=st["generated"], waves=waves,
                 wall_s=wall_s, tokens_per_s=st["generated"] / wall_s,
                 latency_ms=st["latency_ms"], ms_per_wave=wave_ms,
                 host_ms_per_wave=host_ms(replay_once),
                 eager_ms_per_wave=eager_ms,
                 eager_host_ms_per_wave=host_ms(wave_once),
                 dense_ms_per_wave=dense[name]["ms_per_wave"],
                 dense_host_ms_per_wave=dense[name]["host_ms_per_wave"],
                 over_dense_wave=wave_ms / dense[name]["ms_per_wave"],
                 replay_launches_per_wave=graph.launches,
                 launches=launches, captures=engine.captures,
                 kv=st["kv"], max_memory_allocated=peak)
        del graph, pool
        if not quant:
            # one admission's prefill, event-timed, at each prompt's length
            nt1 = -(-max_len // KV_BLOCK)
            pool1 = init_paged_cache(cfg, 1, max_len, block_size=KV_BLOCK,
                                     num_blocks=1 + nt1, device=dev)
            pool1["block_tables"][0] = torch.arange(1, 1 + nt1,
                                                    dtype=torch.int32)
            prefill_ms = []
            for q in prompts:
                def admit_once(q=q):
                    pool1["pos"].zero_()
                    forward_paged(params, q[None], pool1, cfg,
                                  prefill_impl="flash", paged_kernel="off")
                prefill_ms.append(cuda_median_ms(admit_once, iters=5,
                                                 warmup=1))
            r["prefill_ms_per_admission"] = sum(prefill_ms) / len(prefill_ms)
            del pool1
            logit_err, logit_mag = 0.0, 0.0
            for q in prompts[:2]:
                got, _ = forward_cached(params, q[None], init_cache(
                    cfg, 1, q.shape[0], device=dev), cfg,
                    prefill_impl="flash")
                ref, _ = forward_cached(params, q[None], init_cache(
                    cfg, 1, q.shape[0], device=dev), cfg,
                    prefill_impl="dense")
                logit_err = max(logit_err, (got[0, -1].float() - ref[0, -1]
                                            .float()).abs().max().item())
                logit_mag = max(logit_mag,
                                ref[0, -1].float().abs().max().item())
            if not logit_err <= 6.25e-2 * max(1.0, logit_mag):
                raise AssertionError(f"MoE prefill logits: flash vs plain "
                                     f"err {logit_err} (|logit| <= "
                                     f"{logit_mag})")
            solo = [greedy_decode(params, q[None], N_NEW, cfg, device=dev)[0]
                    for q in prompts]
            r.update(prefill_logit_max_abs_err=logit_err,
                     prefill_logit_max_abs=logit_mag,
                     requests_equal_solo_frac=sum(
                         torch.equal(a, b) for a, b in zip(outs, solo))
                     / len(outs))

        def expect():
            return engine.last_stats["waves"] * (
                tally["int8_matmul"] if quant else cfg.n_layers)

        summary, by_name, attempts = profiled(
            lambda: engine(prompts, N_NEW, slots=SLOTS),
            "int8_mm" if quant else "paged_decode_kernel", expect,
            f"serve_moe_flagship {name} profile")
        r["profile"] = {**summary, "by_name": by_name,
                        "by_name_expected": expect(),
                        "by_name_attempts": attempts}
        rec[name] = r
        counts[name] = launches
        del engine
        torch.cuda.empty_cache()
    return rec, (params, cfg), counts


def decode_moe_flagship(params, cfg, dev, smi: str) -> tuple[dict, dict]:
    """``bench.py section_decode_moe``'s shape (batch 8, prompt 512, dense
    prefill, 64 new tokens) on the flagship MoE configuration through
    ``make_decoder`` (a prefill and one replay a call, the decoder built
    once a shape and kept) and through the eager loop, bf16 weights over
    the int8 cache (K6 each step and layer) and over the bf16 cache: decode
    tokens/s by the two-point method, the median of DECODE_RUNS turns with
    its min-max, the launch counts of one replayed call and the replayed
    tokens against the eager loop's. Returns the record and the int8-cache
    call's launch counts."""
    import dataclasses

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        make_decoder,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build

    dcfg = dataclasses.replace(cfg, attn="dense", batch=DECODE_BATCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    prompt = torch.randint(0, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT),
                           generator=g, device=dev)
    rec: dict = {"card": smi, "batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
                 "n_new": DECODE_NEW, "runs": DECODE_RUNS,
                 "experts": cfg.n_experts, "top_k": cfg.router_top_k}
    int8_launches = None
    for cache_dtype in ("int8", "bf16"):
        decoders: dict = {}

        def replayed(n, p, cache_dtype=cache_dtype, decoders=decoders):
            if n not in decoders:
                decoders[n] = make_decoder(dcfg, n_new=n,
                                           cache_dtype=cache_dtype,
                                           device=dev)
            return decoders[n](params, p)

        def eager(n, p, cache_dtype=cache_dtype):
            return greedy_decode(params, p, n, dcfg, cache_dtype=cache_dtype,
                                 device=dev)

        replayed(DECODE_NEW, prompt)       # the capture, outside the count
        _build.reset_launches()
        toks = replayed(DECODE_NEW, prompt)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        steps = (DECODE_NEW - 1) * dcfg.n_layers
        want = {**{k: 0 for k in launches},
                "kv_decode": steps if cache_dtype == "int8" else 0}
        if launches != want or len(decoders[DECODE_NEW].graphs) != 1:
            raise AssertionError(f"decode_moe_flagship {cache_dtype} cache "
                                 f"launched {launches}, expected {want}")
        eager_toks = eager(DECODE_NEW, prompt)
        rep = decode_rates(replayed, DECODE_NEW, prompt)
        eag = decode_rates(eager, DECODE_NEW, prompt)
        rec[f"bf16_weights_{cache_dtype}_cache"] = dict(
            replayed=rep, eager=eag, launches=launches,
            step_ms=(rep["decoder_ms"] - rep["prefill_ms"]) / (DECODE_NEW - 1),
            replayed_over_eager=rep["tokens_per_s"] / eag["tokens_per_s"],
            tokens_equal_eager_frac=(toks == eager_toks).float().mean()
            .item())
        if cache_dtype == "int8":
            int8_launches = launches
        decoders.clear()
        torch.cuda.empty_cache()
    return rec, int8_launches


def kernel_flash_bwd_resources() -> dict:
    """One line per instance of the bf16 backward sweeps (K5 fused and K4
    split, the key-block kernel; K3, the query-block kernel; head dims 64
    and 128; bf16 and f32 outputs): registers and spilled bytes a thread
    (cudaFuncGetAttributes), dynamic shared memory and CTAs per SM (the
    occupancy calculator). A spill fails the run. Returns the records by
    (kernel name, output dtype) at head dim 128."""
    import torch

    from nvidia_terraform_modules_tpu_torch.ops.flash_attention import (
        flash_bwd_resources,
    )

    main = {}
    for d in (64, 128):
        for name in ("flash_bwd_fused", "flash_dkv", "flash_dq"):
            for out in (torch.bfloat16, torch.float32):
                rec = flash_bwd_resources(name, d, out_dtype=out)
                emit("kernel_flash_bwd_resources", kernel=name, head_dim=d,
                     out_dtype=str(out), **rec)
                if rec["spill_bytes"]:
                    raise AssertionError(f"{name} d={d} {out}: "
                                         f"{rec['spill_bytes']} B spilled")
                if d == 128:
                    main[name, out] = rec
    return main


def kernel_flash_dq(randn, dev, train_shape, block) -> None:
    """K3 on bf16 inputs at the train step's causal shape (bf16 dQ) and at
    the ring's block (f32 dQ, causal and full): against its plain version,
    twice on the same inputs with equal bits (no atomics, a fixed order),
    and batch row 0 alone with the bits it has in the batch."""
    import torch

    from nvidia_terraform_modules_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_dq,
        flash_dq_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    cases = [((*train_shape, 16, 128), True, torch.bfloat16),
             (block, True, torch.float32), (block, False, torch.float32)]
    for shape, causal, out_dtype in cases:
        q, k, v, do = (randn(shape, torch.bfloat16) for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        del o
        args = (q, k, v, do, lse, delta)
        kw = dict(scale=shape[3] ** -0.5, causal=causal, out_dtype=out_dtype)
        got = flash_dq(*args, **kw)
        again = flash_dq(*args, **kw)
        alone = flash_dq(*(t[:1].contiguous() for t in args), **kw)
        ref = flash_dq_ref(*args, **kw)
        sync()
        err = grad_errors((got,), (ref,), "bf16",
                          f"flash_dq {list(shape)} causal={causal}")
        if not torch.equal(got, again):
            raise AssertionError(f"flash_dq {list(shape)}: two calls differ")
        if not torch.equal(alone, got[:1]):
            raise AssertionError(f"flash_dq {list(shape)}: row 0 alone "
                                 f"differs from row 0 in the batch")
        emit("kernel_flash_dq_check", shape=list(shape), causal=causal,
             out_dtype=str(out_dtype), max_abs_err=err[0], rel_l2_err=err[1],
             deterministic=True, row_alone_equal=True)
        del args, got, again, alone, ref, q, k, v, do, lse, delta


def kernel_flash_bwd(randn, dev, train_shape) -> dict:
    """K5 and K3 + K4 against their plain versions, fused against split,
    each timed beside its bound; returns the main-path shape's record of
    each kernel."""
    import torch
    import torch.nn.functional as F

    from nvidia_terraform_modules_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_dkv,
        flash_dkv_ref,
        flash_dq,
        flash_dq_ref,
        flash_dqdkv,
        flash_dqdkv_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        sync,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    h, d = 16, 128
    kernel_of = {"flash_bwd_fused": flash_dqdkv, "flash_dq": flash_dq,
                 "flash_dkv": flash_dkv}
    plain_of = {"flash_bwd_fused": flash_dqdkv_ref, "flash_dq": flash_dq_ref,
                "flash_dkv": flash_dkv_ref}
    cases = [(1, s, bf16, "causal", False) for s in (128, 512, 136)]
    cases += [(1, 512, bf16, ("window", 128), False),
              (1, 512, bf16, "full", False), (1, 256, f32, "causal", False),
              (*train_shape, bf16, "causal", True)]
    main: dict = {}
    for b, s, dtype, mask, on_path in cases:
        q, k, v, do = (randn((b, s, h, d), dtype) for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, mask=mask)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
            .contiguous()
        args = (q, k, v, do, lse, delta)
        kw = dict(scale=d ** -0.5, mask=mask)
        got = {"flash_bwd_fused": flash_dqdkv(*args, **kw),
               "flash_dq": (flash_dq(*args, **kw),),
               "flash_dkv": flash_dkv(*args, **kw)}
        ref = flash_dqdkv_ref(*args, **kw)
        sync()
        ref_of = {"flash_bwd_fused": ref, "flash_dq": ref[:1],
                  "flash_dkv": ref[1:]}
        kind = "bf16" if dtype == bf16 else "f32"
        case = f"{[b, s, h, d]} {dtype} {mask}"
        errs = {name: grad_errors(outs, ref_of[name], kind, f"{name} {case}")
                for name, outs in got.items()}
        grad_errors(got["flash_bwd_fused"],
                    got["flash_dq"] + got["flash_dkv"], kind,
                    f"fused vs split {case}")
        if on_path:
            emit("kernel_flash_bwd_check", shape=[b, s, h, d],
                 ref_median_abs=[r.float().abs().median().item()
                                 for r in ref],
                 ref_max_abs=[r.float().abs().max().item() for r in ref],
                 tolerance=dict(zip(("max_abs", "rel_l2"), BWD_TOL[kind])),
                 planted_faults=planted_faults(got["flash_bwd_fused"], ref,
                                               kind))
        del got, ref, ref_of
        # yardstick: SDPA's own backward on the same inputs, timed alone
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        if mask == "causal":
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            live = s * (s + 1) / 2
        elif mask == "full":
            out = F.scaled_dot_product_attention(qt, kt, vt)
            live = float(s * s)
        else:
            w = mask[1]
            idx = torch.arange(s, device=dev)
            amask = (idx[:, None] >= idx[None, :]) & (
                idx[:, None] - idx[None, :] < w)
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)
            live = float(sum(min(i + 1, w) for i in range(s)))
        dot = do.transpose(1, 2)
        library_ms = cuda_median_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
        del out, qt, kt, vt
        fwd_flops = 4.0 * b * h * d * live
        n, elt = b * s * h * d, q.element_size()
        for name, kernel in kernel_of.items():
            ms = cuda_median_ms(lambda kernel=kernel: kernel(*args, **kw))
            plain_ms = cuda_median_ms(
                lambda name=name: plain_of[name](*args, **kw), iters=5,
                warmup=1)
            nbytes = (4 + BWD_OUTPUTS[name]) * n * elt + 2 * b * h * s * 4
            bound_ms, bound_by = bound(BWD_FACTOR[name] * fwd_flops, nbytes,
                                       "bf16" if dtype == bf16 else "f32")
            rec = dict(kernel=name, shape=[b, s, h, d], dtype=str(dtype),
                       mask=mask, main_path=on_path,
                       max_abs_err=errs[name][0], rel_l2_err=errs[name][1],
                       ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            emit("kernel_flash_bwd", **rec)
            if on_path:
                main[name] = rec
    return main


def train_exact(dev) -> None:
    """The train step's gradients on the card, f32 at head_dim 128: the
    kernels (fused and split) against the dense model, fused against
    split, remat and accumulation against the plain pass; then five SGD and
    five AdamW steps each lower the loss (the reference's burnin_ok)."""
    import dataclasses

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        init_params,
        make_adamw_train_step,
        make_grads_fn,
        make_train_step,
        synthetic_batch,
    )

    cfg = BurnInConfig(vocab=512, d_model=256, n_heads=2, d_ff=512,
                       n_layers=2, seq_len=128, batch=2, attn="flash",
                       dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                         device=dev)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(4), cfg,
                            device=dev)

    def grads(accum_steps=1, **over):
        return make_grads_fn(dataclasses.replace(cfg, **over),
                             accum_steps=accum_steps)(params, batch)

    runs = {"fused": grads(), "split": grads(flash_backward="split"),
            "dense": grads(attn="dense"), "remat": grads(remat=True),
            "accum2": grads(accum_steps=2)}
    checks = {  # name: (got, want, limit, floor of the magnitude)
        "fused_vs_dense": ("fused", "dense", 1e-4, 1.0),
        "split_vs_dense": ("split", "dense", 1e-4, 1.0),
        "fused_vs_split": ("fused", "split", 1e-5, 1.0),
        "remat_vs_plain": ("remat", "fused", 1e-6, None),
        "accum2_vs_full": ("accum2", "fused", 1e-5, 1.0),
    }
    errs = {}
    for name, (a, b, lim, floor) in checks.items():
        (la, ga), (lb, gb) = runs[a], runs[b]
        loss_err = abs(la.item() - lb.item()) / max(1.0, abs(lb.item()))
        errs[name] = max(loss_err, max_rel_err(ga, gb, floor))
        if not errs[name] <= lim:
            raise AssertionError(f"train_exact {name}: {errs[name]} > {lim}")
    sgd = make_train_step(cfg, device=dev)
    init, adamw = make_adamw_train_step(cfg, device=dev)
    p, losses_sgd = params, []
    for _ in range(5):
        p, loss = sgd(p, batch)
        losses_sgd.append(loss.item())
    p, state, losses_adamw = params, init(params), []
    for _ in range(5):
        p, state, loss = adamw(p, state, batch)
        losses_adamw.append(loss.item())
    emit("train_exact", errors=errs, losses_sgd=losses_sgd,
         losses_adamw=losses_adamw)
    for name, ls in (("sgd", losses_sgd), ("adamw", losses_adamw)):
        if not ls[-1] < ls[0]:
            raise AssertionError(f"train_exact: {name} loss did not fall "
                                 f"{ls}")


def _flagship_train(dev):
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        FLAGSHIP_TRAIN,
        BurnInConfig,
        synthetic_batch,
    )

    cfg = BurnInConfig(**FLAGSHIP_TRAIN, dtype=torch.bfloat16)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(SEED + 2),
                            cfg, device=dev)
    return cfg, batch


def train_flagship(params, dev) -> tuple[dict, dict]:
    """The flagship burn-in step at full width and depth: SGD steps timed
    on the host clock (each ending in a synchronise), the launch counts of
    one fused and one split step, then AdamW steps. Returns the phase
    record and the timed run's launch counts."""
    import dataclasses
    import math

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        FLAGSHIP_TRAIN,
        make_adamw_train_step,
        make_train_step,
        train_step_flops,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        sync,
        synced_ms,
    )

    cfg, batch = _flagship_train(dev)
    state = {"p": params}

    def timed(fn, n):
        losses, ms = synced_ms(fn, n)
        return [loss.item() for loss in losses], ms

    def make_sgd(**over):
        step = make_train_step(dataclasses.replace(cfg, **over), lr=TRAIN_LR,
                               device=dev)

        def run():
            state["p"], loss = step(state["p"], batch)
            return loss
        return run

    def counted(fn):
        _build.reset_launches()
        fn()
        sync()
        return dict(_build.launches)

    sgd = make_sgd()
    timed(sgd, WARM_STEPS)
    expect = {**{name: 0 for name in _build.launches},
              "flash_fwd": cfg.n_layers, "flash_bwd_fused": cfg.n_layers}
    fused_launches = counted(sgd)
    if fused_launches != expect:
        raise AssertionError(f"fused step launches {fused_launches}, "
                             f"expected {expect}")
    split_launches = counted(make_sgd(flash_backward="split"))
    if split_launches != {**expect, "flash_bwd_fused": 0,
                          "flash_dq": cfg.n_layers,
                          "flash_dkv": cfg.n_layers}:
        raise AssertionError(f"split step launches {split_launches}")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, step_ms = timed(sgd, TIMED_STEPS)
    launches = dict(_build.launches)
    peak_sgd = torch.cuda.max_memory_allocated()
    if launches != {k: c * TIMED_STEPS for k, c in expect.items()}:
        raise AssertionError(f"timed steps launched {launches}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"flagship SGD loss did not fall: {losses}")

    init, adamw = make_adamw_train_step(cfg, device=dev)
    opt = {"s": init(state["p"])}

    def adamw_step():
        state["p"], opt["s"], loss = adamw(state["p"], opt["s"], batch)
        return loss

    torch.cuda.reset_peak_memory_stats()
    adamw_losses, adamw_ms = timed(adamw_step, ADAMW_STEPS)
    flops = train_step_flops(cfg)
    rec = dict(config={**FLAGSHIP_TRAIN, "dtype": "bfloat16"},
               params=sum(p.numel() for p in tree_leaves(params)),
               train_step_flops=flops, lr=TRAIN_LR, step_ms=step_ms,
               burnin_tokens_per_s=cfg.batch * cfg.seq_len / step_ms * 1e3,
               burnin_mfu=flops / (step_ms / 1e3)
               / (card_spec().bf16_tflops * 1e12),
               max_memory_allocated=peak_sgd, first_loss=losses[0],
               last_loss=losses[-1], losses=losses, launches=launches,
               fused_step_launches=fused_launches,
               split_step_launches=split_launches, adamw_step_ms=adamw_ms,
               adamw_max_memory_allocated=torch.cuda.max_memory_allocated(),
               adamw_losses=adamw_losses)
    return rec, launches


def train_profile(params, dev) -> dict:
    """One flagship SGD step under torch.profiler: device time by kernel
    against the step's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from nvidia_terraform_modules_tpu_torch.models import make_train_step
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    cfg, batch = _flagship_train(dev)
    step = make_train_step(cfg, lr=TRAIN_LR, device=dev)
    step(params, batch)                    # warm: allocator, cuBLAS plans
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, batch)
        sync()
        wall_ms = (time.monotonic() - t0) * 1e3
    return profile_summary(prof, wall_ms)


def kernel_flash_partial(randn, dev, block) -> dict:
    """K2 against its plain version at the ring's flagship block, bf16 and
    f32, causal (the ring's diagonal block) and full (a visible block);
    normalised, its output must equal K1's on the same inputs bit for bit
    and its LSE K1's within 1e-6 of max(1, |LSE|). Returns the bf16
    records by mask ("diag", "full")."""
    import torch
    import torch.nn.functional as F

    from nvidia_terraform_modules_tpu_torch.ops.flash_attention import (
        as_mask_spec,
        block_liveness,
        flash_attention_fwd,
        flash_partial,
        flash_partial_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        sync,
    )

    b, s, h, d = block
    scale = d ** -0.5
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        for causal in (True, False):
            q, k, v = (randn((b, s, h, d), dtype) for _ in range(3))
            kw = dict(scale=scale, causal=causal)
            got = flash_partial(q, k, v, **kw)
            ref = flash_partial_ref(q, k, v, **kw)
            o1, lse1 = flash_attention_fwd(q, k, v, **kw)
            sync()
            errs = {}
            for name, a, r in zip(("acc", "m", "l"), got, ref):
                errs[name] = (a - r).abs().max().item()
                lim = PARTIAL_TOL[kind] * max(1.0, r.abs().max().item())
                if not errs[name] <= lim:
                    raise AssertionError(f"flash_partial {kind} causal="
                                         f"{causal} {name}: err "
                                         f"{errs[name]} (limit {lim})")
            acc, m, l_ = got
            lm = l_.clamp_min(1e-30)
            norm = (acc / lm.transpose(1, 2)[..., None]).to(dtype)
            vs_k1 = (norm.float() - o1.float()).abs().max().item()
            lse_err = ((m + torch.log(lm) - lse1).abs()
                       / lse1.abs().clamp_min(1.0)).max().item()
            if vs_k1 != 0.0 or not lse_err <= 1e-6:
                raise AssertionError(f"flash_partial {kind} causal={causal} "
                                     f"vs flash_fwd: output {vs_k1} (must "
                                     f"be 0), LSE {lse_err} (limit 1e-6)")
            del got, ref, o1, lse1, norm
            ms = cuda_median_ms(lambda: flash_partial(q, k, v, **kw))
            plain_ms = cuda_median_ms(lambda: flash_partial_ref(q, k, v, **kw),
                                      iters=5, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            live = s * (s + 1) / 2 if causal else float(s * s)
            elt = q.element_size()
            nbytes = 3 * b * s * h * d * elt + b * s * h * d * 4 \
                + 2 * b * h * s * 4
            flops = 4.0 * b * h * d * live
            bound_ms, bound_by = bound(flops, nbytes, kind)
            # live 64x64 tiles of one (batch, head): the sweep's columns
            tiles = int((block_liveness(
                as_mask_spec(None, causal), -(-s // 64), -(-s // 64), 64,
                64) != 0).sum())
            rec = dict(shape=[b, s, h, d], dtype=str(dtype), causal=causal,
                       max_abs_err=errs["acc"], m_err=errs["m"],
                       l_err=errs["l"], tolerance=PARTIAL_TOL[kind],
                       normalised_vs_flash_fwd=vs_k1,
                       lse_vs_flash_fwd=lse_err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, **achieved(flops, ms, bound_ms),
                       tiling=FWD_TILING, live_tiles=tiles,
                       us_per_tile_column=ms * 1e3 / tiles)
            emit("kernel_flash_partial", **rec)
            if kind == "bf16":
                main["diag" if causal else "full"] = rec
    # and at the train step's causal length
    q, k, v = (randn((b, RING_SP * s, h, d), torch.bfloat16)
               for _ in range(3))
    acc, m, l_ = flash_partial(q, k, v, scale=scale, causal=True)
    o1, lse1 = flash_attention_fwd(q, k, v, scale=scale, causal=True)
    lm = l_.clamp_min(1e-30)
    norm = (acc / lm.transpose(1, 2)[..., None]).to(q.dtype)
    lse_err = ((m + torch.log(lm) - lse1).abs()
               / lse1.abs().clamp_min(1.0)).max().item()
    if not torch.equal(norm, o1) or not lse_err <= 1e-6:
        raise AssertionError(f"flash_partial causal S={RING_SP * s} vs "
                             f"flash_fwd: output equal "
                             f"{torch.equal(norm, o1)} (must be), LSE "
                             f"{lse_err} (limit 1e-6)")
    emit("kernel_flash_partial_vs_fwd", shape=list(q.shape), causal=True,
         normalised_equal=True, lse_vs_flash_fwd=lse_err)
    return main


def kernel_flash_bwd_f32_out(randn, dev, block) -> dict:
    """K5, K3 and K4 at the ring's block with f32 outputs (the ring's
    per-block gradients) against their plain versions, causal (the ring's
    diagonal block) and full (a visible block), each timed beside its
    bound, its plain version, SDPA's backward on the same block and the
    same kernel writing bf16. Returns the records by kernel, then by mask
    ("diag", "full")."""
    import torch
    import torch.nn.functional as F

    from nvidia_terraform_modules_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_dkv,
        flash_dkv_ref,
        flash_dq,
        flash_dq_ref,
        flash_dqdkv,
        flash_dqdkv_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        sync,
    )

    kernel_of = {"flash_bwd_fused": flash_dqdkv, "flash_dq": flash_dq,
                 "flash_dkv": flash_dkv}
    plain_of = {"flash_bwd_fused": flash_dqdkv_ref, "flash_dq": flash_dq_ref,
                "flash_dkv": flash_dkv_ref}
    b, s, h, d = block
    main: dict = {name: {} for name in kernel_of}
    for causal in (True, False):
        q, k, v, do = (randn((b, s, h, d), torch.bfloat16) for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        kw = dict(scale=d ** -0.5, causal=causal)
        f32 = dict(kw, out_dtype=torch.float32)
        ref = flash_dqdkv_ref(*args, **f32)
        got = {"flash_bwd_fused": flash_dqdkv(*args, **f32),
               "flash_dq": (flash_dq(*args, **f32),),
               "flash_dkv": flash_dkv(*args, **f32)}
        sync()
        ref_of = {"flash_bwd_fused": ref, "flash_dq": ref[:1],
                  "flash_dkv": ref[1:]}
        errs = {}
        for name in kernel_of:
            if any(g.dtype != torch.float32 for g in got[name]):
                raise AssertionError(f"{name}: out_dtype float32 ignored")
            errs[name] = grad_errors(got[name], ref_of[name], "bf16",
                                     f"{name} f32 out causal={causal}")
        del got, ref, ref_of
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)
        library_ms = cuda_median_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
        del out, qt, kt, vt
        live = s * (s + 1) / 2 if causal else float(s * s)
        n = b * s * h * d
        for name, kernel in kernel_of.items():
            nbytes = 4 * n * q.element_size() + BWD_OUTPUTS[name] * n * 4 \
                + 2 * b * h * s * 4
            bound_ms, bound_by = bound(BWD_FACTOR[name] * 4.0 * b * h * d
                                       * live, nbytes, "bf16")
            rec = dict(
                kernel=name, shape=list(block), causal=causal,
                max_abs_err=errs[name][0], rel_l2_err=errs[name][1],
                ms=cuda_median_ms(lambda kernel=kernel: kernel(*args, **f32)),
                ms_bf16_out=cuda_median_ms(
                    lambda kernel=kernel: kernel(*args, **kw)),
                plain_ms=cuda_median_ms(
                    lambda name=name: plain_of[name](*args, **f32), iters=5,
                    warmup=1),
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            emit("kernel_flash_bwd_f32_out", **rec)
            main[name]["diag" if causal else "full"] = rec
    return main


def _sp_inputs(dev, shape, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev) for _ in range(4)]


def _attn_grads(fn, q, k, v, w):
    """``fn(q, k, v)`` and the gradients of ``sum(out · w)``."""
    import torch

    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    return [out.detach(), *torch.autograd.grad((out * w).sum(), (q, k, v))]


def _sp_check(name, fn, dev, sp, expect) -> dict:
    """f32 sequence-parallel attention ``fn(q, k, v, mesh, causal=...,
    backward=...)`` on a mesh of ``sp`` members of the one card against
    dense attention: the output and dQ/dK/dV held to ``BWD_TOL["f32"]``'s
    max-abs and relative-L2 limits, and the launch counts of one forward +
    backward to ``expect(sp, causal, backward)``."""
    from nvidia_terraform_modules_tpu_torch.ops import (
        _build,
        dense_reference_attention,
    )
    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        plan_mesh,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    mesh = build_mesh(plan_mesh(sp, tp=1, sp=sp), devices=[dev] * sp)
    q, k, v, w = _sp_inputs(dev, RING_EXACT_SHAPE, seed=20 + sp)
    recs = {}
    for causal in (True, False):
        ref = _attn_grads(lambda *a: dense_reference_attention(
            *a, causal=causal), q, k, v, w)
        for backward in ("fused", "split"):
            _build.reset_launches()
            got = _attn_grads(lambda *a: fn(*a, mesh, causal=causal,
                                            impl="flash", backward=backward),
                              q, k, v, w)
            sync()
            launches = {n: c for n, c in _build.launches.items() if c}
            want = expect(sp, causal, backward)
            if launches != want:
                raise AssertionError(f"{name} sp={sp} causal={causal} "
                                     f"{backward}: launches {launches}, "
                                     f"expected {want}")
            err_abs, err_l2 = grad_errors(
                got, ref, "f32", f"{name} sp={sp} causal={causal} "
                                 f"{backward}")
            recs[f"causal={causal} {backward}"] = dict(
                max_abs_err=err_abs, rel_l2_err=err_l2, launches=launches)
    return recs


def _ring_visits(sp, causal):
    return sp * (sp + 1) // 2 if causal else sp * sp


def ring_exact(dev) -> dict:
    """The f32 ring (K2 + K5, and K2 + K3 + K4) on sp = 2 and 4 against
    dense attention, forward and gradients; then planted faults — the last
    visited block dropped from the forward, the dK/dV accumulators not
    sent home in the backward — must fail the same check."""
    import functools

    import torch

    from nvidia_terraform_modules_tpu_torch.ops import (
        dense_reference_attention,
        ring_attention,
        ring_self_attention,
    )
    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        plan_mesh,
        ring_permute,
    )

    def expect(sp, causal, backward):
        n = _ring_visits(sp, causal)
        bwd = ({"flash_bwd_fused": n} if backward == "fused"
               else {"flash_dq": n, "flash_dkv": n})
        return {"flash_partial": n, **bwd}

    out = {f"sp={sp}": _sp_check("ring", ring_self_attention, dev, sp,
                                 expect) for sp in (2, RING_SP)}
    sp = RING_SP
    mesh = build_mesh(plan_mesh(sp, tp=1, sp=sp), devices=[dev] * sp)
    q, k, v, w = _sp_inputs(dev, RING_EXACT_SHAPE, seed=20 + sp)
    scale = q.shape[-1] ** -0.5
    ref = _attn_grads(lambda *a: dense_reference_attention(*a), q, k, v, w)
    hop = functools.partial(ring_permute, mesh=mesh, axis="sp", coords={})
    calls = {"hop": 0, "k2": 0}
    real_k2 = ring_attention.flash_partial

    def hop_not_home(blocks):
        # the backward hops K, V, dK and dV at each of its sp - 1 steps;
        # the two after those are the home hops of dK and dV: left out
        calls["hop"] += 1
        return blocks if calls["hop"] > 4 * (sp - 1) else hop(blocks)

    def k2_last_dropped(q_, k_, v_, **kw):
        # the forward's last visited block folds a zero state
        calls["k2"] += 1
        o_b, m_b, l_b = real_k2(q_, k_, v_, **kw)
        if calls["k2"] == _ring_visits(sp, True):
            return (torch.zeros_like(o_b), torch.full_like(m_b, -1e30),
                    torch.zeros_like(l_b))
        return o_b, m_b, l_b

    def chunks(x):
        return list(x.chunk(sp, dim=1))

    fwd = ring_attention._ring_flash_fwd
    with torch.no_grad():
        outs, lse = fwd(chunks(q), chunks(k), chunks(v), hop, True, scale)
        grads = ring_attention._ring_flash_bwd(
            chunks(q), chunks(k), chunks(v), outs, lse, chunks(w),
            hop_not_home, True, scale, "fused")
        ring_attention.flash_partial = k2_last_dropped
        try:
            dropped, _ = fwd(chunks(q), chunks(k), chunks(v), hop, True,
                             scale)
        finally:
            ring_attention.flash_partial = real_k2
    if calls != {"hop": 4 * (sp - 1) + 2, "k2": _ring_visits(sp, True)}:
        raise AssertionError(f"planted faults: unexpected calls {calls}")
    faults = []
    for what, got in (
            ("last visited block dropped", [torch.cat(dropped, 1)]
             + ref[1:]),
            ("dK/dV not sent home", [ref[0]] + [torch.cat(g, 1)
                                                for g in grads])):
        diff = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        try:
            grad_errors(got, ref, "f32", f"planted fault: {what}")
        except AssertionError:
            faults.append({"fault": what, "max_abs_err": max(diff),
                           "caught": True})
            continue
        raise AssertionError(f"planted fault not caught: {what} {diff}")
    out["planted_faults"] = faults
    out["shape"] = list(RING_EXACT_SHAPE)
    return out


def ulysses_exact(dev) -> dict:
    """f32 Ulysses (K1 + K5, and K1 + K3 + K4, at the full sequence on
    H/sp heads per member) on sp = 2 and 4 against dense attention,
    forward and gradients."""
    from nvidia_terraform_modules_tpu_torch.ops import ulysses_self_attention

    def expect(sp, causal, backward):
        bwd = ({"flash_bwd_fused": sp} if backward == "fused"
               else {"flash_dq": sp, "flash_dkv": sp})
        return {"flash_fwd": sp, **bwd}

    return {f"sp={sp}": _sp_check("ulysses", ulysses_self_attention, dev, sp,
                                  expect)
            for sp in (2, RING_SP)} | {"shape": list(RING_EXACT_SHAPE)}


def _ring_train(dev):
    import dataclasses

    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        make_rules,
        plan_mesh,
    )

    cfg, batch = _flagship_train(dev)
    cfg = dataclasses.replace(cfg, attn="ring")
    rules = make_rules(build_mesh(plan_mesh(RING_SP, tp=1, sp=RING_SP),
                                  devices=[dev] * RING_SP))
    return cfg, batch, rules


def _as_f32(tree):
    """A params-shaped dict/list tree with every leaf cast to f32."""
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_f32(t) for t in tree]
    return tree.float()


def _leaf_names(tree, prefix=""):
    """The paths of a params-shaped tree's leaves, in ``tree_leaves``'
    order."""
    if isinstance(tree, dict):
        return [n for k in tree for n in _leaf_names(tree[k],
                                                     f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _grads_of(params, batch, cfg, rules=None):
    """One gradient pass: the loss and the gradient leaves, f32."""
    from nvidia_terraform_modules_tpu_torch.models import (
        make_grads_fn,
        tree_leaves,
    )

    loss, grads = make_grads_fn(cfg, rules)(params, batch)
    return loss.float(), [g.float() for g in tree_leaves(grads)]


def _flash_grads(params, batch, cfg):
    """The flash step's gradient pass (``attn="flash"``, no rules) in f32
    and in bf16 on the same params and batch: :func:`_grads_vs_flash`'s
    reference."""
    import dataclasses

    import torch

    flash_cfg = dataclasses.replace(cfg, attn="flash")
    return (_grads_of(_as_f32(params), batch, dataclasses.replace(
        flash_cfg, dtype=torch.float32)), _grads_of(params, batch, flash_cfg))


def _grads_vs_flash(params, batch, cfg, rules, label: str,
                    ref=None) -> dict:
    """One gradient pass of ``cfg`` under ``rules`` against the flash
    step's in f32 and in bf16 on the same bf16 params and batch (``ref``,
    or :func:`_flash_grads`). Two bf16 passes differ by their roundings by
    about 1e-2 relative L2 on some gradients, so each gradient of the
    ``label`` step is held to be no further (relative L2) from the f32
    pass than the flash step's is, times ``RING_VS_FLASH``, and within
    ``BWD_TOL["bf16"]``'s max-abs of it; its loss to the flash step's
    within ``BWD_TOL["bf16"]``. Raises past either; returns the record."""
    (loss32, g32), (loss_f, g_flash) = ref or _flash_grads(params, batch,
                                                           cfg)
    loss_r, g_ring = _grads_of(params, batch, cfg, rules)
    grad_errors([loss_r], [loss_f], "bf16", f"{label} vs flash step loss")
    tol_abs = BWD_TOL["bf16"][0]
    leaves = []
    for name, r, f, t in zip(_leaf_names(params), g_ring, g_flash, g32):
        t_norm = t.norm().item()
        ring_l2 = ((r - t).norm().item() / t_norm) if t_norm else 0.0
        flash_l2 = ((f - t).norm().item() / t_norm) if t_norm else 0.0
        err = (r - t).abs().max().item()
        lim = tol_abs * max(1.0, t.abs().max().item())
        l2_lim = max(BWD_TOL["f32"][1], RING_VS_FLASH * flash_l2)
        leaves.append({"leaf": name, f"{label}_rel_l2": ring_l2,
                       "flash_rel_l2": flash_l2, f"{label}_max_abs": err})
        if not (err <= lim and ring_l2 <= l2_lim):
            raise AssertionError(
                f"{label} step gradient {name} against the f32 step: "
                f"max-abs {err} (limit {lim}), relative L2 {ring_l2} (limit "
                f"{l2_lim}; the flash step's {flash_l2})")
    key = f"{label}_rel_l2"
    return {"loss_f32": loss32.item(), "loss_flash": loss_f.item(),
            f"loss_{label}": loss_r.item(),
            f"worst_{label}_rel_l2": max(leaves, key=lambda x: x[key]),
            "worst_ratio": max(leaves, key=lambda x: x[key]
                               / max(x["flash_rel_l2"], 1e-30)),
            f"{label}_vs_flash_limit": RING_VS_FLASH}


def train_ring_flagship(params, dev, flash_step_ms) -> tuple[dict, dict]:
    """The flagship burn-in step with ``attn="ring"`` on a mesh of
    ``RING_SP`` ring members on the one card: its loss on the flash step's
    params and batch held to the flash step's within ``BWD_TOL["bf16"]``
    and its gradients to an f32 step's as closely as the flash step's
    (``RING_VS_FLASH``), SGD steps timed on the host clock, the launch
    counts of one fused and one split step. Returns the phase record and
    the timed run's launch counts."""
    import dataclasses
    import math

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        make_train_step,
        train_step_flops,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        sync,
        synced_ms,
    )

    cfg, batch, rules = _ring_train(dev)
    state = {"p": params}

    vs_flash = _grads_vs_flash(params, batch, cfg, rules, "ring")

    def make_sgd(**over):
        step = make_train_step(dataclasses.replace(cfg, **over), rules,
                               lr=TRAIN_LR)

        def run():
            state["p"], loss = step(state["p"], batch)
            return loss
        return run

    def counted(fn):
        _build.reset_launches()
        fn()
        sync()
        return dict(_build.launches)

    visits = cfg.n_layers * _ring_visits(RING_SP, True)
    sgd = make_sgd()
    synced_ms(sgd, WARM_STEPS)
    expect = {**{name: 0 for name in _build.launches},
              "flash_partial": visits, "flash_bwd_fused": visits}
    fused_launches = counted(sgd)
    if fused_launches != expect:
        raise AssertionError(f"ring step launches {fused_launches}, "
                             f"expected {expect}")
    split_launches = counted(make_sgd(flash_backward="split"))
    if split_launches != {**expect, "flash_bwd_fused": 0,
                          "flash_dq": visits, "flash_dkv": visits}:
        raise AssertionError(f"ring split step launches {split_launches}")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, step_ms = synced_ms(sgd, TIMED_STEPS)
    launches = dict(_build.launches)
    losses = [loss.item() for loss in losses]
    if launches != {k: c * TIMED_STEPS for k, c in expect.items()}:
        raise AssertionError(f"timed ring steps launched {launches}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ring SGD loss did not fall: {losses}")
    flops = train_step_flops(cfg)
    rec = dict(config={**dataclasses.asdict(cfg), "dtype": "bfloat16"},
               mesh={"sp": RING_SP, "devices": [str(dev)] * RING_SP},
               train_step_flops=flops, lr=TRAIN_LR, step_ms=step_ms,
               burnin_tokens_per_s=cfg.batch * cfg.seq_len / step_ms * 1e3,
               burnin_mfu=flops / (step_ms / 1e3)
               / (card_spec().bf16_tflops * 1e12),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               first_loss=losses[0], last_loss=losses[-1], losses=losses,
               launches=launches, fused_step_launches=fused_launches,
               split_step_launches=split_launches,
               flash_step_ms=flash_step_ms,
               vs_flash_step=step_ms / flash_step_ms,
               grads_vs_flash_step=vs_flash)
    return rec, launches


def train_ring_profile(params, dev) -> dict:
    """One ring SGD step under torch.profiler: device time by kernel
    against the step's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from nvidia_terraform_modules_tpu_torch.models import make_train_step
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    cfg, batch, rules = _ring_train(dev)
    step = make_train_step(cfg, rules, lr=TRAIN_LR)
    step(params, batch)                    # warm: allocator, cuBLAS plans
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, batch)
        sync()
        wall_ms = (time.monotonic() - t0) * 1e3
    return profile_summary(prof, wall_ms)


# the validation Job's legs that the card must pass (the CLI's JSON line)
SMOKETEST_LEGS = ("psum_ok", "burnin_ok", "decode_ok", "serve_engine_ok",
                  "serve_sched_ok", "paged_decode_ok", "serve_fleet_ok",
                  "fleet_chaos_ok", "kv_spill_ok")
# SGD steps from one set of weights for the sharded/unsharded comparison
SHARDED_STEPS = 3
# the flagship train state through the checkpoint engine: AdamW steps of
# the exact-resume comparison (a save after half of them); timed saves
# (snapshot and commit apart) and steps, alone and with an async save
# after each
CKPT_RESUME_STEPS, CKPT_SAVES, CKPT_STEPS = 4, 3, 3
# where the checkpoint phases write: a fresh directory under the checkout
# (git-ignored), removed at the end of each phase
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_checkpoints")
# launcher variables the smoke test's CLI must not inherit: it runs here
# as a world of one over NCCL
_WORLD_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "TPU_SMOKETEST_HOSTS",
               "TPU_SMOKETEST_PLATFORM", "TPU_SMOKETEST_CHECKPOINT_DIR",
               "TPU_SMOKETEST_SLICES", "TPU_TELEMETRY_DIR")


def _smoketest_verdict(checks: dict, where: str) -> None:
    bad = [k for k in SMOKETEST_LEGS if checks.get(k) is not True]
    if not checks.get("ok") or bad or checks.get("backend") != "nccl" \
            or checks.get("devices") != 1:
        raise AssertionError(f"{where}: ok={checks.get('ok')}, legs not "
                             f"passed {bad}, backend "
                             f"{checks.get('backend')}: {checks}")


def _run_cli(level: str = "burnin", **extra) -> tuple[dict, float]:
    """``python -m nvidia_terraform_modules_tpu_torch.smoketest --level
    level`` with one expected device (a world of one over NCCL on this
    card) and ``extra`` variables: its one JSON line and wall seconds."""
    env = {k: v for k, v in os.environ.items()
           if k not in _WORLD_VARS + ("TPU_SMOKETEST_LEVEL",)}
    env.update(TPU_SMOKETEST_EXPECTED_DEVICES="1", **extra)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "nvidia_terraform_modules_tpu_torch.smoketest",
         "--level", level],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    wall_s = time.monotonic() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if out.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"smoketest CLI exited {out.returncode} with "
                             f"{len(lines)} JSON lines: {out.stdout[-3000:]}"
                             f"{out.stderr[-3000:]}")
    return json.loads(lines[0]), wall_s


def smoketest_cli() -> dict:
    """``python -m nvidia_terraform_modules_tpu_torch.smoketest`` as the
    validation Job runs it, at ``burnin`` with one expected device: a
    world of one over NCCL on this card. Its one JSON line must pass every
    leg of ``SMOKETEST_LEGS``."""
    checks, wall_s = _run_cli()
    _smoketest_verdict(checks, "smoketest_cli")
    return dict(wall_s=wall_s, seconds=checks["seconds"],
                backend=checks["backend"], device_kind=checks["device_kind"],
                legs={k: checks[k] for k in SMOKETEST_LEGS},
                leg_seconds=checks["leg_seconds"],
                leg_launches=checks["leg_launches"],
                kv_spill={k: checks[k] for k in ("kv_spill_swapins",
                                                 "kv_spill_spilled_blocks")},
                not_ported=sorted(checks["not_ported"]),
                burnin_loss=[checks["burnin_first_loss"],
                             checks["burnin_last_loss"]])


def smoketest_cli_checkpoint(root: str) -> dict:
    """The CLI at ``burnin`` with ``TPU_SMOKETEST_CHECKPOINT_DIR`` set to
    a fresh directory under ``root``, three times, as a spot pool's Job
    meets it:

    1. fresh: every leg passes, 5 steps saved, the directory cleared (no
       step left in it);
    2. step 3 of the runner's own config planted on the card with the
       port's ``save_checkpoint`` (a preempted pod's leftover): the run
       resumes at 3 and ends at step 8;
    3. the same step planted with its shard file truncated: the run
       passes, counts one quarantined step and starts fresh.

    Returns each run's wall time, leg seconds and leg launches (K7 in
    ``paged_decode``)."""
    import shutil

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        init_params,
        latest_step,
        save_checkpoint,
    )

    d = os.path.join(root, "smoketest")
    shutil.rmtree(d, ignore_errors=True)

    def plant():
        # the runner's config in a world of one: batch max(8, 2 · 1)
        cfg = BurnInConfig(batch=8)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), device="cuda")
        save_checkpoint(d, 3, params)

    def truncate():
        step = os.path.join(d, "step_00000003")
        (shard,) = [os.path.join(step, f) for f in os.listdir(step)
                    if f.endswith(".bin")]
        with open(shard, "r+b") as fh:
            fh.truncate(16)

    runs = {}
    for name, prepare, want in (
            ("fresh", None, dict(burnin_step=5, burnin_checkpoint_saved=5)),
            ("resume", plant, dict(burnin_resumed_step=3, burnin_step=8,
                                   burnin_checkpoint_saved=8)),
            ("quarantine", lambda: (plant(), truncate()),
             dict(checkpoint_quarantined=1, burnin_step=5,
                  burnin_checkpoint_saved=5))):
        if prepare is not None:
            prepare()
        checks, wall_s = _run_cli(TPU_SMOKETEST_CHECKPOINT_DIR=d)
        _smoketest_verdict(checks, f"smoketest_cli_checkpoint {name}")
        got = {k: checks.get(k) for k in want}
        if got != want or not checks.get("burnin_checkpoint_cleared", 0) \
                >= 1 or latest_step(d) is not None or (
                    name != "resume" and "burnin_resumed_step" in checks):
            raise AssertionError(f"smoketest_cli_checkpoint {name}: {got}, "
                                 f"want {want}; cleared "
                                 f"{checks.get('burnin_checkpoint_cleared')},"
                                 f" left {latest_step(d)}: {checks}")
        runs[name] = dict(wall_s=wall_s, seconds=checks["seconds"],
                          leg_seconds=checks["leg_seconds"],
                          leg_launches=checks["leg_launches"],
                          cleared=checks["burnin_checkpoint_cleared"], **got)
    shutil.rmtree(d)
    return runs


def smoketest_inproc() -> tuple[dict, dict]:
    """The same run in this process under ``torch.profiler``, the launch
    counts set to 0 just before it: the ``paged_decode`` leg must have
    launched K7 (its own count, and by name in the profile). Returns the
    record and the run's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.smoketest import run_smoketest
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        result = run_smoketest(level="burnin", env={
            "TPU_SMOKETEST_EXPECTED_DEVICES": "1"})
        sync()
        wall_ms = (time.monotonic() - t0) * 1e3
    launches = dict(_build.launches)
    checks = {"ok": result.ok, **result.checks}
    _smoketest_verdict(checks, "smoketest_inproc")
    k7_leg = checks["leg_launches"].get("paged_decode", {}).get(
        "paged_decode", 0)
    k7_named = kernel_counts(prof, "paged_decode")
    if k7_leg <= 0 or not sum(k7_named.values()):
        raise AssertionError(f"smoketest_inproc: the paged_decode leg "
                             f"launched K7 {k7_leg} times, the profile "
                             f"names {k7_named}")
    summary = profile_summary(prof, wall_ms)
    return dict(seconds=result.seconds, leg_seconds=checks["leg_seconds"],
                leg_launches=checks["leg_launches"], launches=launches,
                paged_decode_k7=k7_leg, k7_kernels_by_name=k7_named,
                device_ms=summary["device_ms"],
                busy_share_profiled=summary["busy_share_profiled"],
                top_kernels=summary["top_kernels"][:6]), launches


def train_sharded_flagship(params, dev) -> tuple[dict, dict]:
    """``FLAGSHIP_TRAIN`` through ``make_train_step(cfg, rules)`` on the
    mesh of a world of one (NCCL) against ``make_train_step(cfg)``.

    - Bit for bit: SHARDED_STEPS SGD steps with the split backward (K1,
      K3 and K4 are deterministic) from the same weights give the same
      losses and parameters.
    - The fused backward (K1 + K5, the main path): K5 adds dQ with float
      atomics, whose order varies from run to run, so two runs of the
      SAME step differ; the first loss must still be equal bit for bit
      (the forward is deterministic) and the parameters after
      SHARDED_STEPS steps within the bf16 tolerance of the backward
      kernels, beside the spread of two unsharded runs.
    - Step ms of each (median of TIMED_STEPS, min–max, after WARM_STEPS)
      and the K1/K5 launches of each timed run (counts set to 0 before).
    Returns the record and the sharded timed run's launch counts."""
    import dataclasses
    import math

    import torch
    import torch.distributed as dist

    from nvidia_terraform_modules_tpu_torch.models import make_train_step
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        make_rules,
        maybe_initialize_distributed,
        plan_mesh,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    cfg, batch = _flagship_train(dev)
    owned = not dist.is_initialized()
    maybe_initialize_distributed({}, device=dev)
    try:
        rules = make_rules(build_mesh(plan_mesh(1)))
        if type(rules.mesh).__name__ != "WorldMesh" or \
                dist.get_backend() != "nccl":
            raise AssertionError(f"not a NCCL world mesh: {rules.mesh}")

        def steps(step, n):
            p, losses = params, []
            for _ in range(n):
                p, loss = step(p, batch)
                losses.append(loss)
            sync()
            return p, losses

        split = dataclasses.replace(cfg, flash_backward="split")
        ps, ls = steps(make_train_step(split, rules, lr=TRAIN_LR),
                       SHARDED_STEPS)
        pu, lu = steps(make_train_step(split, lr=TRAIN_LR, device=dev),
                       SHARDED_STEPS)
        from nvidia_terraform_modules_tpu_torch.models import tree_leaves

        split_bitwise = all(torch.equal(a, b) for a, b in zip(ls, lu)) and \
            all(torch.equal(a, b)
                for a, b in zip(tree_leaves(ps), tree_leaves(pu)))
        if not split_bitwise:
            raise AssertionError(
                f"split backward: sharded step != unsharded, losses "
                f"{[x.item() for x in ls]} vs {[x.item() for x in lu]}, "
                f"max rel {max_rel_err(ps, pu, None)}")
        del ps, pu
        sharded = make_train_step(cfg, rules, lr=TRAIN_LR)
        plain = make_train_step(cfg, lr=TRAIN_LR, device=dev)
        ps, ls = steps(sharded, SHARDED_STEPS)
        pu, lu = steps(plain, SHARDED_STEPS)
        pu2, _ = steps(plain, SHARDED_STEPS)
        err = max_rel_err(ps, pu, None)
        spread = max_rel_err(pu2, pu, None)
        tol = BWD_TOL["bf16"][1]
        if not torch.equal(ls[0], lu[0]) or not err <= tol:
            raise AssertionError(
                f"fused backward: first loss {ls[0].item()} vs "
                f"{lu[0].item()}, params max rel {err} (tol {tol}; two "
                f"unsharded runs {spread})")
        del ps, pu, pu2
        state = {}

        def timed(name, step):
            state[name] = params
            for _ in range(WARM_STEPS):
                state[name], _ = step(state[name], batch)
            sync()
            _build.reset_launches()
            times, losses = [], []
            for _ in range(TIMED_STEPS):
                t0 = time.monotonic()
                state[name], loss = step(state[name], batch)
                sync()
                times.append((time.monotonic() - t0) * 1e3)
                losses.append(loss.item())
            launches = dict(_build.launches)
            if not all(map(math.isfinite, losses)) or \
                    not losses[-1] < losses[0]:
                raise AssertionError(f"{name}: loss did not fall: {losses}")
            state.pop(name)
            times.sort()
            return dict(step_ms=times[len(times) // 2], min_ms=times[0],
                        max_ms=times[-1], losses=[losses[0], losses[-1]],
                        launches={k: c for k, c in launches.items() if c})

        rec_s = timed("sharded", sharded)
        rec_u = timed("unsharded", plain)
        expect = {"flash_fwd": cfg.n_layers * TIMED_STEPS,
                  "flash_bwd_fused": cfg.n_layers * TIMED_STEPS}
        for name, r in (("sharded", rec_s), ("unsharded", rec_u)):
            if r["launches"] != expect:
                raise AssertionError(f"{name} timed steps launched "
                                     f"{r['launches']}, expected {expect}")
        launches = {**{k: 0 for k in _build.launches}, **rec_s["launches"]}
    finally:
        if owned:
            dist.destroy_process_group()
    rec = dict(mesh=dict(rules.mesh.shape), backend="nccl",
               split_bitwise=split_bitwise, split_losses=[x.item()
                                                           for x in ls],
               fused_first_loss_equal=True, fused_params_max_rel=err,
               fused_two_unsharded_runs_max_rel=spread, fused_tol=tol,
               sharded=rec_s, unsharded=rec_u,
               sharded_over_unsharded=rec_s["step_ms"] / rec_u["step_ms"])
    return rec, launches


def _host_free_bytes() -> int:
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemAvailable in /proc/meminfo")


def _bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (bf16 compared as int16)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def train_checkpoint_flagship(params, dev, root: str) -> tuple[dict, dict]:
    """The flagship AdamW train state (bf16 parameters, f32 moments, the
    int32 step) at world 1 through ``Checkpointer`` in a fresh directory
    under ``root``, removed at the end. First the directory's free space
    and the host's free RAM; the phase fails if the disk cannot hold two
    saves (one committed, one in flight).

    - Exact resume, with the split backward (K3 + K4: K5's dQ atomics
      vary bits between runs): CKPT_RESUME_STEPS uninterrupted steps
      against half of them, a save, ``close()``, a fresh ``Checkpointer``
      and ``restore_tree(abstract_train_state(cfg))`` into new tensors,
      then the other half. The restored state equals the saved one, and
      the final parameters, moments and step the uninterrupted run's, bit
      for bit.
    - Cost, with the fused step (K1 + K5): the step alone (median of
      CKPT_STEPS), then CKPT_SAVES async saves, each timed apart — the
      synchronous snapshot (what the loop waits for) and its commit
      (write, crc32 beside the writes, fsync, rename) — a restore onto the
      card, and CKPT_STEPS steps with an async save after each (the
      checkpointed step, which waits for the previous commit). Bytes per
      second beside each; the snapshot's median leaves out the first save,
      which allocates the pinned staging buffers.
    Returns the record and the launch counts of the checkpointed steps
    (K1, K5) and of the exact-resume run (K1, K3, K4)."""
    import dataclasses
    import shutil

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        AdamWConfig,
        Checkpointer,
        abstract_train_state,
        make_adamw_train_step,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    cfg, batch = _flagship_train(dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    param_bytes = sum(p.numel() * p.element_size()
                      for p in tree_leaves(params))
    state_bytes = param_bytes + 2 * 4 * n_params + 4
    d = os.path.join(root, "flagship")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    free_disk = shutil.disk_usage(d).free
    free_ram = _host_free_bytes()
    if free_disk < 2 * state_bytes:
        raise AssertionError(
            f"train_checkpoint_flagship: {d} has {free_disk} bytes free, "
            f"two saves of the flagship state need {2 * state_bytes}")
    rec = dict(n_params=n_params, param_bytes=param_bytes,
               state_bytes=state_bytes, directory=d, disk_free=free_disk,
               host_ram_free=free_ram)
    opt = AdamWConfig(lr=1e-3)

    def run(step, p, s, n):
        for _ in range(n):
            p, s, loss = step(p, s, batch)
        sync()
        return p, s, loss

    def leaves(p, s):
        return tree_leaves([p, s["mu"], s["nu"]]) + [s["step"]]

    # -------- exact resume (split backward)
    split = dataclasses.replace(cfg, flash_backward="split")
    init_state, step = make_adamw_train_step(split, opt=opt, device=dev)
    half = CKPT_RESUME_STEPS // 2
    _build.reset_launches()
    ref_p, ref_s, ref_loss = run(step, params, init_state(params),
                                 CKPT_RESUME_STEPS)
    p, s, _ = run(step, params, init_state(params), half)
    with Checkpointer(d, max_to_keep=1) as ck:
        ck.save(half, {"params": p, "opt": s})
    with Checkpointer(d) as ck:
        tree, at, _ = ck.restore_tree(abstract_train_state(cfg, device=dev))
    restored_equal = at == half and all(
        _bits_equal(a, b) for a, b in zip(leaves(p, s),
                                          leaves(tree["params"],
                                                 tree["opt"])))
    del p, s
    p, s, loss = run(step, tree["params"], tree["opt"],
                     CKPT_RESUME_STEPS - half)
    del tree
    resume_launches = {k: c for k, c in _build.launches.items() if c}
    final_equal = torch.equal(loss, ref_loss) and all(
        _bits_equal(a, b) for a, b in zip(leaves(p, s), leaves(ref_p, ref_s)))
    if not (restored_equal and final_equal):
        raise AssertionError(
            f"train_checkpoint_flagship: restored = saved {restored_equal}, "
            f"resumed = uninterrupted {final_equal} (loss {loss.item()} vs "
            f"{ref_loss.item()})")
    rec.update(resume_steps=CKPT_RESUME_STEPS, saved_at=half,
               restored_bitwise=restored_equal, final_bitwise=final_equal,
               resume_loss=loss.item(), resume_launches=resume_launches)
    del p, s, ref_p, ref_s
    shutil.rmtree(d)
    torch.cuda.empty_cache()

    # -------- cost (fused backward)
    init_state, step = make_adamw_train_step(cfg, opt=opt, device=dev)
    p, s, _ = run(step, params, init_state(params), WARM_STEPS)
    step_ms = []
    for _ in range(CKPT_STEPS):
        t0 = time.monotonic()
        p, s, _ = run(step, p, s, 1)
        step_ms.append((time.monotonic() - t0) * 1e3)
    snapshot_ms, commits = [], []
    with Checkpointer(d, max_to_keep=1, async_save=True) as ck:
        for i in range(CKPT_SAVES):
            ck.flush()
            t0 = time.monotonic()
            ck.save(i + 1, {"params": p, "opt": s})
            snapshot_ms.append((time.monotonic() - t0) * 1e3)
            ck.flush()
            commits.append(ck.last_commit)
        t0 = time.monotonic()
        tree, _, _ = ck.restore_tree(abstract_train_state(cfg, device=dev))
        sync()
        restore_s = time.monotonic() - t0
        del tree
        _build.reset_launches()
        ckpt_ms, stall_ms = [], []
        for i in range(CKPT_STEPS):
            t0 = time.monotonic()
            p, s, loss = run(step, p, s, 1)
            t1 = time.monotonic()
            ck.save(CKPT_SAVES + i + 1, {"params": p, "opt": s})
            t2 = time.monotonic()
            ckpt_ms.append((t2 - t0) * 1e3)
            stall_ms.append((t2 - t1) * 1e3)
        launches = {k: c for k, c in _build.launches.items() if c}
        t0 = time.monotonic()
        ck.flush()
        drain_s = time.monotonic() - t0
    shutil.rmtree(d)
    del p, s
    torch.cuda.empty_cache()

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    def per_s(seconds):
        return state_bytes / max(seconds, 1e-12)

    commit = {key: med([c[key] for c in commits])
              for key in ("commit_s", "write_s", "crc_s", "fsync_s")}
    if any(c["bytes"] != commits[0]["bytes"] for c in commits) or \
            commits[0]["bytes"] + 4 < state_bytes:
        raise AssertionError(f"commits wrote {[c['bytes'] for c in commits]}"
                             f" bytes of a {state_bytes}-byte state")
    step_med, ckpt_med = med(step_ms), med(ckpt_ms)
    rec.update(
        step_ms=step_med, step_ms_range=[min(step_ms), max(step_ms)],
        snapshot_ms=med(snapshot_ms[1:]), snapshot_first_ms=snapshot_ms[0],
        snapshot_bytes_per_s=per_s(med(snapshot_ms[1:]) / 1e3),
        commit_s=commit["commit_s"],
        commit_bytes_per_s=per_s(commit["commit_s"]),
        write_s=commit["write_s"], write_bytes_per_s=per_s(commit["write_s"]),
        crc32_s=commit["crc_s"], crc32_bytes_per_s=per_s(commit["crc_s"]),
        fsync_s=commit["fsync_s"],
        restore_s=restore_s, restore_bytes_per_s=per_s(restore_s),
        checkpointed_step_ms=ckpt_med,
        checkpointed_step_ms_range=[min(ckpt_ms), max(ckpt_ms)],
        save_call_ms=med(stall_ms), drain_s=drain_s,
        checkpointed_over_plain=ckpt_med / step_med,
        checkpointed_bytes_per_s=per_s(ckpt_med / 1e3),
        launches=launches)
    expect = {"flash_fwd": cfg.n_layers * CKPT_STEPS,
              "flash_bwd_fused": cfg.n_layers * CKPT_STEPS}
    if launches != expect:
        raise AssertionError(f"checkpointed steps launched {launches}, "
                             f"expected {expect}")
    return rec, {**launches, **{k: c for k, c in resume_launches.items()
                                if k in ("flash_dq", "flash_dkv")}}


# the validation Job's full level on the card: the flagship MoE train step
# (timed steps, median and min-max) and the rules= engine
MOE_TRAIN_STEPS = 5


def _world_of_one(dev):
    """An NCCL world of one on this card (unless one is up) and its rules:
    ``(rules, owned)``; the caller destroys the group when ``owned``."""
    import torch.distributed as dist

    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        make_rules,
        maybe_initialize_distributed,
        plan_mesh,
    )

    owned = not dist.is_initialized()
    maybe_initialize_distributed({}, device=dev)
    rules = make_rules(build_mesh(plan_mesh(1)))
    if type(rules.mesh).__name__ != "WorldMesh" or \
            dist.get_backend() != "nccl":
        raise AssertionError(f"not a NCCL world mesh: {rules.mesh}")
    return rules, owned


def train_moe_exact(dev) -> dict:
    """The MoE train step's f32 gradients on the card (4 experts, top-2, at
    a capacity factor of 1.25, so routing may drop assignments): the flash
    kernels (fused and split backward) against the dense-attention model,
    fused against split; five SGD steps lower the loss."""
    import dataclasses

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        init_params,
        make_grads_fn,
        make_train_step,
        synthetic_batch,
    )

    cfg = BurnInConfig(vocab=512, d_model=256, n_heads=2, d_ff=512,
                       n_layers=2, seq_len=128, batch=2, attn="flash",
                       n_experts=4, router_top_k=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(13),
                         device=dev)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(14),
                            cfg, device=dev)

    def grads(**over):
        return make_grads_fn(dataclasses.replace(cfg, **over))(params, batch)

    runs = {"fused": grads(), "split": grads(flash_backward="split"),
            "dense": grads(attn="dense")}
    errs = {}
    for name, (a, b, lim) in {"fused_vs_dense": ("fused", "dense", 1e-4),
                              "split_vs_dense": ("split", "dense", 1e-4),
                              "fused_vs_split": ("fused", "split", 1e-5)
                              }.items():
        (la, ga), (lb, gb) = runs[a], runs[b]
        loss_err = abs(la.item() - lb.item()) / max(1.0, abs(lb.item()))
        errs[name] = max(loss_err, max_rel_err(ga, gb))
        if not errs[name] <= lim:
            raise AssertionError(f"train_moe_exact {name}: {errs[name]} > "
                                 f"{lim}")
    step = make_train_step(cfg, lr=0.05, device=dev)
    p, losses = params, []
    for _ in range(5):
        p, loss = step(p, batch)
        losses.append(loss.item())
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_moe_exact: loss did not fall {losses}")
    return dict(errors=errs, losses=losses)


def train_moe_flagship(dev, smi: str) -> tuple[dict, dict]:
    """``FLAGSHIP_TRAIN`` with MOE_EXPERTS experts, top-1 (2.30 B
    parameters; 8,192 tokens a step, the factor capacity 1,280 slots an
    expert) through ``make_train_step(cfg, rules)`` on the mesh of an NCCL
    world of one — the Job's path:

    - two split-backward steps (K3 + K4, deterministic) equal to the
      ``rules=None`` step's bit for bit, losses and parameters;
    - then the fused step (K1 + K5): WARM_STEPS, and MOE_TRAIN_STEPS timed
      on the host clock (each from a synchronise to a synchronise; the
      median and min–max), the launch counts set to 0 just before them (K1
      and K5 one a layer a step), the loss falling, MFU by
      ``train_step_flops`` over the card's dense bf16 peak, and the peak
      memory of the timed steps;
    - one more step under ``torch.profiler``: device time by kernel (the
      expert and routing products, the router's elementwise f32 work)
      against the step's wall clock.
    Returns the record and the timed run's launch counts."""
    import dataclasses
    import math

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from nvidia_terraform_modules_tpu_torch.models import (
        FLAGSHIP_TRAIN,
        BurnInConfig,
        init_params,
        make_train_step,
        synthetic_batch,
        train_step_flops,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.models.moe import (
        expert_capacity,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    cfg = BurnInConfig(**FLAGSHIP_TRAIN, dtype=torch.bfloat16,
                       n_experts=MOE_EXPERTS, router_top_k=MOE_TOP_K)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(
        SEED + 2), cfg, device=dev)
    rules, owned = _world_of_one(dev)
    try:
        def steps(step, n):
            p, losses = params, []
            for _ in range(n):
                p, loss = step(p, batch)
                losses.append(loss)
            sync()
            return p, losses

        split = dataclasses.replace(cfg, flash_backward="split")
        ps, ls = steps(make_train_step(split, rules, lr=TRAIN_LR), 2)
        pu, lu = steps(make_train_step(split, lr=TRAIN_LR, device=dev), 2)
        bitwise = all(torch.equal(a, b) for a, b in zip(ls, lu)) and all(
            torch.equal(a, b)
            for a, b in zip(tree_leaves(ps), tree_leaves(pu)))
        if not bitwise:
            raise AssertionError(
                f"train_moe_flagship: the rules step != the unsharded step "
                f"(split backward), losses {[x.item() for x in ls]} vs "
                f"{[x.item() for x in lu]}, max rel "
                f"{max_rel_err(ps, pu, None)}")
        del ps, pu
        step = make_train_step(cfg, rules, lr=TRAIN_LR)
        p = params
        for _ in range(WARM_STEPS):
            p, _ = step(p, batch)
        sync()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        times, losses = [], []
        for _ in range(MOE_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            p, loss = step(p, batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            p, _ = step(p, batch)
            sync()
            wall_ms = (time.monotonic() - t0) * 1e3
        summary = profile_summary(prof, wall_ms)
    finally:
        if owned:
            dist.destroy_process_group()
    expect = {**{k: 0 for k in launches},
              "flash_fwd": cfg.n_layers * MOE_TRAIN_STEPS,
              "flash_bwd_fused": cfg.n_layers * MOE_TRAIN_STEPS}
    if launches != expect:
        raise AssertionError(f"train_moe_flagship launched {launches}, "
                             f"expected {expect}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_moe_flagship: loss did not fall "
                             f"{losses}")
    times.sort()
    step_ms = times[len(times) // 2]
    flops = train_step_flops(cfg)
    tokens = cfg.batch * cfg.seq_len
    rec = dict(config={**FLAGSHIP_TRAIN, "n_experts": MOE_EXPERTS,
                       "router_top_k": MOE_TOP_K, "dtype": "bfloat16"},
               nvidia_smi=smi, mesh=dict(rules.mesh.shape), backend="nccl",
               params=sum(x.numel() for x in tree_leaves(params)),
               capacity=expert_capacity(tokens * MOE_TOP_K, MOE_EXPERTS,
                                        cfg.capacity_factor),
               split_bitwise=bitwise, lr=TRAIN_LR, train_step_flops=flops,
               step_ms=step_ms, min_ms=times[0], max_ms=times[-1],
               tokens_per_s=tokens / step_ms * 1e3,
               mfu=flops / (step_ms / 1e3) / (card_spec().bf16_tflops
                                                * 1e12),
               max_memory_allocated=peak, losses=losses,
               launches={k: c for k, c in launches.items() if c},
               profile=summary)
    return rec, launches


def serve_rules_flagship(params, cfg, dev, prompts, max_len,
                         smi: str) -> tuple[dict, dict]:
    """The dense flagship engine under ``run(rules=)`` of an NCCL world of
    one, on the flagship prompts: its tokens equal the ``rules=None``
    engine's bit for bit (the same operations: a world of one runs no
    collective); the rules run's launches counted from 0 (K1 one an
    admission and layer, K7 one a wave and layer, the capture's tally
    times the replays); the replayed wave's device and host ms beside the
    unsharded wave's on a pool of the same shape. Then serve_exact's f32
    configuration under the same rules: every request equals its solo
    greedy decode. Returns the record and the rules run's launches."""
    import torch
    import torch.distributed as dist

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        init_params,
        init_paged_cache,
        make_serve_engine,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        host_ms,
        sync,
    )

    nt = -(-max_len // KV_BLOCK)
    engine = make_serve_engine(params, cfg, max_len=max_len,
                               kv_block=KV_BLOCK, device=dev)
    toks = torch.zeros((SLOTS,), dtype=torch.long, device=dev)
    mean_len = sum(p.shape[0] for p in prompts) // len(prompts)

    def wave_ms(rules):
        """The engine's wave (its step for ``rules``) captured over a pool
        of SLOTS full tables at mid-generation: device and host ms."""
        pool = init_paged_cache(cfg, SLOTS, max_len, block_size=KV_BLOCK,
                                num_blocks=1 + SLOTS * nt, rules=rules,
                                device=dev)
        for i in range(SLOTS):
            pool["block_tables"][i] = torch.arange(
                1 + i * nt, 1 + (i + 1) * nt, dtype=torch.int32)
        graph = engine.capture(pool)
        graph.active.fill_(True)
        graph.tokens.copy_(toks)

        def once():
            pool["pos"].fill_(mean_len + N_NEW // 2)
            graph.replay()
        return cuda_median_ms(once), host_ms(once), graph.launches

    plain = engine(prompts, N_NEW, slots=SLOTS)
    plain_ms, plain_host_ms, _ = wave_ms(None)
    rules, owned = _world_of_one(dev)
    try:
        engine(prompts[:SLOTS], 4, slots=SLOTS, rules=rules)     # capture
        sync()
        _build.reset_launches()
        t0 = time.monotonic()
        outs = engine(prompts, N_NEW, slots=SLOTS, rules=rules)
        sync()
        wall_s = time.monotonic() - t0
        launches = dict(_build.launches)
        st = engine.last_stats
        rules_ms, rules_host_ms, per_wave = wave_ms(rules)
        ecfg = _exact_cfg()
        eparams = init_params(ecfg, torch.Generator(device=dev).manual_seed(
            1), device=dev)
        pg = torch.Generator().manual_seed(2)
        eprompts = [torch.randint(0, ecfg.vocab, (n,), generator=pg).to(dev)
                    for n in (16, 24, 8, 32, 16)]
        got = make_serve_engine(eparams, ecfg, max_len=48, kv_block=KV_BLOCK,
                                device=dev)(eprompts, 8, slots=2,
                                            rules=rules)
    finally:
        if owned:
            dist.destroy_process_group()
    solo = [greedy_decode(eparams, p[None], 8, ecfg, device=dev)[0]
            for p in eprompts]
    exact = [torch.equal(a, b) for a, b in zip(got, solo)]
    equal = [torch.equal(a, b) for a, b in zip(outs, plain)]
    admissions, waves = st["requests"], st["waves"]
    expect = {**{k: 0 for k in launches},
              "flash_fwd": admissions * cfg.n_layers,
              "paged_decode": waves * cfg.n_layers}
    if launches != expect:
        raise AssertionError(f"serve_rules_flagship launched {launches}, "
                             f"expected {expect}")
    if not all(equal) or not all(exact):
        raise AssertionError(f"serve_rules_flagship: rules tokens equal to "
                             f"rules=None {equal}; f32 equal to solo decode "
                             f"{exact}")
    rec = dict(nvidia_smi=smi, mesh=dict(rules.mesh.shape), backend="nccl",
               requests=admissions, waves=waves, generated=st["generated"],
               wall_s=wall_s, tokens_per_s=st["generated"] / wall_s,
               ms_per_wave=rules_ms, host_ms_per_wave=rules_host_ms,
               unsharded_ms_per_wave=plain_ms,
               unsharded_host_ms_per_wave=plain_host_ms,
               replay_launches_per_wave=per_wave, captures=engine.captures,
               tokens_equal_to_unsharded=equal, f32_equal_to_solo=exact,
               launches={k: c for k, c in launches.items() if c})
    return rec, launches


def _shard_products(tp: int) -> list[tuple[str, int, int, bool]]:
    """``(name, K, N, [N, K] storage)`` of the flagship's weight products
    at one rank's shard under ``tp``: wq (and wk, wv), wo, up, down and the
    tied head (the embedding split on ``d_model``, read through its
    transpose)."""
    d, f, vocab = 2048, 8192, 8192
    return [("wq", d, d // tp, False), ("wo", d // tp, d, False),
            ("up", d, f // tp, False), ("down", f // tp, d, False),
            ("head", d // tp, vocab, True)]


def kernel_shard_shapes(randn, dev) -> dict:
    """K8 and K6 at the shapes one rank of a tp 2 or tp 4 world gives them
    at the flagship's widths — one card holds one NCCL rank, so this is
    where the kernels meet a multi-card run's shapes: K8 for each of
    :func:`_shard_products` at M = 1, 4 and 8 (the K split
    ``int8_slices`` picks for the shape beside it), and K6 over an int8
    cache of the rank's ``16 / tp`` KV heads at the decode step (batch 8,
    768 rows at positions 512-568). Each against its plain version within
    the int8 kernels' limit, timed beside it and its bound."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import quantize_kv
    from nvidia_terraform_modules_tpu_torch.ops.decode_attention import (
        kv_decode_attention,
        kv_decode_attention_ref,
    )
    from nvidia_terraform_modules_tpu_torch.ops.int8_matmul import (
        int8_matmul,
        int8_matmul_ref,
        int8_slices,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        sync,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    rec: dict = {"int8_matmul": [], "kv_decode": []}
    for tp in (2, 4):
        for name, k, n, trans in _shard_products(tp):
            w = torch.randint(-127, 128, (n, k) if trans else (k, n),
                              generator=randn.gen, device=dev,
                              dtype=torch.int8)
            scale = torch.rand((n,), generator=randn.gen, device=dev) \
                * 2e-3 + 1e-4
            for m in (1, 4, 8):
                x = randn((m, k), bf16)

                def call(x=x, w=w, scale=scale, trans=trans):
                    return int8_matmul(x, w, scale, transpose_rhs=trans)
                out = call()
                ref = int8_matmul_ref(x, w, scale, transpose_rhs=trans)
                sync()
                err = limit_err(out, ref, "bf16",
                                f"int8_matmul tp {tp} {name} M={m}")
                nbytes = k * n + 4 * n + 2 * m * k + 2 * m * n
                bound_ms, bound_by = bound(2.0 * m * k * n, nbytes, "bf16")
                rec["int8_matmul"].append(dict(
                    tp=tp, shape=name, m=m, k=k, n=n, transposed=trans,
                    slices=int8_slices(k, n), max_abs_err=err,
                    ms=cuda_median_ms(call),
                    plain_ms=cuda_median_ms(lambda: int8_matmul_ref(
                        x, w, scale, transpose_rhs=trans)),
                    bound_ms=bound_ms, bound_by=bound_by))
            del w
        b, d, rows, heads = DECODE_BATCH, 128, 768, 16 // tp
        pos_list = [DECODE_PROMPT + 8 * i for i in range(b)]
        q = randn((b, heads, d), bf16)
        (k, ks), (v, vs) = (quantize_kv(randn((b, rows, heads, d), f32))
                            for _ in range(2))
        for i, p_ in enumerate(pos_list):      # rows past pos: planted
            for t in (k, v):
                t[i, p_ + 1:] = 127
            ks[i, p_ + 1:] = 1e4
            vs[i, p_ + 1:] = 1e4
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        kw = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)
        out = kv_decode_attention(q, k, v, pos, **kw)
        ref = kv_decode_attention_ref(q, k, v, pos, **kw)
        sync()
        err = limit_err(out, ref, "bf16", f"kv_decode tp {tp}")
        live = sum(p_ + 1 for p_ in pos_list)
        nbytes = 2 * live * heads * (d + 4) + 2 * b * heads * d * 2 + b * 4
        bound_ms, bound_by = bound(4.0 * heads * d * live, nbytes, "bf16")
        rec["kv_decode"].append(dict(
            tp=tp, b=b, heads=heads, kv_heads=heads, rows=rows,
            max_abs_err=err,
            ms=cuda_median_ms(lambda: kv_decode_attention(q, k, v, pos,
                                                          **kw)),
            plain_ms=cuda_median_ms(lambda: kv_decode_attention_ref(
                q, k, v, pos, **kw), iters=5, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by))
        del q, k, v, ks, vs
    return rec


def decode_rules_flagship(params, cfg, dev, smi: str) -> tuple[dict, dict]:
    """``make_decoder(cfg, rules)`` over the bf16 cache and
    ``make_quantized_decoder(cfg, rules, cache_dtype="int8")`` (weights
    from ``quantize_params(params, rules=)``) on the NCCL world of one, at
    ``decode_int8_flagship``'s shape (batch 8, prompt 512, 64 new) with
    the flash prefill: the tokens equal the ``rules=None`` decoders' bit
    for bit (a world of one runs no collective; its quantised tree equals
    the unsharded one bit for bit); one call's launches counted from 0 —
    K1 once a layer in the prefill, then per step nothing else on the bf16
    cache (the plain masked softmax), 49 K8 and 8 K6 on the int8 stack;
    decode tokens/s of both beside the unsharded decoder's, in turns
    (:func:`decode_rates_ab`). Then ``sample_decode(..., rules)`` (top-p
    0.95 at 0.8; the eager loop, D1 once a token) against ``rules=None``:
    the tokens and launches equal. Returns the record and the launches by
    run."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from nvidia_terraform_modules_tpu_torch.models import (
        make_decoder,
        make_quantized_decoder,
        quantize_params,
        sample_decode,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    bf16 = torch.bfloat16
    dcfg = dataclasses.replace(cfg, attn="flash", batch=DECODE_BATCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    prompt = torch.randint(0, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT),
                           generator=g, device=dev)
    steps = DECODE_NEW - 1
    per_step = dcfg.n_layers * 6 + 1
    rules, owned = _world_of_one(dev)
    rec: dict = {"nvidia_smi": smi, "mesh": dict(rules.mesh.shape),
                 "batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
                 "n_new": DECODE_NEW, "prefill": "flash"}
    launches: dict = {}
    try:
        qparams = quantize_params(params, bf16)
        q_rules = quantize_params(params, bf16, rules)
        rec["quantized_tree_equal"] = all(
            torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
            for a, b in zip(tree_leaves(qparams), tree_leaves(q_rules))
            if hasattr(a, "q"))
        decoders: dict = {}

        def run_of(stack, r):
            weights = params if stack == "bf16" else (
                qparams if r is None else q_rules)

            def run(n, p):
                key = (stack, r is None, n)
                if key not in decoders:
                    decoders[key] = (
                        make_decoder(dcfg, r, n, device=dev)
                        if stack == "bf16" else
                        make_quantized_decoder(dcfg, r, n, dtype=bf16,
                                               cache_dtype="int8",
                                               device=dev))
                return decoders[key](weights, p)
            return run

        for stack in ("bf16", "int8"):
            plain, sharded = run_of(stack, None), run_of(stack, rules)
            want = plain(DECODE_NEW, prompt)
            sharded(DECODE_NEW, prompt)            # the capture
            sync()
            _build.reset_launches()
            got = sharded(DECODE_NEW, prompt)
            sync()
            counted = {k_: c for k_, c in _build.launches.items() if c}
            expect = {"flash_fwd": dcfg.n_layers}
            if stack == "int8":
                expect.update(int8_matmul=steps * per_step,
                              kv_decode=steps * dcfg.n_layers)
            graphs = decoders[(stack, False, DECODE_NEW)].graphs
            if counted != expect or len(graphs) != 1:
                raise AssertionError(
                    f"decode_rules_flagship {stack}: launched {counted}, "
                    f"expected {expect} from one graph ({len(graphs)})")
            if not torch.equal(got, want):
                raise AssertionError(f"decode_rules_flagship {stack}: the "
                                     f"rules decoder's tokens differ")
            ab = decode_rates_ab(plain, sharded, DECODE_NEW, prompt)
            rec[stack] = dict(launches=counted, tokens_equal=True,
                              unsharded_tokens_per_s=ab["a_tokens_per_s"],
                              rules_tokens_per_s=ab["b_tokens_per_s"],
                              rules_over_unsharded=ab["b_over_a"])
            launches[stack] = counted
            decoders.clear()
        # sample_decode (the eager loop; D1 a token) under the rules
        sampled = {}
        for key, r in (("unsharded", None), ("rules", rules)):
            sync()
            _build.reset_launches()
            sampled[key] = sample_decode(params, prompt, DECODE_NEW, dcfg,
                                         SEED, r, temperature=0.8,
                                         top_p=0.95, device=dev)
            sync()
            launches[f"sample_{key}"] = {k_: c for k_, c in
                                         _build.launches.items() if c}
        if not torch.equal(sampled["rules"], sampled["unsharded"]) or \
                launches["sample_rules"] != launches["sample_unsharded"] or \
                launches["sample_rules"].get("sample_draw") != DECODE_NEW:
            raise AssertionError(f"decode_rules_flagship sample_decode: "
                                 f"launches {launches}")
        rec["sample_decode"] = dict(tokens_equal=True,
                                    launches=launches["sample_rules"])
        if not rec["quantized_tree_equal"]:
            raise AssertionError("decode_rules_flagship: quantize_params("
                                 "rules=) differs on a world of one")
    finally:
        if owned:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec, launches


def serve_rules_levers_flagship(params, cfg, dev, prompts, max_len,
                                smi: str) -> tuple[dict, dict]:
    """The engine's levers under ``run(rules=)`` on the NCCL world of one,
    on the flagship prompts: the flagship MoE engine (MOE_EXPERTS experts,
    top-1, bf16), the int8-weight engine (``quantize_params(params,
    rules=)``, int8 pool), the ``spec_k=4`` engine and the sampled engine
    (top-p 0.95 at 0.8), each run with ``rules=None`` and with the rules,
    each run's launches counted from 0 after a warm-up: the tokens equal
    bit for bit and so do the launch counts (K1 an admission and layer;
    K7, or K7-int8 and K8, a wave; D1 a wave and an admission).
    Then ``moe_exact``'s (top-1 and top-2), ``serve_int8_exact``'s and a
    speculative f32 configuration under the same rules: every request
    equals its solo ``greedy_decode(..., rules)``. Returns the record and
    the rules runs' launches by lever."""
    import torch
    import torch.distributed as dist

    from nvidia_terraform_modules_tpu_torch.models import (
        FLAGSHIP_TRAIN,
        BurnInConfig,
        greedy_decode,
        init_params,
        make_serve_engine,
        quantize_params,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    bf16, f32 = torch.bfloat16, torch.float32
    rules, owned = _world_of_one(dev)
    rec: dict = {"nvidia_smi": smi, "mesh": dict(rules.mesh.shape)}
    launches: dict = {}
    try:
        moe_cfg = BurnInConfig(**FLAGSHIP_TRAIN, dtype=bf16,
                               n_experts=MOE_EXPERTS, router_top_k=MOE_TOP_K)
        levers = {
            "moe": (lambda: init_params(
                moe_cfg, torch.Generator(device=dev).manual_seed(SEED),
                device=dev), moe_cfg, dict(max_len=max_len), "paged_decode"),
            "int8_weights": (lambda: quantize_params(params, bf16, rules),
                             cfg, dict(max_len=max_len, cache_dtype="int8"),
                             "paged_decode_int8"),
            "spec_k": (lambda: params, cfg,
                       dict(max_len=max_len + 4, spec_k=4), "flash_fwd"),
            "sampled": (lambda: params, cfg, dict(
                max_len=max_len, sampler={"temperature": 0.8,
                                          "top_p": 0.95}), "sample_draw")}
        for name, (make, lcfg, kw, needed) in levers.items():
            weights = make()
            engine = make_serve_engine(weights, lcfg, kv_block=KV_BLOCK,
                                       device=dev, **kw)
            run_kw = {"rng": SEED} if "sampler" in kw else {}
            outs, counts, stats = {}, {}, {}
            t0 = time.monotonic()
            for key, r in (("unsharded", None), ("rules", rules)):
                engine(prompts[:SLOTS], 4, slots=SLOTS, rules=r,
                       **run_kw)                              # warm-up
                sync()
                _build.reset_launches()
                outs[key] = engine(prompts, N_NEW, slots=SLOTS, rules=r,
                                   **run_kw)
                sync()
                counts[key] = {k_: c for k_, c in _build.launches.items()
                               if c}
                stats[key] = engine.last_stats
            equal = [torch.equal(a, b_) for a, b_ in
                     zip(outs["rules"], outs["unsharded"])]
            if not all(equal) or counts["rules"] != counts["unsharded"] \
                    or not counts["rules"].get(needed):
                raise AssertionError(
                    f"serve_rules_levers_flagship {name}: tokens equal "
                    f"{equal}; launches {counts}")
            rec[name] = dict(
                requests=stats["rules"]["requests"],
                waves=stats["rules"]["waves"],
                generated=stats["rules"]["generated"],
                tokens_equal_to_unsharded=equal, launches=counts["rules"],
                captures=engine.captures,
                wall_s=time.monotonic() - t0)
            launches[name] = counts["rules"]
            del engine, weights
            torch.cuda.empty_cache()
        pg = torch.Generator().manual_seed(2)
        eprompts = [torch.randint(0, 512, (n,), generator=pg).to(dev)
                    for n in (16, 24, 8, 32, 16)]
        long_prompts = [torch.randint(0, 512, (n,), generator=pg).to(dev)
                        for n in (80, 96, 72, 128, 88)]
        periodic = [torch.arange(a, a + per, device=dev).repeat(reps)
                    for a, per, reps in ((3, 4, 5), (40, 3, 6), (7, 5, 4),
                                         (100, 2, 9))]
        exact_cases = {
            "moe_top1": (_moe_exact_cfg(1), False, {}, eprompts),
            "moe_top2": (_moe_exact_cfg(2), False, {}, eprompts),
            "int8_weights": (_exact_cfg(), True,
                             dict(max_len=144, cache_dtype="int8"),
                             long_prompts),
            "spec_k": (_exact_cfg(), False, dict(spec_k=2), periodic)}
        exact = {}
        for name, (ecfg, quant, kw, eps) in exact_cases.items():
            eparams = init_params(ecfg, torch.Generator(
                device=dev).manual_seed(1), device=dev)
            if quant:
                eparams = quantize_params(eparams, f32, rules)
            kw = {"max_len": 48, **kw}
            got = make_serve_engine(eparams, ecfg, kv_block=KV_BLOCK,
                                    device=dev, **kw)(eps, 8, slots=2,
                                                      rules=rules)
            cache_dtype = kw.get("cache_dtype", "bf16")
            exact[name] = [
                torch.equal(a, greedy_decode(eparams, p_[None], 8, ecfg,
                                             rules, cache_dtype=cache_dtype,
                                             device=dev)[0])
                for a, p_ in zip(got, eps)]
        rec["f32_equal_to_solo"] = exact
        if not all(all(v) for v in exact.values()):
            raise AssertionError(f"serve_rules_levers_flagship: f32 tokens "
                                 f"equal to solo decode {exact}")
    finally:
        if owned:
            dist.destroy_process_group()
    return rec, launches


def smoketest_cli_full() -> dict:
    """The CLI at ``--level full`` as a world of one over NCCL: it exits
    0, every burn-in leg passes (``decode_ok`` from the trained shards:
    the line has no ``decode_sharding``), the full level's fabric legs
    are skipped with ``full_skipped`` (one device has no ep or pp
    fabric), and no full-level leg is left under ``not_ported``."""
    checks, wall_s = _run_cli("full")
    _smoketest_verdict(checks, "smoketest_cli_full")
    full_legs = {"all_to_all_ep_ok", "moe_ok", "serving_ok", "pipeline_ok"}
    listed = sorted(full_legs & set(checks["not_ported"]))
    if checks.get("level") != "full" or "full_skipped" not in checks or \
            listed or full_legs & {k for k in checks if k.endswith("_ok")} \
            or checks.get("decode_ok") is not True \
            or "decode_sharding" in checks:
        raise AssertionError(f"smoketest_cli_full: level "
                             f"{checks.get('level')}, full_skipped "
                             f"{checks.get('full_skipped')}, listed "
                             f"{listed}: {checks}")
    return dict(wall_s=wall_s, seconds=checks["seconds"],
                full_skipped=checks["full_skipped"],
                full_legs_not_ported=listed, decode_ok=checks["decode_ok"],
                decode_sharding_key="decode_sharding" in checks,
                leg_seconds=checks["leg_seconds"])


# the pipeline's exactness config (f32) and its flagship: FLAGSHIP_TRAIN's
# widths and depth, one row a microbatch, 8 microbatches (32,768 tokens a
# step) over 2 stages on the one card
PIPE_EXACT = dict(vocab=512, d_model=256, n_heads=4, d_ff=512, n_layers=4,
                  seq_len=256, microbatch=2, n_microbatches=4)
PIPE_FLAGSHIP_PP, PIPE_FLAGSHIP_M = 2, 8
PIPE_WARM, PIPE_TIMED = 2, 5
# the reference tests' tolerances (tests/test_pipeline.py): loss relative,
# gradients (rtol, atol) — GPipe against the unpipelined model, 1F1B
# against the microbatch mean
PIPE_TOL = {"loss": 1e-5, "gpipe": (2e-4, 2e-5), "1f1b": (1e-4, 1e-5)}
# train_ring_world_one: the ring's and Ulysses' losses over 2 bf16 SGD
# steps against the flash step's (PR 16's runs differed by 9.5e-6)
WORLD_ONE_LOSS_REL = 1e-3


def _flash_named(by_name: dict) -> dict:
    """The flash kernels of a profile by role, from their template
    arguments: K1 and K2 share ``flash_fwd_*`` (K2 ``..., true>``), K5 and
    K4 ``flash_bwd_kv_*`` (K5 ``..., true>``; its output type is the
    instance's second argument, ``float`` for the ring's f32 outputs)."""
    import re

    out = {"k1": 0, "k2": 0, "k5": 0, "k5_f32_out": 0, "other": 0}
    for key, n in by_name.items():
        fwd = re.search(r"flash_fwd_\w+<(?:\d+, )?(true|false)>", key)
        bwd = re.search(r"flash_bwd_kv_\w+<([^>]*?)(true|false)>", key)
        if fwd:
            out["k2" if fwd.group(1) == "true" else "k1"] += n
        elif bwd and bwd.group(2) == "true":
            args = [a.strip() for a in bwd.group(1).split(",")]
            f32 = "float" in args or "mma" not in key
            out["k5_f32_out" if f32 else "k5"] += n
        else:
            out["other"] += n
    return out


def _flash_profile(run, expect: dict, what: str) -> dict:
    """The flash kernels of one ``run()`` by role (:func:`_flash_named`),
    profiled after a warm-up step (:func:`profiled`): each role of
    ``expect`` with exactly its count, no other flash kernel."""
    want = {"k1": 0, "k2": 0, "k5": 0, "k5_f32_out": 0, "other": 0,
            **expect}
    summary, named, attempts = profiled(run, "flash_", lambda: want, what,
                                        roles=_flash_named, warm=True)
    if summary["device_ms"] is None:
        return {"not_measured": True}
    return {**_flash_named(named), "profiles": len(attempts)}


def _pipe_check(got, ref, schedule: str, what: str) -> dict:
    """The loss and every gradient of ``got`` against ``ref`` (both
    ``(loss, grads)``) at ``PIPE_TOL``: elementwise ``|g - r| <= atol +
    rtol·|r|``. Raises past it; returns the worst of each."""
    from nvidia_terraform_modules_tpu_torch.parallel.pipeline import _flat

    (loss, grads), (rloss, rgrads) = got, ref
    rtol, atol = PIPE_TOL[schedule]
    loss_rel = abs(float(loss) - float(rloss)) / abs(float(rloss))
    worst = 0.0
    for g, r in zip(_flat(grads), _flat(rgrads)):
        g, r = g.float(), r.float()
        worst = max(worst, ((g - r).abs() - rtol * r.abs()).max().item())
    if not (loss_rel <= PIPE_TOL["loss"] and worst <= atol):
        raise AssertionError(f"{what}: loss rel err {loss_rel} (limit "
                             f"{PIPE_TOL['loss']}), gradient excess "
                             f"{worst} over rtol {rtol} (limit {atol})")
    return {"loss_rel_err": loss_rel, "grad_excess_over_rtol": worst}


def _pipe_batch(cfg, rows: int, dev, seed: int):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    stream = torch.randint(0, cfg.vocab, (rows, cfg.seq_len + 1),
                           generator=g, device=dev)
    return stream[:, :-1], stream[:, 1:]


def _pipe_reference(params, batch, cfg):
    """The unpipelined model's loss and gradients (``reference_loss_fn``,
    the stage's kernels on the card), in the pipeline's tree."""
    import torch

    from nvidia_terraform_modules_tpu_torch.parallel.pipeline import (
        _flat,
        _leaves,
        _unflat,
        reference_loss_fn,
    )

    with torch.enable_grad():
        live = _leaves(params, True)
        loss = reference_loss_fn(live, batch, cfg)
        got = torch.autograd.grad(loss, _flat(live))
    return loss.detach(), _unflat(params, got)


def pipeline_exact(dev) -> tuple[dict, dict]:
    """The pipeline on the card at f32 (``PIPE_EXACT``): GPipe and 1F1B on
    ``[cuda:0] * pp`` for pp 2 and 4, and on a world of one over NCCL (pp
    1: the world form, one rank its only stage), each against the
    unpipelined ``reference_loss_fn`` through the same kernels at
    ``PIPE_TOL``. Planted faults must fail that check: a stage's layers
    applied in reverse order (both schedules) and the last microbatch
    dropped from GPipe's ticks. K1 and K5 counted by name in a profile of
    one GPipe and one 1F1B step at pp 2 (:func:`_flash_profile`). Returns
    the record and the launch counts of the checked runs."""
    import torch
    import torch.distributed as dist

    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.parallel import (
        MeshPlan,
        PipelineConfig,
        build_mesh,
        init_pipeline_params,
        maybe_initialize_distributed,
    )
    from nvidia_terraform_modules_tpu_torch.parallel import pipeline as pl

    cfg = PipelineConfig(**PIPE_EXACT, dtype=torch.float32)
    params = init_pipeline_params(cfg, torch.Generator(
        device=dev).manual_seed(SEED + 40), device=dev)
    batch = _pipe_batch(cfg, cfg.n_microbatches * cfg.microbatch, dev,
                        SEED + 41)
    ref = _pipe_reference(params, batch, cfg)
    fns = {"gpipe": pl._gpipe_value_and_grad,
           "1f1b": pl.pipeline_value_and_grad_1f1b}
    rec = {"config": {**PIPE_EXACT, "dtype": "float32"}, "tolerance":
           PIPE_TOL, "reference_loss": float(ref[0]), "runs": {}}
    _build.reset_launches()
    for pp in (2, 4):
        mesh = build_mesh(MeshPlan(("pp", "dp"), (pp, 1)), devices=[dev] * pp)
        for name, fn in fns.items():
            rec["runs"][f"{name}_pp{pp}"] = _pipe_check(
                fn(params, batch, cfg, mesh), ref, name, f"{name} pp {pp}")
    launches = dict(_build.launches)
    calls = cfg.n_layers * cfg.n_microbatches
    want = {"flash_fwd": 2 * (calls + 2 * calls),
            "flash_bwd_fused": 2 * 2 * calls}
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"pipeline_exact launched {launches}, "
                             f"expected {want}")
    owned = not dist.is_initialized()
    maybe_initialize_distributed({}, device=dev)
    try:
        world = build_mesh(MeshPlan(("pp", "dp"), (1, 1)))
        if type(world).__name__ != "WorldMesh" or \
                dist.get_backend() != "nccl":
            raise AssertionError(f"not a NCCL world mesh: {world}")
        for name, fn in fns.items():
            rec["runs"][f"{name}_world_pp1"] = _pipe_check(
                fn(params, batch, cfg, world), ref, name,
                f"{name} world pp 1")
    finally:
        if owned:
            dist.destroy_process_group()

    # planted faults: each must fail the check
    mesh = build_mesh(MeshPlan(("pp", "dp"), (2, 1)), devices=[dev] * 2)
    real_stage, real_ticks = pl._stage, pl._gpipe_ticks

    def reversed_stage(stage_layers, x, cfg, tp=1, group=None):
        return real_stage({k: w.flip(0) for k, w in stage_layers.items()},
                          x, cfg, tp, group)

    def dropped_ticks(pp, M):
        for t, pairs in real_ticks(pp, M):
            yield t, [(i, f) for i, f in pairs if f != M - 1]

    plants = [("layers reversed", "gpipe", "_stage", reversed_stage),
              ("layers reversed", "1f1b", "_stage", reversed_stage),
              ("last microbatch dropped", "gpipe", "_gpipe_ticks",
               dropped_ticks)]
    caught = []
    for fault, name, attr, fake in plants:
        real = getattr(pl, attr)
        setattr(pl, attr, fake)
        try:
            got = fns[name](params, batch, cfg, mesh)
        finally:
            setattr(pl, attr, real)
        try:
            _pipe_check(got, ref, name, "planted")
        except AssertionError as exc:
            caught.append({"fault": fault, "schedule": name,
                           "caught": True, "check": str(exc)[:200]})
            continue
        raise AssertionError(f"planted fault not caught: {fault} ({name})")
    rec["planted_faults"] = caught

    # K1 and K5 by name: one step of each schedule at pp 2 (the f32
    # instances; K5's writes f32)
    rec["by_name"] = {name: _flash_profile(
        lambda fn=fn: fn(params, batch, cfg, mesh),
        {"k1": calls * (1 if name == "gpipe" else 2), "k5_f32_out": calls},
        f"pipeline_exact {name}") for name, fn in fns.items()}
    rec["launches"] = launches
    return rec, launches


def pipeline_flagship(dev, smi: str) -> tuple[dict, dict]:
    """The pipeline at ``FLAGSHIP_TRAIN``'s widths and depth (bf16; one
    row a microbatch, PIPE_FLAGSHIP_M microbatches: 32,768 tokens a step)
    over PIPE_FLAGSHIP_PP stages on ``[cuda:0] * pp`` — the mesh is the only
    cut. For GPipe, 1F1B and the unpipelined step over the same rows
    (``reference_loss_fn`` on the whole batch): PIPE_WARM steps, then
    PIPE_TIMED steps on the host clock from a synchronise to a synchronise
    (median and min-max), the launch counts set to 0 just before them (K1
    and K5 a step: GPipe 64 and 64, 1F1B 128 and 64), peak memory of the
    timed steps, the loss falling over the first 3 SGD steps, and MFU
    with 1F1B's recompute not billed. Returns the record and the GPipe and
    1F1B timed runs' launch counts."""
    import math

    import torch

    from nvidia_terraform_modules_tpu_torch.models import FLAGSHIP_TRAIN
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.parallel import (
        MeshPlan,
        PipelineConfig,
        build_mesh,
        init_pipeline_params,
        make_pipeline_train_step,
    )
    from nvidia_terraform_modules_tpu_torch.parallel import pipeline as pl
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    widths = {k: FLAGSHIP_TRAIN[k] for k in ("vocab", "d_model", "n_heads",
                                             "d_ff", "n_layers", "seq_len")}
    cfg = PipelineConfig(**widths, microbatch=1,
                         n_microbatches=PIPE_FLAGSHIP_M, dtype=torch.bfloat16)
    pp = PIPE_FLAGSHIP_PP
    mesh = build_mesh(MeshPlan(("pp", "dp"), (pp, 1)), devices=[dev] * pp)
    params0 = init_pipeline_params(cfg, torch.Generator(
        device=dev).manual_seed(SEED + 42), device=dev)
    batch = _pipe_batch(cfg, PIPE_FLAGSHIP_M, dev, SEED + 43)

    def unpipelined_step(params, batch):
        loss, grads = _pipe_reference(params, batch, cfg)
        with torch.no_grad():
            new = {"embed": params["embed"] - TRAIN_LR * grads["embed"],
                   "out_norm": params["out_norm"]
                   - TRAIN_LR * grads["out_norm"],
                   "layers": {k: w - TRAIN_LR * grads["layers"][k]
                              for k, w in params["layers"].items()}}
        return new, loss

    steps = {"gpipe": make_pipeline_train_step(cfg, mesh, lr=TRAIN_LR,
                                               schedule="gpipe"),
             "1f1b": make_pipeline_train_step(cfg, mesh, lr=TRAIN_LR,
                                              schedule="1f1b"),
             "unpipelined": unpipelined_step}
    calls = cfg.n_layers * cfg.n_microbatches
    expect = {"gpipe": (calls, calls), "1f1b": (2 * calls, calls),
              "unpipelined": (cfg.n_layers, cfg.n_layers)}
    flops = pl.pipeline_step_flops(cfg)
    peak = card_spec().bf16_tflops * 1e12
    rec = {"config": {**widths, "microbatch": 1,
                      "n_microbatches": PIPE_FLAGSHIP_M, "pp": pp,
                      "dtype": "bfloat16"},
           "tokens_per_step": PIPE_FLAGSHIP_M * cfg.seq_len,
           "step_flops": flops, "lr": TRAIN_LR, "card": smi}
    counts = {}
    for name, step in steps.items():
        params, losses, times = params0, [], []
        for _ in range(PIPE_WARM):
            params, loss = step(params, batch)
            losses.append(float(loss))
        sync()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        for _ in range(PIPE_TIMED):
            sync()
            t0 = time.perf_counter()
            params, loss = step(params, batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        launches = dict(_build.launches)
        k1, k5 = expect[name]
        got = (launches.get("flash_fwd", 0), launches.get("flash_bwd_fused",
                                                          0))
        if got != (k1 * PIPE_TIMED, k5 * PIPE_TIMED):
            raise AssertionError(f"pipeline_flagship {name}: K1, K5 "
                                 f"launched {got}, expected "
                                 f"{(k1 * PIPE_TIMED, k5 * PIPE_TIMED)}")
        if not all(map(math.isfinite, losses)) or \
                not losses[2] < losses[0]:
            raise AssertionError(f"pipeline_flagship {name}: the loss did "
                                 f"not fall over 3 SGD steps: {losses}")
        times.sort()
        ms = times[len(times) // 2]
        rec[name] = {"step_ms": ms, "step_ms_min": times[0],
                     "step_ms_max": times[-1],
                     "tokens_per_s": rec["tokens_per_step"] / ms * 1e3,
                     "mfu": flops / (ms / 1e3) / peak,
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated(),
                     "k1_per_step": k1, "k5_per_step": k5,
                     "losses": losses, "launches": launches}
        counts[name] = launches
        del params
        torch.cuda.empty_cache()
    for name in ("gpipe", "1f1b"):
        rec[name]["vs_unpipelined"] = (rec[name]["step_ms"]
                                       / rec["unpipelined"]["step_ms"])
    return rec, counts


def train_ring_world_one(dev) -> tuple[dict, dict]:
    """``attn="ring"`` and ``"ulysses"`` through ``make_train_step(cfg,
    rules)`` on the mesh of an NCCL world of one: a ring of one member (K2
    on the diagonal block, K5 with f32 outputs) and Ulysses without an
    all-to-all (K1, K5). At f32 on a small config the first loss equals the
    flash step's bit for bit. At the flagship (bf16) each one's loss and
    gradients on the flash step's params and batch are held to the f32
    flash step's as closely as the bf16 flash step's
    (:func:`_grads_vs_flash`), a check that two planted faults of the
    ring's K2 and K5 must fail; then 2 SGD steps each, their losses within
    ``WORLD_ONE_LOSS_REL`` of the flash step's from the same weights, with
    the launch counts set to 0 before them, and the kernels counted by
    name in a profile of one more step. Returns the record and the
    flagship steps' launch counts."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        init_params,
        make_train_step,
        synthetic_batch,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    rules, owned = _world_of_one(dev)
    rec, counts = {}, {}
    try:
        small = BurnInConfig(vocab=512, d_model=256, n_heads=2, d_ff=512,
                             n_layers=2, seq_len=256, batch=2, attn="flash",
                             dtype=torch.float32)
        p = init_params(small, torch.Generator(device=dev).manual_seed(44),
                        device=dev)
        b = synthetic_batch(torch.Generator(device=dev).manual_seed(45),
                            small, device=dev)
        flash_loss = make_train_step(small, lr=0.05, device=dev)(p, b)[1]
        exact = {}
        for attn in ("ring", "ulysses"):
            loss = make_train_step(dataclasses.replace(small, attn=attn),
                                   rules, lr=0.05, device=dev)(p, b)[1]
            exact[attn] = {"loss": float(loss),
                           "equal": torch.equal(loss, flash_loss)}
            if not exact[attn]["equal"]:
                raise AssertionError(f"train_ring_world_one f32 {attn}: "
                                     f"loss {float(loss)} against the "
                                     f"flash step's {float(flash_loss)}")
        rec["f32_first_loss"] = {"flash": float(flash_loss), **exact}
        del p

        cfg, batch = _flagship_train(dev)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED + 46), device=dev)
        flash_step = make_train_step(cfg, lr=TRAIN_LR, device=dev)
        q, flash_losses = params, []
        for _ in range(2):
            q, loss = flash_step(q, batch)
            flash_losses.append(float(loss))
        rec["flash_losses"] = flash_losses
        ref = _flash_grads(params, batch, cfg)
        rec["planted_faults"] = _world_one_plants(
            params, batch, dataclasses.replace(cfg, attn="ring"), rules, ref)
        roles = {"ring": ("k2", "k5_f32_out", "flash_partial"),
                 "ulysses": ("k1", "k5", "flash_fwd")}
        for attn, (fwd_role, bwd_role, fwd_key) in roles.items():
            acfg = dataclasses.replace(cfg, attn=attn)
            grads = _grads_vs_flash(params, batch, acfg, rules, attn, ref)
            step = make_train_step(acfg, rules, lr=TRAIN_LR, device=dev)
            sync()
            _build.reset_launches()
            q, losses = params, []
            for _ in range(2):
                q, loss = step(q, batch)
                losses.append(float(loss))
            sync()
            launches = dict(_build.launches)
            want = {fwd_key: 2 * cfg.n_layers,
                    "flash_bwd_fused": 2 * cfg.n_layers}
            if {k: launches.get(k, 0) for k in want} != want or \
                    sum(launches.values()) != sum(want.values()):
                raise AssertionError(f"train_ring_world_one {attn} launched "
                                     f"{launches}, expected {want}")
            rel = [abs(a - f) / abs(f) for a, f in zip(losses,
                                                       flash_losses)]
            if not max(rel) <= WORLD_ONE_LOSS_REL:
                raise AssertionError(f"train_ring_world_one {attn}: losses "
                                     f"{losses} against the flash step's "
                                     f"{flash_losses}")
            by_role = _flash_profile(
                lambda step=step, q=q: step(q, batch),
                {fwd_role: cfg.n_layers, bwd_role: cfg.n_layers},
                f"train_ring_world_one {attn}")
            rec[attn] = {"grads_vs_flash_step": grads, "losses": losses,
                         "loss_rel_vs_flash": rel, "launches": launches,
                         "by_name": by_role}
            counts[attn] = launches
        del params, q, ref
    finally:
        if owned:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec, counts


def _world_one_plants(params, batch, cfg, rules, ref) -> list[dict]:
    """The world-of-one ring step's check (:func:`_grads_vs_flash`) against
    known faults: K2's accumulator, or K5's dK, with its rows from S/2 on
    halved (a kernel wrong only far along the sequence) must fail it."""
    from nvidia_terraform_modules_tpu_torch.ops import ring_attention

    def halved(x):
        x = x.clone()
        x[:, x.shape[1] // 2:] *= 0.5
        return x

    plants = {
        "K2 acc rows from S/2 halved": ("flash_partial", lambda out: (
            halved(out[0]), *out[1:])),
        "K5 dK rows from S/2 halved": ("_block_grads", lambda out: (
            out[0], halved(out[1]), out[2]))}
    caught = []
    for fault, (attr, spoil) in plants.items():
        real = getattr(ring_attention, attr)
        setattr(ring_attention, attr,
                lambda *a, real=real, spoil=spoil, **kw: spoil(real(*a, **kw)))
        try:
            _grads_vs_flash(params, batch, cfg, rules, "ring", ref)
        except AssertionError as exc:
            caught.append({"fault": fault, "caught": True,
                           "check": str(exc)[:200]})
            continue
        finally:
            setattr(ring_attention, attr, real)
        raise AssertionError(f"planted fault not caught: {fault}")
    return caught


def flagship_lengths() -> list[int]:
    from nvidia_terraform_modules_tpu_torch.utils.traffic import (
        ragged_lengths,
    )

    lens = ragged_lengths(N_REQUESTS, SEED, lo=128, hi=512)
    return [min(512, max(128, 8 * round(n / 8))) for n in lens]


def _resources(records: dict, name: str, out) -> dict:
    """The registers, spills and CTAs per SM of the bf16 sweep behind a K5,
    K4 or K3 row of the kernels line (the key-block kernel for K5 and K4,
    the query-block kernel for K3)."""
    rec = records.get((name, out))
    if rec is None:
        return {}
    return {key: rec[key] for key in ("registers", "spill_bytes",
                                      "ctas_per_sm")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from nvidia_terraform_modules_tpu_torch.models import (
        FLAGSHIP_TRAIN,
        BurnInConfig,
        cache_rows,
        forward_cached,
        forward_paged,
        greedy_decode,
        init_cache,
        init_paged_cache,
        init_params,
        make_serve_engine,
        quantize_kv,
        quantize_params,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.ops.decode_attention import (
        decode_spans,
        gather_logical,
        kv_decode_attention,
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    from nvidia_terraform_modules_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        host_ms,
        sync,
    )

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    train_shape = (FLAGSHIP_TRAIN["batch"], FLAGSHIP_TRAIN["seq_len"])

    # ------------------------------------------------------------ device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ------------------------------------------------------------- build
    t0 = time.monotonic()
    _build.lib()
    emit("build", seconds=round(time.monotonic() - t0, 3),
         sources=[p.name for p in _build.sources()])

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    randn.gen = gen

    # -------------------------------------------------- kernel_flash_fwd
    lens = flagship_lengths()
    # (batch, S, dtype, mask, KV heads, main path); K1 runs on both paths:
    # at the serve prompts' shapes and at the train step's per-layer shape
    cases = [(1, s, bf16, "causal", 16, False) for s in (128, 512, 136)]
    cases += [(1, 64, f32, "causal", 1, False),
              (1, 512, bf16, ("window", 128), 16, False)]
    cases += [(1, s, bf16, "causal", 16, "serve") for s in sorted(set(lens))]
    cases += [(*train_shape, bf16, "causal", 16, "train")]
    k1_main, k1_train = [], None
    for b, s, dtype, mask, kv, on_path in cases:
        h, d = (16, 128) if kv == 16 else (2, 128)
        q, k, v = (randn((b, s, n, d), dtype) for n in (h, kv, kv))
        o, lse = flash_attention_fwd(q, k, v, mask=mask)
        o_ref, lse_ref = flash_attention_ref(q, k, v, mask=mask)
        sync()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        tol_o, tol_l = (2e-2, 1e-3) if dtype == bf16 else (1e-4, 1e-4)
        if not (err_o <= tol_o and err_l <= tol_l):
            raise AssertionError(f"flash_fwd S={s} {dtype} {mask}: O err "
                                 f"{err_o} (tol {tol_o}), LSE err {err_l} "
                                 f"(tol {tol_l})")
        ms = cuda_median_ms(lambda: flash_attention_fwd(q, k, v, mask=mask))
        plain_ms = cuda_median_ms(
            lambda: flash_attention_ref(q, k, v, mask=mask))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if mask == "causal":
            def lib_call():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=kv != h)
            live = s * (s + 1) / 2
        else:
            w = mask[1]
            idx = torch.arange(s, device=dev)
            amask = (idx[:, None] >= idx[None, :]) & (
                idx[:, None] - idx[None, :] < w)

            def lib_call():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=amask)
            live = sum(min(i + 1, w) for i in range(s))
        library_ms = cuda_median_ms(lib_call)
        elt = q.element_size()
        nbytes = b * ((2 * h + 2 * kv) * s * d * elt + h * s * 4)
        flops = 4.0 * b * h * d * live
        bound_ms, bound_by = bound(flops, nbytes,
                                   "bf16" if dtype == bf16 else "f32")
        rec = dict(shape=[b, s, h, d], kv_heads=kv, dtype=str(dtype),
                   mask=mask, main_path=on_path, max_abs_err=err_o,
                   lse_err=err_l, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, **achieved(flops, ms, bound_ms),
                   tiling=FWD_TILING)
        emit("kernel_flash_fwd", **rec)
        if on_path == "serve":
            k1_main.append((lens.count(s), rec))
        elif on_path == "train":
            k1_train = rec

    # ----------------------------------------------- kernel_paged_decode
    # the flagship wave: SLOTS rows at mid-generation of the first SLOTS
    # requests, the engine's default pool of one full table per slot
    max_len = max(lens) + N_NEW
    wave_pos = [n + N_NEW // 2 for n in lens[:SLOTS]]
    b, h, kv, d, bs = SLOTS, 16, 16, 128, KV_BLOCK
    nt_int8 = cache_rows(max_len, "int8") // bs     # the int8 engine's
    # (q dtype, limit, positions, table width, int8 pool, main path): an
    # int8 pool's table covers cache_rows' 256-row grain
    k7_cases = [(bf16, 1e-2, [559, 301, 77, 130], -(-576 // bs), False,
                 False),
                (f32, 1e-5, [559, 301, 77, 130], -(-576 // bs), False,
                 False),
                (bf16, 1e-2, wave_pos, -(-max_len // bs), False, True),
                (bf16, None, [559, 301, 77, 130], 768 // bs, True, False),
                (f32, None, [559, 301, 77, 130], 768 // bs, True, False),
                (bf16, None, wave_pos, nt_int8, True, True)]
    k7_rec = k7i8_rec = None
    for dtype, tol, pos_list, nt, quant, on_path in k7_cases:
        nb = 1 + b * nt
        k_pool, v_pool = randn((nb, bs, kv, d), dtype), \
            randn((nb, bs, kv, d), dtype)
        ks = vs = None
        if quant:
            (k_pool, ks), (v_pool, vs) = (quantize_kv(t.float()) for t in
                                          (k_pool, v_pool))
            k_pool[0] = 127          # garbage block and its sidecars: a
            v_pool[0] = 127          # read would show
            ks[0] = 1e4
            vs[0] = 1e4
        else:
            k_pool[0] = 1e4          # garbage block: a read would show
            v_pool[0] = 1e4
        pos = torch.tensor(pos_list, dtype=torch.int32)
        tables = torch.zeros((b, nt), dtype=torch.int32)
        for i in range(b):
            n_live = int(pos[i]) // bs + 1
            tables[i, :n_live] = torch.arange(1 + i * nt, 1 + i * nt + n_live)
        if not on_path:
            # row 3 is a frozen, retired slot: its position stays and two
            # of its entries now point at blocks recycled to row 0
            tables[3, 2:4] = tables[0, 5:7]
        tables, pos = tables.to(dev), pos.to(dev)
        q = randn((b, h, d), dtype)
        scale = d ** -0.5
        kw = dict(scale=scale, k_scale=ks, v_scale=vs)
        out = paged_decode_attention(q, k_pool, v_pool, tables, pos, **kw)
        ref = paged_decode_attention_ref(q, k_pool, v_pool, tables, pos,
                                         **kw)
        sync()
        kind = "bf16" if dtype == bf16 else "f32"
        if quant:
            err = limit_err(out, ref, kind, f"paged_decode_int8 {dtype}")
            # the int8 fold is K6's: the same kernel math on the gathered
            # logical view must give the same bits
            rows = nt * bs
            flat = kv_decode_attention(
                q, gather_logical(k_pool, tables, rows),
                gather_logical(v_pool, tables, rows), pos, scale=scale,
                k_scale=gather_logical(ks, tables, rows),
                v_scale=gather_logical(vs, tables, rows))
            sync()
            vs_k6 = (out.float() - flat.float()).abs().max().item()
            if vs_k6 != 0.0:
                raise AssertionError(f"paged_decode_int8 vs kv_decode on "
                                     f"the gathered view: {vs_k6}")
        else:
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"paged_decode {dtype}: err {err} "
                                     f"(tol {tol})")
        ms = cuda_median_ms(lambda: paged_decode_attention(
            q, k_pool, v_pool, tables, pos, **kw))
        plain_ms = cuda_median_ms(lambda: paged_decode_attention_ref(
            q, k_pool, v_pool, tables, pos, **kw))
        # yardstick: SDPA over the PRE-GATHERED (and dequantised) logical
        # view (neither is timed) with the position mask
        k_log = k_pool[tables.long()].reshape(b, nt * bs, kv, d)
        v_log = v_pool[tables.long()].reshape(b, nt * bs, kv, d)
        if quant:
            k_log = (k_log.float() * ks[tables.long()].reshape(
                b, nt * bs, kv, 1)).to(dtype)
            v_log = (v_log.float() * vs[tables.long()].reshape(
                b, nt * bs, kv, 1)).to(dtype)
        k_log, v_log = (x.transpose(1, 2).contiguous() for x in
                        (k_log, v_log))
        amask = (torch.arange(nt * bs, device=dev)[None, :]
                 <= pos.long()[:, None])[:, None, None, :]
        library_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k_log, v_log, attn_mask=amask, scale=scale))
        live = int((pos.long() + 1).sum())
        elt = q.element_size()
        row_bytes = d + 4 if quant else d * elt
        nbytes = 2 * live * kv * row_bytes + 2 * b * h * d * elt \
            + tables.numel() * 4 + b * 4
        bound_ms, bound_by = bound(4.0 * (h // kv) * kv * d * live, nbytes,
                                   kind)
        rec = dict(b=b, heads=h, kv_heads=kv, d=d, block_size=bs,
                   table_width=nt, pos=pos.tolist(), dtype=str(dtype),
                   int8=quant, main_path=on_path, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   ctas=b * kv * decode_spans(nt * bs),
                   live_ctas=kv * sum(decode_spans(p + 1)
                                      for p in pos.tolist()))
        if quant:
            rec["vs_kv_decode_on_gathered_view"] = vs_k6
        emit("kernel_paged_decode", **rec)
        if on_path and quant:
            k7i8_rec = rec
        elif on_path:
            k7_rec = rec

    k6_main = kernel_kv_decode(randn, dev)
    kernel_decode_spans(randn, dev)
    k8_main, k8_decode = kernel_int8_matmul(randn, dev)
    shard_rec = kernel_shard_shapes(randn, dev)
    emit("kernel_shard_shapes", **shard_rec)
    d1_main = kernel_sample_draw(dev, smi)
    emit("probes", **card_probes(smi))

    # ------------------------------------------------------- serve_exact
    cfg = BurnInConfig(vocab=512, d_model=256, n_heads=2, n_kv_heads=1,
                       d_ff=512, n_layers=2, dtype=f32, attn="flash")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    pg = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=pg)
               for n in (16, 24, 8, 32, 16)]
    kw = dict(max_len=48, kv_block=KV_BLOCK, device=dev)
    with_kernels = make_serve_engine(params, cfg, **kw)(prompts, 8, slots=2)
    gather = make_serve_engine(params, cfg, paged_kernel="off", **kw)(
        prompts, 8, slots=2)
    solo = [greedy_decode(params, p[None], 8, cfg, device=dev)[0]
            for p in prompts]
    equal = [torch.equal(a, c) and torch.equal(g, c)
             for a, g, c in zip(with_kernels, gather, solo)]
    emit("serve_exact", requests=len(prompts), equal=equal)
    if not all(equal):
        raise AssertionError(f"serve_exact: tokens differ {equal}")
    del params
    serve_int8_exact(dev)
    serve_graph_exact(dev)
    serve_levers_exact(dev)
    spill_exact = serve_spill_exact(dev)
    emit("serve_spill_exact", **spill_exact)
    fleet_rec, fleet_launches = fleet_exact(dev)
    emit("fleet_exact", nvidia_smi=smi, **fleet_rec)
    scale_rec, scale_launches = fleet_scale_exact(dev)
    emit("fleet_scale_exact", nvidia_smi=smi, **scale_rec)
    serve_sampled_exact(dev)
    serve_spec_exact(dev)
    decode_graph_exact(dev)

    # ---------------------------------------------------- serve_flagship
    nt = -(-max_len // KV_BLOCK)
    cfg = BurnInConfig(**FLAGSHIP_TRAIN, dtype=bf16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    pg = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=pg).to(dev)
               for n in lens]
    engine = make_serve_engine(params, cfg, max_len=max_len,
                               kv_block=KV_BLOCK, device=dev)
    engine(prompts[:SLOTS], 4, slots=SLOTS)        # warm-up, not counted
    sync()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.monotonic()
    outs = engine(prompts, N_NEW, slots=SLOTS)
    sync()
    wall_s = time.monotonic() - t0
    launches = dict(_build.launches)
    peak_bytes = torch.cuda.max_memory_allocated()
    st = engine.last_stats
    admissions, waves = st["requests"], st["waves"]
    if launches["flash_fwd"] != admissions * cfg.n_layers:
        raise AssertionError(f"flash_fwd launched {launches['flash_fwd']}"
                             f" times, expected {admissions} admissions x "
                             f"{cfg.n_layers} layers")
    if launches["paged_decode"] != waves * cfg.n_layers:
        raise AssertionError(f"paged_decode launched "
                             f"{launches['paged_decode']} times, expected "
                             f"{waves} waves x {cfg.n_layers} layers")
    for o in outs:
        if o.shape != (N_NEW,) or int(o.min()) < 0 \
                or int(o.max()) >= cfg.vocab:
            raise AssertionError(f"bad output {o.shape} {o}")
    if st["generated"] != N_REQUESTS * N_NEW:
        raise AssertionError(f"generated {st['generated']}")

    # prefill logits at each prompt's last position: flash kernel vs the
    # plain masked softmax (dense prefill) on the same forward
    logit_err, logit_mag = 0.0, 0.0
    for p in prompts:
        got, _ = forward_cached(params, p[None], init_cache(
            cfg, 1, p.shape[0], device=dev), cfg, prefill_impl="flash")
        want, _ = forward_cached(params, p[None], init_cache(
            cfg, 1, p.shape[0], device=dev), cfg, prefill_impl="dense")
        logit_err = max(logit_err, (got[0, -1].float()
                                    - want[0, -1].float()).abs().max().item())
        logit_mag = max(logit_mag, want[0, -1].float().abs().max().item())
    if not logit_err <= 6.25e-2 * max(1.0, logit_mag):
        raise AssertionError(f"prefill logits: flash vs plain err "
                             f"{logit_err} (|logit| <= {logit_mag})")
    plain = [greedy_decode(params, p[None], N_NEW, cfg, prefill="dense",
                           device=dev)[0] for p in prompts]
    match = sum(torch.equal(a, b_) for a, b_ in zip(outs, plain))

    # where the serve time goes: one admission's prefill and one wave step
    # at the run's shapes, event-timed
    pool1 = init_paged_cache(cfg, 1, max_len, block_size=KV_BLOCK,
                             num_blocks=1 + nt, device=dev)
    pool1["block_tables"][0] = torch.arange(1, 1 + nt, dtype=torch.int32)
    prefill_ms = []
    for p in prompts:
        def admit_once(p=p):
            pool1["pos"].zero_()
            forward_paged(params, p[None], pool1, cfg, prefill_impl="flash",
                          paged_kernel="off")
        prefill_ms.append(cuda_median_ms(admit_once, iters=5, warmup=1))
    poolw = init_paged_cache(cfg, SLOTS, max_len, block_size=KV_BLOCK,
                             num_blocks=1 + SLOTS * nt, device=dev)
    for i in range(SLOTS):
        poolw["block_tables"][i] = torch.arange(
            1 + i * nt, 1 + (i + 1) * nt, dtype=torch.int32)
    mean_len = sum(lens) // len(lens)
    poolw["pos"].fill_(mean_len + N_NEW // 2)
    toks = torch.zeros((SLOTS,), dtype=torch.long, device=dev)
    active = torch.ones((SLOTS,), dtype=torch.bool, device=dev)

    def wave_once():
        poolw["pos"].fill_(mean_len + N_NEW // 2)
        engine.step(toks, active, poolw)
    # the wave as the engine runs it (one replay of its captured graph),
    # and the eager step it replaced, timed in turns on the same pool
    graphw = engine.capture(poolw)
    graphw.active.fill_(True)

    def wave_graph_once():
        poolw["pos"].fill_(mean_len + N_NEW // 2)
        graphw.replay()
    eager_ms = cuda_median_ms(wave_once)
    wave_ms = cuda_median_ms(wave_graph_once)
    eager_host_ms = host_ms(wave_once)         # the host's side: issue time
    wave_host_ms = host_ms(wave_graph_once)
    emit("serve_flagship", params=n_params, prompt_lens=lens,
         requests=admissions, generated=st["generated"], waves=waves,
         wall_s=wall_s, tokens_per_s=st["generated"] / wall_s,
         ms_per_wave=wave_ms, host_ms_per_wave=wave_host_ms,
         eager_ms_per_wave=eager_ms, eager_host_ms_per_wave=eager_host_ms,
         replay_launches_per_wave=graphw.launches,
         captures=engine.captures,
         prefill_ms_per_admission=sum(prefill_ms) / len(prefill_ms),
         launches=launches, prefill_logit_max_abs_err=logit_err,
         prefill_logit_max_abs=logit_mag,
         tokens_match_plain_frac=match / len(outs),
         latency_ms=st["latency_ms"], kv=st["kv"],
         max_memory_allocated=peak_bytes)

    # ----------------------------------------------------- serve_profile
    # where the serve time goes: the same run again under torch.profiler,
    # device time summed by kernel against the run's own wall clock;
    # K7 by name: one kernel a layer a wave, replayed from the graph
    summary, k7_kernels, attempts = profiled(
        lambda: engine(prompts, N_NEW, slots=SLOTS), "paged_decode_kernel",
        lambda: engine.last_stats["waves"] * cfg.n_layers, "serve_profile")
    device_ms = summary["device_ms"]
    emit("serve_profile", **summary,
         busy_share_of_unprofiled_wall=(device_ms / (wall_s * 1e3)
                                        if device_ms is not None else None),
         paged_decode_kernels=k7_kernels,
         paged_decode_expected=engine.last_stats["waves"] * cfg.n_layers,
         paged_decode_attempts=attempts)
    emit("serve_telemetry", **serve_telemetry(engine, params, cfg, dev,
                                              prompts, max_len, outs))
    del engine, poolw, pool1, graphw

    # --------------------------------------------- serve_levers_flagship
    emit("serve_levers_flagship", **serve_levers_flagship(params, cfg, dev))
    torch.cuda.empty_cache()

    # ---------------------------------------------- serve_spill_flagship
    spill_rec, spill_launches = serve_spill_flagship(params, cfg, dev, smi)
    emit("serve_spill_flagship", **spill_rec)
    torch.cuda.empty_cache()

    # ---------------------------------------------- serve_fleet_flagship
    fleet_flag, fleet_flag_launches = serve_fleet_flagship(params, cfg, dev,
                                                           smi)
    emit("serve_fleet_flagship", **fleet_flag)
    torch.cuda.empty_cache()

    # ------------------------------------------------ serve_cdn_flagship
    cdn_flag, cdn_flag_launches = serve_cdn_flagship(params, cfg, dev, smi)
    emit("serve_cdn_flagship", **cdn_flag)
    torch.cuda.empty_cache()

    # ------------------------------------- sampled and speculative serving
    # the flagship traffic sampled (D1 in every wave and admission), and
    # spec_k on the template traffic
    sampled = serve_sampled_flagship(
        params, cfg, dev, prompts, max_len,
        {"tokens_per_s": st["generated"] / wall_s}, d1_main["ms"], smi)
    emit("serve_sampled_flagship", **sampled)
    emit("serve_spec_flagship", **serve_spec_flagship(params, cfg, dev, smi))
    torch.cuda.empty_cache()

    # ----------------------------------------------- serve_int8_flagship
    # the same traffic served with int8 weights and an int8 pool: each
    # admission prefills from the dequantised copy (K1), each wave runs
    # K7-int8 per layer and K8 for each of its 49 weight products
    qparams = quantize_params(params, dtype=bf16)
    engine8 = make_serve_engine(qparams, cfg, max_len=max_len,
                                kv_block=KV_BLOCK, cache_dtype="int8",
                                device=dev)
    engine8(prompts[:SLOTS], 4, slots=SLOTS)       # warm-up, not counted
    sync()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.monotonic()
    outs8 = engine8(prompts, N_NEW, slots=SLOTS)
    sync()
    wall8_s = time.monotonic() - t0
    launches8 = dict(_build.launches)
    peak8 = torch.cuda.max_memory_allocated()
    st8 = engine8.last_stats
    adm8, waves8 = st8["requests"], st8["waves"]
    per_wave = len(params["layers"]) * 6 + 1
    want8 = {**{name: 0 for name in launches8},
             "flash_fwd": adm8 * cfg.n_layers,
             "paged_decode_int8": waves8 * cfg.n_layers,
             "int8_matmul": waves8 * per_wave}
    if launches8 != want8:
        raise AssertionError(f"serve_int8_flagship launched {launches8}, "
                             f"expected {want8}")
    for o in outs8:
        if o.shape != (N_NEW,) or int(o.min()) < 0 \
                or int(o.max()) >= cfg.vocab:
            raise AssertionError(f"bad int8 output {o.shape} {o}")
    same8 = sum(torch.equal(a, b_) for a, b_ in zip(outs8, outs))
    tok_frac8 = sum((a == b_).float().mean().item()
                    for a, b_ in zip(outs8, outs)) / len(outs)
    nt8 = nt_int8
    poolw8 = init_paged_cache(cfg, SLOTS, max_len, block_size=KV_BLOCK,
                              num_blocks=1 + SLOTS * nt8,
                              cache_dtype="int8", device=dev)
    for i in range(SLOTS):
        poolw8["block_tables"][i] = torch.arange(
            1 + i * nt8, 1 + (i + 1) * nt8, dtype=torch.int32)

    def wave8_once():
        poolw8["pos"].fill_(mean_len + N_NEW // 2)
        engine8.step(toks, active, poolw8)
    graphw8 = engine8.capture(poolw8)
    graphw8.active.fill_(True)

    def wave8_graph_once():
        poolw8["pos"].fill_(mean_len + N_NEW // 2)
        graphw8.replay()
    eager8_ms = cuda_median_ms(wave8_once)
    wave8_ms = cuda_median_ms(wave8_graph_once)
    eager8_host_ms = host_ms(wave8_once)
    wave8_host_ms = host_ms(wave8_graph_once)
    emit("serve_int8_flagship", requests=adm8, generated=st8["generated"],
         waves=waves8, wall_s=wall8_s, tokens_per_s=st8["generated"] / wall8_s,
         bf16_tokens_per_s=st["generated"] / wall_s, ms_per_wave=wave8_ms,
         bf16_ms_per_wave=wave_ms, host_ms_per_wave=wave8_host_ms,
         bf16_host_ms_per_wave=wave_host_ms, eager_ms_per_wave=eager8_ms,
         eager_host_ms_per_wave=eager8_host_ms,
         replay_launches_per_wave=graphw8.launches,
         captures=engine8.captures, launches=launches8,
         requests_equal_to_bf16_engine_frac=same8 / len(outs),
         tokens_equal_to_bf16_engine_frac=tok_frac8,
         latency_ms=st8["latency_ms"], kv=st8["kv"],
         max_memory_allocated=peak8)

    # K8's kernels by name: one launch a product
    summary, k8_kernels, attempts = profiled(
        lambda: engine8(prompts, N_NEW, slots=SLOTS), "int8_mm",
        lambda: engine8.last_stats["waves"] * per_wave, "serve_int8_profile")
    device_ms = summary["device_ms"]
    emit("serve_int8_profile", **summary,
         busy_share_of_unprofiled_wall=(device_ms / (wall8_s * 1e3)
                                        if device_ms is not None else None),
         int8_matmul_kernels=k8_kernels,
         int8_products=engine8.last_stats["waves"] * per_wave,
         int8_matmul_attempts=attempts)
    del engine8, poolw8, qparams, graphw8
    torch.cuda.empty_cache()

    # ---------------------------------------------- decode_int8_flagship
    decode_rec, decode_launches = decode_int8_flagship(params, cfg, dev)
    emit("decode_int8_flagship", **decode_rec)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- MoE serve
    # the routed FFN (models/moe.py) through the paged engine and the
    # replayed decoder: exactness at f32, then the flagship MoE traffic
    moe_exact(dev)
    moe_rec, (moe_params, moe_cfg), moe_launches = serve_moe_flagship(
        dev, lens, max_len,
        {"bf16": {"ms_per_wave": wave_ms, "host_ms_per_wave": wave_host_ms},
         "int8": {"ms_per_wave": wave8_ms,
                  "host_ms_per_wave": wave8_host_ms}}, smi)
    emit("serve_moe_flagship", **moe_rec)
    moe_decode_rec, moe_decode_launches = decode_moe_flagship(
        moe_params, moe_cfg, dev, smi)
    emit("decode_moe_flagship", **moe_decode_rec)
    del moe_params
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- train
    # the last main path: the flagship burn-in train step. The serve
    # state goes first (the train step needs the card's memory); the
    # weights are the same seeded flagship draw.
    bwd_res = kernel_flash_bwd_resources()
    bwd = kernel_flash_bwd(randn, dev, train_shape)
    kernel_flash_dq(randn, dev, train_shape,
                    (train_shape[0], train_shape[1] // RING_SP, 16, 128))
    train_exact(dev)
    rec, train_launches = train_flagship(params, dev)
    emit("train_flagship", **rec)
    emit("train_telemetry", **train_telemetry(params, dev))
    emit("train_profile", **train_profile(params, dev))

    # -------------------------------------------- sequence-parallel train
    # the ring's per-member block at the flagship: [B, S / sp, H, D]
    ring_block = (train_shape[0], train_shape[1] // RING_SP, 16, 128)
    k2 = kernel_flash_partial(randn, dev, ring_block)
    bwd_f32 = kernel_flash_bwd_f32_out(randn, dev, ring_block)
    emit("ring_exact", **ring_exact(dev))
    emit("ulysses_exact", **ulysses_exact(dev))
    ring_rec, ring_launches = train_ring_flagship(params, dev,
                                                  rec["step_ms"])
    emit("train_ring_flagship", **ring_rec)
    emit("train_ring_profile", **train_ring_profile(params, dev))
    torch.cuda.empty_cache()

    # ------------------------------------- the validation Job's payload
    # the smoke test as the Job runs it (a process of its own, a world of
    # one over NCCL), then in this process with K7 counted; then the
    # data/tensor-parallel step on the world-1 mesh against the unsharded
    emit("smoketest_cli", **smoketest_cli())
    st_rec, st_launches = smoketest_inproc()
    emit("smoketest_inproc", **st_rec)
    sh_rec, sh_launches = train_sharded_flagship(params, dev)
    emit("train_sharded_flagship", **sh_rec)

    # ---------------------------------------------- the durable train state
    # the CLI with a checkpoint directory (fresh, resumed, quarantined),
    # then the flagship AdamW state through the checkpoint engine
    import shutil

    os.makedirs(CKPT_ROOT, exist_ok=True)
    try:
        cli_ck = smoketest_cli_checkpoint(CKPT_ROOT)
        emit("smoketest_cli_checkpoint", **cli_ck)
        ck_rec, ck_launches = train_checkpoint_flagship(params, dev,
                                                        CKPT_ROOT)
        emit("train_checkpoint_flagship", **ck_rec)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    k7_cli_ck = sum(run["leg_launches"].get("paged_decode", {}).get(
        "paged_decode", 0) for run in cli_ck.values())

    # ----------------------------------- the validation Job's full level
    # the flagship MoE train step on the Job's path (rules of a world of
    # one), the flagship engine under rules=, and the CLI at --level full
    emit("train_moe_exact", **train_moe_exact(dev))
    moe_train_rec, moe_train_launches = train_moe_flagship(dev, smi)
    emit("train_moe_flagship", **moe_train_rec)
    torch.cuda.empty_cache()
    sr_rec, sr_launches = serve_rules_flagship(params, cfg, dev, prompts,
                                               max_len, smi)
    emit("serve_rules_flagship", **sr_rec)
    # the other decode entry points and the engine's levers under rules=
    dr_rec, dr_launches = decode_rules_flagship(params, cfg, dev, smi)
    emit("decode_rules_flagship", **dr_rec)
    srl_rec, srl_launches = serve_rules_levers_flagship(
        params, cfg, dev, prompts, max_len, smi)
    emit("serve_rules_levers_flagship", **srl_rec)
    torch.cuda.empty_cache()
    emit("smoketest_cli_full", **smoketest_cli_full())

    # ------------------------------- the pipeline and sp over processes
    # GPipe and 1F1B at f32 against the unpipelined model (pp 2 and 4 on
    # the card, pp 1 on a world of one), then at the flagship width on
    # [cuda:0] * 2; the ring and Ulysses through the world-of-one rules
    pipe_exact, pipe_exact_launches = pipeline_exact(dev)
    emit("pipeline_exact", **pipe_exact)
    pipe_rec, pipe_launches = pipeline_flagship(dev, smi)
    emit("pipeline_flagship", **pipe_rec)
    rw1_rec, rw1_launches = train_ring_world_one(dev)
    emit("train_ring_world_one", **rw1_rec)

    # --------------------------------------------------------- summary
    n_k1 = sum(c for c, _ in k1_main)

    def k1_mean(key):
        return sum(c * r[key] for c, r in k1_main) / n_k1

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "nvidia_terraform_modules_tpu/ops/flash_attention.py:385",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for _, r in k1_main),
         "ms": k1_mean("ms"), "plain_ms": k1_mean("plain_ms"),
         "bound_ms": k1_mean("bound_ms"),
         "bound_by": k1_main[0][1]["bound_by"],
         "library_ms": k1_mean("library_ms"),
         "moe": {"launches": moe_launches["bf16"]["flash_fwd"],
                 "int8_launches": moe_launches["int8"]["flash_fwd"]},
         # the sharded SGD step's timed run (a world of one, NCCL)
         "sharded": {"launches": sh_launches["flash_fwd"]},
         # the flagship AdamW steps with an async save after each
         "checkpoint": {"launches": ck_launches["flash_fwd"]},
         # the flagship MoE train step's timed steps and the rules= engine
         "moe_train": {"launches": moe_train_launches["flash_fwd"]},
         "serve_rules": {"launches": sr_launches["flash_fwd"]},
         # the decoders under rules (one call each: the flash prefill) and
         # the engine's levers under rules= (admissions)
         "decode_rules": {stack: dr_launches[stack]["flash_fwd"]
                          for stack in ("bf16", "int8")},
         "serve_rules_levers": {lever: c.get("flash_fwd", 0)
                                for lever, c in srl_launches.items()},
         # the flagship pipeline's timed steps (K1 a layer a microbatch;
         # 1F1B twice: forward and recompute), the f32 pipeline checks,
         # and Ulysses on the world-of-one rules
         "pipeline": {"gpipe_launches": pipe_launches["gpipe"]["flash_fwd"],
                      "1f1b_launches": pipe_launches["1f1b"]["flash_fwd"],
                      "exact_launches": pipe_exact_launches["flash_fwd"]},
         "ulysses_world_one": {"launches":
                               rw1_launches["ulysses"]["flash_fwd"]},
         # the flagship spilling engine's last timed run (host_spill)
         "spill": {"launches": spill_launches["flash_fwd"]},
         # the fleets: fleet_exact's last calls, and the flagship fleets'
         # last timed turns (the prefill side's workers)
         "fleet": {"exact_launches": _fleet_sum(fleet_launches,
                                                "flash_fwd"),
                   "flagship_launches": _fleet_sum(fleet_flag_launches,
                                                   "flash_fwd")},
         # the elastic plane's and the CDN's fleets: fleet_scale_exact's
         # checked calls and serve_cdn_flagship's last timed calls
         "fleet_scale": {"exact_launches": _fleet_sum(scale_launches,
                                                      "flash_fwd"),
                         "flagship_launches": _fleet_sum(
                             cdn_flag_launches, "flash_fwd")},
         # the serve prompts' mean rate, and K1 at the train step's shape
         "tflops": k1_mean("tflops"), "bound_share": k1_mean("bound_share"),
         "tiling": FWD_TILING,
         "train": {key: k1_train[key] for key in (
             "shape", "ms", "plain_ms", "bound_ms", "library_ms", "tflops",
             "bound_share", "tiling")}},
        {"name": "paged_decode", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/paged_decode.cu",
         "replaces":
             "nvidia_terraform_modules_tpu/ops/decode_attention.py:332",
         "launches": launches["paged_decode"],
         "max_abs_err": k7_rec["max_abs_err"], "ms": k7_rec["ms"],
         "plain_ms": k7_rec["plain_ms"], "bound_ms": k7_rec["bound_ms"],
         "bound_by": k7_rec["bound_by"],
         "library_ms": k7_rec["library_ms"],
         "moe": {"launches": moe_launches["bf16"]["paged_decode"]},
         # the in-process smoke test (serve legs; paged_decode's "on")
         "smoketest": {"launches": st_launches["paged_decode"],
                       "paged_decode_leg": st_rec["paged_decode_k7"]},
         # the three checkpointed CLI runs' paged_decode legs
         "checkpoint_cli": {"launches": k7_cli_ck},
         # the flagship engine under rules= (a world of one), and the MoE
         # engine under rules=
         "serve_rules": {"launches": sr_launches["paged_decode"]},
         "serve_rules_levers": {
             "moe_launches": srl_launches["moe"]["paged_decode"]},
         # the flagship spilling engine's last timed run
         "spill": {"launches": spill_launches["paged_decode"]},
         # the fleets' decode workers (as K1's "fleet")
         "fleet": {"exact_launches": _fleet_sum(fleet_launches,
                                                "paged_decode"),
                   "flagship_launches": _fleet_sum(fleet_flag_launches,
                                                   "paged_decode")},
         "fleet_scale": {"exact_launches": _fleet_sum(scale_launches,
                                                      "paged_decode"),
                         "flagship_launches": _fleet_sum(
                             cdn_flag_launches, "paged_decode")}},
        {"name": "paged_decode_int8", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/paged_decode.cu",
         "replaces":
             "nvidia_terraform_modules_tpu/ops/decode_attention.py:332",
         "launches": launches8["paged_decode_int8"],
         **{key: k7i8_rec[key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         "moe": {"launches": moe_launches["int8"]["paged_decode_int8"]},
         "serve_rules_levers": {"int8_weights_launches": srl_launches[
             "int8_weights"]["paged_decode_int8"]},
         # the int8-cache spilling runs of serve_spill_exact
         "spill_exact": {"launches": spill_exact["int8_launches"]},
         # fleet_exact's int8-cache fleet
         "fleet": {"exact_launches": _fleet_sum(fleet_launches,
                                                "paged_decode_int8")},
         # fleet_scale_exact's int8-cache CDN fleet
         "fleet_scale": {"exact_launches": _fleet_sum(
             scale_launches, "paged_decode_int8")}},
        {"name": "kv_decode", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/kv_decode.cu",
         "replaces":
             "nvidia_terraform_modules_tpu/ops/decode_attention.py:196",
         "launches": decode_launches["kv_decode"],
         **{key: k6_main["step"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         "moe": {"launches": moe_decode_launches["kv_decode"]},
         # the int8 stack's decoder under rules (one call), and K6 over a
         # tp 2 / tp 4 rank's KV heads
         "decode_rules": {"launches": dr_launches["int8"]["kv_decode"]},
         "shards": [{key: r[key] for key in (
             "tp", "heads", "max_abs_err", "ms", "plain_ms", "bound_ms")}
             for r in shard_rec["kv_decode"]]},
        # K8: the mean per launch over a wave's 49 products, and over a
        # decode step's (M = 8)
        {"name": "int8_matmul", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "nvidia_terraform_modules_tpu/ops/int8_matmul.py:90",
         "launches": launches8["int8_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in k8_main.values()),
         **{key: wave_mean(k8_main, key) for key in (
             "ms", "plain_ms", "bound_ms", "library_ms", "host_us")},
         "bound_by": k8_main["square"]["bound_by"],
         "resources": {
             layout: {key: k8_main[name][key] for key in (
                 "registers", "spill_bytes", "smem_bytes", "ctas_per_sm")}
             for layout, name in (("[K, N]", "square"), ("[N, K]", "head"))},
         # the int8 MoE serve run: the 4 attention products a layer and
         # the head (33 a wave; the expert stacks stay dense)
         "moe": {"launches": moe_launches["int8"]["int8_matmul"]},
         # the int8 decoder under rules (one call) and the int8-weight
         # engine under rules=; K8 at a tp 2 / tp 4 rank's shard shapes
         "decode_rules": {"launches": dr_launches["int8"]["int8_matmul"]},
         "serve_rules_levers": {"int8_weights_launches": srl_launches[
             "int8_weights"]["int8_matmul"]},
         "shards": {
             "max_abs_err": max(r["max_abs_err"]
                                for r in shard_rec["int8_matmul"]),
             **{key: sum(r[key] for r in shard_rec["int8_matmul"])
                / len(shard_rec["int8_matmul"])
                for key in ("ms", "plain_ms", "bound_ms")}},
         "decode": {"launches": decode_launches["int8_matmul"],
                    "max_abs_err": max(r["max_abs_err"]
                                       for r in k8_decode.values()),
                    **{key: wave_mean(k8_decode, key) for key in (
                        "ms", "plain_ms", "bound_ms", "library_ms",
                        "host_us")}}},
    ]
    for name, line in (("flash_bwd_fused", 724), ("flash_dq", 657),
                       ("flash_dkv", 688)):
        r = bwd[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nvidia_terraform_modules_tpu_torch/csrc/flash_bwd.cu",
            "replaces":
                f"nvidia_terraform_modules_tpu/ops/flash_attention.py:{line}",
            # K5's count is the timed fused steps' of the flash train
            # path; K3's and K4's its split step's
            "launches": (train_launches[name] if name == "flash_bwd_fused"
                         else rec["split_step_launches"][name]),
            **({"sharded": {"launches": sh_launches[name]},
                "moe_train": {"launches": moe_train_launches[name]},
                "pipeline": {
                    "gpipe_launches": pipe_launches["gpipe"][name],
                    "1f1b_launches": pipe_launches["1f1b"][name],
                    "exact_launches": pipe_exact_launches[name]},
                "ulysses_world_one": {
                    "launches": rw1_launches["ulysses"][name]}}
               if name == "flash_bwd_fused" else {}),
            # K5: the checkpointed AdamW steps; K3 and K4: the
            # exact-resume comparison (split backward)
            "checkpoint": {"launches": ck_launches[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **_resources(bwd_res, name, bf16)})
    # the ring's kernels at its block: the step's mix per layer — RING_SP
    # diagonal (causal) and the rest fully visible blocks — weights each
    # kernel's two records
    n_diag = RING_SP
    n_full = _ring_visits(RING_SP, True) - n_diag

    def ring_mix(recs, key):
        return (n_diag * recs["diag"][key] + n_full * recs["full"][key]) / (
            n_diag + n_full)

    def ring_row(name, source, line, launches_, recs):
        return {
            "name": name, "route": "cuda",
            "source": f"nvidia_terraform_modules_tpu_torch/csrc/{source}",
            "replaces":
                f"nvidia_terraform_modules_tpu/ops/flash_attention.py:{line}",
            "launches": launches_,
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            **{key: ring_mix(recs, key) for key in (
                "ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": recs["full"]["bound_by"]}

    k2_row = ring_row("flash_partial", "flash_fwd.cu", 420,
                      ring_launches["flash_partial"], k2)
    # the ring of one member on the world-of-one rules: one diagonal block
    # a layer
    k2_row["ring_world_one"] = {
        "launches": rw1_launches["ring"]["flash_partial"]}
    k2_row.update(
        {key: ring_mix(k2, key) for key in ("tflops", "bound_share")},
        tiling=FWD_TILING,
        us_per_tile_column={name: k2[name]["us_per_tile_column"]
                            for name in ("diag", "full")})
    kernels.append(k2_row)
    # K5, K3 and K4 writing f32 (the ring's per-block gradients): K5's
    # count is the ring's timed fused steps', K3's and K4's its split
    # step's
    for name, line in (("flash_bwd_fused", 724), ("flash_dq", 657),
                       ("flash_dkv", 688)):
        kernels.append({**ring_row(
            f"{name}_f32_out", "flash_bwd.cu", line,
            ring_launches[name] if name == "flash_bwd_fused"
            else ring_rec["split_step_launches"][name], bwd_f32[name]),
            **({"ring_world_one": {
                "launches": rw1_launches["ring"][name]}}
               if name == "flash_bwd_fused" else {}),
            **_resources(bwd_res, name, f32)})
    # D1 is not the port of a TPU kernel: the reference draws in XLA
    # (jax.random.categorical in make_sampler); its launches are the
    # sampled flagship run's (top-p)
    kernels.append({
        "name": "sample_draw", "route": "cuda",
        "source": "nvidia_terraform_modules_tpu_torch/csrc/sample.cu",
        "replaces": "nvidia_terraform_modules_tpu/models/decode.py:810",
        "tpu_kernel": False,
        "launches": sampled["top_p"]["launches"]["sample_draw"],
        # sample_decode under rules (one call, a draw a token) and the
        # sampled engine under rules=
        "decode_rules": {"launches": dr_launches["sample_rules"][
            "sample_draw"]},
        "serve_rules_levers": {"launches": srl_launches["sampled"][
            "sample_draw"]},
        **{key: d1_main[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "plain_ms_in_wave": (sampled["top_p"]["plain_draw_ms_per_wave"]
                             - sampled["top_p"]["ms_per_wave"])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
