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
  and K5.

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
    from torch.profiler import ProfilerActivity, profile

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

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            engine(prompts, N_NEW, slots=SLOTS)
            sync()
            prof_wall_ms = (time.monotonic() - t0) * 1e3
        summary = profile_summary(prof, prof_wall_ms)
        by_name = kernel_counts(prof, "int8_mm" if quant
                                else "paged_decode_kernel")
        expect = engine.last_stats["waves"] * (tally["int8_matmul"] if quant
                                               else cfg.n_layers)
        if summary["device_ms"] is not None \
                and sum(by_name.values()) != expect:
            raise AssertionError(f"serve_moe_flagship {name} profile: "
                                 f"{by_name}, expected {expect}")
        r["profile"] = {**summary, "by_name": by_name,
                        "by_name_expected": expect}
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
        make_grads_fn,
        make_train_step,
        train_step_flops,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        sync,
        synced_ms,
    )

    cfg, batch, rules = _ring_train(dev)
    state = {"p": params}

    # one gradient pass of the ring, of the flash step and of the flash
    # step in f32 on the same params and batch. Two bf16 passes differ by
    # their roundings by about 1e-2 relative L2 on some gradients, so each
    # gradient of the ring is held to be no further from the f32 pass
    # than the flash step's is (RING_VS_FLASH), and the loss to the flash
    # step's within BWD_TOL["bf16"]
    def grads_of(cfg_, rules_=None, p=params):
        loss, grads = make_grads_fn(cfg_, rules_)(p, batch)
        return loss.float(), [g.float() for g in tree_leaves(grads)]

    flash_cfg = dataclasses.replace(cfg, attn="flash")
    loss32, g32 = grads_of(dataclasses.replace(flash_cfg,
                                               dtype=torch.float32),
                           p=_as_f32(params))
    loss_f, g_flash = grads_of(flash_cfg)
    loss_r, g_ring = grads_of(cfg, rules)
    grad_errors([loss_r], [loss_f], "bf16", "ring vs flash step loss")
    tol_abs = BWD_TOL["bf16"][0]
    leaves = []
    for name, r, f, t in zip(_leaf_names(params), g_ring, g_flash, g32):
        t_norm = t.norm().item()
        ring_l2 = ((r - t).norm().item() / t_norm) if t_norm else 0.0
        flash_l2 = ((f - t).norm().item() / t_norm) if t_norm else 0.0
        err = (r - t).abs().max().item()
        lim = tol_abs * max(1.0, t.abs().max().item())
        l2_lim = max(BWD_TOL["f32"][1], RING_VS_FLASH * flash_l2)
        leaves.append(dict(leaf=name, ring_rel_l2=ring_l2,
                           flash_rel_l2=flash_l2, ring_max_abs=err))
        if not (err <= lim and ring_l2 <= l2_lim):
            raise AssertionError(
                f"ring step gradient {name} against the f32 step: max-abs "
                f"{err} (limit {lim}), relative L2 {ring_l2} (limit "
                f"{l2_lim}; the flash step's {flash_l2})")
    vs_flash = dict(
        loss_f32=loss32.item(), loss_flash=loss_f.item(),
        loss_ring=loss_r.item(),
        worst_ring_rel_l2=max(leaves, key=lambda x: x["ring_rel_l2"]),
        worst_ratio=max(leaves, key=lambda x: x["ring_rel_l2"]
                        / max(x["flash_rel_l2"], 1e-30)),
        ring_vs_flash_limit=RING_VS_FLASH)
    del g32, g_flash, g_ring

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
                  "serve_sched_ok", "paged_decode_ok")
# SGD steps from one set of weights for the sharded/unsharded comparison
SHARDED_STEPS = 3
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


def smoketest_cli() -> dict:
    """``python -m nvidia_terraform_modules_tpu_torch.smoketest`` as the
    validation Job runs it, at ``burnin`` with one expected device: a
    world of one over NCCL on this card. Its one JSON line must pass every
    leg of ``SMOKETEST_LEGS``."""
    env = {k: v for k, v in os.environ.items() if k not in _WORLD_VARS}
    env.update(TPU_SMOKETEST_LEVEL="burnin",
               TPU_SMOKETEST_EXPECTED_DEVICES="1")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "nvidia_terraform_modules_tpu_torch.smoketest"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    wall_s = time.monotonic() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if out.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"smoketest CLI exited {out.returncode} with "
                             f"{len(lines)} JSON lines: {out.stdout[-3000:]}"
                             f"{out.stderr[-3000:]}")
    checks = json.loads(lines[0])
    _smoketest_verdict(checks, "smoketest_cli")
    return dict(wall_s=wall_s, seconds=checks["seconds"],
                backend=checks["backend"], device_kind=checks["device_kind"],
                legs={k: checks[k] for k in SMOKETEST_LEGS},
                leg_seconds=checks["leg_seconds"],
                leg_launches=checks["leg_launches"],
                not_ported=sorted(checks["not_ported"]),
                burnin_loss=[checks["burnin_first_loss"],
                             checks["burnin_last_loss"]])


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
    # device time summed by kernel against the run's own wall clock
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine(prompts, N_NEW, slots=SLOTS)
        sync()
        prof_wall_ms = (time.monotonic() - t0) * 1e3
    summary = profile_summary(prof, prof_wall_ms)
    device_ms = summary["device_ms"]
    # K7 by name: one kernel a layer a wave, replayed from the graph (an
    # empty trace leaves it "not measured")
    k7_kernels = kernel_counts(prof, "paged_decode_kernel")
    k7_want = engine.last_stats["waves"] * cfg.n_layers
    if device_ms is not None and sum(k7_kernels.values()) != k7_want:
        raise AssertionError(f"serve_profile: K7 kernels {k7_kernels}, "
                             f"expected one a layer a wave ({k7_want})")
    emit("serve_profile", **summary,
         busy_share_of_unprofiled_wall=(device_ms / (wall_s * 1e3)
                                        if device_ms is not None else None),
         paged_decode_kernels=k7_kernels, paged_decode_expected=k7_want)
    emit("serve_telemetry", **serve_telemetry(engine, params, cfg, dev,
                                              prompts, max_len, outs))
    del engine, poolw, pool1, graphw

    # --------------------------------------------- serve_levers_flagship
    emit("serve_levers_flagship", **serve_levers_flagship(params, cfg, dev))
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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine8(prompts, N_NEW, slots=SLOTS)
        sync()
        prof_wall_ms = (time.monotonic() - t0) * 1e3
    summary = profile_summary(prof, prof_wall_ms)
    device_ms = summary["device_ms"]
    # K8's kernels by name: one launch a product when the trace saw the
    # device (an empty trace leaves it "not measured")
    k8_kernels = kernel_counts(prof, "int8_mm")
    products = engine8.last_stats["waves"] * per_wave
    if device_ms is not None and sum(k8_kernels.values()) != products:
        raise AssertionError(f"serve_int8_profile: K8 kernels {k8_kernels}"
                             f", expected one a product ({products})")
    emit("serve_int8_profile", **summary,
         busy_share_of_unprofiled_wall=(device_ms / (wall8_s * 1e3)
                                        if device_ms is not None else None),
         int8_matmul_kernels=k8_kernels, int8_products=products)
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
                       "paged_decode_leg": st_rec["paged_decode_k7"]}},
        {"name": "paged_decode_int8", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/paged_decode.cu",
         "replaces":
             "nvidia_terraform_modules_tpu/ops/decode_attention.py:332",
         "launches": launches8["paged_decode_int8"],
         **{key: k7i8_rec[key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         "moe": {"launches": moe_launches["int8"]["paged_decode_int8"]}},
        {"name": "kv_decode", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/kv_decode.cu",
         "replaces":
             "nvidia_terraform_modules_tpu/ops/decode_attention.py:196",
         "launches": decode_launches["kv_decode"],
         **{key: k6_main["step"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         "moe": {"launches": moe_decode_launches["kv_decode"]}},
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
            **({"sharded": {"launches": sh_launches[name]}}
               if name == "flash_bwd_fused" else {}),
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
