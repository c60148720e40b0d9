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
  exactness contract on the card, serves at the flagship width (the launch
  counts show it went through both kernels) and profiles one more run of
  the same traffic (device time by kernel against the host clock);
- int8 serving: holds K8 (int8-weight matmul), K6 (contiguous int8
  decode) and K7-int8 (the paged kernel on an int8 pool) against their
  plain versions, checks the int8 engine's exactness on the card, serves
  the flagship traffic with int8 weights and an int8 pool (the launch
  counts show every wave went through K7-int8 and K8), profiles it, and
  times ``make_quantized_decoder`` at the flagship's decode shape (batch 8,
  prompt 512, 64 new tokens; K6 and K8 on every step) and at 3584 + 32;
- train: prints the registers, spills and CTAs per SM of each instance of
  the bf16 key-block kernel that K5 and K4 share; holds K5 (fused flash
  backward) and K3/K4 (the split pair)
  against their plain versions, up to the flagship's per-layer
  ``[2, 4096, 16, 128]``; checks the train step's gradients on the card
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
  through K2 and K5, or K3 + K4) and profiles one step.

Every phase prints one JSON line; any failure raises and the script exits
non-zero. Without a CUDA device it exits 1 and prints no result; it
imports nothing of JAX.

The last three lines are: the kernels' JSON record (times, bounds, launch
counts), the card's ``name, power.limit`` as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12          # HBM3, SXM data sheet
H100_PEAK = {"bf16": 989e12,        # dense tensor-core rate
             "f32": 67e12}          # CUDA cores (the f32 kernels' route)

N_REQUESTS, SLOTS, KV_BLOCK, N_NEW, SEED = 8, 4, 16, 32, 0
# the flagship's SGD rate: at make_train_step's default of 1e-3, lr·g is
# below half a bf16 step of most weights (a weight near 0.02 moves only for
# |g| > 0.06), so most of the update rounds away
TRAIN_LR = 0.1
WARM_STEPS, TIMED_STEPS, ADAMW_STEPS = 2, 10, 3
# make_quantized_decoder at bench.py section_decode_int8's shape, and its
# long-context pair
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 8, 512, 64
LONG_PROMPT, LONG_NEW = 3584, 32
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(flops: float, nbytes: float, kind: str) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_ops = flops / H100_PEAK[kind]
    t_bytes = nbytes / H100_BYTES_PER_S
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


def kernel_int8_matmul(randn, dev) -> dict:
    """K8 against its plain version at the wave's shapes (M = 4, and M = 8
    at the square projection) and off the path (M = 1, M = 64, f32 x),
    rows of an M = 4 call against M = 1 calls bit for bit, and a K the
    kernel cannot take, which must raise; returns the main-path records by
    shape name."""
    import torch

    from nvidia_terraform_modules_tpu_torch.ops.int8_matmul import (
        int8_matmul,
        int8_matmul_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
        sync,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, SLOTS, k, n, trans, bf16, True)
             for name, k, n, trans, _ in WAVE_MATMULS]
    cases += [("square", 8, 2048, 2048, False, bf16, False),
              ("square", 1, 2048, 2048, False, bf16, False),
              ("square", 64, 2048, 2048, False, bf16, False),
              ("square", 4, 2048, 2048, False, f32, False)]
    main: dict = {}
    for name, m, k, n, trans, dtype, on_path in cases:
        w = torch.randint(-127, 128, (n, k) if trans else (k, n),
                          generator=randn.gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((n,), generator=randn.gen, device=dev) * 2e-3 \
            + 1e-4
        x = randn((m, k), dtype)
        out = int8_matmul(x, w, scale, transpose_rhs=trans)
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
        ms = cuda_median_ms(lambda: int8_matmul(x, w, scale,
                                                transpose_rhs=trans))
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
        rec = dict(shape=name, m=m, k=k, n=n, transposed=trans,
                   dtype=str(dtype), main_path=on_path, max_abs_err=err,
                   rows_bitwise=m > 1, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, ctas=(n // 64) * (k // (
                       256 if k % 256 == 0 else 128)))
        emit("kernel_int8_matmul", **rec)
        if on_path:
            main[name] = rec
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
    return main


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
                   bound_by=bound_by, ctas=bb * kv)
        emit("kernel_kv_decode", **rec)
        if on_path:
            main[on_path] = rec
        del k, v, kd, vd, ks, vs
    return main


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


def decode_int8_flagship(params, cfg, dev) -> tuple[dict, dict]:
    """``make_quantized_decoder`` at the flagship's decode shape (batch 8,
    prompt 512, 64 new tokens, dense prefill) with the int8 cache and the
    bf16 cache, beside the bf16 weights' ``greedy_decode``; decode
    tokens/s by the two-point method (the decoder at ``n_new`` minus a
    prefill-only twin at ``n_new=1``); the launch counts of each run; then
    the long-context pair (prompt 3584, 32 new, flash prefill), bf16 cache
    against int8 cache. Returns the phase record and the int8 run's
    launch counts."""
    import dataclasses

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        greedy_decode,
        make_quantized_decoder,
        quantize_params,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.utils.timing import synced_ms

    bf16 = torch.bfloat16
    qparams = quantize_params(params, dtype=bf16)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    steps_per_wave = len(params["layers"]) * 6 + 1

    def two_point(run, n_new, prompt):
        """Decode tokens/s: (decoder - prefill twin) over n_new - 1 steps;
        the median of 3 timed runs of each after one warm run."""
        synced_ms(lambda: run(n_new, prompt), 1)
        synced_ms(lambda: run(1, prompt), 1)
        _, total = synced_ms(lambda: run(n_new, prompt), 3)
        _, pre = synced_ms(lambda: run(1, prompt), 3)
        return (prompt.shape[0] * (n_new - 1) / ((total - pre) / 1e3),
                total, pre)

    def counted(run, n_new, prompt):
        _build.reset_launches()
        toks = run(n_new, prompt)
        torch.cuda.synchronize()
        return dict(_build.launches), toks

    def variant(cfg_, cache_dtype, weights):
        if weights == "bf16":
            return lambda n, p: greedy_decode(params, p, n, cfg_,
                                              cache_dtype=cache_dtype,
                                              device=dev)
        return lambda n, p: make_quantized_decoder(
            cfg_, n_new=n, dtype=bf16, cache_dtype=cache_dtype,
            device=dev)(qparams, p)

    dcfg = dataclasses.replace(cfg, attn="dense", batch=DECODE_BATCH)
    prompt = torch.randint(0, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT),
                           generator=g, device=dev)
    rec: dict = {"batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
                 "n_new": DECODE_NEW}
    toks = {}
    int8_launches = None
    for name, cache_dtype, weights in (("int8_weights_int8_cache", "int8",
                                        "int8"),
                                       ("int8_weights_bf16_cache", "bf16",
                                        "int8"),
                                       ("bf16_weights_bf16_cache", "bf16",
                                        "bf16")):
        run = variant(dcfg, cache_dtype, weights)
        launches, toks[name] = counted(run, DECODE_NEW, prompt)
        steps = DECODE_NEW - 1
        want = {"int8_matmul": steps * steps_per_wave if weights == "int8"
                else 0,
                "kv_decode": steps * dcfg.n_layers
                if cache_dtype == "int8" else 0}
        got = {k_: launches[k_] for k_ in want}
        if got != want or launches["flash_fwd"] or launches["paged_decode"] \
                or launches["paged_decode_int8"]:
            raise AssertionError(f"decode {name} launched {launches}, "
                                 f"expected {want}")
        if cache_dtype == "int8" and weights == "int8":
            int8_launches = launches
        tps, total_ms, pre_ms = two_point(run, DECODE_NEW, prompt)
        rec[name] = dict(tokens_per_s=tps, decoder_ms=total_ms,
                         prefill_ms=pre_ms, launches=got)
    rec["int8_cache_tokens_match_bf16_cache_frac"] = (
        toks["int8_weights_int8_cache"] == toks["int8_weights_bf16_cache"]
    ).float().mean().item()
    rec["int8_weights_tokens_match_bf16_weights_frac"] = (
        toks["int8_weights_bf16_cache"] == toks["bf16_weights_bf16_cache"]
    ).float().mean().item()
    lcfg = dataclasses.replace(cfg, attn="flash", batch=DECODE_BATCH)
    lprompt = torch.randint(0, cfg.vocab, (DECODE_BATCH, LONG_PROMPT),
                            generator=g, device=dev)
    for cache_dtype in ("bf16", "int8"):
        tps, total_ms, pre_ms = two_point(variant(lcfg, cache_dtype, "int8"),
                                          LONG_NEW, lprompt)
        rec[f"long_{cache_dtype}_cache"] = dict(
            prompt=LONG_PROMPT, n_new=LONG_NEW, tokens_per_s=tps,
            decoder_ms=total_ms, prefill_ms=pre_ms)
    return rec, int8_launches


def kernel_flash_bwd_resources() -> dict:
    """One line per instance of the bf16 key-block kernel (K5 fused, K4
    split; head dims 64 and 128; bf16 and f32 outputs): registers and
    spilled bytes a thread (cudaFuncGetAttributes), dynamic shared memory
    and CTAs per SM (the occupancy calculator). Returns the records by
    (kernel name, output dtype) at head dim 128."""
    import torch

    from nvidia_terraform_modules_tpu_torch.ops.flash_attention import (
        flash_bwd_kv_resources,
    )

    main = {}
    for d in (64, 128):
        for name, fused in (("flash_bwd_fused", True), ("flash_dkv", False)):
            for out in (torch.bfloat16, torch.float32):
                rec = flash_bwd_kv_resources(d, fused=fused, out_dtype=out)
                emit("kernel_flash_bwd_resources", kernel=name, head_dim=d,
                     out_dtype=str(out), **rec)
                if rec["spill_bytes"]:
                    raise AssertionError(f"{name} d={d} {out}: "
                                         f"{rec['spill_bytes']} B spilled")
                if d == 128:
                    main[name, out] = rec
    return main


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
               burnin_mfu=flops / (step_ms / 1e3) / H100_PEAK["bf16"],
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
               burnin_mfu=flops / (step_ms / 1e3) / H100_PEAK["bf16"],
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


def flagship_lengths() -> list[int]:
    from nvidia_terraform_modules_tpu_torch.utils.traffic import (
        ragged_lengths,
    )

    lens = ragged_lengths(N_REQUESTS, SEED, lo=128, hi=512)
    return [min(512, max(128, 8 * round(n / 8))) for n in lens]


def _resources(records: dict, name: str, out) -> dict:
    """The key-block kernel's registers, spills and CTAs per SM for a K5 or
    K4 row of the kernels line (none for K3, which keeps its kernel)."""
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
                   bound_ms=bound_ms, bound_by=bound_by, ctas=b * kv)
        if quant:
            rec["vs_kv_decode_on_gathered_view"] = vs_k6
        emit("kernel_paged_decode", **rec)
        if on_path and quant:
            k7i8_rec = rec
        elif on_path:
            k7_rec = rec

    k6_main = kernel_kv_decode(randn, dev)
    k8_main = kernel_int8_matmul(randn, dev)

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
    poolw["pos"][:] = mean_len + N_NEW // 2
    toks = torch.zeros((SLOTS,), dtype=torch.long, device=dev)
    active = torch.ones((SLOTS,), dtype=torch.bool, device=dev)

    def wave_once():
        poolw["pos"][:] = mean_len + N_NEW // 2
        engine.step(toks, active, poolw)
    wave_ms = cuda_median_ms(wave_once)
    wave_host_ms = host_ms(wave_once)          # the host's side: issue time
    emit("serve_flagship", params=n_params, prompt_lens=lens,
         requests=admissions, generated=st["generated"], waves=waves,
         wall_s=wall_s, tokens_per_s=st["generated"] / wall_s,
         ms_per_wave=wave_ms, host_ms_per_wave=wave_host_ms,
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
    emit("serve_profile", **summary,
         busy_share_of_unprofiled_wall=(device_ms / (wall_s * 1e3)
                                        if device_ms is not None else None))
    del engine, poolw, pool1

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
        poolw8["pos"][:] = mean_len + N_NEW // 2
        engine8.step(toks, active, poolw8)
    wave8_ms = cuda_median_ms(wave8_once)
    wave8_host_ms = host_ms(wave8_once)
    emit("serve_int8_flagship", requests=adm8, generated=st8["generated"],
         waves=waves8, wall_s=wall8_s, tokens_per_s=st8["generated"] / wall8_s,
         bf16_tokens_per_s=st["generated"] / wall_s, ms_per_wave=wave8_ms,
         bf16_ms_per_wave=wave_ms, host_ms_per_wave=wave8_host_ms,
         bf16_host_ms_per_wave=wave_host_ms, launches=launches8,
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
    emit("serve_int8_profile", **summary,
         busy_share_of_unprofiled_wall=(device_ms / (wall8_s * 1e3)
                                        if device_ms is not None else None))
    del engine8, poolw8, qparams
    torch.cuda.empty_cache()

    # ---------------------------------------------- decode_int8_flagship
    decode_rec, decode_launches = decode_int8_flagship(params, cfg, dev)
    emit("decode_int8_flagship", **decode_rec)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- train
    # the last main path: the flagship burn-in train step. The serve
    # state goes first (the train step needs the card's memory); the
    # weights are the same seeded flagship draw.
    bwd_res = kernel_flash_bwd_resources()
    bwd = kernel_flash_bwd(randn, dev, train_shape)
    train_exact(dev)
    rec, train_launches = train_flagship(params, dev)
    emit("train_flagship", **rec)
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
         "library_ms": k7_rec["library_ms"]},
        {"name": "paged_decode_int8", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/paged_decode.cu",
         "replaces":
             "nvidia_terraform_modules_tpu/ops/decode_attention.py:332",
         "launches": launches8["paged_decode_int8"],
         **{key: k7i8_rec[key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}},
        {"name": "kv_decode", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/kv_decode.cu",
         "replaces":
             "nvidia_terraform_modules_tpu/ops/decode_attention.py:196",
         "launches": decode_launches["kv_decode"],
         **{key: k6_main["step"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}},
        # K8: the mean per launch over a wave's 49 products
        {"name": "int8_matmul", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "nvidia_terraform_modules_tpu/ops/int8_matmul.py:90",
         "launches": launches8["int8_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in k8_main.values()),
         **{key: wave_mean(k8_main, key) for key in (
             "ms", "plain_ms", "bound_ms", "library_ms")},
         "bound_by": k8_main["square"]["bound_by"]},
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
