#!/usr/bin/env python3
# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Chip smoke test of the PyTorch / H100 port (``nvidia_terraform_modules_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` with nvcc (into
``build/torch_kernels/``), and drives the port's two main paths:

- serve: holds K1 (flash forward) and K7 (paged decode) against their plain
  PyTorch versions at the serve path's shapes, checks the engine's
  exactness contract on the card, serves at the flagship width (the launch
  counts show it went through both kernels) and profiles one more run of
  the same traffic (device time by kernel against the host clock);
- train: holds K5 (fused flash backward) and K3/K4 (the split pair)
  against their plain versions, up to the flagship's per-layer
  ``[2, 4096, 16, 128]``; checks the train step's gradients on the card
  against the dense model, fused against split, remat and accumulation;
  runs SGD and AdamW steps of the flagship burn-in step at full width and
  depth (the launch counts show it went through K1 and K5, or K3 + K4);
  and profiles one step.

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
# the backward kernels' FLOPs as multiples of the forward's (tile products:
# 5, 3 and 4 against the forward's 2) and the [B, S, H, D] tensors each
# writes
BWD_FACTOR = {"flash_bwd_fused": 2.5, "flash_dq": 1.5, "flash_dkv": 2.0}
BWD_OUTPUTS = {"flash_bwd_fused": 3, "flash_dq": 1, "flash_dkv": 2}
# the backward kernels' limits: max-abs error over max(1, max|ref|), and
# the relative L2 error ||got - ref|| / ||ref||, which holds the many small
# gradients of a long sequence that the max-abs limit is loose for
BWD_TOL = {"bf16": (2e-2, 1e-2), "f32": (1e-4, 1e-4)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(flops: float, nbytes: float, kind: str) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_ops = flops / H100_PEAK[kind]
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def profile_summary(prof, wall_ms: float) -> dict:
    """Device time summed by kernel name from a ``torch.profiler`` run,
    against the run's wall clock. An empty trace means the profiler saw no
    device activity: the device numbers are then "not measured" (null)."""
    kernels_us: dict[str, list] = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            acc = kernels_us.setdefault(evt.key, [0.0, 0])
            acc[0] += evt.self_device_time_total
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
                             for k, (us, c) in top])


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
    expect = {"flash_fwd": cfg.n_layers, "paged_decode": 0,
              "flash_bwd_fused": cfg.n_layers, "flash_dq": 0, "flash_dkv": 0}
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


def flagship_lengths() -> list[int]:
    from nvidia_terraform_modules_tpu_torch.utils.traffic import (
        ragged_lengths,
    )

    lens = ragged_lengths(N_REQUESTS, SEED, lo=128, hi=512)
    return [min(512, max(128, 8 * round(n / 8))) for n in lens]


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
        forward_cached,
        forward_paged,
        greedy_decode,
        init_cache,
        init_paged_cache,
        init_params,
        make_serve_engine,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.ops import _build
    from nvidia_terraform_modules_tpu_torch.ops.decode_attention import (
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    from nvidia_terraform_modules_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_ref,
    )
    from nvidia_terraform_modules_tpu_torch.utils.timing import (
        cuda_median_ms,
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

    # -------------------------------------------------- kernel_flash_fwd
    lens = flagship_lengths()
    # (batch, S, dtype, mask, KV heads, main path); K1 runs on both paths:
    # at the serve prompts' shapes and at the train step's per-layer shape
    cases = [(1, s, bf16, "causal", 16, False) for s in (128, 512, 136)]
    cases += [(1, 64, f32, "causal", 1, False),
              (1, 512, bf16, ("window", 128), 16, False)]
    cases += [(1, s, bf16, "causal", 16, "serve") for s in sorted(set(lens))]
    cases += [(*train_shape, bf16, "causal", 16, "train")]
    k1_main = []
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
        bound_ms, bound_by = bound(4.0 * b * h * d * live, nbytes,
                                   "bf16" if dtype == bf16 else "f32")
        rec = dict(shape=[b, s, h, d], kv_heads=kv, dtype=str(dtype),
                   mask=mask, main_path=on_path, max_abs_err=err_o,
                   lse_err=err_l, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit("kernel_flash_fwd", **rec)
        if on_path == "serve":
            k1_main.append((lens.count(s), rec))

    # ----------------------------------------------- kernel_paged_decode
    # the flagship wave: SLOTS rows at mid-generation of the first SLOTS
    # requests, the engine's default pool of one full table per slot
    max_len = max(lens) + N_NEW
    wave_pos = [n + N_NEW // 2 for n in lens[:SLOTS]]
    b, h, kv, d, bs = SLOTS, 16, 16, 128, KV_BLOCK
    k7_cases = [(bf16, 1e-2, [559, 301, 77, 130], -(-576 // bs), False),
                (f32, 1e-5, [559, 301, 77, 130], -(-576 // bs), False),
                (bf16, 1e-2, wave_pos, -(-max_len // bs), True)]
    k7_rec = None
    for dtype, tol, pos_list, nt, on_path in k7_cases:
        nb = 1 + b * nt
        k_pool, v_pool = randn((nb, bs, kv, d), dtype), \
            randn((nb, bs, kv, d), dtype)
        k_pool[0] = 1e4              # garbage block: a read would show
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
        out = paged_decode_attention(q, k_pool, v_pool, tables, pos,
                                     scale=scale)
        ref = paged_decode_attention_ref(q, k_pool, v_pool, tables, pos,
                                         scale=scale)
        sync()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"paged_decode {dtype}: err {err} "
                                 f"(tol {tol})")
        ms = cuda_median_ms(lambda: paged_decode_attention(
            q, k_pool, v_pool, tables, pos, scale=scale))
        plain_ms = cuda_median_ms(lambda: paged_decode_attention_ref(
            q, k_pool, v_pool, tables, pos, scale=scale))
        # yardstick: SDPA over the PRE-GATHERED logical view (the gather
        # itself is not timed) with the position mask
        k_log = k_pool[tables.long()].reshape(b, nt * bs, kv, d)
        v_log = v_pool[tables.long()].reshape(b, nt * bs, kv, d)
        k_log, v_log = (x.transpose(1, 2).contiguous() for x in
                        (k_log, v_log))
        amask = (torch.arange(nt * bs, device=dev)[None, :]
                 <= pos.long()[:, None])[:, None, None, :]
        library_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k_log, v_log, attn_mask=amask, scale=scale))
        live = int((pos.long() + 1).sum())
        elt = q.element_size()
        nbytes = 2 * live * kv * d * elt + 2 * b * h * d * elt \
            + tables.numel() * 4 + b * 4
        bound_ms, bound_by = bound(4.0 * (h // kv) * kv * d * live, nbytes,
                                   "bf16" if dtype == bf16 else "f32")
        rec = dict(b=b, heads=h, kv_heads=kv, d=d, block_size=bs,
                   table_width=nt, pos=pos.tolist(), dtype=str(dtype),
                   main_path=on_path, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, ctas=b * kv)
        emit("kernel_paged_decode", **rec)
        if on_path:
            k7_rec = rec

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
    emit("serve_flagship", params=n_params, prompt_lens=lens,
         requests=admissions, generated=st["generated"], waves=waves,
         wall_s=wall_s, tokens_per_s=st["generated"] / wall_s,
         ms_per_wave=wave_ms,
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

    # ------------------------------------------------------------- train
    # the second main path: the flagship burn-in train step. The serve
    # state goes first (the train step needs the card's memory); the
    # weights are the same seeded flagship draw.
    del engine, poolw, pool1
    torch.cuda.empty_cache()
    bwd = kernel_flash_bwd(randn, dev, train_shape)
    train_exact(dev)
    rec, train_launches = train_flagship(params, dev)
    emit("train_flagship", **rec)
    emit("train_profile", **train_profile(params, dev))

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
         "library_ms": k1_mean("library_ms")},
        {"name": "paged_decode", "route": "cuda",
         "source": "nvidia_terraform_modules_tpu_torch/csrc/paged_decode.cu",
         "replaces":
             "nvidia_terraform_modules_tpu/ops/decode_attention.py:332",
         "launches": launches["paged_decode"],
         "max_abs_err": k7_rec["max_abs_err"], "ms": k7_rec["ms"],
         "plain_ms": k7_rec["plain_ms"], "bound_ms": k7_rec["bound_ms"],
         "bound_by": k7_rec["bound_by"],
         "library_ms": k7_rec["library_ms"]},
    ]
    for name, line in (("flash_bwd_fused", 724), ("flash_dq", 657),
                       ("flash_dkv", 688)):
        r = bwd[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nvidia_terraform_modules_tpu_torch/csrc/flash_bwd.cu",
            "replaces":
                f"nvidia_terraform_modules_tpu/ops/flash_attention.py:{line}",
            # K5's count is the timed fused steps'; K3's and K4's the
            # split step's of the same phase
            "launches": (train_launches[name] if name == "flash_bwd_fused"
                         else rec["split_step_launches"][name]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
