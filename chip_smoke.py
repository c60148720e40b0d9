#!/usr/bin/env python3
# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Chip smoke test of the PyTorch / H100 port (``nvidia_terraform_modules_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` with nvcc (into
``build/torch_kernels/``), holds each kernel against its plain PyTorch
version at the serve path's shapes, checks the engine's exactness
contract on the card, then drives the main path — the continuous-batching
serve engine at the flagship width — and shows through the launch counts
that it went through both kernels; last it profiles one more run of the
same traffic to show where the serve time goes (device time by kernel
against the host clock). Every phase prints one JSON line; any
failure raises and the script exits non-zero. Without a CUDA device it
exits 1 and prints no result; it imports nothing of JAX.

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

FLAGSHIP = dict(vocab=8192, d_model=2048, n_heads=16, d_ff=8192,
                n_layers=8, attn="flash")          # bench.py's flagship
N_REQUESTS, SLOTS, KV_BLOCK, N_NEW, SEED = 8, 4, 16, 32, 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(flops: float, nbytes: float, kind: str) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_ops = flops / H100_PEAK[kind]
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
        BurnInConfig,
        forward_cached,
        forward_paged,
        greedy_decode,
        init_cache,
        init_paged_cache,
        init_params,
        make_serve_engine,
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
    cases = [(s, bf16, "causal", 16, False) for s in (128, 512, 136)]
    cases += [(64, f32, "causal", 1, False),
              (512, bf16, ("window", 128), 16, False)]
    cases += [(s, bf16, "causal", 16, True) for s in sorted(set(lens))]
    k1_main = []
    for s, dtype, mask, kv, on_path in cases:
        h, d = (16, 128) if kv == 16 else (2, 128)
        q, k, v = (randn((1, s, n, d), dtype) for n in (h, kv, kv))
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
        nbytes = (2 * h + 2 * kv) * s * d * elt + h * s * 4
        bound_ms, bound_by = bound(4.0 * h * d * live, nbytes,
                                   "bf16" if dtype == bf16 else "f32")
        rec = dict(shape=[1, s, h, d], kv_heads=kv, dtype=str(dtype),
                   mask=mask, main_path=on_path, max_abs_err=err_o,
                   lse_err=err_l, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit("kernel_flash_fwd", **rec)
        if on_path:
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
    cfg = BurnInConfig(**FLAGSHIP, dtype=bf16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    n_params = sum(p.numel() for p in [params["embed"], params["out_norm"]]
                   + [t for layer in params["layers"]
                      for t in layer.values()])
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
    kernels_us: dict[str, list] = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            acc = kernels_us.setdefault(evt.key, [0.0, 0])
            acc[0] += evt.self_device_time_total
            acc[1] += evt.count
    # an empty trace means the profiler saw no device activity there:
    # the device numbers are then "not measured" (null), not zero
    device_ms = (sum(us for us, _ in kernels_us.values()) / 1e3
                 if kernels_us else None)
    top = sorted(kernels_us.items(), key=lambda kv_: -kv_[1][0])[:12]
    emit("serve_profile", wall_ms=prof_wall_ms, device_ms=device_ms,
         busy_share_profiled=(device_ms / prof_wall_ms
                              if device_ms is not None else None),
         busy_share_of_unprofiled_wall=(device_ms / (wall_s * 1e3)
                                        if device_ms is not None else None),
         kernel_launches=sum(c for _, c in kernels_us.values()),
         top_kernels=[{"name": k[:90], "ms": us / 1e3, "count": c}
                      for k, (us, c) in top])

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
