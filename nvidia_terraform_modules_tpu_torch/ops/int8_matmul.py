# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""int8-weight matrix product — the port of the reference's
``ops/int8_matmul.py``.

``int8_matmul(x, w, scale, transpose_rhs=)`` computes ``x [M, K] @
dequant(w)`` with ``w`` int8 in its storage orientation — ``[K, N]``, or
``[N, K]`` with ``transpose_rhs`` (the tied embedding head) — and one
symmetric f32 ``scale`` per output channel; the result comes back in
``x.dtype``. On a CUDA tensor it launches ``csrc/int8_matmul.cu`` (K8: the
int8 weight is read once per call, the products accumulate in f32 — on the
tensor cores for bf16 ``x`` — and the scale applies in the epilogue; it
takes bf16/f32 ``x`` with ``M <= 64``, ``K % 128 == 0`` and ``N % 64 ==
0``, and raises on anything else). On a CPU tensor it runs
:func:`int8_matmul_ref`, which dequantises in f32 before the product, as
the reference's plain version does.

K8 is one launch a product: its grid is channel blocks by K slices by row
groups (:func:`int8_grid` reads it from the kernel). The slices of a
channel block form one thread-block cluster and are summed in slice order
inside the launch through the cluster's shared memory, so the kernel needs
no scratch and keeps nothing between launches. The slice count
(:func:`int8_slices`) follows from K and N alone, never from M, so a row's
bits do not depend on the other rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_M = 64   # the decode regime the kernel is for (the caller's M rule)
# csrc/int8_matmul.cu's tile, which the K split counts in: output channels
# a CTA and k a pipeline stage
K8_BN = K8_BK = 128
# the CTAs the K split aims at: one for each of the H100's 132 SMs. A
# constant, never read from the device, so the split — and the bits — are
# the same on every card.
K8_CTAS = 132
# the fewest tiles a slice sweeps: each slice costs a CTA's start, its
# share of the cluster's combine and the wait for the cluster's slowest CTA.
# 2 rather than 4 puts the 2048² products on 128 SMs instead of 64, which
# timed faster on the H100 (PERF.md, K8 findings)
K8_MIN_TILES = 2
# the K slice counts the kernel takes: the divisors of K8_BN within the
# portable cluster size of 8 (csrc/int8_matmul.cu kMaxSlices), so the CTAs
# of a cluster own equal shares of the channels at the combine
K8_SLICES = (1, 2, 4, 8)


def int8_matmul_ref(x, w, scale, *, transpose_rhs: bool = False):
    """The plain version: ``w`` dequantised in f32 (``w · scale`` per
    output channel), an f32 product, the result cast to ``x.dtype``."""
    s = scale.float().reshape((-1, 1) if transpose_rhs else (1, -1))
    wd = w.float() * s
    out = x.float() @ (wd.T if transpose_rhs else wd)
    return out.to(x.dtype)


def _dims(x, w, transpose_rhs: bool):
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"int8_matmul takes x [M, K] and a 2-D w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, k2 = w.shape if transpose_rhs else w.shape[::-1]
    m, k = x.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    return m, k, n


@functools.lru_cache(maxsize=None)
def int8_slices(k: int, n: int) -> int:
    """K8's K split for ``K`` and ``N`` output channels: the most of
    :data:`K8_SLICES` that divide K's ``K / K8_BK`` tiles while the
    channel blocks times the slices stay within :data:`K8_CTAS` and each
    slice sweeps at least :data:`K8_MIN_TILES` tiles."""
    blocks = -(-n // K8_BN)
    tiles = k // K8_BK
    return max(d for d in K8_SLICES
               if tiles % d == 0 and (d == 1 or (
                   blocks * d <= K8_CTAS and tiles // d >= K8_MIN_TILES)))


def int8_grid(m: int, k: int, n: int) -> tuple[int, int, int]:
    """The grid K8 launches for ``x [M, K]`` and ``N`` output channels,
    as the kernel reports it: ``(channel blocks, K slices, row groups)``.
    Builds the kernels on first use; needs a CUDA device."""
    out = (ctypes.c_int * 3)()
    rc = _build.lib().tk_int8_matmul_grid(m, k, n, int8_slices(k, n),
                                          ctypes.addressof(out))
    _build.check(rc, "int8_matmul_grid")
    return tuple(out)


def int8_matmul_resources(*, transpose_rhs: bool = False,
                          dtype=torch.bfloat16) -> dict:
    """What K8's instance for ``dtype`` x (and ``[N, K]`` weights with
    ``transpose_rhs``) takes on the card: ``registers`` a thread,
    ``spill_bytes`` (local memory) a thread, ``smem_bytes`` of dynamic
    shared memory and ``ctas_per_sm`` that fit an SM. Builds the kernels
    on first use; needs a CUDA device."""
    out = (ctypes.c_int * 4)()
    rc = _build.lib().tk_int8_matmul_info(
        int(transpose_rhs), _build.dtype_code(dtype), ctypes.addressof(out))
    _build.check(rc, "int8_matmul_info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "ctas_per_sm"), out))


def int8_matmul(x, w, scale, *, transpose_rhs: bool = False):
    """``x [M, K] @ dequant(w) → [M, N]`` in ``x.dtype``."""
    m, k, n = _dims(x, w, transpose_rhs)
    if w.dtype != torch.int8:
        raise ValueError(f"w must be int8, got {w.dtype}")
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for N = {n}")
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w, scale, transpose_rhs=transpose_rhs)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul kernel for device {x.device}")
    if not 1 <= m <= MAX_M or k % 128 or n % 64:
        raise ValueError(f"the int8 matmul kernel takes 1 <= M <= {MAX_M}, "
                         f"K % 128 == 0 and N % 64 == 0, got M={m}, K={k}, "
                         f"N={n}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    for name, t in (("x", x), ("w", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _build.lib().tk_int8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k,
        n, int8_slices(k, n), int(transpose_rhs),
        _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_matmul")
    _build.launches["int8_matmul"] += 1
    return out
