# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""int8-weight matrix product — the port of the reference's
``ops/int8_matmul.py``.

``int8_matmul(x, w, scale, transpose_rhs=)`` computes ``x [M, K] @
dequant(w)`` with ``w`` int8 in its storage orientation — ``[K, N]``, or
``[N, K]`` with ``transpose_rhs`` (the tied embedding head) — and one
symmetric f32 ``scale`` per output channel; the result comes back in
``x.dtype``. On a CUDA tensor it launches ``csrc/int8_matmul.cu`` (K8: the
int8 weight is read once per call, the products accumulate in f32 and the
scale applies in the epilogue; it takes bf16/f32 ``x`` with ``M <= 64``,
``K % 128 == 0`` and ``N % 64 == 0``, and raises on anything else). On a
CPU tensor it runs :func:`int8_matmul_ref`, which dequantises in f32 before
the product, as the reference's plain version does.
"""

from __future__ import annotations

import torch

from . import _build

MAX_M = 64   # the decode regime the kernel is for (the caller's M rule)


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
    ks = 256 if k % 256 == 0 else 128
    part = torch.empty((k // ks, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _build.lib().tk_int8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), part.data_ptr(),
        out.data_ptr(), m, k, n, ks, int(transpose_rhs),
        _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_matmul")
    _build.launches["int8_matmul"] += 1
    return out
