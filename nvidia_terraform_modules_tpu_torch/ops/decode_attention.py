# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Paged decode attention — the port of the reference's
``ops/decode_attention.py`` ``paged_decode_attention``.

One T=1 decode step attends THROUGH the block tables: ``q [B, H, D]``
over the physical pool ``[num_blocks, block_size, KV, D]`` via ``tables
[B, NT]`` int32 and per-row ``pos [B]`` int32 (keys at logical ``s <= pos``
take part — which also fences recycled-block garbage and frozen retired
slots, exactly as the gather path's position mask does).

:func:`paged_decode_attention` is the kernel wrapper: a CUDA tensor
launches ``csrc/paged_decode.cu`` (bf16/f32 pools, any block size,
``head_dim % 8 == 0`` and ``<= 256``; anything else raises), a CPU tensor
runs :func:`paged_decode_attention_ref` — the gather of ``k_pool[tables]``
followed by the masked softmax of ``models/decode._cached_attention``, the
read path the kernel replaces.

The int8 pool's scale sidecars are not ported yet (they come with the
contiguous int8 decode kernel): passing them raises.
"""

from __future__ import annotations

import torch

from . import _build


def _check(q, k_pool, v_pool, tables, pos, k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 paged pools (k_scale/v_scale sidecars) are not ported "
            "yet — ROADMAP.md, Queue B: the int8 variant of K7")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("paged decode takes q [B, H, D] and pools "
                         "[num_blocks, block_size, KV, D]")
    b, h, d = q.shape
    kv = k_pool.shape[2]
    if k_pool.shape[3] != d:
        raise ValueError(f"pool head_dim {k_pool.shape[3]} != q's {d}")
    if kv < 1 or h % kv:
        raise ValueError(f"q heads ({h}) must be a multiple of the pool's "
                         f"kv heads ({kv})")
    if tables.dim() != 2 or tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")


def paged_decode_attention_ref(q, k_pool, v_pool, tables, pos, *,
                               scale: float):
    """The plain PyTorch version: gather the logical view
    ``k_pool[tables] → [B, NT·bs, KV, D]`` and run the masked softmax of
    ``_cached_attention`` at each row's position. Returns ``[B, H, D]``
    in ``q.dtype``."""
    from ..models.decode import _cached_attention, _gather_logical

    nt = tables.shape[1]
    rows = nt * k_pool.shape[1]
    k_log = _gather_logical(k_pool, tables, rows)
    v_log = _gather_logical(v_pool, tables, rows)
    return _cached_attention(q[:, None], k_log, v_log,
                             pos.long()[:, None], scale)[:, 0]


def paged_decode_attention(q, k_pool, v_pool, tables, pos, *,
                           scale: float, k_scale=None, v_scale=None):
    """One decode step of attention through the block tables — no
    logical-view gather on the card. Returns ``[B, H, D]`` in
    ``q.dtype``."""
    _check(q, k_pool, v_pool, tables, pos, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, tables, pos,
                                          scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    b, h, d = q.shape
    nb, bs, kv, _ = k_pool.shape
    if d % 8 or d > 256:
        raise ValueError(f"the paged decode kernel takes head_dim % 8 == 0 "
                         f"and <= 256, got {d}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError("q and the pools must share one dtype")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("tables and pos must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    code = _build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    rc = _build.lib().tk_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, kv, d, bs,
        tables.shape[1], float(scale), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_decode")
    _build.launches["paged_decode"] += 1
    return out
