# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""T=1 decode attention — the port of the reference's
``ops/decode_attention.py``: over a contiguous cache
(:func:`kv_decode_attention`, K6) and through the block tables of the
paged pool (:func:`paged_decode_attention`, K7), each for bf16/f32 caches
and for int8 caches whose per-vector f32 scales fold after the products.

- :func:`kv_decode_attention`: ``q [B, H, D]`` over ``k_cache``/``v_cache``
  ``[B, S, KV, D]``, keys at ``s <= pos[b]``; with ``k_scale``/``v_scale``
  ``[B, S, KV]`` the cache is int8. :func:`int8_kv_decode_attention` is the
  same with the scales required.
- :func:`paged_decode_attention`: ``q [B, H, D]`` over the physical pool
  ``[num_blocks, block_size, KV, D]`` via ``tables [B, NT]`` int32 and
  per-row ``pos [B]`` int32 (keys at logical ``s <= pos`` take part —
  which also fences recycled-block garbage and frozen retired slots,
  exactly as the gather path's position mask does); an int8 pool passes
  ``[num_blocks, block_size, KV]`` sidecars that ride the same tables.

Each wrapper launches its CUDA kernel on a CUDA tensor (``csrc/kv_decode.cu``,
``csrc/paged_decode.cu``, one fold in ``csrc/decode_tiles.cuh``; ``head_dim
% 8 == 0`` — ``% 16`` for int8 — and ``<= 256``, anything else raises) and
runs its plain version on a CPU tensor: :func:`kv_decode_attention_ref` /
:func:`paged_decode_attention_ref`, the gather of the logical view followed
by :func:`masked_attention`, the masked softmax the kernels replace. The
int8 paged kernel counts as ``paged_decode_int8``, apart from the bf16/f32
``paged_decode``.

Both kernels split a row's keys into spans of :data:`DECODE_SPAN` keys
(flash-decoding; the span rule is :func:`decode_spans`): the grid and the
f32 partials of the spans (:func:`decode_workspace_shape`) follow from the
buffer's width — the table's ``NT·bs`` or the cache's ``S`` — alone, never
from ``pos``, so the host reads nothing back. The spans of a row are
combined in span order inside the launch, by the last of its CTAs, which
an int32 counter per (row, KV head) elects. The partials and the counters
live in one scratch per device and stream (:func:`_span_scratch`),
allocated once and grown to the widest launch: launches on one stream run
in order, so they share it, and the kernels leave every counter at zero.
Outgrown scratch is never freed, so a CUDA graph captured on a stream (the
serve engine's wave) keeps valid addresses; it must be replayed on that
stream.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import NEG_INF


# Keys one CTA of the decode kernels folds: csrc/decode_tiles.cuh's kSpan
# (the C entry points refuse a span count of any other split).
DECODE_SPAN = 64

# span partials (f32) and counters (int32, zero between launches) by
# (device index, stream)
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
# scratch outgrown by a wider launch: kept alive, since a captured CUDA
# graph replays the addresses it recorded
_outgrown: list[torch.Tensor] = []


def decode_spans(rows: int) -> int:
    """The spans of a buffer of ``rows`` keys (a table's ``NT·bs`` or a
    cache's ``S``): ``ceil(rows / DECODE_SPAN)`` — the kernels' grid over
    a row, whatever its position or the batch."""
    if rows < 1:
        raise ValueError(f"a decode buffer holds at least one key, got "
                         f"{rows}")
    return -(-rows // DECODE_SPAN)


def decode_workspace_shape(batch: int, heads: int, kv_heads: int,
                           head_dim: int, rows: int) -> tuple:
    """The f32 span partials of one launch: ``[B, KV, spans, (H / KV)·(D
    + 2)]`` — each span's unnormalised accumulator and its (m, l) per query
    head of the group."""
    return (batch, kv_heads, decode_spans(rows),
            heads // kv_heads * (head_dim + 2))


def _span_scratch(device, stream, shape: tuple, counters: int):
    """The f32 span partials (room for ``shape``, a
    :func:`decode_workspace_shape`) and at least ``counters`` zeroed int32
    counters for launches on ``stream``: allocated once, and grown when a
    launch needs more."""
    key = (device.index, stream)
    ws, cnt = _scratch.get(key, (None, None))
    partials = shape[0] * shape[1] * shape[2] * shape[3]
    if ws is None or ws.numel() < partials:
        if ws is not None:
            _outgrown.append(ws)
        ws = torch.empty((partials,), dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < counters:
        if cnt is not None:
            _outgrown.append(cnt)
        cnt = torch.zeros((max(counters, 256),), dtype=torch.int32,
                          device=device)
    _scratch[key] = (ws, cnt)
    return ws, cnt


def masked_attention(q, k_cache, v_cache, q_pos, scale: float,
                     k_scale=None, v_scale=None):
    """Attention of ``q`` ``[B, T, H, D]`` over the whole cache buffer,
    keys at positions ``> q_pos`` masked (``q_pos`` ``[T]`` shared or
    ``[B, T]`` per row). GQA: queries reshape into their KV groups and
    contract against the un-repeated cache. Scores and the PV product
    accumulate in f32 from exact f32 copies of the operands; the
    probabilities are cast to ``q.dtype`` first. With ``k_scale``/
    ``v_scale`` ``[B, S, KV]`` the cache is int8 and the scales apply after
    the contractions, at the reference's rounding points: the f32 scores
    times ``scale`` times the k-scale; softmax; P times the v-scale, then
    cast to ``q.dtype``."""
    b, t, h, d = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    qg = q.reshape(b, t, kv, rep, d)
    # int8 → q.dtype → f32 is exact, as is bf16 → f32: one f32 copy serves
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                     k_cache.float()) * scale
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    if q_pos.dim() == 1:
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None, None]
    else:
        mask = (q_pos[:, :, None] >= k_pos[None, None, :])[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgts,bskd->btkgd", p.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def gather_logical(buf, tables, rows: int):
    """``buf[tables]`` flattened to ``rows`` logical rows — the read path
    the paged kernel replaces (K, V and both scale sidecars ride the same
    tables)."""
    shp = (tables.shape[0], rows) + tuple(buf.shape[2:])
    return buf[tables.long()].reshape(shp)


def _check_scales(k_scale, v_scale, k_cache):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is None:
        return False
    if k_cache.dtype != torch.int8:
        raise ValueError(f"scale sidecars come with an int8 cache, got "
                         f"{k_cache.dtype}")
    want = tuple(k_cache.shape[:3])
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} must be {want}")
    return True


def _check_heads(q, k, v):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode attention takes q [B, H, D] and caches "
                         "[rows..., KV, D]")
    h, d = q.shape[1:]
    kv = k.shape[2]
    if k.shape[3] != d:
        raise ValueError(f"cache head_dim {k.shape[3]} != q's {d}")
    if kv < 1 or h % kv:
        raise ValueError(f"q heads ({h}) must be a multiple of the cache's "
                         f"kv heads ({kv})")


def _check_cuda(q, k, quant, tensors):
    """What the CUDA kernels take; anything else raises (no fallback)."""
    d = q.shape[2]
    if d % (16 if quant else 8) or d > 256:
        raise ValueError(f"the decode kernels take head_dim % "
                         f"{16 if quant else 8} == 0 and <= 256, got {d}")
    if not quant and k.dtype != q.dtype:
        raise ValueError("q and a bf16/f32 cache must share one dtype")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
        if name in ("tables", "pos") and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
        if name.endswith("scale") and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32")


def kv_decode_attention_ref(q, k_cache, v_cache, pos, *, scale: float,
                            k_scale=None, v_scale=None):
    """The plain PyTorch version: :func:`masked_attention` at each row's
    position. Returns ``[B, H, D]`` in ``q.dtype``."""
    return masked_attention(q[:, None], k_cache, v_cache,
                            pos.long()[:, None], scale, k_scale,
                            v_scale)[:, 0]


def kv_decode_attention(q, k_cache, v_cache, pos, *, scale: float,
                        k_scale=None, v_scale=None):
    """One decode step of attention over a contiguous cache (int8 with
    ``k_scale``/``v_scale``, else bf16/f32). Returns ``[B, H, D]`` in
    ``q.dtype``."""
    _check_heads(q, k_cache, v_cache)
    b = q.shape[0]
    if k_cache.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"cache {tuple(k_cache.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    quant = _check_scales(k_scale, v_scale, k_cache)
    if q.device.type == "cpu":
        return kv_decode_attention_ref(q, k_cache, v_cache, pos, scale=scale,
                                       k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {q.device}")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("pos", pos)]
    if quant:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    _check_cuda(q, k_cache, quant, tensors)
    _, h, d = q.shape
    s_total, kv = k_cache.shape[1:3]
    out = torch.empty_like(q)
    shape = decode_workspace_shape(b, h, kv, d, s_total)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = _span_scratch(q.device, stream, shape, b * kv)
    rc = _build.lib().tk_kv_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, h, kv, d,
        s_total, shape[2], float(scale), _build.dtype_code(q.dtype),
        int(quant), stream)
    _build.check(rc, "kv_decode")
    _build.launches["kv_decode"] += 1
    return out


def int8_kv_decode_attention(q, k_cache, k_scale, v_cache, v_scale, pos, *,
                             scale: float):
    """One decode step over an int8 cache — :func:`kv_decode_attention`
    with the scale sidecars required (the reference's entry point)."""
    if k_scale is None or v_scale is None:
        raise ValueError("int8_kv_decode_attention needs both scales")
    return kv_decode_attention(q, k_cache, v_cache, pos, scale=scale,
                               k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention_ref(q, k_pool, v_pool, tables, pos, *,
                               scale: float, k_scale=None, v_scale=None):
    """The plain PyTorch version: gather the logical view
    ``k_pool[tables] → [B, NT·bs, KV, D]`` (and the sidecars with the same
    tables) and run :func:`masked_attention` at each row's position.
    Returns ``[B, H, D]`` in ``q.dtype``."""
    rows = tables.shape[1] * k_pool.shape[1]
    ks = vs = None
    if k_scale is not None:
        ks = gather_logical(k_scale, tables, rows)
        vs = gather_logical(v_scale, tables, rows)
    return masked_attention(
        q[:, None], gather_logical(k_pool, tables, rows),
        gather_logical(v_pool, tables, rows), pos.long()[:, None], scale,
        ks, vs)[:, 0]


def paged_decode_attention(q, k_pool, v_pool, tables, pos, *,
                           scale: float, k_scale=None, v_scale=None):
    """One decode step of attention through the block tables — no
    logical-view gather on the card. Returns ``[B, H, D]`` in
    ``q.dtype``."""
    _check_heads(q, k_pool, v_pool)
    b = q.shape[0]
    if tables.dim() != 2 or tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    quant = _check_scales(k_scale, v_scale, k_pool)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, tables, pos,
                                          scale=scale, k_scale=k_scale,
                                          v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("tables", tables), ("pos", pos)]
    if quant:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    _check_cuda(q, k_pool, quant, tensors)
    _, h, d = q.shape
    _, bs, kv, _ = k_pool.shape
    nt = tables.shape[1]
    out = torch.empty_like(q)
    shape = decode_workspace_shape(b, h, kv, d, nt * bs)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = _span_scratch(q.device, stream, shape, b * kv)
    rc = _build.lib().tk_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
        b, h, kv, d, bs, nt, shape[2], float(scale),
        _build.dtype_code(q.dtype), stream)
    name = "paged_decode_int8" if quant else "paged_decode"
    _build.check(rc, name)
    _build.launches[name] += 1
    return out
