# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""KV-cache decoding for the burn-in transformer — the port of the
reference's ``models/decode.py`` for the bf16 cache.

Two storage layouts share ONE trunk (:func:`_transformer_body`), so their
math cannot drift: :func:`forward_cached` over dense ``[B, S_max, KV, D]``
buffers and :func:`forward_paged` over the block/paged pool of
``models/paging.py``. Both write the fresh K/V rows IN PLACE (the
reference returned new buffers; it donated the old ones for the same
effect) and run under ``torch.no_grad``.

Attention paths:

- prompt prefill (``pos == 0``, T > 1) with ``prefill_impl="flash"`` runs
  the flash kernel (``ops/flash_attention``) on the prompt alone;
- the T=1 wave step of :func:`forward_paged` reads through the block
  tables with the paged decode kernel (``ops/decode_attention``) whenever
  the pool is on the card (``paged_kernel="auto"``);
- everything else — dense prefill, the gather read path
  (``paged_kernel="off"``), the CPU — is :func:`_cached_attention`, the
  masked softmax over the cache.

Exactness contract (as the reference's): with the dense prefill, greedy
tokens from the cache equal greedy tokens from re-running the full
forward; the flash prefill matches within kernel float tolerance.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.decode_attention import paged_decode_attention
from ..ops.flash_attention import NEG_INF, flash_attention, pick_impl
from ..utils.layers import rmsnorm as _rmsnorm
from .burnin import (
    BurnInConfig,
    _check_params,
    apply_rope,
    check_device,
    mlp,
)


def cache_rows(max_len: int, cache_dtype: str = "bf16") -> int:
    """Buffer row count for a cache of logical length ``max_len`` (the
    bf16 cache keeps exactly ``max_len``)."""
    if cache_dtype != "bf16":
        raise NotImplementedError(
            f"cache_dtype {cache_dtype!r} is not ported yet — ROADMAP.md, "
            f"Queue B: the int8 cache (K6 and the int8 variant of K7)")
    return max_len


def init_cache(cfg: BurnInConfig, batch: int, max_len: int, *,
               device="cuda") -> dict[str, Any]:
    """Zeroed KV cache: per layer ``[B, S_max, KV, D]`` k/v buffers in
    ``cfg.dtype``; ``pos`` (a host int) is the number of valid rows."""
    dev = check_device(device)
    shape = (batch, cache_rows(max_len), cfg.kv_heads, cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=cfg.dtype, device=dev)
              for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=cfg.dtype, device=dev)
              for _ in range(cfg.n_layers)],
        "pos": 0,
    }


def _cached_attention(q, k_cache, v_cache, q_pos, scale: float):
    """Attention of ``q`` ``[B, T, H, D]`` over the whole cache buffer,
    keys at positions ``> q_pos`` masked (``q_pos`` ``[T]`` shared or
    ``[B, T]`` per row). GQA: queries reshape into their KV groups and
    contract against the un-repeated cache. Scores and the PV product
    accumulate in f32 from input-dtype operands; the probabilities are
    cast to ``q.dtype`` first — the reference's bf16 branch."""
    b, t, h, d = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    qg = q.reshape(b, t, kv, rep, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                     k_cache.float()) * scale
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    if q_pos.dim() == 1:
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None, None]
    else:
        mask = (q_pos[:, :, None] >= k_pos[None, None, :])[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _transformer_body(params, tokens, cfg: BurnInConfig, q_pos, store,
                      attend):
    """The cached-transformer trunk shared by both storage layouts: per
    layer ``store(li, k, v) → handle`` writes the fresh rows and
    ``attend(li, q, k, v, handle) → [B, T, H, D]`` computes attention;
    projections, rope at ``q_pos``, residuals, the MLP and the tied
    unembedding are this one function."""
    b, t = tokens.shape
    x = params["embed"][tokens]
    for li, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["attn_norm"])
        q = (h @ layer["wq"]).view(b, t, cfg.n_heads, cfg.head_dim)
        k = (h @ layer["wk"]).view(b, t, cfg.kv_heads, cfg.head_dim)
        v = (h @ layer["wv"]).view(b, t, cfg.kv_heads, cfg.head_dim)
        if cfg.rope:
            # K rotates before the cache write: cached rows never need
            # re-rotation at later steps
            q = apply_rope(q, q_pos, cfg.rope_theta)
            k = apply_rope(k, q_pos, cfg.rope_theta)
        handle = store(li, k, v)
        attn = attend(li, q, k, v, handle)
        x = x + attn.reshape(b, t, cfg.d_model) @ layer["wo"]
        x = x + mlp(_rmsnorm(x, layer["mlp_norm"]), layer, cfg.dtype)
    x = _rmsnorm(x, params["out_norm"])
    return x @ params["embed"].T


def _prompt_attention(q, k, v, scale: float, prefill_impl: str):
    """The ``pos == 0`` prompt branch shared by both layouts: with
    ``"flash"`` and T > 1, causal attention over the prompt alone through
    the flash kernel (K/V un-repeated — the kernel indexes the KV group).
    ``None`` → the caller attends over its stored context instead."""
    if q.shape[1] > 1 and prefill_impl == "flash":
        return flash_attention(q, k, v, causal=True, scale=scale)
    return None


@torch.no_grad()
def forward_cached(params, tokens, cache, cfg: BurnInConfig, *,
                   prefill_impl: str = "dense"):
    """Forward ``tokens`` ``[B, T]`` starting at ``cache["pos"]``: writes
    the new K/V rows into the cache (in place) and returns ``(logits
    [B, T, vocab], cache)``. ``prefill_impl="flash"`` is valid only at
    ``pos == 0`` (``greedy_decode`` selects it exactly there)."""
    b, t = tokens.shape
    pos0 = cache["pos"]
    s_max = cache["k"][0].shape[1]
    if pos0 + t > s_max:
        raise ValueError(f"pos ({pos0}) + T ({t}) exceeds the cache's "
                         f"{s_max} rows")
    q_pos = torch.arange(pos0, pos0 + t, device=tokens.device)
    scale = 1.0 / (cfg.head_dim ** 0.5)

    def store(li, k, v):
        cache["k"][li][:, pos0:pos0 + t] = k
        cache["v"][li][:, pos0:pos0 + t] = v

    def attend(li, q, k, v, handle):
        attn = _prompt_attention(q, k, v, scale, prefill_impl)
        if attn is not None:
            return attn
        return _cached_attention(q, cache["k"][li], cache["v"][li], q_pos,
                                 scale)

    logits = _transformer_body(params, tokens, cfg, q_pos, store, attend)
    cache["pos"] = pos0 + t
    return logits, cache


def _paged_kernel_on(paged_kernel: str, t: int, device: torch.device) -> bool:
    """``forward_paged``'s read-path dispatch for a T-token step:
    ``"auto"`` takes the paged kernel for every T=1 step on a CUDA pool;
    ``"on"`` for every T=1 step (a CPU pool then runs the kernel's plain
    version); ``"off"`` keeps the gather path everywhere."""
    if paged_kernel not in ("auto", "on", "off"):
        raise ValueError(f"unknown paged_kernel {paged_kernel!r}: "
                         f"use auto|on|off")
    if paged_kernel == "off" or t != 1:
        return False
    return paged_kernel == "on" or device.type == "cuda"


def _gather_logical(buf, tables, rows: int):
    """``buf[tables]`` flattened to ``rows`` logical rows — the reference
    read path the paged kernel replaces."""
    shp = (tables.shape[0], rows) + tuple(buf.shape[2:])
    return buf[tables.long()].reshape(shp)


@torch.no_grad()
def forward_paged(params, tokens, cache, cfg: BurnInConfig, *,
                  prefill_impl: str = "cached", active=None,
                  paged_kernel: str = "auto"):
    """Forward ``tokens`` ``[B, T]`` through the paged pool
    (``cache["block_tables"]`` ``[B, NT]``, per-row ``cache["pos"]``
    ``[B]``), writing the fresh rows to ``(table[pos // bs], pos % bs)``
    in place. ``active`` ``[B]`` bool (default all true) fences dead
    rows: their writes go to garbage block 0 and their ``pos`` freezes.
    Reads: see the module docstring. Precondition (the caller's): each
    active row's ``pos + T`` stays within its allocated rows."""
    b, t = tokens.shape
    tables = cache["block_tables"]
    nt = tables.shape[1]
    bs = cache["k"][0].shape[1]
    pos0 = cache["pos"]
    dev = tokens.device
    q_pos = pos0.long()[:, None] + torch.arange(t, device=dev)[None, :]
    scale = 1.0 / (cfg.head_dim ** 0.5)
    kernel_on = _paged_kernel_on(paged_kernel, t, dev)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    blk = (q_pos // bs).clamp(0, nt - 1)
    pb = torch.gather(tables.long(), 1, blk)
    pb = torch.where(active[:, None], pb, 0)          # dead → garbage
    pr = q_pos % bs

    def store(li, k, v):
        cache["k"][li][pb, pr] = k
        cache["v"][li][pb, pr] = v

    def attend(li, q, k, v, handle):
        attn = _prompt_attention(q, k, v, scale, prefill_impl)
        if attn is not None:
            return attn
        if kernel_on:
            # through the tables, after this step's store: a frozen row
            # reads what the gather path would (same tables, same pos)
            return paged_decode_attention(
                q[:, 0], cache["k"][li], cache["v"][li], tables, pos0,
                scale=scale)[:, None]
        rows = nt * bs
        return _cached_attention(
            q, _gather_logical(cache["k"][li], tables, rows),
            _gather_logical(cache["v"][li], tables, rows), q_pos, scale)

    logits = _transformer_body(params, tokens, cfg, q_pos, store, attend)
    cache["pos"] = torch.where(active, pos0 + t, pos0)
    return logits, cache


def _select_prefill_impl(cfg: BurnInConfig, t: int, prefill: str) -> str:
    """Resolve the prefill attention: ``"auto"`` follows the training
    layout (dense-trained → the exact masked-cache path, every other
    layout → flash); a non-tiling prompt under auto-resolved flash falls
    back to dense up to 512 tokens and raises beyond, as does an explicit
    ``"flash"`` request."""
    if prefill not in ("auto", "dense", "flash"):
        raise ValueError(f"unknown prefill {prefill!r}; use auto|dense|flash")
    requested = prefill
    if prefill == "auto":
        prefill = "dense" if cfg.attn == "dense" else "flash"
    if prefill == "flash" and pick_impl(None, t, "prefill") != "flash":
        if requested == "auto" and t <= 512:
            return "dense"
        raise ValueError(
            f"prompt length {t} has no 8-multiple block divisor for the "
            f"flash prefill — pad the prompt (dense prefill at this "
            f"length would materialise the full [T, S_max] score matrix)")
    return prefill


@torch.no_grad()
def greedy_decode(params, prompt, n_new: int, cfg: BurnInConfig,
                  max_len: int | None = None, prefill: str = "auto", *,
                  device="cuda"):
    """Greedy generation: prefill ``prompt`` ``[B, T]``, then ``n_new - 1``
    cached steps. Returns the ``[B, n_new]`` generated tokens (int64, on
    ``device``)."""
    dev = check_device(device)
    _check_params(params, dev)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, t = prompt.shape
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if max_len is None:
        max_len = t + n_new
    if t + n_new > max_len:
        raise ValueError(f"prompt ({t}) + n_new ({n_new}) exceeds "
                         f"max_len ({max_len})")
    cache = init_cache(cfg, b, max_len, device=dev)
    logits, cache = forward_cached(
        params, prompt, cache, cfg,
        prefill_impl=_select_prefill_impl(cfg, t, prefill))
    tok = logits[:, -1].argmax(dim=-1)
    toks = [tok]
    for _ in range(n_new - 1):
        logits, cache = forward_cached(params, tok[:, None], cache, cfg)
        tok = logits[:, -1].argmax(dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)
