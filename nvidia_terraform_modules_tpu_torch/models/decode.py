# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""KV-cache decoding for the burn-in transformer — the port of the
reference's ``models/decode.py``, for the bf16 cache and the int8 cache
(``cache_dtype="int8"``: symmetric per-vector int8 rows with an f32 scale
per cached vector, quantised on write, rounded up to a 256-row grain).

Two storage layouts share ONE trunk (:func:`_transformer_body`), so their
math cannot drift: :func:`forward_cached` over dense ``[B, S_max, KV, D]``
buffers and :func:`forward_paged` over the block/paged pool of
``models/paging.py``. Both write the fresh K/V rows IN PLACE (the
reference returned new buffers; it donated the old ones for the same
effect) and run under ``torch.no_grad``.

Attention paths:

- prompt prefill (``pos == 0``, T > 1) with ``prefill_impl="flash"`` runs
  the flash kernel (``ops/flash_attention``) on the prompt alone; with
  ``"dense"`` under an int8 cache, the masked softmax over the prompt's
  full-precision k/v (only later steps read quantised rows);
- the T=1 wave step of :func:`forward_paged` reads through the block
  tables with the paged decode kernel (``ops/decode_attention``, K7 or its
  int8 variant) whenever the pool is on the card (``paged_kernel="auto"``);
- the T=1 step over an int8 cache — contiguous, or the gathered view of
  the pool — goes through ``int8_kv_decode_attention`` (K6 on the card,
  its plain version on the CPU);
- everything else — dense prefill, the bf16 gather read path
  (``paged_kernel="off"``), the CPU — is the masked softmax over the
  cache (``ops/decode_attention.masked_attention``).

The reference's ``int8_kernel`` flag (the T=1 int8 kernel off for
mesh-sharded pools) has no counterpart: the port has no sharded pools yet.

:func:`make_decoder` is the compiled greedy decoder (the reference's
``jax.jit`` over :func:`greedy_decode`): on the card one call is the eager
prefill and one replay of a CUDA graph of the decode steps
(:class:`_DecodeGraph`, over :class:`_Replayed`, which the serve engine's
wave graphs share).

Exactness contract (as the reference's): with the dense prefill and the
bf16 cache, greedy tokens from the cache equal greedy tokens from
re-running the full forward; the flash prefill matches within kernel float
tolerance. The int8 cache is lossy by construction.
"""

from __future__ import annotations

import gc
from typing import Any

import torch

from ..ops import _build
from ..ops.decode_attention import gather_logical as _gather_logical
from ..ops.decode_attention import (
    int8_kv_decode_attention,
    masked_attention,
    paged_decode_attention,
)
from ..ops.flash_attention import flash_attention, pick_impl
from ..ops.sampling import draw, key_data, split
from ..utils.layers import rmsnorm as _rmsnorm
from .burnin import (
    BurnInConfig,
    _check_params,
    apply_rope,
    check_device,
    mlp,
    tree_leaves,
)
from .moe import drop_free_capacity, routed_ffn


CACHE_DTYPES = ("bf16", "int8")


def check_cache_dtype(cache_dtype: str) -> bool:
    """Validate ``cache_dtype``; True for the int8 cache."""
    if cache_dtype not in CACHE_DTYPES:
        raise ValueError(f"unknown cache_dtype {cache_dtype!r}: use "
                         f"bf16|int8")
    return cache_dtype == "int8"


def cache_rows(max_len: int, cache_dtype: str = "bf16") -> int:
    """Buffer row count for a cache of logical length ``max_len``: the
    bf16 cache keeps exactly ``max_len``, the int8 cache rounds up to the
    reference's 256-row kernel grain (rows past ``max_len`` sit above
    ``pos`` forever). Every cache constructor (``init_cache``, the paged
    pool) agrees on this one number."""
    if cache_dtype == "int8":
        return -(-max_len // 256) * 256
    return max_len


def quantize_kv(x):
    """Per-vector symmetric int8 for cache rows: ``[..., D]`` → ``(q int8,
    scale f32 [...])`` with ``|dequant - x| <= scale / 2``."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_cache(cfg: BurnInConfig, batch: int, max_len: int, *,
               cache_dtype: str = "bf16", device="cuda") -> dict[str, Any]:
    """Zeroed KV cache: per layer ``[B, cache_rows(max_len), KV, D]`` k/v
    buffers in ``cfg.dtype``, or int8 with f32 ``k_scale``/``v_scale``
    ``[B, rows, KV]`` sidecars under ``cache_dtype="int8"``; ``pos`` (a
    host int) is the number of valid rows."""
    dev = check_device(device)
    quant = check_cache_dtype(cache_dtype)
    shape = (batch, cache_rows(max_len, cache_dtype), cfg.kv_heads,
             cfg.head_dim)
    buf = torch.int8 if quant else cfg.dtype
    cache: dict[str, Any] = {
        "k": [torch.zeros(shape, dtype=buf, device=dev)
              for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=buf, device=dev)
              for _ in range(cfg.n_layers)],
        "pos": 0,
    }
    if quant:
        for key in ("k_scale", "v_scale"):
            cache[key] = [torch.zeros(shape[:3], dtype=torch.float32,
                                      device=dev)
                          for _ in range(cfg.n_layers)]
    return cache


def _cached_attention(q, k_cache, v_cache, q_pos, scale: float,
                      k_scale=None, v_scale=None):
    """Attention of ``q`` ``[B, T, H, D]`` over the whole cache buffer,
    keys at positions ``> q_pos`` masked (``q_pos`` ``[T]`` shared or
    ``[B, T]`` per row): ``ops/decode_attention.masked_attention``. The
    T=1 step over an int8 cache (``k_scale``/``v_scale`` given) goes
    through ``int8_kv_decode_attention`` on every device — K6 on the card,
    the same masked softmax on the CPU."""
    b, t = q.shape[:2]
    if k_scale is not None and t == 1:
        pos_b = q_pos.expand(b) if q_pos.dim() == 1 else q_pos[:, 0]
        return int8_kv_decode_attention(
            q[:, 0], k_cache, k_scale, v_cache, v_scale,
            pos_b.to(torch.int32).contiguous(), scale=scale)[:, None]
    return masked_attention(q, k_cache, v_cache, q_pos, scale, k_scale,
                            v_scale)


_MOE_PREFILL_CHUNK = 128   # tokens per routed chunk along the sequence


def _moe_ffn(h, layer, cfg: BurnInConfig):
    """The routed FFN of the serve path: training's ``moe_layer`` (less its
    aux loss, which serving drops) at drop-free capacity, so routing never
    depends on how many tokens share the batch and cached decode routes as
    a full re-forward does.

    The dispatch tensor is ``[T, E, C]`` with drop-free C growing with T,
    so a long prompt is routed in chunks of ``_MOE_PREFILL_CHUNK`` along
    the sequence (zero-padded, routed chunk by chunk, sliced back): at
    drop-free capacity each token routes on its own, so chunking changes
    memory, never results. Every shape here follows from ``h``'s: the step
    can be captured."""
    b, t, d = h.shape
    if t <= _MOE_PREFILL_CHUNK:
        return routed_ffn(h, layer["moe"], cfg, drop_free_capacity(b * t))[0]
    n = -(-t // _MOE_PREFILL_CHUNK)
    hp = torch.nn.functional.pad(h, (0, 0, 0, n * _MOE_PREFILL_CHUNK - t))
    cap = drop_free_capacity(b * _MOE_PREFILL_CHUNK)
    outs = [routed_ffn(chunk, layer["moe"], cfg, cap)[0]
            for chunk in hp.split(_MOE_PREFILL_CHUNK, dim=1)]
    return torch.cat(outs, dim=1)[:, :t]


def _transformer_body(params, tokens, cfg: BurnInConfig, q_pos, store,
                      attend):
    """The cached-transformer trunk shared by both storage layouts: per
    layer ``store(li, k, v) → handle`` writes the fresh rows and
    ``attend(li, q, k, v, handle) → [B, T, H, D]`` computes attention;
    projections, rope at ``q_pos``, residuals, the MLP (the routed FFN of
    :func:`_moe_ffn` with ``n_experts > 0``) and the tied unembedding are
    this one function."""
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
        h = _rmsnorm(x, layer["mlp_norm"])
        x = x + (_moe_ffn(h, layer, cfg) if cfg.n_experts > 0
                 else mlp(h, layer, cfg.dtype))
    x = _rmsnorm(x, params["out_norm"])
    return x @ params["embed"].T


def _prompt_attention(q, k, v, q_pos, scale: float, prefill_impl: str,
                      quant: bool):
    """The ``pos == 0`` prompt branches shared by both layouts (``None`` →
    the caller attends over its stored context instead):

    - ``"flash"`` and T > 1: causal attention over the prompt alone through
      the flash kernel (K/V un-repeated — the kernel indexes the KV group),
      on the full-precision k/v even under an int8 cache;
    - ``"dense"`` and T > 1 under an int8 cache: the masked softmax over
      the just-computed full-precision k/v, so a pure prefill matches the
      flash branch's precision — only later steps read quantised rows."""
    if q.shape[1] > 1 and prefill_impl == "flash":
        return flash_attention(q, k, v, causal=True, scale=scale)
    if q.shape[1] > 1 and prefill_impl == "dense" and quant:
        return _cached_attention(q, k, v, q_pos, scale)
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
    quant = "k_scale" in cache

    def store(li, k, v):
        if quant:
            # the cache never holds the full-precision rows
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            cache["k_scale"][li][:, pos0:pos0 + t] = k_s
            cache["v_scale"][li][:, pos0:pos0 + t] = v_s
        cache["k"][li][:, pos0:pos0 + t] = k
        cache["v"][li][:, pos0:pos0 + t] = v

    def attend(li, q, k, v, handle):
        attn = _prompt_attention(q, k, v, q_pos, scale, prefill_impl, quant)
        if attn is not None:
            return attn
        return _cached_attention(
            q, cache["k"][li], cache["v"][li], q_pos, scale,
            cache["k_scale"][li] if quant else None,
            cache["v_scale"][li] if quant else None)

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


@torch.no_grad()
def forward_paged(params, tokens, cache, cfg: BurnInConfig, *,
                  prefill_impl: str = "cached", active=None,
                  paged_kernel: str = "auto"):
    """Forward ``tokens`` ``[B, T]`` through the paged pool
    (``cache["block_tables"]`` ``[B, NT]``, per-row ``cache["pos"]``
    ``[B]``), writing the fresh rows to ``(table[pos // bs], pos % bs)``
    in place, and advances ``cache["pos"]`` in place. ``active`` ``[B]``
    bool (default all true) fences dead rows: their writes go to garbage
    block 0 and their ``pos`` freezes.
    An int8 pool (``k_scale``/``v_scale`` ``[num_blocks, block_size,
    KV]`` sidecars) quantises the fresh rows on write and stores their
    scales at the same places. Reads: see the module docstring; the
    sidecars ride the same tables. Precondition (the caller's): each
    active row's ``pos + T`` stays within its allocated rows."""
    b, t = tokens.shape
    tables = cache["block_tables"]
    nt = tables.shape[1]
    bs = cache["k"][0].shape[1]
    pos0 = cache["pos"]
    dev = tokens.device
    q_pos = pos0.long()[:, None] + torch.arange(t, device=dev)[None, :]
    scale = 1.0 / (cfg.head_dim ** 0.5)
    quant = "k_scale" in cache
    kernel_on = _paged_kernel_on(paged_kernel, t, dev)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    blk = (q_pos // bs).clamp(0, nt - 1)
    pb = torch.gather(tables.long(), 1, blk)
    pb = torch.where(active[:, None], pb, 0)          # dead → garbage
    pr = q_pos % bs

    def store(li, k, v):
        if quant:
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            cache["k_scale"][li][pb, pr] = k_s
            cache["v_scale"][li][pb, pr] = v_s
        cache["k"][li][pb, pr] = k
        cache["v"][li][pb, pr] = v

    def attend(li, q, k, v, handle):
        attn = _prompt_attention(q, k, v, q_pos, scale, prefill_impl, quant)
        if attn is not None:
            return attn
        ks = cache["k_scale"][li] if quant else None
        vs = cache["v_scale"][li] if quant else None
        if kernel_on:
            # through the tables, after this step's store: a frozen row
            # reads what the gather path would (same tables, same pos)
            return paged_decode_attention(
                q[:, 0], cache["k"][li], cache["v"][li], tables, pos0,
                scale=scale, k_scale=ks, v_scale=vs)[:, None]
        rows = nt * bs
        if quant:
            ks = _gather_logical(ks, tables, rows)
            vs = _gather_logical(vs, tables, rows)
        return _cached_attention(
            q, _gather_logical(cache["k"][li], tables, rows),
            _gather_logical(cache["v"][li], tables, rows), q_pos, scale,
            ks, vs)

    logits = _transformer_body(params, tokens, cfg, q_pos, store, attend)
    # in place: a captured CUDA graph of this step, and the engine's
    # admissions, keep addressing the pool's own pos tensor
    pos0.copy_(torch.where(active, pos0 + t, pos0))
    return logits, cache


class _Replayed:
    """``fn()`` — work over static buffers (a serve wave over its pool, a
    decoder's steps over its cache) — run eagerly (``capture=False``, the
    CPU path) or captured once as a CUDA graph and replayed.

    It is captured, and replayed, on a stream of its own: the decode
    kernels keep their span partials and counters in one scratch per
    stream, so an eager launch on another stream can never race a replay
    on them. Before capture ``fn`` runs twice eagerly on that stream (the
    serve engine's waves with every slot dead, their writes in the garbage
    block), which builds the kernels and allocates that stream's scratch
    and cuBLAS workspace outside the capture. Python's cycle collector runs
    before the capture and not during it: a collection inside it could
    destroy an unreachable engine's graph, a call the capture forbids,
    which invalidates it. A capture that fails raises.

    A replay calls no kernel wrapper, so the wrappers' launch counts
    (``ops._build.launches``) would miss it: the counts the wrappers added
    during capture — the kernels the graph holds — are taken back out into
    :attr:`launches` and added again at each replay."""

    def __init__(self, fn, dev, capture: bool):
        self.fn = fn
        self.graph = None
        self.launches: dict[str, int] = {}
        if not capture:
            return
        self.stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for _ in range(2):
                fn()
        cur.wait_stream(self.stream)
        before = dict(_build.launches)
        self.graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=self.stream):
                fn()
        finally:
            if collecting:
                gc.enable()
            self.launches = {name: n - before.get(name, 0)
                             for name, n in _build.launches.items()
                             if n != before.get(name, 0)}
            _build.launches.update(before)

    def replay(self) -> None:
        """One run of ``fn``: the graph's replay on its stream, ordered
        after the current stream's work and before the current stream's
        next (or, uncaptured, ``fn()``)."""
        if self.graph is None:
            self.fn()
            return
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        cur.wait_stream(self.stream)
        for name, n in self.launches.items():
            _build.launches[name] += n


def _select_prefill_impl(cfg: BurnInConfig, t: int, prefill: str,
                         device: torch.device | None = None) -> str:
    """Resolve the prefill attention: ``"auto"`` follows the training
    layout (dense-trained → the exact masked-cache path, every other
    layout → flash). On a CUDA ``device`` flash runs at every prompt
    length (the kernel masks ragged tails, :func:`pick_impl`). Elsewhere
    the reference's tile rule holds: a non-tiling prompt under
    auto-resolved flash falls back to dense up to 512 tokens and raises
    beyond, as does an explicit ``"flash"`` request."""
    if prefill not in ("auto", "dense", "flash"):
        raise ValueError(f"unknown prefill {prefill!r}; use auto|dense|flash")
    requested = prefill
    if prefill == "auto":
        prefill = "dense" if cfg.attn == "dense" else "flash"
    if prefill == "flash" and pick_impl(None, t, "prefill",
                                        device) != "flash":
        if requested == "auto" and t <= 512:
            return "dense"
        raise ValueError(
            f"prompt length {t} has no 8-multiple block divisor for the "
            f"flash prefill — pad the prompt (dense prefill at this "
            f"length would materialise the full [T, S_max] score matrix)")
    return prefill


class Sampler:
    """The ``pick(logits [B, V], key) → [B]`` sampling function of
    :func:`make_sampler` (the reference's closure, as an object so that the
    serve engine can reach its parts): temperature, then top-k, then top-p
    over the tempered distribution, then the keyed Gumbel-max draw
    (``ops/sampling.draw``: D1 on the card)."""

    def __init__(self, temperature: float, top_k: int | None,
                 top_p: float | None):
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p

    def filter(self, logits):
        """The tempered, filtered f32 logits the draw reads: ``logits /
        temperature`` (an f32 division, as the reference's), then the
        top-k cut at the k-th value, then the rank-based nucleus."""
        t = torch.full((), self.temperature, dtype=torch.float32,
                       device=logits.device)
        logits = logits.float() / t
        k = self.top_k
        if k is not None and k < logits.shape[-1]:
            kth = torch.topk(logits, k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, -torch.inf, logits)
        if self.top_p is not None and self.top_p < 1.0:
            # keep ranks whose EXCLUSIVE prefix mass is < p: the first
            # always survives, the one crossing p is included, and a logit
            # tied with the boundary but ranked past it is cut
            order = torch.argsort(-logits, dim=-1, stable=True)
            probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
            keep_sorted = torch.cumsum(probs, dim=-1) - probs < self.top_p
            keep = torch.zeros_like(keep_sorted).scatter(-1, order,
                                                         keep_sorted)
            logits = torch.where(keep, logits, -torch.inf)
        return logits

    def __call__(self, logits, key):
        """One ``[2]`` key for the whole ``[B, V]`` batch, as
        ``jax.random.categorical(key, logits)``: row ``b`` counts its
        elements from ``b·V``."""
        logits = self.filter(logits)
        if self.top_k == 1:
            return logits.argmax(dim=-1)              # no tie-break draw
        b, v = logits.shape
        offsets = torch.arange(b, dtype=torch.int64,
                               device=logits.device) * v
        return draw(logits, key, offsets)

    def rows(self, logits, key, fold):
        """The serve engine's per-slot draw: row ``s`` keyed by
        ``fold_in(fold_in(key, request), position)`` with ``fold[s] =
        (request, position)``, each row a draw of its own (the reference
        vmaps ``pick(row[None], key_s)``)."""
        logits = self.filter(logits)
        if self.top_k == 1:
            return logits.argmax(dim=-1)
        return draw(logits, key, None, fold)


def make_sampler(temperature: float = 1.0, top_k: int | None = None,
                 top_p: float | None = None) -> Sampler:
    """Build the ``pick(logits [B, V], key) → [B]`` sampling function
    shared by :func:`sample_decode` and the serve engine: temperature →
    top-k → top-p in the mainstream order (temperature floored at 1e-6),
    ``top_k=1`` recovering greedy exactly. ``key`` is ``[2]`` int64 key data
    (``ops/sampling.key_data``)."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    return Sampler(max(float(temperature), 1e-6), top_k, top_p)


def _decode_len(t: int, n_new: int, max_len: int | None) -> int:
    """The cache length of a decode of ``n_new`` tokens after a ``t``-token
    prompt: ``max_len``, by default ``t + n_new``; raises when it is too
    short."""
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if max_len is None:
        max_len = t + n_new
    if t + n_new > max_len:
        raise ValueError(f"prompt ({t}) + n_new ({n_new}) exceeds "
                         f"max_len ({max_len})")
    return max_len


@torch.no_grad()
def _generate(params, prompt, n_new: int, cfg: BurnInConfig, max_len,
              pick_next, prefill: str, cache_dtype: str, dev):
    """Shared prefill + decode loop; ``pick_next`` is None (greedy) or
    ``(key, pick)``, token ``i`` drawn with ``split(key, n_new)[i]``."""
    _check_params(params, dev)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, t = prompt.shape
    max_len = _decode_len(t, n_new, max_len)
    cache = init_cache(cfg, b, max_len, cache_dtype=cache_dtype, device=dev)
    logits, cache = forward_cached(
        params, prompt, cache, cfg,
        prefill_impl=_select_prefill_impl(cfg, t, prefill, dev))
    if pick_next is None:
        def pick(lg, i):
            return lg.argmax(dim=-1)
    else:
        keys = split(pick_next[0], n_new)             # one per token

        def pick(lg, i):
            return pick_next[1](lg, keys[i])
    tok = pick(logits[:, -1], 0)
    toks = [tok]
    for i in range(1, n_new):
        logits, cache = forward_cached(params, tok[:, None], cache, cfg)
        tok = pick(logits[:, -1], i)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def greedy_decode(params, prompt, n_new: int, cfg: BurnInConfig,
                  max_len: int | None = None, prefill: str = "auto",
                  cache_dtype: str = "bf16", *, device="cuda"):
    """Greedy generation: prefill ``prompt`` ``[B, T]``, then ``n_new - 1``
    cached steps over a ``cache_dtype`` cache. ``params`` may hold int8
    ``QTensor`` weights (``models/quantize.py``). Returns the ``[B,
    n_new]`` generated tokens (int64, on ``device``)."""
    return _generate(params, prompt, n_new, cfg, max_len, None, prefill,
                     cache_dtype, check_device(device))


def _params_key(params) -> tuple:
    """What a captured graph reads of a params tree: each leaf's tensors
    at their addresses, with shape, strides and dtype (a ``QTensor``'s int8
    values and scales, with its layout flags and compute dtype). Two trees
    with equal keys are read identically by the graph; any other tree needs
    its own capture."""
    key = []
    for leaf in tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            tensors, flags = (leaf,), ()
        else:                                     # a QTensor
            tensors = (leaf.q, leaf.scale)
            flags = (leaf.scale_axis, leaf.transposed, leaf.dtype)
        key.append(flags + tuple((t.data_ptr(), tuple(t.shape), t.stride(),
                                  t.dtype) for t in tensors))
    return tuple(key)


class _DecodeGraph(_Replayed):
    """The ``n_new - 1`` cached steps of one greedy decode — one batch,
    prompt length, cache length and params tree — captured once as a CUDA
    graph (:class:`_Replayed`) and replayed each call: the replayed
    counterpart of :func:`_generate`'s loop.

    Every position is fixed within it, so the host-int position that
    :func:`forward_cached` reads and advances is baked in at capture: the
    captured function sets the cache's position to the prompt length at
    its start (the eager warm-ups before the capture run it too). The
    eager prefill writes the first token into column 0 of :attr:`out`;
    step ``i`` reads column ``i - 1`` and writes column ``i``. The graph
    reads the weights at the addresses of the tree it was captured over
    (:attr:`key`, :func:`_params_key`) and holds no reference to it.

    Cache rows above the prompt keep the previous call's decode rows; no
    read reaches them before the step that rewrites them (the masked
    softmax gives them probability 0, K6 reads the live rows only)."""

    def __init__(self, params, cfg: BurnInConfig, batch: int, t: int,
                 max_len: int, n_new: int, cache_dtype: str, dev):
        self.key = _params_key(params)
        self.cfg = cfg
        self.prefill_impl = _select_prefill_impl(cfg, t, "auto", dev)
        self.cache = cache = init_cache(cfg, batch, max_len,
                                        cache_dtype=cache_dtype, device=dev)
        self.out = out = torch.zeros((batch, n_new), dtype=torch.long,
                                     device=dev)
        weights = [params]                  # the capture's only reference

        @torch.no_grad()
        def steps():
            cache["pos"] = t
            for i in range(1, n_new):
                logits, _ = forward_cached(weights[0], out[:, i - 1:i], cache,
                                           cfg)
                out[:, i].copy_(logits[:, -1].argmax(dim=-1))

        super().__init__(steps, dev, capture=True)
        weights.clear()

    @torch.no_grad()
    def __call__(self, params, prompt):
        """The eager prefill of ``prompt``, then one replay; the tokens are
        a copy of :attr:`out`."""
        self.cache["pos"] = 0
        logits, _ = forward_cached(params, prompt, self.cache, self.cfg,
                                   prefill_impl=self.prefill_impl)
        self.out[:, 0].copy_(logits[:, -1].argmax(dim=-1))
        self.replay()
        return self.out.clone()


def make_decoder(cfg: BurnInConfig, n_new: int = 32,
                 max_len: int | None = None, cache_dtype: str = "bf16", *,
                 device="cuda"):
    """Compiled greedy decoder, the counterpart of the reference's
    ``jax.jit`` over :func:`greedy_decode`: ``decoder(params, prompt) →
    [B, n_new]`` int64, token for token ``greedy_decode(params, prompt,
    n_new, cfg, max_len=max_len, cache_dtype=cache_dtype)``.

    On a CUDA ``device`` one call is the eager prefill (K1 on a flash
    prompt) and ONE replay of a CUDA graph of the ``n_new - 1`` decode
    steps (:class:`_DecodeGraph`). As ``jax.jit`` keys its cache on static
    shapes, the decoder keeps one graph per (batch, prompt length,
    ``max_len``), captured at that shape's first call; it is captured over
    one params tree and recaptured when a call passes a tree at other
    addresses (a new tree, a ``quantize_params`` tree), so a graph never
    replays stale weights. Weights are passed by argument, never closed
    over. ``n_new == 1`` has no steps and captures nothing. A capture that
    fails raises: nothing falls back to the eager loop. On the CPU (the
    caller's ``device="cpu"``) a call is :func:`greedy_decode`'s eager
    loop."""
    dev = check_device(device)
    check_cache_dtype(cache_dtype)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    graphs: dict[tuple[int, int, int], _DecodeGraph] = {}

    def decoder(params, prompt):
        if dev.type != "cuda" or n_new == 1:
            return greedy_decode(params, prompt, n_new, cfg, max_len=max_len,
                                 cache_dtype=cache_dtype, device=dev)
        _check_params(params, dev)
        prompt = torch.as_tensor(prompt, device=dev).long()
        b, t = prompt.shape
        shape = (b, t, _decode_len(t, n_new, max_len))
        graph = graphs.get(shape)
        if graph is not None and graph.key != _params_key(params):
            # another tree: its last replay may still be running, and its
            # cache and pool return to the allocator when it goes
            graph.stream.synchronize()
            del graphs[shape], graph
            graph = None
        if graph is None:
            graph = graphs[shape] = _DecodeGraph(params, cfg, *shape, n_new,
                                                 cache_dtype, dev)
        return graph(params, prompt)

    decoder.graphs = graphs
    return decoder


def sample_decode(params, prompt, n_new: int, cfg: BurnInConfig, rng,
                  max_len: int | None = None, temperature: float = 1.0,
                  top_k: int | None = None, top_p: float | None = None,
                  prefill: str = "auto", cache_dtype: str = "bf16", *,
                  device="cuda"):
    """Temperature / top-k / nucleus sampling over the cached loop
    (:func:`make_sampler`'s filters). ``rng`` is an int seed or ``[2]`` key
    data (``ops/sampling.key_data``); one key per generated token, split
    from it, so the same ``rng`` gives the reference's tokens."""
    dev = check_device(device)
    pick = make_sampler(temperature=temperature, top_k=top_k, top_p=top_p)
    return _generate(params, prompt, n_new, cfg, max_len,
                     (key_data(rng, dev), pick), prefill, cache_dtype, dev)
