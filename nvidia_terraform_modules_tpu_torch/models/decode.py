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

Sharding (``rules`` over a ``torch.distributed`` world, one process a
device), on every entry point — :func:`init_cache`, :func:`forward_cached`,
:func:`greedy_decode`, :func:`sample_decode`, :func:`make_decoder`,
:func:`forward_paged`, ``paging.init_paged_cache`` and the speculative and
int8-weight decoders — with ``rules`` at the reference's name and
position. ``params`` are this rank's shards (``burnin.init_params(
rules=)``) and a prompt batch is this rank's rows over the data axes
(``burnin.shard_batch``); the tokens that come back are those rows'. The
heads split over ``tp`` Megatron-style — ``wq``/``wk``/``wv``/``up`` by
columns, ``wo``/``down`` by rows followed by an all-reduce, the tied
``embed`` on ``d_model`` (the lookup all-gathered, the head's partial
logits all-reduced) — as the reference's ``_transformer_body`` constrains
its activations for GSPMD (``decode.py:280-299``). Each rank's cache holds
its KV heads, ``kv_heads / tp``; where ``tp`` does not divide
``kv_heads`` the cache holds them all, ``wk``/``wv`` are gathered whole
(once a call by :func:`paged_params` in every decoder and the engine; a
direct :func:`forward_cached` call gathers them itself), and a rank's query
heads attend from a zero-padded full set, its own sliced back out. ``sp``
is a replicated axis here (the reference's decode specs never name it):
each ``sp`` member decodes the same rows. MoE layers route through
:func:`_moe_ffn`: experts over ``ep``, their ``d_ff`` over ``tp``. The
reference's ``int8_kernel`` flag turns its T=1 int8 kernel off under
``rules`` (a ``pallas_call`` cannot take a mesh-sharded operand); here
each rank's cache is a plain local tensor, so the guard has no
counterpart: :func:`forward_cached` takes the keyword for the reference's
signature and K6 stays on either way — a difference of mechanism, not of
result.

On a one-process mesh (``[cuda:0] * n``, ``[cpu] * n``) the same entry
points run the lock-step layers that the train step runs
(``burnin.lockstep_model``, ``parallel.sharding.Lockstep``): ``params``
and the prompt batch are global, :func:`paged_params` gives a
:class:`LockstepParams` tree whose ``members`` are each position's
contiguous pieces on its device (int8 ``QTensor`` pieces cut from the
whole tree's quantisation, as the world's shards are), and the cache or
pool holds each layer's buffers as a :class:`HeadSplit`: a replica for
each data coordinate (as each data rank holds its own pool), and in it
each ``tp`` member's KV heads, contiguous on its device, so K6, K7 and K8
launch per member on the member's heads and columns. The rows split in
order over the data coordinates (an engine's admissions and the
speculative decoders' batch of one, the same on every data rank of a
world, run once, on coordinate 0); each coordinate's members run its rows
in turn and write their fresh K/V rows into every replica, so the
replicas stay equal. The row-parallel partial products and the head's
partial logits are summed in member order on the coordinate's home, the
lookup joined; ``sp`` replicates. MoE runs each ``ep`` position's
experts' ``d_ff / tp`` columns over every coordinate's rows at drop-free
capacity (:func:`..moe.lockstep_moe`).

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
import threading
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
from ..parallel.collectives import exit_parallel, gather_dim, member_cat
from ..parallel.mesh import WorldMesh
from ..parallel.sharding import Lockstep, gather_shards
from ..utils.layers import rmsnorm as _rmsnorm
from .burnin import (
    BurnInConfig,
    _check_params,
    _lockstep,
    apply_rope,
    check_device,
    lockstep_model,
    member_kv_heads,
    mlp,
    position_trees,
    tree_leaves,
)
from .moe import check_rules as _check_moe_rules
from .moe import drop_free_capacity, lockstep_moe, routed_ffn


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


class HeadSplit:
    """One layer's K or V buffer, or int8 scale sidecar, of a cache or a
    paged pool on a one-process mesh. It holds a replica for each data
    coordinate (:attr:`replicas`, as each data rank of a world holds its
    own pool), and each replica holds the ``tp`` members' pieces, each
    member's KV heads contiguous on the position's device (or every head
    on each, ``whole_heads``, where ``tp`` does not divide them). The
    lock-step forwards read position ``(c, j)``'s own piece
    (:meth:`member`) and write member ``j``'s fresh rows into every
    replica (:meth:`write`), so the replicas stay equal. To the host-side
    code (zeroing, a block's copy, block export and import) it is the
    whole buffer, every KV head along :attr:`axis` in member order: reads
    take replica 0 and writes go to every replica."""

    def __init__(self, replicas, axis: int = 2, whole_heads: bool = False):
        self.replicas = [list(r) for r in replicas]
        self.axis, self.whole_heads = axis, whole_heads

    @property
    def members(self) -> list:
        """Replica 0's member pieces."""
        return self.replicas[0]

    def member(self, c: int, j: int) -> torch.Tensor:
        """Position ``(c, j)``'s piece: member ``j`` of replica ``c``."""
        return self.replicas[c][j]

    @property
    def device(self) -> torch.device:
        return self.members[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.members[0].dtype

    @property
    def shape(self) -> torch.Size:
        shape = list(self.members[0].shape)
        if not self.whole_heads:
            shape[self.axis] = sum(m.shape[self.axis] for m in self.members)
        return torch.Size(shape)

    def _axis_after(self, idx) -> int:
        if isinstance(idx, int):
            return self.axis - 1
        if isinstance(idx, slice):
            return self.axis
        raise TypeError(f"HeadSplit takes an int or a slice on its first "
                        f"axis, got {idx!r}")

    def _pieces(self, x, axis: int) -> list:
        """The members' parts of ``x``, whole along ``axis``."""
        if self.whole_heads:
            return [x] * len(self.members)
        return list(x.split([m.shape[axis] for m in self.members], dim=axis))

    def write(self, j: int, idx: tuple, value: torch.Tensor) -> None:
        """``value`` (member ``j``'s heads) into member ``j`` of every
        replica at ``idx``."""
        for rep in self.replicas:
            m = rep[j]
            at = tuple(i.to(m.device) if isinstance(i, torch.Tensor) else i
                       for i in idx)
            m[at] = value.to(m.device)

    def __getitem__(self, idx) -> "HeadSplit":
        return HeadSplit([[m[idx] for m in rep] for rep in self.replicas],
                         self._axis_after(idx), self.whole_heads)

    def __setitem__(self, idx, value) -> None:
        for r, rep in enumerate(self.replicas):
            parts = (value.replicas[r] if isinstance(value, HeadSplit)
                     else self._pieces(value, self._axis_after(idx)))
            for m, part in zip(rep, parts):
                m[idx] = part.to(m.device)

    def zero_(self) -> "HeadSplit":
        for rep in self.replicas:
            for m in rep:
                m.zero_()
        return self

    def whole(self) -> torch.Tensor:
        """Every head in one tensor on the first member's device."""
        if self.whole_heads:
            return self.members[0]
        return member_cat(self.members, self.axis, self.device)

    def index_select(self, dim: int, ids: torch.Tensor) -> torch.Tensor:
        return HeadSplit([[m.index_select(dim, ids.to(m.device))
                           for m in self.members]], self.axis,
                         self.whole_heads).whole()

    def index_copy_(self, dim: int, ids: torch.Tensor,
                    src: torch.Tensor) -> "HeadSplit":
        parts = self._pieces(src, self.axis)
        for rep in self.replicas:
            for m, part in zip(rep, parts):
                m.index_copy_(dim, ids.to(m.device), part.to(m.device))
        return self


def split_buffers(shape: tuple, dtype, rules, n: int) -> list:
    """``n`` layers' zeroed :class:`HeadSplit` buffers of the whole
    ``shape`` (every KV head on axis 2) for a one-process mesh: a replica
    for each data coordinate, and in it ``kv_heads / tp`` heads for each
    ``tp`` member (all of them where ``tp`` does not divide them), each
    on its position's device."""
    ls = Lockstep(rules)
    kv = shape[2] // ls.tp if shape[2] % ls.tp == 0 else shape[2]
    part = (*shape[:2], kv, *shape[3:])
    return [HeadSplit([[torch.zeros(part, dtype=dtype,
                                    device=ls.device(c, j))
                        for j in range(ls.tp)] for c in range(ls.n_data)],
                      whole_heads=ls.tp > 1 and kv == shape[2])
            for _ in range(n)]


def init_cache(cfg: BurnInConfig, batch: int, max_len: int, rules=None, *,
               cache_dtype: str = "bf16", device="cuda") -> dict[str, Any]:
    """Zeroed KV cache: per layer ``[B, cache_rows(max_len), KV, D]`` k/v
    buffers in ``cfg.dtype``, or int8 with f32 ``k_scale``/``v_scale``
    ``[B, rows, KV]`` sidecars under ``cache_dtype="int8"``; ``pos`` (a
    host int) is the number of valid rows. Under ``rules`` ``batch`` is
    this rank's rows and ``KV`` its heads, :func:`pool_kv_heads`; on a
    one-process mesh ``batch`` is the whole batch and each buffer a
    :class:`HeadSplit` (a replica a data coordinate, each over the ``tp``
    members: every KV head in all, on the mesh's devices; ``device`` is
    not read)."""
    quant = check_cache_dtype(cache_dtype)
    check_serve_rules(rules, cfg)
    shape = (batch, cache_rows(max_len, cache_dtype),
             pool_kv_heads(cfg, rules), cfg.head_dim)
    buf = torch.int8 if quant else cfg.dtype
    if _lockstep(rules):        # each tp member's heads on its device
        check_device(rules.mesh.devices.flat[0])

        def zeros(shape, dtype):
            return split_buffers(shape, dtype, rules, cfg.n_layers)
    else:
        dev = check_device(device)

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=dev)
                    for _ in range(cfg.n_layers)]
    cache: dict[str, Any] = {"k": zeros(shape, buf), "v": zeros(shape, buf),
                             "pos": 0}
    if quant:
        for key in ("k_scale", "v_scale"):
            cache[key] = zeros(shape[:3], torch.float32)
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


def _moe_lines(rules):
    """``((ep_group, n_ep, i_ep), tp_group)`` of this rank on a world mesh
    (``moe.routed_ffn``'s ``serve``); ``None`` off one."""
    if rules is None or not isinstance(rules.mesh, WorldMesh):
        return None
    mesh = rules.mesh
    ep = ("ep",) if "ep" in mesh.axis_names else ()
    return ((mesh.group(ep), mesh.axis_size(ep), mesh.index(ep)),
            mesh.group("tp"))


def _moe_ffn(h, layer, cfg: BurnInConfig, rules=None,
             replicated: bool = False):
    """The routed FFN of the serve path: training's ``moe_layer`` (less its
    aux loss, which serving drops) at drop-free capacity, so routing never
    depends on how many tokens share the batch and cached decode routes as
    a full re-forward does.

    Under ``rules`` the experts shard over ``ep`` and their ``d_ff`` over
    ``tp`` (``moe.routed_ffn``'s serve form): each member of an ``ep``
    line runs its experts on the line's tokens. Where the rows differ
    along the line (``h`` is this rank's rows of a data-sharded batch: a
    decode's, a wave's) they are all-gathered over ``ep`` first and this
    rank's rows kept from the combine; ``replicated`` says that ``h`` is
    already the same on every data rank (an engine's admission or prefill
    chunk), so nothing is gathered. Drop-free capacity keeps each token's
    routing independent of the rows beside it, so either form routes as
    the unsharded model does.

    The dispatch tensor is ``[T, E, C]`` with drop-free C growing with T,
    so a long prompt is routed in chunks of ``_MOE_PREFILL_CHUNK`` along
    the sequence (zero-padded, routed chunk by chunk, sliced back): at
    drop-free capacity each token routes on its own, so chunking changes
    memory, never results. Every shape here follows from ``h``'s: the step
    can be captured."""
    serve = _moe_lines(rules)
    rows = h.shape[0]
    gathered = serve is not None and serve[0][1] > 1 and not replicated
    if gathered:
        (ep, n_ep, _), _ = serve
        h = gather_dim(h, ep, n_ep, 0)
    b, t, d = h.shape
    if t <= _MOE_PREFILL_CHUNK:
        out = routed_ffn(h, layer["moe"], cfg, drop_free_capacity(b * t),
                         serve)[0]
    else:
        n = -(-t // _MOE_PREFILL_CHUNK)
        hp = torch.nn.functional.pad(h, (0, 0, 0,
                                         n * _MOE_PREFILL_CHUNK - t))
        cap = drop_free_capacity(b * _MOE_PREFILL_CHUNK)
        outs = [routed_ffn(chunk, layer["moe"], cfg, cap, serve)[0]
                for chunk in hp.split(_MOE_PREFILL_CHUNK, dim=1)]
        out = torch.cat(outs, dim=1)[:, :t]
    if gathered:
        out = out.narrow(0, serve[0][2] * rows, rows)
    return out


def _lockstep_moe_ffn(hs: list, pieces: dict, cfg: BurnInConfig,
                      ls: Lockstep) -> list:
    """:func:`_moe_ffn` on a one-process mesh: the data coordinates' rows
    ``hs`` through :func:`..moe.lockstep_moe` at drop-free capacity (each
    ``ep`` position's experts over every coordinate's slots, ``tp``
    members over ``d_ff``), a long prompt in chunks of
    ``_MOE_PREFILL_CHUNK`` as there → each coordinate's output."""
    b = sum(h.shape[0] for h in hs)
    t = hs[0].shape[1]
    if t <= _MOE_PREFILL_CHUNK:
        return lockstep_moe(hs, pieces, cfg, ls,
                            capacity=drop_free_capacity(b * t))[0]
    n = -(-t // _MOE_PREFILL_CHUNK)
    chunks = [torch.nn.functional.pad(h, (0, 0, 0, n * _MOE_PREFILL_CHUNK
                                          - t)).split(_MOE_PREFILL_CHUNK,
                                                      dim=1) for h in hs]
    cap = drop_free_capacity(b * _MOE_PREFILL_CHUNK)
    outs = [lockstep_moe([ch[i] for ch in chunks], pieces, cfg, ls,
                         capacity=cap)[0] for i in range(n)]
    return [torch.cat([o[c] for o in outs], dim=1)[:, :t]
            for c in range(len(hs))]


def check_serve_rules(rules, cfg: BurnInConfig) -> None:
    """What the sharded decode path (every decode entry point, the paged
    pool, the serve engine) takes: ``rules`` over a world mesh or a
    one-process mesh whose ``tp`` divides the heads, ``d_model`` and
    ``d_ff`` (and, with experts, whose ``ep`` divides them); ``sp``
    replicates."""
    if rules is None:
        return
    shape = rules.mesh.shape
    if cfg.n_experts > 0:
        _check_moe_rules(rules, cfg)
    tp = shape.get("tp", 1)
    if cfg.n_heads % tp or cfg.d_model % tp or cfg.d_ff % tp:
        raise ValueError(
            f"tp = {tp} must divide n_heads ({cfg.n_heads}), d_model "
            f"({cfg.d_model}) and d_ff ({cfg.d_ff})")


def _tp_line(rules) -> tuple:
    """``(group, n, i)`` of this rank's ``tp`` line (``(None, 1, 0)``
    without a world mesh)."""
    if rules is None or not isinstance(rules.mesh, WorldMesh):
        return None, 1, 0
    mesh = rules.mesh
    return mesh.group("tp"), mesh.axis_size("tp"), mesh.index("tp")


def pool_kv_heads(cfg: BurnInConfig, rules=None) -> int:
    """The KV heads a rank's paged pool holds: ``kv_heads / tp`` where
    ``tp`` divides them, else all of them (the pool replicates the head
    axis, as the reference's ``init_paged_cache`` does). On a one-process
    mesh the pool's whole view (its :class:`HeadSplit` buffers) holds every
    KV head."""
    tp = _tp_line(rules)[1]
    return cfg.kv_heads // tp if cfg.kv_heads % tp == 0 else cfg.kv_heads


def _gather_leaf(leaf, path: tuple, rules):
    """The whole leaf at ``path`` from every rank's shard of it (a tensor,
    or a ``quantize.QTensor``: its values by the leaf's spec, its scales by
    the spec's entry on the scale axis)."""
    spec = rules.param_sharding(path)
    if isinstance(leaf, torch.Tensor):
        return gather_shards(leaf, spec, rules.mesh)
    entry = (tuple(spec) + (None, None))[leaf.scale_axis]
    return type(leaf)(gather_shards(leaf.q, spec, rules.mesh),
                      gather_shards(leaf.scale, (entry,), rules.mesh),
                      scale_axis=leaf.scale_axis, dtype=leaf.dtype,
                      transposed=leaf.transposed)


def _whole_kv(layer, li: int, cfg: BurnInConfig, rules):
    """A layer's ``wk``/``wv`` whole, for a rank whose cache holds every KV
    head: as they are when they are already whole (:func:`paged_params`),
    else gathered from the ``tp`` line's shards."""
    out = []
    for name in ("wk", "wv"):
        w = layer[name]
        if w.shape[-1] != cfg.kv_heads * cfg.head_dim:
            w = _gather_leaf(w, ("layers", str(li), name), rules)
        out.append(w)
    return out


class LockstepParams(dict):
    """The tree the decode path runs over a one-process mesh: the global
    params (the dict itself, what the host-side code reads) and
    :attr:`members`, each lock-step position's pieces of it
    (:func:`_member_trees`)."""

    members: dict


def _member_trees(params, cfg: BurnInConfig, rules) -> dict:
    """Every lock-step position's pieces of the global ``params``,
    contiguous on its device (``burnin.position_trees``; int8 ``QTensor``
    pieces cut from the whole tree's quantisation, as a world's shards
    are), ``wk`` and ``wv`` whole where ``tp`` does not divide
    ``kv_heads``."""
    ls = Lockstep(rules)
    return position_trees(params, rules, ls, contiguous=True,
                          whole_kv=ls.tp > 1 and member_kv_heads(
                              cfg, ls.tp) == cfg.kv_heads)


def paged_params(params, cfg: BurnInConfig, rules=None):
    """The tree the sharded engine runs under ``rules``: ``params`` (this
    rank's shards) as they are, except that where ``tp`` does not divide
    ``kv_heads`` each layer's ``wk``/``wv`` are gathered whole once (the
    cache holds every KV head there; without this tree each step gathers
    them). Collective: every rank of the ``tp`` line calls it. On a
    one-process mesh: a :class:`LockstepParams` over the global
    ``params``, its members' pieces cut once."""
    if _lockstep(rules):
        if isinstance(params, LockstepParams):
            return params
        tree = LockstepParams(params)
        tree.members = _member_trees(params, cfg, rules)
        return tree
    tp = _tp_line(rules)[1]
    if pool_kv_heads(cfg, rules) * tp == cfg.kv_heads:
        return params
    layers = []
    for i, layer in enumerate(params["layers"]):
        wk, wv = _whole_kv(layer, i, cfg, rules)
        layers.append(dict(layer, wk=wk, wv=wv))
    return dict(params, layers=layers)


def _transformer_body(params, tokens, cfg: BurnInConfig, q_pos, store,
                      attend, rules=None, replicated: bool = False):
    """The cached-transformer trunk shared by both storage layouts: per
    layer ``store(li, k, v) → handle`` writes the fresh rows and
    ``attend(li, q, k, v, handle) → [B, T, H, D]`` computes attention;
    projections, rope at ``q_pos``, residuals, the MLP (the routed FFN of
    :func:`_moe_ffn` with ``n_experts > 0``; ``replicated`` as there) and
    the tied unembedding are this one function. With ``rules`` this rank
    runs its heads and FFN columns (module docstring) and returns the full
    logits of its rows; on a one-process mesh :func:`_lockstep_body` steps
    every position (``store`` and ``attend`` then take the position and
    its rows last)."""
    if _lockstep(rules):
        return _lockstep_body(params, tokens, cfg, q_pos, store, attend,
                              rules, replicated)
    b, t = tokens.shape
    group, n_tp, i_tp = _tp_line(rules)
    heads = cfg.n_heads // n_tp
    kv = pool_kv_heads(cfg, rules)
    whole_kv = n_tp > 1 and kv == cfg.kv_heads
    own = slice(i_tp * heads, (i_tp + 1) * heads)
    x = gather_dim(params["embed"][tokens], group, n_tp, -1)
    for li, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["attn_norm"])
        wk, wv = (_whole_kv(layer, li, cfg, rules) if whole_kv
                  else (layer["wk"], layer["wv"]))
        q = (h @ layer["wq"]).view(b, t, heads, cfg.head_dim)
        k = (h @ wk).view(b, t, kv, cfg.head_dim)
        v = (h @ wv).view(b, t, kv, cfg.head_dim)
        if cfg.rope:
            # K rotates before the cache write: cached rows never need
            # re-rotation at later steps
            q = apply_rope(q, q_pos, cfg.rope_theta)
            k = apply_rope(k, q_pos, cfg.rope_theta)
        handle = store(li, k, v)
        if whole_kv:
            # every KV head is here: this rank's query heads among zeros
            full = q.new_zeros((b, t, cfg.n_heads, cfg.head_dim))
            full[:, :, own] = q
            attn = attend(li, full, k, v, handle)[:, :, own]
        else:
            attn = attend(li, q, k, v, handle)
        x = x + exit_parallel(
            attn.reshape(b, t, heads * cfg.head_dim) @ layer["wo"], group)
        h = _rmsnorm(x, layer["mlp_norm"])
        x = x + (_moe_ffn(h, layer, cfg, rules, replicated)
                 if cfg.n_experts > 0
                 else exit_parallel(mlp(h, layer, cfg.dtype), group))
    x = _rmsnorm(x, params["out_norm"])
    if group is not None:          # this rank's d_model columns of the head
        x = x.chunk(n_tp, dim=-1)[i_tp]
    return exit_parallel(x @ params["embed"].T, group)


def _lockstep_body(params, tokens, cfg: BurnInConfig, q_pos, store, attend,
                   rules, replicated: bool):
    """:func:`_transformer_body` over a one-process mesh's positions, the
    train step's :func:`..burnin.lockstep_model` with the cache's attention
    (module docstring). The rows split in order over the data coordinates
    (with ``replicated`` coordinate 0 runs them all, once), each
    coordinate's on its positions' devices from ``params.members``
    (:func:`paged_params`; a plain tree is cut on the spot); member ``j``
    of coordinate ``c`` writes and reads its own cache buffers through
    ``store(li, k, v, c, j, rows)`` and ``attend(li, q, k, v, handle, c,
    j, rows)``. The logits of every row are joined on ``tokens``'
    device."""
    ls = Lockstep(rules)
    trees = (params.members if isinstance(params, LockstepParams)
             else _member_trees(params, cfg, rules))
    n = 1 if replicated else ls.n_data
    b = tokens.shape[0]
    if b % n:
        raise ValueError(f"{b} rows do not split over the data axes "
                         f"{ls.data_axes} ({n} ways)")
    rows = [slice(c * b // n, (c + 1) * b // n) for c in range(n)]
    heads = cfg.n_heads // ls.tp
    whole_kv = ls.tp > 1 and member_kv_heads(cfg, ls.tp) == cfg.kv_heads

    def member_attend(li, q, k, v, c, j):
        handle = store(li, k, v, c, j, rows[c])
        if not whole_kv:
            return attend(li, q, k, v, handle, c, j, rows[c])
        # every KV head is here: this member's query heads among zeros
        own = slice(j * heads, (j + 1) * heads)
        full = q.new_zeros((*q.shape[:2], cfg.n_heads, cfg.head_dim))
        full[:, :, own] = q
        return attend(li, full, k, v, handle, c, j, rows[c])[:, :, own]

    def moe(hs, pieces):
        return _lockstep_moe_ffn(hs, pieces, cfg, ls), None

    toks = [tokens[r].to(ls.home(c)) for c, r in enumerate(rows)]
    pos = [q_pos[r] if q_pos.dim() > 1 else q_pos for r in rows]
    logits, _ = lockstep_model(trees, toks, cfg, ls, member_attend, pos,
                               moe=moe)
    return member_cat(logits, 0, tokens.device)


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


def forward_cached(params, tokens, cache, cfg: BurnInConfig, rules=None, *,
                   prefill_impl: str = "dense", int8_kernel: bool = True):
    """Forward ``tokens`` ``[B, T]`` starting at ``cache["pos"]``: writes
    the new K/V rows into the cache (in place) and returns ``(logits
    [B, T, vocab], cache)``. ``prefill_impl="flash"`` is valid only at
    ``pos == 0`` (``greedy_decode`` selects it exactly there).
    ``int8_kernel`` is the reference's keyword and changes nothing here:
    it guards a ``pallas_call`` on mesh-sharded operands, which has no
    counterpart (module docstring); the T=1 int8-cache step runs K6 on
    the card either way. ``rules``: ``params`` are this rank's shards,
    ``tokens`` its rows and the cache ``init_cache(..., rules)``'s (module
    docstring)."""
    del int8_kernel
    return _forward_cached(params, tokens, cache, cfg, rules, prefill_impl)


@torch.no_grad()
def _forward_cached(params, tokens, cache, cfg: BurnInConfig, rules,
                    prefill_impl: str = "dense", replicated: bool = False):
    """:func:`forward_cached`, with ``replicated`` (:func:`_moe_ffn`'s):
    ``tokens`` are the same on every data rank, as the speculative
    decoder's batch of one is."""
    check_serve_rules(rules, cfg)
    b, t = tokens.shape
    pos0 = cache["pos"]
    s_max = cache["k"][0].shape[1]
    if pos0 + t > s_max:
        raise ValueError(f"pos ({pos0}) + T ({t}) exceeds the cache's "
                         f"{s_max} rows")
    q_pos = torch.arange(pos0, pos0 + t, device=tokens.device)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    quant = "k_scale" in cache

    def buf(key, li, c, j, rows):
        """Layer ``li``'s buffer (a one-process mesh: position ``(c, j)``'s
        piece, its ``rows``)."""
        out = cache[key][li]
        return out if j is None else out.member(c, j)[rows]

    def put(key, li, j, rows, x):
        at = (rows, slice(pos0, pos0 + t))
        if j is None:
            cache[key][li][at] = x
        else:           # member j's rows, in every replica
            cache[key][li].write(j, at, x)

    def store(li, k, v, c=None, j=None, rows=slice(None)):
        if quant:
            # the cache never holds the full-precision rows
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            put("k_scale", li, j, rows, k_s)
            put("v_scale", li, j, rows, v_s)
        put("k", li, j, rows, k)
        put("v", li, j, rows, v)

    def attend(li, q, k, v, handle, c=None, j=None, rows=slice(None)):
        at = q_pos.to(q.device)
        attn = _prompt_attention(q, k, v, at, scale, prefill_impl, quant)
        if attn is not None:
            return attn
        return _cached_attention(
            q, buf("k", li, c, j, rows), buf("v", li, c, j, rows), at, scale,
            buf("k_scale", li, c, j, rows) if quant else None,
            buf("v_scale", li, c, j, rows) if quant else None)

    logits = _transformer_body(params, tokens, cfg, q_pos, store, attend,
                               rules, replicated)
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
def forward_paged(params, tokens, cache, cfg: BurnInConfig, rules=None, *,
                  prefill_impl: str = "cached", active=None,
                  paged_kernel: str = "auto", replicated: bool = False):
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
    active row's ``pos + T`` stays within its allocated rows. ``rules``
    (a world mesh): ``params`` are this rank's shards (best
    :func:`paged_params` of them) and the pool is ``init_paged_cache(...,
    rules=)``'s: this rank runs its heads (module docstring); the logits
    are whole. ``tokens`` are this rank's rows of a batch split over the
    data axes, or, with ``replicated``, the same on every rank (the
    engine's admissions: :func:`_moe_ffn` then gathers nothing)."""
    check_serve_rules(rules, cfg)
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

    def buf(key, li, c, j):
        """Layer ``li``'s buffer (a one-process mesh: position ``(c, j)``'s
        piece)."""
        out = cache[key][li]
        return out if j is None else out.member(c, j)

    def own(x, rows, d):
        """``rows`` of a per-row tensor on ``d`` (a copy for a part of
        them: a kernel's operands start aligned)."""
        part = x[rows]
        return part.to(d) if part.shape[0] == x.shape[0] else \
            part.to(d, copy=True)

    def put(key, li, j, at, x):
        if j is None:
            cache[key][li][at] = x
        else:           # member j's rows, in every replica
            cache[key][li].write(j, at, x)

    def store(li, k, v, c=None, j=None, rows=slice(None)):
        at = (own(pb, rows, k.device), own(pr, rows, k.device))
        if quant:
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            put("k_scale", li, j, at, k_s)
            put("v_scale", li, j, at, v_s)
        put("k", li, j, at, k)
        put("v", li, j, at, v)

    def attend(li, q, k, v, handle, c=None, j=None, rows=slice(None)):
        d = q.device
        at, tab = own(q_pos, rows, d), own(tables, rows, d)
        attn = _prompt_attention(q, k, v, at, scale, prefill_impl, quant)
        if attn is not None:
            return attn
        ks = buf("k_scale", li, c, j) if quant else None
        vs = buf("v_scale", li, c, j) if quant else None
        if kernel_on:
            # through the tables, after this step's store: a frozen row
            # reads what the gather path would (same tables, same pos)
            return paged_decode_attention(
                q[:, 0], buf("k", li, c, j), buf("v", li, c, j), tab,
                own(pos0, rows, d), scale=scale, k_scale=ks,
                v_scale=vs)[:, None]
        n = nt * bs
        if quant:
            ks = _gather_logical(ks, tab, n)
            vs = _gather_logical(vs, tab, n)
        return _cached_attention(
            q, _gather_logical(buf("k", li, c, j), tab, n),
            _gather_logical(buf("v", li, c, j), tab, n), at, scale, ks, vs)

    logits = _transformer_body(params, tokens, cfg, q_pos, store, attend,
                               rules, replicated)
    # in place: a captured CUDA graph of this step, and the engine's
    # admissions, keep addressing the pool's own pos tensor
    pos0.copy_(torch.where(active, pos0 + t, pos0))
    return logits, cache


# one graph capture at a time in a process (see _Replayed)
_CAPTURE_LOCK = threading.Lock()


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

    Captures in one process take turns (``_CAPTURE_LOCK``: a fleet's
    in-process replicas are threads that each capture their waves), and
    each is ``thread_local``: another thread's launches, allocations and
    readbacks on its own stream go on while a capture runs, where the
    default global mode would fail them or break the capture.

    A replay calls no kernel wrapper, so the wrappers' launch counts
    (``ops._build.launches``) would miss it: the capture's calls go to a
    tally of their own (``_build.capture_tally``, this thread's only) —
    the kernels the graph holds — kept as :attr:`launches` and counted
    again at each replay."""

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
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with _build.capture_tally() as held, torch.cuda.graph(
                        self.graph, stream=self.stream,
                        capture_error_mode="thread_local"):
                    fn()
            finally:
                if collecting:
                    gc.enable()
        self.launches = {name: n for name, n in held.items() if n}

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
            _build.count(name, n)


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

    def __call__(self, logits, key, row0: int = 0):
        """One ``[2]`` key for the whole ``[B, V]`` batch, as
        ``jax.random.categorical(key, logits)``: row ``b`` counts its
        elements from ``(row0 + b)·V`` — ``row0`` the first row's place in
        the whole batch, when ``logits`` are a data rank's rows of it."""
        logits = self.filter(logits)
        if self.top_k == 1:
            return logits.argmax(dim=-1)              # no tie-break draw
        b, v = logits.shape
        offsets = (torch.arange(b, dtype=torch.int64, device=logits.device)
                   + row0) * v
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


def _data_line(rules) -> tuple:
    """``(group, n, i)`` of this rank's line over the data axes
    (``(None, 1, 0)`` without a world mesh): a batch's rows split into
    ``n`` pieces in line order, this rank holding piece ``i``."""
    if rules is None or not isinstance(rules.mesh, WorldMesh):
        return None, 1, 0
    mesh = rules.mesh
    return (mesh.group(rules.data), mesh.axis_size(rules.data),
            mesh.index(rules.data))


@torch.no_grad()
def _generate(params, prompt, n_new: int, cfg: BurnInConfig, rules, max_len,
              pick_next, prefill: str, cache_dtype: str, dev):
    """Shared prefill + decode loop; ``pick_next`` is None (greedy) or
    ``(key, pick)``, token ``i`` drawn with ``split(key, n_new)[i]`` (rows
    keyed at their place in the whole batch under ``rules``)."""
    _check_params(params, dev)
    params = paged_params(params, cfg, rules)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, t = prompt.shape
    max_len = _decode_len(t, n_new, max_len)
    cache = init_cache(cfg, b, max_len, rules, cache_dtype=cache_dtype,
                       device=dev)
    logits, cache = forward_cached(
        params, prompt, cache, cfg, rules,
        prefill_impl=_select_prefill_impl(cfg, t, prefill, dev))
    if pick_next is None:
        def pick(lg, i):
            return lg.argmax(dim=-1)
    else:
        keys = split(pick_next[0], n_new)             # one per token
        row0 = _data_line(rules)[2] * b         # place in the whole batch

        def pick(lg, i):
            return pick_next[1](lg, keys[i], row0)
    tok = pick(logits[:, -1], 0)
    toks = [tok]
    for i in range(1, n_new):
        logits, cache = forward_cached(params, tok[:, None], cache, cfg,
                                       rules)
        tok = pick(logits[:, -1], i)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def greedy_decode(params, prompt, n_new: int, cfg: BurnInConfig, rules=None,
                  max_len: int | None = None, prefill: str = "auto",
                  cache_dtype: str = "bf16", *, device="cuda"):
    """Greedy generation: prefill ``prompt`` ``[B, T]``, then ``n_new - 1``
    cached steps over a ``cache_dtype`` cache. ``params`` may hold int8
    ``QTensor`` weights (``models/quantize.py``). Returns the ``[B,
    n_new]`` generated tokens (int64, on ``device``). ``rules``: this
    rank's shards and rows (module docstring)."""
    return _generate(params, prompt, n_new, cfg, rules, max_len, None,
                     prefill, cache_dtype, check_device(device))


def _copy_leaf(dst, src) -> None:
    """``src``'s values into ``dst`` in place (tensors, or ``QTensor``
    values and scales)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        dst.q.copy_(src.q)
        dst.scale.copy_(src.scale)


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
    (:attr:`key`, :func:`_params_key`) and holds no reference to it
    beyond the whole ``wk``/``wv`` it owns (below).

    Cache rows above the prompt keep the previous call's decode rows; no
    read reaches them before the step that rewrites them (the masked
    softmax gives them probability 0, K6 reads the live rows only).

    Where the cache holds every KV head (``tp`` does not divide them) the
    steps read whole ``wk``/``wv`` that the graph owns (:attr:`kv`): each
    call gathers them from the tree's shards once, eagerly, and copies
    them in before the replay, so the graph holds no gather. Off the card
    nothing is captured and :meth:`replay` runs the steps over the call's
    tree."""

    def __init__(self, params, cfg: BurnInConfig, rules, batch: int, t: int,
                 max_len: int, n_new: int, cache_dtype: str, dev):
        self.key = _params_key(params)
        self.cfg, self.rules = cfg, rules
        self.prefill_impl = _select_prefill_impl(cfg, t, "auto", dev)
        self.cache = cache = init_cache(cfg, batch, max_len, rules,
                                        cache_dtype=cache_dtype, device=dev)
        self.out = out = torch.zeros((batch, n_new), dtype=torch.long,
                                     device=dev)
        whole = paged_params(params, cfg, rules)
        # a one-process mesh: the members' pieces the graph reads, kept
        # here and refreshed from each call's tree
        self.lockstep = whole if isinstance(whole, LockstepParams) else None
        self.kv = None if whole is params or self.lockstep is not None \
            else [(layer["wk"], layer["wv"]) for layer in whole["layers"]]
        # the tree the steps read: the capture's only reference, and each
        # uncaptured replay's
        self.weights = weights = [whole]

        @torch.no_grad()
        def steps():
            cache["pos"] = t
            for i in range(1, n_new):
                logits, _ = forward_cached(weights[0], out[:, i - 1:i], cache,
                                           cfg, rules)
                out[:, i].copy_(logits[:, -1].argmax(dim=-1))

        super().__init__(steps, dev, capture=dev.type == "cuda")
        weights.clear()

    @torch.no_grad()
    def __call__(self, params, prompt):
        """The eager prefill of ``prompt``, then one replay; the tokens are
        a copy of :attr:`out`."""
        if self.lockstep is not None:
            fresh = _member_trees(params, self.cfg, self.rules)
            for key, tree in self.lockstep.members.items():
                for dst, src in zip(tree_leaves(tree),
                                    tree_leaves(fresh[key])):
                    _copy_leaf(dst, src)
            params = self.lockstep
        if self.kv is not None:
            fresh = paged_params(params, self.cfg, self.rules)["layers"]
            for (wk, wv), layer in zip(self.kv, fresh):
                _copy_leaf(wk, layer["wk"])
                _copy_leaf(wv, layer["wv"])
            params = dict(params, layers=[
                dict(layer, wk=wk, wv=wv)
                for layer, (wk, wv) in zip(params["layers"], self.kv)])
        self.cache["pos"] = 0
        logits, _ = forward_cached(params, prompt, self.cache, self.cfg,
                                   self.rules,
                                   prefill_impl=self.prefill_impl)
        self.out[:, 0].copy_(logits[:, -1].argmax(dim=-1))
        self.weights.append(params)
        try:
            self.replay()
        finally:
            self.weights.clear()
        return self.out.clone()


def make_decoder(cfg: BurnInConfig, rules=None, n_new: int = 32,
                 max_len: int | None = None, cache_dtype: str = "bf16", *,
                 device="cuda"):
    """Compiled greedy decoder, the counterpart of the reference's
    ``jax.jit`` over :func:`greedy_decode`: ``decoder(params, prompt) →
    [B, n_new]`` int64, token for token ``greedy_decode(params, prompt,
    n_new, cfg, rules, max_len=max_len, cache_dtype=cache_dtype)``.

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
    loop. Under ``rules`` the graph holds this rank's steps, collectives
    included (a world of one launches none)."""
    dev = check_device(device)
    check_cache_dtype(cache_dtype)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    graphs: dict[tuple[int, int, int], _DecodeGraph] = {}

    def decoder(params, prompt):
        if dev.type != "cuda" or n_new == 1:
            return greedy_decode(params, prompt, n_new, cfg, rules,
                                 max_len=max_len, cache_dtype=cache_dtype,
                                 device=dev)
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
            graph = graphs[shape] = _DecodeGraph(params, cfg, rules, *shape,
                                                 n_new, cache_dtype, dev)
        return graph(params, prompt)

    decoder.graphs = graphs
    return decoder


def sample_decode(params, prompt, n_new: int, cfg: BurnInConfig, rng,
                  rules=None, max_len: int | None = None,
                  temperature: float = 1.0, top_k: int | None = None,
                  top_p: float | None = None, prefill: str = "auto",
                  cache_dtype: str = "bf16", *, device="cuda"):
    """Temperature / top-k / nucleus sampling over the cached loop
    (:func:`make_sampler`'s filters). ``rng`` is an int seed or ``[2]`` key
    data (``ops/sampling.key_data``); one key per generated token, split
    from it, so the same ``rng`` gives the reference's tokens — under
    ``rules`` too, each row drawn at its place in the whole batch."""
    dev = check_device(device)
    pick = make_sampler(temperature=temperature, top_k=top_k, top_p=top_p)
    return _generate(params, prompt, n_new, cfg, rules, max_len,
                     (key_data(rng, dev), pick), prefill, cache_dtype, dev)
