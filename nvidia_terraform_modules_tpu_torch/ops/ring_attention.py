# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Ring attention: exact attention with the sequence sharded over the ``sp``
mesh axis — the port of the reference's ``ops/ring_attention.py``.

Each member of the ring keeps its sequence shard of Q; K/V blocks rotate
neighbour to neighbour (:func:`..parallel.collectives.ring_permute`), so
at ring step ``t`` member ``me`` holds the block first owned by
``(me - t) % n``, and every member folds each visiting block into an
online-softmax state. On a one-process mesh the program steps all members
in lock step, each on its mesh device; on a mesh that names one device
``n`` times the hops move nothing. On a ``WorldMesh`` each rank is one
member and a block moves by the world's directed hop
(:func:`..parallel.collectives.hop`, inside autograd for the dense ring).

Two per-block tile maths, as in the reference:

- ``impl="dense"`` (:func:`ring_attention_kernel`): blockwise PyTorch,
  autograd through it — the numerics reference;
- ``impl="flash"`` (:func:`ring_flash_attention_kernel`, the autograd
  Function :class:`RingFlash`): per visiting block one K2 sweep
  (:func:`.flash_attention.flash_partial`, unnormalised state) folded
  exactly. Causality needs no global positions: a visiting block is
  diagonal (src == me: K2 with its local causal mask), fully visible
  (src < me: K2 with none) or fully masked (src > me: skipped, no launch).
  The backward rotates the K/V blocks with their dK/dV accumulators (one
  extra hop brings each home), recomputes P from the saved global LSE,
  and runs K5 (or K3 + K4) per visited block with f32 outputs, summed
  across ring steps in f32 and cast once.

The reference's TPU tile levers (``block_q``, ``block_k``, ``pipeline``)
are not carried: the CUDA kernels have one 64x64 tiling.
"""

from __future__ import annotations

import functools

import torch

from ..parallel.collectives import hop as world_hop
from ..parallel.collectives import ring_map, ring_permute, spec_axes
from ..parallel.mesh import WorldMesh
from .flash_attention import (
    NEG_INF,
    MaskSpec,
    _check_backward,
    flash_dkv,
    flash_dq,
    flash_dqdkv,
    flash_partial,
    pick_impl,
)


def _block_scores(q, k, scale, mask):
    """Masked scores ``[B, H, Q, K]`` of one (q shard × kv block) tile: f32
    products of the input-dtype operands, the scale on the f32 scores;
    ``mask`` ``[Q, K]`` keeps True entries."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def dense_reference_attention(q, k, v, *, causal: bool = True,
                              scale: float | None = None,
                              window: int | None = None,
                              q_offset: int = 0):
    """Unsharded O(S²) softmax attention on ``[B, S, H, D]``: f32 scores,
    softmax, probabilities cast to ``v.dtype`` for the PV product with f32
    accumulation, the output in q's dtype. ``window`` keeps only keys with
    ``q - k < window`` (causal only). ``q_offset``: the queries are rows
    ``q_offset ...`` of the keys' sequence (a sequence shard's queries
    against the whole sequence's keys)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if window is not None and not causal:
        raise ValueError("window masking implies causal attention")
    mask = None
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
    p = torch.softmax(_block_scores(q, k, scale, mask), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _t(x):
    """``[B, H, S]`` → ``[B, S, H, 1]``, to scale ``[B, S, H, D]`` rows."""
    return x.transpose(1, 2)[..., None]


def _members(q, n, members):
    """The ring's size and the member index of each list position: every
    member (one process stepping the whole ring) unless ``members`` names
    the ones held here (a world rank holds its own)."""
    if n is None:
        n = len(q)
    members = tuple(range(n)) if members is None else tuple(members)
    if len(members) != len(q):
        raise ValueError(f"{len(q)} shards for members {members}")
    return n, members


def ring_attention_kernel(q, k, v, *, hop, causal: bool = True,
                          scale: float | None = None, n: int | None = None,
                          members=None):
    """The dense ring over one group: ``q``, ``k``, ``v`` are lists of the
    shards ``[B, S_local, H, D]`` of the ring members held here (member
    order; by default all ``n = len(q)`` of them; on a world mesh one
    rank's, ``members=(i,)`` of ``n``), ``hop`` the group's hop of such a
    list. Causal masking in GLOBAL positions. Returns those members'
    outputs in q's dtype; differentiable by autograd (through the hop
    too)."""
    n, members = _members(q, n, members)
    b, s_loc, h, d = q[0].shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dev = [x.device for x in q]
    ar = [torch.arange(s_loc, device=x) for x in dev]
    m = [torch.full((b, h, s_loc), NEG_INF, device=x) for x in dev]
    l_ = [torch.zeros((b, h, s_loc), device=x) for x in dev]
    o = [torch.zeros((b, s_loc, h, d), device=x) for x in dev]
    k_blk, v_blk = list(k), list(v)
    for t in range(n):
        for j, me in enumerate(members):
            src = (me - t) % n
            mask = None
            if causal:
                mask = (me * s_loc + ar[j])[:, None] >= (
                    src * s_loc + ar[j])[None, :]
            s = _block_scores(q[j], k_blk[j], scale, mask)
            m_new = torch.maximum(m[j], s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
            pv = torch.einsum("bhqk,bkhd->bqhd",
                              p.to(v_blk[j].dtype).float(),
                              v_blk[j].float())
            corr = torch.exp(m[j] - m_new)
            l_[j] = l_[j] * corr + p.sum(dim=-1)
            o[j] = o[j] * _t(corr) + pv
            m[j] = m_new
        if t < n - 1:   # the final block is folded without a wasted hop
            k_blk, v_blk = hop(k_blk), hop(v_blk)
    return [(o[j] / _t(l_[j].clamp_min(1e-30))).to(q[j].dtype)
            for j in range(len(members))]


def _branch_index(src: int, me: int) -> int:
    """0 = diagonal (own block, local causal mask), 1 = fully visible,
    2 = fully masked (skipped: zero contribution, zero FLOPs)."""
    return 0 if src == me else (1 if src < me else 2)


def _visits(n: int, t: int, causal: bool):
    """``(me, causal mask?)`` for each member that folds a block at ring
    step ``t``."""
    for me in range(n):
        branch = _branch_index((me - t) % n, me) if causal else 1
        if branch != 2:
            yield me, branch == 0


def _held_visits(n: int, t: int, causal: bool, members):
    """``(list position, diagonal?)`` of each member held here that folds
    a block at ring step ``t`` (a member skipping a fully masked block
    still passes it on along the ring)."""
    where = {me: j for j, me in enumerate(members)}
    for me, diag in _visits(n, t, causal):
        if me in where:
            yield where[me], diag


def _fold_start(q):
    """The empty online-softmax state of ``q``'s rows: (acc, m, l)."""
    b, s_loc, h, d = q.shape
    return (torch.zeros((b, s_loc, h, d), device=q.device),
            torch.full((b, h, s_loc), NEG_INF, device=q.device),
            torch.zeros((b, h, s_loc), device=q.device))


def _fold(state, part):
    """One K2 sweep ``part`` (acc, m, l) folded exactly into ``state``."""
    (o, m, l_), (o_b, m_b, l_b) = state, part
    m_new = torch.maximum(m, m_b)
    c, c_b = torch.exp(m - m_new), torch.exp(m_b - m_new)
    return o * _t(c) + o_b * _t(c_b), m_new, l_ * c + l_b * c_b


def _finish(state, dtype):
    """The output (``dtype``) and global LSE ``[B, H, S]`` of a folded
    state."""
    o, m, l_ = state
    lm = l_.clamp_min(1e-30)
    return (o / _t(lm)).to(dtype), m + torch.log(lm)


def _block_grads(args, scale: float, diag: bool, backward: str, *,
                 mask=None, q_offset: int = 0):
    """One visited block's (dQ, dK, dV) with f32 outputs: K5, or K3 + K4
    (``args`` = q, k, v, dO, LSE, delta); causal when ``diag``, else
    unmasked, unless ``mask`` (a window) at ``q_offset`` says otherwise."""
    kw = dict(scale=scale, causal=diag, mask=mask, q_offset=q_offset,
              out_dtype=torch.float32)
    if backward == "fused":
        return flash_dqdkv(*args, **kw)
    return (flash_dq(*args, **kw), *flash_dkv(*args, **kw))


def _delta(do, out):
    """``rowsum(dO·O)`` in f32, ``[B, H, S]``."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _ring_flash_fwd(q, k, v, hop, causal: bool, scale: float,
                    n: int | None = None, members=None):
    """The forward ring sweep: per visiting block one K2 call, folded
    exactly. Returns the held members' outputs (q's dtype) and global
    LSEs ``[B, H, S_local]``."""
    n, members = _members(q, n, members)
    state = [_fold_start(x) for x in q]
    k_blk, v_blk = list(k), list(v)
    for t in range(n):
        for me, diag in _held_visits(n, t, causal, members):
            state[me] = _fold(state[me], flash_partial(
                q[me], k_blk[me], v_blk[me], scale=scale, causal=diag))
        if t < n - 1:
            k_blk, v_blk = hop(k_blk), hop(v_blk)
    out, lse = zip(*(_finish(st, x.dtype) for st, x in zip(state, q)))
    return list(out), list(lse)


def _ring_flash_bwd(q, k, v, out, lse, do, hop, causal: bool, scale: float,
                    backward: str, n: int | None = None, members=None):
    """The backward ring sweep: the K/V blocks make the forward's rotation
    and their f32 dK/dV accumulators travel with them; one final hop
    brings each block's gradient home. Per visited block K5 (or K3 + K4)
    with f32 outputs; P from the saved global LSE;
    ``delta = rowsum(dO·O)`` in f32. Returns (dq, dk, dv) lists in the
    inputs' dtypes."""
    n, members = _members(q, n, members)
    f32 = torch.float32
    delta = [_delta(g, o) for g, o in zip(do, out)]
    dq = [torch.zeros(x.shape, dtype=f32, device=x.device) for x in q]
    dk_blk = [torch.zeros(x.shape, dtype=f32, device=x.device) for x in k]
    dv_blk = [torch.zeros(x.shape, dtype=f32, device=x.device) for x in v]
    k_blk, v_blk = list(k), list(v)
    for t in range(n):
        for me, diag in _held_visits(n, t, causal, members):
            dq_t, dk_t, dv_t = _block_grads(
                (q[me], k_blk[me], v_blk[me], do[me], lse[me], delta[me]),
                scale, diag, backward)
            dq[me] += dq_t
            dk_blk[me] += dk_t
            dv_blk[me] += dv_t
        if t < n - 1:
            k_blk, v_blk = hop(k_blk), hop(v_blk)
            dk_blk, dv_blk = hop(dk_blk), hop(dv_blk)
    if n > 1:
        dk_blk, dv_blk = hop(dk_blk), hop(dv_blk)
    return ([g.to(x.dtype) for g, x in zip(dq, q)],
            [g.to(x.dtype) for g, x in zip(dk_blk, k)],
            [g.to(x.dtype) for g, x in zip(dv_blk, v)])


class RingFlash(torch.autograd.Function):
    """The counterpart of the reference's ``custom_vjp`` ``_ring_flash``
    over one ring of ``n``: inputs are the held members' (``members``) q,
    k and v shards, flattened (``len(members)`` each); outputs their
    attention outputs."""

    @staticmethod
    def forward(ctx, hop, causal, scale, backward, n, members, *qkv):
        # contiguous once here, not in every per-block backward call (the
        # shards are sequence slices of [B, S, H, D] tensors)
        c = len(members)
        q, k, v = ([x.contiguous() for x in qkv[i * c:(i + 1) * c]]
                   for i in range(3))
        out, lse = _ring_flash_fwd(q, k, v, hop, causal, scale, n, members)
        ctx.save_for_backward(*q, *k, *v, *out, *lse)
        ctx.hop, ctx.causal, ctx.scale = hop, causal, scale
        ctx.backward, ctx.n, ctx.members = backward, n, members
        return tuple(out)

    @staticmethod
    def backward(ctx, *douts):
        c, saved = len(ctx.members), ctx.saved_tensors
        q, k, v, out, lse = (saved[i * c:(i + 1) * c] for i in range(5))
        do = [g.contiguous() for g in douts]
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, do, ctx.hop,
                                     ctx.causal, ctx.scale, ctx.backward,
                                     ctx.n, ctx.members)
        return (None,) * 6 + (*dq, *dk, *dv)


def ring_flash_attention_kernel(q, k, v, *, hop, causal: bool = True,
                                scale: float | None = None,
                                backward: str = "fused",
                                n: int | None = None, members=None):
    """The flash ring over one group: the same contract as
    :func:`ring_attention_kernel` (lists of held member shards in, their
    outputs out, exact, differentiable), with K2 per visiting block in the
    forward and ``backward`` — ``"fused"`` (K5) or ``"split"`` (K3 + K4) —
    per visited block in the backward. A held member whose visiting block
    is fully masked launches nothing for it, and still passes it on."""
    _check_backward(backward)
    n, members = _members(q, n, members)
    if scale is None:
        scale = 1.0 / (q[0].shape[-1] ** 0.5)
    return list(RingFlash.apply(hop, causal, scale, backward, n, members,
                                *q, *k, *v))


def ring_self_attention(q, k, v, mesh, *, causal: bool = True,
                        axis_name: str = "sp",
                        spec=("dp", "sp", "tp", None),
                        scale: float | None = None,
                        impl: str | None = None,
                        backward: str = "fused",
                        coords: dict[str, int] | None = None):
    """Exact attention on global ``[B, S, H, D]`` tensors with the sequence
    sharded over ``axis_name``: ``spec`` maps batch → dp, sequence → the
    ring, heads → tp, and every (dp, tp) group runs its own ring; each
    shard lives on its mesh device and the output is joined on q's device.
    ``impl``: ``"flash"`` (K2 / K5, or K3 + K4, per visiting block),
    ``"dense"`` (blockwise PyTorch, the numerics reference), or ``None`` —
    flash on CUDA tensors; on the CPU, flash when the shard length tiles
    into 8-multiple blocks and dense otherwise (:func:`pick_impl`).
    ``backward`` picks the flash impl's backward kernels
    (fused|split). On a :class:`..parallel.mesh.WorldMesh` the tensors are
    this rank's shards and the output is its shard: the rank is one member
    of its ring (:func:`_world_ring`). ``coords``: where the axes ``spec``
    leaves out place the shards (default 0; ``..parallel.collectives.
    ring_map``)."""
    _check_backward(backward)
    if spec_axes(spec[1]) != (axis_name,):
        raise ValueError(f"spec {tuple(spec)} must shard the sequence "
                         f"(dimension 1) over {axis_name!r} alone")
    if isinstance(mesh, WorldMesh):
        return _world_ring(q, k, v, mesh, causal=causal, axis_name=axis_name,
                           scale=scale, impl=impl, backward=backward)
    impl = pick_impl(impl, q.shape[1] // mesh.shape[axis_name], "ring",
                     q.device)

    def kernel(qs, ks, vs, coords):
        hop = functools.partial(ring_permute, mesh=mesh, axis=axis_name,
                                coords=coords)
        if impl == "dense":
            return ring_attention_kernel(qs, ks, vs, hop=hop, causal=causal,
                                         scale=scale)
        return ring_flash_attention_kernel(qs, ks, vs, hop=hop,
                                           causal=causal, scale=scale,
                                           backward=backward)

    return ring_map(kernel, (q, k, v), mesh, spec, axis_name, coords=coords)


def _world_ring(q, k, v, mesh: WorldMesh, *, causal: bool, axis_name: str,
                scale, impl, backward: str):
    """The ring on a world mesh: ``q``, ``k``, ``v`` are this rank's shards
    ``[B, S_local, H, D]`` (its rows over the data axes, its sequence
    piece, its heads); the rank is member ``mesh.index(axis_name)`` of its
    line along ``axis_name``, and each block moves by the world's directed
    hop (``parallel.collectives.hop``; a line of one hops nothing). Returns
    this rank's output shard."""
    n, i = mesh.axis_size(axis_name), mesh.index(axis_name)
    impl = pick_impl(impl, q.shape[1], "ring", q.device)

    def hop(blocks):
        return [world_hop(x, mesh, axis_name) for x in blocks]

    if impl == "dense":
        out = ring_attention_kernel([q], [k], [v], hop=hop, causal=causal,
                                    scale=scale, n=n, members=(i,))
    else:
        out = ring_flash_attention_kernel([q], [k], [v], hop=hop,
                                          causal=causal, scale=scale,
                                          backward=backward, n=n,
                                          members=(i,))
    return out[0]


class ShardFlash(torch.autograd.Function):
    """Causal (or sliding-window) attention of sequence shard ``i``'s
    queries against the whole sequence's K/V
    (:func:`shard_flash_attention`)."""

    @staticmethod
    def forward(ctx, q, k, v, i, scale, backward, window):
        q = q.contiguous()
        state = _fold_start(q)
        for j, k_j, v_j, kw in _shard_blocks(k, v, q.shape[1], i, window):
            state = _fold(state, flash_partial(q, k_j, v_j, scale=scale,
                                               **kw))
        out, lse = _finish(state, q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.i, ctx.scale, ctx.backward = i, scale, backward
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do, s, i = do.contiguous(), q.shape[1], ctx.i
        delta = _delta(do, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for j, k_j, v_j, kw in _shard_blocks(k, v, s, i, ctx.window):
            dq_t, dk_t, dv_t = _block_grads(
                (q, k_j, v_j, do, lse, delta), ctx.scale, kw["causal"],
                ctx.backward, mask=kw["mask"], q_offset=kw["q_offset"])
            dq += dq_t
            dk[:, j * s:(j + 1) * s] = dk_t
            dv[:, j * s:(j + 1) * s] = dv_t
        return dq.to(q.dtype), dk, dv, None, None, None, None


def shard_block_live(i: int, j: int, s: int, window: int | None) -> bool:
    """Whether any query of sequence shard ``i`` sees a key of block ``j``
    (blocks of ``s`` rows): ``j <= i`` and, under a window ``W``, the
    nearest pair's distance ``(i − j)·s − (s − 1)`` is below ``W``."""
    return j <= i and (window is None or (i - j) * s - (s - 1) < window)


def _shard_blocks(k, v, s: int, i: int, window: int | None = None):
    """``(j, K_j, V_j, mask kwargs)`` of the live blocks shard ``i``'s
    queries see (:func:`shard_block_live`), in the ring's visiting order:
    its own block, then ``i - 1`` down to 0. Without a window the own
    block is causal and the earlier ones unmasked; with one every block
    takes the window mask at its key offset ``(i − j)·s``."""
    for j in range(i, -1, -1):
        if not shard_block_live(i, j, s, window):
            break
        if window is None:
            kw = dict(causal=j == i, mask=None, q_offset=0)
        else:
            kw = dict(causal=True, mask=MaskSpec("window", window),
                      q_offset=(i - j) * s)
        yield (j, k[:, j * s:(j + 1) * s].contiguous(),
               v[:, j * s:(j + 1) * s].contiguous(), kw)


def shard_flash_attention(q, k, v, i: int, *, scale: float | None = None,
                          backward: str = "fused",
                          window: int | None = None):
    """Causal attention of the queries ``q [B, S, H, D]`` of sequence shard
    ``i`` (global rows ``i·S ...``) against the whole sequence's ``k``,
    ``v`` ``[B, n·S, H, D]`` (gathered over the shards): the blocks ring
    member ``i`` folds, taken from the gathered K/V with no hop — K2 on
    its own block (causal) and on each earlier one (unmasked), in the
    ring's order, so the output equals the world ring's bit for bit; the
    later blocks are fully masked and launch nothing. ``window`` (keys with
    ``q − k < window``): every visited block takes K2's window mask at its
    key offset ``(i − j)·S``, and a block no query of the shard reaches
    (:func:`shard_block_live`) launches nothing, forward or backward.
    Backward: K5 (or K3 + K4, ``backward``) with f32 outputs a block, at
    the same masks; the unvisited blocks' dK/dV are zero. Returns
    ``[B, S, H, D]`` in q's dtype."""
    _check_backward(backward)
    if k.shape[1] % q.shape[1] or k.shape[1] // q.shape[1] <= i:
        raise ValueError(f"{k.shape[1]} keys hold no shard {i} of "
                         f"{q.shape[1]} queries")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return ShardFlash.apply(q, k, v, i, scale, backward, window)
