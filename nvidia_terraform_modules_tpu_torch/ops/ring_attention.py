# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Ring attention: exact attention with the sequence sharded over the ``sp``
mesh axis — the port of the reference's ``ops/ring_attention.py``.

Each member of the ring keeps its sequence shard of Q; K/V blocks rotate
neighbour to neighbour (:func:`..parallel.collectives.ring_permute`), so
at ring step ``t`` member ``me`` holds the block first owned by
``(me - t) % n``, and every member folds each visiting block into an
online-softmax state. The program is one process that steps all members
in lock step, each on its mesh device; on a mesh that names one device
``n`` times the hops move nothing.

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

from ..parallel.collectives import ring_map, ring_permute, spec_axes
from .flash_attention import (
    NEG_INF,
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
                              window: int | None = None):
    """Unsharded O(S²) softmax attention on ``[B, S, H, D]``: f32 scores,
    softmax, probabilities cast to ``v.dtype`` for the PV product with f32
    accumulation, the output in q's dtype. ``window`` keeps only keys with
    ``q - k < window`` (causal only)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if window is not None and not causal:
        raise ValueError("window masking implies causal attention")
    mask = None
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        mask = pos[:, None] >= pos[None, :]
        if window is not None:
            mask &= (pos[:, None] - pos[None, :]) < window
    p = torch.softmax(_block_scores(q, k, scale, mask), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _t(x):
    """``[B, H, S]`` → ``[B, S, H, 1]``, to scale ``[B, S, H, D]`` rows."""
    return x.transpose(1, 2)[..., None]


def ring_attention_kernel(q, k, v, *, hop, causal: bool = True,
                          scale: float | None = None):
    """The dense ring over one group: ``q``, ``k``, ``v`` are lists of the
    ring members' shards ``[B, S_local, H, D]`` (member order), ``hop`` the
    group's :func:`ring_permute`. Causal masking in GLOBAL positions.
    Returns the members' outputs in q's dtype; differentiable by
    autograd."""
    n = len(q)
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
        for me in range(n):
            src = (me - t) % n
            mask = None
            if causal:
                mask = (me * s_loc + ar[me])[:, None] >= (
                    src * s_loc + ar[me])[None, :]
            s = _block_scores(q[me], k_blk[me], scale, mask)
            m_new = torch.maximum(m[me], s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
            pv = torch.einsum("bhqk,bkhd->bqhd",
                              p.to(v_blk[me].dtype).float(),
                              v_blk[me].float())
            corr = torch.exp(m[me] - m_new)
            l_[me] = l_[me] * corr + p.sum(dim=-1)
            o[me] = o[me] * _t(corr) + pv
            m[me] = m_new
        if t < n - 1:   # the final block is folded without a wasted hop
            k_blk, v_blk = hop(k_blk), hop(v_blk)
    return [(o[me] / _t(l_[me].clamp_min(1e-30))).to(q[me].dtype)
            for me in range(n)]


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


def _ring_flash_fwd(q, k, v, hop, causal: bool, scale: float):
    """The forward ring sweep: per visiting block one K2 call, folded
    exactly. Returns the members' outputs (q's dtype) and global LSEs
    ``[B, H, S_local]``."""
    n = len(q)
    b, s_loc, h, d = q[0].shape
    dev = [x.device for x in q]
    m = [torch.full((b, h, s_loc), NEG_INF, device=x) for x in dev]
    l_ = [torch.zeros((b, h, s_loc), device=x) for x in dev]
    o = [torch.zeros((b, s_loc, h, d), device=x) for x in dev]
    k_blk, v_blk = list(k), list(v)
    for t in range(n):
        for me, diag in _visits(n, t, causal):
            o_b, m_b, l_b = flash_partial(q[me], k_blk[me], v_blk[me],
                                          scale=scale, causal=diag)
            m_new = torch.maximum(m[me], m_b)
            c, c_b = torch.exp(m[me] - m_new), torch.exp(m_b - m_new)
            l_[me] = l_[me] * c + l_b * c_b
            o[me] = o[me] * _t(c) + o_b * _t(c_b)
            m[me] = m_new
        if t < n - 1:
            k_blk, v_blk = hop(k_blk), hop(v_blk)
    out, lse = [], []
    for me in range(n):
        lm = l_[me].clamp_min(1e-30)
        out.append((o[me] / _t(lm)).to(q[me].dtype))
        lse.append(m[me] + torch.log(lm))
    return out, lse


def _ring_flash_bwd(q, k, v, out, lse, do, hop, causal: bool, scale: float,
                    backward: str):
    """The backward ring sweep: the K/V blocks make the forward's rotation
    and their f32 dK/dV accumulators travel with them; one final hop
    brings each block's gradient home. Per visited block K5 (or K3 + K4)
    with f32 outputs; P from the saved global LSE;
    ``delta = rowsum(dO·O)`` in f32. Returns (dq, dk, dv) lists in the
    inputs' dtypes."""
    n = len(q)
    f32 = torch.float32
    delta = [(do[me].float() * out[me].float()).sum(-1).transpose(1, 2)
             .contiguous() for me in range(n)]
    dq = [torch.zeros(x.shape, dtype=f32, device=x.device) for x in q]
    dk_blk = [torch.zeros(x.shape, dtype=f32, device=x.device) for x in k]
    dv_blk = [torch.zeros(x.shape, dtype=f32, device=x.device) for x in v]
    k_blk, v_blk = list(k), list(v)
    for t in range(n):
        for me, diag in _visits(n, t, causal):
            args = (q[me], k_blk[me], v_blk[me], do[me], lse[me], delta[me])
            kw = dict(scale=scale, causal=diag, out_dtype=f32)
            if backward == "fused":
                dq_t, dk_t, dv_t = flash_dqdkv(*args, **kw)
            else:
                dq_t = flash_dq(*args, **kw)
                dk_t, dv_t = flash_dkv(*args, **kw)
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
    over one ring: inputs are the members' q, k and v shards, flattened
    (``n`` each); outputs the members' attention outputs."""

    @staticmethod
    def forward(ctx, hop, causal, scale, backward, n, *qkv):
        # contiguous once here, not in every per-block backward call (the
        # shards are sequence slices of [B, S, H, D] tensors)
        q, k, v = ([x.contiguous() for x in qkv[i * n:(i + 1) * n]]
                   for i in range(3))
        out, lse = _ring_flash_fwd(q, k, v, hop, causal, scale)
        ctx.save_for_backward(*q, *k, *v, *out, *lse)
        ctx.hop, ctx.causal, ctx.scale = hop, causal, scale
        ctx.backward, ctx.n = backward, n
        return tuple(out)

    @staticmethod
    def backward(ctx, *douts):
        n, saved = ctx.n, ctx.saved_tensors
        q, k, v, out, lse = (saved[i * n:(i + 1) * n] for i in range(5))
        do = [g.contiguous() for g in douts]
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, do, ctx.hop,
                                     ctx.causal, ctx.scale, ctx.backward)
        return (None,) * 5 + (*dq, *dk, *dv)


def ring_flash_attention_kernel(q, k, v, *, hop, causal: bool = True,
                                scale: float | None = None,
                                backward: str = "fused"):
    """The flash ring over one group: the same contract as
    :func:`ring_attention_kernel` (lists of member shards in, member
    outputs out, exact, differentiable), with K2 per visiting block in the
    forward and ``backward`` — ``"fused"`` (K5) or ``"split"`` (K3 + K4) —
    per visited block in the backward."""
    _check_backward(backward)
    if scale is None:
        scale = 1.0 / (q[0].shape[-1] ** 0.5)
    return list(RingFlash.apply(hop, causal, scale, backward, len(q), *q,
                                *k, *v))


def ring_self_attention(q, k, v, mesh, *, causal: bool = True,
                        axis_name: str = "sp",
                        spec=("dp", "sp", "tp", None),
                        scale: float | None = None,
                        impl: str | None = None,
                        backward: str = "fused"):
    """Exact attention on global ``[B, S, H, D]`` tensors with the sequence
    sharded over ``axis_name``: ``spec`` maps batch → dp, sequence → the
    ring, heads → tp, and every (dp, tp) group runs its own ring; each
    shard lives on its mesh device and the output is joined on q's device.
    ``impl``: ``"flash"`` (K2 / K5, or K3 + K4, per visiting block),
    ``"dense"`` (blockwise PyTorch, the numerics reference), or ``None`` —
    flash on CUDA tensors; on the CPU, flash when the shard length tiles
    into 8-multiple blocks and dense otherwise (:func:`pick_impl`).
    ``backward`` picks the flash impl's backward kernels
    (fused|split)."""
    _check_backward(backward)
    if spec_axes(spec[1]) != (axis_name,):
        raise ValueError(f"spec {tuple(spec)} must shard the sequence "
                         f"(dimension 1) over {axis_name!r} alone")
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

    return ring_map(kernel, (q, k, v), mesh, spec, axis_name)
