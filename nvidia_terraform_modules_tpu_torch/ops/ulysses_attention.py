# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Ulysses attention: all-to-all sequence parallelism over the ``sp`` axis —
the port of the reference's ``ops/ulysses_attention.py``.

Where the ring keeps heads local and rotates K/V blocks, Ulysses re-shards
once each way: an all-to-all (:func:`..parallel.collectives.all_to_all`)
swaps each member's sequence shard for a head shard, so every member holds
the FULL sequence for ``H/sp`` of the heads and runs ordinary attention
locally; a second all-to-all swaps back. Both are PyTorch operations, so
autograd transposes each into its mirror and the backward needs no custom
Function; on a ``WorldMesh`` each all-to-all is one ``all_to_all_single``
on the ``sp`` group, inside autograd, its backward the mirror all-to-all.
The local attention is :func:`.flash_attention.flash_attention` (K1; K5,
or K3 + K4, in the backward) or
:func:`.ring_attention.dense_reference_attention`.

The reference's TPU tile levers (``block_q``, ``block_k``, ``pipeline``)
are not carried: the CUDA kernels have one 64x64 tiling.
"""

from __future__ import annotations

import functools
import math

import torch

from ..parallel.collectives import (
    all_to_all,
    all_to_all_world,
    ring_map,
    spec_axes,
)
from ..parallel.mesh import WorldMesh
from .flash_attention import _check_backward, flash_attention, pick_impl
from .ring_attention import dense_reference_attention


def ulysses_attention_kernel(q, k, v, *, a2a, causal: bool = True,
                             scale: float | None = None,
                             impl: str = "dense", backward: str = "fused",
                             n: int | None = None):
    """Ulysses over one group of ``n`` members (default ``len(q)``): ``q``,
    ``k``, ``v`` are lists of the shards ``[B, S_local, H_local, D]`` of
    the members held here (member order: all of them in one process, this
    rank's on a world mesh), ``a2a`` the group's :func:`all_to_all` of such
    a list. Causal masking is global (after the first all-to-all each
    member holds the whole sequence). Returns those members' outputs
    ``[B, S_local, H_local, D]``."""
    sp = len(q) if n is None else n
    h_loc = q[0].shape[2]
    if h_loc % sp:
        raise ValueError(
            f"Ulysses needs local head count divisible by the sequence axis: "
            f"{h_loc} heads per shard vs sp={sp} (global heads must be a "
            f"multiple of sp × tp)")
    if sp > 1:
        # [3, B, S/sp, H, D] → [3, B, S, H/sp, D]: scatter heads, gather
        # sequence; q/k/v ride one stacked collective
        stacked = a2a([torch.stack(t) for t in zip(q, k, v)], split_axis=3,
                      concat_axis=2)
        q, k, v = zip(*[(t[0], t[1], t[2]) for t in stacked])
    if impl == "flash":
        out = [flash_attention(a, b, c, causal=causal, scale=scale,
                               backward=backward)
               for a, b, c in zip(q, k, v)]
    else:
        out = [dense_reference_attention(a, b, c, causal=causal, scale=scale)
               for a, b, c in zip(q, k, v)]
    if sp > 1:
        # [B, S, H/sp, D] → [B, S/sp, H, D]: the mirror all-to-all
        out = a2a(out, split_axis=1, concat_axis=2)
    return out


def ulysses_self_attention(q, k, v, mesh, *, causal: bool = True,
                           axis_name: str = "sp",
                           spec=("dp", "sp", "tp", None),
                           scale: float | None = None,
                           impl: str | None = None,
                           backward: str = "fused",
                           coords: dict[str, int] | None = None):
    """Exact attention on global ``[B, S, H, D]`` tensors with the sequence
    sharded on ``axis_name``, through head-scatter / sequence-gather
    all-to-alls (the DeepSpeed-Ulysses layout). ``spec`` maps batch → dp,
    sequence → sp, heads → tp; heads must divide by sp × tp. ``impl``:
    ``"flash"``, ``"dense"`` or ``None`` (flash on CUDA tensors; on the CPU,
    flash when the FULL sequence tiles into 8-multiple blocks: after the
    all-to-all the local problem has the global length); ``backward`` the
    flash impl's backward kernels (fused|split). On a
    :class:`..parallel.mesh.WorldMesh` the tensors are this rank's shards
    (heads already cut over ``tp``) and the output is its shard
    (:func:`_world_ulysses`). ``coords``: where the axes ``spec`` leaves
    out place the shards (default 0; ``parallel.collectives.ring_map``)."""
    _check_backward(backward)
    if spec_axes(spec[1]) != (axis_name,):
        raise ValueError(f"spec {tuple(spec)} must shard the sequence "
                         f"(dimension 1) over {axis_name!r} alone")
    if isinstance(mesh, WorldMesh):
        return _world_ulysses(q, k, v, mesh, causal=causal,
                              axis_name=axis_name, scale=scale, impl=impl,
                              backward=backward)
    sp = mesh.shape[axis_name]
    tp = math.prod(mesh.shape[a] for a in spec_axes(spec[2]))
    heads = q.shape[2]
    if heads % (sp * tp):
        raise ValueError(
            f"Ulysses layout needs heads divisible by sp×tp: "
            f"{heads} heads vs sp={sp} × tp={tp}")
    impl = pick_impl(impl, q.shape[1], "ulysses", q.device)

    def kernel(qs, ks, vs, coords):
        a2a = functools.partial(all_to_all, mesh=mesh, axis=axis_name,
                                coords=coords)
        return ulysses_attention_kernel(qs, ks, vs, a2a=a2a, causal=causal,
                                        scale=scale, impl=impl,
                                        backward=backward)

    return ring_map(kernel, (q, k, v), mesh, spec, axis_name, coords=coords)


def _world_ulysses(q, k, v, mesh: WorldMesh, *, causal: bool,
                   axis_name: str, scale, impl, backward: str):
    """Ulysses on a world mesh: ``q``, ``k``, ``v`` are this rank's shards
    ``[B, S_local, H_local, D]`` (``H_local`` its ``tp`` heads); the
    all-to-alls run on its line along ``axis_name``
    (``parallel.collectives.all_to_all_world``; a line of one runs none).
    Heads must divide by ``sp × tp``: ``H_local`` by ``sp``."""
    n = mesh.axis_size(axis_name)
    group = mesh.group(axis_name)
    impl = pick_impl(impl, q.shape[1] * n, "ulysses", q.device)

    def a2a(blocks, *, split_axis, concat_axis):
        return [all_to_all_world(x, group, n, split_axis=split_axis,
                                 concat_axis=concat_axis) for x in blocks]

    return ulysses_attention_kernel([q], [k], [v], a2a=a2a, causal=causal,
                                    scale=scale, impl=impl,
                                    backward=backward, n=n)[0]
