# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Collectives over one mesh axis, in one process — the counterparts of
``jax.lax.ppermute`` (the ring hop of the reference's
``ops/ring_attention.py`` and ``parallel/collectives.ring_permute_probe``)
and ``jax.lax.all_to_all`` (``ops/ulysses_attention.py``), and of
``shard_map``'s cutting of global arrays into per-device shards.

The program is one process that steps every member of a ring in lock
step: a collective takes one tensor per position along the axis, in
order, and returns one per position, each moved with ``.to(device)`` to
the device that owns it. On a mesh that names one device more than once
(the CPU tests' ``[cpu] * n``, one card's ``[cuda:0] * 4``) the move is a
no-op and nothing is copied. Every step is a PyTorch operation, so
autograd runs through it: the backward of a hop is the hop the other way.

Not ported yet (ROADMAP Queue A item 6): the timed probes (``psum_probe``
and the rest), the hierarchical psum, and a ``torch.distributed`` / NCCL
backend for one process per card.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from .mesh import Mesh


def _ring_devices(mesh: Mesh, axis: str = "sp",
                 coords: dict[str, int] | None = None) -> list[torch.device]:
    """The devices along ``axis`` at ``coords`` on the other axes (axes
    left out: 0), in ring order."""
    coords = dict(coords or {})
    return [mesh.device_at(**{**coords, axis: r})
            for r in range(mesh.shape[axis])]


def ring_permute(blocks: Sequence[torch.Tensor], mesh: Mesh,
                 axis: str = "sp", *,
                 coords: dict[str, int] | None = None) -> list[torch.Tensor]:
    """One ring hop: position ``i`` sends its block to ``(i + 1) % n``
    (``ppermute`` with ``perm=[(i, (i + 1) % n)]``). Returns the blocks
    rotated by one, each on its new owner's device."""
    devs = _ring_devices(mesh, axis, coords)
    n = len(devs)
    if len(blocks) != n:
        raise ValueError(f"{len(blocks)} blocks for a ring of {n}")
    return [blocks[(i - 1) % n].to(devs[i]) for i in range(n)]


def all_to_all(blocks: Sequence[torch.Tensor], mesh: Mesh,
               axis: str = "sp", *, split_axis: int, concat_axis: int,
               coords: dict[str, int] | None = None) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(..., tiled=True)`` over ``axis``: position
    ``i`` cuts its block into ``n`` chunks along ``split_axis``; position
    ``j`` receives chunk ``j`` of every position and concatenates them, in
    position order, along ``concat_axis``."""
    devs = _ring_devices(mesh, axis, coords)
    n = len(devs)
    if len(blocks) != n:
        raise ValueError(f"{len(blocks)} blocks for an axis of {n}")
    if any(b.shape[split_axis] % n for b in blocks):
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(blocks[0].shape)} does not split {n} ways")
    chunks = [b.chunk(n, dim=split_axis) for b in blocks]
    return [torch.cat([chunks[i][j].to(devs[j]) for i in range(n)],
                      dim=concat_axis) for j in range(n)]


def spec_axes(entry) -> tuple[str, ...]:
    """A spec entry (``None``, an axis name, or a tuple of them) → the
    tuple of axis names it splits its dimension over."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def ring_map(kernel: Callable, tensors: Sequence[torch.Tensor], mesh: Mesh,
             spec: Sequence, axis: str = "sp") -> torch.Tensor:
    """``shard_map`` for a kernel written over one ring: cut each global
    tensor by ``spec`` (the same spec in and out), place every shard on its
    mesh device, and call ``kernel(*shards, coords=...)`` once per group of
    the other axes' coordinates, where each element of ``shards`` is the
    list of one tensor's shards along ``axis`` (position order) and
    ``coords`` the group's coordinates. The kernel returns the output's
    shards in the same order; they are joined into one tensor on the first
    input's device. Mesh axes that ``spec`` leaves out replicate the work:
    only their coordinate 0 runs."""
    dims = [spec_axes(e) for e in spec]
    ndim = tensors[0].dim()
    if len(dims) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the "
                         f"tensors' {ndim} dimensions")
    dims += [()] * (ndim - len(dims))
    used = [a for d in dims for a in d]
    unknown = sorted(set(used) - set(mesh.axis_names))
    if unknown or len(used) != len(set(used)):
        raise ValueError(f"spec {tuple(spec)} names unknown or repeated "
                         f"mesh axes (mesh axes {mesh.axis_names})")
    if axis not in used:
        raise ValueError(f"spec {tuple(spec)} does not shard over {axis!r}")
    sizes = mesh.shape
    pieces = [math.prod(sizes[a] for a in d) for d in dims]
    for t in tensors:
        for i, (n, d) in enumerate(zip(pieces, dims)):
            if t.shape[i] % n:
                raise ValueError(f"dimension {i} ({t.shape[i]}) of "
                                 f"{tuple(t.shape)} does not split over "
                                 f"{d} ({n})")

    def piece_of(coords: dict[str, int]) -> tuple[int, ...]:
        return tuple(int(np.ravel_multi_index(
            [coords[a] for a in d], [sizes[a] for a in d])) if d else 0
            for d in dims)

    def cut(t: torch.Tensor) -> np.ndarray:
        """The tensor's pieces, one ``chunk`` per dimension: autograd
        joins their gradients with one ``cat`` each, where per-piece
        slices would each scatter into a zero-filled full-size tensor."""
        parts = np.empty((), dtype=object)
        parts[()] = t
        for i, n in enumerate(pieces):
            nxt = np.empty(parts.shape + (n,), dtype=object)
            for idx in np.ndindex(*parts.shape):
                for j, p in enumerate(parts[idx].chunk(n, dim=i)):
                    nxt[idx + (j,)] = p
            parts = nxt
        return parts

    home = tensors[0].device
    others = [a for a in mesh.axis_names if a != axis and a in used]
    cuts = [cut(t) for t in tensors]
    grid = np.empty(pieces, dtype=object)
    for group in np.ndindex(*[sizes[a] for a in others]):
        coords = dict(zip(others, group))
        ring = [{**coords, axis: r} for r in range(sizes[axis])]
        devs = [mesh.device_at(**c) for c in ring]
        shards = [[parts[piece_of(c)].to(dev) for c, dev in zip(ring, devs)]
                  for parts in cuts]
        outs = kernel(*shards, coords=coords)
        for c, out in zip(ring, outs):
            grid[piece_of(c)] = out.to(home)
    for i in reversed(range(ndim)):
        joined = np.empty(grid.shape[:-1], dtype=object)
        for idx in np.ndindex(*grid.shape[:-1]):
            parts = list(grid[idx])
            joined[idx] = parts[0] if len(parts) == 1 else torch.cat(
                parts, dim=i)
        grid = joined
    return grid[()]
