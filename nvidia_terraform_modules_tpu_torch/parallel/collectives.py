# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Collectives over one mesh axis, in two forms.

**One process** (:class:`Mesh`) — the counterparts of ``jax.lax.ppermute``
(the ring hop of the reference's ``ops/ring_attention.py``) and
``jax.lax.all_to_all`` (``ops/ulysses_attention.py``), and of
``shard_map``'s cutting of global arrays into per-device shards. The
program is one process that steps every member of a ring in lock step: a
collective takes one tensor per position along the axis, in order, and
returns one per position, each moved with ``.to(device)`` to the device
that owns it. On a mesh that names one device more than once (the CPU
tests' ``[cpu] * n``, one card's ``[cuda:0] * 4``) the move is a no-op and
nothing is copied. Every step is a PyTorch operation, so autograd runs
through it: the backward of a hop is the hop the other way.

**One process a device** (:class:`WorldMesh`, ``torch.distributed``) — the
reference's timed probes (``psum_probe``, ``all_gather_probe``,
``reduce_scatter_probe``, ``ring_permute_probe``, ``all_to_all_probe``,
``hierarchical_psum`` and its probe; ``ALL_PROBES``) on each axis's
process group: ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``batch_isend_irecv`` to the ring neighbour and
``all_to_all_single`` (names that every PyTorch in use has). Each rank
makes its input from its own axis index (``1 + axis_index``, as the
reference does, so no collective can be folded into local arithmetic),
judges the result itself, and the error is max-reduced over the world:
every rank returns the same verdict. A probe's time is the two-point
delta of chains of 1 and 9 hops (``utils/timing.delta_time``, on CUDA
events on the card), max-reduced over the world; its bytes are counted as
the reference counts them. A line that is this rank alone launches no
collective, except in a world of one, where the world's own group carries
the probe (so a one-rank NCCL world still runs its all-reduce). Then the tensor-parallel pairs of the sharded train step
(:func:`enter_parallel`, :func:`exit_parallel`, :func:`gather_last`):
autograd functions over a ``tp`` group, Megatron's ``f``/``g`` — and
the expert-parallel ones of the MoE layer (:func:`data_exclusive_counts`,
:func:`dispatch_experts`, :func:`gather_experts`, :func:`data_sum`),
whose backward is each forward's transpose. The sequence and stage lines
(since the pipeline port): :func:`hop`, the directed hop along ``sp`` or
``pp`` (backward: the hop the other way), :func:`gather_seq` (backward: a
reduce-scatter), :func:`all_to_all_world` (backward: the mirror
all-to-all), and :func:`exchange`, the point-to-point transfers a static
schedule posts (nothing where nothing is carried).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.timing import delta_time, event_timed
from .mesh import Mesh, WorldMesh


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


# ------------------------------------------- one process a device (world)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` in place over ``group`` (``None``: this rank alone)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[n, *x.shape]``: every member's ``x`` in line order."""
    if group is None:
        return x[None]
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    return out.view(n, *x.shape)


def _reduce_scatter(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over ``group`` of ``x`` (1-d), this member's ``1/n`` of it."""
    if group is None:
        return x
    out = torch.empty((x.numel() // n,), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _ring_hop(x: torch.Tensor, mesh: WorldMesh, axis: str,
              shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the member ``shift`` places on along this rank's line
    along ``axis`` (cyclically) and receive the one ``shift`` places back
    (``ppermute`` by ``shift``). A line of one copies: no rank ever sends
    to itself."""
    line = mesh.line(axis)
    n, i = len(line), mesh.index(axis)
    if n == 1:
        return x.clone()
    out = torch.empty_like(x)
    group = mesh.group(axis)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), line[(i + shift) % n],
                   group=group),
        dist.P2POp(dist.irecv, out, line[(i - shift) % n], group=group)])
    for req in reqs:
        req.wait()
    return out


class _Hop(torch.autograd.Function):
    """The directed hop forward; backward the same hop the other way (the
    gradient of what was received goes back to its sender)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = mesh, axis, shift
        return _ring_hop(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        return _ring_hop(g, mesh, axis, -shift), None, None, None


def hop(x: torch.Tensor, mesh: WorldMesh, axis: str = "sp",
        shift: int = 1) -> torch.Tensor:
    """The directed hop along ``axis`` (``"sp"``, ``"pp"``, ...) on a world
    mesh: every member of this rank's line sends ``x`` ``shift`` places up
    the line (``-1``: down), cyclically, and returns what the member
    ``shift`` places back sent — ``jax.lax.ppermute`` by ``shift``, inside
    autograd (the backward is the hop by ``-shift``). A line of one makes
    no call: ``x`` is copied."""
    return _Hop.apply(x, mesh, axis, shift)


def exchange(mesh: WorldMesh, axis: str, sends=(), recvs=()) -> list:
    """Point-to-point traffic along this rank's line along ``axis``, posted
    together and waited for: ``sends`` is ``(tensor, offset)`` pairs, each
    sent to the member ``offset`` places on; ``recvs`` is ``(shape, dtype,
    offset)`` triples, each received from the member ``offset`` places on.
    Returns the received tensors in ``recvs``' order. No wrap-around: a
    peer off the line raises. Nothing is posted for a send or receive the
    caller leaves out, so a static schedule that both neighbours derive
    alike posts only the transfers that carry something (no garbage on a
    wrap-around edge, as the reference's stage ring sends); a line of one
    has no peer, and no call is made."""
    line = mesh.line(axis)
    i = mesh.index(axis)
    group = mesh.group(axis)

    def peer(offset):
        j = i + offset
        if offset == 0 or not 0 <= j < len(line):
            raise ValueError(f"{axis} member {i} has no peer {offset:+d} on "
                             f"a line of {len(line)}")
        return line[j]

    ops, outs = [], []
    for x, offset in sends:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), peer(offset),
                              group=group))
    for shape, dtype, offset in recvs:
        out = torch.empty(shape, dtype=dtype, device=mesh.device)
        ops.append(dist.P2POp(dist.irecv, out, peer(offset), group=group))
        outs.append(out)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all`` over ``group`` along dim 0 (tiled)."""
    if group is None:
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _probe_group(mesh: WorldMesh, axes):
    """The group a probe runs on: the line's; in a world of one, the
    world's own group."""
    group = mesh.group(axes)
    if group is None and dist.get_world_size() == 1:
        return dist.group.WORLD
    return group


def world_max(value: float, device) -> float:
    """The maximum of ``value`` over every rank of the world."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _run(mesh: WorldMesh, verify: Callable[[], float],
         step: Callable[[Any], torch.Tensor], moved_bytes: float, n: int,
         tol: float = 1e-5) -> dict[str, Any]:
    """Judge and time one probe: ``verify()`` is this rank's error, made
    the world's maximum; ``step(carry)`` is one data-dependent hop
    (``step(None)`` the first input), chained 1 and 9 times for the
    two-point delta."""
    err = world_max(verify(), mesh.device)

    def make_chain(length):
        def chain():
            carry = step(None)
            for _ in range(length):
                carry = step(carry)
            return carry
        return chain

    clock = event_timed if mesh.device.type == "cuda" else None
    secs = world_max(delta_time(make_chain, iters_lo=1, iters_hi=9,
                                clock=clock), mesh.device)
    return {"ok": err <= tol, "max_error": err, "seconds": secs,
            "bytes": moved_bytes, "participants": n}


def _index(mesh: WorldMesh, axes) -> float:
    return float(mesh.index(axes))


def psum_probe(mesh: WorldMesh, axis: str = "dp", n_elems: int = 1 << 20,
               *, offset: float = 0.0) -> dict[str, Any]:
    """All-reduce over ``axis`` — the north-star invariant. Each member
    contributes ``axis_index + 1`` (plus ``offset``: a fault a test
    plants on one rank), so the sum must be ``1 + 2 + … + n``
    everywhere."""
    n, group, i = (mesh.axis_size(axis), _probe_group(mesh, axis),
                   _index(mesh, axis))
    want = n * (n + 1) / 2

    def contribution():
        return torch.full((n_elems,), 1.0 + i + offset, dtype=torch.float32,
                          device=mesh.device)

    def verify():
        out = _all_reduce(contribution(), group)
        return (out - want).abs().max().item()

    def step(carry):
        if carry is None:
            return contribution()
        # mix the previous result back in: every hop is data-dependent
        return _all_reduce(contribution() + 1e-6 * carry, group) + i

    moved = 2 * (n - 1) / n * (n * n_elems * 4)
    return _run(mesh, verify, step, moved, n)


def all_gather_probe(mesh: WorldMesh, axis: str = "tp",
                     n_elems: int = 1 << 18) -> dict[str, Any]:
    """All-gather over ``axis``; every member must see every
    contribution, row ``r`` holding member ``r``'s."""
    n, group, i = (mesh.axis_size(axis), _probe_group(mesh, axis),
                   _index(mesh, axis))

    def mine(v):
        return torch.full((n_elems,), v, dtype=torch.float32,
                          device=mesh.device)

    def verify():
        g = _all_gather(mine(i), group, n)
        want = torch.arange(n, dtype=torch.float32,
                            device=mesh.device)[:, None]
        return (g - want).abs().max().item()

    def step(carry):
        if carry is None:
            return mine(i)
        return _all_gather(carry + i, group, n).mean(dim=0) + i

    moved = (n - 1) / n * (n * n_elems * 4) * n
    return _run(mesh, verify, step, moved, n)


def reduce_scatter_probe(mesh: WorldMesh, axis: str = "tp",
                         n_elems: int = 1 << 18) -> dict[str, Any]:
    """Reduce-scatter over ``axis`` — the backbone of row-parallel
    products."""
    n, group, i = (mesh.axis_size(axis), _probe_group(mesh, axis),
                   _index(mesh, axis))
    want = n * (n + 1) / 2

    def contribution():
        return torch.full((n * n_elems,), 1.0 + i, dtype=torch.float32,
                          device=mesh.device)

    def verify():
        out = _reduce_scatter(contribution(), group, n)
        return (out - want).abs().max().item()

    def step(carry):
        if carry is None:
            return torch.full((n_elems,), i, dtype=torch.float32,
                              device=mesh.device)
        return _reduce_scatter(contribution() + 1e-6 * carry.repeat(n),
                               group, n)

    moved = (n - 1) / n * (n * n * n_elems * 4)
    return _run(mesh, verify, step, moved, n)


def ring_permute_probe(mesh: WorldMesh, axis: str = "sp",
                       n_elems: int = 1 << 18) -> dict[str, Any]:
    """One hop of a ring (``ppermute`` by one) — the primitive under ring
    attention: member ``i`` must receive member ``i - 1``'s payload."""
    n, i = mesh.axis_size(axis), _index(mesh, axis)

    def mine():
        return torch.full((n_elems,), i, dtype=torch.float32,
                          device=mesh.device)

    def verify():
        out = _ring_hop(mine(), mesh, axis)
        return (out - (i - 1) % n).abs().max().item()

    def step(carry):
        if carry is None:
            return mine()
        return _ring_hop(carry + i, mesh, axis)

    moved = n * n_elems * 4
    return _run(mesh, verify, step, moved, n)


def all_to_all_probe(mesh: WorldMesh, axis: str = "ep",
                     n_elems: int = 1 << 16) -> dict[str, Any]:
    """All-to-all over ``axis`` — the MoE dispatch/combine collective.
    Member ``i`` fills row ``r`` of its ``[n, n_elems]`` payload with
    ``i·n + r``; after the exchange row ``j`` must hold ``j·n + i``."""
    n, group, i = (mesh.axis_size(axis), _probe_group(mesh, axis),
                   _index(mesh, axis))
    rows = torch.arange(n, dtype=torch.float32, device=mesh.device)[:, None]

    def contribution():
        return (i * n + rows).expand(n, n_elems).contiguous()

    def verify():
        out = _all_to_all(contribution(), group)
        return (out - (rows * n + i)).abs().max().item()

    def step(carry):
        if carry is None:
            return contribution()
        return _all_to_all(carry + i, group)

    # each member ships (n - 1)/n of its local array a hop
    moved = (n - 1) * n_elems * 4 * n
    return _run(mesh, verify, step, moved, n)


def hierarchical_psum(x: torch.Tensor, mesh: WorldMesh,
                      slice_axis: str = "slice",
                      inner_axes: tuple[str, ...] = ("dp",)) -> torch.Tensor:
    """All-reduce of ``x`` over ``slice × inner_axes`` in three phases:
    reduce-scatter inside the host (each of its ``k`` members ends up
    owning the host's sum of ``1/k`` of the vector), all-reduce of that
    chunk across hosts (the cross-host traffic shrinks by ``k``), then
    all-gather inside the host. With one slice, or ``k = 1``, it is the
    plain all-reduce over the axes present. Returns a new tensor; equal
    to a flat all-reduce up to the order of the sums."""
    names = mesh.axis_names
    inner = tuple(a for a in inner_axes if a in names)
    k = mesh.axis_size(inner)
    n_slices = mesh.shape.get(slice_axis, 1)
    if n_slices == 1 or k == 1:
        axes = ((slice_axis,) if slice_axis in names else ()) + inner
        return _all_reduce(x.clone(), mesh.group(axes) if axes else None)
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % k
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    inner_group = mesh.group(inner)
    with torch.profiler.record_function("hier_psum_ici_reduce_scatter"):
        chunk = _reduce_scatter(flat, inner_group, k)
    with torch.profiler.record_function("hier_psum_dcn_psum"):
        _all_reduce(chunk, mesh.group(slice_axis))
    with torch.profiler.record_function("hier_psum_ici_all_gather"):
        flat = _all_gather(chunk, inner_group, k).reshape(-1)
    return flat[:n].reshape(x.shape)


def hierarchical_psum_probe(mesh: WorldMesh, slice_axis: str = "slice",
                            inner_axis: str = "dp",
                            n_elems: int = 1 << 16) -> dict[str, Any]:
    """All-reduce over (slice × inner) through :func:`hierarchical_psum`,
    on whatever topology the world has (slice axis present, absent, or of
    size 1)."""
    names = mesh.axis_names
    axes = tuple(a for a in (slice_axis, inner_axis) if a in names)
    if not axes:
        raise ValueError(
            f"mesh {names} has neither {slice_axis!r} nor {inner_axis!r}")
    m, i = mesh.axis_size(axes), _index(mesh, axes)
    want = m * (m + 1) / 2

    def contribution():
        return torch.full((n_elems,), 1.0 + i, dtype=torch.float32,
                          device=mesh.device)

    def verify():
        out = hierarchical_psum(contribution(), mesh, slice_axis,
                                (inner_axis,))
        return (out - want).abs().max().item()

    def step(carry):
        if carry is None:
            return contribution()
        return hierarchical_psum(contribution() + 1e-6 * carry, mesh,
                                 slice_axis, (inner_axis,)) + i

    k = mesh.shape.get(inner_axis, 1)
    s = mesh.shape.get(slice_axis, 1)
    data = m * n_elems * 4
    # reduce-scatter and all-gather inside the host on the full vector;
    # the cross-host all-reduce moves the 1/k chunk
    ici = 2 * (k - 1) / k * data if k > 1 else 0.0
    dcn = 2 * (s - 1) / s * (data / max(k, 1)) if s > 1 else 0.0
    moved = (ici + dcn) or 2 * (m - 1) / m * data
    from ..telemetry import get_registry

    reg = get_registry()
    if reg.enabled:
        with reg.span("hier_psum_probe", participants=m, ici_bytes=ici,
                      dcn_bytes=dcn, slices=s, inner=k):
            out = _run(mesh, verify, step, moved, m)
        reg.gauge("hier_psum_gibps").set(
            moved / max(out["seconds"], 1e-9) / (1 << 30))
    else:
        out = _run(mesh, verify, step, moved, m)
    out["ici_bytes"] = ici
    out["dcn_bytes"] = dcn
    return out


ALL_PROBES = {
    "psum": psum_probe,
    "all_gather": all_gather_probe,
    "reduce_scatter": reduce_scatter_probe,
    "ring_permute": ring_permute_probe,
    "all_to_all": all_to_all_probe,
}


# ---------------------------------------- tensor-parallel autograd pairs


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _Exit(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ``n`` members' ``x`` joined along ``dim``, in line order."""
    if group is None:
        return x
    return torch.cat(list(_all_gather(x, group, n).unbind(0)), dim=dim)


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dimension forward; backward keeps this
    member's slice (the gradient downstream is the same on every
    member)."""

    @staticmethod
    def forward(ctx, x, group, n, i):
        ctx.i, ctx.n = i, n
        return gather_dim(x, group, n, -1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.i].contiguous(), None, None, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` over a line whose members hold different
    rows of one tensor (a sequence over ``sp``); backward the
    reduce-scatter: every member's loss reads every row, so each member's
    slice of the gradient is summed over the line. (``_GatherLast`` keeps
    this member's slice instead: right for a ``tp`` line, whose members
    share one downstream gradient, wrong here.)"""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.stack(g.chunk(ctx.n, dim=ctx.dim))
        out = _reduce_scatter(parts.reshape(-1), ctx.group, ctx.n)
        return out.view(parts.shape[1:]), None, None, None


def gather_seq(x: torch.Tensor, group, n: int, dim: int = 1) -> torch.Tensor:
    """The ``n`` members' pieces of a sequence joined along ``dim``, in line
    order, with the reduce-scatter as its backward (``group`` None: ``x``
    itself)."""
    return x if group is None else _GatherSeq.apply(x, group, n, dim)


def _a2a_dims(x: torch.Tensor, group, n: int, split: int,
              concat: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)`` over ``group``: cut ``x``
    into ``n`` chunks along ``split``, send chunk ``j`` to member ``j``,
    and join the received chunks along ``concat`` in member order."""
    parts = torch.stack(x.chunk(n, dim=split))
    got = _all_to_all(parts, group)
    return torch.cat(list(got.unbind(0)), dim=concat)


class _AllToAll(torch.autograd.Function):
    """The all-to-all forward; backward its mirror (split and concat
    swapped), which is its transpose."""

    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.args = group, n, split, concat
        return _a2a_dims(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, n, split, concat = ctx.args
        return _a2a_dims(g, group, n, concat, split), None, None, None, None


def all_to_all_world(x: torch.Tensor, group, n: int, *, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """:func:`all_to_all` for one member of a world line (this rank's
    block in, its block out, ``all_to_all_single`` on the line's group),
    inside autograd; ``group`` None: ``x`` itself."""
    if group is None:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)


def enter_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a ``tp``-split region: ``x`` (the same on every member)
    forward; its gradient summed over the group backward. ``group`` None:
    ``x`` itself."""
    return x if group is None else _Enter.apply(x, group)


def exit_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a ``tp``-split region: the members' partial sums all-reduced
    forward; the gradient passed through backward."""
    return x if group is None else _Exit.apply(x, group)


def gather_last(x: torch.Tensor, group, n: int, i: int) -> torch.Tensor:
    """The members' ``x`` joined along the last dimension, in line order
    (this member's is piece ``i`` of ``n``)."""
    return x if group is None else _GatherLast.apply(x, group, n, i)


# ------------------------------------------ expert-parallel autograd pairs
#
# Over the data axes every rank holds tokens of its own, so each backward
# here is the forward's true transpose (the gradient of the sum of the
# data ranks' losses), where Megatron's ``f``/``g`` above take the one
# loss that a tp line shares.


def data_exclusive_counts(counts: torch.Tensor, group, n: int,
                          i: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(before, total)`` of an integer ``counts`` tensor (an MoE layer's
    ``[K, E]`` assignments) over the ``n`` members of a data line: the sum
    over the members ahead of this one (piece ``i``) in line order, and
    over all of them — one all-gather. ``group`` None: zeros and
    ``counts``."""
    if group is None:
        return torch.zeros_like(counts), counts
    every = _all_gather(counts, group, n)
    return (every[:i].sum(dim=0, dtype=counts.dtype),
            every.sum(dim=0, dtype=counts.dtype))


class _DataSum(torch.autograd.Function):
    """All-reduce forward; all-reduce backward (every member's loss reads
    the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _Dispatch(torch.autograd.Function):
    """``[E, ...]`` partial sums → this member's ``[E / n_ep, ...]`` summed
    over every data rank: a reduce-scatter over ``ep`` along the first
    dimension, then an all-reduce over the other data axes. Backward: the
    all-reduce, then an all-gather over ``ep``."""

    @staticmethod
    def forward(ctx, x, ep_group, n_ep, rest_group):
        ctx.groups = ep_group, n_ep, rest_group
        y = x.contiguous()
        if ep_group is not None:
            y = _reduce_scatter(y.view(-1), ep_group, n_ep).view(
                x.shape[0] // n_ep, *x.shape[1:])
        elif rest_group is not None:
            y = y.clone()
        return _all_reduce(y, rest_group)

    @staticmethod
    def backward(ctx, g):
        ep_group, n_ep, rest_group = ctx.groups
        g = g.contiguous()
        if rest_group is not None:
            g = _all_reduce(g.clone(), rest_group)
        if ep_group is not None:
            g = _all_gather(g, ep_group, n_ep).view(n_ep * g.shape[0],
                                                    *g.shape[1:])
        return g, None, None, None


class _GatherFirst(torch.autograd.Function):
    """All-gather along the first dimension over ``ep``; backward the
    reduce-scatter (each member's downstream gradient differs: its own
    tokens')."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_gather(x, group, n).view(n * x.shape[0], *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        out = _reduce_scatter(g.contiguous().view(-1), ctx.group, n)
        return out.view(g.shape[0] // n, *g.shape[1:]), None, None


def data_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over a data line, forward and backward (``group``
    None: ``x`` itself)."""
    return x if group is None else _DataSum.apply(x, group)


def dispatch_experts(x: torch.Tensor, ep_group, n_ep: int,
                     rest_group) -> torch.Tensor:
    """The MoE dispatch's partial expert batches ``[E, C, D]`` (this rank's
    tokens only) → this rank's experts' ``[E / n_ep, C, D]``, summed over
    every data rank (module comment above; both groups None: ``x``)."""
    if ep_group is None and rest_group is None:
        return x
    return _Dispatch.apply(x, ep_group, n_ep, rest_group)


def gather_experts(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every ``ep`` member's expert outputs ``[E / n, C, D]`` joined into
    ``[E, C, D]``, in line order (the MoE combine's input)."""
    return x if group is None else _GatherFirst.apply(x, group, n)
