# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Device-mesh planning — the port of the reference's ``parallel/mesh.py``.

The visible devices fold into a logical mesh with named axes:

- ``dp`` — data parallel;
- ``tp`` — tensor / model parallel;
- ``sp`` — sequence / context parallel (ring and Ulysses attention);
- ``ep`` — expert parallel, present only when requested (``ep > 1``).

:class:`MeshPlan` and :func:`plan_mesh` are a pure copy of the reference's.
:func:`build_mesh` returns one of two meshes, each with the axis names and
``mesh.shape[axis]`` as JAX's mesh has it:

- a :class:`Mesh` — an ``np.ndarray`` of ``torch.device`` of the plan's
  shape, stepped by ONE process (the sequence-parallel ring and Ulysses of
  ``ops/``); ``devices=[...]`` builds it;
- a :class:`WorldMesh` — the ranks of the ``torch.distributed`` world
  (one process, one device a rank; ``parallel/multihost.py``) in the
  plan's shape, with a process group for each line of each axis (and of
  each set of axes) through this rank: the data- and tensor-parallel
  paths and the probes run on it. ``build_mesh()`` builds it whenever a
  process group is up.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A named logical mesh shape over ``n_devices`` devices."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def describe(self) -> str:
        return " × ".join(f"{n}:{s}" for n, s in zip(self.axis_names,
                                                     self.shape))


def plan_mesh(
    n_devices: int,
    *,
    tp: int | None = None,
    sp: int = 1,
    ep: int = 1,
    axis_names: Sequence[str] | None = None,
) -> MeshPlan:
    """Choose a (dp[, ep], sp, tp) factorisation of ``n_devices``.

    ``tp`` defaults to the largest power of two <= 4 dividing the device
    count; ``ep > 1`` inserts an expert axis between dp and sp (axes
    ``("dp", "ep", "sp", "tp")``)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if ep < 1 or n_devices % (sp * ep) != 0:
        raise ValueError(
            f"ep*sp = {ep}*{sp} does not divide device count {n_devices}")
    if tp is None:
        tp = 1
        while tp < 4 and n_devices % (tp * 2 * sp * ep) == 0:
            tp *= 2
    if n_devices % (tp * sp * ep) != 0:
        raise ValueError(
            f"tp*sp*ep = {tp}*{sp}*{ep} does not divide device count "
            f"{n_devices}"
        )
    dp = n_devices // (tp * sp * ep)
    shape = (dp, ep, sp, tp) if ep > 1 else (dp, sp, tp)
    names = tuple(axis_names) if axis_names is not None else (
        ("dp", "ep", "sp", "tp") if ep > 1 else ("dp", "sp", "tp"))
    if len(names) != len(shape):
        raise ValueError(
            f"axis_names {names} has {len(names)} names for a "
            f"{len(shape)}-axis mesh {shape} (ep > 1 adds an axis)")
    return MeshPlan(names, shape)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an ``np.ndarray`` (dtype object) of ``torch.device``
    with one dimension per name of ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device_at(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (axes left out: 0)."""
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]


@dataclasses.dataclass(frozen=True, eq=False)
class WorldMesh:
    """The ranks of the ``torch.distributed`` world in a plan's shape, seen
    from this rank. ``ranks``: an ``np.ndarray`` of global ranks, row-major
    (rank ``r`` at the ``r``-th coordinate, so the outermost axis groups
    contiguous ranks: a host's, under ``parallel/multihost.py``'s
    numbering); ``device``: this rank's device. :meth:`group` is the
    process group of this rank's line along a set of axes; every rank
    created every group, in the same order, when the mesh was built."""

    ranks: np.ndarray
    axis_names: tuple[str, ...]
    rank: int
    device: torch.device
    groups: dict = dataclasses.field(repr=False)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis."""
        where = np.argwhere(self.ranks == self.rank)[0]
        return dict(zip(self.axis_names, (int(i) for i in where)))

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """The number of ranks on a line along ``axes`` (a name or names)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's position on its line along ``axes``: the row-major
        index of its coordinates there (the rank within :meth:`group`)."""
        axes = self._axes(axes)
        c = self.coords
        return int(np.ravel_multi_index([c[a] for a in axes],
                                        [self.shape[a] for a in axes])
                   ) if axes else 0

    def line(self, axes) -> list[int]:
        """The global ranks of this rank's line along ``axes``, in line
        order."""
        axes = self._axes(axes)
        c = self.coords
        sel = tuple(slice(None) if a in axes else c[a]
                    for a in self.axis_names)
        return [int(r) for r in self.ranks[sel].reshape(-1)]

    def group(self, axes):
        """The process group of this rank's line along ``axes``; ``None``
        when the line is this rank alone (a collective there is the
        identity, and none is launched)."""
        key = tuple(a for a in self._axes(axes) if self.shape[a] > 1)
        if not key:
            return None
        return self.groups[key]


def build_world_mesh(plan: MeshPlan | None = None, *,
                     subset: bool = False) -> WorldMesh | None:
    """A :class:`WorldMesh` for ``plan`` (default: :func:`plan_mesh` of the
    world size) over the initialised process group. Creates a group for
    every line along every set of the plan's axes of size above one (a
    line that spans the world is the world's own group); every rank must
    call this, in the same order as its peers. ``subset=True`` lets a plan
    smaller than the world take its first ``plan.n_devices`` ranks (the
    reference's ``devices=jax.devices()[:k]``): a rank outside it gets
    ``None``, after making the groups with the others."""
    if not dist.is_initialized():
        raise RuntimeError("build_world_mesh: no torch.distributed process "
                           "group is up (parallel.maybe_initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if plan is None:
        plan = plan_mesh(world)
    if plan.n_devices != world and not (subset and plan.n_devices < world):
        raise ValueError(
            f"plan wants {plan.n_devices} devices, the world has {world}")
    ranks = np.arange(plan.n_devices).reshape(plan.shape)
    big = [a for a, n in zip(plan.axis_names, plan.shape) if n > 1]
    groups = {}
    for k in range(1, len(big) + 1):
        for axes in itertools.combinations(big, k):
            keep = [plan.axis_names.index(a) for a in axes]
            moved = np.moveaxis(ranks, keep, list(range(-k, 0)))
            lines = moved.reshape(-1, math.prod(moved.shape[-k:]))
            for members in lines.tolist():
                if len(members) == world:
                    grp = dist.group.WORLD
                else:                       # a collective call: all ranks
                    grp = dist.new_group(members)
                if rank in members:
                    groups[axes] = grp
    if rank >= plan.n_devices:
        return None
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return WorldMesh(ranks, tuple(plan.axis_names), rank, device, groups)


def build_mesh(plan: MeshPlan | None = None, *, devices=None):
    """A :class:`Mesh` for ``plan`` (default: :func:`plan_mesh` of the
    device count) over ``devices``, reshaped in order; with no ``devices``
    and a ``torch.distributed`` process group up, the
    :class:`WorldMesh` over its ranks (:func:`build_world_mesh`).

    ``devices`` defaults to every visible CUDA device; with no card that
    raises — it never falls back to the CPU. An explicit list may name one
    device more than once: ``[torch.device("cpu")] * n`` is the CPU tests'
    mesh of ``n`` (the counterpart of the JAX test rig's virtual host
    devices), and ``[torch.device("cuda", 0)] * 4`` runs a ring of 4 on
    one card, each position a distinct member of the ring on the same
    device."""
    if devices is None and dist.is_initialized():
        return build_world_mesh(plan)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_mesh: no CUDA device is available "
                               "(pass devices= to build a mesh of others)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if plan is None:
        plan = plan_mesh(len(devices))
    if plan.n_devices != len(devices):
        raise ValueError(
            f"plan wants {plan.n_devices} devices, got {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(plan.shape), tuple(plan.axis_names))
