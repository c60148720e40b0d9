# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Device-mesh planning — the port of the reference's ``parallel/mesh.py``.

The visible devices fold into a logical mesh with named axes:

- ``dp`` — data parallel;
- ``tp`` — tensor / model parallel;
- ``sp`` — sequence / context parallel (ring and Ulysses attention);
- ``ep`` — expert parallel, present only when requested (``ep > 1``).

:class:`MeshPlan` and :func:`plan_mesh` are a pure copy of the reference's.
:func:`build_mesh` returns a :class:`Mesh`: an ``np.ndarray`` of
``torch.device`` of the plan's shape, with the axis names, and
``mesh.shape[axis]`` as JAX's mesh has it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


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


def build_mesh(plan: MeshPlan | None = None, *, devices=None) -> Mesh:
    """A :class:`Mesh` for ``plan`` (default: :func:`plan_mesh` of the
    device count) over ``devices``, reshaped in order.

    ``devices`` defaults to every visible CUDA device; with no card that
    raises — it never falls back to the CPU. An explicit list may name one
    device more than once: ``[torch.device("cpu")] * n`` is the CPU tests'
    mesh of ``n`` (the counterpart of the JAX test rig's virtual host
    devices), and ``[torch.device("cuda", 0)] * 4`` runs a ring of 4 on
    one card, each position a distinct member of the ring on the same
    device."""
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
