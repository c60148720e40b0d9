# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Multi-slice meshes: data parallelism across slices, model axes inside
one — the port of the reference's ``parallel/multislice.py``.

On TPUs a slice is a group of chips joined by ICI, and slices talk over
the data-center network. On GPUs a slice is a host: its cards share
NVLink, hosts share the network. The plan is the reference's 4-axis mesh
``("slice", "dp", "sp", "tp")``, ``slice`` outermost, so on a
:class:`WorldMesh` a slice is a run of contiguous ranks — one host's, under
``parallel/multihost.py``'s numbering. :func:`plan_multislice`,
:func:`plan_elastic_multislice` and :func:`group_devices_by_slice` are
pure copies of the reference's.
"""

from __future__ import annotations

import collections
import os
from typing import Sequence

import numpy as np

from .mesh import Mesh, MeshPlan, build_world_mesh, plan_mesh


def plan_multislice(
    n_devices: int,
    n_slices: int,
    *,
    tp: int | None = None,
    sp: int = 1,
) -> MeshPlan:
    """Factorise ``n_devices`` over ``n_slices`` groups × (dp, sp, tp) inside
    each (:func:`plan_mesh`, so tp stays innermost); ``slice`` is outermost
    — the only axis whose collectives cross between hosts."""
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if n_devices % n_slices:
        raise ValueError(
            f"{n_slices} slices do not evenly divide {n_devices} devices")
    per = plan_mesh(n_devices // n_slices, tp=tp, sp=sp)
    return MeshPlan(("slice",) + per.axis_names, (n_slices,) + per.shape)


def plan_elastic_multislice(
    n_devices: int,
    preferred_slices: int,
    *,
    tp: int | None = None,
    sp: int = 1,
) -> MeshPlan:
    """The planner for a world whose size changed between resumes: the
    largest slice count ≤ ``preferred_slices`` that divides the surviving
    device count and factorises (:func:`plan_multislice`), down to a
    single-slice plan — so the 4-axis mesh keeps its structure at every
    world size."""
    if preferred_slices < 1:
        raise ValueError(
            f"preferred_slices must be >= 1, got {preferred_slices}")
    last_err: Exception | None = None
    for s in range(min(preferred_slices, n_devices), 0, -1):
        if n_devices % s:
            continue
        try:
            return plan_multislice(n_devices, s, tp=tp, sp=sp)
        except ValueError as exc:   # per-slice factorisation infeasible
            last_err = exc
    raise ValueError(
        f"no slice count in [1, {preferred_slices}] factorises "
        f"{n_devices} devices (tp={tp}, sp={sp}): {last_err}")


def group_devices_by_slice(devices: Sequence, n_slices: int) -> list[list]:
    """Order devices slice-major: a device's ``slice_index`` where every
    device has one, else contiguous chunks."""
    if n_slices == 1:
        return [list(devices)]
    indices = [getattr(d, "slice_index", None) for d in devices]
    if all(i is not None for i in indices):
        groups: dict[int, list] = collections.defaultdict(list)
        for d, i in zip(devices, indices):
            groups[i].append(d)
        if len(groups) != n_slices:
            raise ValueError(
                f"devices report {len(groups)} distinct slice_index values, "
                f"expected {n_slices}")
        sizes = {len(g) for g in groups.values()}
        if len(sizes) != 1:
            raise ValueError(f"uneven slices: sizes {sorted(sizes)}")
        return [groups[i] for i in sorted(groups)]
    if len(devices) % n_slices:
        raise ValueError(
            f"{n_slices} slices do not evenly divide {len(devices)} devices")
    per = len(devices) // n_slices
    return [list(devices[i * per:(i + 1) * per]) for i in range(n_slices)]


def build_multislice_mesh(plan: MeshPlan | None = None, *,
                          n_slices: int | None = None, devices=None):
    """The 4-axis mesh, slice-major. With ``devices``: a one-process
    :class:`Mesh` over them (grouped by :func:`group_devices_by_slice`);
    without: the :class:`WorldMesh` over the ranks of the process group,
    whose contiguous ranks are a host's. Give ``plan`` (from
    :func:`plan_multislice`) or ``n_slices``."""
    if plan is None:
        if n_slices is None:
            raise ValueError("pass plan= or n_slices=")
        if devices is None:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError("build_multislice_mesh: no process group "
                                   "is up (pass devices=)")
            count = dist.get_world_size()
        else:
            count = len(devices)
        plan = plan_multislice(count, n_slices)
    if plan.axis_names[0] != "slice":
        raise ValueError(f"not a multislice plan: axes {plan.axis_names}")
    if devices is None:
        return build_world_mesh(plan)
    if plan.n_devices != len(devices):
        raise ValueError(
            f"plan wants {plan.n_devices} devices, got {len(devices)}")
    per_shape = plan.shape[1:]
    groups = group_devices_by_slice(list(devices), plan.shape[0])
    slabs = []
    for g in groups:
        arr = np.empty(len(g), dtype=object)
        arr[:] = g
        slabs.append(arr.reshape(per_shape))
    return Mesh(np.stack(slabs), tuple(plan.axis_names))


def dcn_slice_count(env: dict[str, str] | None = None) -> int:
    """How many slices (hosts) the world spans: ``TPU_SMOKETEST_SLICES``
    when set, else the world size over ``LOCAL_WORLD_SIZE`` (default 1:
    one rank a host, the indexed Job's layout). The world size is the
    process group's, else ``WORLD_SIZE``, else 1."""
    e = os.environ if env is None else env
    explicit = int(e.get("TPU_SMOKETEST_SLICES", "0"))
    if explicit:
        return explicit
    import torch.distributed as dist

    world = (dist.get_world_size() if dist.is_initialized()
             else int(e.get("WORLD_SIZE", "1")))
    local = int(e.get("LOCAL_WORLD_SIZE", "1"))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE = {local} does not divide the "
                         f"world of {world}")
    return max(world // local, 1)
