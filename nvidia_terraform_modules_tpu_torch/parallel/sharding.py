# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Named sharding rules for the burn-in workload — the port of the
reference's ``parallel/sharding.py``.

Logical tensor dimensions map onto mesh axes once, here. A spec is a plain
tuple (the port has no ``PartitionSpec``): one entry per dimension, each
``None`` (not split), an axis name, or a tuple of axis names. The ring and
Ulysses attention wrappers read the activation specs to cut ``[B, S, H,
D]`` tensors into per-device shards.

Not ported yet (ROADMAP Queue A item 6): the parameter specs (``embed``,
``attn_qkv``, ``mlp_up``, the MoE specs, ...) with ``shard`` /
``param_sharding``, which place parameters over dp/tp; they come with the
code that reads them.
"""

from __future__ import annotations

import dataclasses

from .mesh import Mesh


def pspec_axes(axes):
    """A 1-tuple of axis names becomes the bare name (the reference's
    ``utils/compat.pspec_axes``)."""
    if isinstance(axes, (tuple, list)) and len(axes) == 1:
        return axes[0]
    return axes


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The mesh and the activation specs of the burn-in model."""

    mesh: Mesh
    # mesh axes carrying the batch dimension: ("dp",), ("slice", "dp"),
    # or ("dp", "ep")
    data: tuple[str, ...] = ("dp",)

    def act(self, *rest) -> tuple:
        """Activation spec: batch over the data axes, then ``rest`` dims."""
        return (pspec_axes(self.data), *rest)


def make_rules(mesh: Mesh) -> ShardingRules:
    data: tuple[str, ...] = (
        ("slice",) if "slice" in mesh.axis_names else ())
    data += ("dp",)
    if "ep" in mesh.axis_names:
        data += ("ep",)
    return ShardingRules(mesh=mesh, data=data)
