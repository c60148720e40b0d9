# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The device mesh, its sharding rules and the collectives over one axis
that the sequence-parallel (ring and Ulysses) attention runs on."""

from .collectives import all_to_all, ring_map, ring_permute
from .mesh import Mesh, MeshPlan, build_mesh, plan_mesh
from .sharding import ShardingRules, make_rules

__all__ = [
    "Mesh",
    "MeshPlan",
    "ShardingRules",
    "all_to_all",
    "build_mesh",
    "make_rules",
    "plan_mesh",
    "ring_map",
    "ring_permute",
]
