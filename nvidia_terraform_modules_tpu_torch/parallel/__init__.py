# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The device mesh, its sharding rules and collectives: the one-process
mesh that the sequence-parallel (ring and Ulysses) attention runs on, and
the ``torch.distributed`` world — one process a device — with its
multi-host bootstrap, its multi-slice meshes, the timed collective probes
and the tensor-parallel pairs of the sharded train step."""

from .collectives import (
    ALL_PROBES,
    all_gather_probe,
    all_to_all,
    all_to_all_probe,
    hierarchical_psum,
    hierarchical_psum_probe,
    psum_probe,
    reduce_scatter_probe,
    ring_map,
    ring_permute,
    ring_permute_probe,
)
from .mesh import (
    Mesh,
    MeshPlan,
    WorldMesh,
    build_mesh,
    build_world_mesh,
    plan_mesh,
)
from .multihost import (
    DistributedInitError,
    JobEnv,
    job_env_from_environ,
    maybe_initialize_distributed,
)
from .multislice import (
    build_multislice_mesh,
    dcn_slice_count,
    group_devices_by_slice,
    plan_elastic_multislice,
    plan_multislice,
)
from .sharding import ShapeDtypeStruct, ShardingRules, local_shard, make_rules

__all__ = [
    "ALL_PROBES",
    "DistributedInitError",
    "JobEnv",
    "Mesh",
    "MeshPlan",
    "ShapeDtypeStruct",
    "ShardingRules",
    "WorldMesh",
    "all_gather_probe",
    "all_to_all",
    "all_to_all_probe",
    "build_mesh",
    "build_multislice_mesh",
    "build_world_mesh",
    "dcn_slice_count",
    "group_devices_by_slice",
    "hierarchical_psum",
    "hierarchical_psum_probe",
    "job_env_from_environ",
    "local_shard",
    "make_rules",
    "maybe_initialize_distributed",
    "plan_elastic_multislice",
    "plan_mesh",
    "plan_multislice",
    "psum_probe",
    "reduce_scatter_probe",
    "ring_map",
    "ring_permute",
    "ring_permute_probe",
]
