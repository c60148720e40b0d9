# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The device mesh, its sharding rules and collectives: the one-process
mesh that the sequence-parallel (ring and Ulysses) attention runs on, and
the ``torch.distributed`` world — one process a device — with its
multi-host bootstrap, its multi-slice meshes, the timed collective probes,
the tensor-parallel pairs of the sharded train step and the world's
directed hop, sequence gather and all-to-all inside autograd; and the
pipeline (GPipe and 1F1B over a ``pp`` axis) on either."""

from .collectives import (
    ALL_PROBES,
    all_gather_probe,
    all_to_all,
    all_to_all_probe,
    all_to_all_world,
    exchange,
    gather_seq,
    hierarchical_psum,
    hierarchical_psum_probe,
    hop,
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
from .pipeline import (
    SCHEDULES,
    PipelineConfig,
    gather_pipeline_params,
    init_pipeline_params,
    make_pipeline_train_step,
    pipeline_loss_fn,
    pipeline_value_and_grad_1f1b,
    place_pipeline_params,
    reference_loss_fn,
    stack_sharding,
)
from .sharding import ShapeDtypeStruct, ShardingRules, local_shard, make_rules

__all__ = [
    "ALL_PROBES",
    "DistributedInitError",
    "JobEnv",
    "Mesh",
    "MeshPlan",
    "PipelineConfig",
    "SCHEDULES",
    "ShapeDtypeStruct",
    "ShardingRules",
    "WorldMesh",
    "all_gather_probe",
    "all_to_all",
    "all_to_all_probe",
    "all_to_all_world",
    "build_mesh",
    "build_multislice_mesh",
    "build_world_mesh",
    "dcn_slice_count",
    "exchange",
    "gather_pipeline_params",
    "gather_seq",
    "group_devices_by_slice",
    "hierarchical_psum",
    "hierarchical_psum_probe",
    "hop",
    "init_pipeline_params",
    "job_env_from_environ",
    "local_shard",
    "make_pipeline_train_step",
    "make_rules",
    "maybe_initialize_distributed",
    "pipeline_loss_fn",
    "pipeline_value_and_grad_1f1b",
    "place_pipeline_params",
    "plan_elastic_multislice",
    "plan_mesh",
    "plan_multislice",
    "psum_probe",
    "reduce_scatter_probe",
    "reference_loss_fn",
    "ring_map",
    "ring_permute",
    "ring_permute_probe",
    "stack_sharding",
]
