# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the world's bootstrap (``parallel/multihost.py``) and the
multi-slice planning (``parallel/multislice.py``) against the JAX
reference's: the Job contract's cases parse to the same process id, world
size and coordinator; torchrun's variables parse too; an unreachable
coordinator fails as a classified ``DistributedInitError`` within its
pre-flight budget; a process with no launcher variables comes up as a
world of one; the planners agree with the reference's."""

import time

import pytest
import torch
import torch.distributed as dist

from nvidia_terraform_modules_tpu.parallel import multihost as jmultihost
from nvidia_terraform_modules_tpu.parallel import multislice as jmultislice
from nvidia_terraform_modules_tpu_torch.parallel import (
    DistributedInitError,
    dcn_slice_count,
    group_devices_by_slice,
    job_env_from_environ,
    maybe_initialize_distributed,
    plan_elastic_multislice,
    plan_multislice,
)
from nvidia_terraform_modules_tpu_torch.parallel.multihost import (
    COORDINATOR_PORT,
    rank_device,
)

JOB_CASES = {
    "single_host": {},
    "one_host": {"TPU_SMOKETEST_HOSTS": "1"},
    "indexed_job": {"TPU_SMOKETEST_HOSTS": "2", "JOB_COMPLETION_INDEX": "1",
                    "TPU_SMOKETEST_COORDINATOR":
                        "tpu-smoketest-0.tpu-smoketest"},
    "explicit_port": {"TPU_SMOKETEST_HOSTS": "4",
                      "JOB_COMPLETION_INDEX": "0",
                      "TPU_SMOKETEST_COORDINATOR": "coord:1234"},
    "worker_hostnames": {"TPU_SMOKETEST_HOSTS": "2", "TPU_WORKER_ID": "1",
                         "TPU_WORKER_HOSTNAMES": "host-a, host-b"},
    "process_base": {"TPU_SMOKETEST_HOSTS": "4", "JOB_COMPLETION_INDEX": "1",
                     "TPU_SMOKETEST_PROCESS_BASE": "2",
                     "TPU_SMOKETEST_COORDINATOR": "c"},
}


@pytest.mark.parametrize("case", sorted(JOB_CASES))
def test_job_contract_matches_reference(case):
    env = JOB_CASES[case]
    want = jmultihost.job_env_from_environ(env)
    got = job_env_from_environ(env)
    if want is None:
        assert got is None
        return
    assert (got.process_id, got.num_processes, got.coordinator_address,
            got.is_coordinator) == (want.process_id, want.num_processes,
                                    want.coordinator_address,
                                    want.is_coordinator)
    assert got.local_rank == 0


def test_default_port_is_the_reference_s():
    assert COORDINATOR_PORT == jmultihost.COORDINATOR_PORT == 8476


def test_missing_coordinator_raises():
    for fn in (jmultihost.job_env_from_environ, job_env_from_environ):
        with pytest.raises(RuntimeError, match="TPU_SMOKETEST_COORDINATOR"):
            fn({"TPU_SMOKETEST_HOSTS": "2"})


def test_torchrun_variables():
    env = {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
           "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "node-0",
           "MASTER_PORT": "29500"}
    job = job_env_from_environ(env)
    assert (job.process_id, job.num_processes, job.coordinator_address,
            job.local_rank) == (5, 8, "node-0:29500", 1)
    assert job_env_from_environ({**env, "WORLD_SIZE": "1"}) is None
    no_port = {k: v for k, v in env.items() if k != "MASTER_PORT"}
    assert job_env_from_environ(no_port).coordinator_address == \
        f"node-0:{COORDINATOR_PORT}"
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        job_env_from_environ({"WORLD_SIZE": "2", "RANK": "0"})


def test_job_contract_with_several_devices_a_host():
    """One process a device: host h's local rank l is rank h·k + l."""
    job = job_env_from_environ({
        "TPU_SMOKETEST_HOSTS": "2", "JOB_COMPLETION_INDEX": "1",
        "LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3",
        "TPU_SMOKETEST_COORDINATOR": "c"})
    assert (job.process_id, job.num_processes, job.local_rank) == (7, 8, 3)


def test_unreachable_coordinator_is_bounded_and_classified():
    """A rank that can never reach rank 0 fails as a classified
    DistributedInitError inside its pre-flight budget, before any process
    group is touched."""
    env = {
        "TPU_SMOKETEST_HOSTS": "2",
        "JOB_COMPLETION_INDEX": "1",
        # a port nothing listens on: connection refused, immediately
        "TPU_SMOKETEST_COORDINATOR": "localhost:9",
        "TPU_SMOKETEST_INIT_TIMEOUT": "20",
        "TPU_SMOKETEST_INIT_PREFLIGHT": "6",
    }
    t0 = time.monotonic()
    with pytest.raises(DistributedInitError) as ei:
        maybe_initialize_distributed(env, device="cpu")
    assert time.monotonic() - t0 < 20
    assert not dist.is_initialized()
    msg = str(ei.value)
    assert "process 1/2" in msg
    assert "localhost:9" in msg
    assert "attempt(s)" in msg          # the retry policy ran
    assert "headless Service" in msg    # operator-actionable diagnostic


def test_no_launcher_variables_is_a_world_of_one():
    assert maybe_initialize_distributed({}, device="cpu") is None
    try:
        assert dist.is_initialized()
        assert (dist.get_world_size(), dist.get_rank(),
                dist.get_backend()) == (1, 0, "gloo")
        x = torch.ones(3)
        dist.all_reduce(x)
        assert torch.equal(x, torch.ones(3))
        # a second call finds the world up and leaves it as it is
        assert maybe_initialize_distributed({}, device="cpu") is None
    finally:
        dist.destroy_process_group()


def test_rank_device_never_falls_back_to_the_cpu():
    assert rank_device(None, "cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert rank_device(None, "cuda") == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device(None, "cuda")


def _fields(plan):
    return plan.axis_names, plan.shape


@pytest.mark.parametrize("n, slices, kw", [
    (8, 2, {}), (8, 4, {}), (16, 2, dict(tp=2)), (8, 2, dict(sp=2)),
    (4, 1, {})])
def test_plan_multislice_matches_reference(n, slices, kw):
    assert _fields(plan_multislice(n, slices, **kw)) == \
        _fields(jmultislice.plan_multislice(n, slices, **kw))


@pytest.mark.parametrize("n, preferred", [(8, 4), (6, 4), (7, 3), (12, 5)])
def test_plan_elastic_multislice_matches_reference(n, preferred):
    assert _fields(plan_elastic_multislice(n, preferred)) == \
        _fields(jmultislice.plan_elastic_multislice(n, preferred))


def test_group_devices_by_slice_matches_reference():
    devices = list(range(8))
    for s in (1, 2, 4):
        assert group_devices_by_slice(devices, s) == \
            jmultislice.group_devices_by_slice(devices, s)
    with pytest.raises(ValueError, match="do not evenly divide"):
        group_devices_by_slice(devices, 3)


def test_dcn_slice_count_reads_the_hosts():
    assert dcn_slice_count({}) == 1
    assert dcn_slice_count({"TPU_SMOKETEST_SLICES": "3"}) == 3
    # a host is a slice: 8 ranks of 4 devices a host are 2 slices
    assert dcn_slice_count({"WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "4"}) == 2
    assert dcn_slice_count({"WORLD_SIZE": "2"}) == 2
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
        dcn_slice_count({"WORLD_SIZE": "6", "LOCAL_WORLD_SIZE": "4"})
