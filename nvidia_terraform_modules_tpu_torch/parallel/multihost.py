# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The ``torch.distributed`` world of the validation Job — the port of the
reference's ``parallel/multihost.py``.

One process drives one device (the PyTorch idiom): a host with ``k`` cards
runs ``k`` processes, rank ``host · k + local_rank``, each on
``cuda:LOCAL_RANK``. Two launch contracts are read:

- the reference's indexed Job (``gke-tpu``'s smoke-test template):
  ``TPU_SMOKETEST_HOSTS`` hosts, ``JOB_COMPLETION_INDEX`` (or
  ``TPU_WORKER_ID``) plus ``TPU_SMOKETEST_PROCESS_BASE`` the host's index,
  ``TPU_SMOKETEST_COORDINATOR`` (or the first of ``TPU_WORKER_HOSTNAMES``)
  the rendezvous, port 8476 unless one is given; one process a host
  unless ``LOCAL_WORLD_SIZE``/``LOCAL_RANK`` say more;
- torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.

:func:`maybe_initialize_distributed` brings the world up with
``torch.distributed.init_process_group``: NCCL on the card, gloo on the
CPU, bounded by ``TPU_SMOKETEST_INIT_TIMEOUT``. A process with none of
those variables is a world of one: it still creates its process group
(over an in-memory store, no port), so the backend — NCCL on the card —
comes up and every collective runs through it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import random
import socket
import sys
import time

import torch
import torch.distributed as dist

from ..utils.retry import RetryPolicy

COORDINATOR_PORT = 8476


class DistributedInitError(RuntimeError):
    """``torch.distributed.init_process_group`` could not assemble the
    world.

    Raised after the bounded retry budget with a diagnostic naming every
    fact an operator needs (who we are, who we dialled, how long we
    waited), instead of a half-scheduled multi-host Job hanging until
    something outside the process kills it.
    """


@dataclasses.dataclass(frozen=True)
class JobEnv:
    """Process-level facts of one rank of the world."""

    process_id: int              # the global rank
    num_processes: int           # the world size
    coordinator_address: str     # host:port of rank 0's store
    local_rank: int = 0          # this rank's device on its host

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def _address(host: str, port: str | int | None) -> str:
    if ":" in host:
        return host
    return f"{host}:{port or COORDINATOR_PORT}"


def job_env_from_environ(env: dict[str, str] | None = None) -> JobEnv | None:
    """Derive a :class:`JobEnv` from the launcher's variables (the module
    docstring's two contracts; torchrun's take precedence). Returns
    ``None`` for a world of one: a single process needs no rendezvous."""
    e = os.environ if env is None else env
    local_rank = int(e.get("LOCAL_RANK", "0"))
    if "WORLD_SIZE" in e:
        world = int(e["WORLD_SIZE"])
        if world <= 1:
            return None
        if "MASTER_ADDR" not in e:
            raise RuntimeError(
                f"torchrun world of {world} (WORLD_SIZE) but MASTER_ADDR is "
                f"not set")
        return JobEnv(process_id=int(e.get("RANK", "0")),
                      num_processes=world,
                      coordinator_address=_address(e["MASTER_ADDR"],
                                                   e.get("MASTER_PORT")),
                      local_rank=local_rank)
    hosts = int(e.get("TPU_SMOKETEST_HOSTS", "1"))
    if hosts <= 1:
        return None
    host = int(e.get("JOB_COMPLETION_INDEX", e.get("TPU_WORKER_ID", "0"))) + \
        int(e.get("TPU_SMOKETEST_PROCESS_BASE", "0"))
    coord = e.get("TPU_SMOKETEST_COORDINATOR", "")
    if not coord:
        hostnames = e.get("TPU_WORKER_HOSTNAMES", "")
        if not hostnames:
            raise RuntimeError(
                "multi-host run (TPU_SMOKETEST_HOSTS > 1) but neither "
                "TPU_SMOKETEST_COORDINATOR nor TPU_WORKER_HOSTNAMES is set"
            )
        coord = hostnames.split(",")[0].strip()
    local = int(e.get("LOCAL_WORLD_SIZE", "1"))
    return JobEnv(process_id=host * local + local_rank,
                  num_processes=hosts * local,
                  coordinator_address=_address(coord, None),
                  local_rank=local_rank)


def rank_device(job: JobEnv | None, platform: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` on the card, the CPU when
    ``platform`` is ``"cpu"``. With no card it raises — nothing selects
    the CPU on its own."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (set TPU_SMOKETEST_PLATFORM=cpu to "
            "run on the CPU over gloo)")
    return torch.device("cuda", job.local_rank if job else 0)


def maybe_initialize_distributed(env: dict[str, str] | None = None, *,
                                 device=None) -> JobEnv | None:
    """Bring up the ``torch.distributed`` world (module docstring) on
    ``device`` (default: this rank's card) unless a process group is up
    already, and return the :class:`JobEnv` (``None`` for a world of one).

    Bounded and classified, never hanging: ``TPU_SMOKETEST_INIT_TIMEOUT``
    (seconds, default 300) is the TOTAL budget for assembling the world.
    Non-coordinators first run a TCP pre-flight against rank 0's store
    (capped at ``TPU_SMOKETEST_INIT_PREFLIGHT``, default 60 s, never more
    than half the budget) with capped exponential backoff and jitter
    (``utils/retry.py``), raising :class:`DistributedInitError` with a full
    diagnostic when rank 0 is unreachable. The rest of the budget bounds
    the rendezvous itself (a peer that never arrives) and every later
    collective."""
    e = os.environ if env is None else env
    job = job_env_from_environ(e)
    if dist.is_initialized():
        return job
    dev = torch.device(device) if device is not None else rank_device(
        job, "cuda")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev      # the communicator comes up eagerly
    timeout = int(e.get("TPU_SMOKETEST_INIT_TIMEOUT", "300"))
    if job is None:
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        return None
    preflight_budget = min(
        timeout / 2.0,
        float(e.get("TPU_SMOKETEST_INIT_PREFLIGHT", "60")))
    remaining = timeout
    if not job.is_coordinator:
        remaining -= _preflight_coordinator(job, preflight_budget)
    print(
        f"smoketest: joining the {backend} world as rank "
        f"{job.process_id}/{job.num_processes} via "
        f"{job.coordinator_address} (timeout {int(remaining)}s)",
        file=sys.stderr, flush=True)
    budget = datetime.timedelta(seconds=max(1, int(remaining)))
    host, _, port = job.coordinator_address.rpartition(":")
    # rank 0 hosts the store, unless torchrun's agent already does
    serve = job.is_coordinator and e.get(
        "TORCHELASTIC_USE_AGENT_STORE") != "True"
    try:
        store = dist.TCPStore(host, int(port), job.num_processes,
                              is_master=serve, timeout=budget)
        dist.init_process_group(
            backend, store=store, rank=job.process_id,
            world_size=job.num_processes, timeout=budget, **kw)
    except (RuntimeError, OSError) as exc:   # the store's own timeout
        raise DistributedInitError(
            f"multi-host world never assembled: rank "
            f"{job.process_id}/{job.num_processes} reached no full world "
            f"at {job.coordinator_address} within {int(remaining)}s. "
            f"Check that every pod of the indexed Job scheduled (kubectl "
            f"get pods -l smoketest-group) and that TPU_SMOKETEST_HOSTS "
            f"matches the Job's completions. Last error: {exc}") from exc
    return job


def _preflight_coordinator(job: JobEnv, budget_s: float) -> float:
    """Bounded, classified wait for rank 0's store to be dialable: a plain
    TCP connect probe with capped exponential backoff and jitter under a
    hard wall-clock deadline, so a never-assembling world (pod 0
    unscheduled, the headless Service's DNS not propagated, a mistyped
    address) fails with a :class:`DistributedInitError` naming every
    relevant fact. Returns the seconds spent, so the caller hands the rest
    of the budget to the rendezvous."""
    host, _, port = job.coordinator_address.rpartition(":")
    t0 = time.monotonic()
    deadline = t0 + budget_s
    # string-seeded jitter: deterministic per target, decorrelated across
    # targets
    delays = RetryPolicy(initial_s=1.0, multiplier=2.0, cap_s=15.0,
                         max_attempts=10_000).delays(
                             random.Random(f"preflight-{host}:{port}"))
    attempt = 0
    last: Exception | None = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        attempt += 1
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=min(5.0, remaining)):
                return time.monotonic() - t0
        except OSError as exc:
            last = exc
        delay = next(delays, 0.0)
        if time.monotonic() + delay >= deadline:
            break
        time.sleep(delay)
    raise DistributedInitError(
        f"multi-host world never assembled: process "
        f"{job.process_id}/{job.num_processes} could not reach the "
        f"coordinator at {job.coordinator_address} after {attempt} "
        f"attempt(s) over {time.monotonic() - t0:.0f}s (pre-flight "
        f"budget {budget_s:.0f}s). Check that pod 0 of the indexed Job "
        f"scheduled (kubectl get pods -l smoketest-group), that the "
        f"headless Service resolves its hostname, and that "
        f"TPU_SMOKETEST_HOSTS matches the Job's completions. Last "
        f"error: {last}")
