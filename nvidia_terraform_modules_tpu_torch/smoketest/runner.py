# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The validation Job's payload — the port of the reference's
``smoketest/runner.py``: after ``terraform apply``, a Job runs this on every
rank of the pool and asserts

1. the expected number of devices joined the world;
2. an all-reduce over all of them returns the participant count;

and, at deeper levels,

3. the collective probes on every mesh axis pass and report bandwidth;
4. a few steps of the sharded burn-in transformer lower the loss, and the
   serve shapes (greedy decode, the paged engine, its scheduler levers,
   the paged decode kernel) are exact on the same pool.

Output is ONE JSON line a host (its local rank 0 prints it:
``__main__.py``); exit 0 iff every check passed. Each rank runs on its
own device (``parallel/multihost.py``), and every leg's verdict is ANDed
over the world, so one rank's failure fails every host's line. A leg
whose module the port has not reached is not run and not counted: it is
listed under ``"not_ported"`` with the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..models import (
    BurnInConfig,
    forward,
    gather_params,
    greedy_decode,
    init_params,
    instrument_step,
    make_serve_engine,
    make_train_step,
    synthetic_batch,
)
from ..ops import _build
from ..parallel import (
    ALL_PROBES,
    build_mesh,
    build_multislice_mesh,
    dcn_slice_count,
    hierarchical_psum_probe,
    job_env_from_environ,
    make_rules,
    maybe_initialize_distributed,
    plan_mesh,
    plan_multislice,
    psum_probe,
)
from ..parallel.collectives import world_max
from ..parallel.multihost import rank_device
from ..telemetry import get_registry
from ..utils.traffic import shared_prefix_prompts

LEVELS = ("psum", "probes", "burnin", "full")

_FLEET = "ROADMAP Queue A item 9"
# legs of the reference's runner that this port does not run yet: key →
# (the levels it belongs to, where it is queued)
NOT_PORTED = {
    "lint_runtime_ok": (LEVELS, "not queued (graftlint reads the JAX "
                                "runtime's source)"),
    "flash_pipeline_ok": (("burnin", "full"),
                          "not queued (the port's kernels have no "
                          "pipeline keyword)"),
    "serve_fleet_ok": (("burnin", "full"), _FLEET),
    "fleet_chaos_ok": (("burnin", "full"), _FLEET),
    "kv_spill_ok": (("burnin", "full"), _FLEET),
    "fleet_scale_ok": (("burnin", "full"), _FLEET),
    "aot_warm_ok": (("burnin", "full"), _FLEET),
    "prefix_cdn_ok": (("burnin", "full"), _FLEET),
    "all_to_all_ep_ok": (("full",), "ROADMAP Queue A item 6"),
    "moe_ok": (("full",), "ROADMAP Queue A item 6"),
    "pipeline_ok": (("full",), "ROADMAP Queue A item 8"),
    "serving_ok": (("full",), "ROADMAP Queue A item 6"),
}


@dataclasses.dataclass
class SmokeResult:
    ok: bool
    checks: dict[str, Any]
    seconds: float

    def to_json(self) -> str:
        return json.dumps(
            {"ok": self.ok, "seconds": round(self.seconds, 3), **self.checks}
        )


def run_smoketest(
    expected_devices: int | None = None,
    level: str = "probes",
    env: dict[str, str] | None = None,
) -> SmokeResult:
    """Run the validation suite (telemetry-exporting wrapper): with
    ``TPU_TELEMETRY_DIR`` set (or a registry injected through
    ``telemetry.set_registry``) the instrumented layers' spans and metrics
    are exported after the suite, whatever its verdict; their paths ride
    the JSON line under ``"telemetry"``."""
    result = _run_smoketest(expected_devices, level, env)
    reg = get_registry()
    if reg.enabled:
        try:
            result.checks["telemetry"] = reg.export()
        except (OSError, ValueError) as exc:
            # observability must never fail the validation verdict
            result.checks["telemetry_error"] = str(exc)
    return result


def _run_smoketest(
    expected_devices: int | None = None,
    level: str = "probes",
    env: dict[str, str] | None = None,
) -> SmokeResult:
    """Run the validation suite at ``level`` ∈ {"psum", "probes",
    "burnin", "full"}, each a superset of the previous, on the card
    (``TPU_SMOKETEST_PLATFORM=cpu``: the CPU, over gloo). Brings up the
    ``torch.distributed`` world unless a process group is up already (and
    then takes it down again at the end)."""
    if level not in LEVELS:
        raise ValueError(
            f"unknown smoke-test level {level!r}: expected "
            f"psum|probes|burnin|full"
        )
    e = os.environ if env is None else env
    t0 = time.perf_counter()
    platform = "cpu" if e.get("TPU_SMOKETEST_PLATFORM", "").lower() == \
        "cpu" else "cuda"
    dev = rank_device(job_env_from_environ(e), platform)
    owned = not dist.is_initialized()
    job = maybe_initialize_distributed(e, device=dev)
    try:
        ok, checks = _suite(expected_devices, level, e, job, dev)
    finally:
        if owned:
            dist.destroy_process_group()
    return SmokeResult(bool(ok), checks, time.perf_counter() - t0)


def _suite(expected_devices, level, e, job, dev) -> tuple[bool, dict]:
    checks: dict[str, Any] = {"level": level}
    checks["not_ported"] = {k: item for k, (levels, item)
                            in NOT_PORTED.items() if level in levels}
    seconds: dict[str, float] = {}
    launched: dict[str, dict[str, int]] = {}
    checks["leg_seconds"] = seconds
    checks["leg_launches"] = launched

    def leg(name: str, fn: Callable[[], Any]):
        """Run one leg, recording its seconds and the kernels it launched
        (``ops/_build.launches``, the wrappers' counts)."""
        before = dict(_build.launches)
        t = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t, 3)
        delta = {k: n - before.get(k, 0) for k, n in _build.launches.items()
                 if n != before.get(k, 0)}
        if delta:
            launched[name] = delta
        return out

    def guarded(key: str, fn: Callable[[], bool]) -> bool:
        """A leg's verdict under ``key``, ANDed over the world; an
        exception fails it, recorded under ``<leg>_error`` (the JSON
        contract over the exception's type)."""
        try:
            flag = bool(fn())
        except Exception as exc:  # noqa: BLE001 — reported, never swallowed
            flag = False
            checks[key.replace("_ok", "_error")] = str(exc)
        # ANDed over the world: the maximum of "failed"
        checks[key] = world_max(float(not flag), dev) == 0.0
        return checks[key]

    n_dev = dist.get_world_size()
    checks["process_id"] = dist.get_rank()
    checks["num_processes"] = n_dev
    checks["local_rank"] = job.local_rank if job else 0
    checks["backend"] = dist.get_backend()
    checks["devices"] = n_dev
    checks["device_kind"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
    if expected_devices is None and "TPU_SMOKETEST_EXPECTED_DEVICES" in e:
        expected_devices = int(e["TPU_SMOKETEST_EXPECTED_DEVICES"])
    if expected_devices is not None:
        checks["expected_devices"] = expected_devices
        checks["device_count_ok"] = n_dev == expected_devices
        if not checks["device_count_ok"]:
            return False, checks

    # 1. the north-star check: an all-reduce over every rank, flat mesh
    flat = build_mesh(plan_mesh(n_dev, tp=1, sp=1))
    r = leg("psum", lambda: psum_probe(flat, axis="dp", n_elems=1 << 16))
    checks["psum_ok"] = r["ok"]
    checks["psum_participants"] = r["participants"]
    ok = r["ok"]

    # across hosts: with more than one slice, an all-reduce over the slice
    # axis and the hierarchical one. A bad slice layout fails the JSON
    # line instead of crashing it.
    ms_mesh = None
    try:
        n_slices = dcn_slice_count(e)
        if n_slices > 1:
            ms_mesh = build_multislice_mesh(plan_multislice(n_dev, n_slices))
    except (ValueError, TypeError) as exc:
        checks["slices_error"] = str(exc)
        return False, checks
    if ms_mesh is not None and ok:
        checks["slices"] = n_slices
        r = leg("dcn_psum",
                lambda: psum_probe(ms_mesh, axis="slice", n_elems=1 << 14))
        checks["dcn_psum_ok"] = r["ok"]
        checks["dcn_psum_participants"] = r["participants"]
        ok &= r["ok"]
        r = leg("hier_psum",
                lambda: hierarchical_psum_probe(ms_mesh, n_elems=1 << 14))
        checks["hier_psum_ok"] = r["ok"]
        checks["hier_psum_participants"] = r["participants"]
        ok &= r["ok"]

    if level in ("probes", "burnin", "full") and ok:
        mesh = ms_mesh if ms_mesh is not None else build_mesh(
            plan_mesh(n_dev))
        checks["mesh"] = dict(mesh.shape)
        for name, probe in ALL_PROBES.items():
            axis = {"psum": "dp", "all_gather": "tp", "reduce_scatter": "tp",
                    "ring_permute": "dp", "all_to_all": "ep"}[name]
            if mesh.shape.get(axis, 1) == 1:
                axis = "dp" if mesh.shape["dp"] > 1 else "tp"
            if mesh.shape[axis] == 1:
                continue
            pr = leg(name, lambda: probe(mesh, axis=axis, n_elems=1 << 14))
            checks[f"{name}_ok"] = pr["ok"]
            checks[f"{name}_gibps"] = round(
                pr["bytes"] / max(pr["seconds"], 1e-9) / (1 << 30), 3)
            ok &= pr["ok"]

    if level in ("burnin", "full") and ok:
        ok &= _burnin(checks, e, dev, ms_mesh, n_dev, leg, guarded)
    return bool(ok), checks


def _burnin(checks, e, dev, ms_mesh, n_dev, leg, guarded) -> bool:
    """The burn-in legs: 5 SGD steps of the sharded transformer, then the
    serve shapes on the trained weights and on small f32 engines."""
    if e.get("TPU_SMOKETEST_CHECKPOINT_DIR"):
        # a resumable burn-in is what the directory asks for: failing is
        # honest, training without checkpoints would not be
        checks["burnin_checkpoint_ok"] = False
        checks["checkpoint_error"] = (
            "checkpointed burn-in (TPU_SMOKETEST_CHECKPOINT_DIR) is not "
            "ported yet — ROADMAP Queue A item 11")
        return False

    mesh = ms_mesh if ms_mesh is not None else build_mesh(plan_mesh(n_dev))
    rules = make_rules(mesh)
    data_shards = mesh.shape["dp"] * mesh.shape.get("slice", 1)
    cfg = BurnInConfig(batch=max(8, 2 * data_shards))

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    params = init_params(cfg, gen(0), device=dev, rules=rules)
    step = instrument_step(make_train_step(cfg, rules), cfg, rules=rules)
    batch = synthetic_batch(gen(1), cfg, rules=rules)
    losses: list[float] = []

    def train():
        nonlocal params
        for _ in range(5):
            params, loss = step(params, batch)
            losses.append(float(loss))

    leg("burnin", train)
    checks["burnin_first_loss"] = round(losses[0], 4)
    checks["burnin_last_loss"] = round(losses[-1], 4)
    checks["burnin_step"] = len(losses)
    guarded("burnin_ok", lambda: len(losses) == 5 and losses[-1] < losses[0])
    ok = checks["burnin_ok"]

    # serve shape: a short greedy decode on the trained weights, its first
    # token equal to the forward's argmax. greedy_decode takes no rules
    # yet (ROADMAP Queue A item 6): each rank gathers the tp shards and
    # decodes its own batch rows unsharded on its device.
    if not ok:
        return False
    checks["decode_sharding"] = "gathered"
    full = gather_params(params, rules)

    def decode():
        prompt = batch[0][:, :8]
        toks = greedy_decode(full, prompt, 4, cfg, device=dev)
        first_ref = forward(full, prompt, cfg)[:, -1].argmax(dim=-1)
        return (tuple(toks.shape) == (prompt.shape[0], 4)
                and bool((toks[:, 0] == first_ref).all()))

    ok &= leg("decode", lambda: guarded("decode_ok", decode))
    del full

    # the continuous-batching engine, its scheduler levers and the paged
    # decode kernel: tiny, unsharded, process-local (every rank checks its
    # own device; no collective until the verdict)
    def small(seed):
        scfg = BurnInConfig(vocab=128, d_model=32, n_heads=4, d_ff=64,
                            n_layers=2, seq_len=16, batch=2,
                            dtype=torch.float32)
        return scfg, init_params(scfg, gen(seed), device=dev)

    def tokens(values):
        return torch.tensor(values, dtype=torch.long, device=dev)

    def serve_engine():
        ecfg, eparams = small(8)
        rng = np.random.default_rng(20)
        prompts = [tokens(rng.integers(0, ecfg.vocab, 4 + (i % 3) * 2))
                   for i in range(5)]
        engine = make_serve_engine(eparams, ecfg, max_len=16, kv_block=4,
                                   device=dev)
        outs = engine(prompts, 6, slots=2)
        kv = engine.last_stats["kv"]
        checks["serve_engine_kv_peak_blocks"] = kv["high_water"]
        checks["serve_engine_kv_utilisation"] = kv["utilisation"]
        return all(torch.equal(o, greedy_decode(eparams, p[None, :], 6, ecfg,
                                                device=dev)[0])
                   for o, p in zip(outs, prompts))

    def shared(n, seed, template_len, vocab):
        return [tokens(p) for _t, p in shared_prefix_prompts(
            n, seed=seed, n_templates=2, template_len=template_len,
            suffix_lo=1, suffix_hi=4, vocab=vocab)]

    def serve_sched():
        scfg, sparams = small(11)
        prompts = shared(5, 0, 9, scfg.vocab)
        budgets = [2, 5, 1, 4, 3]
        max_len = max(p.shape[-1] + n for p, n in zip(prompts, budgets))
        base = make_serve_engine(sparams, scfg, max_len=max_len, kv_block=4,
                                 policy="fifo", device=dev)
        b_outs = base(prompts, budgets, slots=2)
        lever = make_serve_engine(sparams, scfg, max_len=max_len, kv_block=4,
                                  share_prefix=True, lazy_growth=True,
                                  device=dev)
        l_outs = lever(prompts, budgets, slots=2)
        st = lever.last_stats
        checks["serve_sched_prefix_hit_blocks"] = st["prefix"]["hit_blocks"]
        checks["serve_sched_blocks_grown_lazy"] = st["kv"][
            "blocks_grown_lazy"]
        return (all(torch.equal(a, b) for a, b in zip(l_outs, b_outs))
                and st["prefix"]["hit_blocks"] > 0
                and st["kv"]["in_use"] == 0)

    def paged_decode():
        # the paged decode kernel (K7 on the card) against the gather
        # path, token for token, at f32
        kcfg, kparams = small(12)
        prompts = shared(4, 1, 9, kcfg.vocab)
        budgets = [3, 5, 2, 4]
        max_len = max(p.shape[-1] + n for p, n in zip(prompts, budgets))
        outs = {}
        for mode in ("off", "on"):
            eng = make_serve_engine(kparams, kcfg, max_len=max_len,
                                    kv_block=8, share_prefix=True,
                                    paged_kernel=mode, device=dev)
            outs[mode] = eng(prompts, budgets, slots=2)
        return all(torch.equal(a, b) for a, b in zip(outs["on"], outs["off"]))

    for key, fn in (("serve_engine_ok", serve_engine),
                    ("serve_sched_ok", serve_sched),
                    ("paged_decode_ok", paged_decode)):
        if not ok:
            break
        ok &= leg(key[:-3], lambda: guarded(key, fn))
    return bool(ok)
