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
   the paged decode kernel, the prefix index's host-RAM tier, the fleet
   router with its fault plane, its autoscaler's warm joins, the warm
   cache's bring-up and its durable prefix CDN — ``TPU_PREFIX_DISK_SPILL``
   points that leg at a durable directory, else a temporary one) are exact
   on the same pool;
5. at ``full``, on two devices or more, the expert and stage fabric and
   serving on the mesh: an all-to-all over ``ep``, three MoE train steps
   with the experts sharded over ``ep``, three 2-stage GPipe steps (the
   activations and their gradients hop stage to stage), and the paged
   engine under ``rules=`` (its first tokens against a batch-1 forward). A world of one has no
   fabric to prove: it sets ``full_skipped``. With
   ``TPU_SMOKETEST_CHECKPOINT_DIR`` (a spot pool's volume) the steps
   resume from the newest valid checkpoint and run supervised
   (``models/resilience.py``): a durable checkpoint each step, the SIGTERM
   drain with an emergency checkpoint inside
   ``TPU_SMOKETEST_GRACE_SECONDS``, heartbeats; a corrupt step is
   quarantined and counted; a run that passes clears the directory.

Before any of them, at every level and before the device or the world
is touched, graftlint (``analysis/``) scans the installed package
(``TPU_SMOKETEST_LINT_DIR`` redirects it): an ERROR finding refuses the
run with ``lint_runtime_ok: false`` and the findings listed.

Output is ONE JSON line a host (its local rank 0 prints it:
``__main__.py``); exit 0 iff every check passed. Each rank runs on its
own device (``parallel/multihost.py``), and every leg's verdict is ANDed
over the world, so one rank's failure fails every host's line. A leg of
the reference's that the port does not run (a declared divergence) is
not counted: it is listed under ``"not_ported"`` with its reason.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..models import (
    BurnInConfig,
    CheckpointError,
    Checkpointer,
    SupervisedLoop,
    forward,
    gather_params,
    greedy_decode,
    init_params,
    instrument_step,
    make_serve_engine,
    make_train_step,
    resilience_from_env,
    synthetic_batch,
)
from ..models.checkpoint import _is_remote
from ..ops import _build
from ..parallel import (
    ALL_PROBES,
    MeshPlan,
    PipelineConfig,
    build_mesh,
    build_multislice_mesh,
    build_world_mesh,
    dcn_slice_count,
    hierarchical_psum_probe,
    init_pipeline_params,
    job_env_from_environ,
    make_pipeline_train_step,
    make_rules,
    maybe_initialize_distributed,
    place_pipeline_params,
    plan_mesh,
    plan_multislice,
    psum_probe,
    shutdown_distributed,
)
from ..parallel.collectives import all_to_all_probe, world_max
from ..parallel.multihost import rank_device
from ..telemetry import get_registry
from ..utils.traffic import shared_prefix_prompts

LEVELS = ("psum", "probes", "burnin", "full")

# legs of the reference's runner that this port does not run: key → (the
# levels it belongs to, why)
NOT_PORTED = {
    "flash_pipeline_ok": (("burnin", "full"),
                          "not queued (the port's kernels have no "
                          "pipeline keyword)"),
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
    lint = _lint_preflight(e)
    if not lint["lint_runtime_ok"]:
        return SmokeResult(False, {"level": level, **lint},
                           time.perf_counter() - t0)
    platform = "cpu" if e.get("TPU_SMOKETEST_PLATFORM", "").lower() == \
        "cpu" else "cuda"
    dev = rank_device(job_env_from_environ(e), platform)
    owned = not dist.is_initialized()
    job = maybe_initialize_distributed(e, device=dev)
    try:
        ok, checks = _suite(expected_devices, level, e, job, dev, lint)
    finally:
        if owned:
            shutdown_distributed()
    return SmokeResult(bool(ok), checks, time.perf_counter() - t0)


def _lint_preflight(e) -> dict[str, Any]:
    """graftlint over the installed port package (``TPU_SMOKETEST_LINT_DIR``
    redirects it), before any device or world is touched: an ERROR
    finding refuses the run, with the findings listed; an unreadable tree
    is reported and does not block it (the reference's preflight)."""
    from ..analysis import run_graftlint

    pkg_dir = e.get("TPU_SMOKETEST_LINT_DIR") or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    out: dict[str, Any] = {}
    try:
        errors = [str(f) for f in run_graftlint(pkg_dir)
                  if f.severity == "error"]
    except (OSError, ValueError) as exc:
        errors = []
        out["lint_runtime_error"] = str(exc)
    out["lint_runtime_ok"] = not errors
    if errors:
        out["lint_runtime_findings"] = errors
    return out


def _suite(expected_devices, level, e, job, dev,
           lint: dict) -> tuple[bool, dict]:
    checks: dict[str, Any] = {"level": level, **lint}
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
    if level == "full" and ok:
        ok &= _full(checks, dev, n_dev, leg, guarded)
    return bool(ok), checks


def _burnin(checks, e, dev, ms_mesh, n_dev, leg, guarded) -> bool:
    """The burn-in legs: 5 SGD steps of the sharded transformer, then the
    serve shapes on the trained weights and on small f32 engines. With
    ``TPU_SMOKETEST_CHECKPOINT_DIR`` the steps resume from the directory's
    newest valid step and checkpoint every step under the supervised loop
    (:func:`_supervised_steps`); a run whose every leg passed clears the
    directory."""
    mesh = ms_mesh if ms_mesh is not None else build_mesh(plan_mesh(n_dev))
    rules = make_rules(mesh)
    data_shards = mesh.shape["dp"] * mesh.shape.get("slice", 1)
    cfg = BurnInConfig(batch=max(8, 2 * data_shards))

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    ckpt_dir = e.get("TPU_SMOKETEST_CHECKPOINT_DIR")
    ckpt, params, start = None, None, 0
    try:
        if ckpt_dir:
            ckpt, restored = _restore(checks, ckpt_dir, cfg, rules)
            if ckpt is None:
                return False
            if restored is not None:
                params, start, _meta = restored
        if params is None:
            params = init_params(cfg, gen(0), device=dev, rules=rules)
        step = instrument_step(make_train_step(cfg, rules), cfg, rules=rules)
        batch = synthetic_batch(gen(1), cfg, rules=rules)
        losses: list[float] = []

        def train():
            nonlocal params
            if ckpt is None:
                for _ in range(5):
                    params, loss = step(params, batch)
                    losses.append(float(loss))
                return "completed"
            params, status = _supervised_steps(
                checks, e, ckpt, ckpt_dir, params, start, step, batch,
                losses)
            return status

        if leg("burnin", train) != "completed":
            return False
        checks["burnin_first_loss"] = round(losses[0], 4)
        checks["burnin_last_loss"] = round(losses[-1], 4)
        checks["burnin_step"] = start + len(losses)
        guarded("burnin_ok",
                lambda: len(losses) == 5 and losses[-1] < losses[0])
        ok = checks["burnin_ok"] and _serve_legs(checks, cfg, params, batch,
                                                 rules, dev, gen, leg,
                                                 guarded, e)
        if ckpt is not None and ok:
            try:
                checks["burnin_checkpoint_cleared"] = ckpt.clear()
            except (CheckpointError, OSError) as exc:
                checks["burnin_checkpoint_ok"] = False
                checks["checkpoint_error"] = f"clear: {exc}"
                ok = False
        return bool(ok)
    finally:
        if ckpt is not None:
            ckpt.close()


def _restore(checks, ckpt_dir, cfg, rules):
    """Open the checkpoint directory and restore its newest valid step:
    ``(checkpointer, (params, step, meta) or None)``. A storage failure (a
    remote prefix, an unreadable directory, a bounded rendezvous timeout)
    fails the leg through the JSON contract — ``(None, None)`` — never as
    a traceback; a corrupt step is quarantined inside the restore, counted
    here, and the run falls back to the next older step or a fresh
    start."""
    ckpt = None
    try:
        ckpt = Checkpointer(ckpt_dir)
        restored = ckpt.restore(cfg, rules)
    except (CheckpointError, OSError) as exc:
        if ckpt is not None:
            ckpt.close()
        checks["burnin_checkpoint_ok"] = False
        checks["checkpoint_error"] = f"restore: {exc}"
        return None, None
    quarantined = ckpt.quarantined()
    if quarantined:
        checks["checkpoint_quarantined"] = len(quarantined)
    if restored is not None:
        checks["burnin_resumed_step"] = restored[1]
    return ckpt, restored


def _supervised_steps(checks, e, ckpt, ckpt_dir, params, start, step, batch,
                      losses):
    """Steps ``start + 1 … start + 5`` under ``SupervisedLoop``: a durable
    checkpoint each step, the SIGTERM drain with an emergency checkpoint
    inside ``TPU_SMOKETEST_GRACE_SECONDS``, heartbeat files beside the
    checkpoints. Returns ``(params, "completed" | "preempted" | None)``;
    ``None`` is a storage failure, reported under ``checkpoint_error``."""
    def one_step(p, _step_no):
        p, loss = step(p, batch)
        losses.append(float(loss))
        return p

    loop = SupervisedLoop(
        ckpt, resilience_from_env(e), total_steps=start + 5,
        process_id=dist.get_rank(), num_processes=dist.get_world_size(),
        heartbeat_dir=None if _is_remote(ckpt_dir) else ckpt_dir)
    try:
        params, outcome = loop.run(
            params, one_step, start_step=start,
            meta=lambda s, _p: {"last_loss": losses[-1]})
    except (CheckpointError, OSError) as exc:
        # storage-layer failures only (an unwritable volume, a bounded
        # rendezvous timeout); a train step's error propagates
        checks["burnin_checkpoint_ok"] = False
        checks["checkpoint_error"] = f"save: {exc}"
        checks["burnin_step"] = start + len(losses)
        return params, None
    if outcome.status == "preempted":
        # drained + emergency checkpoint committed: the Job controller
        # restarts the pod and the next attempt resumes
        checks["burnin_preempted"] = outcome.step
        checks["burnin_step"] = outcome.step
        checks["burnin_ok"] = False
        return params, "preempted"
    checks["burnin_checkpoint_saved"] = outcome.step
    return params, "completed"


def _serve_legs(checks, cfg, params, batch, rules, dev, gen, leg,
                guarded, e) -> bool:
    """The serve shapes on the trained weights, and on small f32
    engines."""
    # serve shape: a short greedy decode on the trained shards (the
    # tp-sharded cache, this rank's batch rows), its first token equal to
    # the sharded forward's argmax
    def decode():
        prompt = batch[0][:, :8]
        toks = greedy_decode(params, prompt, 4, cfg, rules, device=dev)
        first_ref = forward(params, prompt, cfg, rules)[:, -1].argmax(dim=-1)
        return (tuple(toks.shape) == (prompt.shape[0], 4)
                and bool((toks[:, 0] == first_ref).all()))

    ok = leg("decode", lambda: guarded("decode_ok", decode))

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
        # string-seeded: a literal integer seed collides across legs
        rng = random.Random("smoketest-serve-engine")
        prompts = [tokens([rng.randrange(ecfg.vocab)
                           for _ in range(4 + (i % 3) * 2)])
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

    def kv_spill():
        kcfg, kparams = small(14)
        flag, rec = kv_spill_leg(kparams, kcfg, dev)
        checks.update(rec)
        return flag

    fleet_state: dict = {}

    def serve_fleet():
        fcfg, fparams = small(13)
        flag, rec, state = serve_fleet_leg(fparams, fcfg, dev)
        checks.update(rec)
        fleet_state.update(state, cfg=fcfg, params=fparams)
        return flag

    def fleet_chaos():
        flag, rec = fleet_chaos_leg(fleet_state["params"], fleet_state["cfg"],
                                    dev, fleet_state["prompts"],
                                    fleet_state["base"])
        checks.update(rec)
        return flag

    def fleet_scale():
        flag, rec = fleet_scale_leg(fleet_state["params"], fleet_state["cfg"],
                                    dev)
        checks.update(rec)
        return flag

    def aot_warm():
        acfg, aparams = small(21)
        flag, rec = aot_warm_leg(aparams, acfg, dev)
        checks.update(rec)
        return flag

    def prefix_cdn():
        ccfg, cparams = small(23)
        flag, rec = prefix_cdn_leg(cparams, ccfg, dev,
                                   e.get("TPU_PREFIX_DISK_SPILL"))
        checks.update(rec)
        return flag

    for key, fn in (("serve_engine_ok", serve_engine),
                    ("serve_sched_ok", serve_sched),
                    ("paged_decode_ok", paged_decode),
                    ("serve_fleet_ok", serve_fleet),
                    ("fleet_chaos_ok", fleet_chaos),
                    ("kv_spill_ok", kv_spill),
                    ("fleet_scale_ok", fleet_scale),
                    ("aot_warm_ok", aot_warm),
                    ("prefix_cdn_ok", prefix_cdn)):
        if not ok:
            break
        ok &= leg(key[:-3], lambda: guarded(key, fn))
    return bool(ok)


def _fleet_wave(cfg: BurnInConfig, dev):
    """The reference's fleet legs' wave: ``shared_prefix_prompts(6,
    seed=2)`` over 2 templates of 8 tokens, budgets ``[3, 5, 2, 4, 3,
    2]``."""
    prompts = [torch.tensor(p, dtype=torch.long, device=dev)
               for _t, p in shared_prefix_prompts(
                   6, seed=2, n_templates=2, template_len=8, suffix_lo=1,
                   suffix_hi=4, vocab=cfg.vocab)]
    budgets = [3, 5, 2, 4, 3, 2]
    max_len = max(int(p.shape[-1]) + n for p, n in zip(prompts, budgets))
    return prompts, budgets, max_len


def serve_fleet_leg(params, cfg: BurnInConfig, dev):
    """The reference's fleet router gate: a 2-replica affinity fleet on
    the shared-prefix wave must equal the single engine token for token,
    shed nothing, place every request by affinity and drain both pools.
    Returns the verdict, the line's ``serve_fleet_*`` fields, and the
    prompts and single-engine outputs the chaos leg reuses."""
    from ..models import make_fleet

    prompts, budgets, max_len = _fleet_wave(cfg, dev)
    base = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             share_prefix=True, device=dev)
    b_outs = base(prompts, budgets, slots=2)
    fleet = make_fleet(params, cfg, max_len=max_len, replicas=2, kv_block=4,
                       share_prefix=True, steal=False, device=dev)
    f_outs = fleet(prompts, budgets, slots=2)
    fst = fleet.last_stats["fleet"]
    flag = (all(o is not None and torch.equal(o, b)
                for o, b in zip(f_outs, b_outs))
            and fst["shed"] == 0 and fst["affinity_routed_frac"] == 1.0
            and all(rs["kv"]["in_use"] == 0
                    for rs in fleet.last_stats["replica_stats"]))
    return flag, {"serve_fleet_hit_blocks": fst["affinity_hit_blocks"],
                  "serve_fleet_replicas": fst["replicas"]}, {
        "prompts": prompts, "base": b_outs}


# the chaos leg's kill, and its victim's first-wave stall past it (beyond
# the reference's schedule): the kill lands while the victim holds requests
# however fast the device serves the wave
CHAOS_KILL_S = 0.05
CHAOS_STALL_S = 2 * CHAOS_KILL_S


def fleet_chaos_leg(params, cfg: BurnInConfig, dev, prompts, base_outs):
    """The reference's fleet chaos gate: a 3-replica fleet with a seeded
    kill of the replica the first prompt routes to, at ``CHAOS_KILL_S``,
    must serve every request equal to the single engine, shed nothing, lose
    exactly one replica and drain the survivors' pools. The victim also
    stalls its first wave by ``2 * CHAOS_KILL_S`` (a ``slow_replica``), so
    the kill always finds it mid-run — a departure from the reference's
    schedule, which arms the kill alone; the line's
    ``fleet_chaos_stall_s`` states it. Returns the verdict and the line's
    ``fleet_chaos_redriven`` and ``fleet_chaos_stall_s``."""
    from ..models.fleet import (
        FleetFault,
        FleetFaultProfile,
        HashRing,
        affinity_key,
        make_fleet,
    )

    _prompts, budgets, max_len = _fleet_wave(cfg, dev)
    victim = HashRing(3).target(affinity_key(prompts[0], 4))
    chaos = make_fleet(
        params, cfg, max_len=max_len, replicas=3, kv_block=4,
        share_prefix=True, steal=False, device=dev,
        faults=FleetFaultProfile(
            [FleetFault("kill_replica", target=victim, at_s=CHAOS_KILL_S),
             FleetFault("slow_replica", target=victim, at_s=0.0,
                        stall_s=CHAOS_STALL_S, waves=1)], seed=0))
    c_outs = chaos(prompts, budgets, slots=2)
    cst = chaos.last_stats["fleet"]
    flag = (all(o is not None and torch.equal(o, b)
                for o, b in zip(c_outs, base_outs))
            and cst["served"] == len(prompts) and cst["shed"] == 0
            and cst["faults"]["replica_down"] == 1
            and all(rs["kv"]["in_use"] == 0
                    for rs in chaos.last_stats["replica_stats"]
                    if rs is not None))
    return flag, {"fleet_chaos_redriven": cst["faults"]["redriven"],
                  "fleet_chaos_stall_s": CHAOS_STALL_S}


def kv_spill_leg(params, cfg: BurnInConfig, dev) -> tuple[bool, dict]:
    """The reference's tiered-KV gate: a template wave whose working set
    (4 blocks a template) overflows a device keep-cap of 0, through a
    spilling engine at a tight ``kv_blocks``, must equal the unconstrained
    engine without the tier token for token, with at least one swap-in,
    blocks spilled, no corrupt drop, and both pools drained. Returns the
    verdict and the line's ``kv_spill_*`` counts."""
    pairs = shared_prefix_prompts(6, seed=3, template_len=8, suffix_lo=1,
                                  suffix_hi=4, vocab=cfg.vocab,
                                  working_set_blocks=4, block_size=4)
    prompts = [torch.tensor(p, dtype=torch.long, device=dev)
               for _t, p in pairs]
    budgets = [3, 4, 2, 4, 3, 2]
    max_len = max(int(p.shape[-1]) + n for p, n in zip(prompts, budgets))
    want = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             device=dev)(prompts, budgets, slots=1)
    spill = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                              share_prefix=True, prefix_keep_blocks=0,
                              host_spill=True, device=dev)
    got = spill(prompts, budgets, slots=1,
                kv_blocks=1 + -(-max_len // 4) + 2)
    st = spill.last_stats
    sp = st["prefix"]["spill"]
    flag = (all(torch.equal(a, b) for a, b in zip(got, want))
            and sp["swapins"] >= 1 and sp["spilled_blocks"] > 0
            and sp["corrupt_dropped"] == 0 and st["kv"]["in_use"] == 0
            and sp["host_in_use"] == 0)
    return flag, {"kv_spill_swapins": sp["swapins"],
                  "kv_spill_spilled_blocks": sp["spilled_blocks"]}


def fleet_scale_leg(params, cfg: BurnInConfig, dev) -> tuple[bool, dict]:
    """The reference's elastic-fleet gate: on ``shared_prefix_prompts(12,
    seed=6)`` (4 templates of 8 tokens), a burst of 8 then a sparse tail,
    an autoscaled fleet (1 to 3 replicas, ``host_spill`` engines) must
    scale up and down, equal the single engine token for token and drain
    its pools; a second identical call must replay the same events with a
    warm join whose seeded chains turn into prefix hits. Returns the
    verdict and the line's ``fleet_scale_warm_blocks`` and
    ``fleet_scale_joiner_hits``."""
    from ..models.fleet import AutoscalePolicy, make_fleet

    prompts = [torch.tensor(p, dtype=torch.long, device=dev)
               for _t, p in shared_prefix_prompts(
                   12, seed=6, n_templates=4, template_len=8, suffix_lo=1,
                   suffix_hi=4, vocab=cfg.vocab)]
    budgets = [3, 4, 2, 4, 3, 2, 4, 3, 2, 3, 4, 2]
    max_len = max(int(p.shape[-1]) + n for p, n in zip(prompts, budgets))
    base = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             share_prefix=True, device=dev)(
        prompts, budgets, slots=2)
    arrivals = [0.0] * 8 + [0.5 + 0.25 * i for i in range(4)]
    elastic = make_fleet(
        params, cfg, max_len=max_len, replicas=1, kv_block=4,
        share_prefix=True, host_spill=True, host_blocks=64,
        prefix_keep_blocks=16, est_token_s=0.02, steal=False, device=dev,
        autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3,
                                  up_backlog=2.0, down_backlog=0.5,
                                  cooldown_s=0.05, seed=0))
    rounds = []
    for _ in range(2):
        outs = elastic(prompts, budgets, slots=2, arrivals=arrivals)
        sc = elastic.last_stats["fleet"]["scale"]
        reps = elastic.last_stats["replica_stats"]
        rounds.append({
            "match": all(o is not None and torch.equal(o, b)
                         for o, b in zip(outs, base)),
            "scale": sc,
            "drained": all(rs["kv"]["in_use"] == 0
                           and rs["prefix"]["spill"]["host_in_use"] == 0
                           for rs in reps if rs is not None),
            "joiner_hits": sum(rs["prefix"]["hit_blocks"]
                               for i, rs in enumerate(reps)
                               if rs is not None and i >= sc["initial"]),
            "warm_blocks": sum(rs["prefix"]["warm"]["seeded_blocks"]
                               for rs in reps if rs is not None)})
    r1, r2 = rounds
    flag = (r1["match"] and r2["match"] and r1["drained"] and r2["drained"]
            and r1["scale"]["ups_executed"] >= 1
            and r1["scale"]["downs"] >= 1
            and r2["scale"]["events"] == r1["scale"]["events"]
            and r2["scale"]["warm_joins"] >= 1 and r2["warm_blocks"] >= 1
            and r2["joiner_hits"] > 0)
    return flag, {"fleet_scale_warm_blocks": r2["warm_blocks"],
                  "fleet_scale_joiner_hits": r2["joiner_hits"]}


def aot_warm_leg(params, cfg: BurnInConfig, dev) -> tuple[bool, dict]:
    """The reference's cold-start gate: the warm cache is a bring-up
    change, never different tokens. On ``shared_prefix_prompts(6,
    seed=5)`` (templates of 8 tokens) a cold engine, an engine warmed
    against a temporary cache directory and a second bring-up over the
    same directory (``share_prefix`` engines, ``kv_block=4``, 2 slots):
    the warmed engine's tokens must equal the cold engine's, the first
    warm register ≥ 1 pieces, neither warm report an error, and the
    second land ≥ 1 hits. The directory is deactivated (in reverse order
    of activation: activation is sticky) and removed. Returns the verdict
    and the line's ``aot_warm_registered`` and ``aot_warm_second_hits``."""
    import shutil
    import tempfile

    prompts = [torch.tensor(p, dtype=torch.long, device=dev)
               for _t, p in shared_prefix_prompts(
                   6, seed=5, template_len=8, suffix_lo=1, suffix_hi=4,
                   vocab=cfg.vocab)]
    budgets = [3, 4, 2, 4, 3, 2]
    max_len = max(int(p.shape[-1]) + n for p, n in zip(prompts, budgets))
    lens = tuple(sorted({int(p.shape[-1]) for p in prompts}))
    kw = dict(max_len=max_len, kv_block=4, share_prefix=True, device=dev)
    cold = make_serve_engine(params, cfg, **kw)(prompts, budgets, slots=2)
    adir = tempfile.mkdtemp(prefix="smoke_aot_")
    engines = []
    try:
        engines.append(make_serve_engine(params, cfg, aot_cache=adir, **kw))
        ws1 = engines[0].warm(slots=2, prompt_lens=lens, n_new=max(budgets))
        warmed = engines[0](prompts, budgets, slots=2)
        engines.append(make_serve_engine(params, cfg, aot_cache=adir, **kw))
        ws2 = engines[1].warm(slots=2, prompt_lens=lens, n_new=max(budgets))
    finally:
        for engine in reversed(engines):
            engine.aot_cache.deactivate()
        shutil.rmtree(adir, ignore_errors=True)
    flag = (all(torch.equal(a, b) for a, b in zip(warmed, cold))
            and ws1["enabled"] and ws2["enabled"]
            and ws1["registered"] >= 1 and not ws1["errors"]
            and not ws2["errors"] and ws2["hits"] >= 1)
    return flag, {"aot_warm_registered": ws1["registered"],
                  "aot_warm_second_hits": ws2["hits"]}


def prefix_cdn_leg(params, cfg: BurnInConfig, dev,
                   spill_dir: str | None = None) -> tuple[bool, dict]:
    """The reference's durable prefix CDN gate: a 2-replica fleet with
    ``disk_spill=`` on ``shared_prefix_prompts(6, seed=7)`` must equal the
    single engine; a brand-new fleet over the same directory (every byte of
    RAM state gone: a whole-fleet restart) must come back warm from disk
    (chains restored, store hits) and equal it again, nothing quarantined
    and the tier alive. ``spill_dir`` (``TPU_PREFIX_DISK_SPILL``) names a
    durable directory; without it a temporary one is made and removed.
    Returns the verdict and the line's ``prefix_cdn_*`` fields."""
    import shutil
    import tempfile

    from ..models.fleet import make_fleet

    prompts = [torch.tensor(p, dtype=torch.long, device=dev)
               for _t, p in shared_prefix_prompts(
                   6, seed=7, n_templates=2, template_len=8, suffix_lo=1,
                   suffix_hi=4, vocab=cfg.vocab)]
    budgets = [3, 4, 2, 4, 3, 2]
    max_len = max(int(p.shape[-1]) + n for p, n in zip(prompts, budgets))
    base = make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             share_prefix=True, device=dev)(
        prompts, budgets, slots=2)
    ddir = spill_dir or tempfile.mkdtemp(prefix="smoke_cdn_")
    try:
        def cdn_run():
            fleet = make_fleet(params, cfg, max_len=max_len, replicas=2,
                               kv_block=4, share_prefix=True, steal=False,
                               disk_spill=ddir, device=dev)
            outs = fleet(prompts, budgets, slots=2)
            return (all(o is not None and torch.equal(o, b)
                        for o, b in zip(outs, base)),
                    fleet.cdn_store.disk_restored,
                    fleet.last_stats["fleet"]["cdn"])

        m1, _r1, cdn1 = cdn_run()                 # seeds the disk
        m2, restored, cdn2 = cdn_run()            # the restart
    finally:
        if spill_dir is None:
            shutil.rmtree(ddir, ignore_errors=True)
    flag = (m1 and m2 and restored > 0
            and cdn1["store"]["disk"]["stored_chains"] > 0
            and cdn2["store"]["fetch_blocks"] > 0
            and cdn2["store"]["disk"]["quarantined"] == 0
            and not cdn2["store"]["disk"]["dead"])
    return flag, {"prefix_cdn_durable_dir": spill_dir is not None,
                  "prefix_cdn_restored_chains": restored,
                  "prefix_cdn_hit_blocks": cdn2["store"]["fetch_blocks"]}


def _full(checks, dev, n_dev, leg, guarded) -> bool:
    """The reference's ``_run_full_level`` legs: the all-to-all over
    ``ep``, three MoE train steps with the experts sharded over ``ep``
    (``plan_mesh(n, ep=2, tp=1)``), three 2-stage GPipe steps over a
    ``("pp", "dp")`` world of ``(2, n // 2)`` (``parallel/pipeline.py``),
    and the paged engine under ``rules=`` on ``plan_mesh(n)``, twice as
    many requests as slots, each first token against a batch-1 ``forward``
    of the gathered weights (no eos: the loop never waits on the device).
    A world of one has no fabric: the legs are skipped with
    ``full_skipped``, never passed vacuously."""
    if n_dev < 2:
        checks["full_skipped"] = "ep/pp fabric needs >= 2 devices"
        return True

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    meshes: dict[str, Any] = {}

    def ep_mesh():
        if "ep" not in meshes:
            meshes["ep"] = build_mesh(plan_mesh(n_dev, ep=2, tp=1))
        return meshes["ep"]

    def all_to_all_ep():
        # ep-suffixed keys: the probes level recorded an all_to_all over
        # its own axis already — both measurements stay
        pr = all_to_all_probe(ep_mesh(), axis="ep", n_elems=1 << 14)
        checks["all_to_all_ep_gibps"] = round(
            pr["bytes"] / max(pr["seconds"], 1e-9) / (1 << 30), 3)
        return pr["ok"]

    def moe():
        mesh = ep_mesh()
        rules = make_rules(mesh)
        cfg = BurnInConfig(n_experts=2, d_ff=256,
                           batch=max(8, 2 * mesh.shape["dp"]))
        params = init_params(cfg, gen(2), device=dev, rules=rules)
        step = make_train_step(cfg, rules)
        batch = synthetic_batch(gen(3), cfg, rules=rules)
        losses = []
        for _ in range(3):
            params, loss = step(params, batch)
            losses.append(float(loss))
        checks["moe_first_loss"] = round(losses[0], 4)
        checks["moe_last_loss"] = round(losses[-1], 4)
        return losses[-1] < losses[0]

    def pipeline():
        # a 2-stage GPipe train step over a ("pp", "dp") world of the
        # first 2·(n // 2) ranks (gradients flow back stage to stage); a
        # rank outside it (an odd world's last) has nothing to run
        mesh = build_world_mesh(MeshPlan(("pp", "dp"), (2, n_dev // 2)),
                                subset=True)
        if mesh is None:
            return True
        pcfg = PipelineConfig(vocab=64, d_model=32, n_heads=2, d_ff=64,
                              n_layers=2, seq_len=16, microbatch=2,
                              n_microbatches=2)
        pparams = place_pipeline_params(
            init_pipeline_params(pcfg, gen(4), device=dev), mesh)
        pstep = make_pipeline_train_step(pcfg, mesh)
        total = pcfg.n_microbatches * pcfg.microbatch * mesh.shape["dp"]
        stream = torch.randint(0, pcfg.vocab, (total, pcfg.seq_len + 1),
                               generator=gen(5), device=dev)
        pbatch = (stream[:, :-1], stream[:, 1:])
        plosses = []
        for _ in range(3):
            pparams, ploss = pstep(pparams, pbatch)
            plosses.append(float(ploss))
        checks["pipeline_first_loss"] = round(plosses[0], 4)
        checks["pipeline_last_loss"] = round(plosses[-1], 4)
        return plosses[-1] < plosses[0]

    def serving():
        mesh = build_mesh(plan_mesh(n_dev))
        rules = make_rules(mesh)
        slots = mesh.shape["dp"]
        cfg = BurnInConfig(batch=max(2, slots))
        params = init_params(cfg, gen(6), device=dev, rules=rules)
        n_req, plen, n_new = 2 * slots, 8, 4
        prompts = torch.randint(0, cfg.vocab, (n_req, plen),
                                generator=gen(7), device=dev)
        engine = make_serve_engine(params, cfg, max_len=plen + n_new,
                                   device=dev)
        outs = engine([prompts[i] for i in range(n_req)], n_new,
                      slots=slots, rules=rules)
        full = gather_params(params, rules)
        ref_first = torch.stack([
            forward(full, prompts[i:i + 1], cfg)[0, -1].argmax(dim=-1)
            for i in range(n_req)])
        firsts = torch.stack([o[0] for o in outs])
        checks["serving_requests"] = n_req
        checks["serving_slots"] = slots
        checks["serving_kv_utilisation"] = \
            engine.last_stats["kv"]["utilisation"]
        return (all(tuple(o.shape) == (n_new,) for o in outs)
                and bool((firsts == ref_first).all()))

    ok = True
    for key, fn in (("all_to_all_ep_ok", all_to_all_ep), ("moe_ok", moe),
                    ("pipeline_ok", pipeline), ("serving_ok", serving)):
        ok &= leg(key[:-3], lambda: guarded(key, fn))
    return bool(ok)
