# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the validation Job's payload (``smoketest/``) on the CPU:
the cases of the reference's ``tests/test_smoketest.py`` that the port's
levels cover, in a gloo world of 4 ranks (``_torch_world.py``; the
reference's ``plan_mesh(4)``, so tp 4) and in a world of one in this
process; the legs not run, listed under ``not_ported`` against the
reference's runner; the checkpointed burn-in (``TPU_SMOKETEST_CHECKPOINT_DIR``)
with the reference's keys and verdicts (``tests/test_checkpoint.py:128-189``:
save and clear, resume at a planted step, quarantine and a fresh start, a
store failure through the JSON contract), a ``gs://`` prefix, and a world
of 2 resuming a step that a world of 4 planted; the CLI with no card and
no CPU steer; and one 2-process CLI run over gloo in the manner of
``tests/test_multihost_e2e.py`` (two hosts of the indexed Job, so two
slices).
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
from _torch_world import run_world

import torch

from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    init_params,
    latest_step,
    save_checkpoint,
)
from nvidia_terraform_modules_tpu_torch.smoketest import run_smoketest

ROOT = Path(__file__).resolve().parent.parent
CPU = {"TPU_SMOKETEST_PLATFORM": "cpu"}
# four ranks on one host: one slice
WORLD4 = {**CPU, "LOCAL_WORLD_SIZE": "4"}
SERVE_LEGS = ("decode_ok", "serve_engine_ok", "serve_sched_ok",
              "paged_decode_ok", "kv_spill_ok")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The world of 4: full (burnin's legs and the full level's), probes,
    and psum expecting 8 devices; each rank's checks of each run."""
    runs = [("full", WORLD4), ("probes", WORLD4),
            ("psum", {**WORLD4, "TPU_SMOKETEST_EXPECTED_DEVICES": "8"})]
    return run_world("smoketest", 4, tmp_path_factory.mktemp("smoke"),
                     {"runs": runs}, timeout=180)


def test_burnin_level_in_a_world_of_four(world4):
    for rank, runs in enumerate(world4):
        r = runs[0]
        assert r["ok"] is True, r["checks"]
        c = r["checks"]
        assert c["process_id"] == rank and c["num_processes"] == 4
        assert c["backend"] == "gloo" and c["devices"] == 4
        assert c["psum_ok"] and c["psum_participants"] == 4
        assert c["mesh"] == {"dp": 1, "sp": 1, "tp": 4}
        for name in ("all_gather", "reduce_scatter", "ring_permute",
                     "all_to_all"):
            assert c[f"{name}_ok"] is True and c[f"{name}_gibps"] > 0
        assert c["burnin_ok"] and c["burnin_step"] == 5
        assert c["burnin_last_loss"] < c["burnin_first_loss"]
        assert all(c[key] is True for key in SERVE_LEGS)
        assert "decode_sharding" not in c      # decoded on the shards
        assert c["serve_sched_prefix_hit_blocks"] > 0
        assert "slices" not in c            # one host
    # every rank's line carries the world's verdicts
    verdicts = {json.dumps({k: v for k, v in runs[0]["checks"].items()
                            if k.endswith("_ok")}, sort_keys=True)
                for runs in world4}
    assert len(verdicts) == 1


def test_full_level_in_a_world_of_four(world4):
    """The full level's legs as the reference's ``_run_full_level`` keys
    them: the all-to-all over ``ep`` (dp 2 × ep 2), three MoE steps with
    the experts over ``ep`` lowering the loss, three 2-stage GPipe steps
    over a (pp 2, dp 2) world lowering theirs, and the engine under
    ``rules=`` on ``plan_mesh(4)`` (tp 4, so one slot and 2 requests); no
    full-level leg is left under ``not_ported``."""
    for runs in world4:
        c = runs[0]["checks"]
        assert c["level"] == "full"
        assert c["all_to_all_ep_ok"] is True and c["all_to_all_ep_gibps"] > 0
        assert c["moe_ok"] is True
        assert c["moe_last_loss"] < c["moe_first_loss"]
        assert c["serving_ok"] is True
        assert c["serving_requests"] == 2 and c["serving_slots"] == 1
        assert c["serving_kv_utilisation"] > 0
        assert c["pipeline_ok"] is True, c.get("pipeline_error")
        assert c["pipeline_last_loss"] < c["pipeline_first_loss"]
        assert "full_skipped" not in c
        full_listed = {k for k in c["not_ported"]
                       if k in ("all_to_all_ep_ok", "moe_ok", "serving_ok",
                                "pipeline_ok")}
        assert full_listed == set()
        for leg in ("all_to_all_ep", "moe", "pipeline", "serving"):
            assert leg in c["leg_seconds"]


def test_full_level_in_a_world_of_two_decodes_on_the_shards(
        tmp_path_factory):
    """A gloo world of 2 at ``full`` (tp 2): the decode leg runs
    ``greedy_decode`` and ``forward`` on the trained shards, so the line
    has no ``decode_sharding`` and ``decode_ok`` is true; the line's
    ``*_ok`` keys are the reference runner's less ``NOT_PORTED`` and the
    four that need an expected device count, a checkpoint store or more
    than one slice."""
    import nvidia_terraform_modules_tpu.smoketest.runner as jrunner
    from nvidia_terraform_modules_tpu_torch.smoketest.runner import (
        NOT_PORTED,
    )

    source = Path(jrunner.__file__).read_text()
    ref_keys = set(re.findall(r'checks\["(\w+_ok)"\]', source))
    ref_keys |= {f"{p}_ok" for p in ("psum", "all_gather", "reduce_scatter",
                                     "ring_permute", "all_to_all")}
    conditional = {"device_count_ok", "burnin_checkpoint_ok", "dcn_psum_ok",
                   "hier_psum_ok"}
    ranks = run_world("smoketest", 2, tmp_path_factory.mktemp("full2"),
                      {"runs": [("full", {**CPU,
                                          "LOCAL_WORLD_SIZE": "2"})]},
                      timeout=180)
    for r in ranks:
        c = r[0]["checks"]
        assert r[0]["ok"] is True, c
        assert c["mesh"] == {"dp": 1, "sp": 1, "tp": 2}
        assert c["decode_ok"] is True and "decode_sharding" not in c
        got = {k for k in c if k.endswith("_ok")}
        assert got == ref_keys - set(NOT_PORTED) - conditional
        assert set(c["not_ported"]) == set(NOT_PORTED)


def test_probes_level_in_a_world_of_four(world4):
    for runs in world4:
        c = runs[1]["checks"]
        assert runs[1]["ok"] is True
        assert c["all_gather_ok"] and c["reduce_scatter_ok"]
        assert c["ring_permute_ok"]
        assert "burnin_ok" not in c


def test_device_count_mismatch_fails(world4):
    for runs in world4:
        r = runs[2]
        assert r["ok"] is False
        assert r["checks"]["device_count_ok"] is False
        assert r["checks"]["expected_devices"] == 8
        assert "psum_ok" not in r["checks"]


def test_psum_level_world_of_one():
    r = run_smoketest(expected_devices=1, level="psum", env=CPU)
    assert r.ok
    assert r.checks["psum_ok"] and r.checks["psum_participants"] == 1
    assert r.checks["device_count_ok"]
    assert r.checks["not_ported"] == {
        "lint_runtime_ok": r.checks["not_ported"]["lint_runtime_ok"]}


def test_kv_spill_leg_at_burnin_equals_the_jax_runner_leg():
    """``kv_spill_ok`` runs at ``burnin`` (no longer under ``not_ported``,
    its seconds recorded), and the leg on the reference runner's config
    and weights (``init_params(PRNGKey(14))``) counts the swap-ins and
    spilled blocks the reference's leg counts, both verdicts true."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nvidia_terraform_modules_tpu.models import burnin as jburnin
    from nvidia_terraform_modules_tpu.models.serving import (
        make_serve_engine as jax_engine,
    )
    from nvidia_terraform_modules_tpu.utils.traffic import (
        shared_prefix_prompts,
    )
    from nvidia_terraform_modules_tpu_torch.models import params_from_numpy
    from nvidia_terraform_modules_tpu_torch.smoketest.runner import (
        kv_spill_leg,
    )

    r = run_smoketest(level="burnin", env=CPU)
    assert r.ok and r.checks["kv_spill_ok"] is True, r.checks
    assert "kv_spill_ok" not in r.checks["not_ported"]
    assert "kv_spill" in r.checks["leg_seconds"]
    assert r.checks["kv_spill_swapins"] >= 1
    kw = dict(vocab=128, d_model=32, n_heads=4, d_ff=64, n_layers=2,
              seq_len=16, batch=2)
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(14), jcfg)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    flag, rec = kv_spill_leg(params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"), cfg, "cpu")
    # the reference runner's leg, as it runs it
    prompts = [jnp.asarray(p, jnp.int32) for _t, p in shared_prefix_prompts(
        6, seed=3, template_len=8, suffix_lo=1, suffix_hi=4,
        vocab=jcfg.vocab, working_set_blocks=4, block_size=4)]
    budgets = [3, 4, 2, 4, 3, 2]
    ml = max(int(p.shape[-1]) + n for p, n in zip(prompts, budgets))
    want = jax_engine(jp, jcfg, max_len=ml, kv_block=4)(prompts, budgets,
                                                        slots=1)
    spill = jax_engine(jp, jcfg, max_len=ml, kv_block=4, share_prefix=True,
                       prefix_keep_blocks=0, host_spill=True)
    got = spill(prompts, budgets, slots=1, kv_blocks=1 + -(-ml // 4) + 2)
    sp = spill.last_stats["prefix"]["spill"]
    assert all(bool(jnp.array_equal(a, b)) for a, b in zip(got, want))
    assert flag is True
    assert rec == {"kv_spill_swapins": sp["swapins"],
                   "kv_spill_spilled_blocks": sp["spilled_blocks"]}


def test_fleet_scale_and_prefix_cdn_legs_equal_the_jax_runner_legs(
        tmp_path):
    """``fleet_scale_ok`` and ``prefix_cdn_ok`` run at ``burnin`` (off
    ``not_ported``, their seconds recorded; the CDN leg on the durable
    directory ``TPU_PREFIX_DISK_SPILL`` names, which it keeps), and the
    legs on the reference runner's configs and weights
    (``init_params(PRNGKey(13))`` and ``(23)``) report the warm blocks,
    restored chains and store hits the reference's legs report, the
    joiner hitting on both, every verdict true."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nvidia_terraform_modules_tpu.models import burnin as jburnin
    from nvidia_terraform_modules_tpu.models.fleet import (
        AutoscalePolicy,
    )
    from nvidia_terraform_modules_tpu.models.fleet import (
        make_fleet as jax_fleet,
    )
    from nvidia_terraform_modules_tpu.utils.traffic import (
        shared_prefix_prompts,
    )
    from nvidia_terraform_modules_tpu_torch.models import params_from_numpy
    from nvidia_terraform_modules_tpu_torch.smoketest.runner import (
        fleet_scale_leg,
        prefix_cdn_leg,
    )

    spill = tmp_path / "cdn"
    r = run_smoketest(level="burnin", env={
        **CPU, "TPU_PREFIX_DISK_SPILL": str(spill)})
    assert r.ok, r.checks
    for key in ("fleet_scale", "prefix_cdn"):
        assert r.checks[f"{key}_ok"] is True
        assert f"{key}_ok" not in r.checks["not_ported"]
        assert key in r.checks["leg_seconds"]
    assert r.checks["prefix_cdn_durable_dir"] is True
    assert (spill / "objects").is_dir()
    kw = dict(vocab=128, d_model=32, n_heads=4, d_ff=64, n_layers=2,
              seq_len=16, batch=2)
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)

    def weights(seed):
        jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
        return jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")

    def wave(n, seed, templates, budgets):
        prompts = [jnp.asarray(p, jnp.int32) for _t, p in
                   shared_prefix_prompts(n, seed=seed,
                                         n_templates=templates,
                                         template_len=8, suffix_lo=1,
                                         suffix_hi=4, vocab=jcfg.vocab)]
        return prompts, max(int(p.shape[-1]) + b
                            for p, b in zip(prompts, budgets))

    # the reference runner's fleet_scale leg, as it runs it
    jp, params = weights(13)
    budgets = [3, 4, 2, 4, 3, 2, 4, 3, 2, 3, 4, 2]
    prompts, ml = wave(12, 6, 4, budgets)
    elastic = jax_fleet(
        jp, jcfg, max_len=ml, replicas=1, kv_block=4, share_prefix=True,
        host_spill=True, host_blocks=64, prefix_keep_blocks=16,
        est_token_s=0.02, steal=False,
        autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3,
                                  up_backlog=2.0, down_backlog=0.5,
                                  cooldown_s=0.05, seed=0))
    arrivals = [0.0] * 8 + [0.5 + 0.25 * i for i in range(4)]
    for _ in range(2):
        elastic(prompts, budgets, slots=2, arrivals=arrivals)
    sc = elastic.last_stats["fleet"]["scale"]
    reps = elastic.last_stats["replica_stats"]
    flag, rec = fleet_scale_leg(params, cfg, "cpu")
    assert flag is True
    assert rec["fleet_scale_warm_blocks"] == sum(
        rs["prefix"]["warm"]["seeded_blocks"] for rs in reps if rs)
    # the joiner's hits depend on which of its admissions share a wave (a
    # chain registers once its prefill ran): both sides hit, counts vary
    assert rec["fleet_scale_joiner_hits"] > 0 and sum(
        rs["prefix"]["hit_blocks"] for i, rs in enumerate(reps)
        if rs and i >= sc["initial"]) > 0
    # the reference runner's prefix_cdn leg, over a directory of its own
    jp, params = weights(23)
    budgets = [3, 4, 2, 4, 3, 2]
    prompts, ml = wave(6, 7, 2, budgets)
    for _ in range(2):
        fl = jax_fleet(jp, jcfg, max_len=ml, replicas=2, kv_block=4,
                       share_prefix=True, steal=False,
                       disk_spill=str(tmp_path / "jax_cdn"))
        fl(prompts, budgets, slots=2)
    flag, rec = prefix_cdn_leg(params, cfg, "cpu")
    assert flag is True
    assert rec == {"prefix_cdn_durable_dir": False,
                   "prefix_cdn_restored_chains": fl.cdn_store.disk_restored,
                   "prefix_cdn_hit_blocks":
                       fl.last_stats["fleet"]["cdn"]["store"][
                           "fetch_blocks"]}


def test_json_line_contract():
    r = run_smoketest(level="psum", env=CPU)
    parsed = json.loads(r.to_json())
    assert parsed["ok"] is True
    assert "seconds" in parsed and "leg_seconds" in parsed


def test_unknown_level_rejected():
    with pytest.raises(ValueError, match="psum|probes|burnin|full"):
        run_smoketest(level="nope", env=CPU)


def test_every_reference_leg_runs_or_is_listed_not_ported(tmp_path):
    """Each ``*_ok`` key of the reference's runner is either run by the
    port at ``full`` (with a checkpoint directory, so the supervised
    burn-in runs) or listed under ``not_ported`` with its ROADMAP item;
    the rest need more than one slice, a failing checkpoint store, an
    ``ep`` axis, or — the full level's fabric legs — two devices (a world
    of one sets ``full_skipped``; the world of 4 runs them)."""
    import nvidia_terraform_modules_tpu.smoketest.runner as jrunner

    source = Path(jrunner.__file__).read_text()
    ref_keys = set(re.findall(r'checks\["(\w+_ok)"\]', source))
    ref_keys |= {f"{p}_ok" for p in ("psum", "all_gather", "reduce_scatter",
                                     "ring_permute", "all_to_all")}
    r = run_smoketest(level="full", env={
        **CPU, "TPU_SMOKETEST_CHECKPOINT_DIR": str(tmp_path)})
    assert r.ok, r.checks
    assert r.checks["burnin_checkpoint_saved"] == 5
    assert r.checks["burnin_checkpoint_cleared"] >= 1
    listed = r.checks["not_ported"]
    assert all(re.match(r"ROADMAP Queue A item \d+|not queued", v)
               for v in listed.values())
    assert not any("item 11" in v for v in listed.values())
    run_keys = {k for k in r.checks if k.endswith("_ok")}
    assert not run_keys & set(listed)
    conditional = {"dcn_psum_ok", "hier_psum_ok", "burnin_checkpoint_ok",
                   "device_count_ok", "all_gather_ok", "reduce_scatter_ok",
                   "ring_permute_ok", "all_to_all_ok", "all_to_all_ep_ok",
                   "moe_ok", "pipeline_ok", "serving_ok"}
    assert ref_keys - run_keys - set(listed) <= conditional
    assert r.checks["full_skipped"] == "ep/pp fabric needs >= 2 devices"
    assert "pipeline_ok" not in listed and "pipeline_ok" in ref_keys
    assert not {"all_to_all_ep_ok", "moe_ok", "serving_ok"} & set(listed)


def _ckpt_env(d):
    return {**CPU, "TPU_SMOKETEST_CHECKPOINT_DIR": str(d)}


def _plant(d, step):
    """Step ``step`` of the runner's own config (``BurnInConfig(batch=
    max(8, 2·data_shards))``: 8 in a world of one), as a preempted pod
    leaves it."""
    params = init_params(BurnInConfig(batch=8),
                         torch.Generator().manual_seed(0), device="cpu")
    save_checkpoint(str(d), step, params)


def test_smoketest_job_resume_contract(tmp_path):
    """A fresh run saves each step then clears on success; a preempted
    pod (a checkpoint left behind, no clear) resumes at the saved global
    step and runs 5 more."""
    env = _ckpt_env(tmp_path)
    first = run_smoketest(level="burnin", env=env)
    assert first.ok, first.checks
    c = first.checks
    assert "burnin_resumed_step" not in c
    assert c["burnin_step"] == 5 and c["burnin_checkpoint_saved"] == 5
    assert c["burnin_checkpoint_cleared"] >= 1
    assert latest_step(str(tmp_path)) is None
    assert "checkpoint_quarantined" not in c
    _plant(tmp_path, 3)
    second = run_smoketest(level="burnin", env=env)
    assert second.ok, second.checks
    assert second.checks["burnin_resumed_step"] == 3
    assert second.checks["burnin_step"] == 8
    assert second.checks["burnin_checkpoint_saved"] == 8
    assert latest_step(str(tmp_path)) is None


def test_smoketest_corrupt_checkpoint_quarantined_not_fatal(tmp_path):
    """A truncated checkpoint does not wedge the Job: it is quarantined,
    the run starts fresh, and the JSON line counts the quarantine."""
    d = tmp_path / "ckpt"
    _plant(d, 3)
    shard = next((d / "step_00000003").glob("shards_p*.bin"))
    shard.write_bytes(shard.read_bytes()[:16])
    r = run_smoketest(level="burnin", env=_ckpt_env(d))
    assert r.ok, r.checks
    assert r.checks["checkpoint_quarantined"] == 1
    assert "burnin_resumed_step" not in r.checks
    assert r.checks["burnin_step"] == 5


@pytest.mark.parametrize("where", ["file", "gs"])
def test_smoketest_checkpoint_failure_keeps_json_contract(tmp_path, where):
    """A broken checkpoint STORE (a file where the directory should be;
    a gs:// prefix, whose backend the port does not have) fails through
    the JSON contract — ok false and ``checkpoint_error`` — never as a
    traceback, and never by training without checkpoints."""
    if where == "file":     # no step to restore: the first save fails
        d, stage = tmp_path / "ckpt", "save: "
        d.write_text("not a directory")
    else:                   # the constructor refuses the prefix
        d, stage = "gs://bucket/smoketest", "restore: "
    r = run_smoketest(level="burnin", env=_ckpt_env(d))
    assert r.ok is False
    assert r.checks["burnin_checkpoint_ok"] is False
    assert r.checks["checkpoint_error"].startswith(stage)
    assert "burnin_ok" not in r.checks
    if where == "gs":
        assert "Queue A item 13" in r.checks["checkpoint_error"]
        assert not os.path.exists("gs:")


def test_world_of_two_resumes_a_step_planted_by_a_world_of_four(
        tmp_path_factory):
    """Elastic resume through the Job contract: a world of 4 (tp 4)
    plants step 3; a world of 2 (tp 2) re-shards it, resumes at 3, runs
    to 8, passes every leg and clears the directory."""
    d = tmp_path_factory.mktemp("planted") / "ckpt"
    meshes = run_world("plant_checkpoint", 4,
                       tmp_path_factory.mktemp("plant4"),
                       {"dir": str(d), "step": 3, "batch": 8}, timeout=120)
    assert meshes[0] == {"dp": 1, "sp": 1, "tp": 4}
    ranks = run_world("smoketest", 2, tmp_path_factory.mktemp("resume2"),
                      {"runs": [("burnin", {**_ckpt_env(d),
                                            "LOCAL_WORLD_SIZE": "2"})]},
                      timeout=180)
    for r in ranks:
        c = r[0]["checks"]
        assert r[0]["ok"] is True, c
        assert c["mesh"] == {"dp": 1, "sp": 1, "tp": 2}
        assert c["burnin_resumed_step"] == 3 and c["burnin_step"] == 8
        assert c["burnin_checkpoint_saved"] == 8
        assert c["burnin_checkpoint_cleared"] >= 1
    assert latest_step(str(d)) is None


def test_a_failing_leg_is_recorded_and_fails_the_run(monkeypatch):
    import nvidia_terraform_modules_tpu_torch.smoketest.runner as runner

    def broken(*a, **k):
        raise RuntimeError("engine refused")

    monkeypatch.setattr(runner, "make_serve_engine", broken)
    r = run_smoketest(level="burnin", env=CPU)
    assert r.ok is False
    assert r.checks["burnin_ok"] and r.checks["decode_ok"]
    assert r.checks["serve_engine_ok"] is False
    assert r.checks["serve_engine_error"] == "engine refused"
    assert "serve_sched_ok" not in r.checks


def test_cli_without_a_card_or_a_cpu_steer_exits_non_zero():
    env = {k: v for k, v in os.environ.items()
           if k != "TPU_SMOKETEST_PLATFORM"}
    out = subprocess.run(
        [sys.executable, "-m", "nvidia_terraform_modules_tpu_torch.smoketest"],
        cwd=ROOT, env={**env, "PYTHONPATH": str(ROOT),
                       "CUDA_VISIBLE_DEVICES": "", "TPU_SMOKETEST_LEVEL":
                       "psum"}, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["ok"] is False and "psum_ok" not in line


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_two_hosts_over_gloo():
    """Two processes of the indexed Job (one device a host, so two
    slices) through the CLI: each host prints one line, and both pass the
    cross-host legs."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nvidia_terraform_modules_tpu_torch.smoketest"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT),
                       "OMP_NUM_THREADS": "1", **CPU,
                       "TPU_SMOKETEST_LEVEL": "burnin",
                       "TPU_SMOKETEST_EXPECTED_DEVICES": "2",
                       "TPU_SMOKETEST_HOSTS": "2",
                       "JOB_COMPLETION_INDEX": str(i),
                       "TPU_SMOKETEST_COORDINATOR": f"localhost:{port}",
                       "TPU_SMOKETEST_INIT_TIMEOUT": "60"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for i in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-3000:]
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        assert len(lines) == 1, out
        c = json.loads(lines[0])
        assert c["ok"] is True and c["process_id"] == i
        assert c["num_processes"] == 2 and c["slices"] == 2
        assert c["psum_participants"] == 2
        assert c["dcn_psum_ok"] and c["hier_psum_ok"]
        assert c["mesh"] == {"slice": 2, "dp": 1, "sp": 1, "tp": 1}
        assert c["burnin_ok"] and all(c[key] for key in SERVE_LEGS)
