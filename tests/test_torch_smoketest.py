# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the validation Job's payload (``smoketest/``) on the CPU:
the cases of the reference's ``tests/test_smoketest.py`` that the port's
levels cover, in a gloo world of 4 ranks (``_torch_world.py``; the
reference's ``plan_mesh(4)``, so tp 4) and in a world of one in this
process; the legs not run, listed under ``not_ported`` against the
reference's runner; a checkpoint directory that fails the run; the CLI
with no card and no CPU steer; and one 2-process CLI run over gloo in the
manner of ``tests/test_multihost_e2e.py`` (two hosts of the indexed Job,
so two slices).
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

from nvidia_terraform_modules_tpu_torch.smoketest import run_smoketest

ROOT = Path(__file__).resolve().parent.parent
CPU = {"TPU_SMOKETEST_PLATFORM": "cpu"}
# four ranks on one host: one slice
WORLD4 = {**CPU, "LOCAL_WORLD_SIZE": "4"}
SERVE_LEGS = ("decode_ok", "serve_engine_ok", "serve_sched_ok",
              "paged_decode_ok")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The world of 4: burnin, probes, and psum expecting 8 devices; each
    rank's checks of each run."""
    runs = [("burnin", WORLD4), ("probes", WORLD4),
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
        assert c["decode_sharding"] == "gathered"
        assert c["serve_sched_prefix_hit_blocks"] > 0
        assert "slices" not in c            # one host
    # every rank's line carries the world's verdicts
    verdicts = {json.dumps({k: v for k, v in runs[0]["checks"].items()
                            if k.endswith("_ok")}, sort_keys=True)
                for runs in world4}
    assert len(verdicts) == 1


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


def test_json_line_contract():
    r = run_smoketest(level="psum", env=CPU)
    parsed = json.loads(r.to_json())
    assert parsed["ok"] is True
    assert "seconds" in parsed and "leg_seconds" in parsed


def test_unknown_level_rejected():
    with pytest.raises(ValueError, match="psum|probes|burnin|full"):
        run_smoketest(level="nope", env=CPU)


def test_every_reference_leg_runs_or_is_listed_not_ported():
    """Each ``*_ok`` key of the reference's runner is either run by the
    port at ``full`` or listed under ``not_ported`` with its ROADMAP item;
    the rest need more than one slice, a checkpoint directory, or an
    ``ep`` axis (asserted elsewhere)."""
    import nvidia_terraform_modules_tpu.smoketest.runner as jrunner

    source = Path(jrunner.__file__).read_text()
    ref_keys = set(re.findall(r'checks\["(\w+_ok)"\]', source))
    ref_keys |= {f"{p}_ok" for p in ("psum", "all_gather", "reduce_scatter",
                                     "ring_permute", "all_to_all")}
    r = run_smoketest(level="full", env=CPU)
    assert r.ok, r.checks
    listed = r.checks["not_ported"]
    assert all(re.match(r"ROADMAP Queue A item \d+|not queued", v)
               for v in listed.values())
    run_keys = {k for k in r.checks if k.endswith("_ok")}
    assert not run_keys & set(listed)
    conditional = {"dcn_psum_ok", "hier_psum_ok", "burnin_checkpoint_ok",
                   "device_count_ok", "all_gather_ok", "reduce_scatter_ok",
                   "ring_permute_ok", "all_to_all_ok"}
    assert ref_keys - run_keys - set(listed) <= conditional
    assert {"all_to_all_ep_ok", "moe_ok", "pipeline_ok",
            "serving_ok"} <= set(listed)


def test_checkpoint_dir_fails_instead_of_training_without_it(tmp_path):
    r = run_smoketest(level="burnin", env={
        **CPU, "TPU_SMOKETEST_CHECKPOINT_DIR": str(tmp_path)})
    assert r.ok is False
    assert r.checks["burnin_checkpoint_ok"] is False
    assert "item 11" in r.checks["checkpoint_error"]
    assert "burnin_ok" not in r.checks


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
