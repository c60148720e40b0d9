"""Every piece of the benchmark parses and is found by name; a new cell,
configuration, traffic mix and metric are picked up as new files alone."""

from __future__ import annotations

import json
import shutil

import pytest

from portbench import harness
from portbench.tests.conftest import make_tiny

SPEC = json.loads(harness.BENCHMARK.read_text())


def test_every_data_file_parses():
    for folder in ("configs", "workloads", "traffic"):
        files = sorted((harness.PKG / folder).glob("*.json"))
        assert files, folder
        for f in files:
            assert isinstance(json.loads(f.read_text()), dict), f


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_pieces(cell):
    bench = harness.Bench()
    c = bench.cell(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert (c["config"], c["traffic"], c["chips"], c["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert bench.config(c["config"])["name"] == c["config"]
    kind = bench.kind(bench.traffic(c["traffic"])["kind"])
    assert callable(kind.run)
    names = [m["name"] for m in bench.end_to_end(cell)]
    assert "setup_s" in names and len(names) >= 2
    assert bench.per_layer(cell), cell


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_metric_has_a_reader(metric):
    reader = harness.Bench().metric(metric)
    assert reader.read({}) is None       # nothing to read → nothing


def test_config_files_match_benchmark_json():
    for c in SPEC["configs"]:
        path = harness.PKG.parent / c["file"]
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert c["reduced"] == []


def test_a_new_cell_config_mix_and_metric_are_files_alone(tmp_path):
    root = make_tiny(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs/flagship-dense.json").read_text())
    cfg.update(name="dummy-model", n_layers=1)
    (pb / "configs/dummy-model.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic/train_4k.json").read_text())
    mix.update(seq_len=8)
    (pb / "traffic/dummy-mix.json").write_text(json.dumps(mix))
    cell = json.loads((pb / "workloads/dense-train-4k.json").read_text())
    cell.update(name="dummy-cell", config="dummy-model", traffic="dummy-mix")
    (pb / "workloads/dummy-cell.json").write_text(json.dumps(cell))
    (pb / "metrics/dummy_steps.py").write_text(
        "def read(ctx):\n"
        "    t = ctx.get('train')\n"
        "    return None if not t else float(t['steps'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy-model",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("dummy-cell")
    spec["per_layer"].append({"name": "dummy_steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "train_tokens_per_s",
                              "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()
             and p in before}
    assert after == before               # no existing file was edited
    bench = harness.Bench(pb, root / "BENCHMARK.json")
    job = bench.job("dummy-cell", 4, 0.2, True, "cpu")
    assert job.config["n_layers"] == 1 and job.traffic["seq_len"] == 8
    out = harness.execute(bench, job)
    line = harness.result(bench, job, out, 1.0, {"platform": "cpu"})
    assert line["correct"], line
    assert line["metrics"]["dummy_steps"]["value"] >= 1
    shutil.rmtree(root)
