"""Finds the benchmark's pieces by name and runs one cell.

- a cell: ``workloads/<cell>.json`` (its configuration, traffic mix,
  chips, why, and the limits of the numbers its check compares);
- a configuration: ``configs/<name>.json``;
- a traffic mix: ``traffic/<mix>.json``, whose ``kind`` names the general
  generator ``traffic/<kind>.py`` that reads it;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns
  the number, or None where its run has nothing to read;
- which metrics a cell reports, and their units: ``BENCHMARK.json``.

A kind's ``run(job)`` sets up, measures for ``job.seconds`` and checks,
and returns an :class:`Outcome`. Nothing here decides on a device: the
command line (:mod:`portbench.run`) refuses a run without a card, and the
tests hand in the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
from pathlib import Path
from typing import Any, Callable

PKG = Path(__file__).resolve().parent
BENCHMARK = PKG.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "nvidia_terraform_modules_tpu")


def forbidden_modules(names) -> list[str]:
    """The JAX-side top-level names among module names ``names`` (the
    part before the first dot, compared whole)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Job:
    """One run of one cell, as a kind sees it."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    # a planted fault, or the control in the program's place, called as
    # fault(point, value) where the timed path hands its state on (None:
    # the program)
    fault: Callable | None = None


@dataclasses.dataclass
class Outcome:
    """What a kind's run gives the harness."""
    window_start: float            # time.monotonic() at the window's start
    end_to_end: dict[str, float]
    context: dict[str, Any]        # what the per-layer readers read
    compared: dict[str, tuple]     # name → (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None      # trace.summarise()'s, with --trace 1
    notes: dict = dataclasses.field(default_factory=dict)


class Bench:
    """The benchmark's files under ``root`` (default: this package) and
    its ``BENCHMARK.json``."""

    def __init__(self, root: Path | str = PKG,
                 benchmark: Path | str = BENCHMARK):
        self.root = Path(root)
        self.spec = json.loads(Path(benchmark).read_text())

    def _json(self, folder: str, name: str) -> dict:
        return json.loads((self.root / folder / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        cell = self._json("workloads", name)
        if cell.get("name", name) != name:
            raise ValueError(f"workloads/{name}.json names {cell['name']!r}")
        return cell

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def _module(self, folder: str, name: str):
        path = self.root / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def kind(self, name: str):
        return self._module("traffic", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def _applies(self, metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        """The cell's per-layer metrics: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def chips(self, cell: str) -> int:
        for w in self.spec["workloads"]:
            if w["name"] == cell:
                return int(w["chips"])
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")

    def job(self, cell: str, seed: int, seconds: float, trace: bool,
            device: str, fault=None) -> Job:
        c = self.cell(cell)
        return Job(cell=c, config=self.config(c["config"]),
                   traffic=self.traffic(c["traffic"]), seed=seed,
                   seconds=seconds, trace=trace, device=device, fault=fault)


def execute(bench: Bench, job: Job) -> Outcome:
    """Run ``job`` through its traffic kind."""
    return bench.kind(job.traffic["kind"]).run(job)


def result(bench: Bench, job: Job, out: Outcome, setup_s: float,
           device: dict) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or
    its per-layer metrics (``--trace 1``), ``correct`` from every compared
    number against its limit, and the compared numbers last."""
    name = job.cell["name"]
    metrics = {}
    if job.trace:
        ctx = dict(out.context, trace=out.trace)
        for m in bench.per_layer(name):
            value = bench.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.end_to_end, setup_s=setup_s)
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    # nothing compared is nothing shown: such a run is not correct
    correct = out.failed == 0 and bool(out.compared) and all(
        v is not None and v <= lim for v, lim in out.compared.values())
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if job.trace and out.trace is not None:
        line["breakdown"] = out.trace["breakdown"]
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.compared.items()}
    return line


def monotonic_process_start() -> float:
    """``time.monotonic()`` at this process's start (its age from
    ``/proc``), or now where that cannot be read."""
    try:
        import os
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.monotonic()
