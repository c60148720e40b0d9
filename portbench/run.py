"""Run one cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds``, checks the outputs against
the plain reference, and prints one JSON line as the last line of standard
output (the compared numbers beside their limits also as the last lines of
standard error). Exits non-zero, printing no result, without the CUDA
cards the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from portbench import harness, trace

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".portbench_cache"


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return got.stdout.strip().splitlines()[0] if got.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    start = harness.monotonic_process_start()
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # fixed cache directories inside the checkout, before the port loads
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    bench = harness.Bench()
    chips = bench.chips(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    job = bench.job(args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda")
    out = harness.execute(bench, job)
    setup_s = out.window_start - start
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: JAX-side modules loaded: {bad}", file=sys.stderr)
        return 3
    name = torch.cuda.get_device_name(0)
    power = _power_limit()
    device = {"platform": "gpu", "kind": name, "count": chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
    line = harness.result(bench, job, out, setup_s, device)
    line["device"]["power_limit"] = power
    print(f"portbench: {name}, power limit {power}; notes "
          f"{json.dumps(out.notes)}", file=sys.stderr)
    if out.trace is not None:
        counted = out.context.get("launches_traced", {})
        for kernel, counter in trace.WATCHED.items():
            print(f"trace records: {kernel} {out.trace['records'][kernel]} "
                  f"seen of {counted.get(counter, 0)} launched",
                  file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"compared {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
