"""Knee sweep of an open-loop serve cell: one set-up, then one window at
each fixed offered rate, in the order given. For each rate it prints the
latency p50/p95, the completed tokens/s, the queue wait p95, and the
backlog's trend: the mean queue wait of the window's last third of
requests against its first third (a backlog that grows through the window
shows as a last third far above the first). The knee is the highest rate
whose backlog does not grow; a cell offers 0.8 × the knee.

    python3 -m portbench.sweep --workload <cell> --seed <n> --seconds <s> \\
        --rates 60,100,140
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

from portbench import harness

CACHE = Path(__file__).resolve().parent.parent / ".portbench_cache"


def trend(w: dict) -> tuple[float, float]:
    """Mean queue wait (ms) of the first and the last third of the
    requests, in due order."""
    waits = [(p - d) * 1e3 for p, d in zip(w["popped"], w["dues"])
             if p is not None]
    third = max(1, len(waits) // 3)
    return statistics.fmean(waits[:third]), statistics.fmean(waits[-third:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench()
    job = bench.job(args.workload, args.seed, args.seconds, False, "cuda")
    kind = bench.kind(job.traffic["kind"])
    cell = kind.ServeCell(job)
    for rate in [float(r) for r in args.rates.split(",")]:
        w = cell.window(rate, args.seconds, args.seed)
        e2e, ctx, failed = kind.summarise(w, job.config)
        first, last = trend(w)
        serve = ctx["serve"]
        print(json.dumps({
            "workload": args.workload, "rate_rps": rate,
            "requests": len(w["dues"]), "failed": failed,
            "serve_p95_ms": e2e["serve_p95_ms"],
            "latency_p50_ms": serve["latency_p50_ms"],
            "serve_tokens_per_s": serve["tokens"]
            / (args.seconds + serve["drain_s"]),
            "queue_wait_p95_ms": harness.Bench().metric(
                "queue_wait_p95_ms").read(ctx),
            "wait_first_third_ms": first, "wait_last_third_ms": last,
            "tokens_per_wave": serve["generated"] / max(1, serve["waves"]),
            "kv_mean_utilisation": serve["kv_mean_utilisation"],
            "drain_s": serve["drain_s"],
            "memory_peak_bytes": w["memory"],
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main())
