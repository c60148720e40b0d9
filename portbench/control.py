"""The readings the limits of ``correct`` are set from, at a cell's own
size, many seeds in one process (set-up is the long part):

- the program's reading on each seed (a sound run: the lower reading);
- the control's: the reference put in the program's place, computed in
  float8 e4m3 (the precision below the configuration's bf16);
- for train cells, the planted fault "half of the batch left out, the
  mean taken over the rest" (the step sees the first half of each
  batch's rows).

Serve cells serve ``--seconds`` of the cell's own traffic at its rate per
seed and read the sample a run reads. Prints one JSON line a seed.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 6

:class:`Fp8Control` is the same control as a fault of a whole run: handed
to a job, it puts the fp8 reference's outputs in the program's place, so
the harness's own comparison judges them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from portbench import harness

CACHE = Path(__file__).resolve().parent.parent / ".portbench_cache"


class Fp8Control:
    """The fp8 reference in the program's place, for a job's ``fault``:
    a train cell's step becomes the reference's fp8 SGD step on the
    program's state (loss and parameters after each step, each leaf kept
    in its stored type); a serve cell's checked requests get, at each
    served position, the token the fp8 reference puts first there."""

    def __init__(self, job: harness.Job):
        self.m, self.tr = job.config, job.traffic
        self.seed, self.device = job.seed, job.device

    def __call__(self, point, value):
        if point == "train_step":
            return self._step
        if point == "checked":
            return self._picks(value)
        return value

    def _step(self, state, batch):
        import torch

        from portbench import weights
        from portbench.reference import model as ref
        stored = [t.dtype for _, t in weights.leaves(state)]
        params = weights.to_float(state)
        with ref.exact():
            value, _ = ref.sgd_step(params, batch, self.m, self.tr["lr"],
                                    stored, fp8=True)
        flat = iter(t.to(dt) for t, dt in zip(ref.leaves(params), stored))

        def take(tree):
            return {k: {kk: next(flat) for kk in v} if isinstance(v, dict)
                    else next(flat) for k, v in tree.items()}
        new = {"embed": next(flat), "out_norm": next(flat)}
        new["layers"] = [take(layer) for layer in state["layers"]]
        return new, torch.tensor(value)

    def _picks(self, seqs):
        import torch

        from portbench import weights
        from portbench.reference import model as ref
        dev = torch.device(self.device)
        params = weights.to_float(weights.make(self.m, self.seed, dev))
        out = []
        with ref.exact():
            for prompt, served in seqs:
                seq = torch.cat([prompt, served[:-1]]).to(dev)
                at = slice(prompt.shape[0] - 1, None)
                pick = ref.serve_logits(params, seq, self.m, fp8=True)[at]
                out.append((prompt, pick.argmax(dim=-1).cpu()))
        return out


def half_batch(point, step):
    """The planted fault: the step sees the first half of each batch."""
    if point != "train_step":
        return step

    def broken(params, batch):
        half = batch[0].shape[0] // 2
        return step(params, tuple(x[:half] for x in batch))
    return broken


def serve_seed(bench, cell: str, seed: int, seconds: float, device: str):
    job = bench.job(cell, seed, seconds, False, device)
    kind = bench.kind(job.traffic["kind"])
    sc = kind.ServeCell(job)
    w = sc.window(job.cell["rate_rps"], seconds, seed)
    picked = kind.sample(w, seed, job.traffic)
    seqs = [(w["prompts"][r].cpu(), w["outs"][r].cpu()) for r in picked]
    e2e, _, failed = kind.summarise(w, job.config)
    sc.close()
    del w
    got = kind.logit_gaps(job.config, seed, device, seqs, control=True)
    return {**got, "failed": failed, "checked_requests": len(picked),
            "checked_tokens": sum(int(s.shape[0]) for _, s in seqs), **e2e}


def train_seed(bench, cell: str, seed: int, device: str, faults: bool):
    import gc

    import torch
    job = bench.job(cell, seed, 0.0, False, device)
    kind = bench.kind(job.traffic["kind"])
    m, tr = job.config, job.traffic
    from portbench import program, weights
    cfg = program.config(m, seq_len=tr["seq_len"], batch=tr["batch"])
    n = tr["check_steps"]

    def prog_readings(fault=None):
        step = program.train_step(cfg, tr["lr"], device)
        if fault is not None:
            step = fault("train_step", step)
        feed = kind.Feed(m, tr, seed, device)
        params = weights.make(m, seed, device)
        state, loss, grad, change = kind.program_steps(job, step, params,
                                                       feed, n)
        del state, params, step
        gc.collect()
        torch.cuda.empty_cache()
        return loss, grad, change

    prog = prog_readings()
    half = prog_readings(half_batch) if faults else None
    refr = kind.reference_steps(m, tr, seed, device, n)
    gc.collect()
    torch.cuda.empty_cache()
    low = kind.reference_steps(m, tr, seed, device, n, fp8=True)
    out = {"program": kind.readings(prog, refr),
           "control": kind.readings(low[:3], refr),
           "losses": {"program": prog[0], "reference": refr[0],
                      "control": low[0]}}
    if half is not None:
        out["half_batch"] = kind.readings(half, refr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--faults", type=int, default=1)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench()
    kind = bench.traffic(bench.cell(args.workload)["traffic"])["kind"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        if kind == "serve_open_loop":
            got = serve_seed(bench, args.workload, seed, args.seconds, "cuda")
        else:
            got = train_seed(bench, args.workload, seed, "cuda",
                             bool(args.faults))
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
