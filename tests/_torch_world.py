# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Spawn a ``torch.distributed`` gloo world on the CPU for the port's tests.

:func:`run_world` starts ``n`` Python processes (this file as a script),
each of which joins a gloo world over a ``file://`` store under the test's
``tmp_path`` (no TCP port, so parallel test workers never collide), calls
one of the functions below with the test's arguments, and writes its
return value back as a pickle. The parent waits with a deadline and kills
every process of the world when it passes. The children import torch and
the port only: the tests compare their results with the JAX reference in
the parent.
"""

from __future__ import annotations

import datetime
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_world(target: str, n: int, tmp_path, args=None, *,
              timeout: float = 120.0) -> list:
    """Run ``target`` (a function of this module) on ranks ``0..n-1`` of a
    gloo world; returns the ranks' results in rank order. Raises with the
    ranks' output when one fails or the deadline passes."""
    tmp = Path(tmp_path) / f"world_{target}"
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "args.pkl").write_bytes(pickle.dumps(args))
    child_env = {**os.environ, "PYTHONPATH": str(ROOT),
                 "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, target, str(rank), str(n), str(tmp)],
        cwd=ROOT, env=child_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for rank in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for p in procs:
            p.wait()
        raise AssertionError(f"world {target} of {n} passed its {timeout}s "
                             f"deadline")
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise AssertionError("\n".join(
            f"rank {r} exited {rc}:\n{o[-4000:]}" for r, rc, o in bad))
    return [pickle.loads((tmp / f"out_{r}.pkl").read_bytes())
            for r in range(n)]


# ------------------------------------------------------ the ranks' work


def collectives(rank, n, args):
    """The five probes and the hierarchical psum: on the flat mesh (dp
    n), on the 2 × 2 multislice mesh (slice × dp) over both axes, a ring
    on an axis of one, and a psum with a fault planted on rank 2."""
    import torch
    import torch.distributed as dist

    from nvidia_terraform_modules_tpu_torch.parallel import (
        ALL_PROBES,
        build_mesh,
        build_multislice_mesh,
        hierarchical_psum,
        hierarchical_psum_probe,
        plan_mesh,
        plan_multislice,
        psum_probe,
        ring_permute_probe,
    )

    flat = build_mesh(plan_mesh(n, tp=1))
    ms = build_multislice_mesh(plan_multislice(n, 2, tp=1))
    out = {"flat": {}, "slice": {}, "dp": {}}
    for name, probe in ALL_PROBES.items():
        out["flat"][name] = probe(flat, axis="dp", n_elems=256)
        for axis in ("slice", "dp"):
            out[axis][name] = probe(ms, axis=axis, n_elems=256)
    out["ring_of_one"] = ring_permute_probe(ms, axis="tp", n_elems=64)
    out["hier_probe"] = hierarchical_psum_probe(ms, n_elems=257)
    x = torch.from_numpy(args["inputs"][rank])
    out["hier"] = hierarchical_psum(x, ms).numpy()
    flat_sum = x.clone()
    dist.all_reduce(flat_sum, group=ms.group(("slice", "dp")))
    out["flat_sum"] = flat_sum.numpy()
    out["planted"] = psum_probe(flat, axis="dp", n_elems=128,
                                offset=0.5 if rank == 2 else 0.0)
    out["coords"] = (ms.coords, ms.line("dp"), ms.line("slice"))
    return out


def sharded_train(rank, n, args):
    """The sharded SGD step for each case: ``shard_params`` and back,
    ``steps`` steps, the losses and the gathered parameters; then the
    refusals, each as its exception's type and message."""
    import dataclasses

    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        gather_params,
        make_train_step,
        params_from_numpy,
        params_to_numpy,
        shard_batch,
        shard_params,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        make_rules,
        plan_mesh,
    )

    out = {}
    for case in args["cases"]:
        cfg = BurnInConfig(**case["cfg"], dtype=torch.float32)
        rules = make_rules(build_mesh(plan_mesh(n, tp=case["tp"])))
        full = params_from_numpy(case["params"], cfg, device="cpu")
        params = shard_params(full, rules)
        back = gather_params(params, rules)
        roundtrip = all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(back), tree_leaves(full)))
        batch = shard_batch(tuple(torch.from_numpy(x).long()
                                  for x in case["batch"]), rules)
        step = make_train_step(cfg, rules, lr=case["lr"], device="cpu")
        losses = []
        for _ in range(case["steps"]):
            params, loss = step(params, batch)
            losses.append(float(loss))
        final = params_to_numpy(gather_params(params, rules))
        out[case["name"]] = {"roundtrip": roundtrip, "losses": losses,
                             "params": final if rank == 0 else None,
                             "local_rows": int(batch[0].shape[0]),
                             "mesh": dict(rules.mesh.shape)}
    refusals = {}
    base = BurnInConfig(**args["cases"][0]["cfg"], dtype=torch.float32)
    for name, over, plan in (
            ("tp_heads", dict(n_heads=2, n_kv_heads=None), dict(tp=4)),
            ("tp_kv_heads", dict(n_kv_heads=2), dict(tp=4)),
            ("tp_d_ff", dict(d_ff=66), dict(tp=4)),
            ("moe", dict(n_experts=2), dict(tp=2)),
            ("sp_with_tp", {}, dict(tp=2, sp=2)),
            ("sp_alone", {}, dict(tp=1, sp=4))):
        cfg = dataclasses.replace(base, **over)
        rules = make_rules(build_mesh(plan_mesh(n, **plan)))
        try:
            make_train_step(cfg, rules, device="cpu")
            refusals[name] = None
        except (ValueError, NotImplementedError) as exc:
            refusals[name] = (type(exc).__name__, str(exc))
    out["refusals"] = refusals
    return out


def smoketest(rank, n, args):
    """``run_smoketest`` at each of ``args["runs"]`` (level, env), in this
    world; the checks of each run."""
    from nvidia_terraform_modules_tpu_torch.smoketest import run_smoketest

    return [run_smoketest(level=level, env=env).__dict__
            for level, env in args["runs"]]


def _main() -> None:
    target, rank, n, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        Path(sys.argv[4])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=90))
    try:
        args = pickle.loads((tmp / "args.pkl").read_bytes())
        result = globals()[target](rank, n, args)
        (tmp / f"out_{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
