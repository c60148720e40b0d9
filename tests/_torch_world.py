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
    """The sharded SGD step for each case (its mesh ``plan_mesh(n,
    **case["plan"])``): ``shard_params`` and back, ``steps`` steps, the
    losses and the gathered parameters; then the refusals, each as its
    exception's type and message."""
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
        rules = make_rules(build_mesh(plan_mesh(n, **case["plan"])))
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
                             "local_seq": int(batch[0].shape[1]),
                             "mesh": dict(rules.mesh.shape)}
    refusals = {}
    base = BurnInConfig(**args["cases"][0]["cfg"], dtype=torch.float32)
    for name, over, plan in (
            ("tp_heads", dict(n_heads=2, n_kv_heads=None), dict(tp=4)),
            ("tp_kv_heads", dict(n_kv_heads=2), dict(tp=4)),
            ("tp_d_ff", dict(d_ff=66), dict(tp=4)),
            ("sp_flash_window", dict(attn="flash", flash_window=4),
             dict(tp=1, sp=2))):
        cfg = dataclasses.replace(base, **over)
        rules = make_rules(build_mesh(plan_mesh(n, **plan)))
        try:
            make_train_step(cfg, rules, device="cpu")
            refusals[name] = None
        except (ValueError, NotImplementedError) as exc:
            refusals[name] = (type(exc).__name__, str(exc))
    out["refusals"] = refusals
    return out


def zero1_adamw(rank, n, args):
    """The ZeRO-1 AdamW step for each case: ``steps`` steps from the
    case's weights, the losses, the gathered parameters and moments (rank
    0), and each rank's moment shapes and dtypes beside its parameters'."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        AdamWConfig,
        BurnInConfig,
        gather_params,
        make_adamw_train_step,
        opt_state_shardings,
        params_from_numpy,
        params_to_numpy,
        shard_batch,
        shard_params,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.models.burnin import _tree_map
    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        make_rules,
    )
    from nvidia_terraform_modules_tpu_torch.parallel.mesh import plan_mesh
    from nvidia_terraform_modules_tpu_torch.parallel.sharding import (
        gather_shards,
    )

    out = {}
    for case in args["cases"]:
        dtype = getattr(torch, case.get("dtype", "float32"))
        cfg = BurnInConfig(**case["cfg"], dtype=dtype)
        rules = make_rules(build_mesh(plan_mesh(n, tp=case["tp"])))
        full = params_from_numpy(case["params"], cfg, device="cpu")
        params = shard_params(full, rules)
        batch = shard_batch(tuple(torch.from_numpy(x).long()
                                  for x in case["batch"]), rules)
        init_state, step = make_adamw_train_step(
            cfg, rules, AdamWConfig(**case["opt"]), device="cpu")
        state = init_state(params)
        losses = []
        for _ in range(case["steps"]):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
        specs = opt_state_shardings(full, rules)["mu"]

        def gathered(tree):
            return params_to_numpy(_tree_map(
                lambda m, spec: gather_shards(m, spec, rules.mesh), tree,
                specs))

        out[case["name"]] = {
            "losses": losses, "step": int(state["step"]),
            "params": params_to_numpy(gather_params(params, rules)),
            "mu": gathered(state["mu"]), "nu": gathered(state["nu"]),
            "local": [(tuple(p.shape), tuple(m.shape), str(m.dtype))
                      for p, m in zip(tree_leaves(params),
                                      tree_leaves(state["mu"]))],
            "mesh": dict(rules.mesh.shape)}
        if rank:
            for key in ("params", "mu", "nu"):
                out[case["name"]][key] = None
    return out


def checkpoint_ops(rank, n, args):
    """Run ``args["ops"]`` in order in this world, each a dict with an
    ``"op"``, and return each op's result (trees gathered on every rank):

    - ``save_state``/``restore_state``: the AdamW train state of
      ``args["cfg"]`` on ``plan_mesh(n, tp=op["tp"])`` — parameters from
      ``args["params"]``, moments ``2·p + 1`` of the global parameter cut to
      this rank's ZeRO-1 slice, step 7;
    - ``save_leaves``/``restore_leaves``: ``{"w": args["w"] + step}``
      placed by ``op["spec"]`` over ``plan_mesh(n, tp=1)``;
    - ``adamw_resume``: 6 AdamW steps straight against 3, a save, a fresh
      checkpointer's restore and 3 more — equal bit for bit?
    """
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        AdamWConfig,
        BurnInConfig,
        Checkpointer,
        abstract_train_state,
        gather_params,
        make_adamw_train_step,
        opt_state_shardings,
        params_from_numpy,
        params_to_numpy,
        shard_batch,
        shard_params,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.models.burnin import _tree_map
    from nvidia_terraform_modules_tpu_torch.parallel import (
        ShapeDtypeStruct,
        build_mesh,
        make_rules,
    )
    from nvidia_terraform_modules_tpu_torch.parallel.mesh import plan_mesh
    from nvidia_terraform_modules_tpu_torch.parallel.sharding import (
        gather_shards,
        local_shard,
    )

    cpu = torch.device("cpu")
    cfg = BurnInConfig(**args["cfg"], dtype=torch.float32)
    full = params_from_numpy(args["params"], cfg, device="cpu")
    w = torch.from_numpy(args["w"])
    out = []
    for op in args["ops"]:
        kind = op["op"]
        if kind.endswith("_state") or kind == "adamw_resume":
            rules = make_rules(build_mesh(plan_mesh(n, tp=op["tp"])))
            abstract = abstract_train_state(cfg, rules, device="cpu")
            specs = opt_state_shardings(full, rules)["mu"]
        else:
            rules = make_rules(build_mesh(plan_mesh(n, tp=1)))
            abstract = {"w": ShapeDtypeStruct(tuple(w.shape), w.dtype, cpu,
                                              tuple(op["spec"]), rules.mesh)}
        with Checkpointer(op["dir"], max_to_keep=8) as ck:
            if kind == "save_state":
                params = shard_params(full, rules)
                mu = _tree_map(lambda p, spec: local_shard(
                    p.float() * 2 + 1, spec, rules.mesh), full, specs)
                state = {"params": params,
                         "opt": {"step": torch.tensor(7, dtype=torch.int32),
                                 "mu": mu, "nu": mu}}
                ck.save(7, state, meta={"world": n}, layout=abstract)
                out.append({"mesh": dict(rules.mesh.shape)})
            elif kind == "restore_state":
                tree, step, meta = ck.restore_tree(abstract)
                out.append({
                    "step": step, "meta": meta, "mesh": dict(rules.mesh.shape),
                    "stored_world": ck.stored_world(step),
                    "opt_step": int(tree["opt"]["step"]),
                    "params": params_to_numpy(gather_params(tree["params"],
                                                            rules)),
                    "mu": params_to_numpy(_tree_map(
                        lambda m, spec: gather_shards(m, spec, rules.mesh),
                        tree["opt"]["mu"], specs)),
                    "local_mu": [tuple(m.shape) for m in
                                 tree_leaves(tree["opt"]["mu"])]})
            elif kind == "save_leaves":
                for step in op["steps"]:
                    piece = local_shard(w + step, tuple(op["spec"]),
                                        rules.mesh)
                    ck.save(step, {"w": piece}, layout=abstract)
                out.append({})
            elif kind == "restore_leaves":
                got = ck.restore_tree(abstract)
                if got is None:
                    out.append(None)
                    continue
                tree, step, _ = got
                out.append({"step": step, "piece": tree["w"].numpy(),
                            "bounds": abstract["w"].bounds(),
                            "full": gather_shards(tree["w"],
                                                  tuple(op["spec"]),
                                                  rules.mesh).numpy(),
                            "quarantined": ck.quarantined()})
            else:                               # adamw_resume
                init_state, step_fn = make_adamw_train_step(
                    cfg, rules, AdamWConfig(lr=1e-2), device="cpu")
                batch = shard_batch(tuple(torch.from_numpy(x).long()
                                          for x in args["batch"]), rules)

                def run(p, s, k):
                    for _ in range(k):
                        p, s, _loss = step_fn(p, s, batch)
                    return p, s

                p0 = shard_params(full, rules)
                ref_p, ref_s = run(p0, init_state(p0), 6)
                p, s = run(p0, init_state(p0), 3)
                ck.save(3, {"params": p, "opt": s}, meta={"phase": "burnin"},
                        layout=abstract)
                with Checkpointer(op["dir"]) as fresh:
                    tree, at, meta = fresh.restore_tree(abstract)
                restored_equal = all(torch.equal(a, b) for a, b in zip(
                    tree_leaves([p, s["mu"], s["nu"]]),
                    tree_leaves([tree["params"], tree["opt"]["mu"],
                                 tree["opt"]["nu"]])))
                p, s = run(tree["params"], tree["opt"], 3)
                out.append({
                    "at": at, "meta": meta, "restored_equal": restored_equal,
                    "final_equal": all(torch.equal(a, b) for a, b in zip(
                        tree_leaves([ref_p, ref_s["mu"], ref_s["nu"]]),
                        tree_leaves([p, s["mu"], s["nu"]]))),
                    "step_equal": torch.equal(ref_s["step"], s["step"])})
    return out


def plant_checkpoint(rank, n, args):
    """Save step ``args["step"]`` of the smoke test's own burn-in config
    (``BurnInConfig(batch=args["batch"])`` on ``plan_mesh(n)``) into
    ``args["dir"]``, each rank its shards."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        abstract_params,
        init_params,
        save_checkpoint,
    )
    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        make_rules,
        plan_mesh,
    )

    cfg = BurnInConfig(batch=args["batch"])
    rules = make_rules(build_mesh(plan_mesh(n)))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", rules=rules)
    save_checkpoint(args["dir"], args["step"], params,
                    layout=abstract_params(cfg, rules, device="cpu"))
    return dict(rules.mesh.shape)


def moe_ep(rank, n, args):
    """MoE with experts over ``ep`` on ``args["plan"]`` (axis names and
    shape): for each case, this rank's ``forward_and_aux`` logits (its
    batch rows) and aux, one SGD step's gathered parameters, the losses of
    ``args["train_steps"]`` steps and, with ``"adamw"``, a ZeRO-1 AdamW
    step's gathered parameters; with ``args["ckpt"]``, a checkpoint round
    trip of the case's sharded parameters."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        AdamWConfig,
        BurnInConfig,
        Checkpointer,
        abstract_params,
        forward_and_aux,
        gather_params,
        make_adamw_train_step,
        make_train_step,
        opt_state_shardings,
        params_from_numpy,
        params_to_numpy,
        shard_batch,
        shard_params,
        tree_leaves,
    )
    from nvidia_terraform_modules_tpu_torch.models.burnin import _tree_map
    from nvidia_terraform_modules_tpu_torch.parallel import (
        MeshPlan,
        build_mesh,
        make_rules,
    )
    from nvidia_terraform_modules_tpu_torch.parallel.sharding import (
        gather_shards,
    )

    names, shape = args["plan"]
    rules = make_rules(build_mesh(MeshPlan(tuple(names), tuple(shape))))
    out = {"mesh": dict(rules.mesh.shape),
           "data_index": rules.mesh.index(rules.data)}
    for case in args["cases"]:
        cfg = BurnInConfig(**case["cfg"], dtype=torch.float32)
        full = params_from_numpy(case["params"], cfg, device="cpu")
        params = shard_params(full, rules)
        batch = shard_batch(tuple(torch.from_numpy(x).long()
                                  for x in case["batch"]), rules)
        rec = {"local": [tuple(p.shape) for p in tree_leaves(params)]}
        with torch.no_grad():
            logits, aux = forward_and_aux(params, batch[0], cfg, rules)
        rec["logits"], rec["aux"] = logits.numpy(), float(aux)
        if "lr" in case:
            step = make_train_step(cfg, rules, lr=case["lr"], device="cpu")
            p, loss = step(params, batch)
            rec["sgd_loss"] = float(loss)
            rec["sgd"] = params_to_numpy(gather_params(p, rules))
            losses = [float(loss)]
            for _ in range(args["train_steps"] - 1):
                p, loss = step(p, batch)
                losses.append(float(loss))
            rec["losses"] = losses
        if "adamw" in case:
            init_state, astep = make_adamw_train_step(
                cfg, rules, AdamWConfig(**case["adamw"]), device="cpu")
            state = init_state(params)
            p = params
            for _ in range(case["adamw_steps"]):
                p, state, loss = astep(p, state, batch)
            rec["adamw_loss"] = float(loss)
            specs = opt_state_shardings(full, rules)["mu"]
            rec["adamw"] = {
                "params": params_to_numpy(gather_params(p, rules)),
                **{k: params_to_numpy(_tree_map(
                    lambda m, spec: gather_shards(m, spec, rules.mesh),
                    state[k], specs)) for k in ("mu", "nu")}}
            rec["zero1_specs"] = specs
            rec["zero1_local"] = [tuple(m.shape)
                                  for m in tree_leaves(state["mu"])]
        if rank:
            for key in ("sgd", "adamw"):
                rec.pop(key, None)
        out[case["name"]] = rec
    if args.get("ckpt"):
        case = args["cases"][0]
        cfg = BurnInConfig(**case["cfg"], dtype=torch.float32)
        params = shard_params(params_from_numpy(case["params"], cfg,
                                                device="cpu"), rules)
        with Checkpointer(args["ckpt"]) as ck:
            ck.save(1, params, layout=abstract_params(cfg, rules,
                                                      device="cpu"))
        with Checkpointer(args["ckpt"]) as ck:
            restored, at, _ = ck.restore(cfg, rules, device="cpu")
        out["ckpt"] = {"step": at, "equal": all(
            torch.equal(a, b) and a.shape == b.shape for a, b in zip(
                tree_leaves(params), tree_leaves(restored)))}
    return out


def serve_sharded(rank, n, args):
    """The serve engine under ``run(rules=)`` on ``plan_mesh(n,
    tp=args["tp"])``: for each case, the tokens of a run from the case's
    weights (this rank's shards), the shape of this rank's paged pool, and
    the logits of ``forward_paged(rules=)`` over the first prompt — a
    prefill of all but its last token, then a T=1 step through the
    tables; then ``slots`` that the data axes do not divide, as its
    exception."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        forward_paged,
        init_paged_cache,
        make_serve_engine,
        params_from_numpy,
        shard_params,
    )
    from nvidia_terraform_modules_tpu_torch.models.decode import (
        paged_params,
    )
    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        make_rules,
        plan_mesh,
    )

    rules = make_rules(build_mesh(plan_mesh(n, tp=args["tp"])))
    out = {"mesh": dict(rules.mesh.shape)}
    for case in args["cases"]:
        cfg = BurnInConfig(**case["cfg"], dtype=torch.float32)
        params = shard_params(params_from_numpy(case["params"], cfg,
                                                device="cpu"), rules)
        engine = make_serve_engine(params, cfg, device="cpu",
                                   **case["engine"])
        prompts = [torch.from_numpy(p).long() for p in case["prompts"]]
        toks = engine(prompts, case["n_new"], rules=rules, **case["run"])
        pool = init_paged_cache(cfg, 1, 16, block_size=4, num_blocks=5,
                                rules=rules, device="cpu",
                                cache_dtype=case["engine"].get(
                                    "cache_dtype", "bf16"))
        pool["block_tables"][0, :4] = torch.arange(1, 5, dtype=torch.int32)
        tree = paged_params(params, cfg, rules)
        seq = prompts[0][None]
        head, _ = forward_paged(tree, seq[:, :-1], pool, cfg, rules)
        last, _ = forward_paged(tree, seq[:, -1:], pool, cfg, rules,
                                paged_kernel="on")
        out[case["name"]] = {
            "tokens": [t.tolist() for t in toks],
            "pool": tuple(pool["k"][0].shape),
            "logits": torch.cat([head, last], dim=1)[0].numpy(),
            "kv": engine.last_stats["kv"]["high_water"]}
    case = args["cases"][0]
    cfg = BurnInConfig(**case["cfg"], dtype=torch.float32)
    engine = make_serve_engine(shard_params(params_from_numpy(
        case["params"], cfg, device="cpu"), rules), cfg, device="cpu",
        max_len=16)
    try:
        engine([torch.tensor([1, 2])], 2, slots=3, rules=rules)
        out["odd_slots"] = None
    except ValueError as exc:
        out["odd_slots"] = str(exc)
    return out


def pipeline_world(rank, n, args):
    """For each case (axis names and shape of a world mesh over all ``n``
    ranks, or with ``"subset"`` over the first ranks: the others report
    ``None``): this rank's GPipe and 1F1B loss and gathered gradients from
    the case's reference weights and global batch, and the losses of
    ``steps`` SGD steps of each schedule; the gradients on rank 0 only."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        pipeline_params_from_numpy,
        pipeline_params_to_numpy,
    )
    from nvidia_terraform_modules_tpu_torch.parallel import (
        MeshPlan,
        PipelineConfig,
        build_world_mesh,
        gather_pipeline_params,
        make_pipeline_train_step,
        place_pipeline_params,
    )
    from nvidia_terraform_modules_tpu_torch.parallel.pipeline import (
        _gpipe_value_and_grad,
        pipeline_loss_fn,
        pipeline_value_and_grad_1f1b,
    )

    cfg = PipelineConfig(**args["cfg"])
    out = {}
    for case in args["cases"]:
        mesh = build_world_mesh(MeshPlan(tuple(case["names"]),
                                         tuple(case["shape"])),
                                subset=case.get("subset", False))
        if mesh is None:
            out[case["name"]] = None
            continue
        full = pipeline_params_from_numpy(args["params"], cfg, device="cpu")
        params = place_pipeline_params(full, mesh)
        batch = tuple(torch.from_numpy(x).long() for x in case["batch"])
        rec = {"mesh": dict(mesh.shape),
               "local_wq": tuple(params["layers"]["wq"].shape),
               "forward": float(pipeline_loss_fn(params, batch, cfg, mesh))}
        for name, fn in (("gpipe", _gpipe_value_and_grad),
                         ("1f1b", pipeline_value_and_grad_1f1b)):
            loss, grads = fn(params, batch, cfg, mesh)
            grads = pipeline_params_to_numpy(gather_pipeline_params(grads,
                                                                    mesh))
            rec[name] = {"loss": float(loss),
                         "grads": grads if rank == 0 else None}
            step = make_pipeline_train_step(cfg, mesh, lr=args["lr"],
                                            schedule=name)
            p, losses = params, []
            for _ in range(args["steps"]):
                p, loss = step(p, batch)
                losses.append(float(loss))
            rec[name]["losses"] = losses
        out[case["name"]] = rec
    return out


def sp_world(rank, n, args):
    """The burn-in with ``sp`` over processes: for each case (a mesh plan:
    ``plan_mesh(n, **case["plan"])``, or with ``"slices"`` the multislice
    plan), this rank's ``forward_and_aux`` logits and aux on its rows and
    sequence piece with its coordinates, the world's loss and gradients
    (gathered; rank 0 only) from the case's weights and global batch, and
    the losses of ``steps`` SGD steps. A case with ``"planted_rope"``
    runs with every rank's RoPE offset planted at 0."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import (
        BurnInConfig,
        forward_and_aux,
        gather_params,
        make_grads_fn,
        make_train_step,
        params_from_numpy,
        params_to_numpy,
        shard_batch,
        shard_params,
    )
    from nvidia_terraform_modules_tpu_torch.models import burnin
    from nvidia_terraform_modules_tpu_torch.parallel import (
        build_mesh,
        build_multislice_mesh,
        make_rules,
        plan_mesh,
        plan_multislice,
    )

    real_offset = burnin._seq_offset
    out = {}
    for case in args["cases"]:
        burnin._seq_offset = ((lambda rules, s: 0) if case.get("planted_rope")
                              else real_offset)
        if "slices" in case:
            mesh = build_multislice_mesh(plan_multislice(
                n, case["slices"], **case["plan"]))
        else:
            mesh = build_mesh(plan_mesh(n, **case["plan"]))
        rules = make_rules(mesh)
        cfg = BurnInConfig(**case["cfg"], dtype=torch.float32)
        full = params_from_numpy(case["params"], cfg, device="cpu")
        params = shard_params(full, rules)
        batch = shard_batch(tuple(torch.from_numpy(x).long()
                                  for x in case["batch"]), rules)
        with torch.no_grad():
            logits, aux = forward_and_aux(params, batch[0], cfg, rules)
        loss, grads = make_grads_fn(cfg, rules)(params, batch)
        grads = params_to_numpy(gather_params(grads, rules))
        step = make_train_step(cfg, rules, lr=args["lr"], device="cpu")
        p, losses = params, []
        for _ in range(args["steps"]):
            p, step_loss = step(p, batch)
            losses.append(float(step_loss))
        out[case["name"]] = {
            "mesh": dict(mesh.shape), "logits": logits.numpy(),
            "aux": float(aux), "loss": float(loss), "losses": losses,
            "data": (mesh.index(rules.data), mesh.axis_size(rules.data)),
            "sp": (mesh.index("sp"), mesh.axis_size("sp")),
            "grads": grads if rank == 0 else None}
    burnin._seq_offset = real_offset
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
