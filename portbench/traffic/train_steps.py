"""Traffic kind ``train_steps``: the burn-in Job's SGD step
(``make_train_step(cfg, lr=)``) on a fresh batch a step, as fast as the
card takes them, for the window.

The mix file gives ``seq_len``, ``batch``, ``lr``, how many steps the
check follows (``check_steps``) and how many a traced run profiles
(``trace_steps``). Batches are uniform token streams drawn on the device
from ``--seed``, one draw a step (tokens and their next-token targets).

Set-up builds the one step object, drives it through its first
``check_steps`` steps (those are the check's, and warm every shape), and
hands the same object and state to the window. The reference follows those
steps afterwards from the same weights and batches (:func:`readings`).
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench import flops, program, weights
from portbench.harness import Job, Outcome
from portbench.reference import model as ref
from portbench.trace import Tracer


class Feed:
    """Fresh ``(tokens, targets)`` batches from the seed, on the device."""

    def __init__(self, m: dict, traffic: dict, seed: int, device):
        self.shape = (traffic["batch"], traffic["seq_len"] + 1)
        self.vocab = m["vocab"]
        self.dev = torch.device(device)
        self.g = torch.Generator(device=self.dev).manual_seed(
            weights.derive_seed(seed, "batches"))

    def next(self):
        s = torch.randint(0, self.vocab, self.shape, generator=self.g,
                          device=self.dev)
        return s[:, :-1], s[:, 1:]


def leaf_norms(a: list, b: list, scale: float = 1.0) -> list[float]:
    """‖(a_i − b_i)·scale‖ of each pair of leaves, in f32."""
    out = torch.stack([((x.float() - y.float()) * scale).norm()
                       for x, y in zip(a, b)])
    return out.tolist()


def leaf_gaps(prog: list[float], refn: list[float],
              counted: list[bool]) -> list[float]:
    """Each counted leaf's |‖prog‖ − ‖ref‖| over the larger of the
    reference's norm of that leaf and of the median counted leaf (a leaf
    not counted reads None)."""
    med = statistics.median(r for r, c in zip(refn, counted) if c)
    return [abs(p - r) / max(r, med) if c else None
            for p, r, c in zip(prog, refn, counted)]


def program_steps(job: Job, step, params: dict, feed: Feed, n: int):
    """The first ``n`` steps: ``(state, losses, first-gradient norms,
    change norms)``, the gradient as the optimizer got it, (p0 − p1)/lr,
    and the change p_n − p0, leaf by leaf."""
    lr = job.traffic["lr"]
    p0 = [t for _, t in weights.leaves(params)]
    state, losses, grad = params, [], None
    for i in range(n):
        state, loss = step(state, feed.next())
        losses.append(loss)
        if i == 0:
            grad = leaf_norms(p0, [t for _, t in weights.leaves(state)],
                              1.0 / lr)
    change = leaf_norms([t for _, t in weights.leaves(state)], p0)
    return state, [float(x) for x in losses], grad, change


def reference_steps(m: dict, traffic: dict, seed: int, device, n: int,
                    fp8: bool = False):
    """The reference's ``(losses, first-gradient norms, change norms,
    true first-gradient norms)`` over the same weights and batches."""
    dev = torch.device(device)
    lr = traffic["lr"]
    made = weights.make(m, seed, dev)
    p0 = [t for _, t in weights.leaves(made)]
    stored = [t.dtype for t in p0]
    params = weights.to_float(made)
    feed = Feed(m, traffic, seed, dev)
    batches = [feed.next() for _ in range(n)]
    flat = ref.leaves(params)
    losses, grad, true_grad = [], None, None
    with ref.exact():
        for i, batch in enumerate(batches):
            value, g = ref.sgd_step(params, batch, m, lr, stored, fp8)
            losses.append(value)
            if i == 0:
                true_grad = [float(x.norm()) for x in g]
                grad = leaf_norms(p0, flat, 1.0 / lr)
            del g
    change = leaf_norms(flat, p0)
    return losses, grad, change, true_grad


def readings(prog: tuple, refr: tuple) -> dict:
    """The compared numbers: the widest loss gap over the steps
    (``loss_gap``), and of the first gradient's and of the change's
    norms the worst leaf's gap (``grad_gap``, ``change_gap``); leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out."""
    p_loss, p_grad, p_change = prog
    r_loss, r_grad, r_change, r_true = refr
    med = statistics.median(r_true)
    counted = [g >= 1e-3 * med for g in r_true]
    out = {"loss_gap": max(abs(a - b) for a, b in zip(p_loss, r_loss))}
    for key, p, r in (("grad_gap", p_grad, r_grad),
                      ("change_gap", p_change, r_change)):
        out[key] = max(g for g in leaf_gaps(p, r, counted) if g is not None)
    return out


def attn_shape(m: dict, traffic: dict) -> list[int]:
    return [traffic["batch"], traffic["seq_len"], m["n_heads"],
            m["d_model"] // m["n_heads"]]


def run(job: Job) -> Outcome:
    m, tr = job.config, job.traffic
    dev = torch.device(job.device)
    cuda = dev.type == "cuda"
    compiled = program.build_kernels() if cuda else False
    cfg = program.config(m, seq_len=tr["seq_len"], batch=tr["batch"])
    step = program.train_step(cfg, tr["lr"], dev)
    if job.fault is not None:
        step = job.fault("train_step", step)
    feed = Feed(m, tr, job.seed, dev)
    params = weights.make(m, job.seed, dev)
    state, p_loss, p_grad, p_change = program_steps(
        job, step, params, feed, tr["check_steps"])
    del params

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    steps = 0
    while True:
        state, _ = step(state, feed.next())
        steps += 1
        if time.monotonic() - t0 >= job.seconds:
            break
    sync()
    window = time.monotonic() - t0
    memory = torch.cuda.max_memory_allocated() if cuda else 0
    tokens = tr["batch"] * tr["seq_len"]
    ctx = {"kind": "train", "train": {
        "step_flops": flops.train_step_flops(m, tr["batch"], tr["seq_len"]),
        "steps": steps, "seconds": window,
        "attn_shape": attn_shape(m, tr)}}
    notes = {"compiled": compiled, "steps": steps}
    summary = None
    if job.trace:
        # the profile's own cost stays out of the window: a few more
        # steps after it, profiled
        tracer = Tracer(job.device, program.launches)
        tracer.start()
        for _ in range(tr["trace_steps"]):
            state, _ = step(state, feed.next())
        tracer.stop()
        ctx["launches_traced"] = notes["launches_traced"] = tracer.launches
        summary = tracer.summarise()
    del state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = readings((p_loss, p_grad, p_change),
                   reference_steps(m, tr, job.seed, dev, tr["check_steps"]))
    limits = job.cell["limits"]
    return Outcome(
        window_start=t0,
        end_to_end={"train_tokens_per_s": tokens * steps / window},
        context=ctx,
        compared={k: (got[k], limits[k]) for k in limits},
        attempted=steps, failed=0, memory_peak_bytes=memory,
        trace=summary, notes=notes)
