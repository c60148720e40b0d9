"""Traffic kind ``serve_open_loop``: independent users send requests on a
fixed schedule whatever the engine does, and the engine's
``run(prompts, n_new, slots=, admission=)`` serves them greedily
(``eos_id=None``: every request makes exactly its budget).

The mix file gives the prompt and output length ranges (``lo``, ``hi``,
``mean`` of the seeded long-tailed draw), the engine's ``slots``,
``max_len`` and ``kv_block``, the ``shape_seed`` of the sizes and gaps,
and the check's sample; the cell gives ``rate_rps``. Every seed serves the
same multiset of ``(prompt, output)`` sizes and the same multiset of
Poisson gaps (drawn from ``shape_seed``, ``rate_rps · seconds`` requests,
the gaps scaled to span the window), in an order and with prompt tokens
drawn from ``--seed``: the work is the same from seed to seed.

Each request is timed from its due time to its completion: the device
time at which the wave that made its last token finished (a CUDA event
the benchmark records when the engine retires it), on the host's clock.
Every request due in the window is drained; ``serve_p95_ms`` is the 95th
percentile of that time over all of them. A traced run profiles a
short segment of the same traffic served after the window (the mix's
``trace_segment``: its seconds of arrivals, and from when on
``trace_seconds`` of waves are profiled), so the profile's cost stays out
of every number the window gives.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from portbench import flops, gen, program, weights
from portbench.harness import Job, Outcome
from portbench.reference import model as ref
from portbench.trace import Tracer


def plan(traffic: dict, rate: float, seconds: float, seed: int):
    """``(dues, prompt_lens, budgets)``: dues ascending from 0, the
    sizes in the seed's order."""
    n = max(1, round(rate * seconds))
    base = traffic["shape_seed"]
    times = gen.poisson_trace(rate, n, base)
    gaps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    scale = seconds / sum(gaps)
    p, o = traffic["prompt"], traffic["output"]
    sizes = list(zip(
        gen.ragged_lengths(n, base, lo=p["lo"], hi=p["hi"], mean=p["mean"]),
        gen.ragged_lengths(n, base + 1, lo=o["lo"], hi=o["hi"],
                           mean=o["mean"])))
    order = random.Random(f"order-{seed}")
    order.shuffle(gaps)
    order.shuffle(sizes)
    dues, t = [], 0.0
    for g in gaps:
        t += g * scale
        dues.append(t)
    return dues, [s[0] for s in sizes], [s[1] for s in sizes]


def prompts_of(lens, vocab: int, seed: int, device) -> list:
    """Uniform prompt ids, one draw on the device, cut into requests."""
    g = torch.Generator(device=device).manual_seed(
        weights.derive_seed(seed, "prompts"))
    flat = torch.randint(0, vocab, (sum(lens),), generator=g, device=device)
    return list(flat.split(lens))


def open_loop(dues, cuda: bool, on_tick=None):
    """The benchmark's admission source over requests due at ``dues``
    (seconds from :meth:`start`), served in due order."""
    base = program.admission_base()

    class OpenLoop(base):
        def __init__(self):
            self.dues = dues
            self.next = 0                  # the queue head, in due order
            self.back: list[int] = []      # requeued requests
            self.popped = [None] * len(dues)
            self.done = [None] * len(dues)
            self.events: dict[int, torch.cuda.Event] = {}
            self.tokens = [0] * len(dues)
            self.waves = 0
            self.t0 = time.monotonic()

        def start(self, t0: float) -> None:
            self.t0 = t0

        def now(self) -> float:
            return time.monotonic() - self.t0

        def _head(self):
            if self.back:
                return self.back[0]
            return self.next if self.next < len(self.dues) else None

        def candidate(self):
            head = self._head()
            if head is None or self.dues[head] > self.now():
                return None
            return head

        def pop(self, req):
            if self.back and self.back[0] == req:
                self.back.pop(0)
            else:
                self.next += 1
            self.popped[req] = self.now()

        def requeue(self, req):
            self.back.append(req)
            self.back.sort()

        def tick(self):
            self.waves += 1
            if on_tick is not None:
                on_tick(self)

        def waiting(self):
            now = self.now()
            ahead = self.next
            while ahead < len(self.dues) and self.dues[ahead] <= now:
                ahead += 1
            return ahead - self.next + len(self.back)

        def wait_s(self, req):
            return max(0.0, self.now() - self.dues[req])

        def exhausted(self):
            return self._head() is None

        def idle_wait(self):
            head = self._head()
            if head is not None:
                wait = self.dues[head] - self.now()
                if wait > 0:
                    time.sleep(wait)

        def retired(self, req, tokens):
            self.tokens[req] = tokens
            self.done[req] = self.now()
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events[req] = ev

    return OpenLoop()


class ServeCell:
    """One configuration's engine, weights and prompts, set up once; each
    :meth:`window` serves one open-loop schedule through it."""

    def __init__(self, job: Job):
        self.job = job
        self.m, self.tr = job.config, job.traffic
        self.dev = torch.device(job.device)
        self.cuda = self.dev.type == "cuda"
        self.compiled = program.build_kernels() if self.cuda else False
        self.cfg = program.config(self.m)
        self.params = weights.make(self.m, job.seed, self.dev)
        self.engine = program.serve_engine(
            self.params, self.cfg, max_len=self.tr["max_len"],
            kv_block=self.tr["kv_block"], device=self.dev)
        self._warm()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _warm(self) -> None:
        """One run over a few requests at the window's slots: the graph
        capture of the wave at this pool, the kernels' first launches and
        the prefill at the mix's shortest, mean and longest prompts."""
        p = self.tr["prompt"]
        lens = [p["lo"], p["mean"], p["hi"]] * 2
        prompts = prompts_of(lens, self.m["vocab"], -1, self.dev)
        src = open_loop([0.0] * len(lens), self.cuda)
        src.start(time.monotonic())
        self.engine(prompts, [4] * len(lens), slots=self.tr["slots"],
                    admission=src)
        self._sync()

    def window(self, rate: float, seconds: float, seed: int,
               tracer: Tracer | None = None, trace_from: float = 0.0) -> dict:
        """Serve the schedule of ``rate`` over ``seconds`` from ``seed``;
        returns the requests' timings and outputs. ``tracer`` profiles
        ``trace_seconds`` of waves from ``trace_from`` seconds on, started
        and stopped at wave boundaries."""
        dues, lens, budgets = plan(self.tr, rate, seconds, seed)
        prompts = prompts_of(lens, self.m["vocab"], seed, self.dev)

        def on_tick(src):
            if tracer is None or tracer.stopped:
                return
            if not tracer.started and src.now() >= trace_from:
                tracer.start()
            elif tracer.started and \
                    time.perf_counter() - tracer.t[0] >= \
                    self.tr["trace_seconds"]:
                tracer.stop()

        src = open_loop(dues, self.cuda, on_tick)
        self._sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        if self.cuda:
            origin = torch.cuda.Event(enable_timing=True)
            origin.record()
        src.start(t0)
        outs = self.engine(prompts, budgets, slots=self.tr["slots"],
                           admission=src)
        self._sync()
        if tracer is not None and tracer.started and not tracer.stopped:
            tracer.stop()
        if self.job.fault is not None:
            outs = self.job.fault("serve_outputs", outs)
        done = list(src.done)
        if self.cuda:
            for req, ev in src.events.items():
                done[req] = origin.elapsed_time(ev) / 1e3
        memory = torch.cuda.max_memory_allocated() if self.cuda else 0
        return {"t0": t0, "dues": dues, "lens": lens, "budgets": budgets,
                "prompts": prompts, "outs": outs, "done": done,
                "popped": src.popped, "stats": self.engine.last_stats,
                "memory": memory}

    def close(self) -> None:
        self.engine = self.params = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def summarise(w: dict, m: dict) -> tuple[dict, dict, int]:
    """End-to-end numbers, per-layer context and the failed count of one
    window."""
    n = len(w["dues"])
    served = {r: o for r, o in w["outs"].items()
              if w["done"][r] is not None}
    failed = sum(1 for r in range(n)
                 if r not in served or int(served[r].shape[0])
                 != w["budgets"][r])
    lat = [(w["done"][r] - w["dues"][r]) * 1e3 for r in served]
    waits = [(w["popped"][r] - w["dues"][r]) * 1e3 for r in range(n)
             if w["popped"][r] is not None]
    stats = w["stats"] or {}
    e2e = {"serve_p95_ms": flops.percentile(lat, 95)}
    ctx = {"kind": "serve", "serve": {
        "queue_wait_ms": waits, "generated": stats.get("generated", 0),
        "waves": stats.get("waves", 0),
        "kv_mean_utilisation": stats.get("kv", {}).get("mean_utilisation"),
        "latency_p50_ms": flops.percentile(lat, 50), "requests": n,
        "tokens": sum(int(o.shape[0]) for o in served.values()),
        "drain_s": (max(w["done"][r] for r in served) - w["dues"][-1]
                    if served else None)}}
    return e2e, ctx, failed


def sample(w: dict, seed: int, traffic: dict) -> list[int]:
    """The requests the check compares: the longest finished one, then
    others in the seed's order until the sample holds ``min_tokens``
    served tokens and ``min_requests`` requests, or ``max_requests``."""
    chk = traffic["check"]
    finished = sorted(w["outs"])
    if not finished:
        return []
    longest = max(finished, key=lambda r: (w["lens"][r] + w["budgets"][r],
                                           -r))
    rest = [r for r in finished if r != longest]
    random.Random(f"check-{seed}").shuffle(rest)
    picked, tokens = [longest], int(w["outs"][longest].shape[0])
    for r in rest:
        enough = tokens >= chk["min_tokens"] and \
            len(picked) >= chk["min_requests"]
        if enough or len(picked) >= chk["max_requests"]:
            break
        picked.append(r)
        tokens += int(w["outs"][r].shape[0])
    return picked


def logit_gaps(m: dict, seed: int, device, seqs,
               control: bool = False) -> dict:
    """How far served tokens' logits lie below the reference's best, over
    ``seqs`` (``(prompt, served)`` on the host): the widest gap
    (``logit_gap``) and the mean over the served tokens
    (``logit_gap_mean``). With ``control``, the same numbers of the tokens
    the fp8 reference puts first at the same positions (``control_*``)."""
    dev = torch.device(device)
    params = weights.to_float(weights.make(m, seed, dev))
    prog, low = [], []
    with ref.exact():
        for prompt, served in seqs:
            seq = torch.cat([prompt, served[:-1]]).to(dev)
            at = slice(prompt.shape[0] - 1, None)
            logits = ref.serve_logits(params, seq, m)[at]
            best = logits.max(dim=-1).values
            prog.append(
                best - logits.gather(-1, served.to(dev)[:, None])[:, 0])
            if control:
                pick = ref.serve_logits(params, seq, m, fp8=True)[at] \
                    .argmax(dim=-1)
                low.append(best - logits.gather(-1, pick[:, None])[:, 0])
    out = {}
    for name, gaps in (("", prog), ("control_", low)):
        if gaps:
            allg = torch.cat(gaps)
            out[name + "logit_gap"] = float(allg.max())
            out[name + "logit_gap_mean"] = float(allg.mean())
    return out


def run(job: Job) -> Outcome:
    cell = ServeCell(job)
    w = cell.window(job.cell["rate_rps"], job.seconds, job.seed)
    e2e, ctx, failed = summarise(w, job.config)
    picked = sample(w, job.seed, job.traffic)
    seqs = [(w["prompts"][r].cpu(), w["outs"][r].cpu()) for r in picked]
    del w["outs"], w["prompts"]
    notes = {"compiled": cell.compiled, "checked_requests": len(picked),
             "checked_tokens": sum(int(s.shape[0]) for _, s in seqs)}
    summary = None
    if job.trace:
        # the profile's own cost stays out of the window: a short segment
        # of the same traffic after it, profiled in its steady middle
        seg = job.traffic["trace_segment"]
        tracer = Tracer(job.device, program.launches)
        cell.window(job.cell["rate_rps"], seg["seconds"], job.seed + 1,
                    tracer, trace_from=seg["from"])
        summary = tracer.summarise()
        ctx["launches_traced"] = notes["launches_traced"] = tracer.launches
    cell.close()
    if job.fault is not None:
        seqs = job.fault("checked", seqs)
    gaps = logit_gaps(job.config, job.seed, job.device, seqs)
    notes.update(gaps)
    limits = job.cell["limits"]
    return Outcome(window_start=w["t0"], end_to_end=e2e, context=ctx,
                   compared={k: (gaps[k], limits[k]) for k in limits},
                   attempted=len(w["dues"]), failed=failed,
                   memory_peak_bytes=w["memory"], trace=summary, notes=notes)
