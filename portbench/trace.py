"""A bounded slice of a run under ``torch.profiler``, reduced to numbers:
the device's busy time as the UNION of its operations' intervals (two
streams that overlap count once), the device operations that took most
time, the longest idle stretches named by what the host was doing, and
each kernel's records (count and seconds). On the card the profile holds
the device's operations and the CUDA runtime's calls (no host operators),
so an idle stretch is named by the runtime call under way, or "host: no
traced op" where the host was in Python. The profile lives in memory
only: no trace file is written."""

from __future__ import annotations

import bisect
import time

import torch


# the port's kernels whose profiler records a run prints beside the
# launches the port counted (the profiler has dropped records on this card)
WATCHED = {"flash_fwd_mma": "flash_fwd", "flash_bwd_kv_mma": "flash_bwd_fused",
           "paged_decode_kernel": "paged_decode"}


def union_seconds(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _host_at(t: float, host: list, starts: list, look: int = 256) -> str:
    """The innermost host operation running at ``t`` (host operations of
    a thread nest: the latest-starting one that still covers ``t``),
    looking back over at most ``look`` operations."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look), -1):
        name, s, e = host[j]
        if e >= t:
            return name
    return "host: no traced op"


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce(device_ops, host_ops, lo: float, hi: float) -> dict:
    """The numbers of one traced window ``[lo, hi]`` (seconds): device
    and host operations as ``(name, start, end)``."""
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device_ops
              if e > lo and s < hi]
    spans = [(s, e) for _, s, e in inside]
    by_name: dict[str, list] = {}
    for n, s, e in inside:
        acc = by_name.setdefault(n, [0, 0.0])
        acc[0] += 1
        acc[1] += e - s
    idle: dict[str, float] = {}
    host = sorted(host_ops, key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    for gs, ge in gaps(spans, lo, hi):
        what = _host_at((gs + ge) / 2, host, starts)
        idle[what] = idle.get(what, 0.0) + (ge - gs)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    records = {k: sum(c for n, (c, _) in by_name.items() if k in n)
               for k in WATCHED}
    worst = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": union_seconds(spans), "window_s": hi - lo,
        "kernels": {n: {"count": c, "seconds": t}
                    for n, (c, t) in by_name.items()},
        "records": records,
        "breakdown": {"device_ops": [[_short(n), t] for n, (_, t) in top],
                      "idle_gaps": [[_short(n), t] for n, t in worst]},
    }


def _events(prof):
    """``(name, start_s, end_s, on_device)`` of every profiler record."""
    for e in prof.profiler.kineto_results.events():
        on_device = "CUDA" in str(e.device_type())
        start = e.start_ns() * 1e-9
        yield e.name(), start, start + e.duration_ns() * 1e-9, on_device


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop`; each synchronises with
    the device first, so the window holds whole operations. ``counter``
    (the port's launch counts) is read at both ends: :attr:`launches`
    holds the launches counted in between."""

    def __init__(self, device: str, counter=dict):
        self.cuda = torch.device(device).type == "cuda"
        # on the card only the device's activity and the CUDA runtime's
        # calls: recording every host operator slows a host-bound loop
        # several-fold and so changes what the slice measures
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CUDA] if self.cuda else [act.CPU])
        self.counter = counter
        self.started = self.stopped = False
        self.t = [0.0, 0.0]
        self.launches: dict[str, int] = {}

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self._counts = self.counter()
        self.prof.start()
        self.started = True
        self.t[0] = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t[1] = time.perf_counter()
        self.prof.stop()
        self.stopped = True
        after = self.counter()
        self.launches = {k: v - self._counts.get(k, 0)
                         for k, v in after.items()
                         if v - self._counts.get(k, 0)}

    def summarise(self) -> dict | None:
        if not self.stopped:
            return None
        dev, host = [], []
        for name, s, e, on_device in _events(self.prof):
            (dev if on_device else host).append((name, s, e))
        self.prof = None
        # the traced window is the host's, profiler start to stop; its
        # first record opens it on the profiler's clock
        span = self.t[1] - self.t[0]
        every = dev + host
        lo = min(s for _, s, _ in every) if every else 0.0
        out = reduce(dev, host, lo, lo + span)
        return out
