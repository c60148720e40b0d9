# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Telemetry core: the event log, the instruments, and the registry — the
port's own copy of the reference's ``telemetry/core.py``, the same code
and the same event schema.

Stdlib-only by design: recording a metric must not pay for (or depend on)
a PyTorch import. See the package docstring (``telemetry/__init__.py``)
for the architecture overview.

One event schema for every producer::

    {"ts": <seconds>, "kind": "span"|"event", "name": str,
     "dur": <seconds, spans only>, "pid": <process label>,
     "tid": <lane/thread>, "depth": <span nesting depth>,
     "clock": "real"|"sim", "args": {…}}

``ts`` is whatever the producing :class:`Registry`'s clock says —
wall-clock ``time.time`` by default, a simulated clock when injected —
so simulated-clock spans and the runtime's real spans are the same
record type and merge into one timeline (``telemetry/export.py``).

Disabled is the default and is a near-zero-cost no-op: the process-wide
registry is :data:`NULL` unless ``TPU_TELEMETRY_DIR`` is set or a caller
injects a real :class:`Registry`. Hot paths check ``registry.enabled``
ONCE per call site and skip their instrumentation entirely; the null
registry's instruments and span context are shared singletons, so even
an unguarded call allocates nothing.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from typing import Any, Callable, Optional

# default histogram buckets (upper bounds): latency-shaped, in the unit
# the caller records (the repo convention is milliseconds for *_ms
# histograms, seconds for *_s ones)
DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
                   60000.0)

# exact-quantile sample cap: below it quantiles are order statistics over
# every recorded value (the test contract); past it new values still
# update count/sum/buckets and quantiles degrade to bucket-midpoint
# estimates instead of growing memory without bound
_MAX_SAMPLES = 1 << 17

_EVENTS_PREFIX = "events-"


# ------------------------------------------------------------- instruments


class Counter:
    """Monotonic counter; ``inc`` is thread-safe (a background thread may
    increment it)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar (tokens/s, MFU, heartbeat lag)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with exact p50/p90/p99 order statistics.

    Buckets serve the Prometheus exposition (cumulative ``le`` counts);
    quantiles come from the retained samples — exact against a reference
    sort up to :data:`_MAX_SAMPLES` recorded values, bucket-midpoint
    estimates beyond (count/sum/buckets stay exact forever).
    """

    __slots__ = ("name", "buckets", "_counts", "_samples", "_sum",
                 "_count", "_lock")

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r} needs >= 1 bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)   # + the +Inf bucket
        self._samples: list[float] = []
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1
            if len(self._samples) < _MAX_SAMPLES:
                self._samples.append(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> list[tuple[float, int]]:
        """Cumulative ``(upper_bound, count)`` pairs, +Inf last."""
        with self._lock:
            return self._bucket_counts_locked()

    def _bucket_counts_locked(self) -> list[tuple[float, int]]:
        out = []
        cum = 0
        for bound, c in zip(self.buckets, self._counts):
            cum += c
            out.append((bound, cum))
        out.append((math.inf, cum + self._counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Order-statistic quantile: the value at rank ``ceil(q·n)`` of
        the sorted samples (None when empty). Exact while every recorded
        value is retained; past the cap, estimated from buckets."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> Optional[float]:
        n = self._count
        if n == 0:
            return None
        if n == len(self._samples):
            s = sorted(self._samples)
            return s[max(0, math.ceil(q * n) - 1)]
        # bucket-midpoint estimate (post-cap only)
        rank = max(1, math.ceil(q * n))
        cum = 0
        lo = 0.0
        for bound, c in zip(self.buckets, self._counts):
            if cum + c >= rank:
                return (lo + bound) / 2.0
            cum += c
            lo = bound
        return self.buckets[-1]

    def snapshot(self) -> dict:
        """One internally-consistent view taken under a SINGLE lock
        acquisition: buckets, sum, count, and the p50/p90/p99 quantiles.
        The exporters use this so a concurrent ``record`` (another
        thread, another step) can never produce an exposition
        whose +Inf bucket disagrees with ``_count`` — the Prometheus
        histogram invariant."""
        with self._lock:
            return {
                "buckets": self._bucket_counts_locked(),
                "sum": self._sum,
                "count": self._count,
                "quantiles": {q: self._quantile_locked(q)
                              for q in (0.5, 0.9, 0.99)},
            }


# -------------------------------------------------------------- event log


class EventLog:
    """Append-only JSONL event writer — the one schema every layer emits.

    Each record is written and flushed as a single line, so events
    survive a SIGKILL'd process up
    to the last completed write. Safe for multi-process appends to a
    shared file: one short ``write()`` per record. ``clock`` stamps the
    records' time domain (``"real"`` wall clock vs a simulated ``"sim"``),
    which the exporters use to normalise timelines independently.
    """

    def __init__(self, path: str, clock: Callable[[], float] = time.time,
                 clock_id: str = "real", process: Any = None):
        self.path = path
        self.clock = clock
        self.clock_id = clock_id
        self.process = os.getpid() if process is None else process
        self._lock = threading.Lock()
        self._fh = None

    def _write(self, record: dict) -> None:
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(line)
            self._fh.flush()

    def event(self, name: str, ts: Optional[float] = None, *,
              pid: Any = None, clock: Optional[str] = None,
              **fields: Any) -> None:
        """One point event; ``fields`` ride in ``args``."""
        self._write({
            "ts": self.clock() if ts is None else ts,
            "kind": "event", "name": name,
            "pid": self.process if pid is None else pid,
            "tid": 0, "clock": self.clock_id if clock is None else clock,
            "args": fields,
        })

    def emit_span(self, name: str, start: float, end: float, *,
                  lane: Any = None, pid: Any = None, depth: int = 0,
                  clock: Optional[str] = None, **args: Any) -> None:
        """One complete span with explicit timestamps — how retroactive
        and simulated-clock spans are recorded."""
        self._write({
            "ts": start, "kind": "span", "name": name,
            "dur": max(0.0, end - start),
            "pid": self.process if pid is None else pid,
            "tid": 0 if lane is None else lane, "depth": depth,
            "clock": self.clock_id if clock is None else clock,
            "args": args,
        })

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------- registry


class _Span:
    """Live span handle: a context manager whose ``args`` may be filled
    in before exit (e.g. the restored step number, known only inside)."""

    __slots__ = ("_reg", "name", "lane", "args", "_start", "_depth")

    def __init__(self, reg: "Registry", name: str, lane: Any, args: dict):
        self._reg = reg
        self.name = name
        self.lane = lane
        self.args = args
        self._start = 0.0
        self._depth = 0

    def __enter__(self) -> "_Span":
        self._start = self._reg.clock()
        self._depth = self._reg._enter_span()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._reg._exit_span()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._reg.emit_span(self.name, self._start, self._reg.clock(),
                            lane=self.lane, depth=self._depth,
                            **self.args)


class Registry:
    """Process-local telemetry plane: instruments + structured events.

    ``directory`` is where the JSONL event stream (one
    ``events-<ospid>.jsonl`` per OS process) and the exports land; with
    ``directory=None`` events accumulate in memory only (tests, bench).
    ``clock`` injects the time source — the default wall clock and
    a simulated clock share the one event schema, distinguished by
    ``clock_id``. A Registry is always *enabled*; the disabled story is
    :data:`NULL` (see :func:`get_registry`).
    """

    enabled = True

    def __init__(self, directory: Optional[str] = None, *,
                 clock: Callable[[], float] = time.time,
                 clock_id: str = "real", process: Any = None):
        self.directory = directory
        self.clock = clock
        self.clock_id = clock_id
        self.process = os.getpid() if process is None else process
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self.events: list[dict] = []     # in-memory mirror (bounded)
        self._events_cap = _MAX_SAMPLES
        self._local = threading.local()
        self._log: Optional[EventLog] = None
        if directory is not None:
            self._log = EventLog(
                os.path.join(directory,
                             f"{_EVENTS_PREFIX}{os.getpid()}.jsonl"),
                clock=clock, clock_id=clock_id, process=self.process)

    # ---- instruments ------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, buckets)
            return h

    def instruments(self) -> tuple[dict, dict, dict]:
        """Snapshot views ``(counters, gauges, histograms)`` by name."""
        with self._lock:
            return (dict(self._counters), dict(self._gauges),
                    dict(self._histograms))

    # ---- spans / events ---------------------------------------------
    def _enter_span(self) -> int:
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        return depth

    def _exit_span(self) -> None:
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)

    def span(self, name: str, *, lane: Any = None, **args: Any) -> _Span:
        """Nestable wall-clock span: ``with reg.span("train_step",
        step=3):``. Depth is tracked per thread; the record is emitted at
        exit with the registry clock's start/end."""
        return _Span(self, name, lane, args)

    def _record(self, record: dict) -> None:
        with self._lock:
            if len(self.events) < self._events_cap:
                self.events.append(record)
        if self._log is not None:
            self._log._write(record)

    def event(self, name: str, ts: Optional[float] = None, *,
              pid: Any = None, clock: Optional[str] = None,
              **fields: Any) -> None:
        self._record({
            "ts": self.clock() if ts is None else ts,
            "kind": "event", "name": name,
            "pid": self.process if pid is None else pid,
            "tid": 0, "clock": self.clock_id if clock is None else clock,
            "args": fields,
        })

    def emit_span(self, name: str, start: float, end: float, *,
                  lane: Any = None, pid: Any = None, depth: int = 0,
                  clock: Optional[str] = None, **args: Any) -> None:
        self._record({
            "ts": start, "kind": "span", "name": name,
            "dur": max(0.0, end - start),
            "pid": self.process if pid is None else pid,
            "tid": 0 if lane is None else lane, "depth": depth,
            "clock": self.clock_id if clock is None else clock,
            "args": args,
        })

    # ---- export -----------------------------------------------------
    def export(self, directory: Optional[str] = None) -> dict[str, str]:
        """Write ``trace.json`` (Chrome-trace/Perfetto), ``metrics.prom``
        (Prometheus text exposition), and ``summary.txt`` (terminal
        table) under ``directory`` (default: the registry's own). The
        trace merges EVERY ``*.jsonl`` event file present in the
        directory — other processes' streams and earlier attempts' all
        land on one timeline. Returns the paths."""
        from .export import export_all

        directory = directory or self.directory
        if directory is None:
            raise ValueError(
                "export needs a directory (registry has none)")
        return export_all(self, directory)

    def summary(self) -> str:
        from .export import summary_table

        return summary_table(self)

    def prometheus_text(self) -> str:
        from .export import prometheus_text

        return prometheus_text(self)

    def close(self) -> None:
        if self._log is not None:
            self._log.close()


# ------------------------------------------------------------ null plane


class _NullInstrument:
    """Shared no-op counter/gauge/histogram — every accessor returns this
    same instance, so the disabled path never allocates."""

    __slots__ = ()
    name = "null"
    value = 0
    count = 0
    sum = 0.0
    buckets = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> None:
        return None

    def bucket_counts(self) -> list:
        return []

    def snapshot(self) -> dict:
        return {"buckets": [], "sum": 0.0, "count": 0, "quantiles": {}}


class _NullSpan:
    """Shared no-op span context (``args`` mutations are discarded with
    the shared dict cleared on entry — guard with ``registry.enabled``
    before doing real work)."""

    __slots__ = ("args",)

    def __init__(self):
        self.args: dict = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        self.args.clear()


class NullRegistry:
    """The disabled telemetry plane: every operation is a no-op and every
    handle is a shared singleton. ``enabled`` is False so call sites can
    skip instrumentation with one attribute check and no allocation."""

    enabled = False
    directory = None
    clock_id = "off"
    events: list = []

    def __init__(self):
        self._instrument = _NullInstrument()
        self._span = _NullSpan()
        self.clock = time.time

    def counter(self, name: str) -> _NullInstrument:
        return self._instrument

    def gauge(self, name: str) -> _NullInstrument:
        return self._instrument

    def histogram(self, name: str, buckets=None) -> _NullInstrument:
        return self._instrument

    def span(self, name: str, **kw: Any) -> _NullSpan:
        return self._span

    def event(self, name: str, ts: Optional[float] = None,
              **kw: Any) -> None:
        pass

    def emit_span(self, name: str, start: float, end: float,
                  **kw: Any) -> None:
        pass

    def instruments(self) -> tuple[dict, dict, dict]:
        return {}, {}, {}

    def export(self, directory: Optional[str] = None) -> dict:
        return {}

    def summary(self) -> str:
        return ""

    def prometheus_text(self) -> str:
        return ""

    def close(self) -> None:
        pass


NULL = NullRegistry()

_REGISTRY: Optional[Any] = None
_REGISTRY_LOCK = threading.Lock()


def get_registry():
    """The process-wide registry: :data:`NULL` (disabled, no-op) unless
    ``TPU_TELEMETRY_DIR`` names a directory or :func:`set_registry`
    injected one. Resolved once and cached — the per-call cost on the
    disabled path is one global read."""
    global _REGISTRY
    reg = _REGISTRY
    if reg is not None:
        return reg
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            d = os.environ.get("TPU_TELEMETRY_DIR")
            _REGISTRY = Registry(d) if d else NULL
        return _REGISTRY


def set_registry(reg) -> Any:
    """Inject the process-wide registry (``None`` re-resolves from the
    environment on next use). Returns the previous value."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        prev = _REGISTRY
        _REGISTRY = reg
        return prev
