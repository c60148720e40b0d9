# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Exporters: one timeline (Chrome trace), one scrape (Prometheus), one
table (terminal) — the port's own copy of the reference's
``telemetry/export.py``.

All three read the same sources: the registry's instruments, its
in-memory event mirror, and — for the trace — every ``*.jsonl`` event
file in the export directory, so spans emitted by other processes
(workers across kill-and-resume attempts, simulated-clock runs) merge into the one timeline the PR exists for.

Timestamp discipline: events carry a ``clock`` domain (``"real"`` wall
clock vs ``"sim"`` simulated seconds). Each domain is normalised
independently — real timestamps re-base to the earliest real event,
simulated ones keep their absolute (near-zero) values — so a directory
holding both renders sensibly in Perfetto instead of putting 2026's unix
epoch next to second 3 of a simulation.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Iterable, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    """Prometheus-legal metric name (invalid chars → ``_``)."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = f"_{name}"
    return name


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------- events


def read_events(directory: str) -> list[dict]:
    """Every parseable event record in the directory's ``*.jsonl`` files
    (the registry's own streams, peers', earlier attempts', and journal
    files sharing the schema). Unparseable lines and foreign records are
    skipped, never fatal — a half-written line from a killed process is
    expected input here."""
    out: list[dict] = []
    if not os.path.isdir(directory):
        return out
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".jsonl"):
            continue
        try:
            with open(os.path.join(directory, fname)) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(rec, dict) and "kind" in rec \
                            and "name" in rec and "ts" in rec:
                        out.append(rec)
        except OSError:
            continue
    return out


def _merged_events(registry, directory: Optional[str]) -> list[dict]:
    events = read_events(directory) if directory else []
    if not events:
        events = list(getattr(registry, "events", []))
    return events


# ----------------------------------------------------------- chrome trace


def chrome_trace(events: Iterable[dict]) -> dict:
    """Chrome-trace/Perfetto JSON (``{"traceEvents": […]}``) from
    schema events: spans become complete ``"X"`` events, point events
    become instants, and process/thread metadata names the lanes (a
    span's ``tid`` is its lane)."""
    events = list(events)
    bases: dict[str, float] = {}
    for e in events:
        if e.get("clock", "real") == "real":
            bases["real"] = min(bases.get("real", math.inf), e["ts"])
    pid_ids: dict[Any, int] = {}
    tid_ids: dict[tuple, int] = {}
    trace: list[dict] = []

    def pid_of(label) -> int:
        if label not in pid_ids:
            pid_ids[label] = len(pid_ids) + 1
            trace.append({"ph": "M", "name": "process_name",
                          "pid": pid_ids[label], "tid": 0,
                          "args": {"name": str(label)}})
        return pid_ids[label]

    def tid_of(pid: int, label) -> int:
        key = (pid, label)
        if key not in tid_ids:
            tid_ids[key] = len([k for k in tid_ids if k[0] == pid])
            trace.append({"ph": "M", "name": "thread_name", "pid": pid,
                          "tid": tid_ids[key],
                          "args": {"name": str(label)}})
        return tid_ids[key]

    for e in sorted(events, key=lambda e: (str(e.get("pid")), e["ts"])):
        clock = e.get("clock", "real")
        base = bases.get(clock, 0.0) if clock == "real" else 0.0
        ts_us = (e["ts"] - base) * 1e6
        pid = pid_of(e.get("pid", 0))
        tid = tid_of(pid, e.get("tid", 0))
        args = dict(e.get("args") or {})
        args["clock"] = clock
        if e["kind"] == "span":
            trace.append({"name": e["name"], "cat": clock, "ph": "X",
                          "ts": ts_us, "dur": e.get("dur", 0.0) * 1e6,
                          "pid": pid, "tid": tid, "args": args})
        else:
            trace.append({"name": e["name"], "cat": clock, "ph": "i",
                          "ts": ts_us, "s": "t", "pid": pid, "tid": tid,
                          "args": args})
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


# ------------------------------------------------------------- prometheus


def prometheus_text(registry) -> str:
    """Prometheus text exposition of every instrument: counters and
    gauges as themselves, histograms as bucket/sum/count families plus
    ``<name>_p50/_p90/_p99`` gauges (the exact order-statistic quantiles
    Prometheus histograms cannot express)."""
    counters, gauges, histograms = registry.instruments()
    lines: list[str] = []
    for name in sorted(counters):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {counters[name].value}")
    for name in sorted(gauges):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(gauges[name].value)}")
    for name in sorted(histograms):
        # ONE consistent snapshot per histogram: buckets/sum/count and
        # quantiles taken under a single lock, so a concurrent record()
        # can never yield +Inf ≠ _count in the exposition
        snap = histograms[name].snapshot()
        m = _metric_name(name)
        lines.append(f"# TYPE {m} histogram")
        for bound, cum in snap["buckets"]:
            lines.append(f'{m}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f"{m}_sum {_fmt(snap['sum'])}")
        lines.append(f"{m}_count {snap['count']}")
        for q, tag in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            v = snap["quantiles"].get(q)
            if v is not None:
                lines.append(f"# TYPE {m}_{tag} gauge")
                lines.append(f"{m}_{tag} {_fmt(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------- summary


def summary_table(registry) -> str:
    """Terminal summary: one aligned row per instrument."""
    counters, gauges, histograms = registry.instruments()
    rows: list[tuple[str, str, str]] = []
    for name in sorted(counters):
        rows.append((name, "counter", str(counters[name].value)))
    for name in sorted(gauges):
        rows.append((name, "gauge", f"{gauges[name].value:g}"))
    for name in sorted(histograms):
        snap = histograms[name].snapshot()
        qs = [snap["quantiles"].get(q) for q in (0.5, 0.9, 0.99)]
        stat = (f"n={snap['count']}"
                + "".join(f" {tag}={v:g}" for tag, v in
                          zip(("p50", "p90", "p99"), qs)
                          if v is not None))
        rows.append((name, "histogram", stat))
    if not rows:
        return "(no telemetry recorded)\n"
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    return "".join(f"{n:<{w0}}  {t:<{w1}}  {s}\n" for n, t, s in rows)


# ------------------------------------------------------------- export_all


def _atomic_write(path: str, text: str) -> None:
    """Write-to-temp + rename: a textfile collector (or a human mid-run)
    reading the artifact never sees a truncated or half-written file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def export_all(registry, directory: str) -> dict[str, str]:
    """Write the three artifacts under ``directory``; returns their
    paths keyed ``trace`` / ``prometheus`` / ``summary``. Each artifact
    is replaced atomically."""
    os.makedirs(directory, exist_ok=True)
    events = _merged_events(registry, directory)
    paths = {
        "trace": os.path.join(directory, "trace.json"),
        "prometheus": os.path.join(directory, "metrics.prom"),
        "summary": os.path.join(directory, "summary.txt"),
    }
    _atomic_write(paths["trace"], json.dumps(chrome_trace(events)))
    _atomic_write(paths["prometheus"], prometheus_text(registry))
    _atomic_write(paths["summary"], summary_table(registry))
    return paths
