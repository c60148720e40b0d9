# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Telemetry plane of the port: spans, metrics and one trace timeline — a
copy of the reference's stdlib-only ``telemetry`` package (the port
imports nothing of the reference), with the same event schema, the same
instruments and the same exports, so dashboards read the port as they
read the reference.

Three layers:

- **Instruments** (:class:`Counter`, :class:`Gauge`,
  :class:`Histogram`): process-local, thread-safe, with exact
  p50/p90/p99 order-statistic quantiles on the histograms
  (``telemetry/core.py``).
- **Events**: nestable wall-clock :meth:`Registry.span` contexts and
  point :meth:`Registry.event`\\ s, written as structured JSONL — one
  schema whatever the producer. The clock is injectable (``clock:
  "sim"`` vs ``"real"``).
- **Exporters** (``telemetry/export.py``): a Chrome-trace/Perfetto JSON
  timeline, a Prometheus text exposition (histogram buckets plus
  ``_p50/_p90/_p99`` gauges) and a terminal summary table
  (:func:`export_all` writes all three).

**Off by default, near-zero when off.** :func:`get_registry` returns the
shared :data:`NULL` no-op registry unless ``TPU_TELEMETRY_DIR`` is set
(the reference's switch, which the validation Job's manifests set) or a
caller injects a :class:`Registry` via :func:`set_registry` (or the
``telemetry=`` parameter the instrumented layers accept). Hot paths check
``registry.enabled`` once per call site; the null registry's instruments
and span context are shared singletons, so the disabled path allocates
nothing and emits nothing.

Instrumented layers of the port (all emit here when enabled):

====================================  =====================================
``models/burnin.instrument_step``     per-step latency histogram
                                      (``train_step_ms``), live
                                      ``train_tokens_per_s`` /
                                      ``train_mfu`` gauges, one span per
                                      step; the one-shot flash probe's
                                      ``flash_fwd_ms`` / ``flash_bwd_ms``
                                      and ``flash_*_mxu_frac``
``models/serving``                    per-request ``serve_prefill`` /
                                      ``serve_request`` spans, the
                                      ``serve_request_ms`` histogram,
                                      admission / generated / accepted-
                                      draft / verify-step counters, queue,
                                      slot, KV-block, prefix-hit, lazy-
                                      growth and ``paged_decode_ms`` gauges
``models/speculative``                one ``spec_decode`` span a call,
                                      ``spec_verify_steps`` /
                                      ``spec_accepted_draft_tokens``
``utils/profiling.annotate``          one span per annotated region, named
                                      as its ``torch.profiler`` range
====================================  =====================================

Quick start::

    TPU_TELEMETRY_DIR=/tmp/telemetry python3 my_serve_script.py
    # in the script, once the work is done:
    #   from nvidia_terraform_modules_tpu_torch.telemetry import get_registry
    #   get_registry().export()    # → trace.json, metrics.prom, summary.txt
"""

from .core import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    EventLog,
    Gauge,
    Histogram,
    NULL,
    NullRegistry,
    Registry,
    get_registry,
    set_registry,
)
from .export import (  # noqa: F401
    chrome_trace,
    export_all,
    prometheus_text,
    read_events,
    summary_table,
)
