# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Device trace capture over ``torch.profiler`` — the port of the
reference's ``utils/profiling.py``: the profiling tier above
``utils/timing``.

``timing`` answers "how long"; this module answers "why": it captures a
trace of host operators and CUDA kernels (per-kernel timelines, launch
gaps, synchronisations) and writes it as a Chrome trace, viewable in
Perfetto or ``chrome://tracing``.

Usage::

    from nvidia_terraform_modules_tpu_torch.utils.profiling import (
        annotate, device_trace)
    from nvidia_terraform_modules_tpu_torch.utils.timing import sync

    with device_trace("/tmp/trace"):            # one capture window
        with annotate("train_step"):            # named timeline region
            out = step(params, batch)
        sync(out)                               # capture real execution

The capture window must contain the synchronise, not just the launches:
PyTorch returns before the card finishes, and kernels that outlive the
window are not recorded.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator

from .timing import sync

# the file name the trace is written under (TensorBoard's PyTorch profile
# plugin reads the same suffix)
TRACE_SUFFIX = ".pt.trace.json"


@contextmanager
def device_trace(log_dir: str, *, host_tracer_level: int = 2,
                 python_tracer_level: int = 0) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace of the enclosed block — CPU
    operators, and CUDA kernels when a card is present — and write it as
    a Chrome trace under ``log_dir`` (created if needed) when the block
    ends. Yields ``log_dir``.

    ``python_tracer_level`` > 0 records the Python stack of each operator
    (``with_stack``; costly — leave off for kernel work).
    ``host_tracer_level`` is the reference's ``jax.profiler`` detail
    level; ``torch.profiler`` has no counterpart, and it has no effect
    here."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 with_stack=python_tracer_level > 0) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}{TRACE_SUFFIX}"))


@contextmanager
def annotate(name: str, telemetry=None) -> Iterator[None]:
    """Named region on the trace timeline (``torch.profiler``'s
    ``record_function``): operators and kernels issued inside the block
    group under ``name`` in the viewer. Cheap enough to leave in
    production code; a no-op range when no trace is active.

    When the telemetry plane is active (``TPU_TELEMETRY_DIR`` or an
    injected registry), the same ``name`` is also emitted as a host-side
    telemetry span, so a device trace and the telemetry timeline
    correlate region for region by name."""
    from torch.profiler import record_function

    from ..telemetry import get_registry

    reg = telemetry if telemetry is not None else get_registry()
    if reg.enabled:
        with reg.span(name), record_function(name):
            yield
    else:
        with record_function(name):
            yield


def trace_once(fn: Callable[..., Any], *args: Any, log_dir: str,
               warmup: int = 1, **kwargs: Any) -> tuple[Any, str]:
    """Capture one synchronised call of ``fn`` → ``(out, trace_dir)``.

    ``warmup`` untimed calls first keep one-off work (kernel builds,
    cuBLAS heuristics, graph captures) out of the capture. The traced call
    is synchronised inside the window, so device execution — not just the
    launches — lands in the trace."""
    for _ in range(warmup):
        sync(fn(*args, **kwargs))
    with device_trace(log_dir) as path:
        with annotate(getattr(fn, "__name__", "traced_fn")):
            out = fn(*args, **kwargs)
        sync(out)
    return out, path


def trace_artifacts(log_dir: str) -> list[str]:
    """Paths of the trace files written under ``log_dir``. Empty means no
    capture ended there.

    Deterministically sorted by path components, independent of
    ``os.walk``'s directory enumeration order."""
    found: list[str] = []
    for root, dirs, files in os.walk(log_dir):
        dirs.sort()
        found.extend(os.path.join(root, f) for f in sorted(files)
                     if f.endswith(TRACE_SUFFIX))
    return sorted(found, key=lambda p: p.split(os.sep))
