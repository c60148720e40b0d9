# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Timing on the card.

PyTorch returns before the device finishes, so a host clock measures the
enqueue unless it ends in a synchronise. :func:`sync` is that barrier.
:func:`cuda_median_ms` measures DEVICE time: CUDA events around ``fn``,
with the device held in a spin (``torch.cuda._sleep``) while the host
enqueues, so the interval between the events holds no host gaps. Without
that, a call whose host work (Python, argument checks, many small
launches) outlasts its kernels would be timed at its host cost.
:func:`host_ms` is the other half: the host time to issue ``fn``.
:func:`synced_ms` times whole steps on the host clock, synchronised. A
measurement with no card fails: it never falls back to the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

# larger than the H100's 50 MB L2: writing it evicts the previous run's data
_FLUSH_BYTES = 64 * 1024 * 1024
# spin cycles per second of host enqueue to cover (the card's clock is
# below 2 GHz, so this errs toward a longer spin)
_SPIN_CYCLES_PER_S = 2.0e9


def sync() -> None:
    """Wait for every kernel queued on the current CUDA device."""
    torch.cuda.synchronize()


def host_ms(fn: Callable[[], Any], *, iters: int = 10,
            warmup: int = 3) -> float:
    """Median host milliseconds to issue ``fn()`` (no synchronise inside
    the clock; the device is drained between runs)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    sync()
    times.sort()
    return times[len(times) // 2]


def synced_ms(fn: Callable[[], Any], n: int) -> tuple[list, float]:
    """Run ``fn()`` ``n`` times, each timed on the host clock from a
    synchronise to a synchronise (a whole step, device work included);
    returns the results and the median milliseconds."""
    results, times = [], []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        results.append(fn())
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return results, times[len(times) // 2]


def cuda_median_ms(fn: Callable[[], Any], *, iters: int = 10,
                   warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``iters`` (>= 5) runs
    timed with CUDA events, after ``warmup`` untimed runs. Before each
    timed run a 64 MB buffer is written (every run starts with a cold L2
    cache, as the serve path's kernels find it) and the device spins for
    twice ``fn``'s host issue time, so the events bracket device work
    only."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_median_ms needs a CUDA device")
    if iters < 5:
        raise ValueError(f"iters must be >= 5, got {iters}")
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    issue_ms = host_ms(fn, iters=3, warmup=warmup)
    spin = int((2 * issue_ms * 1e-3 + 1e-4) * _SPIN_CYCLES_PER_S)
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]
