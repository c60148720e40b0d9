# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Capped exponential backoff with jitter — the workload-side retry policy.

The *infrastructure* simulator already models retries precisely
(``tfsim/faults/control_plane.py``: 1s → ×2 → cap 30s, the google
provider's shape, on a simulated clock). This module is the same policy
shape for the *workload* layer — distributed init on a half-scheduled
slice, restore-time reads racing a PVC remount — where time is real and
many workers retry at once, so a deterministic schedule would
synchronise every peer's retry into the exact thundering herd the
backoff exists to avoid. Hence the one deliberate difference from the
simulator: **full jitter** (each delay drawn uniformly from
``[0, capped_backoff]``), seedable for tests.

Kept in ``utils`` (not ``models`` or ``parallel``) on purpose:
``parallel/multihost.py`` consumes it, as ``models/resilience.py`` will,
and ``models`` already imports ``parallel`` — a policy living in either
would cycle. A copy of the reference's ``utils/retry.py`` (no JAX there
either): the port imports nothing of the reference package.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Iterator, Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff (the ``tfsim`` control-plane shape)
    plus full jitter and an attempt bound.

    ``max_attempts`` counts *attempts*, not retries: 3 means the first
    try and up to two more. ``jitter=False`` pins each delay to the
    deterministic cap (the simulator's behaviour) for tests that assert
    exact schedules.
    """

    initial_s: float = 1.0
    multiplier: float = 2.0
    cap_s: float = 30.0
    max_attempts: int = 3
    jitter: bool = True

    def delays(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """The backoff delay before each retry (``max_attempts - 1`` of
        them). Deterministic under a seeded ``rng``."""
        # decorrelated full-jitter default is the point here;
        # replay-sensitive callers pass a seeded rng
        rng = rng or random.Random()
        backoff = self.initial_s
        for _ in range(max(0, self.max_attempts - 1)):
            capped = min(backoff, self.cap_s)
            yield rng.uniform(0.0, capped) if self.jitter else capped
            backoff *= self.multiplier


class RetriesExhausted(Exception):
    """All attempts failed; ``last`` carries the final attempt's error."""

    def __init__(self, what: str, attempts: int, elapsed_s: float,
                 last: BaseException):
        super().__init__(
            f"{what}: failed after {attempts} attempt(s) over "
            f"{elapsed_s:.1f}s — last error: {type(last).__name__}: {last}")
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last = last


def retry_call(fn: Callable, *, policy: RetryPolicy,
               what: str = "operation",
               retryable: tuple = (Exception,),
               giveup: Optional[Callable[[BaseException], bool]] = None,
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep,
               log: Optional[Callable[[str], None]] = None):
    """Run ``fn()`` under ``policy``.

    Only ``retryable`` exceptions are retried; anything else propagates
    immediately (terminal faults must fail fast, exactly like the
    simulator's retryable-vs-terminal split). ``giveup`` refines the
    split *within* a retryable type: an exception it returns True for
    propagates untouched — the lever for exception hierarchies where a
    subtype is terminal (a corrupt checkpoint inside the transient
    checkpoint-error family). When the budget runs out the last error
    is wrapped in :class:`RetriesExhausted` so callers can report a
    *classified*, attempt-counted failure instead of the bare final
    exception.
    """
    t0 = time.monotonic()
    delays = policy.delays(rng)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retryable as exc:  # noqa: PERF203 — retry loop by design
            if giveup is not None and giveup(exc):
                raise
            delay = next(delays, None)
            if delay is None:
                raise RetriesExhausted(
                    what, attempt, time.monotonic() - t0, exc) from exc
            if log:
                log(f"{what}: attempt {attempt} failed "
                    f"({type(exc).__name__}: {exc}); retrying in "
                    f"{delay:.1f}s")
            sleep(delay)
