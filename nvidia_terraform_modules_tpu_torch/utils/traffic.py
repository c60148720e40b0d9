# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Seeded workload draws — a stdlib copy of the reference's
``utils/traffic.py`` (``_rng``, ``poisson_trace``, ``ragged_lengths``).

Kept byte-for-byte in behaviour: one ``(seed, params)`` yields the same
trace and the same lengths as the reference, so a port run and a
reference run labelled with one seed saw the same users
(``tests/test_torch_layers.py`` pins the equality).
"""

from __future__ import annotations

import random


def _rng(seed, salt: str = "traffic") -> random.Random:
    # string seeding is sha512-based and cross-process deterministic
    return random.Random(f"{salt}-{seed}")


def poisson_trace(rate: float, n: int, seed: int = 0) -> list[float]:
    """``n`` homogeneous Poisson arrivals at ``rate`` requests/second
    (exponential gaps from a seed-local PRNG), in seconds from 0."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    r = _rng(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += r.expovariate(rate)
        out.append(t)
    return out


def ragged_lengths(n: int, seed: int = 0, *, lo: int = 1, hi: int = 64,
                   mean: float | None = None) -> list[int]:
    """``n`` seeded long-tailed lengths in ``[lo, hi]`` (``lo`` +
    exponential, clamped at ``hi``), pre-clamp mean ``mean`` (default the
    range midpoint)."""
    if not 1 <= lo <= hi:
        raise ValueError(f"need 1 <= lo <= hi, got lo={lo} hi={hi}")
    if hi == lo:
        return [lo] * n
    if mean is None:
        mean = (lo + hi) / 2.0
    if mean <= lo:
        raise ValueError(f"mean must exceed lo ({lo}), got {mean}")
    r = _rng(seed, salt="lengths")
    scale = mean - lo
    return [max(lo, min(hi, lo + int(r.expovariate(1.0 / scale))))
            for _ in range(n)]
