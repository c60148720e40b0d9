"""Seeded traffic draws: a frozen copy of the port's ``utils/traffic.py``
generators the benchmark's mixes use (``poisson_trace``, ``spike_trace``,
``ragged_lengths``, ``shared_prefix_prompts``), the same draws for the same
``(seed, params)``. The copy is the yardstick's: a later change to the
port's generators cannot move the benchmark's traffic."""

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


def spike_trace(base_rate: float, n: int, seed: int = 0, *,
                spike_rate: float | None = None,
                spike_every: float = 60.0,
                spike_duration: float = 5.0) -> list[float]:
    """Baseline Poisson arrivals plus burst windows: every ``spike_every``
    seconds the rate jumps to ``spike_rate`` (default ``10·base_rate``) for
    ``spike_duration`` seconds (thinning, so bursts are exact)."""
    if spike_rate is None:
        spike_rate = 10.0 * base_rate
    if base_rate <= 0 or spike_rate <= 0:
        raise ValueError("rates must be > 0")
    if spike_every <= 0 or spike_duration <= 0:
        raise ValueError("spike_every and spike_duration must be > 0")
    r = _rng(seed)
    peak = max(base_rate, spike_rate)
    t = 0.0
    out: list[float] = []
    while len(out) < n:
        t += r.expovariate(peak)
        in_spike = (t % spike_every) < spike_duration
        rate = spike_rate if in_spike else base_rate
        if r.random() * peak <= rate:
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


def shared_prefix_prompts(n: int, seed: int = 0, *,
                          n_templates: int = 4, zipf_s: float = 1.2,
                          template_len: int = 32, suffix_lo: int = 1,
                          suffix_hi: int = 16, vocab: int = 256,
                          working_set_blocks: int | None = None,
                          block_size: int = 16,
                          ) -> list[tuple[int, list[int]]]:
    """``n`` seeded ``(template_id, prompt)`` pairs: ``n_templates`` fixed
    token templates drawn with Zipf popularity (rank ``r`` ∝ ``1 /
    r**zipf_s``), each request appending ``suffix_lo..suffix_hi`` fresh
    tokens — the shared leading span cross-request prefix sharing exists
    for. ``working_set_blocks`` sizes the pool in full KV blocks instead:
    ``n_templates`` becomes the fewest templates whose ``template_len //
    block_size`` blocks each reach it."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if working_set_blocks is not None:
        if working_set_blocks < 1:
            raise ValueError(
                f"working_set_blocks must be >= 1, got "
                f"{working_set_blocks}")
        if block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size}")
        if template_len < block_size:
            raise ValueError(
                f"working_set_blocks sizes the pool in FULL kv blocks "
                f"— template_len ({template_len}) must hold at least "
                f"one block_size ({block_size}) span, or no template "
                f"ever enters the prefix index")
        per_template = template_len // block_size
        n_templates = -(-working_set_blocks // per_template)
    if n_templates < 1:
        raise ValueError(f"n_templates must be >= 1, got {n_templates}")
    if template_len < 1:
        raise ValueError(f"template_len must be >= 1, got {template_len}")
    if not 1 <= suffix_lo <= suffix_hi:
        raise ValueError(
            f"need 1 <= suffix_lo <= suffix_hi, got "
            f"lo={suffix_lo} hi={suffix_hi}")
    if vocab < 2:
        raise ValueError(f"vocab must be >= 2, got {vocab}")
    if zipf_s <= 0:
        raise ValueError(f"zipf_s must be > 0, got {zipf_s}")
    r = _rng(seed, salt="prefix")
    templates = [[r.randrange(vocab) for _ in range(template_len)]
                 for _ in range(n_templates)]
    weights = [1.0 / (rank + 1) ** zipf_s for rank in range(n_templates)]
    total = sum(weights)
    cum = []
    acc = 0.0
    for w in weights:
        acc += w / total
        cum.append(acc)
    # rounding can leave cum[-1] a hair under 1.0 while random() reaches
    # 1 - 2**-53: pin the last boundary
    cum[-1] = 1.0
    out: list[tuple[int, list[int]]] = []
    for _ in range(n):
        u = r.random()
        tid = next(i for i, c in enumerate(cum) if u <= c)
        suffix = [r.randrange(vocab)
                  for _ in range(r.randint(suffix_lo, suffix_hi))]
        out.append((tid, templates[tid] + suffix))
    return out
