"""The yardstick's frozen arithmetic: published peaks, the model's FLOPs a
train step, and the kernels' least times (operations
and bytes from their shapes). Frozen copies: the port keeps its own
counts, which a later change may alter; these stay as they are."""

from __future__ import annotations

import math

# NVIDIA's H100 SXM data sheet, dense rates at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _kv_frac(m: dict) -> float:
    return (m.get("n_kv_heads") or m["n_heads"]) / m["n_heads"]


def _topk(m: dict) -> int:
    return m.get("router_top_k", 1) if m.get("n_experts", 0) else 1


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward + backward = 3 × forward):
    the projections, the attention contractions at the causal mask's half,
    the FFN (k experts a token) and the tied head."""
    b, s, d, f, v = batch, seq, m["d_model"], m["d_ff"], m["vocab"]
    per_layer = ((4.0 + 4.0 * _kv_frac(m)) * b * s * d * d
                 + 4.0 * 0.5 * b * s * s * d
                 + 4.0 * b * s * d * f * _topk(m))
    return 3.0 * (m["n_layers"] * per_layer + 2.0 * b * s * d * v)


def _bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_fwd_bound_s(b: int, s: int, h: int, d: int) -> float:
    """K1, causal bf16 ``[b, s, h, d]``: 4·b·h·d·s(s+1)/2 operations; Q, K,
    V read and O written once in bf16, the f32 row statistics written."""
    live = s * (s + 1) / 2
    n = b * s * h * d
    return _bound_s(4.0 * b * h * d * live, 4 * n * 2 + b * h * s * 4)


def flash_bwd_bound_s(b: int, s: int, h: int, d: int) -> float:
    """K5 (fused backward), causal bf16: 2.5 × the forward's operations; Q,
    K, V, O, dO read and dQ, dK, dV written once in bf16, the f32 row
    statistics read."""
    live = s * (s + 1) / 2
    n = b * s * h * d
    return _bound_s(2.5 * 4.0 * b * h * d * live,
                    (4 + 3) * n * 2 + 2 * b * h * s * 4)


def percentile(values, p: float) -> float | None:
    """Nearest-rank percentile (``p`` in [0, 100]) of ``values``."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[max(0, math.ceil(p / 100.0 * len(xs)) - 1)]
