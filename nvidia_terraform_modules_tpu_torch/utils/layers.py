# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Shared layer primitives — the port of ``nvidia_terraform_modules_tpu/
utils/layers.py``: one RMSNorm and one init scale for every model."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm with the reference's rounding points: the variance in f32,
    ``x · rsqrt(var + 1e-6)`` in f32, cast back to ``x.dtype``, THEN the
    scale multiply in that dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def dense_init(generator: torch.Generator, shape, dtype: torch.dtype,
               scale: float = 0.02) -> torch.Tensor:
    """``normal · scale`` drawn in f32 from ``generator`` (on the
    generator's device), then cast to ``dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(dtype)
