# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The port's kernel wrappers: each launches its hand-written CUDA kernel on
a CUDA tensor (sources in ``../csrc``, built by :mod:`._build`) and runs its
plain PyTorch version on a CPU tensor."""

from ._build import launches, reset_launches
from .decode_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
)
from .flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_ref,
)

__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_ref",
    "launches",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "reset_launches",
]
