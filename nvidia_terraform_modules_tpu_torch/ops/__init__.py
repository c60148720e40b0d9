# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The port's kernel wrappers: each launches its hand-written CUDA kernel on
a CUDA tensor (sources in ``../csrc``, built by :mod:`._build`) and runs its
plain PyTorch version (``*_ref``) on a CPU tensor."""

from ._build import launches, reset_launches
from .decode_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
)
from .flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_fwd,
    flash_attention_ref,
    flash_backward,
    flash_dkv,
    flash_dkv_ref,
    flash_dq,
    flash_dq_ref,
    flash_dqdkv,
    flash_dqdkv_ref,
)

__all__ = [
    "FlashAttention",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_ref",
    "flash_backward",
    "flash_dkv",
    "flash_dkv_ref",
    "flash_dq",
    "flash_dq_ref",
    "flash_dqdkv",
    "flash_dqdkv_ref",
    "launches",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "reset_launches",
]
