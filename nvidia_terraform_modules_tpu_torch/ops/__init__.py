# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The port's kernel wrappers — each launches its hand-written CUDA kernel on
a CUDA tensor (sources in ``../csrc``, built by :mod:`._build`) and runs its
plain PyTorch version (``*_ref``) on a CPU tensor — and the
sequence-parallel attention built on them (ring and Ulysses) — and the
keyed draw of the samplers (D1, ``sampling.draw``), which replaces no TPU
kernel: the reference draws in XLA."""

from ._build import launches, reset_launches
from .decode_attention import (
    int8_kv_decode_attention,
    kv_decode_attention,
    kv_decode_attention_ref,
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
    flash_partial,
    flash_partial_ref,
)
from .int8_matmul import int8_matmul, int8_matmul_ref
from .sampling import draw, draw_ref
from .ring_attention import (
    RingFlash,
    dense_reference_attention,
    ring_attention_kernel,
    ring_flash_attention_kernel,
    ring_self_attention,
)
from .ulysses_attention import (
    ulysses_attention_kernel,
    ulysses_self_attention,
)

__all__ = [
    "FlashAttention",
    "RingFlash",
    "dense_reference_attention",
    "draw",
    "draw_ref",
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
    "flash_partial",
    "flash_partial_ref",
    "int8_kv_decode_attention",
    "int8_matmul",
    "int8_matmul_ref",
    "kv_decode_attention",
    "kv_decode_attention_ref",
    "launches",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "reset_launches",
    "ring_attention_kernel",
    "ring_flash_attention_kernel",
    "ring_self_attention",
    "ulysses_attention_kernel",
    "ulysses_self_attention",
]
