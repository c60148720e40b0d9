# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The serve path of the burn-in transformer, in PyTorch."""

from .burnin import BurnInConfig, apply_rope, forward, init_params
from .convert import params_from_numpy
from .decode import (
    forward_cached,
    forward_paged,
    greedy_decode,
    init_cache,
)
from .paging import BlockAllocator, blocks_for_rows, init_paged_cache
from .serving import make_serve_engine, make_serve_step

__all__ = [
    "BlockAllocator",
    "BurnInConfig",
    "apply_rope",
    "blocks_for_rows",
    "forward",
    "forward_cached",
    "forward_paged",
    "greedy_decode",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "make_serve_engine",
    "make_serve_step",
    "params_from_numpy",
]
