# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The burn-in transformer in PyTorch: its serve path and its train step."""

from .burnin import (
    FLAGSHIP_TRAIN,
    BurnInConfig,
    apply_rope,
    forward,
    forward_and_aux,
    grad_accum,
    init_params,
    loss_fn,
    make_grads_fn,
    make_train_step,
    synthetic_batch,
    train_step_flops,
    tree_leaves,
)
from .convert import opt_state_from_numpy, params_from_numpy, params_to_numpy
from .decode import (
    forward_cached,
    forward_paged,
    greedy_decode,
    init_cache,
)
from .optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    lr_at,
    make_adamw_train_step,
)
from .paging import BlockAllocator, blocks_for_rows, init_paged_cache
from .serving import make_serve_engine, make_serve_step

__all__ = [
    "AdamWConfig",
    "BlockAllocator",
    "BurnInConfig",
    "FLAGSHIP_TRAIN",
    "adamw_update",
    "apply_rope",
    "blocks_for_rows",
    "forward",
    "forward_and_aux",
    "forward_cached",
    "forward_paged",
    "grad_accum",
    "greedy_decode",
    "init_cache",
    "init_opt_state",
    "init_paged_cache",
    "init_params",
    "loss_fn",
    "lr_at",
    "make_adamw_train_step",
    "make_grads_fn",
    "make_serve_engine",
    "make_serve_step",
    "make_train_step",
    "opt_state_from_numpy",
    "params_from_numpy",
    "params_to_numpy",
    "synthetic_batch",
    "train_step_flops",
    "tree_leaves",
]
