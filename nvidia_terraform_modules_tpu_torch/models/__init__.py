# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The burn-in transformer in PyTorch: its serve path (bf16 and int8) and its
train step."""

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
from .convert import (
    opt_state_from_numpy,
    params_from_numpy,
    params_to_numpy,
    qparams_from_numpy,
)
from .decode import (
    cache_rows,
    forward_cached,
    forward_paged,
    greedy_decode,
    init_cache,
    quantize_kv,
)
from .optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    lr_at,
    make_adamw_train_step,
)
from .paging import (
    BlockAllocator,
    blocks_for_rows,
    init_paged_cache,
    paged_pool_spec,
)
from .quantize import (
    QTensor,
    dequantize,
    dequantize_params,
    dequantize_tree,
    make_quantized_decoder,
    quantize,
    quantize_params,
    quantize_tree,
    quantized_nbytes,
)
from .serving import make_serve_engine, make_serve_step

__all__ = [
    "AdamWConfig",
    "BlockAllocator",
    "BurnInConfig",
    "FLAGSHIP_TRAIN",
    "QTensor",
    "adamw_update",
    "apply_rope",
    "blocks_for_rows",
    "cache_rows",
    "dequantize",
    "dequantize_params",
    "dequantize_tree",
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
    "make_quantized_decoder",
    "make_serve_engine",
    "make_serve_step",
    "make_train_step",
    "opt_state_from_numpy",
    "params_from_numpy",
    "paged_pool_spec",
    "params_to_numpy",
    "qparams_from_numpy",
    "quantize",
    "quantize_kv",
    "quantize_params",
    "quantize_tree",
    "quantized_nbytes",
    "synthetic_batch",
    "train_step_flops",
    "tree_leaves",
]
