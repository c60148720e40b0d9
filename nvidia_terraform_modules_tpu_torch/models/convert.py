# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Load the reference package's parameter tree into the port.

``params_from_numpy(tree, cfg, device)`` takes the reference's tree
(``embed``, ``out_norm``, ``layers[i]`` dicts) with numpy leaves — e.g.
``jax.tree.map(numpy.asarray, params)`` on the reference side — and
returns the port's dict on ``device`` in ``cfg.dtype``. This is how a
parity test gives both sides the same weights (the two frameworks draw
different numbers from one seed). Leaves may be float32 or bfloat16
(``ml_dtypes.bfloat16``, what ``numpy.asarray`` yields for a bf16 JAX
array); bf16 → f32 → bf16 is exact, so an f32 copy of bf16 weights loads
bit-identically.
"""

from __future__ import annotations

import numpy as np
import torch

from .burnin import BurnInConfig, check_device

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "up",
               "down")


def _leaf(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: reinterpret the 16-bit payload
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    elif a.dtype in (np.float32, np.float64, np.float16):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
    else:
        raise TypeError(f"unsupported parameter dtype {a.dtype}")
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, cfg: BurnInConfig, device="cuda") -> dict:
    """The reference's parameter tree (numpy leaves) → the port's dict."""
    dev = check_device(device)
    layers = tree["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree has {len(layers)} layers, cfg "
                         f"{cfg.n_layers}")
    out = {"embed": _leaf(tree["embed"], cfg.dtype, dev),
           "out_norm": _leaf(tree["out_norm"], cfg.dtype, dev),
           "layers": []}
    for i, layer in enumerate(layers):
        missing = [k for k in _LAYER_KEYS if k not in layer]
        if missing:
            raise ValueError(f"layer {i} lacks {missing} (MoE trees are "
                             f"not ported)")
        out["layers"].append({k: _leaf(layer[k], cfg.dtype, dev)
                              for k in _LAYER_KEYS})
    return out
