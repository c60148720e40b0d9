# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Carry state between the reference package's trees and the port.

``params_from_numpy(tree, cfg, device)`` takes the reference's tree
(``embed``, ``out_norm``, ``layers[i]`` dicts) with numpy leaves — e.g.
``jax.tree.map(numpy.asarray, params)`` on the reference side — and
returns the port's dict on ``device`` in ``cfg.dtype``. This is how a
parity test gives both sides the same weights (the two frameworks draw
different numbers from one seed). Leaves may be float32 or bfloat16
(``ml_dtypes.bfloat16``, what ``numpy.asarray`` yields for a bf16 JAX
array); bf16 → f32 → bf16 is exact, so an f32 copy of bf16 weights loads
bit-identically.

``params_to_numpy`` goes the other way (params, gradients: any dict of
the same shape → f32 numpy leaves), and ``opt_state_from_numpy`` loads the
reference's AdamW state ``{"step", "mu", "nu"}``.
"""

from __future__ import annotations

import numpy as np
import torch

from .burnin import BurnInConfig, _tree_map, check_device

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


def params_to_numpy(tree) -> dict:
    """A params-shaped tree of tensors → the same tree of f32 numpy arrays
    (the reference's layout)."""
    return _tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def opt_state_from_numpy(tree, device="cuda") -> dict:
    """The reference's AdamW state (numpy leaves) → the port's: an int32
    step counter and f32 moments on ``device``."""
    dev = check_device(device)
    return {
        "step": torch.tensor(int(np.asarray(tree["step"])),
                             dtype=torch.int32, device=dev),
        "mu": _tree_map(lambda x: _leaf(x, torch.float32, dev), tree["mu"]),
        "nu": _tree_map(lambda x: _leaf(x, torch.float32, dev), tree["nu"]),
    }
