# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Carry state between the reference package's trees and the port.

``params_from_numpy(tree, cfg, device)`` takes the reference's tree
(``embed``, ``out_norm``, ``layers[i]`` dicts) with numpy leaves — e.g.
``jax.tree.map(numpy.asarray, params)`` on the reference side — and
returns the port's dict on ``device`` in ``cfg.dtype`` (an MoE layer's
``moe`` subtree too, its router in f32). This is how a
parity test gives both sides the same weights (the two frameworks draw
different numbers from one seed). Leaves may be float32 or bfloat16
(``ml_dtypes.bfloat16``, what ``numpy.asarray`` yields for a bf16 JAX
array); bf16 → f32 → bf16 is exact, so an f32 copy of bf16 weights loads
bit-identically.

``pipeline_params_from_numpy`` / ``pipeline_params_to_numpy`` do the same
for the pipeline's tree (``parallel/pipeline.py``: ``layers`` is one dict of
``[L, ...]`` stacks). ``params_to_numpy`` goes the other way (params,
gradients: any dict of the same shape → f32 numpy leaves),
``opt_state_from_numpy`` loads the reference's AdamW state ``{"step", "mu",
"nu"}``, and ``qparams_from_numpy`` the reference's ``quantize_params``
tree, each quantised leaf given as ``{"q": int8 array, "scale": f32 array,
"scale_axis": int}`` — so both sides hold the same int8 weights and scales.
"""

from __future__ import annotations

import numpy as np
import torch

from .burnin import BurnInConfig, _tree_map, check_device
from .quantize import QTensor

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
_DENSE_KEYS = ("up", "down")
_MOE_KEYS = ("router", "experts_up", "experts_down")


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


def _layers(tree, cfg: BurnInConfig, load, dev) -> list:
    """Each layer of the reference's tree through ``load(leaf, dtype,
    device)``: the attention keys and ``up``/``down``, or with
    ``cfg.n_experts > 0`` the ``moe`` subtree — its router in f32 whatever
    ``cfg.dtype`` is, as the reference keeps it."""
    layers = tree["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree has {len(layers)} layers, cfg "
                         f"{cfg.n_layers}")
    out = []
    for i, layer in enumerate(layers):
        moe = layer.get("moe", {}) if cfg.n_experts else None
        missing = [k for k in _LAYER_KEYS if k not in layer]
        if moe is None:
            missing += [k for k in _DENSE_KEYS if k not in layer]
        else:
            missing += [f"moe/{k}" for k in _MOE_KEYS if k not in moe]
        if missing:
            raise ValueError(f"layer {i} lacks {missing} (cfg.n_experts = "
                             f"{cfg.n_experts})")
        keys = _LAYER_KEYS if moe is not None else _LAYER_KEYS + _DENSE_KEYS
        ported = {k: load(layer[k], cfg.dtype, dev) for k in keys}
        if moe is not None:
            ported["moe"] = {
                k: load(moe[k], torch.float32 if k == "router" else cfg.dtype,
                        dev) for k in _MOE_KEYS}
        out.append(ported)
    return out


def params_from_numpy(tree, cfg: BurnInConfig, device="cuda") -> dict:
    """The reference's parameter tree (numpy leaves) → the port's dict."""
    dev = check_device(device)
    return {"embed": _leaf(tree["embed"], cfg.dtype, dev),
            "out_norm": _leaf(tree["out_norm"], cfg.dtype, dev),
            "layers": _layers(tree, cfg, _leaf, dev)}


def pipeline_params_from_numpy(tree, cfg, device="cuda") -> dict:
    """The reference's pipeline tree (``parallel/pipeline.py``'s
    ``init_pipeline_params``: ``embed``, ``out_norm`` and the stacked
    ``layers`` dict, numpy leaves) → the port's, in ``cfg.dtype`` on
    ``device`` (a ``PipelineConfig``)."""
    dev = check_device(device)
    layers = tree["layers"]
    if layers["wq"].shape[0] != cfg.n_layers:
        raise ValueError(f"tree has {layers['wq'].shape[0]} layers, cfg "
                         f"{cfg.n_layers}")
    return {"embed": _leaf(tree["embed"], cfg.dtype, dev),
            "out_norm": _leaf(tree["out_norm"], cfg.dtype, dev),
            "layers": {k: _leaf(w, cfg.dtype, dev)
                       for k, w in layers.items()}}


def pipeline_params_to_numpy(tree) -> dict:
    """The port's pipeline tree (parameters or gradients) → the
    reference's layout with f32 numpy leaves."""
    return {"embed": tree["embed"].detach().float().cpu().numpy(),
            "out_norm": tree["out_norm"].detach().float().cpu().numpy(),
            "layers": {k: w.detach().float().cpu().numpy()
                       for k, w in tree["layers"].items()}}


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


def _qleaf(x, dtype: torch.dtype, device: torch.device):
    if not isinstance(x, dict):
        return _leaf(x, dtype, device)
    q = np.asarray(x["q"])
    if q.dtype != np.int8:
        raise TypeError(f"quantised values must be int8, got {q.dtype}")
    scale = np.asarray(x["scale"], dtype=np.float32).reshape(-1)
    return QTensor(torch.from_numpy(q.copy()).to(device),
                   torch.from_numpy(scale.copy()).to(device),
                   scale_axis=int(x["scale_axis"]), dtype=dtype)


def qparams_from_numpy(tree, cfg: BurnInConfig, device="cuda") -> dict:
    """The reference's ``quantize_params`` tree → the port's QTensor tree
    on ``device``: ``{"q", "scale", "scale_axis"}`` leaves become
    :class:`QTensor` leaves computing in ``cfg.dtype``, every other leaf
    loads as in :func:`params_from_numpy`."""
    dev = check_device(device)
    return {"embed": _qleaf(tree["embed"], cfg.dtype, dev),
            "out_norm": _qleaf(tree["out_norm"], cfg.dtype, dev),
            "layers": _layers(tree, cfg, _qleaf, dev)}
