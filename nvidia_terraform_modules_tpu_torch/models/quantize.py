# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Weight-only int8 quantisation for the serve path — the port of the
reference's ``models/quantize.py``.

Decoding at small batch is bound by the bytes of the weights it re-reads
every step; int8-resident weights halve them against bf16. Matmul weights
(the 2-D leaves) store int8 values with one symmetric f32 scale per output
channel — per column of an ``[in, out]`` projection, per vocab row of the
``[vocab, d]`` embedding, which serves both the gather and the tied head —
and norms (1-D) pass through untouched.

:class:`QTensor` carries exactly the three ways the decode forward uses a
weight, so ``models/decode.py`` runs unchanged over int8 params:

- ``h @ qt``: ``ops/int8_matmul.int8_matmul`` when ``M <= 64`` and the
  dims are 128-multiples (the reference's ``_kernel_ok``: K8 on the card,
  its plain version on the CPU), else ``int8_matmul_ref`` (prefill widths,
  which the reference leaves to XLA);
- ``qt[idx]``: the int8 row gather, dequantised after the gather (the
  embedding lookup);
- ``qt.T``: a transposed view (no int8 copy), whose product contracts
  ``[N, K]`` storage through ``transpose_rhs``.

``torch.Tensor.__matmul__`` turns its ``TypeError`` on a non-tensor into
``NotImplemented``, so ``h @ qt`` reaches :meth:`QTensor.__rmatmul__`.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.int8_matmul import MAX_M, int8_matmul, int8_matmul_ref
from .burnin import BurnInConfig, _tree_map, check_device, tree_leaves
from .decode import make_decoder


class QTensor:
    """Int8 weight ``q`` + per-output-channel f32 ``scale``,
    model-consumable. ``scale_axis`` is the storage axis the scales index
    (the output channel): 1 for ``[in, out]`` projections, 0 for the
    ``[vocab, d]`` embedding. ``dtype`` is the compute dtype of what it
    returns."""

    def __init__(self, q, scale, *, scale_axis: int, dtype,
                 transposed: bool = False):
        self.q, self.scale = q, scale
        self.scale_axis, self.transposed = scale_axis, transposed
        self.dtype = dtype

    @property
    def shape(self):
        s = tuple(self.q.shape)
        return s[::-1] if self.transposed else s

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def T(self):  # noqa: N802 — torch's name
        return QTensor(self.q, self.scale, scale_axis=self.scale_axis,
                       dtype=self.dtype, transposed=not self.transposed)

    def dequantize(self):
        """Dense tensor in STORAGE orientation, in ``dtype``."""
        shape = (-1, 1) if self.scale_axis == 0 else (1, -1)
        return dequantize(self.q, self.scale.reshape(shape), self.dtype)

    def __getitem__(self, idx):
        if self.transposed:
            raise TypeError("gather on a transposed QTensor is not a "
                            "model access pattern")
        if self.scale_axis != 0:
            raise TypeError("QTensor gather needs per-row scales "
                            "(scale_axis=0, the embedding layout)")
        return (self.q[idx].float()
                * self.scale[idx][..., None]).to(self.dtype)

    def __rmatmul__(self, x):
        lead, k_dim = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k_dim)
        # the scales apply to OUTPUT channels: storage axis 1 plain, axis 0
        # through a .T view (the embedding as tied head)
        if self.scale_axis != (0 if self.transposed else 1):
            raise TypeError(
                "QTensor matmul with scales on the contraction axis is not "
                "a model access pattern")
        n = self.q.shape[self.scale_axis]
        k = self.q.shape[1 - self.scale_axis]
        if k != k_dim:
            raise ValueError(
                f"contraction mismatch: x {tuple(x.shape)} @ qtensor "
                f"{self.shape}")
        if _kernel_ok(x2.shape[0], k, n):
            out = int8_matmul(x2, self.q, self.scale,
                              transpose_rhs=self.transposed)
        else:
            out = int8_matmul_ref(x2, self.q, self.scale,
                                  transpose_rhs=self.transposed)
        return out.reshape(*lead, n)


def _kernel_ok(m: int, k: int, n: int) -> bool:
    """The reference's rule for the int8 matmul kernel: the skinny
    weight-bound regime (decode steps, ``M <= 64``) with dims that tile in
    128-multiples. Prompt-width products (``M > 64``) are compute-bound and
    take the plain dequant-then-product instead."""
    return m <= MAX_M and k % 128 == 0 and n % 128 == 0


def quantize(w, axis: int = -1):
    """Symmetric per-channel int8: ``(q int8, scale f32)``, one scale per
    slice along ``axis`` (max over every other axis, kept as size 1) — one
    per output channel of an ``[in, out]`` weight with ``axis=-1``."""
    w32 = w.float()
    axis = axis % w32.dim()
    amax = w32.abs().amax(dim=tuple(i for i in range(w32.dim())
                                    if i != axis), keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def _walk(fn, tree, name=None):
    """Map ``fn(name, leaf)`` over a params tree, ``name`` being the
    leaf's own dict key (``None`` inside a list)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v) for v in tree]
    return fn(name, tree)


def quantize_params(params, dtype=torch.bfloat16):
    """Params tree → the same tree with its matmul weights as
    :class:`QTensor` leaves computing in ``dtype``: the 2-D leaves quantise
    (per column; per vocab row for ``embed``, ``scale_axis=0``), every
    other leaf passes through untouched — norms, the MoE ``router`` (f32:
    routing decisions are precision-sensitive) and the 3-D expert stacks
    (their ``bmm`` consumers do not go through :class:`QTensor`). Leaves
    are told apart by their exact key."""

    def leaf(name, x):
        if not isinstance(x, torch.Tensor) or x.dim() != 2 \
                or name == "router":
            return x
        axis = 0 if name == "embed" else 1
        q, s = quantize(x, axis=axis)
        return QTensor(q, s.reshape(-1), scale_axis=axis, dtype=dtype)

    return _walk(leaf, params)


def _is_quantizable(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 2


def quantize_tree(params) -> dict[str, Any]:
    """Params tree → ``{"q", "scale", "kept"}``: ``q``/``scale`` mirror the
    quantisable (>= 2-D) leaves (``quantize`` with ``axis=-1``), ``kept``
    the others, with ``None`` placeholders keeping the three congruent."""
    pairs = _tree_map(lambda x: quantize(x) if _is_quantizable(x) else None,
                      params)
    # a (q, scale) tuple is one leaf of _tree_map, which walks dicts and
    # lists only
    return {"q": _tree_map(lambda p: None if p is None else p[0], pairs),
            "scale": _tree_map(lambda p: None if p is None else p[1], pairs),
            "kept": _tree_map(lambda x: None if _is_quantizable(x) else x,
                              params)}


def dequantize_tree(qparams, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_tree`."""
    return _tree_map(
        lambda q, s, kept: kept if q is None else dequantize(q, s, dtype),
        qparams["q"], qparams["scale"], qparams["kept"])


def quantized_nbytes(qparams) -> int:
    """Bytes of every tensor of a tree (QTensor leaves: values and
    scales)."""
    total = 0
    for leaf in tree_leaves(qparams):
        for t in ((leaf.q, leaf.scale) if isinstance(leaf, QTensor)
                  else (leaf,)):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


def dequantize_params(qparams):
    """QTensor leaves → dense tensors in their compute dtype (the
    unfused decoder and the serve engine's admissions)."""
    return _tree_map(
        lambda x: x.dequantize() if isinstance(x, QTensor) else x, qparams)


def make_quantized_decoder(cfg: BurnInConfig, n_new: int = 32,
                           max_len: int | None = None,
                           dtype=torch.bfloat16, fused: bool = True,
                           cache_dtype: str = "bf16", device="cuda"):
    """Greedy decoder over int8-resident weights: ``decoder(qparams,
    prompt) → [B, n_new]`` with ``qparams`` from :func:`quantize_params`.
    The decode is :func:`..decode.make_decoder`'s (on the card one replay
    of a captured graph of the steps a call): QTensor leaves route every
    decode-step matmul through the int8 kernel. ``fused=False``
    dequantises the whole tree first instead (the reference's A/B
    baseline; the dequantised copy is made each call, and a copy that
    lands at other addresses than the last one is captured anew).
    ``dtype`` must match the QTensor leaves' compute dtype;
    ``cache_dtype="int8"`` also quantises the KV cache — the full int8
    serving stack."""
    dev = check_device(device)
    decode = make_decoder(cfg, n_new, max_len, cache_dtype, device=dev)

    def decoder(qparams, prompt):
        qleaves = [leaf for leaf in tree_leaves(qparams)
                   if isinstance(leaf, QTensor)]
        if not qleaves:
            raise ValueError(
                "make_quantized_decoder expects a quantize_params tree "
                "(QTensor weight leaves); got a tree with none — plain "
                "params would silently serve at full precision")
        for leaf in qleaves:
            if leaf.dtype != dtype:
                raise ValueError(
                    f"decoder built for dtype {dtype}, but qparams carry "
                    f"{leaf.dtype} — rebuild with quantize_params(params, "
                    f"dtype={dtype})")
        return decode(qparams if fused else dequantize_params(qparams),
                      prompt)

    decoder.graphs = decode.graphs
    return decoder
