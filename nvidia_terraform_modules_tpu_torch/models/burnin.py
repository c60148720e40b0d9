# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The burn-in transformer, inference side — the port of the reference's
``models/burnin.py``: :class:`BurnInConfig` (the fields the serve path
reads), :func:`apply_rope`, :func:`init_params` (the same dict layout) and
an inference-only :func:`forward`, the decode oracle.

Parameters are a plain dict of tensors: ``embed [vocab, d]``, ``out_norm``
and ``layers[i]`` holding ``attn_norm``/``wq``/``wk``/``wv``/``wo``/
``mlp_norm``/``up``/``down``. Training (and any autograd) is a later slice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.flash_attention import NEG_INF, flash_attention
from ..utils.layers import dense_init
from ..utils.layers import rmsnorm as _rmsnorm


@dataclasses.dataclass(frozen=True)
class BurnInConfig:
    vocab: int = 512
    d_model: int = 128
    n_heads: int = 4
    # grouped-query attention: K/V project to this many heads (must divide
    # n_heads); None = n_heads (plain MHA)
    n_kv_heads: int | None = None
    # rotary embeddings on q/k (half-split convention, even head_dim)
    rope: bool = False
    rope_theta: float = 10000.0
    d_ff: int = 512
    n_layers: int = 2
    seq_len: int = 128
    batch: int = 8
    dtype: torch.dtype = torch.bfloat16
    # the TRAINING attention layout; at serve time "dense" prefills through
    # the masked-cache path and every other layout through the flash kernel
    attn: str = "dense"
    n_experts: int = 0

    def __post_init__(self):
        if self.attn not in ("dense", "ring", "ulysses", "flash"):
            raise ValueError(
                f"unknown attn impl {self.attn!r}; "
                f"use dense|ring|ulysses|flash")
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got "
                            f"{self.dtype!r}")
        if self.n_experts < 0:
            raise ValueError(f"n_experts must be >= 0, got {self.n_experts}")
        if self.n_experts > 0:
            raise NotImplementedError(
                "MoE (n_experts > 0) is not ported yet — ROADMAP.md, "
                "Queue A: models/moe.py")
        if self.n_kv_heads is not None and (
                self.n_kv_heads < 1 or self.n_heads % self.n_kv_heads):
            raise ValueError(
                f"n_kv_heads = {self.n_kv_heads} must divide n_heads = "
                f"{self.n_heads}")
        if self.rope and self.head_dim % 2:
            raise ValueError(
                f"rope needs an even head_dim, got {self.head_dim}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else \
            self.n_heads


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on ``[B, T, H, D]`` at ``positions`` ``[T]``
    (shared across the batch) or ``[B, T]`` (per row). Half-split
    convention; angles in f32, output in ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (2.0 / d) * torch.log(torch.tensor(theta, dtype=torch.float32)))
    ang = positions.to(torch.float32)[..., None] * freqs     # [..., T, half]
    if positions.dim() == 1:
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
    else:
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def check_device(device) -> torch.device:
    """Resolve an entry point's ``device`` argument; a CUDA device with no
    card raises — nothing selects the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available (pass device='cpu' to run the plain versions)")
    return dev


def init_params(cfg: BurnInConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Seeded parameters in the reference's dict layout, drawn in f32 from
    ``generator`` (default: seed 0 on ``device``) and cast to
    ``cfg.dtype``. The draws differ from the reference's ``jax.random``
    ones; parity tests load the reference's weights through
    :func:`..convert.params_from_numpy` instead."""
    dev = check_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")

    def dense(shape):
        return dense_init(generator, shape, cfg.dtype)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=dev)

    kv_dim = cfg.kv_heads * cfg.head_dim
    params = {"embed": dense((cfg.vocab, cfg.d_model)),
              "out_norm": ones(cfg.d_model), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": ones(cfg.d_model),
            "wq": dense((cfg.d_model, cfg.d_model)),
            "wk": dense((cfg.d_model, kv_dim)),
            "wv": dense((cfg.d_model, kv_dim)),
            "wo": dense((cfg.d_model, cfg.d_model)),
            "mlp_norm": ones(cfg.d_model),
            "up": dense((cfg.d_model, cfg.d_ff)),
            "down": dense((cfg.d_ff, cfg.d_model)),
        })
    return params


def mlp(h: torch.Tensor, layer: dict, dtype: torch.dtype) -> torch.Tensor:
    """The block's MLP: ``gelu`` in f32 with the TANH approximation — the
    default of the reference's ``jax.nn.gelu`` — then back to ``dtype``."""
    u = F.gelu((h @ layer["up"]).float(), approximate="tanh").to(dtype)
    return u @ layer["down"]


def dense_attention(q, k, v, scale: float):
    """Causal softmax attention on ``[B, S, H, D]`` — the reference's
    ``dense_reference_attention``: f32 scores, softmax, probabilities cast
    to ``v.dtype`` for the PV product with f32 accumulation."""
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    sc = torch.where(keep, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


@torch.inference_mode()
def forward(params: dict, tokens: torch.Tensor,
            cfg: BurnInConfig) -> torch.Tensor:
    """Decoder-only forward → logits ``[batch, seq, vocab]`` (unsharded,
    inference only): the oracle cached decoding is held against."""
    x = params["embed"][tokens]
    b, s = tokens.shape
    scale = 1.0 / (cfg.head_dim ** 0.5)
    rep = cfg.n_heads // cfg.kv_heads
    for layer in params["layers"]:
        h = _rmsnorm(x, layer["attn_norm"])
        q = (h @ layer["wq"]).view(b, s, cfg.n_heads, cfg.head_dim)
        k = (h @ layer["wk"]).view(b, s, cfg.kv_heads, cfg.head_dim)
        v = (h @ layer["wv"]).view(b, s, cfg.kv_heads, cfg.head_dim)
        if cfg.rope:
            pos = torch.arange(s, device=x.device)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if cfg.attn == "flash":
            attn = flash_attention(q, k, v, causal=True, scale=scale)
        else:
            if rep > 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            attn = dense_attention(q, k, v, scale)
        x = x + attn.reshape(b, s, cfg.d_model) @ layer["wo"]
        x = x + mlp(_rmsnorm(x, layer["mlp_norm"]), layer, cfg.dtype)
    x = _rmsnorm(x, params["out_norm"])
    return x @ params["embed"].T
