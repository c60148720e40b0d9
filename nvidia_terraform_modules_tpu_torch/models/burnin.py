# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The burn-in transformer — the port of the reference's ``models/burnin.py``,
unsharded: :class:`BurnInConfig`, :func:`apply_rope`, :func:`init_params`
(the same dict layout), the inference-only :func:`forward` (the decode
oracle), and the training side — the differentiable
:func:`forward_and_aux`, :func:`loss_fn`, :func:`synthetic_batch`,
:func:`grad_accum` / :func:`make_grads_fn`, the SGD :func:`make_train_step`
and :func:`train_step_flops` (AdamW is in ``models/optimizer.py``).

Parameters are a plain dict of tensors: ``embed [vocab, d]``, ``out_norm``
and ``layers[i]`` holding ``attn_norm``/``wq``/``wk``/``wv``/``wo``/
``mlp_norm``/``up``/``down``; gradients and optimizer moments are dicts of
the same shape. A train step is functional, as the reference's jitted step
is: it returns new parameters and leaves the caller's unchanged.

Not carried from the reference: the sharded ``rules`` (raise
``NotImplementedError``), the telemetry wrapper ``instrument_step``, and
the TPU's tile levers ``flash_pipeline`` / ``flash_block_q`` /
``flash_block_k`` (the CUDA kernels have one fixed 64x64 tiling).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import (
    NEG_INF,
    MaskSpec,
    flash_attention,
    mask_live_frac,
)
from ..utils.layers import dense_init
from ..utils.layers import rmsnorm as _rmsnorm

# bench.py's flagship: the width both main paths run at, with its burn-in
# train step's batch (bf16: 419,465,216 parameters)
FLAGSHIP_TRAIN = dict(vocab=8192, d_model=2048, n_heads=16, d_ff=8192,
                      n_layers=8, attn="flash", seq_len=4096, batch=2)


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
    # the flash path's backward kernels: "fused" (K5, one pass) or "split"
    # (K3 + K4, the A/B oracle)
    flash_backward: str = "fused"
    # sliding-window causal attention (q - k < N) on the flash and dense
    # training paths; None = full causal
    flash_window: int | None = None
    # recompute each block's activations in the backward
    # (torch.utils.checkpoint) instead of keeping them
    remat: bool = False
    n_experts: int = 0

    def __post_init__(self):
        if self.attn not in ("dense", "ring", "ulysses", "flash"):
            raise ValueError(
                f"unknown attn impl {self.attn!r}; "
                f"use dense|ring|ulysses|flash")
        if self.flash_backward not in ("fused", "split"):
            raise ValueError(
                f"unknown flash_backward impl {self.flash_backward!r}; "
                f"use fused|split")
        if self.flash_window is not None:
            if self.flash_window < 1:
                raise ValueError(
                    f"flash_window must be >= 1, got {self.flash_window}")
            if self.attn not in ("flash", "dense"):
                raise ValueError(
                    f"flash_window needs attn='flash' or 'dense', got "
                    f"{self.attn!r} (the sharded ring/ulysses masks don't "
                    f"carry a window yet)")
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


def _check_params(params: dict, dev: torch.device) -> None:
    have = params["embed"].device
    if have.type != dev.type:
        raise ValueError(f"params live on {have}, the call targets {dev} "
                         f"(move them, or pass device={have.type!r})")


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


def dense_attention(q, k, v, scale: float, window: int | None = None):
    """Causal softmax attention on ``[B, S, H, D]`` — the reference's
    ``dense_reference_attention``: f32 scores, softmax, probabilities cast
    to ``v.dtype`` for the PV product with f32 accumulation. ``window``
    keeps only keys with ``q - k < window``."""
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    if window is not None:
        keep = keep.triu(1 - window)
    sc = torch.where(keep, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


@torch.inference_mode()
def forward(params: dict, tokens: torch.Tensor,
            cfg: BurnInConfig) -> torch.Tensor:
    """Decoder-only forward → logits ``[batch, seq, vocab]`` (unsharded,
    inference only): the oracle cached decoding is held against. It is
    :func:`forward_and_aux`'s logits; with no gradient to keep, the flash
    path runs K1 alone."""
    return forward_and_aux(params, tokens, cfg)[0]


# ------------------------------------------------------------- training

def _tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of a params-shaped dict/list tree (and
    the matching leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [_tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a params-shaped dict/list tree, in order."""
    out: list = []
    _tree_map(out.append, tree)
    return out


def _tree_unflatten(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _no_rules(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "sharded training (rules=) is not ported yet — ROADMAP.md, "
            "Queue A item 6: parallel/")


def forward_and_aux(params: dict, tokens: torch.Tensor, cfg: BurnInConfig,
                    rules=None):
    """Differentiable, unsharded forward → ``(logits [B, S, vocab], aux)``;
    ``aux`` (the MoE load-balance loss in the reference) is 0.0 for the
    dense model. Attention runs through :class:`FlashAttention` (K1
    forward; K5, or K3 + K4, backward) with ``attn="flash"`` and through
    :func:`dense_attention` otherwise; GQA repeats K/V to the query heads
    first, as the reference does, so autograd sums dK/dV over each group.
    ``cfg.remat`` recomputes each block in the backward."""
    _no_rules(rules)
    b, s = tokens.shape
    scale = 1.0 / (cfg.head_dim ** 0.5)
    rep = cfg.n_heads // cfg.kv_heads
    mask = (MaskSpec("window", cfg.flash_window)
            if cfg.flash_window is not None else None)

    def block(x, layer):
        h = _rmsnorm(x, layer["attn_norm"])
        q = (h @ layer["wq"]).view(b, s, cfg.n_heads, cfg.head_dim)
        k = (h @ layer["wk"]).view(b, s, cfg.kv_heads, cfg.head_dim)
        v = (h @ layer["wv"]).view(b, s, cfg.kv_heads, cfg.head_dim)
        if cfg.rope:
            pos = torch.arange(s, device=x.device)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if cfg.attn == "flash":
            attn = flash_attention(q, k, v, causal=True, scale=scale,
                                   mask=mask, backward=cfg.flash_backward)
        else:
            attn = dense_attention(q, k, v, scale, window=cfg.flash_window)
        x = x + attn.reshape(b, s, cfg.d_model) @ layer["wo"]
        return x + mlp(_rmsnorm(x, layer["mlp_norm"]), layer, cfg.dtype)

    x = params["embed"][tokens]
    for layer in params["layers"]:
        if cfg.remat:
            x = checkpoint(block, x, layer, use_reentrant=False)
        else:
            x = block(x, layer)
    x = _rmsnorm(x, params["out_norm"])
    logits = x @ params["embed"].T                    # weight-tied head
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def train_step_flops(cfg: BurnInConfig) -> float:
    """Model FLOPs for ONE train step (fwd + bwd), for MFU accounting — the
    reference's count: projections (K/V at the GQA width), the attention
    contractions at the mask's live fraction, the MLP and the tied head;
    backward = 2× forward."""
    b, s, d, dff, v = (cfg.batch, cfg.seq_len, cfg.d_model, cfg.d_ff,
                       cfg.vocab)
    kv_frac = cfg.kv_heads / cfg.n_heads
    live = mask_live_frac(
        MaskSpec("window", cfg.flash_window)
        if cfg.flash_window is not None else MaskSpec("causal"), s)
    per_layer = ((4.0 + 4.0 * kv_frac) * b * s * d * d
                 + 4.0 * live * b * s * s * d
                 + 4.0 * b * s * d * dff)
    fwd = cfg.n_layers * per_layer + 2.0 * b * s * d * v
    return 3.0 * fwd


def loss_fn(params: dict, batch, cfg: BurnInConfig,
            rules=None) -> torch.Tensor:
    """Mean next-token cross-entropy, the logits in f32."""
    tokens, targets = batch
    logits, _aux = forward_and_aux(params, tokens, cfg, rules)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None]).squeeze(-1)
    return nll.mean()


def synthetic_batch(generator: torch.Generator, cfg: BurnInConfig,
                    device="cuda"):
    """Deterministic synthetic LM batch ``(tokens, targets)``, each
    ``[batch, seq_len]`` int64: the next token of a random stream drawn
    from ``generator`` (on ``device``). Its numbers differ from the
    reference's ``jax.random`` ones."""
    dev = check_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, batch on {dev}")
    stream = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len + 1),
                           generator=generator, device=dev)
    return stream[:, :-1], stream[:, 1:]


def _value_and_grad(cfg: BurnInConfig) -> Callable:
    """``(params, batch) → (loss, grads)``: the loss (detached) and its
    gradient for every leaf, in the params' dict layout and dtype."""

    def vg(params, batch):
        with torch.enable_grad():
            live = _tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
            loss = loss_fn(live, batch, cfg)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        return loss.detach(), _tree_unflatten(params, grads)

    return vg


def grad_accum(fn: Callable, accum_steps: int) -> Callable:
    """Microbatch a ``(params, batch) → (loss, grads)`` function over the
    batch axis: ``accum_steps`` equal microbatches run one after another
    (activation memory at microbatch size), their losses and gradients
    summed in f32 and averaged. Loss is a mean over examples, so this is
    the full-batch gradient up to rounding; the gradients come back f32."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def accumulated(params, batch):
        b = batch[0].shape[0]
        if b % accum_steps:
            raise ValueError(
                f"batch {b} not divisible by accum_steps {accum_steps}")
        micro = [x.chunk(accum_steps) for x in batch]
        loss_sum, grad_sum = None, None
        for i in range(accum_steps):
            loss, grads = fn(params, tuple(x[i] for x in micro))
            if grad_sum is None:
                loss_sum = loss.float()
                grad_sum = _tree_map(lambda g: g.float(), grads)
            else:
                loss_sum = loss_sum + loss
                grad_sum = _tree_map(lambda a, g: a + g, grad_sum, grads)
        inv = 1.0 / accum_steps
        return loss_sum * inv, _tree_map(lambda g: g * inv, grad_sum)

    return accumulated


def make_grads_fn(cfg: BurnInConfig, rules=None,
                  accum_steps: int = 1) -> Callable:
    """``(params, batch) → (loss, grads)`` — the gradient pass both train
    steps (SGD here, AdamW in ``models/optimizer.py``) share, with optional
    microbatch accumulation."""
    _no_rules(rules)
    vg = _value_and_grad(cfg)
    return vg if accum_steps == 1 else grad_accum(vg, accum_steps)


def make_train_step(cfg: BurnInConfig, rules=None, lr: float = 1e-3,
                    accum_steps: int = 1, *, device="cuda") -> Callable:
    """SGD train step ``step(params, batch) → (params, loss)`` on
    ``device``: ``p − lr·g.to(p.dtype)`` for every leaf, into new tensors.
    ``accum_steps > 1`` runs the batch as that many microbatches through
    :func:`grad_accum`; it composes with ``cfg.remat``."""
    dev = check_device(device)
    grads_of = make_grads_fn(cfg, rules, accum_steps)

    def step(params, batch):
        _check_params(params, dev)
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            params = _tree_map(lambda p, g: p - lr * g.to(p.dtype), params,
                               grads)
        return params, loss

    return step
