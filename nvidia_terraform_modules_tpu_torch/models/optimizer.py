# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""AdamW for the burn-in transformer — the port of the reference's
``models/optimizer.py``, unsharded: :class:`AdamWConfig`, the warmup +
cosine schedule :func:`lr_at`, :func:`init_opt_state`, :func:`adamw_update`
and :func:`make_adamw_train_step`.

The state mirrors the params dict: ``{"step", "mu", "nu"}`` with an int32
step counter and f32 moments of the params' shapes (f32 even for bf16
params). Updates are functional: new tensors, the caller's left as they
are. The ZeRO-1 moment shardings and ``abstract_train_state`` are not
ported (ROADMAP.md, Queue A item 6): the SGD step shards over dp and tp,
this one does not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from .burnin import (
    BurnInConfig,
    _check_params,
    _tree_map,
    check_device,
    make_grads_fn,
)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    # schedule: linear warmup 0 → lr over ``warmup_steps``, then cosine
    # decay to ``lr · min_lr_ratio`` over ``decay_steps`` (constant at
    # ``lr`` when decay_steps == 0, and past the end of the decay)
    warmup_steps: int = 0
    decay_steps: int = 0
    min_lr_ratio: float = 0.0


def lr_at(opt: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate (f32 tensor on ``step``'s device) at the 1-indexed
    ``step`` under the schedule; no host synchronisation."""
    t = step.to(torch.float32)
    lr = torch.full_like(t, opt.lr)
    if opt.warmup_steps > 0:
        lr = lr * torch.clamp(t / opt.warmup_steps, max=1.0)
    if opt.decay_steps > 0:
        frac = torch.clamp((t - opt.warmup_steps) / opt.decay_steps, 0.0,
                           1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        floor = opt.min_lr_ratio
        lr = torch.where(t <= opt.warmup_steps, lr,
                         opt.lr * (floor + (1.0 - floor) * cos))
    return lr


def init_opt_state(params: dict) -> dict[str, Any]:
    """Zero moments, params-shaped, f32; step counter for bias correction."""
    dev = params["embed"].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params),
        "nu": _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params),
    }


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict,
                 opt: AdamWConfig):
    """One AdamW step → ``(params, state)``: moments in f32, decoupled
    weight decay, bias correction; the arithmetic in the reference's order
    and rounding points."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(opt.b1, t)
    c2 = 1.0 - torch.pow(opt.b2, t)
    lr = lr_at(opt, step)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m = opt.b1 * m + (1.0 - opt.b1) * g
        v = opt.b2 * v + (1.0 - opt.b2) * torch.square(g)
        delta = (m / c1) / (torch.sqrt(v / c2) + opt.eps)
        delta = delta + opt.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = _tree_map(upd, params, grads, state["mu"], state["nu"])

    def pick(i):
        return _tree_map(lambda o: o[i], out)

    return pick(0), {"step": step, "mu": pick(1), "nu": pick(2)}


def make_adamw_train_step(cfg: BurnInConfig, rules=None,
                          opt: AdamWConfig | None = None,
                          accum_steps: int = 1, *,
                          device="cuda") -> tuple[Callable, Callable]:
    """``(init_opt_state, step)`` on ``device``, with
    ``step(params, opt_state, batch) → (params, opt_state, loss)``;
    ``accum_steps > 1`` microbatches the gradient pass."""
    if rules is not None:
        raise NotImplementedError(
            "the sharded AdamW step (rules=, ZeRO-1 moments over dp) is not "
            "ported yet — ROADMAP.md, Queue A item 6: ZeRO-1 AdamW (the "
            "SGD step shards over dp and tp)")
    dev = check_device(device)
    opt = opt or AdamWConfig()
    grads_of = make_grads_fn(cfg, rules, accum_steps)

    def step(params, opt_state, batch):
        _check_params(params, dev)
        loss, grads = grads_of(params, batch)
        params, opt_state = adamw_update(params, grads, opt_state, opt)
        return params, opt_state, loss

    return init_opt_state, step
