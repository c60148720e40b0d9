# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""AdamW for the burn-in transformer — the port of the reference's
``models/optimizer.py``: :class:`AdamWConfig`, the warmup + cosine schedule
:func:`lr_at`, :func:`init_opt_state`, :func:`adamw_update`, the ZeRO-1
moment placement (:func:`opt_state_shardings`), the train state's shapes
and placement without tensors (:func:`abstract_train_state`, the
checkpoint restore's contract) and :func:`make_adamw_train_step`.

The state mirrors the params dict: ``{"step", "mu", "nu"}`` with an int32
step counter and f32 moments of the params' shapes (f32 even for bf16
params). Updates are functional: new tensors, the caller's left as they
are.

ZeRO-1 on a world mesh. The reference gives the moments a sharding over
the data axes and lets XLA's partitioner derive the schedule; here it is
written out. Each moment takes its parameter's spec plus the first
still-replicated dimension that the data axes divide, sharded over them
(the parameter's own spec where none divides). A step computes the
gradients as the SGD step does (averaged in f32 over the data axes), runs
the AdamW arithmetic on this rank's slice of each such leaf only — its
slice of the gradient, its moments, its slice of the parameter — and
all-gathers the updated slices over the data axes back into the
parameter's own (``tp``) shard. So a rank holds ``1 / data`` of the
moments; a world of one runs the unsharded step's operations, bit for
bit.

On a one-process mesh (the lock-step form, ``parallel.sharding.
Lockstep``) the parameters are global, so the state keeps the reference's
layout, whole moments beside the whole parameters on the mesh's first
device, and the update is the unsharded one: the arithmetic is
elementwise, so it equals the ZeRO-1 slices' updates bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..parallel.collectives import gather_dim, spec_axes
from ..parallel.sharding import ShapeDtypeStruct, pspec_axes
from .burnin import (
    BurnInConfig,
    _check_params,
    _device,
    _tree_map,
    _tree_map_path,
    _world,
    abstract_params,
    make_grads_fn,
    param_shapes,
    param_shardings,
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


def _bias(state: dict, opt: AdamWConfig):
    """The next step counter, the two bias corrections and the rate."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    return (step, 1.0 - torch.pow(opt.b1, t), 1.0 - torch.pow(opt.b2, t),
            lr_at(opt, step))


def _adamw_leaf(p, g, m, v, opt: AdamWConfig, c1, c2, lr):
    g = g.to(torch.float32)
    m = opt.b1 * m + (1.0 - opt.b1) * g
    v = opt.b2 * v + (1.0 - opt.b2) * torch.square(g)
    delta = (m / c1) / (torch.sqrt(v / c2) + opt.eps)
    delta = delta + opt.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v


def _split(out, state_step):
    def pick(i):
        return _tree_map(lambda o: o[i], out)

    return pick(0), {"step": state_step, "mu": pick(1), "nu": pick(2)}


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict,
                 opt: AdamWConfig):
    """One AdamW step → ``(params, state)``: moments in f32, decoupled
    weight decay, bias correction; the arithmetic in the reference's order
    and rounding points."""
    step, c1, c2, lr = _bias(state, opt)
    out = _tree_map(lambda p, g, m, v: _adamw_leaf(p, g, m, v, opt, c1, c2,
                                                   lr),
                    params, grads, state["mu"], state["nu"])
    return _split(out, step)


def _zero1_dim(shape: tuple, spec: tuple, rules):
    """``(dim, axes)``: the first still-replicated dimension of a
    parameter that its unused data axes divide, and those axes; ``None``
    where none divides or the axes hold one rank (the reference's
    ``_zero1_sharding`` rule)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    used = {ax for entry in spec for ax in spec_axes(entry)}
    axes = tuple(ax for ax in rules.data if ax not in used)
    dp = math.prod(rules.mesh.shape[ax] for ax in axes)
    if dp > 1:
        for i, (dim, s) in enumerate(zip(shape, spec)):
            if s is None and dim % dp == 0 and dim >= dp:
                return i, axes
    return None


def _zero1_spec(shape: tuple, spec: tuple, rules) -> tuple:
    """The moment spec of one parameter: its own spec (one entry a
    dimension) with :func:`_zero1_dim`'s dimension sharded over the data
    axes."""
    out = tuple(spec) + (None,) * (len(shape) - len(spec))
    hit = _zero1_dim(shape, spec, rules)
    if hit is None:
        return out
    i, axes = hit
    return out[:i] + (pspec_axes(axes),) + out[i + 1:]


def opt_state_shardings(params, rules) -> dict:
    """The spec of every leaf of :func:`init_opt_state`'s state, in its
    layout: ``"step"`` replicated, each moment its parameter's ZeRO-1 spec
    (:func:`_zero1_spec`). ``params`` may be tensors or
    :class:`ShapeDtypeStruct` records: only the shapes are read."""
    moments = _tree_map(
        lambda leaf, spec: _zero1_spec(tuple(leaf.shape), spec, rules),
        params, param_shardings(params, rules))
    return {"step": (), "mu": moments, "nu": moments}


def abstract_train_state(cfg: BurnInConfig, rules=None, *,
                         device="cuda") -> dict:
    """``{"params": …, "opt": {"step", "mu", "nu"}}`` as
    :class:`ShapeDtypeStruct` records — the placement contract of the
    checkpoint restore (``Checkpointer.restore_tree``): the parameters
    carry the burn-in placement, the moments (f32) their ZeRO-1 specs, the
    step an int32 scalar. Nothing is allocated."""
    params = abstract_params(cfg, rules, device=device)
    dev = _device(device, rules, cfg)
    mesh = rules.mesh if _world(rules) else None
    if mesh is None:
        specs = _tree_map(lambda _: (), params)
    else:
        specs = opt_state_shardings(params, rules)["mu"]
    moments = _tree_map(
        lambda a, spec: ShapeDtypeStruct(a.shape, torch.float32, dev, spec,
                                         mesh), params, specs)
    return {"params": params,
            "opt": {"step": ShapeDtypeStruct((), torch.int32, dev),
                    "mu": moments, "nu": moments}}


def _zero1_slices(cfg: BurnInConfig, rules) -> dict:
    """Each leaf's ZeRO-1 slice on this rank: ``(dim, n, i, group)`` —
    the dimension split over ``n`` data ranks, this rank's piece ``i`` and
    the data line's group — or ``None`` where the moment keeps its
    parameter's spec."""
    mesh = rules.mesh

    def one(path, sd):
        hit = _zero1_dim(sd[0], rules.param_sharding(path), rules)
        if hit is None:
            return None
        dim, axes = hit
        return dim, mesh.axis_size(axes), mesh.index(axes), mesh.group(axes)

    return _tree_map_path(one, param_shapes(cfg))


@torch.no_grad()
def _zero1_update(params: dict, grads: dict, state: dict,
                  opt: AdamWConfig, slices: dict):
    """:func:`adamw_update` on this rank's ZeRO-1 slices: each sliced leaf
    updates its piece of the parameter from its piece of the gradient and
    its moments, then the pieces are all-gathered over the data line."""
    step, c1, c2, lr = _bias(state, opt)

    def upd(p, g, m, v, sl):
        if sl is None:
            return _adamw_leaf(p, g, m, v, opt, c1, c2, lr)
        dim, n, i, group = sl
        piece, m, v = _adamw_leaf(p.chunk(n, dim)[i], g.chunk(n, dim)[i],
                                  m, v, opt, c1, c2, lr)
        return gather_dim(piece, group, n, dim), m, v

    out = _tree_map(upd, params, grads, state["mu"], state["nu"], slices)
    return _split(out, step)


def make_adamw_train_step(cfg: BurnInConfig, rules=None,
                          opt: AdamWConfig | None = None,
                          accum_steps: int = 1, *,
                          device="cuda") -> tuple[Callable, Callable]:
    """``(init_state, step)`` on ``device`` (with ``rules``, the mesh's
    first device, or on a world mesh this rank's), with
    ``step(params, opt_state, batch) → (params, opt_state, loss)``;
    ``accum_steps > 1`` microbatches the gradient pass. On a world mesh
    ``init_state(params)`` makes the f32 moments of this rank's ZeRO-1
    slices (module docstring) and the step updates those slices only; on
    a one-process mesh the moments are whole and the update unsharded
    (module docstring)."""
    dev = _device(device, rules, cfg)
    opt = opt or AdamWConfig()
    grads_of = make_grads_fn(cfg, rules, accum_steps)
    slices = _zero1_slices(cfg, rules) if _world(rules) else None

    def init_state(params):
        if slices is None:
            return init_opt_state(params)

        def zeros(p, sl):
            shape = p.shape if sl is None else p.chunk(sl[1], sl[0])[
                sl[2]].shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": _tree_map(zeros, params, slices),
                "nu": _tree_map(zeros, params, slices)}

    def step(params, opt_state, batch):
        _check_params(params, dev)
        loss, grads = grads_of(params, batch)
        if slices is None:
            params, opt_state = adamw_update(params, grads, opt_state, opt)
        else:
            params, opt_state = _zero1_update(params, grads, opt_state, opt,
                                              slices)
        return params, opt_state, loss

    return init_state, step
