# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Switch / GShard Mixture-of-Experts FFN — the port of the reference's
``models/moe.py``, on one process.

Routing is the reference's dense formulation, kept as it is: every token
picks its top-k experts, and the choice becomes one-hot dispatch and
combine tensors of fixed shape ``[tokens, experts, capacity]``, so no shape
depends on the data and a serve wave that routes can be captured as a CUDA
graph. Each expert then runs its FFN over all ``capacity`` slots
(``torch.bmm`` over the ``[E, C, D]`` batch): E·C rows for T tokens, and at
decode every expert's weights are read each step. The routed product that
reads only the chosen experts is ROADMAP Queue B work.

Numerics the reference fixes, and the port keeps:

- the router is f32 (its weight is never cast or quantised) and its
  product is an elementwise f32 multiply and sum — no cuBLAS call, so no
  TF32 setting of the process can change an expert choice;
- ties pick the lowest expert index, as ``jax.lax.top_k`` does
  (``argmax`` for k = 1, a stable descending sort for k > 1);
- one-hots are comparisons against ``arange`` (``F.one_hot`` reads its
  range back to the host, which a graph capture forbids, and raises where
  JAX's gives an all-zero row);
- capacity positions are an int32 exclusive cumsum along tokens, rank r
  claiming slots after every lower rank's total (GShard priority).

On a ``torch.distributed`` world (``rules`` over a ``WorldMesh``) each
rank holds its batch rows (cut over the data axes, ``("dp", "ep")`` on an
``ep`` mesh, in the reference's ``P(("dp", "ep"))`` order), ``E / ep``
experts and ``d_ff / tp`` of each. Routing is the unsharded routing
exactly: the capacity counts the global tokens, a rank's slot follows
every lower top-k rank's assignments over all tokens and this rank's
assignments on earlier data ranks (one all-gather of the ``[K, E]``
counts, ``parallel.collectives.data_exclusive_counts``), and the aux loss
takes global means. Where the reference constrains the expert batch to
``P("ep", ...)`` and lets XLA lower the einsums to all-to-alls, the
dispatch here reduce-scatters the ``[E, C, D]`` partial sums over ``ep``
and all-reduces them over the other data axes (each ``(expert, slot)``
holds one token, so the sums add zeros: exact), the expert FFN runs
Megatron-style over ``tp``, and the combine all-gathers the expert outputs
over ``ep`` (``dispatch_experts``, ``gather_experts``; each backward is its
forward's transpose). A world of one runs no collective. With ``sp``
above 1 the burn-in model gathers the sequence over ``sp`` before the
layer (``models/burnin.py``), so every ``sp`` member routes its data
rank's whole rows, in the flattened ``[B, S]`` order the slots follow.

On a one-process mesh (:func:`lockstep_moe`, ``parallel.sharding.
Lockstep``) the process steps the same ranks in turn: each data
coordinate routes its rows on its home device, the counts ahead of it
are the plain sum over the coordinates before it
(``parallel.collectives.exclusive_sums``), each position runs its
``E / ep`` experts' ``d_ff / tp`` columns on its device over the slots of
every data coordinate (their partial batches summed in coordinate order),
the ``tp`` partial products are summed in member order and the ``ep``
members' outputs joined for the combine — plain tensor operations, so
autograd runs through them, and the routing is the unsharded routing. The
decode path runs the same function at drop-free capacity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    data_exclusive_counts,
    data_sum,
    dispatch_experts,
    enter_parallel,
    exclusive_sums,
    exit_parallel,
    gather_experts,
    member_cat,
    member_sum,
)
from ..parallel.mesh import WorldMesh
from ..utils.layers import dense_init


def expert_capacity(tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Per-expert token slots, ``ceil(tokens / n_experts · factor)``
    rounded up to a multiple of 8 (at least 8) — the reference's count."""
    cap = math.ceil(tokens / n_experts * capacity_factor)
    return max(8, math.ceil(cap / 8) * 8)


def drop_free_capacity(assignments: int) -> int:
    """Capacity at which no assignment can overflow (every token routed to
    one expert): the serve path's capacity, so routing never depends on
    how many tokens share a batch and cached decode equals a full
    re-forward."""
    return max(8, math.ceil(assignments / 8) * 8)


def init_moe_params(cfg, generator: torch.Generator) -> dict:
    """Router ``[d_model, E]`` in f32 (``normal · 0.02``) and stacked expert
    weights ``experts_up [E, d_model, d_ff]`` / ``experts_down [E, d_ff,
    d_model]`` in ``cfg.dtype``, drawn from ``generator`` on its device."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        # f32 whatever cfg.dtype is: a bf16 logit tie flips an expert
        "router": dense_init(generator, (d, e), torch.float32),
        "experts_up": dense_init(generator, (e, d, f), cfg.dtype),
        "experts_down": dense_init(generator, (e, f, d), cfg.dtype),
    }


def check_rules(rules, cfg=None) -> None:
    """Refuse what the layer cannot run: with ``cfg``, an ``ep`` that does
    not divide the experts or a ``tp`` that does not divide ``d_ff``."""
    if rules is None or cfg is None:
        return
    shape = rules.mesh.shape
    ep, tp = shape.get("ep", 1), shape.get("tp", 1)
    if cfg.n_experts % ep or cfg.d_ff % tp:
        raise ValueError(
            f"ep = {ep} must divide n_experts ({cfg.n_experts}) and tp = "
            f"{tp} must divide d_ff ({cfg.d_ff})")


def _lines(rules):
    """The groups the layer's collectives run on, on a world mesh:
    ``(data, n_data, i_data)`` of this rank's line over the data axes,
    ``(ep, n_ep)``, the line over the data axes other than ``ep``, and the
    ``tp`` line (``None`` where a line is this rank alone); ``None`` off a
    world mesh."""
    if rules is None or not isinstance(rules.mesh, WorldMesh):
        return None
    mesh = rules.mesh
    data = tuple(a for a in rules.data if a in mesh.axis_names)
    ep = tuple(a for a in ("ep",) if a in mesh.axis_names)
    rest = tuple(a for a in data if a not in ep)
    return ((mesh.group(data), mesh.axis_size(data), mesh.index(data)),
            (mesh.group(ep) if ep else None, mesh.axis_size(ep)),
            mesh.group(rest) if rest else None, mesh.group("tp"))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: row ``i`` has a 1 at ``idx[i]`` and is all zero
    where ``idx`` lies outside ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: values and indices, ties to
    the lower index."""
    if k == 1:
        idx = probs.argmax(dim=-1, keepdim=True)
    else:
        idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def moe_layer(x: torch.Tensor, params: dict, cfg, rules=None, *,
              capacity: int | None = None):
    """Top-k MoE FFN (k = ``cfg.router_top_k``) of ``x`` ``[B, S, D]`` →
    ``(out [B, S, D], aux)``.

    k = 1 is Switch routing (the gate is the raw top probability); k > 1
    is GShard routing (gates renormalised over the chosen experts, rank-r
    assignments queued behind every lower rank's, so a full expert drops
    second choices first). ``capacity`` overrides the factor-derived slot
    count ``expert_capacity(T·k, E, cfg.capacity_factor)``; the serve path
    passes :func:`drop_free_capacity`. A dropped assignment contributes
    nothing (the residual carries the token). ``aux`` is the Switch
    load-balance loss ``E · Σ_e load_e · prob_e`` over all tokens, dropped
    ones included, with the load of the rank-0 choices. On a world mesh
    ``x`` is this rank's rows and ``params`` its expert shard; ``T``, the
    slots and the aux are the world's (module docstring)."""
    check_rules(rules, cfg)
    if rules is not None and not isinstance(rules.mesh, WorldMesh):
        return _moe_one_process(x, params, cfg, rules, capacity)
    lines = _lines(rules)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.router_top_k
    t = b * s * (1 if lines is None else lines[0][1])      # global tokens
    c = capacity if capacity is not None else \
        expert_capacity(t * k, e, cfg.capacity_factor)
    out, probs, _, total = _route(x, params, cfg, c, lines)
    load = total[0].float() / t
    prob = data_sum(probs.sum(dim=0), None if lines is None
                    else lines[0][0]) / t
    aux = e * (load * prob).sum()
    return out, aux


def routed_ffn(x: torch.Tensor, params: dict, cfg, capacity: int,
               serve=None):
    """:func:`moe_layer`'s routing and expert FFN at ``capacity`` slots an
    expert, without the aux loss (which the serve path, like XLA's
    dead-code elimination in the reference, never computes) → ``(out
    [B, S, D], probs [T, E], top_e [T, k])``.

    ``serve`` (the serve path on a world mesh, ``((ep_group, n_ep, i_ep),
    tp_group)``): ``x`` is the same on every member of this rank's ``ep``
    line, and ``params`` this rank's expert shard. Every member routes all
    of ``x`` (so no count crosses a rank), runs its ``E / n_ep`` experts'
    ``d_ff / tp`` columns on their slots, and the expert outputs are
    all-reduced over ``tp`` and all-gathered over ``ep`` before the
    combine. No sum runs over the data axes: unlike training's dispatch,
    which adds every data rank's own tokens, this form is right for a
    batch that the ranks share."""
    return _route(x, params, cfg, capacity, None, serve)[:3]


def _choose(tokens: torch.Tensor, router: torch.Tensor, cfg):
    """The router's choice for ``tokens [T, D]`` → ``(probs [T, E], top_p
    [T, k], top_e [T, k], one-hots [k × [T, E]] int32, counts [k, E]
    int32)``."""
    e, k = cfg.n_experts, cfg.router_top_k
    logits = (tokens.float()[:, :, None] * router.float()).sum(dim=1)
    probs = torch.softmax(logits, dim=-1)                     # [T, E]
    top_p, top_e = _top_k(probs, k)                           # [T, K]
    if k > 1:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # int32 counts: f32 would lose integer exactness past 2^24 tokens
    ohs = [_one_hot(top_e[:, r], e, torch.int32) for r in range(k)]
    counts = torch.stack([oh.sum(dim=0, dtype=torch.int32) for oh in ohs])
    return probs, top_p, top_e, ohs, counts


def _slots(ohs, top_p, before, total, capacity: int):
    """The dispatch and combine tensors ``[T, E, C]`` (f32) of one set of
    tokens: assignment ``r`` of a token takes the slot after the lower
    ranks' per-expert totals ``total`` and the same rank's ``before``
    (the assignments of the tokens ahead of these; ``None``: none)."""
    t, e = ohs[0].shape
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=top_p.device)
    combine = torch.zeros_like(dispatch)
    used = torch.zeros((e,), dtype=torch.int32, device=top_p.device)
    for r, oh in enumerate(ohs):
        # the slot within the expert's batch: an exclusive cumsum along the
        # tokens, behind the lower ranks' per-expert totals (and, on a
        # world, this rank's assignments on earlier data ranks)
        base = used if before is None else used + before[r]
        pos = (torch.cumsum(oh, dim=0, dtype=torch.int32) * oh - oh
               + base[None] * oh)
        within = ((pos < capacity) & (oh == 1)).float()
        d_r = _one_hot(pos, capacity, torch.float32) * within[..., None]
        dispatch = dispatch + d_r
        combine = combine + d_r * top_p[:, r, None, None]
        used = used + total[r]
    return dispatch, combine


def _expert_ffn(xin: torch.Tensor, params: dict, cfg) -> torch.Tensor:
    """The experts' FFN on their batches ``[E, C, D]`` (any split of the
    experts or of ``d_ff``: the row-parallel part of the down product)."""
    h = torch.bmm(xin, params["experts_up"])
    h = F.gelu(h.float(), approximate="tanh").to(cfg.dtype)
    return torch.bmm(h, params["experts_down"])


def _route(x: torch.Tensor, params: dict, cfg, capacity: int, lines,
           serve=None):
    """Routing, dispatch, the expert FFN and the combine → ``(out
    [B, S, D], probs [T, E], top_e [T, k], total [k, E])``: this rank's
    rows, their router probabilities and choices, and the world's
    assignment counts by top-k rank
    (:func:`_lines`' groups; ``None``: one process, or the serve form of
    :func:`routed_ffn` under ``serve``)."""
    b, s, d = x.shape
    t = b * s
    tokens = x.reshape(t, d)
    probs, top_p, top_e, ohs, counts = _choose(tokens, params["router"], cfg)
    if lines is None:
        before, total = None, counts
    else:                  # the data ranks ahead hold the earlier tokens
        before, total = data_exclusive_counts(counts, *lines[0])
    dispatch, combine = _slots(ohs, top_p, before, total, capacity)

    if serve is not None:        # this rank's experts' slots only
        (ep, n_ep, i_ep), tp = serve
        dispatch = dispatch.chunk(n_ep, dim=1)[i_ep]
    xin = torch.einsum("tec,td->ecd", dispatch.to(cfg.dtype), tokens)
    if lines is not None:       # this rank's experts, every rank's tokens
        (_, (ep, n_ep), rest, tp) = lines
        xin = enter_parallel(dispatch_experts(xin, ep, n_ep, rest), tp)
    xout = _expert_ffn(xin, params, cfg)
    if lines is not None or serve is not None:
        xout = gather_experts(exit_parallel(xout, tp), ep, n_ep)
    out = torch.einsum("tec,ecd->td", combine.to(cfg.dtype), xout)
    return out.reshape(b, s, d), probs, top_e, total


def lockstep_moe(hs: list, pieces: dict, cfg, ls, *,
                 capacity: int | None = None):
    """The MoE layer over a one-process mesh's positions
    (``parallel.sharding.Lockstep`` ``ls``; module docstring): ``hs`` is
    each data coordinate's rows ``[b, S, D]`` on its home device, in
    coordinate order, ``pieces[c, j]`` position ``(c, j)``'s pieces of the
    layer's ``router`` / ``experts_up`` / ``experts_down``, on its device
    → ``(outs, aux)``: each coordinate's output on its home, and the
    load-balance loss of all the tokens on coordinate 0's home. Routing,
    slots and capacity are the unsharded layer's."""
    e, k = cfg.n_experts, cfg.router_top_k
    t = sum(h.shape[0] * h.shape[1] for h in hs)
    cap = capacity if capacity is not None else \
        expert_capacity(t * k, e, cfg.capacity_factor)
    toks = [h.reshape(-1, h.shape[-1]) for h in hs]
    chosen = [_choose(x, pieces[c, 0]["router"], cfg)
              for c, x in enumerate(toks)]
    before, total = exclusive_sums([ch[4] for ch in chosen])
    xin, combine = [], []
    for c, (x, ch) in enumerate(zip(toks, chosen)):
        d_c, c_c = _slots(ch[3], ch[1], before[c], total.to(x.device), cap)
        xin.append(torch.einsum("tec,td->ecd", d_c.to(cfg.dtype), x))
        combine.append(c_c)
    # each position's experts over every coordinate's slots, then the tp
    # partial products summed on the coordinate's home
    xout = []
    for c in range(ls.n_data):
        i = ls.data[c].get("ep", 0)
        parts = []
        for j in range(ls.tp):
            dev = ls.device(c, j)
            batch = member_sum([x.chunk(ls.ep, dim=0)[i] for x in xin], dev)
            parts.append(_expert_ffn(batch, pieces[c, j], cfg))
        xout.append(member_sum(parts, ls.home(c)))
    outs = []
    for c, (h, comb) in enumerate(zip(hs, combine)):
        every = member_cat([xout[ls.index(**{**ls.data[c], "ep": i})]
                            for i in range(ls.ep)], 0, ls.home(c))
        out = torch.einsum("tec,ecd->td", comb.to(cfg.dtype), every)
        outs.append(out.reshape(h.shape))
    home = ls.home(0)
    load = total[0].float() / t
    prob = member_sum([ch[0].sum(dim=0) for ch in chosen], home) / t
    return outs, e * (load.to(home) * prob).sum()


def _moe_one_process(x, params, cfg, rules, capacity):
    """:func:`moe_layer` on a one-process mesh: the global ``x`` and
    ``params`` cut into the positions' rows and pieces, through
    :func:`lockstep_moe`, the output joined on ``x``'s device."""
    from ..parallel.sharding import Lockstep

    ls = Lockstep(rules)
    hs = [ls.rows(x, c).to(ls.home(c)) for c in range(ls.n_data)]
    pieces = {(c, j): {name: ls.piece(w, rules.param_sharding(("moe", name)),
                                      c, j).to(ls.device(c, j))
                       for name, w in params.items()}
              for c in range(ls.n_data) for j in range(ls.tp)}
    outs, aux = lockstep_moe(hs, pieces, cfg, ls, capacity=capacity)
    return member_cat(outs, 0, x.device), aux.to(x.device)

