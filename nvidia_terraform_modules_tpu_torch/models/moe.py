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

Expert sharding over ``ep`` is not ported (ROADMAP Queue A item 6):
``rules`` whose mesh has an axis above 1 raise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def check_rules(rules) -> None:
    """Refuse a mesh with any axis above 1: the experts would shard over
    ``ep`` there, which the port does not do yet."""
    if rules is None:
        return
    big = {a: n for a, n in rules.mesh.shape.items() if n > 1}
    if big:
        raise NotImplementedError(
            f"MoE over a mesh {big} (experts sharded over ep) is not ported "
            f"yet — ROADMAP.md, Queue A item 6: parallel/")


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
    ones included, with the load of the rank-0 choices."""
    check_rules(rules)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.router_top_k
    c = capacity if capacity is not None else \
        expert_capacity(b * s * k, e, cfg.capacity_factor)
    out, probs, top_e = routed_ffn(x, params, cfg, c)
    load = _one_hot(top_e[:, 0], e, torch.float32).mean(dim=0)
    aux = e * (load * probs.mean(dim=0)).sum()
    return out, aux


def routed_ffn(x: torch.Tensor, params: dict, cfg, capacity: int):
    """:func:`moe_layer`'s routing and expert FFN at ``capacity`` slots an
    expert, without the aux loss (which the serve path, like XLA's dead-code
    elimination in the reference, never computes) → ``(out [B, S, D],
    probs [T, E], top_e [T, k])``."""
    b, s, d = x.shape
    e, k, c = cfg.n_experts, cfg.router_top_k, capacity
    t = b * s
    tokens = x.reshape(t, d)
    router = params["router"]
    logits = (tokens.float()[:, :, None] * router.float()).sum(dim=1)
    probs = torch.softmax(logits, dim=-1)                     # [T, E]
    top_p, top_e = _top_k(probs, k)                           # [T, K]
    if k > 1:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    dispatch = torch.zeros((t, e, c), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    # int32 counts: f32 would lose integer exactness past 2^24 tokens
    used = torch.zeros((e,), dtype=torch.int32, device=x.device)
    for r in range(k):
        oh = _one_hot(top_e[:, r], e, torch.int32)            # [T, E]
        # the slot within the expert's batch: an exclusive cumsum along the
        # tokens, behind the lower ranks' per-expert totals
        pos = (torch.cumsum(oh, dim=0, dtype=torch.int32) * oh - oh
               + used[None] * oh)
        within = ((pos < c) & (oh == 1)).float()
        d_r = _one_hot(pos, c, torch.float32) * within[..., None]
        dispatch = dispatch + d_r
        combine = combine + d_r * top_p[:, r, None, None]
        used = used + oh.sum(dim=0, dtype=torch.int32)

    xin = torch.einsum("tec,td->ecd", dispatch.to(cfg.dtype), tokens)
    h = torch.bmm(xin, params["experts_up"])
    h = F.gelu(h.float(), approximate="tanh").to(cfg.dtype)
    xout = torch.bmm(h, params["experts_down"])
    out = torch.einsum("tec,ecd->td", combine.to(cfg.dtype), xout)
    return out.reshape(b, s, d), probs, top_e
