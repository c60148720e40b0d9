"""The burn-in model in plain PyTorch: a pre-norm decoder (RMSNorm with
eps 1e-6, multi-head causal attention at scale 1/sqrt(head_dim), no
position encoding, a GELU-tanh FFN of ``up``/``down`` or a Switch-routed
one, a final RMSNorm and the embedding as the tied head), its
cross-entropy loss with the Switch load-balance term, and SGD.

Everything is computed in f32 under :func:`exact` (TF32 off). ``fp8=True``
is the control: every matrix product takes its two operands rounded to
float8 e4m3 (one scale a tensor, its absolute max at 448), with the
gradient passed straight through the rounding; the router stays f32, as
the configuration states.

Routing (Switch, top-1): the router's softmax in f32, the top expert by
argmax (ties to the lower index), the output scaled by its probability.
At train capacity an expert keeps the first ``capacity`` tokens routed to
it in the flattened ``[batch, seq]`` order and a dropped token adds
nothing; the serve path routes without a capacity. The aux loss is
``E · Σ_e (tokens routed to e / T) · mean_t prob[t, e]``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact():
    """f32 products in f32 (no TF32) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (absolute max → 448),
    returned in f32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _RoundE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return to_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = _RoundE4M3.apply(a), _RoundE4M3.apply(b)
    return a @ b


def rmsnorm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * w


def attention(h: torch.Tensor, layer: dict, m: dict, fp8: bool):
    """Causal self-attention of ``h`` ``[B, S, D]``."""
    b, s, d = h.shape
    heads = m["n_heads"]
    hd = d // heads
    kvh = m.get("n_kv_heads") or heads
    q = mm(h, layer["wq"], fp8).view(b, s, heads, hd).transpose(1, 2)
    k = mm(h, layer["wk"], fp8).view(b, s, kvh, hd).transpose(1, 2)
    v = mm(h, layer["wv"], fp8).view(b, s, kvh, hd).transpose(1, 2)
    if kvh != heads:
        k = k.repeat_interleave(heads // kvh, dim=1)
        v = v.repeat_interleave(heads // kvh, dim=1)
    scores = mm(q, k.transpose(-1, -2), fp8) * (1.0 / math.sqrt(hd))
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(p, v, fp8).transpose(1, 2).reshape(b, s, d)
    return mm(o, layer["wo"], fp8)


def gelu_ffn(h, up, down, fp8):
    return mm(F.gelu(mm(h, up, fp8), approximate="tanh"), down, fp8)


def expert_capacity(tokens: int, n_experts: int, factor: float) -> int:
    """``ceil(tokens / E · factor)`` up to a multiple of 8, at least 8."""
    cap = math.ceil(tokens / n_experts * factor)
    return max(8, math.ceil(cap / 8) * 8)


def routed_ffn(h: torch.Tensor, moe: dict, m: dict, capacity, fp8: bool):
    """Switch FFN of ``h`` ``[B, S, D]`` → ``(out, aux)``; ``capacity``
    None routes every token."""
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    e = m["n_experts"]
    probs = torch.softmax(x @ moe["router"], dim=-1)          # f32 router
    top_p, top_e = probs.max(dim=-1)
    onehot = F.one_hot(top_e, e)
    keep = torch.ones_like(top_e, dtype=torch.bool)
    if capacity is not None:
        slot = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
        keep = slot < capacity
    out = torch.zeros_like(x)
    for j in range(e):
        idx = torch.nonzero((top_e == j) & keep).squeeze(-1)
        if idx.numel():
            y = gelu_ffn(x[idx], moe["experts_up"][j],
                         moe["experts_down"][j], fp8)
            out = out.index_add(0, idx, y * top_p[idx, None])
    load = onehot.float().mean(dim=0)
    aux = e * (load * probs.mean(dim=0)).sum()
    return out.view(b, s, d), aux


def block(x, layer, m: dict, capacity, fp8: bool):
    x = x + attention(rmsnorm(x, layer["attn_norm"]), layer, m, fp8)
    h = rmsnorm(x, layer["mlp_norm"])
    if m.get("n_experts", 0):
        out, aux = routed_ffn(h, layer["moe"], m, capacity, fp8)
    else:
        out, aux = gelu_ffn(h, layer["up"], layer["down"], fp8), None
    return x + out, aux


def forward(params: dict, tokens: torch.Tensor, m: dict, *, capacity=None,
            fp8: bool = False, remat: bool = False):
    """Logits ``[B, S, vocab]`` and the summed aux loss of ``tokens``
    ``[B, S]``; ``remat`` recomputes each block in the backward."""
    x = params["embed"][tokens]
    aux = torch.zeros((), device=x.device)
    for layer in params["layers"]:
        if remat:
            x, a = checkpoint(block, x, layer, m, capacity, fp8,
                              use_reentrant=False)
        else:
            x, a = block(x, layer, m, capacity, fp8)
        if a is not None:
            aux = aux + a
    x = rmsnorm(x, params["out_norm"])
    return mm(x, params["embed"].T, fp8), aux


def serve_logits(params: dict, tokens: torch.Tensor, m: dict,
                 fp8: bool = False) -> torch.Tensor:
    """Logits ``[T, vocab]`` of one sequence ``[T]``, every token routed."""
    with torch.no_grad():
        return forward(params, tokens[None], m, fp8=fp8)[0][0]


def loss(params: dict, tokens, targets, m: dict, fp8: bool = False):
    """Mean next-token cross-entropy plus ``aux_loss_weight`` × aux, with
    the experts at train capacity."""
    t = tokens.numel()
    cap = (expert_capacity(t * m.get("router_top_k", 1), m["n_experts"],
                           m.get("capacity_factor", 1.25))
           if m.get("n_experts", 0) else None)
    logits, aux = forward(params, tokens, m, capacity=cap, fp8=fp8,
                          remat=True)
    nll = F.cross_entropy(logits.reshape(t, -1), targets.reshape(t))
    return nll + m.get("aux_loss_weight", 0.01) * aux


def sgd_step(params: dict, batch, m: dict, lr: float, stored: list,
             fp8: bool = False):
    """One SGD step on ``params`` (f32, updated in place): ``p ← p − lr ·
    g`` in f32, the result kept in the type the configuration stores that
    leaf in (``stored``, in :func:`leaves` order: the model type, the
    router f32). Returns the loss and the f32 gradients."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    value = loss(params, *batch, m, fp8)
    grads = torch.autograd.grad(value, flat)
    with torch.no_grad():
        for p, g, dt in zip(flat, grads, stored):
            p.requires_grad_(False)
            p.copy_((p - lr * g).to(dt).float())
    return float(value.detach()), grads


def leaves(params: dict) -> list:
    """Every leaf: ``embed``, ``out_norm``, then each layer's in its
    order (a nested group's in its own)."""
    out = [params["embed"], params["out_norm"]]
    for layer in params["layers"]:
        for v in layer.values():
            out += list(v.values()) if isinstance(v, dict) else [v]
    return out
