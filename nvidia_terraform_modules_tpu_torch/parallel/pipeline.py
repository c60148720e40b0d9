# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Pipeline parallelism over a ``pp`` mesh axis — the port of the
reference's ``parallel/pipeline.py``: GPipe and 1F1B, with data
parallelism beside the stages and Megatron tensor parallelism inside them.

The params tree is the reference's: ``embed [vocab, D]``, ``out_norm [D]``
and ``layers``, a dict of per-layer weights stacked ``[L, ...]``. A stage
holds ``L / pp`` rows of each stack and, with ``tp``, its columns
(``wq``/``wk``/``wv``/``up``) or rows (``wo``/``down``) as
:func:`_layer_specs` says; the norms, ``embed`` and ``out_norm`` are
replicated. Stage 0 embeds, the last stage runs the tied head and the loss.

Two forms, chosen by the mesh (``("pp", "dp"[, "tp"])``):

- a one-process :class:`.mesh.Mesh` (``[cpu] * n`` in the tests,
  ``[cuda:0] * pp`` on one card): the process steps every stage of every
  ``dp`` coordinate in lock step over the global tree, each stage on its
  mesh device, its ``tp`` pieces cut from the stacks and their row-parallel
  partial products summed in member order;
- a :class:`.mesh.WorldMesh`: one rank is one stage of one ``dp`` row and
  one ``tp`` member; it holds its shard of the tree
  (:func:`place_pipeline_params`), activations and their gradients travel
  between stages by point-to-point transfers that both neighbours derive
  from the static schedule (:func:`.collectives.exchange`: nothing is sent
  on a tick that carries nothing), and ``tp`` inside a stage is Megatron's
  ``f``/``g`` pair (``enter_parallel``/``exit_parallel``).

Where the reference computes warm-up and drain ticks on garbage and masks
them out (XLA prefers uniform work), a skipped tick costs nothing here,
and its masked result is exactly zero there: only the valid (stage,
microbatch) pairs run, in the reference's tick order
(:func:`_gpipe_ticks`, :func:`_1f1b_ticks`).

- **GPipe** (:func:`pipeline_loss_fn`): all M forwards, then the backward.
  On a one-process mesh the backward is autograd through the forward
  schedule. On a world mesh it is the same schedule written out: every
  forward keeps its graph, then the microbatches go back in reverse order,
  each stage taking its output's gradient from the stage above, running
  its vjp and handing its input's gradient down.
- **1F1B** (:func:`pipeline_value_and_grad_1f1b`) owns its backward, as the
  reference does: each tick runs one forward and one backward sub-step a
  stage; the stage's inputs wait in a ring buffer of ``R = 2·pp − 1`` slots
  (independent of M), and the backward sub-step recomputes the stage from
  its saved input (``torch.autograd.grad`` over the stage's weights and
  input). Weight gradients accumulate in f32 and are divided by M at the
  end.

Gradients: with Megatron's autograd pairs each ``tp`` member's gradients
arrive true (the reference seeds its head vjp with ``1/tp`` and sums the
norm gradients over ``tp`` because JAX's manual mode transposes a psum
into a psum; nothing of that is needed here). ``embed`` takes two
contributions — the last stage's head and stage 0's lookup — summed over
``pp``; every gradient and the loss are averaged over ``dp``.

The stage's attention is exact causal attention: on CUDA tensors the
flash kernels (K1 forward, K5 — or K3 + K4 — backward, through
``ops/flash_attention.flash_attention``), where the reference's stage calls
XLA's dense attention (a ``[B, H, S, S]`` f32 score tensor that GPipe
would keep for every layer and microbatch); on CPU tensors the plain dense
math (``ops/ring_attention.dense_reference_attention``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.layers import dense_init
from ..utils.layers import rmsnorm as _rmsnorm
from .collectives import enter_parallel, exchange, exit_parallel
from .mesh import WorldMesh
from .sharding import gather_shards, local_shard

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "up", "down")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    d_ff: int = 128
    n_layers: int = 4
    seq_len: int = 32
    microbatch: int = 2        # examples per microbatch
    n_microbatches: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_pipeline_params(cfg: PipelineConfig,
                         generator: torch.Generator | None = None,
                         device="cuda") -> dict:
    """Embed/head (replicated) + per-layer weights stacked on axis 0, in
    ``cfg.dtype``, drawn in f32 from ``generator`` (default: seed 0 on
    ``device``). The draws differ from the reference's ``jax.random``
    ones; parity tests load the reference's weights through
    ``models/convert.pipeline_params_from_numpy``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_pipeline_params: no CUDA device is "
                           "available (pass device='cpu')")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def dense(shape):
        return dense_init(generator, shape, cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=generator.device)

    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff
    return {
        "embed": dense((cfg.vocab, D)),
        "out_norm": ones(D),
        "layers": {
            "attn_norm": ones(L, D),
            "wq": dense((L, D, D)),
            "wk": dense((L, D, D)),
            "wv": dense((L, D, D)),
            "wo": dense((L, D, D)),
            "mlp_norm": ones(L, D),
            "up": dense((L, D, Fd)),
            "down": dense((L, Fd, D)),
        },
    }


def _attention(q, k, v):
    """Exact causal attention: the flash kernels on CUDA tensors, the dense
    math on CPU tensors."""
    # imported here: ops/ imports parallel/ (the ring's hops), so a
    # module-level import would be circular
    from ..ops.flash_attention import flash_attention
    from ..ops.ring_attention import dense_reference_attention

    if q.is_cuda:
        return flash_attention(q, k, v, causal=True)
    return dense_reference_attention(q, k, v, causal=True)


def _block(layer, x, cfg: PipelineConfig, group=None):
    """One dense transformer block; ``layer`` leaves have NO layer dim.
    ``layer`` is one dict, or a list of the ``tp`` members' pieces that
    this process holds (columns of ``wq``/``wk``/``wv``/``up``, rows of
    ``wo``/``down``; the norms are read from the first): each piece runs
    its heads and FFN columns and the row-parallel partial products are
    summed in member order, then over ``group`` (a world's ``tp`` line:
    Megatron's ``f`` before each column-parallel product, ``g`` after each
    row-parallel one)."""
    pieces = layer if isinstance(layer, (list, tuple)) else [layer]
    B, S, _ = x.shape
    hd = cfg.head_dim
    h = enter_parallel(_rmsnorm(x, pieces[0]["attn_norm"]), group)
    attn_out = None
    for p in pieces:
        heads = p["wq"].shape[-1] // hd
        q = (h @ p["wq"]).view(B, S, heads, hd)
        k = (h @ p["wk"]).view(B, S, heads, hd)
        v = (h @ p["wv"]).view(B, S, heads, hd)
        ctx = _attention(q, k, v).reshape(B, S, heads * hd)
        part = ctx @ p["wo"]
        attn_out = part if attn_out is None else attn_out + part
    x = x + exit_parallel(attn_out, group)
    h = enter_parallel(_rmsnorm(x, pieces[0]["mlp_norm"]), group)
    ffn_out = None
    for p in pieces:
        u = F.gelu((h @ p["up"]).float(), approximate="tanh").to(x.dtype)
        part = u @ p["down"]
        ffn_out = part if ffn_out is None else ffn_out + part
    return x + exit_parallel(ffn_out, group)


def _tp_pieces(stage_layers: dict, tp: int) -> list:
    """The ``tp`` members' pieces of a stage's stacks (views), cut as
    :func:`_layer_specs` says; ``[stage_layers]`` when ``tp`` is 1."""
    if tp == 1:
        return [stage_layers]
    specs = _layer_specs(tp)
    out = [{} for _ in range(tp)]
    for key, w in stage_layers.items():
        dim = specs[key].index("tp") if "tp" in specs[key] else None
        for j in range(tp):
            out[j][key] = w if dim is None else w.chunk(tp, dim=dim)[j]
    return out


def _stage(stage_layers, x, cfg: PipelineConfig, tp: int = 1, group=None):
    """Apply this stage's stacked layers ``[L/pp, ...]`` in order;
    ``tp`` is the number of ``tp`` pieces this process holds of them (a
    one-process mesh: every member's), ``group`` a world's ``tp`` line."""
    pieces = _tp_pieces(stage_layers, tp)
    n = pieces[0]["wq"].shape[0]
    for idx in range(n):
        x = _block([{k: w[idx] for k, w in p.items()} for p in pieces], x,
                   cfg, group)
    return x


def _head_loss(out, embed, out_norm, tgt):
    """Final-stage LM head + mean NLL for one microbatch — the ONE
    definition both schedules share, so their losses cannot drift."""
    h = _rmsnorm(out, out_norm)
    logits = (h @ embed.T).float()
    logp = F.log_softmax(logits, dim=-1)
    return (-logp.gather(-1, tgt[..., None]).squeeze(-1)).mean()


def _validate_pipeline(cfg: PipelineConfig, mesh, batch):
    """Shared config/mesh/batch checks → (pp, dp, tp). Named quantities,
    not a reshape error deep in the schedule."""
    if "pp" not in mesh.shape or "dp" not in mesh.shape:
        raise ValueError(
            f"pipeline needs a ('pp', 'dp'[, 'tp']) mesh; got axes "
            f"{tuple(mesh.axis_names)} (use dp=1 for no data parallelism)")
    pp = mesh.shape["pp"]
    dp = mesh.shape["dp"]
    tp = mesh.shape.get("tp", 1)
    if cfg.n_layers % pp != 0:
        raise ValueError(
            f"n_layers = {cfg.n_layers} does not divide into pp = {pp} "
            f"stages")
    if tp > 1 and (cfg.n_heads % tp or cfg.d_ff % tp or cfg.d_model % tp):
        raise ValueError(
            f"tp = {tp} must divide n_heads ({cfg.n_heads}), d_ff "
            f"({cfg.d_ff}), and d_model ({cfg.d_model})")
    expected = cfg.n_microbatches * cfg.microbatch * dp
    if batch[0].shape[0] != expected:
        raise ValueError(
            f"batch has {batch[0].shape[0]} rows; pipeline needs "
            f"n_microbatches·microbatch·dp = {cfg.n_microbatches}·"
            f"{cfg.microbatch}·{dp} = {expected}")
    return pp, dp, tp


def _layer_specs(tp: int) -> dict:
    """Specs for the stacked layer dict: ``pp`` on the layer dim, ``tp``
    on the Megatron dim of each weight (none when tp == 1)."""
    if tp == 1:
        return {k: ("pp",) for k in LAYER_KEYS}
    col, row = ("pp", None, "tp"), ("pp", "tp", None)
    return {
        "attn_norm": ("pp",), "mlp_norm": ("pp",),
        "wq": col, "wk": col, "wv": col, "up": col,
        "wo": row, "down": row,
    }


def stack_sharding(mesh, params) -> dict:
    """The spec of every leaf: layer stacks over ``pp`` (+ Megatron ``tp``
    dims when the mesh carries a tp axis), embed/head replicated."""
    specs = _layer_specs(mesh.shape.get("tp", 1))
    return {"embed": (), "out_norm": (),
            "layers": {k: specs[k] for k in params["layers"]}}


def place_pipeline_params(params: dict, mesh) -> dict:
    """The global tree placed for ``mesh``: on a world mesh this rank's
    shard of every leaf (:func:`stack_sharding`); on a one-process mesh
    the whole tree on its first device, where the process keeps it."""
    if isinstance(mesh, WorldMesh):
        specs = stack_sharding(mesh, params)
        return {"embed": params["embed"], "out_norm": params["out_norm"],
                "layers": {k: local_shard(w, specs["layers"][k], mesh)
                           for k, w in params["layers"].items()}}
    home = mesh.devices.flat[0]
    return {"embed": params["embed"].to(home),
            "out_norm": params["out_norm"].to(home),
            "layers": {k: w.to(home) for k, w in params["layers"].items()}}


def gather_pipeline_params(params: dict, mesh) -> dict:
    """The global tree from every rank's shard (the inverse of
    :func:`place_pipeline_params`; every rank gets it); a one-process
    mesh's tree is global already."""
    if not isinstance(mesh, WorldMesh):
        return params
    specs = stack_sharding(mesh, params)
    return {"embed": params["embed"], "out_norm": params["out_norm"],
            "layers": {k: gather_shards(w, specs["layers"][k], mesh)
                       for k, w in params["layers"].items()}}


# ------------------------------------------------------------ schedules

def _gpipe_ticks(pp: int, M: int):
    """GPipe's ticks: ``(t, [(stage, microbatch), ...])`` for ``t`` in
    ``0 .. M + pp - 2``, only the valid pairs (stage ``i`` works on
    microbatch ``t - i``)."""
    for t in range(M + pp - 1):
        yield t, [(i, t - i) for i in range(pp) if 0 <= t - i < M]


def _1f1b_ticks(pp: int, M: int):
    """1F1B's ticks: ``(t, [(stage, f, b), ...])`` for ``t`` in
    ``0 .. M + 2(pp - 1) - 1``: stage ``i`` runs the forward of microbatch
    ``f = t - i`` and the backward of ``b = t - 2(pp - 1) + i`` (``None``
    where out of range; stages with neither are left out). On the last
    stage ``f == b``: its head's gradient is consumed the tick it is made."""
    for t in range(M + 2 * (pp - 1)):
        pairs = []
        for i in range(pp):
            f, b = t - i, t - 2 * (pp - 1) + i
            f = f if 0 <= f < M else None
            b = b if 0 <= b < M else None
            if f is not None or b is not None:
                pairs.append((i, f, b))
        yield t, pairs


def _split_batch(batch, cfg: PipelineConfig, dp: int, d: int):
    """Data row ``d``'s microbatches ``[M, mb, S]`` of the global batch
    (the rows split into ``dp`` contiguous pieces, as ``P(None, "dp")``
    cuts them)."""
    M, mb, S = cfg.n_microbatches, cfg.microbatch, cfg.seq_len
    return tuple(x.chunk(dp)[d].reshape(M, mb, S) for x in batch)


def _stage_rows(layers: dict, i: int, pp: int) -> dict:
    """Stage ``i``'s rows of the stacks (views)."""
    return {k: w.chunk(pp)[i] for k, w in layers.items()}


class _World:
    """This rank's place on a world mesh: stage ``i`` of ``pp``, data row
    ``d`` of ``dp``, its ``tp`` line's group (None when tp is 1)."""

    def __init__(self, mesh: WorldMesh):
        self.mesh = mesh
        self.pp, self.i = mesh.axis_size("pp"), mesh.index("pp")
        self.dp, self.d = mesh.axis_size("dp"), mesh.index("dp")
        self.tp_group = (mesh.group("tp") if "tp" in mesh.axis_names
                         else None)
        self.last = self.i == self.pp - 1


# ------------------------------------------------------------- GPipe

def pipeline_loss_fn(params, batch, cfg: PipelineConfig, mesh):
    """Pipelined forward + LM loss over a ``("pp", "dp"[, "tp"])`` mesh.

    ``batch`` is the global ``(tokens, targets)``, each
    ``[n_microbatches · microbatch · dp, seq]``; data row ``d`` takes its
    contiguous ``[M, mb, S]`` piece. Stage 0 feeds microbatch ``t`` at tick
    ``t``, stage ``i`` works on microbatch ``t - i``, the last stage takes
    each microbatch's mean NLL; the loss is their sum over M, averaged
    over ``dp``. On a one-process mesh it is differentiable (GPipe's
    backward is autograd through this schedule); on a world mesh it is the
    forward alone, each rank returning the world's loss (the schedule's
    backward is written out in :func:`_gpipe_world`)."""
    pp, dp, tp = _validate_pipeline(cfg, mesh, batch)
    if isinstance(mesh, WorldMesh):
        with torch.no_grad():
            return _gpipe_world(params, batch, cfg, mesh, grads=False)[0]
    M = cfg.n_microbatches
    embed, out_norm = params["embed"], params["out_norm"]
    stages = [_stage_rows(params["layers"], i, pp) for i in range(pp)]
    total = None
    for d in range(dp):
        devs = [mesh.device_at(pp=i, dp=d) for i in range(pp)]
        tokens, targets = _split_batch(batch, cfg, dp, d)
        arrived: dict[int, torch.Tensor] = {}
        losses = []
        for _, pairs in _gpipe_ticks(pp, M):
            sent = {}
            for i, f in pairs:
                x = (embed[tokens[f]] if i == 0 else arrived.pop(i)).to(
                    devs[i])
                out = _stage(stages[i], x, cfg, tp)
                if i == pp - 1:
                    losses.append(_head_loss(out, embed.to(devs[i]),
                                             out_norm.to(devs[i]),
                                             targets[f].to(devs[i])))
                else:        # the hop to the next stage's device
                    sent[i + 1] = out.to(devs[i + 1])
            arrived.update(sent)
        row = sum(loss.to(embed.device) for loss in losses) / M
        total = row if total is None else total + row
    return total / dp


def _gpipe_world(params, batch, cfg: PipelineConfig, mesh: WorldMesh, *,
                 grads: bool):
    """GPipe on a world mesh: every forward of this rank's stage, in the
    schedule's order, each graph kept when ``grads``; then the backward,
    microbatch M-1 first: the output's gradient from the stage above (the
    last stage: its loss), the stage's vjp, the input's gradient to the
    stage below. → ``(loss, grads or None)``."""
    w = _World(mesh)
    M = cfg.n_microbatches
    tokens, targets = _split_batch(batch, cfg, w.dp, w.d)
    leaves = _leaves(params, grads)
    shape, dtype = (cfg.microbatch, cfg.seq_len, cfg.d_model), cfg.dtype
    saved = []                      # (input, output or loss) a microbatch
    loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for f in _stage_microbatches(_gpipe_ticks(w.pp, M), w.i):
        with torch.set_grad_enabled(grads):
            if w.i == 0:
                x = leaves["embed"][tokens[f]]
            else:
                x = exchange(mesh, "pp", recvs=[(shape, dtype, -1)])[0]
                x.requires_grad_(grads)
            out = _stage(leaves["layers"], x, cfg, 1, w.tp_group)
            if w.last:
                out = _head_loss(out, leaves["embed"], leaves["out_norm"],
                                 targets[f])
                loss = loss + out.detach()
            else:
                exchange(mesh, "pp", sends=[(out.detach(), 1)])
        if grads:
            saved.append((x, out))
    acc = _zeros_f32(leaves) if grads else None
    for x, out in reversed(saved):
        d_out = (None if w.last else
                 exchange(mesh, "pp", recvs=[(shape, dtype, 1)])[0])
        d_x = _accumulate(acc, leaves, x if w.i > 0 else None, out, d_out)
        if w.i > 0:
            exchange(mesh, "pp", sends=[(d_x, -1)])
    return _world_reduce(loss, acc, params, mesh, M)


def _stage_microbatches(ticks, i: int) -> list:
    """The microbatches stage ``i`` runs, in the schedule's order."""
    return [f for _, pairs in ticks for j, f in pairs if j == i]


def _map(fn, tree) -> dict:
    """``fn`` of every leaf of a pipeline tree, in its layout."""
    return {"embed": fn(tree["embed"]), "out_norm": fn(tree["out_norm"]),
            "layers": {k: fn(x) for k, x in tree["layers"].items()}}


def _leaves(params, grads: bool) -> dict:
    """The params as fresh leaves (requiring gradients when ``grads``)."""
    return _map(lambda x: x.detach().requires_grad_(grads), params)


def _flat(tree) -> list:
    return [tree["embed"], tree["out_norm"],
            *(tree["layers"][k] for k in sorted(tree["layers"]))]


def _unflat(tree, leaves) -> dict:
    """The inverse of :func:`_flat`, in ``tree``'s layout."""
    return {"embed": leaves[0], "out_norm": leaves[1],
            "layers": dict(zip(sorted(tree["layers"]), leaves[2:]))}


def _zeros_f32(tree) -> dict:
    return _map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)


def _accumulate(acc: dict, leaves: dict, x, out, d_out):
    """One microbatch's vjp through this stage into the f32 accumulators:
    ``out`` is the stage's output (``d_out`` its gradient) or, with
    ``d_out`` None, the last stage's loss. Returns the gradient of the
    stage input ``x`` (None when ``x`` is None: stage 0, whose input is
    the embedding lookup, reached through ``leaves["embed"]``)."""
    inputs = _flat(leaves) + ([x] if x is not None else [])
    got = torch.autograd.grad(
        out, inputs, grad_outputs=d_out, allow_unused=True)
    for a, g in zip(_flat(acc), got):
        if g is not None:
            a += g.float()
    return got[-1] if x is not None else None


def _world_reduce(loss, acc, params, mesh: WorldMesh, M: int):
    """The loss and (with ``acc``) gradients of the world: ``embed`` and
    ``out_norm`` summed over ``pp`` (stage 0's lookup, the last stage's
    head) with the loss (only the last stage holds it), everything over M
    and averaged over ``dp``; gradients in the params' dtypes."""
    pp_group, dp_group = mesh.group("pp"), mesh.group("dp")
    grads = _flat(acc) if acc is not None else []
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads[:2]])
    if pp_group is not None:
        dist.all_reduce(flat, group=pp_group)
    flat = torch.cat([flat] + [g.reshape(-1) for g in grads[2:]])
    if dp_group is not None:
        dist.all_reduce(flat, group=dp_group)
    flat = flat / (M * mesh.axis_size("dp"))
    if acc is None:
        return flat[0], None
    parts = flat[1:].split([g.numel() for g in grads])
    return flat[0], _unflat(params, [
        p.view(g.shape).to(w.dtype)
        for p, g, w in zip(parts, grads, _flat(params))])


def _gpipe_value_and_grad(params, batch, cfg: PipelineConfig, mesh):
    if isinstance(mesh, WorldMesh):
        _validate_pipeline(cfg, mesh, batch)
        return _gpipe_world(params, batch, cfg, mesh, grads=True)
    with torch.enable_grad():
        live = _leaves(params, True)
        loss = pipeline_loss_fn(live, batch, cfg, mesh)
        got = torch.autograd.grad(loss, _flat(live))
    return loss.detach(), _unflat(params, got)


# -------------------------------------------------------------- 1F1B

def pipeline_value_and_grad_1f1b(params, batch, cfg: PipelineConfig, mesh):
    """1F1B: forward and backward interleaved → ``(loss, grads)``.

    Each tick runs one forward sub-step and one backward sub-step a stage
    (:func:`_1f1b_ticks`): the forward of microbatch ``f = t - i`` (as
    GPipe, without keeping its graph), the backward of ``b = t - 2(pp-1) +
    i``. A stage input saved at tick ``f + i`` is consumed at ``b + 2(pp-1)
    - i``, so a ring buffer of ``R = 2·pp − 1`` slots — independent of M —
    holds them; the backward sub-step recomputes the stage from the saved
    input under ``torch.enable_grad`` and takes ``torch.autograd.grad``
    over the stage's weights and input. Each stage's input gradient
    reaches the stage below one tick later; the last stage's head
    gradient is consumed the tick it is made. Gradients accumulate in f32,
    ``/M`` at the end; ``embed`` takes stage 0's lookup scatter-add and
    the last stage's head, summed over ``pp``; all averaged over ``dp``.
    The loss and gradients equal GPipe's and the unpipelined ones; the
    schedule changes memory, never the model. Gradients come back f32 on a
    one-process mesh (the global tree) and in the params' dtypes on a
    world mesh (this rank's shard)."""
    pp, dp, tp = _validate_pipeline(cfg, mesh, batch)
    if isinstance(mesh, WorldMesh):
        return _1f1b_world(params, batch, cfg, mesh)
    M, R = cfg.n_microbatches, 2 * pp - 1
    f32 = torch.float32
    home = params["embed"].device
    stages = [_leaves({"embed": params["embed"],
                       "out_norm": params["out_norm"],
                       "layers": _stage_rows(params["layers"], i, pp)}, True)
              for i in range(pp)]
    acc = [_zeros_f32(s) for s in stages]
    loss = torch.zeros((), dtype=f32, device=home)
    for d in range(dp):
        devs = [mesh.device_at(pp=i, dp=d) for i in range(pp)]
        tokens, targets = _split_batch(batch, cfg, dp, d)
        fwd_recv: dict[int, torch.Tensor] = {}
        bwd_recv: dict[int, torch.Tensor] = {}
        buf = [[None] * R for _ in range(pp)]
        for t, pairs in _1f1b_ticks(pp, M):
            fwd_sent, bwd_sent = {}, {}
            for i, f, b in pairs:
                loss_f, up, down = _1f1b_substep(
                    stages[i], acc[i], buf[i], t, i, pp, f, b,
                    fwd_recv.pop(i, None), bwd_recv.pop(i, None), tokens,
                    targets, cfg, tp, None, devs[i])
                if loss_f is not None:
                    loss += loss_f.to(home)
                if up is not None:
                    fwd_sent[i + 1] = up.to(devs[i + 1])
                if down is not None:
                    bwd_sent[i - 1] = down.to(devs[i - 1])
            fwd_recv.update(fwd_sent)
            bwd_recv.update(bwd_sent)
    inv = 1.0 / (M * dp)
    layers = {k: torch.cat([a["layers"][k].to(home) for a in acc]) * inv
              for k in params["layers"]}
    return loss * inv, {
        "embed": sum(a["embed"].to(home) for a in acc) * inv,
        "out_norm": sum(a["out_norm"].to(home) for a in acc) * inv,
        "layers": layers}


def _1f1b_substep(leaves, acc, buf, t, i, pp, f, b, x_in, d_in, tokens,
                  targets, cfg, tp, group, dev):
    """Stage ``i``'s sub-steps at 1F1B tick ``t``, the same in both forms
    (only how the returned tensors move differs). The forward of
    microbatch ``f`` (None: none this tick) from ``x_in`` (the stage
    below's activation; stage 0 looks its tokens up), its input saved
    into the ring buffer ``buf``; on the last stage the head's vjp into
    ``acc``. The backward of ``b`` recomputed from ``buf`` against
    ``d_in`` (the stage above's input gradient; the last stage uses its
    own head gradient), the weights' gradients into ``acc``, stage 0's
    lookup scatter-added into ``acc["embed"]``. Returns ``(loss, up,
    down)``: the head's loss, the activation for the stage above and the
    input gradient for the stage below, each None where there is none."""
    R, last = len(buf), i == pp - 1
    loss = up = down = head_grad = None
    if f is not None:
        with torch.no_grad():
            inp = (leaves["embed"][tokens[f]] if i == 0 else x_in).to(dev)
            out = _stage(leaves["layers"], inp, cfg, tp, group)
        buf[t % R] = inp
        if last:
            with torch.enable_grad():
                o = out.detach().requires_grad_(True)
                loss_f = _head_loss(o, leaves["embed"], leaves["out_norm"],
                                    targets[f].to(dev))
                d_o, d_e, d_n = torch.autograd.grad(
                    loss_f, [o, leaves["embed"], leaves["out_norm"]])
            acc["embed"] += d_e.float()
            acc["out_norm"] += d_n.float()
            loss, head_grad = loss_f.detach(), d_o.to(out.dtype)
        else:
            up = out
    if b is not None:
        saved, buf[(b + i) % R] = buf[(b + i) % R], None
        with torch.enable_grad():
            x = saved.detach().requires_grad_(True)
            out = _stage(leaves["layers"], x, cfg, tp, group)
            weights = [leaves["layers"][k] for k in sorted(leaves["layers"])]
            got = torch.autograd.grad(
                out, weights + [x],
                grad_outputs=head_grad if last else d_in)
        for k, g in zip(sorted(leaves["layers"]), got):
            acc["layers"][k] += g.float()
        if i == 0:
            acc["embed"].index_add_(0, tokens[b].reshape(-1).to(dev),
                                    got[-1].reshape(-1, cfg.d_model).float())
        else:
            down = got[-1]
    return loss, up, down


def _1f1b_world(params, batch, cfg: PipelineConfig, mesh: WorldMesh):
    """1F1B with this rank as its stage: each tick's forward and backward
    sub-steps, then one exchange with both neighbours posting exactly the
    transfers the schedule gives the next tick (the activation up when
    this tick's forward ran below the last stage, the input gradient down
    when its backward ran above stage 0 — and the matching receives,
    derived from the next tick on this rank's side)."""
    w = _World(mesh)
    M, R, pp, i = cfg.n_microbatches, 2 * w.pp - 1, w.pp, w.i
    tokens, targets = _split_batch(batch, cfg, w.dp, w.d)
    leaves = _leaves(params, True)
    acc = _zeros_f32(leaves)
    shape, dtype = (cfg.microbatch, cfg.seq_len, cfg.d_model), cfg.dtype
    loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
    buf = [None] * R
    fwd_in = bwd_in = None
    for t, pairs in _1f1b_ticks(pp, M):
        mine = [(f, b) for j, f, b in pairs if j == i]
        f, b = mine[0] if mine else (None, None)
        loss_f, up, down = _1f1b_substep(
            leaves, acc, buf, t, i, pp, f, b, fwd_in, bwd_in, tokens,
            targets, cfg, 1, w.tp_group, mesh.device)
        if loss_f is not None:
            loss += loss_f
        sends = [(x, d) for x, d in ((up, 1), (down, -1)) if x is not None]
        # the next tick's inputs: an activation from below when its
        # forward is valid above stage 0, a gradient from above when its
        # backward is valid below the last stage
        f1, b1 = t + 1 - i, t + 1 - 2 * (pp - 1) + i
        recvs = []
        if i > 0 and 0 <= f1 < M:
            recvs.append((shape, dtype, -1))
        if not w.last and 0 <= b1 < M:
            recvs.append((shape, dtype, 1))
        got = exchange(mesh, "pp", sends=sends, recvs=recvs)
        fwd_in = got.pop(0) if i > 0 and 0 <= f1 < M else None
        bwd_in = got.pop(0) if not w.last and 0 <= b1 < M else None
    return _world_reduce(loss, acc, params, mesh, M)


SCHEDULES = ("gpipe", "1f1b")


def make_pipeline_train_step(cfg: PipelineConfig, mesh, lr: float = 1e-3,
                             schedule: str = "gpipe"):
    """SGD step ``step(params, batch) → (params, loss)`` over the pipelined
    loss: ``p − lr·g.to(p.dtype)`` for every leaf, into new tensors.

    ``schedule="gpipe"``: the backward through the forward schedule
    (autograd on a one-process mesh, the written-out reverse schedule on a
    world mesh). ``schedule="1f1b"``: :func:`pipeline_value_and_grad_1f1b`
    — same loss, same gradients, O(pp) instead of O(M) live activations a
    stage. ``params`` is the tree :func:`place_pipeline_params` gives for
    ``mesh``; ``batch`` the global batch."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {schedule!r}; use one of "
            f"{SCHEDULES}")
    grads_of = (_gpipe_value_and_grad if schedule == "gpipe"
                else pipeline_value_and_grad_1f1b)

    def step(params, batch):
        loss, grads = grads_of(params, batch, cfg, mesh)
        with torch.no_grad():
            new = {"embed": params["embed"] - lr * grads["embed"].to(
                       params["embed"].dtype),
                   "out_norm": params["out_norm"] - lr * grads[
                       "out_norm"].to(params["out_norm"].dtype),
                   "layers": {k: w - lr * grads["layers"][k].to(w.dtype)
                              for k, w in params["layers"].items()}}
        return new, loss

    return step


def reference_loss_fn(params, batch, cfg: PipelineConfig):
    """The same model WITHOUT the pipeline: every layer applied in order
    on one device — the equivalence oracle for the schedule."""
    tokens, targets = batch
    x = params["embed"][tokens]
    layers = params["layers"]
    for idx in range(layers["wq"].shape[0]):
        x = _block({k: w[idx] for k, w in layers.items()}, x, cfg)
    h = _rmsnorm(x, params["out_norm"])
    logits = (h @ params["embed"].T).float()
    logp = F.log_softmax(logits, dim=-1)
    return (-logp.gather(-1, targets[..., None]).squeeze(-1)).mean()


def pipeline_step_flops(cfg: PipelineConfig) -> float:
    """Model FLOPs of one train step over the ``M · microbatch`` rows of a
    data row (fwd + bwd = 3 × fwd; 1F1B's recompute is not billed): the
    projections, causal attention at half the score matrix, the FFN and
    the tied head."""
    b, s, d, f, v = (cfg.n_microbatches * cfg.microbatch, cfg.seq_len,
                     cfg.d_model, cfg.d_ff, cfg.vocab)
    per_layer = 8.0 * b * s * d * d + 2.0 * b * s * s * d \
        + 4.0 * b * s * d * f
    return 3.0 * (cfg.n_layers * per_layer + 2.0 * b * s * d * v)


__all__ = [
    "PipelineConfig",
    "SCHEDULES",
    "gather_pipeline_params",
    "init_pipeline_params",
    "make_pipeline_train_step",
    "pipeline_loss_fn",
    "pipeline_step_flops",
    "pipeline_value_and_grad_1f1b",
    "place_pipeline_params",
    "reference_loss_fn",
    "stack_sharding",
]
