# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The burn-in transformer — the port of the reference's ``models/burnin.py``:
:class:`BurnInConfig`, :func:`apply_rope`, :func:`init_params` (the same
dict layout), the inference-only :func:`forward` (the decode oracle), and
the training side — the differentiable :func:`forward_and_aux`,
:func:`loss_fn`, :func:`synthetic_batch`, :func:`grad_accum` /
:func:`make_grads_fn`, the SGD :func:`make_train_step` and
:func:`train_step_flops` (AdamW is in ``models/optimizer.py``), the
parameters' shapes and placement without tensors (:func:`param_shapes`,
:func:`abstract_params`) — and the
telemetry wrapper :func:`instrument_step` with its one-shot flash probe.

Parameters are a plain dict of tensors: ``embed [vocab, d]``, ``out_norm``
and ``layers[i]`` holding ``attn_norm``/``wq``/``wk``/``wv``/``wo``/
``mlp_norm`` and the FFN — ``up``/``down``, or with ``n_experts > 0`` a
``moe`` dict (``models/moe.py``: an f32 ``router`` and the stacked
``experts_up``/``experts_down``); gradients and optimizer moments are dicts
of the same shape. A train step is functional, as the reference's jitted step
is: it returns new parameters and leaves the caller's unchanged.

Sharding ``rules`` (``parallel.make_rules``) carry a mesh, of one of two
kinds (``parallel/mesh.py``):

- a one-process ``Mesh`` (``[cuda:0] * n``, ``[cpu] * n``: any plan of
  ``plan_mesh``, ``dp``, ``tp``, ``ep``, ``sp`` and their products), run
  in lock step (:func:`_lockstep_forward`; ``parallel.sharding.Lockstep``):
  the parameters and the batch stay global on the mesh's first device, and
  the process steps every position — a data coordinate (its rows of the
  batch) and a ``tp`` member — in turn. Each member computes its heads and
  FFN columns on its own device from its pieces of the tree (the column
  and row splits of :func:`shard_params`); the row-parallel partial
  products and the tied head's partial logits are summed in member order
  on the coordinate's home device, where the residual stream, the norms
  and the loss live; MoE routes as the unsharded layer does
  (``moe.lockstep_moe``: the ``ep`` members hold their experts). With
  ``attn="ring"``/``"ulysses"`` each member's attention is the ring or
  Ulysses over the ``sp`` devices of its line; flash and dense attend the
  member's whole sequence (``sp`` replicates). Every collective is a plain
  tensor operation — a sum, a ``cat``, ``.to(device)`` — so one autograd
  graph holds every position, and the pieces are views of the leaves, so
  autograd assembles each leaf's gradient (:func:`position_trees`); over
  more than one data coordinate each cuts its pieces from leaves of its
  own and the coordinates' gradients are averaged in f32 with the loss,
  as the world's all-reduce averages them. The decode path runs the same
  layers (:func:`lockstep_model`). Without rules, ring and ulysses run
  dense attention, as in the reference.
- a ``WorldMesh`` over the ranks of a ``torch.distributed`` world, one
  device a rank: data, sequence, tensor and expert parallelism (``dp``,
  ``slice`` × ``dp``, ``sp``, ``tp``, ``ep``), Megatron style, where GSPMD
  would insert the collectives in the reference. ``wq``/``wk``/``wv``/
  ``up`` are split by columns over ``tp`` (heads over ``tp``),
  ``wo``/``down`` by rows and followed by an all-reduce; the tied ``embed``
  is split on ``d_model`` — the lookup is all-gathered, the head's partial
  logits all-reduced; norms and the router are replicated; the expert stacks
  split ``E`` over ``ep`` and ``d_ff`` over ``tp`` (``models/moe.py`` routes
  as the unsharded model does). Each rank holds its shard of the parameters
  (:func:`shard_params`; :func:`gather_params` joins them) and its rows of
  the batch (:func:`shard_batch`, over ``("dp", "ep")`` on an ``ep`` mesh)
  with its piece of the sequence over ``sp`` (:func:`forward_and_aux` says
  how each attention layout and MoE meet it); the loss and each gradient are
  all-reduced and averaged in f32 over the ranks holding other tokens — over
  ``sp`` and the data axes its spec does not split: every data axis for the
  dense leaves, ``dp`` alone for the experts. A world of one runs the
  unsharded step's operations, bit for bit (``attn="ring"``/``"ulysses"``
  there run a ring of one member and Ulysses without an all-to-all, where
  the unsharded step runs dense attention, as the reference's does).
  ``rules`` reach every decode entry point and the serve engine
  (``models/decode.py``, ``models/serving.py``) on both kinds of mesh.

Not carried from the reference: the TPU's tile levers ``flash_pipeline`` /
``flash_block_q`` / ``flash_block_k`` (the CUDA kernels have one fixed
64x64 tiling).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import (
    MaskSpec,
    flash_attention,
    flash_attention_fwd,
    flash_backward,
    mask_live_frac,
)
from ..ops.ring_attention import (
    dense_reference_attention,
    ring_self_attention,
    shard_flash_attention,
)
from ..ops.ulysses_attention import ulysses_self_attention
from ..parallel.collectives import (
    enter_parallel,
    exit_parallel,
    gather_last,
    gather_seq,
    member_cat,
    member_sum,
    spec_axes,
)
from ..parallel.mesh import WorldMesh
from ..parallel.sharding import (
    Lockstep,
    ShapeDtypeStruct,
    gather_shards,
    local_shard,
)
from ..utils.layers import dense_init
from ..utils.layers import rmsnorm as _rmsnorm
from .moe import check_rules as check_moe_rules
from .moe import init_moe_params, lockstep_moe, moe_layer

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
    # n_experts > 0 swaps each block's dense FFN for the routed layer of
    # models/moe.py; its Switch load-balance loss joins the training loss
    n_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # experts per token: 1 = Switch (top-1), 2 = GShard top-2
    router_top_k: int = 1

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
        if self.router_top_k < 1 or (
                self.n_experts and self.router_top_k > self.n_experts):
            raise ValueError(
                f"router_top_k must be in [1, n_experts], got "
                f"{self.router_top_k} with {self.n_experts} experts")
        if self.router_top_k > 1 and self.n_experts == 0:
            raise ValueError(
                f"router_top_k = {self.router_top_k} needs n_experts > 0 "
                f"(a dense model has no router to take a top-k from)")
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
                device="cuda", rules=None) -> dict:
    """Seeded parameters in the reference's dict layout, drawn in f32 from
    ``generator`` (default: seed 0 on ``device``) and cast to
    ``cfg.dtype``; with ``rules``, on the mesh's first device, or on a
    world mesh this rank's shard of the same global draw
    (:func:`shard_params`). The draws differ from the reference's
    ``jax.random`` ones; parity tests load the reference's weights through
    :func:`..convert.params_from_numpy` instead."""
    dev = _device(device, rules, cfg)
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
        layer = {
            "attn_norm": ones(cfg.d_model),
            "wq": dense((cfg.d_model, cfg.d_model)),
            "wk": dense((cfg.d_model, kv_dim)),
            "wv": dense((cfg.d_model, kv_dim)),
            "wo": dense((cfg.d_model, cfg.d_model)),
            "mlp_norm": ones(cfg.d_model),
        }
        if cfg.n_experts > 0:
            layer["moe"] = init_moe_params(cfg, generator)
        else:
            layer["up"] = dense((cfg.d_model, cfg.d_ff))
            layer["down"] = dense((cfg.d_ff, cfg.d_model))
        params["layers"].append(layer)
    if _world(rules):
        params = shard_params(params, rules)
    return params


def param_shapes(cfg: BurnInConfig) -> dict:
    """The global ``(shape, dtype)`` of every leaf of :func:`init_params`,
    in its layout, with nothing allocated (the router is f32, as
    ``models/moe.py`` keeps it)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kv_dim = cfg.kv_heads * cfg.head_dim

    def w(*shape, dtype=cfg.dtype):
        return tuple(shape), dtype

    def layer():
        out = {"attn_norm": w(d), "wq": w(d, d), "wk": w(d, kv_dim),
               "wv": w(d, kv_dim), "wo": w(d, d), "mlp_norm": w(d)}
        if e > 0:
            out["moe"] = {"router": w(d, e, dtype=torch.float32),
                          "experts_up": w(e, d, f),
                          "experts_down": w(e, f, d)}
        else:
            out.update(up=w(d, f), down=w(f, d))
        return out

    return {"embed": w(cfg.vocab, d), "out_norm": w(d),
            "layers": [layer() for _ in range(cfg.n_layers)]}


def abstract_params(cfg: BurnInConfig, rules=None, *,
                    device="cuda") -> dict:
    """A :class:`..parallel.sharding.ShapeDtypeStruct` for every leaf of
    :func:`init_params` (with ``rules``, the same placement): the global
    shape and dtype, and on a world mesh this rank's piece under the
    leaf's spec. Nothing is allocated."""
    dev = _device(device, rules, cfg)
    mesh = rules.mesh if _world(rules) else None
    return _tree_map_path(
        lambda path, sd: ShapeDtypeStruct(
            sd[0], sd[1], dev,
            rules.param_sharding(path) if mesh is not None else (), mesh),
        param_shapes(cfg))


def _tree_map_path(fn: Callable, tree, path: tuple = ()):
    """:func:`_tree_map` with each leaf's path (its keys and list indices,
    as strings) passed first."""
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(params: dict, rules) -> dict:
    """The spec of every leaf, by its path (``ShardingRules.param_sharding``),
    in the params' dict layout."""
    return _tree_map_path(lambda path, _: rules.param_sharding(path), params)


def shard_params(params: dict, rules) -> dict:
    """This rank's shard of every leaf of the global ``params`` on a world
    mesh (``parallel.sharding.local_shard`` under its spec); a leaf that
    is not split is the caller's tensor itself."""
    return _tree_map_path(
        lambda path, x: local_shard(x, rules.param_sharding(path),
                                    rules.mesh), params)


def gather_params(params: dict, rules) -> dict:
    """The global ``params`` from every rank's shards (the inverse of
    :func:`shard_params`; every rank gets the whole tree)."""
    return _tree_map_path(
        lambda path, x: gather_shards(x, rules.param_sharding(path),
                                      rules.mesh), params)


def shard_batch(batch, rules):
    """This rank's piece of a global ``(tokens, targets)`` batch: the rows
    split over the data axes and the sequence over ``sp``
    (``rules.act("sp")``; an ``sp`` of 1 leaves the sequence whole)."""
    return tuple(local_shard(x, rules.act("sp"), rules.mesh) for x in batch)


def mlp(h: torch.Tensor, layer: dict, dtype: torch.dtype) -> torch.Tensor:
    """The block's MLP: ``gelu`` in f32 with the TANH approximation — the
    default of the reference's ``jax.nn.gelu`` — then back to ``dtype``."""
    u = F.gelu((h @ layer["up"]).float(), approximate="tanh").to(dtype)
    return u @ layer["down"]


@torch.inference_mode()
def forward(params: dict, tokens: torch.Tensor, cfg: BurnInConfig,
            rules=None) -> torch.Tensor:
    """Decoder-only forward → logits ``[batch, seq, vocab]`` (inference
    only): the oracle cached decoding is held against. It is
    :func:`forward_and_aux`'s logits (under ``rules``, of this rank's rows
    and positions, from its shards); with no gradient to keep, the flash
    path runs K1 alone."""
    return forward_and_aux(params, tokens, cfg, rules)[0]


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


def _world(rules) -> bool:
    return rules is not None and isinstance(rules.mesh, WorldMesh)


def _lockstep(rules) -> bool:
    """A one-process mesh: the lock-step form (:func:`_lockstep_forward`)."""
    return rules is not None and not isinstance(rules.mesh, WorldMesh)


def _check_rules(rules, cfg: BurnInConfig | None = None) -> None:
    """Refuse what the port cannot run: with ``cfg``, a ``tp``, an ``ep``,
    an ``sp`` or a batch that the config's dimensions do not divide (on a
    one-process mesh, ``sp`` only where the ring or Ulysses shards the
    sequence)."""
    if rules is None or cfg is None:
        return
    shape = rules.mesh.shape
    sp, tp, ep = shape.get("sp", 1), shape.get("tp", 1), shape.get("ep", 1)
    data = math.prod(shape.get(a, 1) for a in rules.data)
    if cfg.n_experts > 0:
        check_moe_rules(rules, cfg)
    if cfg.seq_len % sp and (_world(rules) or cfg.attn in ("ring",
                                                           "ulysses")):
        raise ValueError(
            f"seq_len {cfg.seq_len} does not split over sp = {sp}")
    if cfg.attn == "ulysses" and cfg.n_heads % (sp * tp):
        raise ValueError(
            f"Ulysses layout needs heads divisible by sp×tp: "
            f"{cfg.n_heads} heads vs sp={sp} × tp={tp}")
    if tp > 1 and (cfg.n_heads % tp or cfg.kv_heads % tp or cfg.d_ff % tp
                   or cfg.d_model % tp):
        raise ValueError(
            f"tp = {tp} must divide n_heads ({cfg.n_heads}), n_kv_heads "
            f"({cfg.kv_heads}), d_ff ({cfg.d_ff}), and d_model "
            f"({cfg.d_model})")
    if ep > 1 and cfg.n_experts % ep:
        raise ValueError(
            f"ep = {ep} must divide n_experts ({cfg.n_experts}): each "
            f"rank holds n_experts / ep experts")
    if cfg.batch % data:
        raise ValueError(
            f"batch {cfg.batch} does not split over the data axes "
            f"{rules.data} ({data} ways)")


def _device(device, rules, cfg: BurnInConfig | None = None) -> torch.device:
    """The entry point's device: with ``rules``, the mesh's first device
    (where parameters and batch live) or, on a world mesh, this rank's;
    otherwise ``device``."""
    _check_rules(rules, cfg)
    if _world(rules):
        device = rules.mesh.device
    elif rules is not None:
        device = rules.mesh.devices.flat[0]
    return check_device(device)


def _tp(rules, axis: str = "tp") -> tuple:
    """``(group, n, i)`` of this rank's line along ``axis`` on a world mesh
    (the group ``None`` where the axis is 1 or absent); ``(None, 1, 0)``
    elsewhere."""
    if not _world(rules) or axis not in rules.mesh.axis_names:
        return None, 1, 0
    mesh = rules.mesh
    return mesh.group(axis), mesh.axis_size(axis), mesh.index(axis)


def _seq_offset(rules, s_local: int) -> int:
    """The global position of this rank's first sequence row: its index
    along ``sp`` times the local length (0 off a world mesh)."""
    return _tp(rules, "sp")[2] * s_local


def forward_and_aux(params: dict, tokens: torch.Tensor, cfg: BurnInConfig,
                    rules=None):
    """Differentiable forward → ``(logits [B, S, vocab], aux)``; ``aux`` is
    the layers' summed Switch load-balance loss (``models/moe.py``, each
    layer routed at the factor capacity), 0.0 for the dense model.
    Attention runs through :class:`FlashAttention` (K1 forward; K5,
    or K3 + K4, backward) with ``attn="flash"``, through the ring or
    Ulysses over ``rules.mesh`` with ``attn="ring"``/``"ulysses"`` and
    rules, and through :func:`dense_reference_attention` otherwise; GQA
    repeats K/V to the query heads first, as the reference does, so
    autograd sums dK/dV over each group. ``cfg.remat`` recomputes each
    block in the backward. On a world mesh each rank runs its heads and
    FFN columns (module docstring) on its batch rows and its piece of the
    sequence, and returns the logits of those rows and positions: RoPE
    takes the global positions; the ring passes K/V blocks along ``sp``
    and Ulysses swaps sequence for heads; ``"flash"`` and ``"dense"``
    gather the normed input over ``sp`` (the reference's ``act(h, None,
    None)``) and attend with this rank's queries at their global offsets
    (flash: K2 on the blocks up to this rank's own, no later one, and
    under ``flash_window`` only those the window reaches, each masked at
    its key offset) — and MoE routes the gathered sequence (a token's slot
    depends on every earlier token) and keeps this rank's rows of the
    combine. On a one-process mesh: :func:`_lockstep_forward`, the global
    logits joined on ``tokens``' device."""
    _check_rules(rules, cfg)
    if _lockstep(rules):
        ls = Lockstep(rules)
        logits, aux = _lockstep_forward(position_trees(params, rules, ls),
                                        tokens, cfg, ls)
        return member_cat(logits, 0, tokens.device), aux.to(tokens.device)
    world = _world(rules)
    sharded = None if not world or cfg.attn not in ("ring", "ulysses") \
        else {"ring": ring_self_attention,
              "ulysses": ulysses_self_attention}[cfg.attn]
    group, n_tp, i_tp = _tp(rules)
    sp_group, n_sp, i_sp = _tp(rules, "sp")
    b, s = tokens.shape
    off = _seq_offset(rules, s)
    s_all = s * n_sp
    scale = 1.0 / (cfg.head_dim ** 0.5)
    rep = cfg.n_heads // cfg.kv_heads
    heads, kv_heads = cfg.n_heads // n_tp, cfg.kv_heads // n_tp
    mask = (MaskSpec("window", cfg.flash_window)
            if cfg.flash_window is not None else None)
    pos = torch.arange(s, device=tokens.device) + off
    pos_all = torch.arange(s_all, device=tokens.device)

    def project(layer, hq, hkv, q_pos, k_pos):
        q = (hq @ layer["wq"]).view(b, hq.shape[1], heads, cfg.head_dim)
        k = (hkv @ layer["wk"]).view(b, hkv.shape[1], kv_heads,
                                      cfg.head_dim)
        v = (hkv @ layer["wv"]).view(b, hkv.shape[1], kv_heads,
                                      cfg.head_dim)
        if cfg.rope:
            q = apply_rope(q, q_pos, cfg.rope_theta)
            k = apply_rope(k, k_pos, cfg.rope_theta)
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return q, k, v

    def attend(layer, h):
        if sharded is not None:
            q, k, v = project(layer, h, h, pos, pos)
            return sharded(q, k, v, rules.mesh, causal=True, scale=scale,
                           spec=rules.act("sp", "tp", None),
                           backward=cfg.flash_backward)
        if sp_group is not None:          # the whole sequence's K/V
            q, k, v = project(layer, h, gather_seq(h, sp_group, n_sp), pos,
                              pos_all)
            if cfg.attn == "dense":
                return dense_reference_attention(
                    q, k, v, causal=True, scale=scale,
                    window=cfg.flash_window, q_offset=off)
            return shard_flash_attention(q, k, v, i_sp, scale=scale,
                                         backward=cfg.flash_backward,
                                         window=cfg.flash_window)
        q, k, v = project(layer, h, h, pos, pos)
        if cfg.attn == "flash":
            return flash_attention(q, k, v, causal=True, scale=scale,
                                   mask=mask, backward=cfg.flash_backward)
        return dense_reference_attention(q, k, v, causal=True, scale=scale,
                                         window=cfg.flash_window)

    def block(x, layer):
        attn = attend(layer, enter_parallel(_rmsnorm(x, layer["attn_norm"]),
                                            group))
        x = x + exit_parallel(
            attn.reshape(b, s, heads * cfg.head_dim) @ layer["wo"], group)
        h = _rmsnorm(x, layer["mlp_norm"])
        if cfg.n_experts > 0:
            out, layer_aux = moe_layer(gather_seq(h, sp_group, n_sp),
                                       layer["moe"], cfg, rules)
            if sp_group is not None:      # this rank's rows of the combine
                out = out.narrow(1, off, s)
            return x + out, layer_aux
        return x + exit_parallel(
            mlp(enter_parallel(h, group), layer, cfg.dtype), group), None

    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x = gather_last(params["embed"][tokens], group, n_tp, i_tp)
    for layer in params["layers"]:
        if cfg.remat:
            x, layer_aux = checkpoint(block, x, layer, use_reentrant=False)
        else:
            x, layer_aux = block(x, layer)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = _rmsnorm(x, params["out_norm"])
    if group is not None:        # this rank's d_model columns of the head
        x = enter_parallel(x, group).chunk(n_tp, dim=-1)[i_tp]
    logits = exit_parallel(x @ params["embed"].T, group)   # weight-tied
    return logits, aux


# ---------------------------------------------- the one-process lock step

def member_kv_heads(cfg: BurnInConfig, tp: int) -> int:
    """The KV heads a ``tp`` member holds: ``kv_heads / tp`` where ``tp``
    divides them, else all of them (the decode path then keeps ``wk`` and
    ``wv`` whole, :func:`position_trees`' ``whole_kv``)."""
    return cfg.kv_heads // tp if cfg.kv_heads % tp == 0 else cfg.kv_heads


def _cut_piece(x, spec: tuple, ls: Lockstep, c: int, j: int,
               contiguous: bool, memo: dict):
    """Position ``(c, j)``'s piece of one leaf on its device
    (:func:`position_trees`); an int8 ``QTensor``'s values are cut by
    ``spec`` and its scales by the spec's entry on its scale axis."""
    if not isinstance(x, torch.Tensor):
        entry = (tuple(spec) + (None, None))[x.scale_axis]
        return type(x)(_cut_piece(x.q, spec, ls, c, j, contiguous, memo),
                       _cut_piece(x.scale, (entry,), ls, c, j, contiguous,
                                  memo),
                       scale_axis=x.scale_axis, dtype=x.dtype,
                       transposed=x.transposed)
    dev = ls.device(c, j)
    if not contiguous:
        return ls.piece(x, spec, c, j).to(dev)
    idx = ls.slices(tuple(x.shape), spec, c, j)
    key = (id(x), tuple((s.start, s.stop) for s in idx), dev)
    if key not in memo:     # positions on one device share a piece
        memo[key] = ls.piece(x, spec, c, j).contiguous().to(dev)
    return memo[key]


def position_trees(params: dict, rules, ls: Lockstep, *, coords=None,
                   contiguous: bool = False,
                   whole_kv: bool = False) -> dict:
    """``{(c, j): tree}``: the pieces of the global ``params`` that each
    position of the data coordinates ``coords`` (default all) runs on, on
    its device (``Lockstep.piece`` under each leaf's spec, the cut
    :func:`shard_params` makes for the rank at the same coordinates). The
    pieces are views of ``params`` where they share its device, so
    autograd reaches ``params`` through them; with ``contiguous`` (the
    decode path's kernels) each is laid out alone, once a device. With
    ``whole_kv`` ``wk`` and ``wv`` stay whole (the decode path where
    ``tp`` does not divide ``kv_heads``)."""
    memo: dict = {}
    out = {}
    for c in range(ls.n_data) if coords is None else coords:
        for j in range(ls.tp):
            def cut(path, x, c=c, j=j):
                spec = (() if whole_kv and path[-1] in ("wk", "wv")
                        else rules.param_sharding(path))
                return _cut_piece(x, spec, ls, c, j, contiguous, memo)

            out[c, j] = _tree_map_path(cut, params)
    return out


def lockstep_model(trees: dict, toks: list, cfg: BurnInConfig,
                   ls: Lockstep, attend: Callable, pos: list, *,
                   moe: Callable | None = None, remat: bool = False):
    """The transformer over a one-process mesh's positions, in lock step —
    the one body that the lock-step train step and decode path share →
    ``(logits, aux)``: each data coordinate's logits on its home, in
    coordinate order, and the layers' summed MoE load-balance loss on
    coordinate 0's home.

    ``toks[c]`` are data coordinate ``c``'s token rows on its home
    (``ls.home(c)``: its ``tp`` member 0's device, where its residual
    stream and norms live), ``pos[c]`` their RoPE positions, ``trees[c,
    j]`` position ``(c, j)``'s pieces (:func:`position_trees`). Member
    ``j`` looks the tokens up in its ``d_model`` columns of ``embed``
    (joined in member order), runs its heads' projections, RoPE and
    ``attend(li, q, k, v, c, j) → [b, t, heads, head_dim]`` and its rows
    of ``wo``, and its FFN columns, on its device; the row-parallel
    partial products and the tied head's partial logits are summed in
    member order on the home. MoE: ``moe(hs, pieces) → (outs, aux)`` over
    every coordinate's normed rows and every position's ``moe`` leaves
    (default :func:`..moe.lockstep_moe`). ``remat`` recomputes each layer
    in the backward."""
    n_tp, hd = ls.tp, cfg.head_dim
    heads, kv = cfg.n_heads // n_tp, member_kv_heads(cfg, n_tp)
    coords = range(len(toks))
    if moe is None:
        def moe(hs, pieces):
            return lockstep_moe(hs, pieces, cfg, ls)

    def member_attention(li, p, h, c, j):
        dev = ls.device(c, j)
        h = h.to(dev)
        b, t = h.shape[:2]
        q = (h @ p["wq"]).view(b, t, heads, hd)
        k = (h @ p["wk"]).view(b, t, kv, hd)
        v = (h @ p["wv"]).view(b, t, kv, hd)
        if cfg.rope:
            at = pos[c].to(dev)
            q = apply_rope(q, at, cfg.rope_theta)
            k = apply_rope(k, at, cfg.rope_theta)
        return attend(li, q, k, v, c, j).reshape(b, t, heads * hd) @ p["wo"]

    def block(li, xs, layer):
        hs = [_rmsnorm(x, layer[c, 0]["attn_norm"]) for c, x in zip(coords,
                                                                    xs)]
        xs = [x + member_sum([member_attention(li, layer[c, j], h, c, j)
                              for j in range(n_tp)], x.device)
              for c, x, h in zip(coords, xs, hs)]
        hs = [_rmsnorm(x, layer[c, 0]["mlp_norm"]) for c, x in zip(coords,
                                                                   xs)]
        if cfg.n_experts > 0:
            ffn, aux = moe(hs, {key: p["moe"] for key, p in layer.items()})
        else:
            ffn, aux = [member_sum(
                [mlp(h.to(ls.device(c, j)), layer[c, j], cfg.dtype)
                 for j in range(n_tp)], h.device)
                for c, h in zip(coords, hs)], None
        return [x + f for x, f in zip(xs, ffn)], aux

    aux = torch.zeros((), dtype=torch.float32, device=ls.home(0))
    xs = [member_cat([trees[c, j]["embed"][x.to(ls.device(c, j))]
                      for j in range(n_tp)], -1, ls.home(c))
          for c, x in zip(coords, toks)]
    for li in range(cfg.n_layers):
        layer = {key: tree["layers"][li] for key, tree in trees.items()}
        if remat:
            xs, layer_aux = checkpoint(block, li, xs, layer,
                                       use_reentrant=False)
        else:
            xs, layer_aux = block(li, xs, layer)
        if layer_aux is not None:
            aux = aux + layer_aux.to(aux.device)
    logits = []
    for c, x in zip(coords, xs):
        h = _rmsnorm(x, trees[c, 0]["out_norm"]).chunk(n_tp, dim=-1)
        # a member's columns laid out alone: an int8 head (K8) takes only
        # a contiguous, aligned operand
        logits.append(member_sum(
            [h[j].to(ls.device(c, j)).contiguous() @ trees[c, j]["embed"].T
             for j in range(n_tp)], x.device))
    return logits, aux


def _lockstep_forward(trees: dict, tokens: torch.Tensor, cfg: BurnInConfig,
                      ls: Lockstep):
    """The train forward over a one-process mesh's positions
    (:func:`lockstep_model`): data coordinate ``c`` takes its rows of
    ``tokens``; each member attends with its heads through the ring or
    Ulysses over the ``sp`` devices of its line (``coords``), or flash
    (K1; K5 or K3 + K4 backward) or dense on its whole sequence."""
    rep = cfg.n_heads // cfg.kv_heads
    scale = 1.0 / (cfg.head_dim ** 0.5)
    mask = (MaskSpec("window", cfg.flash_window)
            if cfg.flash_window is not None else None)
    sharded = {"ring": ring_self_attention,
               "ulysses": ulysses_self_attention}.get(cfg.attn)
    toks = [ls.rows(tokens, c).to(ls.home(c)) for c in range(ls.n_data)]
    pos = [torch.arange(tokens.shape[1], device=ls.home(c))
           for c in range(ls.n_data)]

    def attend(li, q, k, v, c, j):
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if sharded is not None:
            return sharded(q, k, v, ls.mesh, causal=True, scale=scale,
                           spec=(None, "sp", None, None),
                           coords=ls.coords(c, j),
                           backward=cfg.flash_backward)
        if cfg.attn == "flash":
            return flash_attention(q, k, v, causal=True, scale=scale,
                                   mask=mask, backward=cfg.flash_backward)
        return dense_reference_attention(q, k, v, causal=True, scale=scale,
                                         window=cfg.flash_window)

    return lockstep_model(trees, toks, cfg, ls, attend, pos,
                          remat=cfg.remat)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, the logits in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).squeeze(-1).mean()


def _lockstep_losses(trees: dict, batch, cfg: BurnInConfig,
                     ls: Lockstep) -> list:
    """Each data coordinate's loss (f32, on its home): the mean over its
    tokens plus ``cfg.aux_loss_weight`` times the layers' aux loss of all
    the tokens — the loss a world rank at that coordinate reports."""
    tokens, targets = batch
    logits, aux = _lockstep_forward(trees, tokens, cfg, ls)
    return [_nll(lg, ls.rows(targets, c).to(lg.device))
            + cfg.aux_loss_weight * aux.to(lg.device)
            for c, lg in enumerate(logits)]


def _lockstep_value_and_grad(cfg: BurnInConfig, rules) -> Callable:
    """``(params, batch) → (loss, grads)`` over a one-process mesh. With
    one data coordinate this is :func:`_value_and_grad`: the positions'
    pieces are views of one set of leaves, and autograd assembles each
    leaf's gradient in the params' dtype. With more, each coordinate cuts
    its pieces from a set of leaves of its own, so autograd gives each
    coordinate's gradient as a world rank's backward does, and those are
    averaged in f32, the loss too, as the world's all-reduce averages
    them."""
    ls = Lockstep(rules)
    if ls.n_data == 1:
        return _value_and_grad(cfg, rules)

    def vg(params, batch):
        with torch.enable_grad():
            lives = [_tree_map(lambda p: p.detach().requires_grad_(True),
                               params) for _ in range(ls.n_data)]
            trees = {}
            for c, live in enumerate(lives):
                trees.update(position_trees(live, rules, ls, coords=[c]))
            losses = _lockstep_losses(trees, batch, cfg, ls)
            flat = [x for live in lives for x in tree_leaves(live)]
            got = torch.autograd.grad(
                member_sum([x.float() for x in losses], ls.home(0)), flat,
                allow_unused=True)
        n, inv = len(flat) // ls.n_data, 1.0 / ls.n_data
        out = []
        for li, p in enumerate(tree_leaves(params)):
            parts = [g.float() for g in got[li::n] if g is not None]
            out.append(member_sum(parts, p.device) * inv if parts else
                       torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device))
        loss = member_sum([x.detach().float() for x in losses],
                          ls.home(0))
        return loss * inv, _tree_unflatten(params, out)

    return vg


def train_step_flops(cfg: BurnInConfig) -> float:
    """Model FLOPs for ONE train step (fwd + bwd), for MFU accounting — the
    reference's count: projections (K/V at the GQA width), the attention
    contractions at the mask's live fraction, the MLP and the tied head;
    backward = 2× forward. A top-k MoE token passes through k experts, so
    the FFN term scales by k (the routing einsums are not billed)."""
    b, s, d, dff, v = (cfg.batch, cfg.seq_len, cfg.d_model, cfg.d_ff,
                       cfg.vocab)
    kv_frac = cfg.kv_heads / cfg.n_heads
    live = mask_live_frac(
        MaskSpec("window", cfg.flash_window)
        if cfg.flash_window is not None else MaskSpec("causal"), s)
    per_layer = ((4.0 + 4.0 * kv_frac) * b * s * d * d
                 + 4.0 * live * b * s * s * d
                 + 4.0 * b * s * d * dff * (
                     cfg.router_top_k if cfg.n_experts else 1))
    fwd = cfg.n_layers * per_layer + 2.0 * b * s * d * v
    return 3.0 * fwd


def loss_fn(params: dict, batch, cfg: BurnInConfig,
            rules=None) -> torch.Tensor:
    """Mean next-token cross-entropy, the logits in f32, plus
    ``cfg.aux_loss_weight`` times the MoE load-balance loss."""
    if _lockstep(rules):
        _check_rules(rules, cfg)
        ls = Lockstep(rules)
        losses = _lockstep_losses(position_trees(params, rules, ls), batch,
                                  cfg, ls)
        home = batch[0].device
        return member_sum([x.float() for x in losses], home) / ls.n_data
    tokens, targets = batch
    logits, aux = forward_and_aux(params, tokens, cfg, rules)
    return _nll(logits, targets) + cfg.aux_loss_weight * aux


def synthetic_batch(generator: torch.Generator, cfg: BurnInConfig,
                    device="cuda", rules=None):
    """Deterministic synthetic LM batch ``(tokens, targets)``, each
    ``[batch, seq_len]`` int64: the next token of a random stream drawn
    from ``generator`` (on ``device``; with ``rules``, on the mesh's first
    device, or on a world mesh this rank's rows of the same global draw,
    :func:`shard_batch`). Its numbers differ from the reference's
    ``jax.random`` ones."""
    dev = _device(device, rules, cfg)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, batch on {dev}")
    stream = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len + 1),
                           generator=generator, device=dev)
    batch = stream[:, :-1], stream[:, 1:]
    return shard_batch(batch, rules) if _world(rules) else batch


def _value_and_grad(cfg: BurnInConfig, rules=None) -> Callable:
    """``(params, batch) → (loss, grads)``: the loss (detached) and its
    gradient for every leaf, in the params' dict layout and dtype."""

    def vg(params, batch):
        with torch.enable_grad():
            live = _tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
            loss = loss_fn(live, batch, cfg, rules)
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
    microbatch accumulation. On a world mesh with more than one data or
    ``sp`` rank the loss and the gradients are then all-reduced and
    averaged in f32 over the ranks that hold other tokens (each rank's loss
    is the mean over its own): each leaf over the data axes its spec does
    not split and over ``sp`` (every data axis for the dense leaves; ``dp``
    alone for the expert stacks, already split over ``ep``), one flat
    buffer a set of axes; they come back f32."""
    _check_rules(rules, cfg)
    vg = (_lockstep_value_and_grad(cfg, rules) if _lockstep(rules)
          else _value_and_grad(cfg, rules))
    fn = vg if accum_steps == 1 else grad_accum(vg, accum_steps)
    if not _world(rules):
        return fn
    mesh = rules.mesh
    tokens = tuple(rules.data) + tuple(
        a for a in ("sp",) if a in mesh.axis_names)
    if mesh.group(tokens) is None:
        return fn
    inv = 1.0 / mesh.axis_size(tokens)

    def axes_of(path, _):
        used = {a for entry in rules.param_sharding(path)
                for a in spec_axes(entry)}
        return tuple(a for a in tokens if a not in used)

    def data_mean(params, batch):
        loss, grads = fn(params, batch)
        leaves = tree_leaves(grads)
        axes = tree_leaves(_tree_map_path(axes_of, grads))
        out = [None] * len(leaves)
        # the loss rides with the leaves reduced over every such axis
        for key in dict.fromkeys([tokens] + axes):
            idx = [j for j, a in enumerate(axes) if a == key]
            flat = torch.cat([leaves[j].float().reshape(-1) for j in idx]
                             + ([loss.float().reshape(1)]
                                if key == tokens else []))
            group = mesh.group(key) if key else None
            if group is not None:
                dist.all_reduce(flat, group=group)
            flat = flat * inv
            if key == tokens:
                loss, flat = flat[-1], flat[:-1]
            for j, part in zip(idx, flat.split(
                    [leaves[j].numel() for j in idx])):
                out[j] = part.view(leaves[j].shape)
        return loss, _tree_unflatten(grads, out)

    return data_mean


def make_train_step(cfg: BurnInConfig, rules=None, lr: float = 1e-3,
                    accum_steps: int = 1, *, device="cuda") -> Callable:
    """SGD train step ``step(params, batch) → (params, loss)`` on
    ``device`` (with ``rules``: the mesh's first device, the attention
    sharded over its ``sp`` axis; on a world mesh, this rank's card, with
    this rank's parameter shards and batch rows, the loss the world's
    mean): ``p − lr·g.to(p.dtype)`` for every leaf, into new tensors.
    ``accum_steps > 1`` runs the batch as that many microbatches through
    :func:`grad_accum`; it composes with ``cfg.remat``."""
    dev = _device(device, rules, cfg)
    grads_of = make_grads_fn(cfg, rules, accum_steps)

    def step(params, batch):
        _check_params(params, dev)
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            params = _tree_map(lambda p, g: p - lr * g.to(p.dtype), params,
                               grads)
        return params, loss

    return step


def _flash_kernel_probe(cfg: BurnInConfig, reg, dev: torch.device) -> None:
    """One-shot per-kernel flash timing probe for the telemetry plane.

    Times one per-layer flash forward (K1 on the card) and one backward
    (K5, or K3 + K4 under ``flash_backward="split"``) at the config's
    attention shape with the two-point chain of ``utils/timing.delta_time``
    (chains of 1 and 3 dependent calls: the fixed cost of a call cancels),
    then records the ``flash_fwd_ms``/``flash_bwd_ms`` histograms and the
    ``flash_fwd_mxu_frac``/``flash_bwd_mxu_frac`` gauges — achieved matmul
    FLOP/s over the card's dense bf16 peak, billing only mask-live tiles
    (2 tile products forward; backward 5 fused — score remat, dP and the
    three gradient products — or 7 split). The names are the reference's,
    so dashboards read the same; on this card the share is of the
    tensor-core peak, not the TPU's MXU."""
    from ..utils.device import device_kind, device_spec
    from ..utils.timing import delta_time

    b, s, h, dh = cfg.batch, cfg.seq_len, cfg.n_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v, do = (torch.randn((b, s, h, dh), generator=g,
                               device=dev).to(cfg.dtype) for _ in range(4))
    spec = (MaskSpec("window", cfg.flash_window)
            if cfg.flash_window is not None else MaskSpec("causal"))
    scale = 1.0 / (dh ** 0.5)

    def fwd_chain(length):
        def chain(q, k, v):
            acc = q
            for _ in range(length):
                acc = flash_attention_fwd(acc, k, v, scale=scale,
                                          mask=spec)[0]
            return acc
        return chain

    def bwd_chain(length):
        def chain(q, k, v, do):
            o, lse = flash_attention_fwd(q, k, v, scale=scale, mask=spec)
            carry = do
            for _ in range(length):
                carry = flash_backward(q, k, v, o, carry, lse, scale=scale,
                                       mask=spec,
                                       backward=cfg.flash_backward)[0]
            return carry
        return chain

    with torch.no_grad():
        t_fwd = delta_time(fwd_chain, q, k, v, iters_lo=1, iters_hi=3,
                           samples=1)
        t_bwd = delta_time(bwd_chain, q, k, v, do, iters_lo=1, iters_hi=3,
                           samples=1)
    peak = device_spec(device_kind(dev)).bf16_tflops * 1e12
    flops_fwd = 4.0 * mask_live_frac(spec, s) * b * h * s * s * dh
    bwd_dots = 2.5 if cfg.flash_backward == "fused" else 3.5  # x fwd's 2
    reg.histogram("flash_fwd_ms").record(t_fwd * 1e3)
    reg.histogram("flash_bwd_ms").record(t_bwd * 1e3)
    reg.gauge("flash_fwd_mxu_frac").set(
        flops_fwd / max(t_fwd, 1e-12) / peak)
    reg.gauge("flash_bwd_mxu_frac").set(
        bwd_dots * flops_fwd / max(t_bwd, 1e-12) / peak)


def instrument_step(step: Callable, cfg: BurnInConfig, telemetry=None, *,
                    rules=None, sync: bool = True,
                    kernel_probe: bool | None = None,
                    device="cuda") -> Callable:
    """Wrap a train step with per-step telemetry.

    Records a ``train_step_ms`` latency histogram (exact p50/p90/p99 in the
    Prometheus dump), the ``train_steps`` counter, live
    ``train_tokens_per_s`` and ``train_mfu`` gauges (``train_step_flops``
    over the step time over the dense bf16 peak of ``utils/device``), and
    one ``train_step`` span per call into the telemetry plane
    (``telemetry/``). ``sync=True`` (default) synchronises the card after
    each step so the clock covers device execution, not just the launches;
    pass ``sync=False`` for callers that pipeline steps and synchronise
    themselves.

    ``kernel_probe`` adds the one-shot flash probe
    (:func:`_flash_kernel_probe`) before the first instrumented step —
    ``None`` (default) probes exactly when ``cfg.attn == "flash"``,
    ``False`` never, ``True`` demands it (ValueError on other configs). It
    runs on ``device`` (with ``rules``, the mesh's first device), the card
    unless the caller asks for the CPU.

    Pass the step's ``rules`` when it runs over a mesh: MFU is over the
    aggregate peak of the distinct devices doing the work (a mesh that
    names one card several times has one card's peak).

    With telemetry disabled (the default — no ``TPU_TELEMETRY_DIR``, no
    injected registry) the ORIGINAL ``step`` is returned unchanged."""
    from ..telemetry import get_registry

    if kernel_probe and cfg.attn != "flash":
        raise ValueError(
            f"kernel_probe=True needs attn='flash', got {cfg.attn!r} — "
            f"the probe times the flash kernels the step runs")
    reg = telemetry if telemetry is not None else get_registry()
    if not reg.enabled:
        return step
    from ..utils.device import device_kind, device_spec
    from ..utils.timing import sync as _sync

    dev = _device(device, rules)
    probe = cfg.attn == "flash" if kernel_probe is None else kernel_probe
    probe_state = {"done": False}
    hist = reg.histogram("train_step_ms")
    steps_c = reg.counter("train_steps")
    toks_g = reg.gauge("train_tokens_per_s")
    mfu_g = reg.gauge("train_mfu")
    flops = train_step_flops(cfg)
    tokens = cfg.batch * cfg.seq_len
    n_dev = (1 if rules is None else rules.mesh.size if _world(rules)
             else len({str(d) for d in rules.mesh.devices.flat}))
    peak = device_spec(device_kind(dev)).bf16_tflops * 1e12 * n_dev

    def instrumented(*args):
        if probe and not probe_state["done"]:
            # before t0: the probe's launches stay out of the first
            # step's sample
            probe_state["done"] = True
            _flash_kernel_probe(cfg, reg, dev)
        t0 = reg.clock()
        out = step(*args)
        if sync:
            _sync(out)
        t1 = reg.clock()
        dt = max(t1 - t0, 1e-9)
        hist.record(dt * 1e3)
        steps_c.inc()
        toks_g.set(tokens / dt)
        mfu_g.set(flops / dt / peak)
        reg.emit_span("train_step", t0, t1, step_ms=round(dt * 1e3, 3))
        return out

    return instrumented
