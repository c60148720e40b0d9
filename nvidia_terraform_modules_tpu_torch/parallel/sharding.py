# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Named sharding rules for the burn-in workload — the port of the
reference's ``parallel/sharding.py``.

Logical tensor dimensions map onto mesh axes once, here. A spec is a plain
tuple (the port has no ``PartitionSpec``): one entry per dimension, each
``None`` (not split), an axis name, or a tuple of axis names. The ring and
Ulysses attention wrappers read the activation specs to cut ``[B, S, H,
D]`` tensors into per-device shards; the data- and tensor-parallel train
step (``models/burnin.py``) reads the parameter specs, by each leaf's
path (:meth:`ShardingRules.param_sharding`), and :func:`local_shard` cuts
a global tensor into this rank's piece of a :class:`WorldMesh`.
:class:`ShapeDtypeStruct` describes a leaf without holding it: its global
shape and dtype, and where this rank's piece lives (the checkpoint
engine's placement contract).
"""

from __future__ import annotations

import dataclasses

import torch

from .collectives import gather_dim, spec_axes
from .mesh import Mesh, WorldMesh


def pspec_axes(axes):
    """A 1-tuple of axis names becomes the bare name (the reference's
    ``utils/compat.pspec_axes``)."""
    if isinstance(axes, (tuple, list)) and len(axes) == 1:
        return axes[0]
    return axes


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The mesh, and the specs of each logical tensor role of the burn-in
    model: Megatron's column-parallel (``attn_qkv``, ``mlp_up``: heads and
    FFN columns over ``tp``) and row-parallel (``attn_out``, ``mlp_down``)
    projections, the tied ``embed`` split on ``d_model``, norms
    replicated."""

    mesh: Mesh | WorldMesh
    # mesh axes carrying the batch dimension: ("dp",), ("slice", "dp"),
    # or ("dp", "ep")
    data: tuple[str, ...] = ("dp",)
    embed: tuple = (None, "tp")            # [vocab, d_model]
    attn_qkv: tuple = (None, "tp")         # [d_model, heads*head_dim]
    attn_out: tuple = ("tp", None)         # [heads*head_dim, d_model]
    mlp_up: tuple = (None, "tp")           # [d_model, d_ff]
    mlp_down: tuple = ("tp", None)         # [d_ff, d_model]
    moe_up: tuple = ("ep", None, "tp")     # [E, d_model, d_ff]
    moe_down: tuple = ("ep", "tp", None)   # [E, d_ff, d_model]
    replicated: tuple = ()

    @property
    def batch(self) -> tuple:              # [batch, ...]
        return (pspec_axes(self.data),)

    def act(self, *rest) -> tuple:
        """Activation spec: batch over the data axes, then ``rest`` dims."""
        return (pspec_axes(self.data), *rest)

    def param_sharding(self, path: tuple[str, ...]) -> tuple:
        """The spec of a parameter by its path in the params tree (leaf
        names), the reference's matching rules in its order."""
        name = "/".join(str(p) for p in path)
        # expert tensors first: "experts_up" would otherwise match "up"
        if "experts_up" in name:
            return self.moe_up
        if "experts_down" in name:
            return self.moe_down
        if "router" in name:
            return self.replicated
        if "embed" in name:
            return self.embed
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("wq", "wk", "wv"):
            return self.attn_qkv
        if leaf == "wo":
            return self.attn_out
        if "up" in name or "gate" in name:
            return self.mlp_up
        if "down" in name:
            return self.mlp_down
        return self.replicated


def make_rules(mesh: Mesh | WorldMesh) -> ShardingRules:
    data: tuple[str, ...] = (
        ("slice",) if "slice" in mesh.axis_names else ())
    data += ("dp",)
    if "ep" in mesh.axis_names:
        return ShardingRules(mesh=mesh, data=data + ("ep",))
    # no expert axis: MoE tensors replicate their expert dim
    return ShardingRules(mesh=mesh, data=data,
                         moe_up=(None, None, "tp"),
                         moe_down=(None, "tp", None))


def _pieces(spec: tuple, mesh: WorldMesh, ndim: int) -> list[tuple]:
    """(axes, pieces, this rank's piece) of each dimension under
    ``spec``."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = []
    for entry in tuple(spec) + (None,) * (ndim - len(spec)):
        axes = tuple(a for a in spec_axes(entry) if a in mesh.axis_names)
        out.append((axes, mesh.axis_size(axes), mesh.index(axes)))
    return out


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """A leaf's global ``shape`` and ``dtype``, and where this rank holds
    it: on ``device``, its piece under ``spec`` over a :class:`WorldMesh`
    (the bounds :func:`local_shard` cuts), or the whole leaf when ``mesh``
    is ``None``. The counterpart of ``jax.ShapeDtypeStruct(...,
    sharding=)``; it allocates nothing."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    spec: tuple = ()
    mesh: WorldMesh | None = None

    def bounds(self) -> list[list[int]]:
        """This rank's ``[start, stop]`` in each dimension of the leaf."""
        if self.mesh is None:
            return [[0, d] for d in self.shape]
        out = []
        for d, (_, n, i) in zip(self.shape, _pieces(self.spec, self.mesh,
                                                     len(self.shape))):
            if d % n:
                raise ValueError(f"dimension {d} of {self.shape} does not "
                                 f"split {n} ways")
            out.append([i * d // n, (i + 1) * d // n])
        return out


def local_shard(x: torch.Tensor, spec: tuple,
                mesh: WorldMesh) -> torch.Tensor:
    """This rank's piece of the global tensor ``x`` under ``spec`` (each
    split dimension cut into equal, contiguous pieces in the line order of
    its axes), as a contiguous tensor. A spec over axes of size 1 returns
    ``x`` itself."""
    pieces = _pieces(spec, mesh, x.dim())
    if all(n == 1 for _, n, _ in pieces):
        return x
    for dim, (_, n, i) in enumerate(pieces):
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} ({x.shape[dim]}) of "
                             f"{tuple(x.shape)} does not split {n} ways")
        x = x.chunk(n, dim=dim)[i] if n > 1 else x
    return x.contiguous()


def gather_shards(x: torch.Tensor, spec: tuple,
                  mesh: WorldMesh) -> torch.Tensor:
    """The global tensor from every rank's :func:`local_shard` of it:
    each split dimension all-gathered over its axes."""
    for dim, (axes, n, _) in enumerate(_pieces(spec, mesh, x.dim())):
        if n > 1:
            x = gather_dim(x, mesh.group(axes), n, dim)
    return x
