# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Host-side input pipeline: streaming batches with device prefetch — the
port of the reference's ``utils/data.py``.

The burn-in workloads train on one fixed synthetic batch (right for a
validation Job: deterministic, zero I/O). Real training streams, and the
input pipeline's one job is to keep the host→device copy OFF the step's
critical path:

- **host-side generation** in numpy: an infinite deterministic token
  stream per seed, the reference's draw number for number;
- **placement the step expects**: each batch lands where the train step
  takes it — on the card, or with ``rules`` this rank's rows of a world
  mesh (the cut ``models.shard_batch`` makes) or the whole batch on a
  one-process mesh's home device (the lock-step form takes its rows per
  data coordinate) — the contract ``synthetic_batch`` satisfies;
- **prefetch depth N**: a sliding window of batches already in flight.
  On the card each leaf is staged in pinned host memory and copied with
  ``non_blocking=True`` on a copy stream of its own, so batch ``i+1``'s
  copy runs while the step computes on batch ``i``; a batch is handed
  over by an event the consumer's current stream waits on, and each of
  its tensors is marked used on that stream (``record_stream``), so the
  caching allocator never recycles a buffer the step still reads. No
  threads and no queues: the reference's overlap comes from the
  asynchronous ``device_put``, this one from the asynchronous copy.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterator

import numpy as np
import torch

_BIASES = ("zipf", "uniform")


def token_stream(cfg, seed: int = 0,
                 bias: str = "zipf") -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Infinite deterministic LM batches ``(tokens, targets)`` on the host,
    each ``[batch, seq_len]`` int64 (the dtype the port's train step
    takes); their values are the reference's int32 values, from the same
    ``np.random.default_rng(seed)`` draw.

    Each batch is the next-token view of a fresh random stream — the
    streaming generalisation of ``models.synthetic_batch`` (one fixed
    batch), reproducible per ``seed``.

    ``bias="zipf"`` (default) draws tokens from a Zipf-shaped marginal
    (p ∝ 1/rank): unlike a uniform stream — whose optimal loss is exactly
    ``ln(vocab)``, leaving a fresh-data-each-step run nothing to learn —
    a biased marginal gives streaming training a learnable signal, so
    loss curves on the stream mean something. ``bias="uniform"`` matches
    ``synthetic_batch``'s distribution.
    """
    rng = np.random.default_rng(seed)
    if bias not in _BIASES:
        raise ValueError(f"unknown bias {bias!r}; use zipf|uniform")
    p = None
    if bias == "zipf":
        p = 1.0 / np.arange(1, cfg.vocab + 1)
        p /= p.sum()
    while True:
        stream = rng.choice(
            cfg.vocab, size=(cfg.batch, cfg.seq_len + 1), p=p
        ).astype(np.int64)
        yield stream[:, :-1], stream[:, 1:]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _placer(rules, device) -> tuple[torch.device, Callable]:
    """The target device and the host-side cut of each leaf: with a world
    mesh's ``rules`` this rank's piece (rows over the data axes, the
    sequence over ``sp``, the spec truncated to the leaf's rank); on a
    one-process mesh the whole leaf, for its home device."""
    if rules is None:
        from ..models.burnin import check_device

        return check_device("cuda" if device is None else device), \
            lambda x: x
    from ..parallel.mesh import WorldMesh
    from ..parallel.sharding import local_shard

    mesh = rules.mesh
    if not isinstance(mesh, WorldMesh):
        return torch.device(mesh.devices.flat[0]), lambda x: x
    spec = rules.act("sp")

    def cut(x: torch.Tensor) -> torch.Tensor:
        return local_shard(x, spec[:x.dim()], mesh) if x.dim() else x

    return torch.device(mesh.device), cut


class _Stager:
    """Issues each batch's host→device copies (on the card: pinned
    staging, a copy stream of its own, an event a batch) and hands a
    batch over to the consumer's current stream."""

    def __init__(self, dev: torch.device, cut: Callable):
        self.dev, self.cut = dev, cut
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def _host(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return self.cut(t.to("cpu")).contiguous()

    def issue(self, batch) -> tuple[Any, Any]:
        if self.stream is None:
            return _tree_map(lambda x: self._host(x).to(self.dev),
                             batch), None

        def copy(x):
            return self._host(x).pin_memory().to(self.dev,
                                                  non_blocking=True)

        with torch.cuda.stream(self.stream):
            placed = _tree_map(copy, batch)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return placed, ready

    def hand_over(self, item) -> Any:
        placed, ready = item
        if ready is None:
            return placed
        consumer = torch.cuda.current_stream(self.dev)
        consumer.wait_event(ready)
        _tree_map(lambda t: t.record_stream(consumer), placed)
        return placed


def prefetch_to_device(batches: Iterator[Any], rules=None, size: int = 2,
                       device=None) -> Iterator[Any]:
    """Keep ``size`` batches in flight to the device ahead of the consumer.

    Tree-generic (dicts, lists, tuples): every leaf — a numpy array or
    scalar, a Python number, a tensor — becomes a tensor on the card
    (``device`` names another, the tests' ``"cpu"``; there is no fallback
    to the CPU), or with ``rules`` where the step takes it (module
    docstring). Prefetching reorders nothing, and a finite iterator is
    drained to its end."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    stager = _Stager(*_placer(rules, device))
    window: collections.deque = collections.deque()
    for batch in batches:
        window.append(stager.issue(batch))
        if len(window) >= size:
            yield stager.hand_over(window.popleft())
    while window:
        yield stager.hand_over(window.popleft())


def input_pipeline(cfg, rules=None, seed: int = 0, prefetch: int = 2,
                   bias: str = "zipf", device=None) -> Iterator[Any]:
    """``token_stream`` → ``prefetch_to_device``: the assembled pipeline."""
    return prefetch_to_device(token_stream(cfg, seed, bias), rules, prefetch,
                              device)
