# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The reference's random draws, bit for bit, and the fused draw kernel D1.

The reference samples with ``jax.random`` (``models/decode.py``
``make_sampler``, ``models/serving.py`` ``_request_key``) under JAX's
default generator, threefry-2x32 with partitionable bits. That generator is
a pure function of 32-bit integers, so its bits are the same on every
platform; this module computes them with PyTorch:

- :func:`key_data`: a seed (``jax.random.PRNGKey(s)`` and ``key(s)``
  carry ``(0, s mod 2^32)``) or raw ``[2]`` key data;
- :func:`threefry2x32`, :func:`fold_in` (``threefry(k, (0, d))``),
  :func:`split` (``split(k, n)[i] == fold_in(k, i)``),
  :func:`random_bits` (``x0 ^ x1`` of ``threefry(k, (hi, lo))`` over the
  flattened element index), :func:`uniform` (``[tiny, 1)``, as the Gumbel
  draw's "low" mode asks), :func:`gumbel` and :func:`categorical`.

Integers are int64 tensors masked to 32 bits (PyTorch's uint32 lacks the
shifts).

:func:`draw` is the one entry the samplers call: the Gumbel-max draw over
``[S, V]`` f32 logits, row ``s`` keyed by ``keys`` (``[2]`` shared or
``[S, 2]``), optionally folded with ``fold[s] = (request, position)`` as
the serve engine keys its tokens, its elements counted from ``offsets[s]``
(0 for a per-row draw, ``s·V`` for ``categorical``'s batched draw with one
key). On a CUDA tensor it launches D1 (``csrc/sample.cu``); on a CPU tensor
it runs :func:`draw_ref`, the same arithmetic in PyTorch.

D1 is not the port of a TPU kernel: the reference draws in XLA, which fuses
threefry, the Gumbel transform and the argmax into the jitted step. In eager
PyTorch the same draw is some two hundred elementwise launches over
``[S, V]`` int64 tensors; D1 is one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def key_data(rng, device=None) -> torch.Tensor:
    """The ``[2]`` int64 key data of ``rng``: an int seed as
    ``jax.random.PRNGKey`` makes it, ``(0, seed mod 2^32)``, or a ``[2]``
    array or tensor of raw key data (``jax.random.key_data``)."""
    if isinstance(rng, (int, np.integer)):
        t = torch.tensor([0, int(rng) & MASK32], dtype=torch.int64)
    elif isinstance(rng, torch.Tensor):
        t = rng.to(torch.int64) & MASK32
    else:
        t = torch.from_numpy(np.asarray(rng).astype(np.int64)) & MASK32
    if t.shape != (2,):
        raise ValueError(f"a key is 2 words of key data, got shape "
                         f"{tuple(t.shape)}")
    return t if device is None else t.to(device)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key ``(k0, k1)``: int64 tensors (or ints) holding 32-bit values,
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def fold_in(key, data):
    """``jax.random.fold_in``: ``threefry(key, (0, data))``. ``data`` is an
    int or an int64 tensor, whose elements fold in one by one (the result
    then has their shape and a trailing axis of 2)."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & MASK32
    else:
        d = torch.tensor(int(data) & MASK32, dtype=torch.int64,
                         device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key, num: int = 2):
    """``jax.random.split`` (partitionable): ``[num, 2]`` keys, row ``i``
    ``threefry(key, (0, i))``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], i >> 32, i & MASK32)
    return torch.stack([y0, y1], dim=-1)


def _bits(k0, k1, counts):
    x0, x1 = threefry2x32(k0, k1, counts >> 32, counts & MASK32)
    return x0 ^ x1


def random_bits(key, shape):
    """``jax.random.bits`` of 32 bits: element ``i`` of the flattened
    ``shape`` is ``x0 ^ x1`` of ``threefry(key, (i >> 32, i mod 2^32))``."""
    n = int(np.prod(shape, dtype=np.int64))
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    return _bits(key[0], key[1], counts).reshape(shape)


def _uniform_from_bits(bits):
    """JAX's float32 ``uniform`` with ``minval = tiny``, ``maxval = 1``:
    the top 23 bits as a mantissa of ``[1, 2)``, minus 1, scaled by
    ``maxval - minval`` (which rounds to 1), plus ``minval``, at least
    ``minval`` — each step an f32 rounding, in JAX's order."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    # made on the device (a host scalar's copy cannot be captured)
    lo = torch.full((), TINY, dtype=torch.float32, device=bits.device)
    span = torch.ones((), dtype=torch.float32, device=bits.device) - lo
    return torch.maximum(lo, (f - 1.0) * span + lo)


def uniform(key, shape):
    """``jax.random.uniform(key, shape, minval=tiny, maxval=1.)``."""
    return _uniform_from_bits(random_bits(key, shape))


def _gumbel_from_bits(bits):
    return -torch.log(-torch.log(_uniform_from_bits(bits)))


def gumbel(key, shape):
    """``jax.random.gumbel(key, shape)`` in its default "low" mode:
    ``-log(-log(u))`` over :func:`uniform`."""
    return _gumbel_from_bits(random_bits(key, shape))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis of
    ``[B, V]`` logits: the argmax of ``gumbel(key, [B, V]) + logits``."""
    b, v = logits.shape
    offsets = torch.arange(b, dtype=torch.int64, device=logits.device) * v
    return draw(logits.float(), key, offsets)


def _row_keys(keys, fold, rows: int):
    """Each row's key: ``keys`` (``[2]`` shared or ``[S, 2]``), folded with
    the row's (request, position) when ``fold`` is given."""
    k0 = keys[..., 0].expand(rows) if keys.dim() == 1 else keys[:, 0]
    k1 = keys[..., 1].expand(rows) if keys.dim() == 1 else keys[:, 1]
    if fold is not None:
        zero = torch.zeros_like(k0)
        for j in range(2):
            k0, k1 = threefry2x32(k0, k1, zero, fold[:, j] & MASK32)
    return k0, k1


def draw_ref(logits, keys, offsets=None, fold=None, *, scores: bool = False):
    """The plain version of :func:`draw`: threefry bits of each element's
    count ``offsets[s] + v``, JAX's uniform and Gumbel transform, ``score =
    logit + g``, and the first index of the row's largest score. With
    ``scores`` also returns the ``[S, V]`` scores."""
    s, v = logits.shape
    k0, k1 = _row_keys(keys, fold, s)
    counts = torch.arange(v, dtype=torch.int64, device=logits.device)[None]
    if offsets is not None:
        counts = counts + offsets[:, None]
    g = _gumbel_from_bits(_bits(k0[:, None], k1[:, None], counts))
    sc = logits + g
    tok = sc.argmax(dim=-1)
    return (tok, sc) if scores else tok


def _check(logits, keys, offsets, fold):
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"draw takes f32 logits [S, V], got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    s = logits.shape[0]
    if keys.dtype != torch.int64 or keys.shape not in ((2,), (s, 2)):
        raise ValueError(f"keys must be int64 [2] or [S, 2], got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if offsets is not None and (offsets.dtype != torch.int64
                                or offsets.shape != (s,)):
        raise ValueError(f"offsets must be int64 [S], got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if fold is not None and (fold.dtype != torch.int64
                             or fold.shape != (s, 2)):
        raise ValueError(f"fold must be int64 [S, 2], got "
                         f"{tuple(fold.shape)} {fold.dtype}")


def _launch(logits, keys, offsets, fold, scores):
    s, v = logits.shape
    dev = logits.device
    for name, t in (("keys", keys), ("offsets", offsets), ("fold", fold)):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {dev}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if not 1 <= s <= 65535 or v < 1:
        raise ValueError(f"D1 takes 1 <= S <= 65535 rows, got [{s}, {v}]")
    out = torch.empty((s,), dtype=torch.int64, device=dev)
    sc = torch.empty((s, v), dtype=torch.float32, device=dev) \
        if scores else None
    rc = _build.lib().tk_sample_draw(
        logits.data_ptr(), keys.data_ptr(), 0 if keys.dim() == 1 else 2,
        None if offsets is None else offsets.data_ptr(),
        None if fold is None else fold.data_ptr(), out.data_ptr(),
        None if sc is None else sc.data_ptr(), s, v,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sample_draw")
    _build.launches["sample_draw"] += 1
    return (out, sc) if scores else out


def draw(logits, keys, offsets=None, fold=None):
    """The Gumbel-max draw: ``[S]`` int64 tokens from ``[S, V]`` f32
    logits (already tempered and filtered; ``-inf`` never wins unless the
    whole row is ``-inf``, and ties go to the lowest index, as
    ``jnp.argmax``). ``keys`` ``[2]`` or ``[S, 2]`` int64; ``offsets``
    ``[S]`` int64 element counts of each row's first element (None: 0);
    ``fold`` ``[S, 2]`` int64 ``(request, position)`` folded into each
    row's key. D1 on a CUDA tensor, :func:`draw_ref` on a CPU tensor."""
    _check(logits, keys, offsets, fold)
    if logits.device.type == "cpu":
        return draw_ref(logits, keys, offsets, fold)
    if logits.device.type != "cuda":
        raise ValueError(f"no draw kernel for device {logits.device}")
    return _launch(logits, keys, offsets, fold, False)


def draw_scores(logits, keys, offsets=None, fold=None):
    """D1 with its debug output: ``(tokens, scores [S, V])``, the Gumbel
    scores the kernel compared (CUDA tensors only), for holding them
    against :func:`draw_ref`'s."""
    _check(logits, keys, offsets, fold)
    if logits.device.type != "cuda":
        raise ValueError("draw_scores reads D1's scores: CUDA tensors only")
    return _launch(logits, keys, offsets, fold, True)
