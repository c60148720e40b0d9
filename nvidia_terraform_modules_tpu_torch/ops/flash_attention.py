# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Flash attention forward on ``[B, S, H, D]`` — the port of the reference's
``ops/flash_attention.py`` forward (``flash_attention`` → ``_fwd``).

:func:`flash_attention_fwd` is the kernel wrapper: on a CUDA tensor it
launches the hand-written kernel ``csrc/flash_fwd.cu`` (or raises), on a
CPU tensor it runs :func:`flash_attention_ref`, the plain PyTorch version
of the same function. There is no other dispatch and no fallback.

Kept as numpy copies of the reference, because the flash/dense SELECTION
changes numerics and must match it: :class:`MaskSpec` /
:func:`as_mask_spec` / :func:`block_liveness`, ``NEG_INF``,
:func:`_fit_block` and :func:`pick_impl`. The TPU's tile rules
(``auto_blocks``, the VMEM budget) are not carried over: the CUDA kernel
has its own fixed 64x64 tiling.

GQA: ``k``/``v`` may carry ``KV`` heads dividing ``H``; query head ``h``
reads KV head ``h // (H // KV)`` — the same math as repeating K/V (the
reference's ``grow``), without the copy.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build

NEG_INF = -1e30

MASK_DEAD = 0
MASK_PARTIAL = 1
MASK_FULL = 2

_MASK_CODE = {"causal": 0, "full": 1, "window": 2}


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Static attention mask: ``"causal"`` (q >= k), ``"full"``, or
    ``"window"`` (q >= k and q - k < window)."""

    kind: str = "causal"
    window: int | None = None

    def __post_init__(self):
        if self.kind not in ("causal", "full", "window"):
            raise ValueError(
                f"unknown mask kind {self.kind!r}; use causal|full|window")
        if self.kind == "window":
            if self.window is None or self.window < 1:
                raise ValueError(
                    f"window mask needs window >= 1, got {self.window}")
        elif self.window is not None:
            raise ValueError(f"mask kind {self.kind!r} takes no window")


def as_mask_spec(mask, causal: bool = True) -> MaskSpec:
    """Normalise ``mask=``: ``None`` defers to ``causal``; a string names a
    kind; ``("window", W)`` and :class:`MaskSpec` pass through."""
    if mask is None:
        return MaskSpec("causal" if causal else "full")
    if isinstance(mask, MaskSpec):
        return mask
    if isinstance(mask, str):
        return MaskSpec(mask)
    if isinstance(mask, tuple) and len(mask) == 2 and mask[0] == "window":
        return MaskSpec("window", int(mask[1]))
    raise ValueError(
        f"unknown mask {mask!r}; use None, 'causal'|'full', ('window', W) "
        f"or a MaskSpec")


@functools.lru_cache(maxsize=256)
def block_liveness(spec: MaskSpec, nq: int, nk: int,
                   block_q: int, block_k: int) -> np.ndarray:
    """Per-(q-block, k-block) liveness map ``[nq, nk]`` of MASK_DEAD /
    MASK_PARTIAL / MASK_FULL. The CUDA kernel's loop bounds visit exactly
    the non-dead tiles of this map at its 64x64 tiling."""
    if spec.kind == "full":
        live = np.full((nq, nk), MASK_FULL, np.int32)
    else:
        qlo = np.arange(nq, dtype=np.int64)[:, None] * block_q
        qhi = qlo + block_q - 1
        klo = np.arange(nk, dtype=np.int64)[None, :] * block_k
        khi = klo + block_k - 1
        dead = klo > qhi
        full = khi <= qlo
        if spec.kind == "window":
            w = spec.window
            dead |= khi < qlo - (w - 1)
            full &= (qhi - klo) <= (w - 1)
        live = np.where(dead, MASK_DEAD,
                        np.where(full, MASK_FULL, MASK_PARTIAL)).astype(
                            np.int32)
    live.setflags(write=False)
    return live


def _fit_block(s: int, want: int | None) -> int:
    """Largest 8-multiple divisor of ``s`` that is <= ``want`` (``None``:
    the reference's ``min(1024, max(128, S/4))``); 0 when none exists."""
    if want is None:
        want = min(1024, max(128, s // 4))
    if s <= 8:
        return s
    b = min(want - want % 8, s - s % 8)
    while b >= 8 and s % b:
        b -= 8
    return b if b >= 8 else 0


def pick_impl(impl: str | None, seq_len: int, what: str) -> str:
    """The flash/dense selection: ``None`` picks "flash" when ``seq_len``
    tiles into 8-multiple blocks (every 8-multiple length), "dense"
    otherwise; an explicit impl is validated and passed through. This is
    the reference's rule on its production device; its extra clause for
    the CPU interpreter (every ``seq_len <= 8`` counts as flash there) is
    not carried, because the port's kernel is the production path."""
    if impl not in (None, "dense", "flash"):
        raise ValueError(f"unknown {what} impl {impl!r}; use dense|flash")
    if impl is not None:
        return impl
    return "flash" if _fit_block(seq_len, None) >= 8 else "dense"


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    kv = k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"q heads ({h}) must be a multiple of the k/v "
                         f"heads ({kv})")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None, mask=None):
    """The plain PyTorch version: ``(o [B,S,H,D] in q.dtype, lse [B,H,S]
    f32)`` with the kernel's numerics in one tile — f32 scores from
    input-dtype operands, the scale after the product, finite -1e30
    masking, unnormalised P rounded to ``v.dtype`` before the PV product,
    ``lse = m + log(max(l, 1e-30))``."""
    _check_qkv(q, k, v)
    spec = as_mask_spec(mask, causal)
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if spec.kind != "full":
        idx = torch.arange(s, device=q.device)
        keep = idx[:, None] >= idx[None, :]
        if spec.kind == "window":
            keep &= (idx[:, None] - idx[None, :]) < spec.window
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(sc <= NEG_INF / 2, torch.zeros_like(sc),
                    torch.exp(sc - m))
    l_ = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = (acc / l_.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l_)).squeeze(-1)
    return o, lse


def _flash_cuda(q, k, v, scale: float, spec: MaskSpec):
    b, s, h, d = q.shape
    if d % 16 or d > 128:
        raise ValueError(f"the flash kernel takes head_dim % 16 == 0 and "
                         f"<= 128, got {d}")
    code = _build.dtype_code(q.dtype)
    vec = 16 // q.element_size()

    def aligned(t):
        # 16-byte rows: unit last stride, vector-multiple strides, base
        ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
              and all(t.stride(i) % vec == 0 for i in range(3)))
        return t if ok else t.contiguous()

    q, k, v = aligned(q), aligned(k), aligned(v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)]
    window = spec.window if spec.kind == "window" else 0
    rc = _build.lib().tk_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d, *strides, float(scale),
        _MASK_CODE[spec.kind], window, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_fwd")
    _build.launches["flash_fwd"] += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: float | None = None, mask=None):
    """Flash attention forward → ``(o [B,S,H,D], lse [B,H,S] f32)``.

    A CUDA tensor launches the kernel (``csrc/flash_fwd.cu``; bf16 or
    f32, ``head_dim % 16 == 0`` and ``<= 128``, anything else raises); a
    CPU tensor runs :func:`flash_attention_ref`."""
    _check_qkv(q, k, v)
    spec = as_mask_spec(mask, causal)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, mask=spec)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return _flash_cuda(q, k, v, scale, spec)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, mask=None):
    """Fused flash attention on ``[B, S, H, D]`` inputs; returns the output
    in the input dtype (see :func:`flash_attention_fwd`)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               mask=mask)[0]
