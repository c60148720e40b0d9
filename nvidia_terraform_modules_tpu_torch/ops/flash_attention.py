# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Flash attention on ``[B, S, H, D]`` — the port of the reference's
``ops/flash_attention.py``: the forward (``flash_attention`` → ``_fwd``),
the partial forward of ring attention (``flash_partial``), the backward
kernels (``flash_dqdkv``, ``flash_dq``, ``flash_dkv``, with ``out_dtype``
for the ring's f32 per-block gradients) and the ``custom_vjp`` that joins
them (:class:`FlashAttention`).

Each kernel wrapper — :func:`flash_attention_fwd` and
:func:`flash_partial` (``csrc/flash_fwd.cu``), :func:`flash_dqdkv`,
:func:`flash_dq` and :func:`flash_dkv` (``csrc/flash_bwd.cu``) — launches its hand-written kernel on a CUDA
tensor (or raises) and runs its plain PyTorch version (the ``*_ref``
function of the same name) on a CPU tensor. There is no other dispatch and
no fallback.

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

import ctypes
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


def mask_live_frac(spec: MaskSpec, s: int) -> float:
    """Fraction of the [S, S] score matrix the mask keeps live — the FLOP
    billing factor of ``train_step_flops``. Causal keeps the reference's
    0.5 convention."""
    if spec.kind == "full":
        return 1.0
    if spec.kind == "causal":
        return 0.5
    w = min(spec.window, s)
    live = w * (w + 1) // 2 + (s - w) * w
    return live / float(s * s)


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


def pick_impl(impl: str | None, seq_len: int, what: str,
              device: torch.device | None = None) -> str:
    """The flash/dense selection; an explicit impl is validated and passed
    through. ``None`` on a CUDA ``device`` picks "flash" at every length:
    the CUDA kernels zero-fill and mask ragged tails. Elsewhere it is the
    reference's rule on its production device: "flash" when ``seq_len``
    tiles into 8-multiple blocks (every 8-multiple length), "dense"
    otherwise. The reference's extra clause for the CPU interpreter (every
    ``seq_len <= 8`` counts as flash there) is not carried, because the
    port's kernel is the production path."""
    if impl not in (None, "dense", "flash"):
        raise ValueError(f"unknown {what} impl {impl!r}; use dense|flash")
    if impl is not None:
        return impl
    if device is not None and torch.device(device).type == "cuda":
        return "flash"
    return "flash" if _fit_block(seq_len, None) >= 8 else "dense"


def _check_qkv(q, k, v, same_len: bool = True):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or (
            same_len and k.shape[1] != s):
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


def flash_partial_ref(q, k, v, *, scale: float, causal: bool = True,
                      mask=None):
    """The plain version of K2 (:func:`flash_partial`): the UNNORMALISED
    online-softmax state ``(acc f32 [B,Sq,H,D], m f32 [B,H,Sq], l f32
    [B,H,Sq])`` in one tile — f32 scores from input-dtype operands, the
    scale after the product, finite -1e30 masking in LOCAL positions
    (query ``i`` against key ``j``), ``p = 0`` where ``s <= -1e30 / 2``,
    P rounded to ``v.dtype`` before the PV product, no final division.
    ``k``/``v`` may be longer or shorter than ``q``."""
    _check_qkv(q, k, v, same_len=False)
    spec = as_mask_spec(mask, causal)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if spec.kind != "full":
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        keep = qi >= ki
        if spec.kind == "window":
            keep &= (qi - ki) < spec.window
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1)
    p = torch.where(sc <= NEG_INF / 2, torch.zeros_like(sc),
                    torch.exp(sc - m[..., None]))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(dim=-1)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None, mask=None):
    """The plain version of K1: ``(o [B,S,H,D] in q.dtype, lse [B,H,S]
    f32)`` — :func:`flash_partial_ref`'s state normalised, as the kernel's
    epilogue does: ``o = acc / max(l, 1e-30)`` and
    ``lse = m + log(max(l, 1e-30))``."""
    _check_qkv(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    acc, m, l_ = flash_partial_ref(q, k, v, scale=scale, causal=causal,
                                   mask=mask)
    l_ = l_.clamp_min(1e-30)
    o = (acc / l_.permute(0, 2, 1)[..., None]).to(q.dtype)
    return o, m + torch.log(l_)


def _flash_cuda(q, k, v, scale: float, spec: MaskSpec, partial: bool):
    """Launch K1 (``tk_flash_fwd`` → ``(o, lse)``) or, with ``partial``,
    K2 (``tk_flash_partial`` → ``(acc, m, l)``) of ``csrc/flash_fwd.cu``;
    the outputs are allocated here."""
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
    strides = [t.stride(i) for t in (q, k, v) for i in (0, 1, 2)]
    window = spec.window if spec.kind == "window" else 0
    tail = [float(scale), _MASK_CODE[spec.kind], window, code,
            torch.cuda.current_stream(q.device).cuda_stream]
    stats = [torch.empty((b, h, s), dtype=torch.float32, device=q.device)
             for _ in range(1 + partial)]
    if partial:
        acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        rc = _build.lib().tk_flash_partial(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            *[t.data_ptr() for t in stats], b, s, k.shape[1], h,
            k.shape[2], d, *strides, *tail)
        _build.check(rc, "flash_partial")
        _build.count("flash_partial")
        return acc, *stats
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = _build.lib().tk_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        stats[0].data_ptr(), b, s, h, k.shape[2], d, *strides,
        *[o.stride(i) for i in (0, 1, 2)], *tail)
    _build.check(rc, "flash_fwd")
    _build.count("flash_fwd")
    return o, stats[0]


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
    return _flash_cuda(q, k, v, scale, spec, partial=False)


def flash_partial(q, k, v, *, scale: float, causal: bool = True, mask=None):
    """K2: one flash sweep of ``q`` over (``k``, ``v``) WITHOUT the final
    normalisation → ``(acc f32 [B,Sq,H,D], m f32 [B,H,Sq], l f32
    [B,H,Sq])``, the unnormalised accumulator, running max and running sum
    — what ring attention folds across visiting K/V blocks. ``k``/``v``
    may have another sequence length than ``q``; ``causal`` (and a window
    ``mask``) work in LOCAL positions, right for the ring's diagonal
    block.

    A CUDA tensor launches ``csrc/flash_fwd.cu``'s partial instance of the
    forward kernel (K1's sweep with another epilogue, so
    ``acc / max(l, 1e-30)`` equals K1's output bit for bit); a CPU tensor
    runs :func:`flash_partial_ref`."""
    _check_qkv(q, k, v, same_len=False)
    spec = as_mask_spec(mask, causal)
    if q.device.type == "cpu":
        return flash_partial_ref(q, k, v, scale=scale, mask=spec)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return _flash_cuda(q, k, v, scale, spec, partial=True)


# ------------------------------------------------------------- backward

def _check_bwd(q, k, v, do, lse, delta):
    _check_qkv(q, k, v)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"the flash backward takes MHA shapes: q has "
                         f"{q.shape[2]} heads, k/v {k.shape[2]} (repeat K/V "
                         f"for GQA first, as the training forward does)")
    b, s, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be [B, H, S] float32 "
                             f"{(b, h, s)}, got {tuple(t.shape)} {t.dtype}")
    if any(t.device != q.device for t in (do, lse, delta)):
        raise ValueError("the backward's inputs must be on one device")


def _bwd_tile_ref(q, k, v, do, lse, delta, scale: float, spec: MaskSpec):
    """``_bwd_tile`` over the whole sequence as one tile → ``(p, ds)``
    ``[B, H, Sq, Sk]`` f32: scores from input-dtype operands, the scale
    after the product, finite -1e30 masking, P from the saved LSE (0 where
    masked), ``dP = dO·Vᵀ`` and ``dS = P·(dP − delta)`` in f32."""
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if spec.kind != "full":
        idx = torch.arange(s, device=q.device)
        keep = idx[:, None] >= idx[None, :]
        if spec.kind == "window":
            keep &= (idx[:, None] - idx[None, :]) < spec.window
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    p = torch.where(sc <= NEG_INF / 2, torch.zeros_like(sc),
                    torch.exp(sc - lse[..., None]))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _dq_of(ds, k, scale):
    return (torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                         k.float()) * scale)


def _dk_of(ds, q, scale):
    return (torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                         q.float()) * scale)


def _dv_of(p, do):
    return torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(),
                        do.float())


def _out_dtype(q, out_dtype):
    """The gradients' dtype: q's by default, or float32 (the ring's
    per-block gradients, summed across ring steps before one cast)."""
    if out_dtype is None:
        return q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"out_dtype must be the inputs' dtype ({q.dtype}) "
                         f"or torch.float32, got {out_dtype}")
    return out_dtype


def flash_dq_ref(q, k, v, do, lse, delta, *, scale: float, mask=None,
                 causal: bool = True, out_dtype=None):
    """The plain version of K3 (``flash_dq``): ``dQ = (dS→k.dtype)·K·scale``
    in ``out_dtype`` (default q's). ``lse`` and ``delta`` are ``[B, H, S]``
    f32."""
    _check_bwd(q, k, v, do, lse, delta)
    _, ds = _bwd_tile_ref(q, k, v, do, lse, delta, scale,
                          as_mask_spec(mask, causal))
    return _dq_of(ds, k, scale).to(_out_dtype(q, out_dtype))


def flash_dkv_ref(q, k, v, do, lse, delta, *, scale: float, mask=None,
                  causal: bool = True, out_dtype=None):
    """The plain version of K4 (``flash_dkv``): ``(dK, dV)`` with
    ``dK = (dS→q.dtype)ᵀ·Q·scale`` and ``dV = (P→dO.dtype)ᵀ·dO``, in
    ``out_dtype`` (default the inputs')."""
    _check_bwd(q, k, v, do, lse, delta)
    p, ds = _bwd_tile_ref(q, k, v, do, lse, delta, scale,
                          as_mask_spec(mask, causal))
    out = _out_dtype(q, out_dtype)
    return _dk_of(ds, q, scale).to(out), _dv_of(p, do).to(out)


def flash_dqdkv_ref(q, k, v, do, lse, delta, *, scale: float, mask=None,
                    causal: bool = True, out_dtype=None):
    """The plain version of K5 (``flash_dqdkv``): ``(dQ, dK, dV)`` from one
    P/dS — the same numbers as :func:`flash_dq_ref` and
    :func:`flash_dkv_ref`."""
    _check_bwd(q, k, v, do, lse, delta)
    p, ds = _bwd_tile_ref(q, k, v, do, lse, delta, scale,
                          as_mask_spec(mask, causal))
    out = _out_dtype(q, out_dtype)
    return (_dq_of(ds, k, scale).to(out), _dk_of(ds, q, scale).to(out),
            _dv_of(p, do).to(out))


def _bwd_cuda(kernel: str, q, k, v, do, lse, delta, scale: float,
              spec: MaskSpec, out_dtype):
    """Launch one of the backward kernels of ``csrc/flash_bwd.cu`` on
    contiguous inputs; outputs are allocated here, in q's layout and
    ``out_dtype``."""
    b, s, h, d = q.shape
    if d % 16 or d > 128:
        raise ValueError(f"the flash backward kernels take head_dim % 16 == "
                         f"0 and <= 128, got {d}")
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    tail = [b, s, h, d, float(scale), _MASK_CODE[spec.kind],
            spec.window if spec.kind == "window" else 0,
            _build.dtype_code(q.dtype), _build.dtype_code(out_dtype),
            torch.cuda.current_stream(q.device).cuda_stream]
    lib = _build.lib()

    def empty(n):
        return tuple(torch.empty(q.shape, dtype=out_dtype, device=q.device)
                     for _ in range(n))

    if kernel == "flash_bwd_fused":
        ws = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        out = empty(3)
        rc = lib.tk_flash_bwd_fused(*ptrs, ws.data_ptr(),
                                    *[t.data_ptr() for t in out], *tail)
    elif kernel == "flash_dkv":
        out = empty(2)
        rc = lib.tk_flash_dkv(*ptrs, *[t.data_ptr() for t in out], *tail)
    else:
        (out,) = empty(1)
        rc = lib.tk_flash_dq(*ptrs, out.data_ptr(), *tail)
    _build.check(rc, kernel)
    _build.count(kernel)
    return out


# the bf16 sweeps' codes in ``tk_flash_bwd_info``, by launch-count name
_SWEEP_CODE = {"flash_bwd_fused": 0, "flash_dkv": 1, "flash_dq": 2}


def flash_bwd_resources(kernel: str, head_dim: int, *,
                        out_dtype=torch.bfloat16) -> dict:
    """What the bf16 backward kernel ``kernel`` (``"flash_bwd_fused"``: K5
    and ``"flash_dkv"``: K4, the key-block sweep ``flash_bwd_kv_mma`` of
    ``csrc/flash_bwd.cu``; ``"flash_dq"``: K3, the query-block sweep
    ``flash_dq_mma``) launches at ``head_dim`` with gradients in
    ``out_dtype`` takes on the card: ``registers`` a thread,
    ``spill_bytes`` (local memory) a thread, ``smem_bytes`` of dynamic
    shared memory, and ``ctas_per_sm`` that fit an SM. Builds the kernels
    on first use; needs a CUDA device."""
    if kernel not in _SWEEP_CODE:
        raise ValueError(f"kernel must be one of {sorted(_SWEEP_CODE)}, got "
                         f"{kernel!r}")
    out = (ctypes.c_int * 4)()
    rc = _build.lib().tk_flash_bwd_info(
        _SWEEP_CODE[kernel], head_dim, _build.dtype_code(out_dtype),
        ctypes.addressof(out))
    _build.check(rc, "flash_bwd_info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "ctas_per_sm"), out))


def _bwd_dispatch(kernel, ref, q, k, v, do, lse, delta, scale, mask,
                  causal, out_dtype):
    _check_bwd(q, k, v, do, lse, delta)
    spec = as_mask_spec(mask, causal)
    out_dtype = _out_dtype(q, out_dtype)
    if q.device.type == "cpu":
        return ref(q, k, v, do, lse, delta, scale=scale, mask=spec,
                   out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no flash backward kernel for device {q.device}")
    return _bwd_cuda(kernel, q, k, v, do, lse, delta, scale, spec,
                     out_dtype)


def flash_dq(q, k, v, do, lse, delta, *, scale: float, mask=None,
             causal: bool = True, out_dtype=None):
    """K3: dQ of the split backward, in ``out_dtype`` (q's, or float32).
    A CUDA tensor launches ``csrc/flash_bwd.cu``'s ``flash_dq_mma`` (bf16,
    bitwise deterministic) or ``flash_dq_kernel`` (f32), ``head_dim % 16
    == 0`` and ``<= 128``; a CPU tensor runs :func:`flash_dq_ref`."""
    return _bwd_dispatch("flash_dq", flash_dq_ref, q, k, v, do, lse, delta,
                         scale, mask, causal, out_dtype)


def flash_dkv(q, k, v, do, lse, delta, *, scale: float, mask=None,
              causal: bool = True, out_dtype=None):
    """K4: ``(dK, dV)`` of the split backward (``flash_bwd_kv_kernel``
    without the dQ atomics); a CPU tensor runs :func:`flash_dkv_ref`."""
    return _bwd_dispatch("flash_dkv", flash_dkv_ref, q, k, v, do, lse,
                         delta, scale, mask, causal, out_dtype)


def flash_dqdkv(q, k, v, do, lse, delta, *, scale: float, mask=None,
                causal: bool = True, out_dtype=None):
    """K5: ``(dQ, dK, dV)`` from the fused single-pass kernel (dQ summed
    with atomics, so its rounding order varies from run to run); a CPU
    tensor runs :func:`flash_dqdkv_ref`."""
    return _bwd_dispatch("flash_bwd_fused", flash_dqdkv_ref, q, k, v, do,
                         lse, delta, scale, mask, causal, out_dtype)


def _check_backward(backward: str) -> None:
    if backward not in ("fused", "split"):
        raise ValueError(
            f"unknown backward impl {backward!r}; use fused|split")


def flash_backward(q, k, v, o, do, lse, *, scale: float, mask=None,
                   causal: bool = True, backward: str = "fused",
                   out_dtype=None):
    """Full flash backward → ``(dQ, dK, dV)`` in ``out_dtype`` (q's, or
    float32): the delta reduction ``rowsum(dO·O)`` in f32 (plain PyTorch,
    as the reference leaves it to XLA), then the fused kernel (K5) or the
    split pair (K3, K4)."""
    _check_backward(backward)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    kw = dict(scale=scale, mask=mask, causal=causal, out_dtype=out_dtype)
    if backward == "fused":
        return flash_dqdkv(q, k, v, do, lse, delta, **kw)
    dq = flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's ``_flash_bhsd`` ``custom_vjp``:
    forward through :func:`flash_attention_fwd` (K1), saving
    ``(q, k, v, o, lse)``; backward through :func:`flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, spec: MaskSpec, backward: str):
        o, lse = flash_attention_fwd(q, k, v, scale=scale, mask=spec)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.spec, ctx.backward = scale, spec, backward
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, do.contiguous(), lse,
                                    scale=ctx.scale, mask=ctx.spec,
                                    backward=ctx.backward)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, mask=None,
                    backward: str = "fused"):
    """Fused flash attention on ``[B, S, H, D]`` inputs; returns the output
    in the input dtype (see :func:`flash_attention_fwd`). When an input
    requires a gradient it runs through :class:`FlashAttention`, whose
    backward is ``backward``: ``"fused"`` (K5) or ``"split"`` (K3 + K4);
    that path takes MHA shapes (GQA inputs raise)."""
    _check_backward(backward)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   mask=mask)[0]
    _check_qkv(q, k, v)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"flash attention with gradients takes MHA shapes: "
                         f"q has {q.shape[2]} heads, k/v {k.shape[2]} "
                         f"(repeat K/V to the query heads first)")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return FlashAttention.apply(q, k, v, scale, as_mask_spec(mask, causal),
                                backward)
