# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object file —
all sources at once, one ``nvcc`` each — and the objects link into
``build/torch_kernels/libkernels.so`` at the repository root, which is
loaded with ``ctypes``. The sources include no PyTorch header: a plain C
interface builds in seconds, where an extension that includes PyTorch's
headers takes minutes. The library is rebuilt when the sources or the
flags change (a stamp file holds their digest).

Nothing here runs at import: the first kernel call builds and loads. The
C entry points take device pointers and the stream as ``c_void_p`` and
return ``cudaGetLastError()`` after the launch; :func:`check` raises on a
non-zero code, so a refused launch can never pass silently.

``launches`` holds one launch count per kernel: each wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_LIB_NAME = "libkernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

launches: dict[str, int] = {"flash_fwd": 0, "flash_partial": 0,
                            "paged_decode": 0,
                            "paged_decode_int8": 0, "kv_decode": 0,
                            "int8_matmul": 0, "flash_bwd_fused": 0,
                            "flash_dq": 0, "flash_dkv": 0,
                            "sample_draw": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, B, S, H, KV, D, 4×3 strides (q, k, v, o: b, s, h),
    # scale, mask kind, window, dtype code, stream
    "tk_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_F, _I, _I, _I, _P],
    # q, k, v, acc (f32, contiguous), m, l, B, Sq, Sk, H, KV, D, 3×3
    # strides (q, k, v: b, s, h), scale, mask kind, window, dtype code,
    # stream
    "tk_flash_partial": [_P] * 6 + [_I] * 6 + [_L] * 9
    + [_F, _I, _I, _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale (None: a bf16/f32 pool), tables,
    # pos, out, span partials (f32), span counters (int32), B, H, KV, D,
    # block size, table width, spans, scale, dtype code, stream
    "tk_paged_decode": [_P] * 10 + [_I] * 7 + [_F, _I, _P],
    # q, k, v, k_scale, v_scale (None unless int8), pos, out, span
    # partials, span counters, B, H, KV, D, S, spans, scale, dtype code,
    # int8 flag, stream
    "tk_kv_decode": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P],
    # x, w, scale, out, M, K, N, K slices, transpose, dtype code, stream
    "tk_int8_matmul": [_P] * 4 + [_I] * 6 + [_P],
    # M, K, N, K slices, int[3] out (channel blocks, K slices, row groups)
    "tk_int8_matmul_grid": [_I] * 4 + [_P],
    # transpose, dtype code, int[4] out (registers, local bytes, dynamic
    # shared memory, CTAs per SM)
    "tk_int8_matmul_info": [_I, _I, _P],
    # q, k, v, dout, lse, delta, ws, dq, dk, dv, B, S, H, D, scale,
    # mask kind, window, dtype code, output dtype code, stream
    "tk_flash_bwd_fused": [_P] * 10 + [_I] * 4 + [_F, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, B, S, H, D, scale, mask kind,
    # window, dtype code, output dtype code, stream
    "tk_flash_dkv": [_P] * 8 + [_I] * 4 + [_F, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, delta, dq, B, S, H, D, scale, mask kind, window,
    # dtype code, output dtype code, stream
    "tk_flash_dq": [_P] * 7 + [_I] * 4 + [_F, _I, _I, _I, _I, _P],
    # kernel (0 K5, 1 K4, 2 K3), head dim, output dtype code, int[4] out
    # (registers, local bytes, dynamic shared memory, CTAs per SM)
    "tk_flash_bwd_info": [_I, _I, _I, _P],
    # logits (f32 [S, V]), keys (int64), key row stride (0: one shared
    # key, 2: a key a row), offsets (int64 [S] or None), fold (int64
    # [S, 2] or None), out (int64 [S]), scores (f32 [S, V] or None), S, V,
    # stream
    "tk_sample_draw": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P],
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ with the CUDA toolkit's nvcc (PATH or "
                       "CUDA_HOME)")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile ``csrc/*.cu`` (in parallel) and link the shared library;
    a no-op when the stamp matches. Returns the library path."""
    srcs = sources()
    lib_path = _BUILD / _LIB_NAME
    stamp = _BUILD / "stamp"
    digest = _digest(srcs)
    if lib_path.exists() and stamp.exists() \
            and stamp.read_text() == digest:
        return lib_path
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in srcs:
        obj = _BUILD / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = _BUILD / (_LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _src, obj, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.tk_error_string.argtypes = [ctypes.c_int]
            handle.tk_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc:
        msg = lib().tk_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def dtype_code(dtype) -> int:
    """The C side's element-type code: 0 = float32, 1 = bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, got "
                         f"{dtype}")
    return codes[dtype]
