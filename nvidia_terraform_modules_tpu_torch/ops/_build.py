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

``launches`` holds one launch count per kernel: each wrapper adds one,
through :func:`count`, where it launches its kernel, and nowhere else.
:func:`count` is atomic across threads (a fleet's replicas are threads
launching at once); :func:`tally` gives one thread its own counts beside
the process's, and :func:`capture_tally` takes a graph capture's calls
out of them (a capture records kernels, it runs none).

Processes that build at once (a fleet's replica children) take an
``fcntl`` lock on the build directory, so one compiles and the others find
its library.

A warm cache (``models/aotcache.AotCompileCache.activate``) can stand
behind the build, process-wide: :func:`set_library_cache`. Before ``nvcc``
runs, under the same lock and stamp rule, the cache installs a library it
holds for these sources, flags, ``nvcc`` and card; after a build it banks
the new library. A library from the cache is loaded under a name of its
own before it takes the library's place: one that fails to load is refused
to the cache (which quarantines its entry) and the library is built by
``nvcc``, so a refused library's file is never the one later bound.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
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
_count_lock = threading.Lock()
_local = threading.local()
_lib: ctypes.CDLL | None = None
# the warm cache behind the build (None: nvcc only) and where the last
# build's library came from: "stamp" (already built), "cache" or "nvcc"
_library_cache = None
_last_source: str | None = None
_nvcc_release: str | None = None

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
    # strides (q, k, v: b, s, h), scale, mask kind, window, key offset,
    # dtype code, stream
    "tk_flash_partial": [_P] * 6 + [_I] * 6 + [_L] * 9
    + [_F, _I, _I, _I, _I, _P],
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
    # mask kind, window, key offset, dtype code, output dtype code, stream
    "tk_flash_bwd_fused": [_P] * 10 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
    # q, k, v, dout, lse, delta, dk, dv, B, S, H, D, scale, mask kind,
    # window, key offset, dtype code, output dtype code, stream
    "tk_flash_dkv": [_P] * 8 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
    # q, k, v, dout, lse, delta, dq, B, S, H, D, scale, mask kind, window,
    # key offset, dtype code, output dtype code, stream
    "tk_flash_dq": [_P] * 7 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
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
    with _count_lock:
        for name in launches:
            launches[name] = 0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` launches of kernel ``name``: to ``launches`` (under a
    lock) and to each :func:`tally` this thread holds open — or, while this
    thread captures a graph (:func:`capture_tally`), to the capture's tally
    alone."""
    cap = getattr(_local, "capture", None)
    if cap is not None:
        cap[name] = cap.get(name, 0) + n
        return
    with _count_lock:
        launches[name] += n
    for t in getattr(_local, "tallies", ()):
        t[name] = t.get(name, 0) + n


@contextlib.contextmanager
def tally():
    """Yield a dict of the launches this thread makes inside the block,
    kernel by kernel (the process's ``launches`` still count them)."""
    own: dict[str, int] = {}
    stack = _local.__dict__.setdefault("tallies", [])
    stack.append(own)
    try:
        yield own
    finally:
        # by identity: an equal dict of an enclosing tally stays open
        del stack[next(i for i in range(len(stack) - 1, -1, -1)
                       if stack[i] is own)]


@contextlib.contextmanager
def capture_tally():
    """Yield a dict that takes this thread's launch counts while a graph is
    captured, instead of ``launches`` and the open tallies."""
    prev = getattr(_local, "capture", None)
    cap: dict[str, int] = {}
    _local.capture = cap
    try:
        yield cap
    finally:
        _local.capture = prev


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


def library_digest() -> str:
    """The digest of the kernel sources and ``NVCC_FLAGS`` (the stamp)."""
    return _digest(sources())


def nvcc_release() -> str:
    """The ``nvcc --version`` release line (read once a process)."""
    global _nvcc_release
    if _nvcc_release is None:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
        lines = [ln for ln in out.splitlines() if "release" in ln]
        _nvcc_release = (lines or out.splitlines() or ["?"])[-1].strip()
    return _nvcc_release


def library_path() -> Path | None:
    """The built library when its stamp matches the sources, else None."""
    lib_path, stamp = _BUILD / _LIB_NAME, _BUILD / "stamp"
    if lib_path.exists() and stamp.exists() \
            and stamp.read_text() == library_digest():
        return lib_path
    return None


def set_library_cache(cache):
    """Put ``cache`` (an object with ``install_library(digest, dest) →
    bool``, ``bank_library(digest, path)`` and ``refuse_library(digest,
    reason)``; None: none) behind every later build of this process.
    Returns the previous one."""
    global _library_cache
    prev, _library_cache = _library_cache, cache
    return prev


def build() -> Path:
    """Compile ``csrc/*.cu`` (in parallel) and link the shared library;
    a no-op when the stamp matches. Returns the library path. The check
    and the build hold an exclusive ``fcntl`` lock on the build directory,
    so processes that build at once build once. With a warm cache set, a
    library the cache holds for these sources, and that loads with every
    entry point, is installed in place of the build."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_locked()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _install_cached(digest: str, lib_path: Path) -> bool:
    """Install the warm cache's library for ``digest`` at ``lib_path``:
    written to a fresh name and loaded there first, so a library that
    fails to load (not a shared object, an entry point missing) is refused
    to the cache and never takes ``lib_path`` — whose later load must find
    a new file, not the refused one the loader already holds."""
    fd, name = tempfile.mkstemp(dir=_BUILD, prefix=_LIB_NAME + ".cache")
    os.close(fd)
    tmp = Path(name)
    try:
        if not _library_cache.install_library(digest, tmp):
            return False
        try:
            _bind(tmp)
        except (OSError, AttributeError) as exc:
            _library_cache.refuse_library(
                digest, f"library failed to load: {exc!r}")
            return False
        os.replace(tmp, lib_path)
        return True
    finally:
        tmp.unlink(missing_ok=True)


def _build_locked() -> Path:
    global _last_source
    srcs = sources()
    lib_path = _BUILD / _LIB_NAME
    stamp = _BUILD / "stamp"
    digest = _digest(srcs)
    if lib_path.exists() and stamp.exists() \
            and stamp.read_text() == digest:
        _last_source = "stamp"
        return lib_path
    if _library_cache is not None and _install_cached(digest, lib_path):
        stamp.write_text(digest)
        _last_source = "cache"
        return lib_path
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
    _last_source = "nvcc"
    if _library_cache is not None:
        _library_cache.bank_library(digest, lib_path)
    return lib_path


def _bind(path: Path) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.tk_error_string.argtypes = [ctypes.c_int]
    handle.tk_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built, or installed from the warm cache,
    on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(build())
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
