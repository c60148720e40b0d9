# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Persistent warm cache for the serve engine — the port of the
reference's ``models/aotcache.py``: the cold-start half of a fleet's
elastic joins.

A replica's first call pays for work no request asked for: the kernel
library's load (or its ``nvcc`` build), the first use of each kernel and
of cuBLAS, and the CUDA graph captures of the wave, the sampled wave or
the speculative trip. :func:`warm_engine` moves that work onto the
bring-up, in the reference's three stages:

1. **Store** — the engine's warm family is enumerable through
   ``engine.aot_registrations()`` as ``(name, fn, example args)``;
   :func:`warm_engine` probes one crc-framed entry per registration in an
   :class:`AotCompileCache` and, on a miss, calls ``fn()`` — the work a
   bring-up cannot leave to the call path: the library's load, and for
   the wave (the sampled wave, the speculative trip) the capture into the
   engine's pool cache, so the next ``run()`` replays it; every other
   piece's ``fn`` does nothing, its first use is the prime's — and stores
   the entry. A graph capture does not cross processes, so these entries are
   ``mode="traceonly"``, as the reference's are on a backend without
   ``serialize_executable``. One entry carries a binary: the kernel
   library (``kernel_library``, on the card), ``mode="serialized"``, keyed
   by the sources' digest (``ops/_build.library_digest``: the sources and
   ``NVCC_FLAGS``), the ``nvcc`` release and the card's name, and
   validated on every hit by installing and loading it.
2. **The library behind the build** — :meth:`AotCompileCache.activate`
   (the counterpart of pointing ``jax_compilation_cache_dir`` at the
   cache) puts the cache behind ``ops/_build``: process-wide and sticky,
   a build installs a library the cache holds for these sources instead
   of running ``nvcc``, and banks what ``nvcc`` builds. A fresh process
   with an empty build directory loads the kernels in the time of a copy.
3. **Priming** — ``engine.aot_prime`` drives one tiny seeded schedule
   through the engine's real ``run()``, which does every first use the
   registrations do not (each admission length, the chunk and table
   steps, the eager waves before a capture) and captures the graphs an
   earlier hit skipped.

Integrity is the reference's: every entry is ``GAC1``-framed (big-endian
length and crc32 over the pickled body) and stores its full key; a
corrupt, truncated or stale entry is QUARANTINED into
``<path>/quarantine/`` and rebuilt, never served. A ``serialized`` entry
that cannot be validated (a graph's, or a library for other sources) is
quarantined and stored again as ``traceonly`` (a library: rebuilt by
``nvcc`` and stored again), so the store converges. Writes are atomic
through a temporary file of a unique name (``mkstemp`` in the cache
directory) and ``os.replace``: concurrent warmers — threads or processes
— race only to write identical bytes. Keys hash an
:func:`engine_fingerprint` (torch, CUDA, the device's name and count, the
mesh, the config and every engine lever) and the registration's name and
:func:`describe_avals` signature; the port's keys never meet the
reference's (``torch=`` against ``jax=``), but an entry stored under one
key string by either package is probed whole by the other.

Telemetry: ``aot_cache_hit_total`` / ``aot_cache_miss_total`` counters a
registration probe, the ``engine_warmup_ms`` gauge a :func:`warm_engine`,
and ``join_first_token_ms``, which the engine sets at a run's first
prefill (``models/serving.py``).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
import tempfile
import zlib
from typing import Any

import torch

from ..ops import _build
from .burnin import check_device
from .quantize import QTensor

_MAGIC = b"GAC1"
_HEADER = struct.Struct(">II")          # (len(body), crc32(body))
_SUFFIX = ".gac"
# the registration that carries the kernel library (on the card)
KERNEL_LIBRARY = "kernel_library"


class AotCacheCorruptError(RuntimeError):
    """A cache entry failed its magic, crc or key check — a CLASSIFIED
    integrity failure: the entry is quarantined and the caller rebuilds,
    never loads the corrupt entry."""


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _write_atomic(path: str, *chunks: bytes) -> None:
    """Write ``chunks`` to ``path`` through a temporary file of a unique
    name (``mkstemp`` beside it) and ``os.replace``: two writers — two
    cache objects of one process included — never share the temporary
    file, and a reader sees the old file or the new one, whole."""
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as fh:
            for chunk in chunks:
                fh.write(chunk)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _structure(x, parts: list) -> str:
    """The tree's structure with a ``*`` a leaf; each leaf's description
    appended to ``parts``. Dicts go by sorted key, as a pytree's do; a
    ``QTensor`` is a node of its int8 ``q`` and its ``scale``."""
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(x[k], parts)}"
                               for k in sorted(x)) + "}"
    if isinstance(x, list):
        return "[" + ", ".join(_structure(v, parts) for v in x) + "]"
    if isinstance(x, tuple):
        return "(" + "".join(_structure(v, parts) + ", " for v in x) + ")"
    if x is None:
        return "None"
    if isinstance(x, QTensor):
        return (f"QTensor[scale_axis={x.scale_axis}, "
                f"transposed={x.transposed}, dtype={x.dtype}]("
                f"{_structure(x.q, parts)}, {_structure(x.scale, parts)})")
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        dims = "x".join(str(int(d)) for d in shape)
        parts.append(f"{str(dtype).removeprefix('torch.')}[{dims}]")
    else:
        parts.append(repr(x))
    return "*"


def describe_avals(args: Any) -> str:
    """Deterministic abstract signature of a registration's arguments: the
    tree's structure (dicts, lists, tuples, ``QTensor``) plus each leaf's
    ``dtype[shape]`` (anything that is not a tensor — a static string, an
    int — by ``repr``). Two registrations whose signatures differ never
    share an entry: a dtype or geometry change cannot serve a stale one."""
    parts: list[str] = []
    tree = _structure(args, parts)
    return f"{tree}|{';'.join(parts)}"


def engine_fingerprint(cfg, max_len: int, levers: dict, *, mesh=None,
                       device="cuda") -> str:
    """The cache SCOPE: everything outside one registration that changes
    what a bring-up does — the torch and CUDA versions, the device's type,
    name and count, the mesh axes, the model config, ``max_len`` and every
    engine lever (sorted; values must be primitives — ``models/serving``
    turns callables into qualnames and the shared store into a boolean, as
    a ``repr`` carrying an address would split the key across
    processes)."""
    dev = check_device(device)
    if dev.type == "cuda":
        name, count = torch.cuda.get_device_name(dev), \
            torch.cuda.device_count()
    else:
        name, count = dev.type, 1
    if mesh is None:
        mesh_desc = "none"
    else:
        shape = getattr(mesh, "shape", None)
        mesh_desc = (",".join(f"{k}={v}" for k, v in shape.items())
                     if isinstance(shape, dict) else repr(shape))
    lever_desc = ",".join(f"{k}={levers[k]!r}" for k in sorted(levers))
    return (f"gac1|torch={torch.__version__}|cuda={torch.version.cuda}"
            f"|dev={dev.type}:{name}x{count}|mesh={mesh_desc}"
            f"|cfg={cfg!r}|max_len={max_len}|{lever_desc}")


def library_key(digest: str) -> str:
    """The kernel library's key: the sources' digest, the ``nvcc`` release
    and the card's name — never an engine's scope, so every engine of one
    checkout on one kind of card shares it."""
    return (f"gac1|{KERNEL_LIBRARY}|digest={digest}"
            f"|nvcc={_build.nvcc_release()}"
            f"|dev={torch.cuda.get_device_name()}")


class AotCompileCache:
    """One directory of crc-framed warm entries.

    Entry file format: ``GAC1`` magic, big-endian ``(len, crc32)`` header,
    pickled body ``{"key", "mode", "payload"}`` where ``key`` is the FULL
    key (stale and collision detection), ``mode`` is ``"serialized" |
    "traceonly"`` and ``payload`` is None or, for the kernel library,
    ``{"digest", "lib"}`` (the built ``libkernels.so`` bytes). File names
    are the first 24 hex characters of sha256(key).

    The cache pickles down to its path, so a process fleet ships it to its
    children through ``engine_kw`` and every replica shares one store.
    """

    def __init__(self, path: str, *, telemetry=None):
        self.path = str(path)
        self._telemetry = telemetry
        self._active: dict | None = None
        self.installed = 0             # libraries installed by a build
        os.makedirs(self.path, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)

    # picklability: the registry handle and the activation stay behind — a
    # child activates in its own process
    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.__init__(state["path"])

    @property
    def quarantine_dir(self) -> str:
        return os.path.join(self.path, "quarantine")

    # ---- keys -------------------------------------------------------
    def entry_key(self, scope: str, name: str, args: Any) -> str:
        """Full key for one registration: the engine scope, the piece's
        name and the abstract signature of its arguments."""
        return f"{scope}::{name}::{describe_avals(args)}"

    def _entry_path(self, key: str) -> str:
        digest = hashlib.sha256(key.encode()).hexdigest()[:24]
        return os.path.join(self.path, digest + _SUFFIX)

    # ---- entries ----------------------------------------------------
    def probe(self, key: str):
        """The entry body for ``key``, or None. Any integrity failure — bad
        magic, a short read, a crc mismatch, an unpicklable body, or a
        stored key that is not ``key`` — QUARANTINES the file and returns
        None, so the caller rebuilds."""
        path = self._entry_path(key)
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return None
        try:
            body = self._decode(raw, key)
        except AotCacheCorruptError as exc:
            self.quarantine(path, str(exc))
            return None
        return body

    def _decode(self, raw: bytes, key: str) -> dict:
        if raw[:4] != _MAGIC:
            raise AotCacheCorruptError(
                f"bad magic {raw[:4]!r} (want {_MAGIC!r})")
        if len(raw) < 4 + _HEADER.size:
            raise AotCacheCorruptError(
                f"truncated header ({len(raw)} bytes)")
        length, crc = _HEADER.unpack_from(raw, 4)
        body_raw = raw[4 + _HEADER.size:]
        if len(body_raw) != length:
            raise AotCacheCorruptError(
                f"truncated body ({len(body_raw)} of {length} bytes)")
        if _crc32(body_raw) != crc:
            raise AotCacheCorruptError(
                f"crc mismatch ({_crc32(body_raw):#010x} != {crc:#010x})")
        try:
            body = pickle.loads(body_raw)
        except Exception as exc:  # noqa: BLE001 — classified below
            raise AotCacheCorruptError(
                f"body unpicklable: {exc!r}") from exc
        if not isinstance(body, dict) or body.get("key") != key:
            stored = body.get("key") if isinstance(body, dict) else None
            raise AotCacheCorruptError(
                f"stale entry: stored key {str(stored)[:80]!r}… "
                "does not match probe key")
        return body

    def store(self, key: str, mode: str, payload) -> str:
        """Atomically write one entry (:func:`_write_atomic`); returns the
        mode stored (a payload that refuses to pickle degrades the entry to
        trace-only)."""
        body = {"key": key, "mode": mode, "payload": payload}
        try:
            body_raw = pickle.dumps(body, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as exc:  # noqa: BLE001 — degrade, don't fail
            body = {"key": key, "mode": "traceonly", "payload": None,
                    "degraded": repr(exc)}
            body_raw = pickle.dumps(body, protocol=pickle.HIGHEST_PROTOCOL)
        # racers write equal bytes
        _write_atomic(self._entry_path(key), _MAGIC,
                      _HEADER.pack(len(body_raw), _crc32(body_raw)), body_raw)
        return body["mode"]

    def quarantine(self, path: str, reason: str) -> None:
        """Move a corrupt or stale entry aside (never delete: the bytes are
        the postmortem) and remember why."""
        dest = os.path.join(self.quarantine_dir, os.path.basename(path))
        try:
            os.replace(path, dest)
        except FileNotFoundError:
            pass                       # a racer already moved it
        self.quarantine_reasons.append(reason)

    def quarantine_key(self, key: str, reason: str) -> None:
        self.quarantine(self._entry_path(key), reason)

    @property
    def quarantine_reasons(self) -> list:
        reasons = getattr(self, "_quarantine_reasons", None)
        if reasons is None:
            reasons = self._quarantine_reasons = []
        return reasons

    # ---- the kernel library ----------------------------------------
    def library_refusal(self, entry: dict, digest: str) -> str | None:
        """Why a library entry cannot be installed for sources of
        ``digest`` (None: it can)."""
        if entry.get("mode") != "serialized":
            return "library entry carries no binary (traceonly)"
        payload = entry.get("payload")
        if not isinstance(payload, dict) \
                or not isinstance(payload.get("lib"), bytes):
            return "library entry has no library bytes"
        if payload.get("digest") != digest:
            return (f"stale library: built from digest "
                    f"{str(payload.get('digest'))[:16]}…, the sources' is "
                    f"{digest[:16]}…")
        return None

    def install_library(self, digest: str, dest) -> bool:
        """Write the library this cache holds for sources of ``digest`` to
        ``dest`` (a temporary file, then ``os.replace``); False when it
        holds none. A stale or unusable entry is quarantined, never
        installed. Called by ``ops/_build`` under its lock."""
        key = library_key(digest)
        entry = self.probe(key)
        if entry is None:
            return False
        reason = self.library_refusal(entry, digest)
        if reason is not None:
            self.quarantine_key(key, reason)
            return False
        _write_atomic(str(dest), entry["payload"]["lib"])
        self.installed += 1
        return True

    def bank_library(self, digest: str, path) -> str:
        """Store the built library at ``path`` (sources of ``digest``)."""
        with open(path, "rb") as fh:
            lib = fh.read()
        return self.store(library_key(digest), "serialized",
                          {"digest": digest, "lib": lib})

    def refuse_library(self, digest: str, reason: str) -> None:
        """Quarantine the library entry of ``digest`` (it failed to
        load)."""
        self.quarantine_key(library_key(digest), reason)

    # ---- activation -------------------------------------------------
    def activate(self) -> None:
        """Put this cache behind the kernel library's build, process-wide
        (``ops/_build.set_library_cache``). Idempotent; :meth:`deactivate`
        restores the previous setting."""
        if self._active is not None:
            return
        self._active = {"library_cache": _build.set_library_cache(self)}

    def deactivate(self) -> None:
        if self._active is None:
            return
        _build.set_library_cache(self._active["library_cache"])
        self._active = None

    # ---- inspection -------------------------------------------------
    def entries(self) -> list:
        return sorted(f for f in os.listdir(self.path)
                      if f.endswith(_SUFFIX))

    def stats(self) -> dict:
        return {
            "path": self.path,
            "entries": len(self.entries()),
            "quarantined": len([f for f in os.listdir(self.quarantine_dir)
                                if f.endswith(_SUFFIX)]),
            "active": self._active is not None,
        }


def warm_engine(engine, cache: AotCompileCache | None = None, *,
                slots: int = 2, kv_blocks: int | None = None,
                prompt_lens=(), n_new: int = 2, prime: bool = True,
                telemetry=None) -> dict:
    """Warm a serve engine's whole family against ``cache``.

    Stages (see the module docstring): activate the cache behind the
    kernel build, probe every registration and, on a miss, do its first
    use and store its entry (a library hit is validated by installing and
    loading it); then prime the call path through the engine's real
    ``run()`` (``prime=False`` skips it — a bring-up that serves a real
    schedule right after warms itself).

    ``slots`` / ``kv_blocks`` / ``prompt_lens`` must be the geometry the
    engine will serve: the graphs are captured per ``(slots, kv_blocks)``.
    Returns ``registered/hits/misses/serialized/traceonly/demoted/
    quarantined/primed/errors/warm_ms``; a piece whose first use raises is
    recorded in ``errors`` (priming still covers the call path). Without a
    cache it returns ``{"enabled": False, ...}`` and does nothing, so an
    unwarmed engine stays the engine it was."""
    from ..telemetry import get_registry

    reg = telemetry if telemetry is not None else get_registry()
    clk0 = reg.clock()
    if cache is None:
        cache = getattr(engine, "aot_cache", None)
    stats: dict[str, Any] = {
        "enabled": cache is not None, "registered": 0, "hits": 0,
        "misses": 0, "serialized": 0, "traceonly": 0,
        "demoted": 0, "quarantined": 0, "primed": 0, "errors": [],
    }
    if cache is None:
        return stats
    cache.activate()
    q0 = len(cache.quarantine_reasons)
    scope = engine.aot_scope
    c_hit = reg.counter("aot_cache_hit_total")
    c_miss = reg.counter("aot_cache_miss_total")
    regs = engine.aot_registrations(slots=slots, kv_blocks=kv_blocks,
                                    prompt_lens=tuple(prompt_lens),
                                    n_new=n_new)
    for name, fn, args in regs:
        stats["registered"] += 1
        library = name == KERNEL_LIBRARY
        # the library's key is its sources' (args: key, digest), shared by
        # every engine; a piece's is the engine's scope and its signature
        key = args[0] if library else cache.entry_key(scope, name, args)
        entry = cache.probe(key)
        demote = False
        if entry is not None and library:
            reason = cache.library_refusal(entry, args[1])
            if reason is not None:
                cache.quarantine_key(key, reason)
                entry = None
        elif entry is not None and entry["mode"] == "serialized":
            # a capture has no serialised form to validate: rebuild it and
            # store the entry trace-only, so the store converges
            cache.quarantine_key(
                key, "serialized entry for a piece with no serialised "
                "form (graph captures do not cross processes)")
            entry = None
            demote = True
        if entry is not None:
            stats["hits"] += 1
            c_hit.inc()
            if library:
                fn()                   # install and load: the validation
            continue
        stats["misses"] += 1
        c_miss.inc()
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — recorded, prime follows
            stats["errors"].append(f"{name}: {exc!r}")
            continue
        if library:
            path = _build.library_path()
            if path is None:
                stats["errors"].append(f"{name}: no built library for "
                                       f"digest {args[1][:16]}…")
                continue
            stored = cache.bank_library(args[1], path)
        else:
            stored = cache.store(key, "traceonly", None)
        stats[stored] += 1
        if demote:
            stats["demoted"] += 1
    if prime:
        stats["primed"] = int(engine.aot_prime(
            slots=slots, kv_blocks=kv_blocks,
            prompt_lens=tuple(prompt_lens), n_new=n_new))
    stats["quarantined"] = len(cache.quarantine_reasons) - q0
    warm_ms = round((reg.clock() - clk0) * 1e3, 3)
    stats["warm_ms"] = warm_ms
    reg.gauge("engine_warmup_ms").set(warm_ms)
    return stats
