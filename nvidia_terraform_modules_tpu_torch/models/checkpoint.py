# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Durable checkpoint/resume for the burn-in workload — the port of the
reference's ``models/checkpoint.py`` (its local engine), on the same
on-disk format, so a step written by either package restores in the
other.

Why this exists: the ``gke-tpu`` module makes *preemptible* slices a
first-class provisioning option, and a spot node can vanish mid-burn-in —
and mid-**save**. Durability is a property of the commit protocol:

- **atomic commit**: every save writes into a hidden temp directory
  (``.tmp.step_N``), fsyncs data and directory, and publishes with one
  ``os.rename`` — a step directory either exists completely or not at
  all, and ``latest_step()`` cannot see an in-flight write;
- **verified restore**: each committed step carries ``manifest.json``
  with a crc32 for each shard record. A truncated/corrupt/stale step is
  logged, **quarantined** (renamed under ``quarantine/`` with the failure
  reason), and restore falls back to the newest *valid* step. A
  quarantined step is never restored;
- **sharded**: each rank writes only its own pieces of the tree, with
  their global bounds (the pieces ``parallel/sharding.local_shard`` cuts
  under each leaf's spec); restore places each rank's target piece on its
  device;
- **no collectives**: ranks rendezvous through the (shared) checkpoint
  filesystem itself — nonce-stamped part files that rank 0 merges and
  commits. No barrier runs through the process group, so an emergency save
  still commits when a peer is already dead. Every wait is bounded
  (``TPU_CHECKPOINT_SYNC_TIMEOUT_S``) and times out as a classified
  :class:`CheckpointError`, never an indefinite hang;
- **async save**: ``async_save=True`` copies the tensors to the host
  synchronously (into pinned staging buffers, behind the step's work on
  its stream), then writes and commits on a background thread;
  :meth:`Checkpointer.flush` / :meth:`Checkpointer.close` are the commit
  barriers and re-raise any background failure;
- **step-numbered + run-scoped**: the global step survives restarts, and
  a successful run calls :meth:`Checkpointer.clear`;
- **elastic (re-sharding) restore**: the manifest records every shard's
  global bounds, so a step written by a world of N ranks restores into a
  world of M with another placement. Restore streams leaf by leaf: for
  each target piece it reads only the intersecting byte ranges (``seek``
  + ranged read, crc32-checked per record). In a **multi-process** world
  it first verifies every record, so all peers reach the same
  valid/quarantine verdict.

A process is one device here (``parallel/multihost.py``), so a step's
``nprocs`` — :meth:`Checkpointer.stored_world` — counts ranks.

Leaves are named by the strings ``jax.tree_util.keystr`` gives for the
same tree (``['params']['layers'][0]['wq']``), dtypes by numpy's names
(``float32``, ``bfloat16``, ``int32``); a bf16 leaf's raw bytes pass
through an integer view both ways, so no extended-dtype package is
needed. Restore-time reads retry transient I/O with capped exponential
backoff and jitter (``utils/retry.py``) before a step is classified
corrupt.

Remote prefixes (any ``<protocol>://…``: ``gs://``, ``s3://``,
``file://``, ``memory://``): the reference sends them to orbax, which
needs JAX; the port writes the same layout as the local store, file for
file and byte for byte, over an ``fsspec`` filesystem (imported lazily,
at the first read or write — the constructor touches no storage).
Object stores cannot rename a directory, so the remote commit keeps
these invariants instead:

- ``manifest.json`` is written last (through a temporary object moved
  into place) and is the commit point: a step directory without one is
  an unfinished or crashed save, never listed, and removed by a later
  age-gated sweep (each save of process 0, and :meth:`Checkpointer.clear`);
- retention and re-saves delete a step's manifest before its data;
- restore reads each record as a verified byte range (the same retry
  policy, the same quarantine and fall-back to the previous step);
- each rank writes its own ``shards_p*.bin`` and part, and process 0
  merges the parts and writes the manifest after the same bounded
  rendezvous, through the filesystem.

A missing ``fsspec``, or a protocol it cannot load (``gs://`` without
``gcsfs``), raises :class:`CheckpointError` naming the protocol; no path
ever falls back to local storage. A committed step copied to a local
directory restores through either package's local ``Checkpointer``.

On-disk layout of a committed step::

    <root>/step_00000042/
        manifest.json     # step, world size, per-leaf shard records + crc32
        meta.json         # the caller's JSON metadata
        shards_p00000.bin # rank 0's raw shard bytes (one file a rank)
        part_p00000.json  # rank 0's shard records (merged into the manifest)
    <root>/quarantine/
        step_00000041.bad-crc/   # quarantined, never restored
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import logging
import os
import queue
import shutil
import threading
import time
import uuid
import zlib
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..parallel.sharding import ShapeDtypeStruct
from ..utils.retry import RetryPolicy, retry_call
from .burnin import BurnInConfig, abstract_params

log = logging.getLogger(__name__)

_STEP_PREFIX = "step_"
_TMP_PREFIX = ".tmp."
_QUARANTINE = "quarantine"
_MANIFEST = "manifest.json"
_META = "meta.json"
_TOKEN = "token.json"
_FORMAT = 1

# bounded rendezvous: how long a process waits for its peers' part files
# (or the committed step) before failing with a classified error instead
# of hanging — a dead peer must cost one timeout, not the whole job
DEFAULT_SYNC_TIMEOUT_S = 120.0

# restore-time read retries: transient I/O (PVC remount, NFS blip) is
# retried briefly before the step is classified corrupt
_READ_RETRY = RetryPolicy(initial_s=0.1, multiplier=2.0, cap_s=1.0,
                          max_attempts=3, jitter=True)

# threads computing a part's crc32s beside its writes
_CRC_THREADS = min(8, os.cpu_count() or 1)

# numpy's dtype names, the manifest's vocabulary
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


class CheckpointError(Exception):
    """Classified checkpoint-layer failure (rendezvous timeout, missing
    explicit step, unwritable storage)."""


class CorruptCheckpointError(CheckpointError):
    """A specific step failed verification; ``reason`` says how."""

    def __init__(self, step: int, reason: str):
        super().__init__(f"checkpoint step {step} is not restorable: "
                         f"{reason}")
        self.step = step
        self.reason = reason


class MissingStepError(CheckpointError):
    """An explicitly requested step is not in the committed namespace —
    deterministic (retention pruned it or it never existed), so retry
    layers must NOT hammer it like a transient rendezvous failure."""


def _is_remote(directory: str) -> bool:
    return "://" in directory


def _root(directory: str) -> str:
    # os.path.abspath would mangle gs://bucket/x into <cwd>/gs:/bucket/x
    return directory if _is_remote(directory) else os.path.abspath(directory)


def _no_checkpoint_possible(directory: str) -> bool:
    """Cheap local fast-path; never touches (or creates) remote storage
    when the directory plainly doesn't exist yet."""
    return not _is_remote(directory) and not os.path.isdir(directory)


def _step_dirname(step: int) -> str:
    return f"{_STEP_PREFIX}{step:08d}"


def _parse_step(name: str) -> Optional[int]:
    if not name.startswith(_STEP_PREFIX):
        return None
    tail = name[len(_STEP_PREFIX):]
    return int(tail) if tail.isdigit() else None


def _world() -> tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _fsync_dir(path: str) -> None:
    # directory fsync makes the rename itself durable; some filesystems
    # (tmpfs among them) don't support it — durability degrades, the
    # atomicity of the rename does not
    with contextlib.suppress(OSError):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def _age_s(mtime: float) -> float:
    """Seconds since ``mtime``, a storage timestamp in epoch seconds."""
    # graftlint: ignore[graft-wallclock-nondeterminism] — mtime ages
    return time.time() - mtime


def _wait_for(predicate: Callable[[], Any], timeout_s: float, what: str,
              interval_s: float = 0.05):
    """Poll ``predicate`` until truthy; bounded by ``timeout_s``.

    The timeout converts "a peer died mid-save" from an indefinite hang
    into a classified failure the supervisor can act on."""
    t0 = time.monotonic()
    while True:
        value = predicate()
        if value:
            return value
        if time.monotonic() - t0 > timeout_s:
            raise CheckpointError(
                f"checkpoint rendezvous timed out after {timeout_s:.0f}s "
                f"waiting for {what} — a peer process is dead or shared "
                f"storage has stalled")
        time.sleep(interval_s)


def _dtype_name(dtype: torch.dtype) -> str:
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise CheckpointError(f"dtype {dtype} has no checkpoint "
                              f"encoding") from None


def _keystr(key) -> str:
    return f"[{key!r}]"


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a tree of dicts, lists and tuples, in
    ``jax.tree_util``'s order (dict keys sorted), each path as
    ``jax.tree_util.keystr`` writes it."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], prefix + _keystr(k))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + _keystr(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _host_bytes(x: torch.Tensor) -> memoryview:
    """The raw bytes of a contiguous host tensor, without a copy (any
    dtype, bf16 included, through a byte view)."""
    return memoryview(x.reshape(-1).view(torch.uint8).numpy())


def _placement(path: str, x: torch.Tensor,
               placement: Optional[ShapeDtypeStruct]):
    """``(global_shape, bounds)`` of this rank's piece ``x`` of one leaf:
    by ``placement`` (its bounds under the leaf's spec), or the whole leaf
    without one."""
    if placement is None:
        return tuple(x.shape), [[0, d] for d in x.shape]
    bounds = placement.bounds()
    if [b - a for a, b in bounds] != list(x.shape):
        raise CheckpointError(
            f"leaf {path}: this rank holds {tuple(x.shape)}, its placement "
            f"says {[b - a for a, b in bounds]} of {tuple(placement.shape)}")
    return tuple(placement.shape), bounds


# --------------------------------------------------------------- local store


class _LocalStore:
    """The durable local engine: commit protocol, verification,
    quarantine, retention. One instance per :class:`Checkpointer`.

    ``last_commit`` holds the seconds and bytes of this process's latest
    commit: ``write_s`` (the shard file's writes), ``crc_s`` (until the
    last record's crc32, computed beside the writes), ``fsync_s`` (the
    file's fsync), ``commit_s`` (the whole :meth:`save`: rendezvous,
    manifest, rename and retention included) and ``bytes``."""

    def __init__(self, root: str, max_to_keep: int,
                 sync_timeout_s: Optional[float] = None):
        self.root = root
        self.max_to_keep = max_to_keep
        self.sync_timeout_s = sync_timeout_s if sync_timeout_s is not None \
            else float(os.environ.get("TPU_CHECKPOINT_SYNC_TIMEOUT_S",
                                      DEFAULT_SYNC_TIMEOUT_S))
        self.last_commit: dict[str, float] = {}

    # ---- listing ----------------------------------------------------
    def committed_steps(self) -> list[int]:
        """Steps with a published directory AND a readable manifest —
        the commit marker. (A partial directory cannot appear here: the
        rename publishes manifest and data together.)"""
        if not os.path.isdir(self.root):
            return []
        steps = []
        for name in os.listdir(self.root):
            step = _parse_step(name)
            if step is None:
                continue
            if os.path.isfile(os.path.join(self.root, name, _MANIFEST)):
                steps.append(step)
        return sorted(steps)

    def quarantined(self) -> list[str]:
        qdir = os.path.join(self.root, _QUARANTINE)
        if not os.path.isdir(qdir):
            return []
        return sorted(os.listdir(qdir))

    # ---- save -------------------------------------------------------
    def save(self, step: int, snapshot, meta: dict) -> None:
        """Commit one step from a host-side ``snapshot`` (the list
        :meth:`Checkpointer._snapshot` builds).

        Single-writer protocol per process; rank 0 is the committer.
        All cross-process coordination is file-based and bounded.
        """
        t0 = time.perf_counter()
        pid, nprocs = _world()
        os.makedirs(self.root, exist_ok=True)
        tmp = os.path.join(self.root, f"{_TMP_PREFIX}{_step_dirname(step)}")
        token_path = os.path.join(tmp, _TOKEN)

        if pid == 0:
            # fresh attempt: sweep any leftover from a crashed writer so
            # stale parts can never be merged into this commit
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            nonce = uuid.uuid4().hex
            _atomic_write_json(token_path, {"nonce": nonce, "step": step,
                                            "nprocs": nprocs})
        else:
            nonce = _wait_for(
                lambda: _read_json_or_none(token_path, key="nonce"),
                self.sync_timeout_s,
                f"the save token of step {step} from process 0")

        stats = self._write_part(tmp, step, pid, nonce, snapshot)

        final = os.path.join(self.root, _step_dirname(step))
        if pid == 0:
            parts = _wait_for(
                lambda: self._all_parts(tmp, nonce, nprocs),
                self.sync_timeout_s,
                f"{nprocs} shard part file(s) of step {step}")
            manifest = {
                "format": _FORMAT,
                "step": step,
                "nprocs": nprocs,
                "leaves": _merge_parts(parts),
            }
            _atomic_write_json(os.path.join(tmp, _META), dict(meta or {}))
            _atomic_write_json(os.path.join(tmp, _MANIFEST), manifest)
            os.remove(token_path)
            _fsync_dir(tmp)
            if os.path.isdir(final):
                # re-saving an existing step replaces it: demote the old
                # directory out of the committed namespace first so no
                # reader ever sees a half-replaced step
                doomed = os.path.join(
                    self.root, f"{_TMP_PREFIX}rm.{uuid.uuid4().hex}")
                os.rename(final, doomed)
                shutil.rmtree(doomed, ignore_errors=True)
            os.rename(tmp, final)
            _fsync_dir(self.root)
            self._enforce_retention()
        else:
            def committed_or_token_changed():
                if os.path.isfile(os.path.join(final, _MANIFEST)):
                    return "committed"
                current = _read_json_or_none(token_path, key="nonce")
                if current is not None and current != nonce:
                    return "restarted"
                return None

            outcome = _wait_for(
                committed_or_token_changed, self.sync_timeout_s,
                f"process 0 to commit step {step}")
            if outcome == "restarted":
                # process 0 started a fresh attempt (it swept our part):
                # rejoin it once — self-heals the crashed-writer leftover
                # race where this process wrote against a stale token
                self.save(step, snapshot, meta)
                return
        self.last_commit = {**stats, "commit_s": time.perf_counter() - t0}

    def _write_part(self, tmp: str, step: int, pid: int, nonce: str,
                    snapshot) -> dict[str, float]:
        """This rank's shard file and part record. The records' crc32s run
        on a thread pool while the file is written (``zlib.crc32``
        releases the interpreter lock): ``crc_s`` is the wall time until
        the last crc32 is done, ``write_s`` that of the writes."""
        shard_file = f"shards_p{pid:05d}.bin"
        pieces = _pieces(snapshot)
        with open(os.path.join(tmp, shard_file), "wb") as fh:
            crcs, stats = _write_shards(fh, pieces)
            fh.flush()
            t = time.perf_counter()
            os.fsync(fh.fileno())
            stats["fsync_s"] = time.perf_counter() - t
        records = _records(pieces, crcs, shard_file)
        _atomic_write_json(
            os.path.join(tmp, f"part_p{pid:05d}.json"),
            {"nonce": nonce, "step": step, "process": pid,
             "records": records})
        return {**stats, "bytes": float(sum(r["nbytes"] for r in records))}

    @staticmethod
    def _all_parts(tmp: str, nonce: str, nprocs: int):
        parts = []
        for k in range(nprocs):
            data = _read_json_or_none(
                os.path.join(tmp, f"part_p{k:05d}.json"))
            if data is None or data.get("nonce") != nonce:
                return None
            parts.append(data)
        return parts

    def _enforce_retention(self) -> None:
        steps = self.committed_steps()
        for old in steps[:-self.max_to_keep] if self.max_to_keep else []:
            self._remove_step(old)

    def _remove_step(self, step: int) -> None:
        path = os.path.join(self.root, _step_dirname(step))
        if not os.path.isdir(path):
            return
        # demote out of the committed namespace before deleting so a
        # crash mid-rmtree can never leave a half-deleted "committed" dir
        doomed = os.path.join(self.root,
                              f"{_TMP_PREFIX}rm.{uuid.uuid4().hex}")
        with contextlib.suppress(FileNotFoundError):
            os.rename(path, doomed)
            shutil.rmtree(doomed, ignore_errors=True)

    # ---- verify / quarantine ---------------------------------------
    def read_manifest(self, step: int) -> tuple[dict, dict]:
        """Read + header-verify one committed step's ``(meta, manifest)``.

        Shard *data* is deliberately not read here — the streaming
        restore pulls only the byte ranges the target placement needs
        (see :class:`_RecordReader`). Raises
        :class:`CorruptCheckpointError` on an unreadable or mismatched
        manifest.
        """
        stepdir = os.path.join(self.root, _step_dirname(step))

        def read(path):
            def once():
                with open(path, "rb") as fh:
                    return fh.read()

            return retry_call(once, policy=_READ_RETRY,
                              what=f"read {os.path.basename(path)}",
                              retryable=(OSError,))

        try:
            manifest = json.loads(read(os.path.join(stepdir, _MANIFEST)))
            meta = json.loads(read(os.path.join(stepdir, _META)))
        except Exception as exc:  # noqa: BLE001 — classified below
            raise CorruptCheckpointError(
                step, f"unreadable manifest/meta ({exc})") from exc
        return meta, _checked_manifest(step, manifest)

    def record_reader(self, step: int) -> "_RecordReader":
        return _RecordReader(
            os.path.join(self.root, _step_dirname(step)), step)

    def quarantine(self, step: int, reason: str) -> None:
        """Move a failed step out of the committed namespace for good.

        The renamed directory keeps the bytes (post-mortem evidence) but
        can never be listed or restored again. Multi-process safe: the
        first process to rename wins, the rest observe ENOENT and move
        on — every process still falls back to the same next step.
        """
        src = os.path.join(self.root, _step_dirname(step))
        qdir = os.path.join(self.root, _QUARANTINE)
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, _quarantine_name(step, reason))
        if os.path.exists(dst):
            dst = f"{dst}.{uuid.uuid4().hex[:8]}"
        with contextlib.suppress(FileNotFoundError):
            os.rename(src, dst)
            log.warning(
                "quarantined checkpoint step %d -> %s (%s)", step,
                os.path.relpath(dst, self.root), reason)

    def sweep_stale_tmp(self, min_age_s: float = 3600.0) -> None:
        """Remove crashed writers' leftovers (old ``.tmp.*`` dirs) —
        age-gated so an in-flight save on a peer is never swept."""
        if not os.path.isdir(self.root):
            return
        for name in os.listdir(self.root):
            if not name.startswith(_TMP_PREFIX):
                continue
            path = os.path.join(self.root, name)
            with contextlib.suppress(OSError):
                if _age_s(os.path.getmtime(path)) >= min_age_s:
                    shutil.rmtree(path, ignore_errors=True)

    # ---- the clear rendezvous's files --------------------------------
    def put_json(self, rel: str, payload: dict) -> None:
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write_json(path, payload)

    def isfile(self, rel: str) -> bool:
        return os.path.isfile(os.path.join(self.root, rel))

    def isdir(self, rel: str) -> bool:
        return os.path.isdir(os.path.join(self.root, rel))

    def rmtree(self, rel: str) -> None:
        shutil.rmtree(os.path.join(self.root, rel), ignore_errors=True)


def _pieces(snapshot) -> list[tuple]:
    """``(path, shape, dtype, bounds, raw bytes)`` of each piece of a
    snapshot, in the shard file's order."""
    return [(path, shape, dtype, bounds, _host_bytes(host))
            for path, (shape, dtype, shards) in snapshot
            for bounds, host in shards]


def _write_shards(fh, pieces) -> tuple[list[int], dict[str, float]]:
    """Write the pieces to ``fh`` while their crc32s run on a thread pool
    (``zlib.crc32`` releases the interpreter lock): the crcs, and
    ``write_s`` (the writes) and ``crc_s`` (until the last crc)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(_CRC_THREADS) as pool:
        futures = [pool.submit(zlib.crc32, raw) for *_, raw in pieces]
        for *_, raw in pieces:
            fh.write(raw)
        write_s = time.perf_counter() - t0
        crcs = [f.result() & 0xFFFFFFFF for f in futures]
    return crcs, {"write_s": write_s, "crc_s": time.perf_counter() - t0}


def _records(pieces, crcs, shard_file: str) -> list[dict]:
    """The manifest records of one shard file's pieces."""
    records, offset = [], 0
    for (path, shape, dtype, bounds, raw), crc in zip(pieces, crcs):
        records.append({
            "path": path,
            "shape": list(shape),
            "dtype": dtype,
            "bounds": bounds,
            "file": shard_file,
            "offset": offset,
            "nbytes": raw.nbytes,
            "crc32": crc,
        })
        offset += raw.nbytes
    return records


def _checked_manifest(step: int, manifest: dict) -> dict:
    if manifest.get("format") != _FORMAT or manifest.get("step") != step:
        raise CorruptCheckpointError(
            step, f"manifest format/step mismatch "
                  f"(format={manifest.get('format')}, "
                  f"step={manifest.get('step')})")
    return manifest


def _quarantine_name(step: int, reason: str) -> str:
    slug = "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in reason.split("(")[0].strip())[:48].rstrip("-")
    return f"{_step_dirname(step)}.{slug or 'bad'}"


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _read_json_or_none(path: str, key: Optional[str] = None):
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    return data.get(key) if key is not None else data


def _merge_parts(parts: list[dict]) -> list[dict]:
    records = []
    for part in parts:
        records.extend(part["records"])
    return records


# ------------------------------------------- streaming (elastic) assembly


class _RecordReader:
    """Ranged, verified reads of individual shard records.

    The elastic restore path's I/O layer: one persistent handle per shard
    file, ``seek`` + ranged read per record (retried via ``_READ_RETRY``),
    length- and crc32-checked so corruption classifies per record — a
    rank restoring into an M-rank world reads only the byte ranges its
    own target pieces intersect, never whole files.
    """

    def __init__(self, stepdir: str, step: int):
        self.stepdir = stepdir
        self.step = step
        self._handles: dict[str, Any] = {}

    def _ranged(self, rec: dict) -> tuple[Any, int]:
        """One record's bytes and how many arrived (retried; raises
        :class:`CorruptCheckpointError` once the retries are spent)."""
        fname = rec["file"]
        fh = self._handles.get(fname)
        if fh is None:
            try:
                fh = retry_call(
                    lambda: open(os.path.join(self.stepdir, fname), "rb"),
                    policy=_READ_RETRY, what=f"open {fname}",
                    retryable=(OSError,))
            except Exception as exc:  # noqa: BLE001 — classified
                raise CorruptCheckpointError(
                    self.step, f"missing/unreadable shard file {fname} "
                               f"({exc})") from exc
            self._handles[fname] = fh

        buf = bytearray(rec["nbytes"])

        def ranged():
            fh.seek(rec["offset"])
            return fh.readinto(buf)

        try:
            got = retry_call(
                ranged, policy=_READ_RETRY,
                what=f"read {fname}[{rec['offset']}:+{rec['nbytes']}]",
                retryable=(OSError,))
        except Exception as exc:  # noqa: BLE001 — classified: a ranged
            # read that stays broken past the retry budget (bad block,
            # vanished mount) must quarantine-and-fall-back like any
            # other unreadable shard, not crash the restore attempt
            raise CorruptCheckpointError(
                self.step, f"unreadable shard range "
                           f"{fname}[{rec['offset']}:+{rec['nbytes']}] "
                           f"for {rec['path']} ({exc})") from exc
        return buf, got

    def close(self) -> None:
        for fh in self._handles.values():
            with contextlib.suppress(OSError):
                fh.close()
        self._handles.clear()

    def __enter__(self) -> "_RecordReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def read(self, rec: dict) -> torch.Tensor:
        """One record as a host tensor of its piece's shape (checked)."""
        fname = rec["file"]
        buf, got = self._ranged(rec)
        if got != rec["nbytes"]:
            raise CorruptCheckpointError(
                self.step, f"shard file {fname} truncated at offset "
                           f"{rec['offset']} (wanted {rec['nbytes']} bytes "
                           f"for {rec['path']})")
        if (zlib.crc32(buf) & 0xFFFFFFFF) != rec["crc32"]:
            raise CorruptCheckpointError(
                self.step, f"crc32 mismatch in {fname} for {rec['path']} "
                           f"{rec['bounds']}")
        extents = [b - a for a, b in rec["bounds"]]
        dtype = _DTYPES[rec["dtype"]]
        if not buf:
            return torch.empty(extents, dtype=dtype)
        return torch.frombuffer(buf, dtype=torch.uint8).view(
            dtype).reshape(extents)


def _intersect_bounds(a, b) -> Optional[list[tuple[int, int]]]:
    """Per-dim overlap of two explicit bounds lists, or None if disjoint."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return out


def _volume(bounds) -> int:
    n = 1
    for a, b in bounds:
        n *= b - a
    return n


def _unique_records(path: str, abstract: ShapeDtypeStruct, records,
                    step: int) -> list[dict]:
    """Validate a leaf's manifest records against the run's expectation
    and reduce them to one record per distinct shard bounds.

    Replicated leaves are stored once per *writing* rank — identical
    bounds in different part files — so dedup keeps the first copy (the
    rest are never read). Coverage is judged by arithmetic before any
    data I/O: the unique bounds of a placement partition the leaf, so
    their volumes must sum to the leaf exactly — short means a writer died
    before its part was recorded, long means overlapping records.
    """
    shape = tuple(abstract.shape)
    stored_shapes = {tuple(rec["shape"]) for rec in records}
    if stored_shapes != {shape}:
        raise CorruptCheckpointError(
            step, f"stale checkpoint: leaf {path} has shape "
                  f"{sorted(stored_shapes)} on disk but the run expects "
                  f"{shape}")
    want = _dtype_name(abstract.dtype)
    stored_dtypes = {rec["dtype"] for rec in records}
    if stored_dtypes != {want}:
        raise CorruptCheckpointError(
            step, f"stale checkpoint: leaf {path} stored as "
                  f"{sorted(stored_dtypes)}, run expects {want}")
    unique: dict[tuple, dict] = {}
    for rec in records:
        unique.setdefault(tuple(map(tuple, rec["bounds"])), rec)
    volume = sum(_volume(rec["bounds"]) for rec in unique.values())
    size = _volume([(0, d) for d in shape])
    if volume != size:
        raise CorruptCheckpointError(
            step, f"partial checkpoint: leaf {path} shard records cover "
                  f"{volume} of {size} elements (a writer died before "
                  f"its part was recorded, or records overlap)")
    return list(unique.values())


def _assemble_leaf(path: str, abstract: ShapeDtypeStruct, records,
                   step: int, reader: _RecordReader) -> torch.Tensor:
    """This rank's piece of one leaf, streamed from its shard records and
    placed on ``abstract.device``.

    The re-sharding core: the stored bounds partition the leaf along the
    *writing* world's placement, the target bounds along the *restoring*
    world's — generally neither a refinement of the other. The target
    piece is assembled from the intersecting records only, each read as
    a verified byte range, so peak host memory stays at one leaf's piece.
    """
    unique = _unique_records(path, abstract, records, step)
    bounds = abstract.bounds()
    key = tuple(map(tuple, bounds))
    out = None
    filled = 0
    for rec in unique:
        inter = _intersect_bounds(rec["bounds"], bounds)
        if inter is None:
            continue
        arr = reader.read(rec)
        if tuple(map(tuple, rec["bounds"])) == key:
            out, filled = arr, arr.numel()
            break
        if out is None:
            out = torch.empty([b - a for a, b in bounds], dtype=arr.dtype)
        dst = tuple(slice(lo - t0, hi - t0)
                    for (lo, hi), (t0, _t1) in zip(inter, bounds))
        src = tuple(slice(lo - r0, hi - r0)
                    for (lo, hi), (r0, _r1) in zip(inter, rec["bounds"]))
        out[dst] = arr[src]
        filled += _volume(inter)
    size = _volume(bounds)
    if out is None or filled != size:
        raise CorruptCheckpointError(
            step, f"partial checkpoint: leaf {path} target piece {key} "
                  f"assembled {filled} of {size} elements")
    return out.to(abstract.device)


# -------------------------------------------------------------- remote store


def _filesystem(url: str):
    """``(filesystem, root path)`` of a ``<protocol>://`` URL through
    ``fsspec``; a missing package or a protocol it cannot load is a
    :class:`CheckpointError` naming the protocol."""
    protocol = url.split("://", 1)[0]
    try:
        from fsspec.core import url_to_fs

        fs, root = url_to_fs(url)
    except (ImportError, ValueError) as exc:
        raise CheckpointError(
            f"checkpoint directory {url!r}: no filesystem for the "
            f"{protocol}:// protocol ({type(exc).__name__}: {exc}) — the "
            f"remote backend needs fsspec and the protocol's package; "
            f"nothing falls back to a local path") from exc
    return fs, root.rstrip("/")


def _join(*parts: str) -> str:
    return "/".join(parts)


def _basename(path: str) -> str:
    return path.rstrip("/").rsplit("/", 1)[-1]


class _RemoteStore:
    """The local store's commit protocol and layout over an ``fsspec``
    filesystem (module docstring): no directory rename, the manifest the
    commit point. The filesystem is resolved at the first operation.

    ``last_commit`` as the local store's, with ``fsync_s`` the shard
    file's close (the write's durability point on an object store)."""

    def __init__(self, url: str, max_to_keep: int,
                 sync_timeout_s: Optional[float] = None):
        self.url = url
        self.max_to_keep = max_to_keep
        self.sync_timeout_s = sync_timeout_s if sync_timeout_s is not None \
            else float(os.environ.get("TPU_CHECKPOINT_SYNC_TIMEOUT_S",
                                      DEFAULT_SYNC_TIMEOUT_S))
        self.last_commit: dict[str, float] = {}
        self._fs = None
        self._root = ""

    @property
    def fs(self):
        if self._fs is None:
            self._fs, self._root = _filesystem(self.url)
        return self._fs

    @property
    def root(self) -> str:
        _ = self.fs
        return self._root

    def _path(self, *rel: str) -> str:
        return _join(self.root, *rel)

    def _names(self, rel: str = "") -> list[str]:
        try:
            entries = self.fs.ls(self._path(rel) if rel else self.root,
                                 detail=False)
        except FileNotFoundError:
            return []
        return sorted(_basename(e) for e in entries)

    def _exists(self, *rel: str) -> bool:
        return self.fs.exists(self._path(*rel))

    def _put(self, data: bytes, *rel: str) -> None:
        """``data`` at ``rel``, whole or not at all: written to a
        temporary name, then moved into place."""
        path = self._path(*rel)
        tmp = f"{path}{_TMP_PREFIX}{uuid.uuid4().hex[:8]}"
        with self.fs.open(tmp, "wb") as fh:
            fh.write(data)
        self.fs.mv(tmp, path)

    def _put_json(self, payload: dict, *rel: str) -> None:
        self._put(json.dumps(payload).encode(), *rel)

    def _get_json(self, *rel: str, key: Optional[str] = None):
        try:
            data = json.loads(self.fs.cat_file(self._path(*rel)))
        except (OSError, ValueError):
            return None
        return data.get(key) if key is not None else data

    # ---- listing ----------------------------------------------------
    def committed_steps(self) -> list[int]:
        """Steps whose manifest exists — the commit marker."""
        return sorted(step for name in self._names()
                      if (step := _parse_step(name)) is not None
                      and self._exists(name, _MANIFEST))

    def quarantined(self) -> list[str]:
        return self._names(_QUARANTINE)

    # ---- save -------------------------------------------------------
    def save(self, step: int, snapshot, meta: dict) -> None:
        """Commit one step (the local store's :meth:`_LocalStore.save`,
        with the manifest as the commit point). Process 0 first removes
        an earlier copy of the step (its manifest first) and sweeps
        crashed saves older than an hour, then writes the step's token;
        the others write against it."""
        t0 = time.perf_counter()
        pid, nprocs = _world()
        name = _step_dirname(step)
        if pid == 0:
            self.sweep_stale_tmp()
            self._remove_step(step)
            self.fs.makedirs(self._path(name), exist_ok=True)
            nonce = uuid.uuid4().hex
            self._put_json({"nonce": nonce, "step": step, "nprocs": nprocs},
                           name, _TOKEN)
        else:
            nonce = _wait_for(
                lambda: self._get_json(name, _TOKEN, key="nonce"),
                self.sync_timeout_s,
                f"the save token of step {step} from process 0")

        stats = self._write_part(name, step, pid, nonce, snapshot)

        if pid == 0:
            parts = _wait_for(
                lambda: self._all_parts(name, nonce, nprocs),
                self.sync_timeout_s,
                f"{nprocs} shard part file(s) of step {step}")
            manifest = {
                "format": _FORMAT,
                "step": step,
                "nprocs": nprocs,
                "leaves": _merge_parts(parts),
            }
            self._put_json(dict(meta or {}), name, _META)
            self.fs.rm(self._path(name, _TOKEN))
            self._put_json(manifest, name, _MANIFEST)      # the commit
            self._enforce_retention()
        else:
            def committed_or_token_changed():
                current = self._get_json(name, _TOKEN, key="nonce")
                if current is not None and current != nonce:
                    return "restarted"
                if current is None and self._exists(name, _MANIFEST):
                    return "committed"
                return None

            outcome = _wait_for(
                committed_or_token_changed, self.sync_timeout_s,
                f"process 0 to commit step {step}")
            if outcome == "restarted":
                self.save(step, snapshot, meta)
                return
        self.last_commit = {**stats, "commit_s": time.perf_counter() - t0}

    def _write_part(self, name: str, step: int, pid: int, nonce: str,
                    snapshot) -> dict[str, float]:
        """This rank's shard file and part record, as the local store
        writes them (crc32s on a thread pool beside the writes)."""
        shard_file = f"shards_p{pid:05d}.bin"
        pieces = _pieces(snapshot)
        fh = self.fs.open(self._path(name, shard_file), "wb")
        try:
            crcs, stats = _write_shards(fh, pieces)
        finally:
            t = time.perf_counter()
            fh.close()
            close_s = time.perf_counter() - t
        records = _records(pieces, crcs, shard_file)
        self._put_json({"nonce": nonce, "step": step, "process": pid,
                        "records": records}, name, f"part_p{pid:05d}.json")
        return {**stats, "fsync_s": close_s,
                "bytes": float(sum(r["nbytes"] for r in records))}

    def _all_parts(self, name: str, nonce: str, nprocs: int):
        parts = []
        for k in range(nprocs):
            data = self._get_json(name, f"part_p{k:05d}.json")
            if data is None or data.get("nonce") != nonce:
                return None
            parts.append(data)
        return parts

    _enforce_retention = _LocalStore._enforce_retention

    def _remove_step(self, step: int) -> None:
        """The manifest first (the step leaves the committed namespace),
        then its data."""
        name = _step_dirname(step)
        with contextlib.suppress(FileNotFoundError):
            self.fs.rm(self._path(name, _MANIFEST))
        self.rmtree(name)

    # ---- verify / quarantine ---------------------------------------
    def read_manifest(self, step: int) -> tuple[dict, dict]:
        """As :meth:`_LocalStore.read_manifest`."""
        name = _step_dirname(step)

        def read(fname):
            return retry_call(lambda: self.fs.cat_file(self._path(name,
                                                                  fname)),
                              policy=_READ_RETRY, what=f"read {fname}",
                              retryable=(OSError,))

        try:
            manifest = json.loads(read(_MANIFEST))
            meta = json.loads(read(_META))
        except Exception as exc:  # noqa: BLE001 — classified below
            raise CorruptCheckpointError(
                step, f"unreadable manifest/meta ({exc})") from exc
        return meta, _checked_manifest(step, manifest)

    def record_reader(self, step: int) -> "_RemoteRecordReader":
        return _RemoteRecordReader(self.fs, self._path(_step_dirname(step)),
                                   step)

    def quarantine(self, step: int, reason: str) -> None:
        """The step's files copied under ``quarantine/`` (the evidence),
        then its manifest and data deleted. Process 0 moves it; the
        others, which reached the same verdict, fall back without it."""
        if _world()[0] != 0:
            return
        name = _step_dirname(step)
        dst = _quarantine_name(step, reason)
        if dst in self.quarantined():
            dst = f"{dst}.{uuid.uuid4().hex[:8]}"
        self.fs.makedirs(self._path(_QUARANTINE, dst), exist_ok=True)
        for fname in self._names(name):
            with contextlib.suppress(FileNotFoundError):
                self.fs.copy(self._path(name, fname),
                             self._path(_QUARANTINE, dst, fname))
        self._remove_step(step)
        log.warning("quarantined checkpoint step %d -> %s/%s (%s)", step,
                    _QUARANTINE, dst, reason)

    def _mtime(self, rel: str) -> Optional[float]:
        """The newest modification time under ``rel``, in epoch seconds;
        None when the filesystem does not keep one."""
        try:
            paths = self.fs.find(self._path(rel)) or [self._path(rel)]
            return max(self.fs.modified(p).timestamp() for p in paths)
        except (OSError, NotImplementedError):
            return None

    def sweep_stale_tmp(self, min_age_s: float = 3600.0) -> None:
        """Remove crashed saves — step directories without a manifest —
        and leftover temporaries, age-gated (by the newest file in each)
        so a save in flight on a peer is never swept."""
        for name in self._names():
            step = _parse_step(name)
            stale = name.startswith(_TMP_PREFIX) or (
                step is not None and not self._exists(name, _MANIFEST))
            if not stale:
                continue
            if min_age_s > 0:
                mtime = self._mtime(name)
                if mtime is None or _age_s(mtime) < min_age_s:
                    continue
            self.rmtree(name)

    # ---- the clear rendezvous's files --------------------------------
    def put_json(self, rel: str, payload: dict) -> None:
        self.fs.makedirs(self._path(rel.rsplit("/", 1)[0]), exist_ok=True)
        self._put_json(payload, rel)

    def isfile(self, rel: str) -> bool:
        return self.fs.isfile(self._path(rel))

    def isdir(self, rel: str) -> bool:
        return self.fs.isdir(self._path(rel))

    def rmtree(self, rel: str) -> None:
        with contextlib.suppress(FileNotFoundError):
            self.fs.rm(self._path(rel), recursive=True)


class _RemoteRecordReader(_RecordReader):
    """:class:`_RecordReader` over a filesystem: each record one ranged
    read (``cat_file`` of its byte range), retried, then length- and
    crc32-checked as the local reads are."""

    def __init__(self, fs, stepdir: str, step: int):
        super().__init__(stepdir, step)
        self._fs = fs

    def _ranged(self, rec: dict) -> tuple[Any, int]:
        fname, start = rec["file"], rec["offset"]
        try:
            buf = retry_call(
                lambda: self._fs.cat_file(_join(self.stepdir, fname),
                                          start=start,
                                          end=start + rec["nbytes"]),
                policy=_READ_RETRY,
                what=f"read {fname}[{start}:+{rec['nbytes']}]",
                retryable=(OSError,))
        except Exception as exc:  # noqa: BLE001 — classified, as local
            raise CorruptCheckpointError(
                self.step, f"unreadable shard range "
                           f"{fname}[{start}:+{rec['nbytes']}] "
                           f"for {rec['path']} ({exc})") from exc
        return bytearray(buf), len(buf)


# ------------------------------------------------------------ async writer


class _AsyncWriter:
    """One background thread draining a queue of commit jobs.

    ``save`` snapshots the tensors on the caller's thread (training may
    write them right after) and enqueues only host-side I/O. The first
    failure is stored and re-raised at the next ``save``/``flush``/
    ``close`` — an async save must never fail silently."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="checkpoint-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                if self._error is None:
                    job()
            except BaseException as exc:  # noqa: BLE001 — re-raised at flush
                self._error = exc
            finally:
                # drop the job's snapshot before waiting for the next one
                job = None
                self._q.task_done()

    def submit(self, job: Callable[[], None]) -> None:
        self.raise_pending()
        self._q.put(job)

    def flush(self) -> None:
        self._q.join()
        self.raise_pending()

    def raise_pending(self) -> None:
        if self._error is not None:
            exc, self._error = self._error, None
            raise CheckpointError(
                f"a background checkpoint save failed: "
                f"{type(exc).__name__}: {exc}") from exc

    def close(self) -> None:
        self._q.put(None)
        self._q.join()
        self._thread.join(timeout=30)
        self.raise_pending()


# -------------------------------------------------------------- the fronts


class Checkpointer:
    """One durable checkpoint store for a whole run.

    Use as a context manager or call :meth:`close`; the run loop holds ONE
    instance (per-save construction would re-scan the directory every
    step).

    Where a save's leaves sit in the global tree: ``save(layout=)`` takes
    a tree of :class:`..parallel.sharding.ShapeDtypeStruct` records (what
    ``restore_tree`` takes), by default the one this checkpointer last
    restored into — a run restores (or finds nothing) before its first
    save. Without one, each tensor is its whole leaf, which a world of one
    rank always satisfies; a larger world without a layout raises.
    """

    def __init__(self, directory: str, max_to_keep: int = 2,
                 async_save: bool = False,
                 sync_timeout_s: Optional[float] = None,
                 telemetry=None):
        """``async_save=True`` makes :meth:`save` return once the tensors
        are copied to the host, with serialization and the atomic commit
        running behind the next training steps. The commit point moves to
        :meth:`flush` / :meth:`close` / the next read. The smoke-test Job
        keeps the blocking default: it may be preempted right after a
        step, and an uncommitted async write racing pod teardown would
        lose the step."""
        self.directory = directory
        self._max_to_keep = max_to_keep
        self._async = async_save
        # explicit injection wins; otherwise the process registry (the
        # NULL no-op unless TPU_TELEMETRY_DIR enabled it)
        self._telemetry = telemetry
        self._writer: Optional[_AsyncWriter] = None
        self._layout = None
        # pinned host copies of device leaves, by path, reused by saves
        self._staging: dict[str, torch.Tensor] = {}
        # a remote URL's store resolves its filesystem at the first
        # read or write: constructing touches no storage
        self._store = (_RemoteStore if _is_remote(directory)
                       else _LocalStore)(_root(directory), max_to_keep,
                                         sync_timeout_s)

    @property
    def _reg(self):
        if self._telemetry is not None:
            return self._telemetry
        from ..telemetry import get_registry

        return get_registry()

    @property
    def last_commit(self) -> dict[str, float]:
        """The seconds and bytes of this process's latest commit (the
        store's ``last_commit``); read it after :meth:`flush`."""
        return dict(self._store.last_commit)

    # ---- lifecycle --------------------------------------------------
    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Commit any in-flight async save, then tear down — a close
        that dropped a scheduled write would silently lose the run's
        last step."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def flush(self) -> None:
        """Block until every scheduled (async) save has committed."""
        if self._writer is not None:
            self._writer.flush()

    # ---- listing ----------------------------------------------------
    def latest_step(self) -> Optional[int]:
        self.flush()   # reads must not miss a scheduled-but-uncommitted save
        if _no_checkpoint_possible(self.directory):
            return None
        steps = self._store.committed_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        self.flush()
        if _no_checkpoint_possible(self.directory):
            return []
        return self._store.committed_steps()

    def quarantined(self) -> list[str]:
        """Quarantined step directory names (never restorable), a remote
        store's included (the reference's orbax branch answers [])."""
        if _no_checkpoint_possible(self.directory):
            return []
        return self._store.quarantined()

    # ---- save -------------------------------------------------------
    def _snapshot(self, tree: Any, layout: Any = None) -> list:
        """This rank's pieces of ``tree`` on the host: ``[(path,
        (global_shape, dtype_name, [(bounds, host_tensor)]))]`` — the part
        of a save that the caller waits for even when the commit runs in
        the background. A device tensor is copied into a pinned staging
        buffer of this checkpointer's, kept for its later saves (the
        previous commit has finished with it: :meth:`save` waits for it
        first), behind the step's work on its stream; the snapshot returns
        once those streams have finished the copies. A host tensor is
        copied only for an async save (later writes must not reach it)."""
        pairs = _flatten(tree)
        layout = self._layout if layout is None else layout
        placements = dict(_flatten(layout)) if layout is not None else {}
        if set(placements) != {path for path, _ in pairs}:
            if _world()[1] > 1:
                raise CheckpointError(
                    "a save in a world of more than one rank needs the "
                    "tree's layout (save(layout=), or a restore first): a "
                    "tensor alone does not say which piece of its leaf "
                    "it is")
            placements = {}
        out, devices = [], set()
        for path, leaf in pairs:
            x = torch.as_tensor(leaf).detach()
            shape, bounds = _placement(path, x, placements.get(path))
            if x.is_cuda:
                host = self._staging.get(path)
                if host is None or host.shape != x.shape or \
                        host.dtype != x.dtype:
                    host = torch.empty(x.shape, dtype=x.dtype,
                                       pin_memory=True)
                    self._staging[path] = host
                host.copy_(x, non_blocking=True)
                devices.add(x.device)
            else:
                host = x.to("cpu", copy=self._async).contiguous()
            out.append((path, (shape, _dtype_name(x.dtype),
                               [(bounds, host)])))
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        return out

    def save(self, step: int, tree: Any,
             meta: Optional[dict[str, Any]] = None, *,
             layout: Any = None) -> None:
        """Atomic, checksummed save of this rank's pieces of ``tree`` (+
        JSON ``meta``); ``layout`` as in the class docstring.

        Blocking by default; with ``async_save=True`` the write+commit
        overlaps subsequent compute and lands at the next
        save/:meth:`flush`/:meth:`close`.
        """
        reg = self._reg
        with reg.span("checkpoint_save", step=step,
                      asynchronous=self._async,
                      backend="fsspec" if _is_remote(self.directory)
                      else "local"):
            reg.counter("checkpoint_saves").inc()
            if self._writer is not None:
                # one commit at a time, none queued behind it: the host
                # holds at most two snapshots (the committed one until
                # this copy is made, and this one)
                self._writer.flush()
            snapshot = self._snapshot(tree, layout)
            if not self._async:
                self._store.save(step, snapshot, meta or {})
                return
            if self._writer is None:
                self._writer = _AsyncWriter()
            store, m = self._store, dict(meta or {})

            def job():
                with reg.span("checkpoint_commit", step=step):
                    store.save(step, snapshot, m)

            self._writer.submit(job)

    # ---- restore ----------------------------------------------------
    def restore(self, cfg: BurnInConfig, rules=None,
                step: Optional[int] = None, *, device="cuda",
                ) -> Optional[tuple[Any, int, dict[str, Any]]]:
        """Restore ``(params, step, meta)`` from the newest valid (or a
        given) step, placed as :func:`..burnin.init_params` places them
        (``rules``: this rank's pieces on its device; else on
        ``device``). Returns None when no valid checkpoint exists."""
        return self.restore_tree(abstract_params(cfg, rules, device=device),
                                 step)

    def restore_tree(self, abstract: Any, step: Optional[int] = None,
                     ) -> Optional[tuple[Any, int, dict[str, Any]]]:
        """Restore an arbitrary tree saved with :meth:`save`.

        ``abstract`` is a tree of :class:`ShapeDtypeStruct` records
        describing the target placement — e.g. the AdamW train state
        ``{"params": …, "opt": …}`` whose moments carry ZeRO-1 specs
        (``models/optimizer.abstract_train_state``). It becomes the layout
        of later saves. With ``step=None`` the newest step that passes
        verification wins; corrupt/truncated/stale steps are quarantined
        and skipped. An explicit ``step`` is strict: a missing or corrupt
        step raises instead of falling back (the caller asked for *that*
        step). Returns ``(tree, step, meta)`` or None when no valid
        checkpoint exists.
        """
        self.flush()   # never restore a step whose commit hasn't landed
        self._layout = abstract
        if _no_checkpoint_possible(self.directory):
            return None
        with self._reg.span("checkpoint_restore") as sp:
            out = self._restore_steps(abstract, step)
            sp.args["step"] = out[1] if out is not None else None
            return out

    def _restore_steps(self, abstract: Any, step: Optional[int],
                       ) -> Optional[tuple[Any, int, dict[str, Any]]]:
        if step is not None:
            if step not in self._store.committed_steps():
                raise MissingStepError(
                    f"checkpoint step {step} does not exist in "
                    f"{self.directory} (committed: "
                    f"{self._store.committed_steps() or 'none'})")
            return self._load(abstract, step)
        for candidate in reversed(self._store.committed_steps()):
            try:
                return self._load(abstract, candidate)
            except CorruptCheckpointError as exc:
                log.warning(
                    "checkpoint step %d failed verification (%s); "
                    "quarantining and falling back to the previous step",
                    candidate, exc.reason)
                self._reg.counter("checkpoint_quarantined").inc()
                self._reg.event("checkpoint.quarantine", step=candidate,
                                reason=exc.reason)
                self._store.quarantine(candidate, exc.reason)
        return None

    def _load(self, abstract: Any, step: int,
              ) -> tuple[Any, int, dict[str, Any]]:
        """Streamed, re-sharding load: leaf by leaf — the stored world
        size and placement never have to match the restoring run's
        (elastic resume)."""
        meta, manifest = self._store.read_manifest(step)
        stored: dict[str, list] = {}
        for rec in manifest.get("leaves", []):
            stored.setdefault(rec["path"], []).append(rec)
        pairs = _flatten(abstract)
        want = {path for path, _ in pairs}
        have = set(stored)
        if want != have:
            missing = sorted(want - have)[:3]
            extra = sorted(have - want)[:3]
            raise CorruptCheckpointError(
                step, f"stale checkpoint: leaf set mismatch "
                      f"(missing {missing}, unexpected {extra})")
        reg = self._reg
        with self._store.record_reader(step) as reader:
            if _world()[1] > 1:
                # multi-process: every rank must reach the SAME
                # valid/quarantine verdict, or peers could resume from
                # different steps (split-brain) when corruption touches
                # only some ranks' target ranges. Verify every record
                # (streamed, one at a time) before any assembly; a world
                # of one keeps the partial-read fast path.
                with reg.span("checkpoint_verify", step=step) as sp:
                    for rec in manifest.get("leaves", []):
                        reader.read(rec)
                    sp.args["records"] = len(manifest.get("leaves", []))
            # the assembly phase IS the re-shard when the writing world
            # differs from ours — name it so the timeline says whether a
            # restore crossed world sizes
            stored_world = manifest.get("nprocs")
            name = ("checkpoint_reshard"
                    if stored_world not in (None, _world()[1])
                    else "checkpoint_assemble")
            with reg.span(name, step=step, stored_world=stored_world,
                          world=_world()[1]):
                leaves = {path: _assemble_leaf(path, a, stored[path], step,
                                               reader)
                          for path, a in pairs}
        return _rebuild(abstract, leaves), step, dict(meta or {})

    def stored_world(self, step: int) -> Optional[int]:
        """Rank count of the world that WROTE ``step`` — the resume
        journal's evidence that a re-sharding restore crossed world
        sizes. A remote store answers from its manifest too (the
        reference's orbax branch keeps no manifest and answers None)."""
        if _no_checkpoint_possible(self.directory):
            return None
        try:
            _meta, manifest = self._store.read_manifest(step)
        except CorruptCheckpointError:
            return None
        return manifest.get("nprocs")

    # ---- clear ------------------------------------------------------
    def clear(self) -> int:
        """Delete every committed step; returns how many were removed.

        Called after a run *succeeds*: the burn-in is validated, resume
        state is no longer needed, and leaving it behind would make the
        next fresh Job silently continue a finished run's step count.

        Multi-process discipline: every rank snapshots the step list,
        then they rendezvous through token files so all snapshots happen
        *before* rank 0 mutates the directory; rank 0 deletes, the rest
        wait (bounded) for the steps to be gone. No collective runs
        through the process group. Quarantined steps are kept — they are
        post-mortem evidence, not resume state.
        """
        # an uncommitted async save racing the delete could re-land its
        # step AFTER the directory sweep — commit everything first
        self.flush()
        if _no_checkpoint_possible(self.directory):
            return 0
        store = self._store
        steps = store.committed_steps()
        pid, nprocs = _world()
        if nprocs == 1:
            for s in steps:
                store._remove_step(s)
            store.sweep_stale_tmp(min_age_s=0.0)
            return len(steps)
        sync_dir = f"{_TMP_PREFIX}clear"
        store.put_json(f"{sync_dir}/clear_p{pid:05d}.json",
                       {"process": pid, "steps": steps})
        if pid == 0:
            _wait_for(
                lambda: all(store.isfile(f"{sync_dir}/clear_p{k:05d}.json")
                            for k in range(nprocs)),
                store.sync_timeout_s, "every process's clear snapshot")
            for s in steps:
                store._remove_step(s)
            store.rmtree(sync_dir)
            store.sweep_stale_tmp(min_age_s=0.0)
        else:
            _wait_for(
                lambda: not any(store.isdir(_step_dirname(s))
                                for s in steps)
                and not store.isdir(sync_dir),
                store.sync_timeout_s, "process 0 to finish clearing")
        return len(steps)


# One-shot convenience wrappers (tests, ad-hoc use). Run loops should hold
# a Checkpointer instead of paying directory scans per call.

def latest_step(directory: str) -> Optional[int]:
    """Highest committed step in ``directory``, or None if no checkpoint."""
    with Checkpointer(directory) as c:
        return c.latest_step()


def save_checkpoint(directory: str, step: int, params: Any,
                    meta: Optional[dict[str, Any]] = None,
                    max_to_keep: int = 2, *, layout: Any = None) -> None:
    with Checkpointer(directory, max_to_keep) as c:
        c.save(step, params, meta, layout=layout)


def restore_checkpoint(
    directory: str,
    cfg: BurnInConfig,
    rules=None,
    step: Optional[int] = None,
    *,
    device="cuda",
) -> Optional[tuple[Any, int, dict[str, Any]]]:
    with Checkpointer(directory) as c:
        return c.restore(cfg, rules, step, device=device)


def clear_checkpoints(directory: str) -> int:
    with Checkpointer(directory) as c:
        return c.clear()
