# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Host-RAM block tier for the paged KV cache — the port of the reference's
``models/hostkv.py``: the host pool (:class:`HostBlockPool`, its
:class:`HostSpillCorruptError` and the index adapter :class:`IndexSpill`),
and the fleet's durable prefix CDN (the shared :class:`WarmChainStore`,
its crash-safe :class:`DiskChainStore` and the chain-level adapter
:class:`ChainSpill`).

``prefix_keep_blocks`` caps what the prefix index may retain at what the
device pool spares; this tier is the second level behind it. The index
SPILLS an evicted chain into a host-side block pool instead of dropping it,
and a later prefix hit swaps the rows back into fresh device blocks — a
copy and a crc check instead of a prefill from tokens.

Division of labour, as in the reference: the pool owns bytes (per layer
``k``/``v`` ``[host_blocks, block_size, kv, D]``, and f32 ``k_scale``/
``v_scale`` sidecars for an int8 cache; one ``BlockAllocator(reserved=0)``
— a host block has exactly one owner, its index entry); the index owns
which chain holds which host block; the engine owns the swap schedule.

The buffers are torch tensors on the host (bf16 needs no conversion),
pinned when the pool serves a CUDA device — a failed pin raises, nothing
falls back to pageable memory — and plain on a CPU engine. Under
``rules`` the pool holds the rank's own KV heads, as the device pool does.

Integrity is the reference's: each stored block is stamped with
``paging.transfer_crc`` of its single-block payload (crc32 over the
block's bytes in key-sorted, layer order) and
re-checked before its rows are imported; a mismatch raises the
CLASSIFIED :class:`HostSpillCorruptError` and the engine drops the chain
and prefills from tokens. The check runs on a snapshot of the rows, and
the snapshot is what gets imported, so the verified bytes are the bytes
that reach the device.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np
import torch

from .burnin import BurnInConfig, check_device
from .decode import check_cache_dtype, pool_kv_heads
from .paging import (
    BlockAllocator,
    chain_key,
    export_block_rows,
    pool_transfer_keys,
)

_ALIGN = 16                         # byte alignment of a snapshot's segments


class HostSpillCorruptError(RuntimeError):
    """A spilled block's bytes no longer match their store-time crc — a
    CLASSIFIED integrity failure: the caller drops the chain and recomputes
    from tokens, never decodes the corrupt rows."""


class HostBlockPool:
    """Host-side block pool: the spill target behind the prefix index.

    Its layout is the device pool's transferable keys, so a spill is
    ``paging.export_block_rows`` landing in host rows and a swap-in is the
    same payload handed to ``paging.import_block_rows``: the round trip is
    bitwise per dtype, never a re-quantisation. :meth:`store` is
    all-or-nothing (host exhaustion returns ``None``; the caller drops the
    chain). :meth:`load` returns a crc-verified snapshot; :meth:`stage` is
    its asynchronous half — it snapshots the rows now (a later free or
    reuse of the host block cannot race it) and verifies them and copies
    them to the device on a worker thread, which never touches the device
    pool."""

    def __init__(self, cfg: BurnInConfig, host_blocks: int, *,
                 block_size: int, cache_dtype: str = "bf16", rules=None,
                 device="cuda"):
        if host_blocks < 1:
            raise ValueError(f"host_blocks must be >= 1, got {host_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        quant = check_cache_dtype(cache_dtype)
        self.host_blocks = host_blocks
        self.block_size = block_size
        self.cache_dtype = cache_dtype
        self.device = check_device(device)
        self.pinned = self.device.type == "cuda"
        tail = (block_size, pool_kv_heads(cfg, rules), cfg.head_dim)
        buf = torch.int8 if quant else cfg.dtype

        def zeros(shape, dtype):
            return [torch.zeros((host_blocks,) + shape, dtype=dtype,
                                pin_memory=self.pinned)
                    for _ in range(cfg.n_layers)]

        self._bufs: dict[str, list[torch.Tensor]] = {
            "k": zeros(tail, buf), "v": zeros(tail, buf)}
        if quant:
            self._bufs["k_scale"] = zeros(tail[:2], torch.float32)
            self._bufs["v_scale"] = zeros(tail[:2], torch.float32)
        # the wire order: key-sorted, then layer order
        self._order = [(k, li) for k in sorted(self._bufs)
                       for li in range(cfg.n_layers)]
        self._alloc = BlockAllocator(host_blocks, reserved=0)
        self._crc: dict[int, int] = {}
        self._pool: Any = None            # the swap worker, built lazily
        self._stream = None               # its copy stream on the card
        self._lock = threading.Lock()
        self.stored_blocks = 0            # cumulative spill traffic
        self.loaded_blocks = 0

    def reset(self) -> None:
        """A fresh run over the SAME buffers: a new allocator, no crc
        stamps, zeroed traffic counters (a row is only read after a new
        store stamps it). The allocator, the stamps and ``stored_blocks``
        have one writer, the engine's thread; ``loaded_blocks`` is also
        counted by the swap worker, under the lock."""
        self._alloc = BlockAllocator(self.host_blocks, reserved=0)
        self._crc.clear()
        self.stored_blocks = 0
        with self._lock:
            self.loaded_blocks = 0

    # ------------------------------------------------------- accounting

    @property
    def in_use(self) -> int:
        return self._alloc.in_use

    @property
    def free_blocks(self) -> int:
        return self._alloc.free_blocks

    @property
    def high_water(self) -> int:
        return self._alloc.high_water

    @property
    def nbytes(self) -> int:
        """Host bytes the pool's buffers hold."""
        return int(sum(b.nelement() * b.element_size()
                       for bufs in self._bufs.values() for b in bufs))

    def stats(self) -> dict[str, int]:
        return {
            "host_blocks": self.host_blocks,
            "in_use": self.in_use,
            "free": self.free_blocks,
            "high_water": self.high_water,
            "stored_blocks": self.stored_blocks,
            "loaded_blocks": self.loaded_blocks,
        }

    # ------------------------------------------------------- store side

    def _block_crc(self, bufs: dict, i: int) -> int:
        """``transfer_crc`` of block ``i`` of ``bufs`` (host tensors in the
        pool's layout): its buffers' bytes in key-sorted, layer order."""
        crc = 0
        for k, li in self._order:
            crc = zlib.crc32(bufs[k][li][i].view(torch.uint8).numpy(), crc)
        return crc

    def store(self, pool: dict, dev_blocks: Sequence[int]) -> list[int] | None:
        """Copy ``dev_blocks``' rows out of the device ``pool`` into host
        rows: the host ids (one per block, in order), or ``None`` when the
        pool cannot hold them all (checked before any device traffic). On
        the card the copy is queued on the current stream — after every
        wave queued before it, before any later kernel reuses the freed
        blocks — and finishes before the rows are stamped."""
        dev_blocks = list(dev_blocks)
        if not dev_blocks:
            return []
        keys = pool_transfer_keys(pool)
        if sorted(keys) != sorted(self._bufs):
            raise ValueError(
                f"device pool carries keys {sorted(keys)}, host pool was "
                f"built for {sorted(self._bufs)} (cache_dtype mismatch "
                f"between the tiers?)")
        if pool["k"][0].device.type == "cuda" and not self.pinned:
            raise ValueError(
                "a host pool built for a CPU engine cannot take a CUDA "
                "pool's rows (build it with the engine's device)")
        if self.free_blocks < len(dev_blocks):
            return None
        return self.adopt(export_block_rows(pool, dev_blocks))

    def host_payload(self, payload: dict) -> dict:
        """``payload`` (``export_block_rows``' format: torch tensors on any
        device, or numpy arrays as a disk record or the reference writes
        them, bf16 as 16-bit patterns) as host tensors of this pool's
        dtypes. Device rows are copied into pinned memory on the current
        stream, which is then synchronised: every returned byte has
        landed."""
        if sorted(payload) != sorted(self._bufs):
            raise ValueError(
                f"payload carries keys {sorted(payload)}, host pool was "
                f"built for {sorted(self._bufs)} (cache_dtype mismatch "
                f"between the tiers?)")
        out: dict[str, list[torch.Tensor]] = {}
        wait = set()
        for k, bufs in payload.items():
            want = self._bufs[k][0].dtype
            rows = []
            for src in bufs:
                if isinstance(src, np.ndarray):
                    t = torch.from_numpy(np.require(
                        src, requirements=["C", "W"]))
                    if want == torch.bfloat16 and t.dtype == torch.int16:
                        t = t.view(torch.bfloat16)
                elif src.device.type == "cuda":
                    t = torch.empty(src.shape, dtype=src.dtype,
                                    pin_memory=True)
                    t.copy_(src, non_blocking=True)
                    wait.add(src.device)
                else:
                    t = src
                if t.dtype != want:
                    raise ValueError(
                        f"payload[{k!r}] rows are {t.dtype}, the host "
                        f"pool holds {want}")
                rows.append(t)
            out[k] = rows
        for d in wait:
            torch.cuda.current_stream(d).synchronize()
        return out

    def adopt(self, payload: dict) -> list[int] | None:
        """Store an exported payload (see :meth:`host_payload` for what it
        may hold; ``n`` blocks a buffer) into host rows: the host ids, or
        ``None`` when the pool cannot hold them all. The door :meth:`store`
        goes through, and the one a warm chain takes into a joiner's pool
        or the fleet's :class:`WarmChainStore` without touching a device
        pool. Rows are crc-stamped once their bytes have landed."""
        rows = self.host_payload(payload)
        n = int(rows["k"][0].shape[0])
        if n == 0:
            return []
        hids = self._alloc.alloc(n)
        if hids is None:
            return None
        idx = torch.tensor(hids, dtype=torch.long)
        for k, li in self._order:
            self._bufs[k][li].index_copy_(0, idx, rows[k][li])
        for hid in hids:
            self._crc[hid] = self._block_crc(self._bufs, hid)
        self.stored_blocks += n
        return hids

    def free(self, host_ids: Sequence[int]) -> None:
        for hid in host_ids:
            self._crc.pop(int(hid), None)
        self._alloc.free([int(h) for h in host_ids])

    # -------------------------------------------------------- load side

    def _want(self, hid: int) -> int:
        want = self._crc.get(hid)
        if want is None:
            raise ValueError(
                f"host block {hid} holds no spilled content — foreign or "
                f"already-freed id")
        return want

    @staticmethod
    def _check(hid: int, want: int, got: int) -> None:
        if got != want:
            raise HostSpillCorruptError(
                f"host block {hid} failed its crc re-check (stored "
                f"{want:#010x}, read {got:#010x}) — host RAM corruption; "
                f"drop the chain and prefill from tokens, never decode "
                f"these rows")

    def _verify(self, hid: int) -> None:
        """Re-check host block ``hid`` against its store-time crc."""
        self._check(hid, self._want(hid), self._block_crc(self._bufs, hid))

    def _layout(self, n: int) -> tuple[list[int], int]:
        """Byte offsets of each buffer's ``n`` blocks in a snapshot (each
        segment contiguous and aligned), and the snapshot's size."""
        offs, end = [], 0
        for k, li in self._order:
            b = self._bufs[k][li]
            offs.append(end)
            end += -(-n * b[0].nelement() * b.element_size() // _ALIGN) \
                * _ALIGN
        return offs, end

    def _views(self, raw: torch.Tensor, n: int) -> dict:
        """The payload (``export_block_rows``' format) over a snapshot's
        bytes ``raw``: contiguous typed views, one per buffer."""
        offs, _ = self._layout(n)
        out: dict[str, list] = {k: [] for k in sorted(self._bufs)}
        for (k, li), off in zip(self._order, offs):
            b = self._bufs[k][li]
            size = n * b[0].nelement() * b.element_size()
            out[k].append(raw[off:off + size].view(b.dtype).view(
                (n,) + tuple(b.shape[1:])))
        return out

    def _snapshot(self, hids: list[int]) -> tuple[torch.Tensor, dict]:
        """The rows of ``hids`` gathered into one contiguous host byte
        tensor (pinned on the card) and its payload views."""
        raw = torch.empty((self._layout(len(hids))[1],), dtype=torch.uint8,
                          pin_memory=self.pinned)
        views = self._views(raw, len(hids))
        idx = torch.tensor(hids, dtype=torch.long)
        for k, li in self._order:
            torch.index_select(self._bufs[k][li], 0, idx, out=views[k][li])
        return raw, views

    def _verified(self, hids, wants, views) -> None:
        for i, (hid, want) in enumerate(zip(hids, wants)):
            self._check(hid, want, self._block_crc(views, i))
        with self._lock:
            self.loaded_blocks += len(hids)

    def load(self, host_ids: Sequence[int], device=None) -> dict:
        """The swap-in payload of ``host_ids``: a crc-verified snapshot in
        ``export_block_rows``' format, ready for ``paging.import_block_rows``
        into freshly granted device blocks — on the host, or on ``device``
        (one copy of the whole snapshot, queued on the current stream).
        Raises :class:`HostSpillCorruptError` on a bad row."""
        hids = [int(h) for h in host_ids]
        wants = [self._want(h) for h in hids]
        raw, views = self._snapshot(hids)
        self._verified(hids, wants, views)
        if device is None or torch.device(device).type == "cpu":
            return views
        return self._views(raw.to(device, non_blocking=True), len(hids))

    def stage(self, host_ids: Sequence[int]):
        """The ASYNC half of the double-buffered swap-in: snapshot the rows
        now, then verify the snapshot and (on the card) copy it to the
        device on the worker thread, on a copy stream of its own, so both
        overlap the wave loop. Returns a future whose ``result()`` is the
        payload — on the pool's device, its copy finished — or raises
        :class:`HostSpillCorruptError`."""
        from concurrent.futures import ThreadPoolExecutor

        hids = [int(h) for h in host_ids]
        wants = [self._want(h) for h in hids]
        raw, views = self._snapshot(hids)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hostkv-swap")
        if self.pinned and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)

        def work():
            self._verified(hids, wants, views)
            if not self.pinned:
                return views
            with torch.cuda.stream(self._stream):
                out = raw.to(self.device, non_blocking=True)
                self._stream.synchronize()
            return self._views(out, len(hids))

        return self._pool.submit(work)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


_PCD_MAGIC = b"PCD1"
_PCD_HEADER = struct.Struct(">II")      # body length, crc32(body)
_PCD_SUFFIX = ".pcd"

# transient IO retried with a tiny deterministic backoff: a disk-tier op
# runs on the serving path, so its budget is milliseconds; exhaustion
# degrades to the two-tier path (billed), never stalls the wave loop
_DISK_RETRY_KW: dict[str, Any] = {}


def _disk_retry(fn, what: str):
    """``(True, fn())``, or ``(False, None)`` once transient ``OSError``\\ s
    exhaust their retries."""
    from ..utils.retry import RetriesExhausted, RetryPolicy, retry_call

    if not _DISK_RETRY_KW:
        _DISK_RETRY_KW["policy"] = RetryPolicy(
            initial_s=0.005, multiplier=2.0, cap_s=0.02,
            max_attempts=3, jitter=False)
    try:
        return True, retry_call(fn, policy=_DISK_RETRY_KW["policy"],
                                what=what, retryable=(OSError,))
    except RetriesExhausted:
        return False, None


def _read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _record_array(buf) -> np.ndarray:
    """One payload buffer as a disk record holds it: a host numpy array,
    bf16 as its 16-bit patterns (the reference's records carry numpy
    arrays; bf16 has no numpy dtype here)."""
    return buf if isinstance(buf, np.ndarray) else _host_bytes(buf)[0]


class DiskChainCorruptError(RuntimeError):
    """A disk-tier chain record failed its frame verification (bad magic,
    truncated, crc mismatch, stale key, or chunks that no longer hash to
    the filename) — a CLASSIFIED integrity failure: the record is
    quarantined with its reason and the chain comes from a warmer tier or
    a prefill, never from the corrupt frame."""


class DiskChainStore:
    """The crash-safe DISK tier behind the fleet's :class:`WarmChainStore`:
    one crc-framed file a LEAF chain key, holding the long tail so the
    template working set survives a whole-fleet restart. The reference's
    format and discipline, file for file:

    - **filename**: the leaf ``paging.chain_key`` hex under
      ``objects/<hex[:2]>/<hex>.pcd``;
    - **frame**: ``PCD1`` + ``>II`` (body length, crc32) + a pickled
      record ``{key, seq, chunks, payload}`` — the un-hashed key, a
      persisted monotonic ``seq`` (the restore order; never the mtime),
      the chunk chain and the whole chain's rows. ``payload`` buffers are
      numpy arrays, bf16 as 16-bit patterns (f32 and int8 records are the
      reference's own);
    - **write**: tmp file + flush + ``os.fsync`` + ``os.replace`` — a
      kill at any instant leaves the old record or the new one;
    - **read**: every frame verified (magic, header, body crc, the
      record's key against the filename, ``chain_key(chunks)`` derived
      again, the row count a node); a bad file moves under
      ``quarantine/`` with its reason, billed;
    - **transient IO** is retried; exhaustion, or a store directory that
      cannot be made, bills ``degraded`` and the op is a miss — serving
      shrinks to two tiers, it never raises into the wave loop."""

    def __init__(self, path: str, *, telemetry=None):
        self.path = os.path.abspath(str(path))
        self.objects_dir = os.path.join(self.path, "objects")
        self.quarantine_dir = os.path.join(self.path, "quarantine")
        self._lock = threading.Lock()
        self._reg = telemetry
        # leaf key → (chunks, seq, root key); node key → leaf key
        self._catalog: dict[bytes, tuple[tuple, int, bytes]] = {}
        self._node_leaf: dict[bytes, bytes] = {}
        self._seq = 0
        self._tmp_seq = 0
        self.dead = False               # the whole tier is unreachable
        self.stored_chains = 0
        self.loaded_chains = 0
        self.quarantined = 0
        self.quarantine_reasons: list[str] = []
        self.degraded = 0               # ops lost to IO exhaustion / death
        ok, _ = _disk_retry(self._ensure_dirs, "disk tier mkdir")
        if not ok:
            self.dead = True
            self._note_degraded()
            return
        with self._lock:
            self._scan_locked()

    def _registry(self):
        if self._reg is None:
            from ..telemetry import get_registry

            self._reg = get_registry()
        return self._reg

    def _note_degraded(self) -> None:
        """One lost op: the store's count and
        ``prefix_disk_degraded_total``."""
        self.degraded += 1
        self._registry().counter("prefix_disk_degraded_total").inc()

    def _ensure_dirs(self) -> None:
        os.makedirs(self.objects_dir, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)

    # -------------------------------------------------------- framing

    @staticmethod
    def _chain_nodes(chunks) -> list[bytes]:
        return [chain_key(chunks, k) for k in range(1, len(chunks) + 1)]

    def _entry_path(self, leaf: bytes) -> str:
        hexkey = leaf.hex()
        return os.path.join(self.objects_dir, hexkey[:2],
                            hexkey + _PCD_SUFFIX)

    @staticmethod
    def _encode(record: dict) -> bytes:
        body = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        return (_PCD_MAGIC
                + _PCD_HEADER.pack(len(body), zlib.crc32(body)) + body)

    @staticmethod
    def _decode(raw: bytes, leaf: bytes) -> dict:
        """Verify one frame end to end; raises
        :class:`DiskChainCorruptError` with the reason."""
        if raw[:len(_PCD_MAGIC)] != _PCD_MAGIC:
            raise DiskChainCorruptError("bad magic (foreign or "
                                        "corrupt file)")
        off = len(_PCD_MAGIC)
        if len(raw) < off + _PCD_HEADER.size:
            raise DiskChainCorruptError("truncated header")
        length, crc = _PCD_HEADER.unpack_from(raw, off)
        body = raw[off + _PCD_HEADER.size:]
        if len(body) != length:
            raise DiskChainCorruptError(
                f"truncated body ({len(body)} bytes of {length})")
        if zlib.crc32(body) != crc:
            raise DiskChainCorruptError(
                f"body crc mismatch (stored {crc:#010x}, "
                f"read {zlib.crc32(body):#010x})")
        try:
            record = pickle.loads(body)
        except Exception as exc:
            raise DiskChainCorruptError(
                f"unpicklable body ({type(exc).__name__})") from exc
        if not isinstance(record, dict) or "key" not in record:
            raise DiskChainCorruptError("foreign record shape")
        if record["key"] != leaf:
            raise DiskChainCorruptError(
                "stale key: record names a different chain than its "
                "filename (renamed or misplaced file)")
        chunks = record.get("chunks") or ()
        if not chunks or chain_key(chunks) != leaf:
            raise DiskChainCorruptError(
                "chunk chain no longer hashes to the record key")
        payload = record.get("payload")
        if not isinstance(payload, dict) or not payload:
            raise DiskChainCorruptError("missing block payload")
        n = len(chunks)
        for k, bufs in payload.items():
            for buf in bufs:
                if int(np.asarray(buf).shape[0]) != n:
                    raise DiskChainCorruptError(
                        f"payload[{k!r}] carries "
                        f"{int(np.asarray(buf).shape[0])} block rows "
                        f"for a {n}-node chain")
        return record

    def _quarantine(self, fpath: str, reason: str) -> None:
        """Move a bad file aside with its reason: a corrupt record is never
        read again as a miss-then-hit."""
        name = os.path.basename(fpath)
        ok, _ = _disk_retry(
            lambda: os.replace(fpath,
                               os.path.join(self.quarantine_dir, name)),
            "disk tier quarantine")
        if not ok:
            self._note_degraded()
        self.quarantined += 1
        self.quarantine_reasons.append(f"{name}: {reason}")
        self._registry().counter("prefix_disk_quarantine_total").inc()

    # ----------------------------------------------------------- scan

    def _scan_locked(self) -> None:
        """The restore-time walk: verify every frame once, build the
        catalog, quarantine every bad file. An unreadable objects tree
        kills the tier (degraded, never a crash)."""
        def listing():
            out = []
            for shard in sorted(os.listdir(self.objects_dir)):
                sdir = os.path.join(self.objects_dir, shard)
                if not os.path.isdir(sdir):
                    continue
                for name in sorted(os.listdir(sdir)):
                    if name.endswith(_PCD_SUFFIX):
                        out.append(os.path.join(sdir, name))
            return out

        ok, files = _disk_retry(listing, "disk tier scan")
        if not ok:
            self.dead = True
            self._note_degraded()
            return
        for fpath in files:
            name = os.path.basename(fpath)[:-len(_PCD_SUFFIX)]
            try:
                leaf = bytes.fromhex(name)
            except ValueError:
                self._quarantine(fpath, "non-hex filename")
                continue
            ok, raw = _disk_retry(lambda p=fpath: _read_file(p),
                                  "disk tier read")
            if not ok:
                self._note_degraded()
                continue
            try:
                record = self._decode(raw, leaf)
            except DiskChainCorruptError as exc:
                self._quarantine(fpath, str(exc))
                continue
            self._index_locked(leaf, record["chunks"], int(record["seq"]))
        self._seq = 1 + max(
            (seq for _c, seq, _r in self._catalog.values()), default=-1)

    def _index_locked(self, leaf: bytes, chunks, seq: int) -> None:
        chunks = tuple(tuple(c) for c in chunks)
        nodes = self._chain_nodes(chunks)
        self._catalog[leaf] = (chunks, seq, nodes[0])
        for nk in nodes:
            # every chain through a node holds the same rows up to it
            self._node_leaf[nk] = leaf

    # ------------------------------------------------------ store side

    def has(self, leaf: bytes) -> bool:
        with self._lock:
            return leaf in self._catalog

    def put(self, chunks, payload: dict) -> bool:
        """File one whole chain (``payload`` rows cover every node, root to
        leaf), atomically. False (billed ``degraded``) when the tier is
        dead or transient IO exhausts its retries."""
        if self.dead:
            self._note_degraded()
            return False
        chunks = tuple(tuple(c) for c in chunks)
        if not chunks:
            return False
        leaf = chain_key(chunks)
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._tmp_seq += 1
            tmp_seq = self._tmp_seq
        record = {"key": leaf, "seq": seq, "chunks": chunks,
                  "payload": {k: [_record_array(b) for b in bufs]
                              for k, bufs in payload.items()}}
        frame = self._encode(record)
        fpath = self._entry_path(leaf)
        tmp = f"{fpath}.tmp.{os.getpid()}.{tmp_seq}"

        def write():
            os.makedirs(os.path.dirname(fpath), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(frame)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, fpath)

        ok, _ = _disk_retry(write, "disk tier write")
        if not ok:
            self._note_degraded()
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        with self._lock:
            self._index_locked(leaf, chunks, seq)
            self.stored_chains += 1
        return True

    # ------------------------------------------------------- load side

    def get(self, leaf: bytes):
        """``(chunks, payload)`` of one verified chain (``payload`` as the
        record holds it: numpy arrays), or ``None`` — a miss, a quarantined
        frame or degraded IO, never an exception."""
        if self.dead:
            return None
        with self._lock:
            if leaf not in self._catalog:
                return None
        fpath = self._entry_path(leaf)
        ok, raw = _disk_retry(lambda: _read_file(fpath), "disk tier read")
        if not ok:
            self._note_degraded()
            return None
        try:
            record = self._decode(raw, leaf)
        except DiskChainCorruptError as exc:
            self._quarantine(fpath, str(exc))
            self._forget(leaf)
            return None
        with self._lock:
            self.loaded_chains += 1
        return record["chunks"], record["payload"]

    def _forget(self, leaf: bytes) -> None:
        with self._lock:
            ent = self._catalog.pop(leaf, None)
            if ent is None:
                return
            for nk in self._chain_nodes(ent[0]):
                if self._node_leaf.get(nk) == leaf:
                    del self._node_leaf[nk]

    def node_leaf(self, node_key: bytes) -> bytes | None:
        """The leaf chain whose path runs through ``node_key``, if any."""
        with self._lock:
            return self._node_leaf.get(node_key)

    def hot_first(self) -> list[bytes]:
        """Leaf keys by DESCENDING persisted seq (the restore order)."""
        with self._lock:
            return sorted(self._catalog,
                          key=lambda k: -self._catalog[k][1])

    def roots(self) -> dict[bytes, bytes]:
        """Root chain key → leaf key for every filed chain (the root key
        is ``fleet.affinity_key``'s)."""
        with self._lock:
            return {root: leaf
                    for leaf, (_c, _s, root) in self._catalog.items()}

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "dead": self.dead,
                "chains": len(self._catalog),
                "stored_chains": self.stored_chains,
                "loaded_chains": self.loaded_chains,
                "quarantined": self.quarantined,
                "quarantine_reasons": list(self.quarantine_reasons),
                "degraded": self.degraded,
            }


class WarmChainStore:
    """The fleet-shared HOST tier of prefix chains: filed by their LEAF
    chain key, kept LRU, with rows stored once a chain NODE (refcounted),
    so chains sharing a template prefix share its rows. Replicas publish
    their retained chains at close or drain, joiners take their keyspace
    share at bring-up, and admissions of a ``shared_store`` engine fetch
    from it. Every row rides :class:`HostBlockPool`'s crc discipline: a
    corrupt chain is dropped and billed, never handed out. The rows are
    pinned host tensors when the store serves a CUDA device.

    Locking is per chain by PINNING: the lock guards the catalog and the
    counters; a reader pins its chain's rows (+1 a node, under the lock)
    and copies them outside it, so a large copy never stalls a publisher
    or a wave loop. A publisher's rows enter the catalog only once their
    bytes have landed in host memory (:meth:`HostBlockPool.host_payload`
    synchronises the publisher's stream first), so no reader sees a row
    in flight.

    With a :class:`DiskChainStore` (``disk=``) this is the three-tier
    prefix CDN: publishes write through to disk (outside the lock),
    construction restores the hottest chains into RAM, and a RAM miss on
    :meth:`fetch` falls through to the verified disk frame."""

    def __init__(self, cfg: BurnInConfig, host_blocks: int, *,
                 block_size: int, cache_dtype: str = "bf16",
                 disk: "DiskChainStore | None" = None, device="cuda"):
        self.pool = HostBlockPool(cfg, host_blocks, block_size=block_size,
                                  cache_dtype=cache_dtype, device=device)
        self.disk = disk
        self._lock = threading.Lock()
        # leaf key → chunks, LRU order; node key → [host id, refcount]
        self._chains: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._rows: dict[bytes, list] = {}
        self.published_chains = 0       # chains newly stored
        self.store_full_drops = 0       # publishes the full pool refused
        self.corrupt_dropped = 0        # reads that failed their crc
        self.taken_chains = 0           # chains handed to joiners
        self.fetch_hits = 0             # RAM-tier fetch() chains served
        self.fetch_blocks = 0
        self.disk_hit_chains = 0        # fetches the disk tier saved
        self.disk_hit_blocks = 0
        self.disk_restored = 0          # chains restored at construction
        if disk is not None:
            self._restore_from_disk()

    def __len__(self) -> int:
        with self._lock:
            return len(self._chains)

    @staticmethod
    def _node_keys(chunks) -> list:
        return [chain_key(chunks, k) for k in range(1, len(chunks) + 1)]

    def _drop_chain_locked(self, leaf) -> None:
        """Unfile one chain: one reference off each node, rows no chain
        holds any more freed."""
        chunks = self._chains.pop(leaf)
        self._unpin_locked(self._node_keys(chunks))

    def _unpin_locked(self, node_keys) -> None:
        """One reference off each node; a pinned row whose chains were all
        evicted during the copy frees here."""
        for nk in node_keys:
            row = self._rows.get(nk)
            if row is None:
                continue
            row[1] -= 1
            if row[1] == 0:
                self.pool.free([row[0]])
                del self._rows[nk]

    def publish(self, chains: Sequence[tuple], *,
                to_disk: bool = True) -> int:
        """Store ``(chunks, payload)`` chains (``payload`` covering the
        whole chain), given hottest first. A chain already filed refreshes
        its LRU slot. Under pressure a chain evicts LRU chains and is
        dropped (billed) if it still does not fit; the batch is inserted
        coldest first, so the cold tail is what a squeeze loses, and a
        chain bigger than the whole pool is refused up front. With a disk
        tier every chain of the batch not filed there writes through
        (outside the lock), the ones RAM refused included. Returns the
        chains newly stored in RAM."""
        batch = []
        for chunks, payload in chains:
            chunks = tuple(tuple(int(t) for t in c) for c in chunks)
            if chunks:
                # bytes landed before the lock: no reader sees a row in
                # flight, no publisher waits on another's stream
                batch.append((chunks, self.pool.host_payload(payload)))
        stored = 0
        with self._lock:
            for chunks, payload in reversed(batch):
                node_keys = self._node_keys(chunks)
                leaf = node_keys[-1]
                if leaf in self._chains:
                    self._chains.move_to_end(leaf)
                    continue
                while True:
                    # again each attempt: an eviction may free a prefix
                    # node this chain shares
                    missing = [i for i, nk in enumerate(node_keys)
                               if nk not in self._rows]
                    if len(missing) > self.pool.host_blocks:
                        hids = None          # bigger than the pool
                        break
                    if not missing:
                        hids = []            # fully shared already
                        break
                    idx = torch.tensor(missing, dtype=torch.long)
                    hids = self.pool.adopt(
                        {k: [b.index_select(0, idx) for b in bufs]
                         for k, bufs in payload.items()})
                    if hids is not None or not self._chains:
                        break
                    self._drop_chain_locked(next(iter(self._chains)))
                if hids is None:
                    self.store_full_drops += 1
                    continue
                for i, hid in zip(missing, hids):
                    self._rows[node_keys[i]] = [int(hid), 0]
                for nk in node_keys:
                    self._rows[nk][1] += 1
                self._chains[leaf] = chunks
                self.published_chains += 1
                stored += 1
        if to_disk and self.disk is not None:
            for chunks, payload in batch:
                if not self.disk.has(chain_key(chunks)):
                    self.disk.put(chunks, payload)
        return stored

    def take(self, owns) -> list[tuple[tuple, dict]]:
        """The joiner's share: every stored chain whose ROOT key satisfies
        ``owns(root)``, as ``(chunks, payload)`` (host tensors) ready for
        ``HostBlockPool.adopt`` + ``PrefixIndex.seed_host``, sorted by key
        (the seeding order must not follow publish timing). Rows are
        crc-verified as they are copied; a corrupt chain leaves the store,
        billed. The chains stay in the store — a take copies."""
        with self._lock:
            picked = []
            for key in sorted(self._chains):
                chunks = self._chains[key]
                node_keys = self._node_keys(chunks)
                if not owns(node_keys[0]):
                    continue
                for nk in node_keys:
                    self._rows[nk][1] += 1       # pin
                picked.append((key, chunks, node_keys,
                               [self._rows[nk][0] for nk in node_keys]))
        out: list[tuple[tuple, dict]] = []
        for key, chunks, node_keys, hids in picked:
            try:
                payload = self.pool.load(hids)   # lock NOT held
            except HostSpillCorruptError:
                with self._lock:
                    if key in self._chains:
                        self._drop_chain_locked(key)
                    self.corrupt_dropped += 1
                    self._unpin_locked(node_keys)
                continue
            with self._lock:
                if key in self._chains:
                    self._chains.move_to_end(key)
                self._unpin_locked(node_keys)
                self.taken_chains += 1
            out.append((chunks, payload))
        return out

    def fetch(self, chunks, start: int = 0):
        """The admission swap-in: the LONGEST run of consecutive node rows
        ``start..`` of this exact chain as ``(n, payload, disk_hit)``
        (``payload`` host tensors for ``paging.import_block_rows``), or
        ``None`` when no tier holds node ``start``. RAM rows are pinned,
        then copied crc-verified outside the lock; a RAM miss falls through
        to the disk tier's verified frame, and a disk hit promotes the
        chain into RAM. Corrupt rows are dropped and billed, never
        returned."""
        chunks = tuple(tuple(int(t) for t in c) for c in chunks)
        if not 0 <= start < len(chunks):
            return None
        node_keys = self._node_keys(chunks)
        with self._lock:
            m = start
            while m < len(node_keys) and node_keys[m] in self._rows:
                m += 1
            if m > start:
                for nk in node_keys[start:m]:
                    self._rows[nk][1] += 1       # pin
                hids = [self._rows[nk][0] for nk in node_keys[start:m]]
        if m == start:
            return self._fetch_disk(chunks, node_keys, start)
        try:
            payload = self.pool.load(hids)       # lock NOT held
        except HostSpillCorruptError:
            with self._lock:
                # the bad row may back several chains: every chain through
                # a pinned node is suspect
                bad = set(node_keys[start:m])
                for leaf in [lf for lf, ch in self._chains.items()
                             if bad & set(self._node_keys(ch))]:
                    self._drop_chain_locked(leaf)
                    self.corrupt_dropped += 1
                self._unpin_locked(node_keys[start:m])
            return None
        with self._lock:
            self._unpin_locked(node_keys[start:m])
            self.fetch_hits += 1
            self.fetch_blocks += m - start
        return m - start, payload, False

    def _fetch_disk(self, chunks, node_keys, start: int):
        """The RAM miss: the disk catalog's chain through the wanted node,
        read and verified, the requested nodes sliced out, the chain
        promoted into RAM (not written again). Every failure is a miss."""
        if self.disk is None:
            return None
        leaf = self.disk.node_leaf(node_keys[start])
        if leaf is None:
            return None
        rec = self.disk.get(leaf)
        if rec is None:
            return None
        d_chunks, payload = rec
        d_chunks = tuple(tuple(int(t) for t in c) for c in d_chunks)
        # the run where the filed chain and the request agree token for
        # token (a hash collision is never trusted)
        m = start
        while (m < len(chunks) and m < len(d_chunks)
               and chunks[m] == d_chunks[m]):
            m += 1
        if m == start or d_chunks[:start] != chunks[:start]:
            return None
        rows = self.pool.host_payload(payload)
        with self._lock:
            self.disk_hit_chains += 1
            self.disk_hit_blocks += m - start
        self.publish([(d_chunks, rows)], to_disk=False)
        return m - start, {k: [b[start:m] for b in bufs]
                           for k, bufs in rows.items()}, True

    def _restore_from_disk(self) -> None:
        """Construction: warm the RAM tier with the disk's hottest chains
        (persisted-seq order); capacity keeps the head, the tail stays one
        :meth:`fetch` away on disk."""
        records = []
        for leaf in self.disk.hot_first():
            rec = self.disk.get(leaf)
            if rec is not None:
                records.append(rec)
        self.disk_restored = self.publish(records, to_disk=False)

    def residency(self) -> dict[bytes, str]:
        """ROOT chain key → ``"ram"`` | ``"disk"`` for every chain a tier
        holds: the router's global view (the root key is
        ``fleet.affinity_key``'s)."""
        out: dict[bytes, str] = {}
        with self._lock:
            for chunks in self._chains.values():
                out[chain_key(chunks, 1)] = "ram"
        if self.disk is not None:
            for root in self.disk.roots():
                out.setdefault(root, "disk")
        return out

    def clear(self) -> None:
        with self._lock:
            while self._chains:
                self._drop_chain_locked(next(iter(self._chains)))

    def stats(self) -> dict:
        with self._lock:
            out = {
                "chains": len(self._chains),
                "blocks_in_use": self.pool.in_use,
                "host_blocks": self.pool.host_blocks,
                "host_bytes": self.pool.nbytes,
                "published_chains": self.published_chains,
                "taken_chains": self.taken_chains,
                "store_full_drops": self.store_full_drops,
                "corrupt_dropped": self.corrupt_dropped,
                "fetch_hits": self.fetch_hits,
                "fetch_blocks": self.fetch_blocks,
                "disk_hit_chains": self.disk_hit_chains,
                "disk_hit_blocks": self.disk_hit_blocks,
                "disk_restored": self.disk_restored,
            }
        out["disk"] = self.disk.stats() if self.disk is not None else None
        return out


class IndexSpill:
    """The spill adapter ``PrefixIndex`` drives: a :class:`HostBlockPool`
    bound to the engine's device pool, read through a callable so the
    adapter always sees the run's current pool. The index only sees
    ``store(dev_blocks) → host_ids | None`` and ``free(host_ids)``."""

    def __init__(self, host: HostBlockPool, pool_ref):
        self.host = host
        self._pool_ref = pool_ref

    def store(self, dev_blocks: Sequence[int]) -> list[int] | None:
        return self.host.store(self._pool_ref(), dev_blocks)

    def free(self, host_ids: Sequence[int]) -> None:
        self.host.free(host_ids)


class ChainSpill:
    """The CHAIN-LEVEL spill adapter of a ``shared_store`` engine: a
    ``PrefixIndex`` with ``chain_level`` spill hands evictions over as
    whole root→leaf chains (chunks and device blocks); this exports their
    rows from the live pool and publishes them into the ONE fleet-shared
    :class:`WarmChainStore` (which writes through to its disk tier), so N
    replicas keep one copy of the template head. The export runs on the
    engine's current stream and its bytes land in host memory (that
    stream synchronised) before the store files them. ``free`` is refused:
    a chain-level index owns no host ids."""

    chain_level = True

    def __init__(self, store: WarmChainStore, pool_ref):
        self.store = store
        self._pool_ref = pool_ref
        self.spilled_chains = 0

    def store_chains(self, chains: Sequence[tuple]) -> int:
        """Publish ``(chunks, dev_blocks)`` chains (root to leaf) into the
        shared store, best-effort (the store bills its own drops)."""
        recs = [(tuple(tuple(c) for c in chunks),
                 export_block_rows(self._pool_ref(), list(dev_blocks)))
                for chunks, dev_blocks in chains]
        if recs:
            self.store.publish(recs)
            self.spilled_chains += len(recs)
        return len(recs)

    def free(self, host_ids: Sequence[int]) -> None:
        raise ValueError(
            "chain-level spill holds no per-index host rows — a "
            "host-tier entry leaked into a shared-store engine")


class SnapshotCorruptError(RuntimeError):
    """A streamed param leaf's bytes no longer match their snapshot-time
    crc — a CLASSIFIED integrity failure: the receiver refuses the tree,
    never builds an engine on corrupt weights."""


def _snapshot_leaves(tree, leaves: list):
    """The tree's skeleton with each tensor replaced by its index in
    ``leaves`` (appended in ``jax.tree.leaves`` order: dict keys sorted,
    lists in order; a ``QTensor`` is its ``q`` then its ``scale``)."""
    from .quantize import QTensor

    if isinstance(tree, dict):
        out = {k: _snapshot_leaves(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}          # the tree's own key order
    if isinstance(tree, (list, tuple)):
        return [_snapshot_leaves(t, leaves) for t in tree]
    if isinstance(tree, QTensor):
        return {"__qtensor__": {
            "q": _snapshot_leaves(tree.q, leaves),
            "scale": _snapshot_leaves(tree.scale, leaves),
            "scale_axis": tree.scale_axis, "transposed": tree.transposed,
            "dtype": str(tree.dtype).removeprefix("torch.")}}
    leaves.append(tree)
    return len(leaves) - 1


def _host_bytes(t: torch.Tensor):
    """``(numpy array, torch dtype name)`` of a tensor's host copy; bf16 (no
    numpy dtype) as its 16-bit patterns, so its bytes — and their crc — are
    the reference's."""
    h = t.detach().to("cpu").contiguous()
    name = str(h.dtype).removeprefix("torch.")
    if h.dtype == torch.bfloat16:
        h = h.view(torch.int16)
    return h.numpy(), name


class HostParamSnapshot:
    """Donor weights for a fleet's replica processes: ONE contiguous host
    copy of the param tree with a crc32 a leaf (the reference's
    ``HostParamSnapshot``), built once and sent to every replica child.
    The leaves go in ``jax.tree.leaves`` order and their bytes are the
    reference's, so each leaf's crc equals the reference's for the same
    weights. :meth:`decode` verifies every leaf on the receiving side
    before the tree is rebuilt on its device."""

    def __init__(self, params):
        leaves: list = []
        self.skeleton = _snapshot_leaves(params, leaves)
        self.leaves = [_host_bytes(t) for t in leaves]
        self.crcs = [zlib.crc32(a.tobytes()) & 0xFFFFFFFF
                     for a, _ in self.leaves]
        self.nbytes = int(sum(a.nbytes for a, _ in self.leaves))

    def encode(self) -> dict:
        """The wire form: host arrays as they are (pickling them once is
        the transport's job)."""
        return {"skeleton": self.skeleton, "leaves": self.leaves,
                "crcs": list(self.crcs), "nbytes": self.nbytes}

    @staticmethod
    def decode(wire: dict, device="cuda"):
        """Verify every leaf's crc and rebuild the tree on ``device``; a
        mismatch or a leaf-count drift raises
        :class:`SnapshotCorruptError`."""
        from .quantize import QTensor

        leaves, crcs = wire["leaves"], wire["crcs"]
        if len(leaves) != len(crcs):
            raise SnapshotCorruptError(
                f"snapshot carries {len(crcs)} leaf crcs for "
                f"{len(leaves)} leaves — foreign or truncated stream")
        for i, ((arr, _), crc) in enumerate(zip(leaves, crcs)):
            got = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
            if got != crc:
                raise SnapshotCorruptError(
                    f"param leaf {i}: crc {got:#010x} does not match "
                    f"snapshot crc {crc:#010x}")
        dev = check_device(device)

        def leaf(i):
            arr, name = leaves[i]
            t = torch.from_numpy(arr.copy())
            if name == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(dev)

        def build(node):
            if isinstance(node, int):
                return leaf(node)
            if isinstance(node, list):
                return [build(n) for n in node]
            if "__qtensor__" in node:
                q = node["__qtensor__"]
                return QTensor(build(q["q"]), build(q["scale"]),
                               scale_axis=q["scale_axis"],
                               dtype=getattr(torch, q["dtype"]),
                               transposed=q["transposed"])
            return {k: build(v) for k, v in node.items()}

        return build(wire["skeleton"])
