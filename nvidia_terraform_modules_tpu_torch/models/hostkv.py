# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Host-RAM block tier for the paged KV cache — the port of the reference's
``models/hostkv.py`` host pool (:class:`HostBlockPool`, its
:class:`HostSpillCorruptError` and the index adapter :class:`IndexSpill`).

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

import threading
import zlib
from typing import Any, Sequence

import torch

from .burnin import BurnInConfig, check_device
from .decode import check_cache_dtype, pool_kv_heads
from .paging import BlockAllocator, export_block_rows, pool_transfer_keys

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
        store stamps it)."""
        self._alloc = BlockAllocator(self.host_blocks, reserved=0)
        self._crc.clear()
        self.stored_blocks = 0
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
        src_dev = pool["k"][0].device
        if src_dev.type == "cuda" and not self.pinned:
            raise ValueError(
                "a host pool built for a CPU engine cannot take a CUDA "
                "pool's rows (build it with the engine's device)")
        if self.free_blocks < len(dev_blocks):
            return None
        payload = export_block_rows(pool, dev_blocks)
        n = len(dev_blocks)
        hids = self._alloc.alloc(n)
        staged = []
        for k, li in self._order:
            buf = self._bufs[k][li]
            dst = torch.empty((n,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                              pin_memory=self.pinned)
            dst.copy_(payload[k][li], non_blocking=True)
            staged.append((buf, dst))
        if src_dev.type == "cuda":
            torch.cuda.current_stream(src_dev).synchronize()
        idx = torch.tensor(hids, dtype=torch.long)
        for buf, dst in staged:
            buf.index_copy_(0, idx, dst)
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
