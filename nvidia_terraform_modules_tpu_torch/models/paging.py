# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Block/paged KV-cache allocation — the port of the reference's
``models/paging.py`` (``blocks_for_rows``, :class:`BlockAllocator`,
``paged_pool_spec``, ``init_paged_cache`` for the bf16 and the int8 pool;
cross-request prefix sharing: ``chain_chunks``, ``chunk_tokens_covered``,
``chain_key`` and :class:`PrefixIndex` with its host-RAM tier; and the
block transfer: ``pool_transfer_keys``, ``export_block_rows``,
``transfer_crc`` and ``import_block_rows``).

The physical cache is one ``[num_blocks, block_size, kv_heads, D]`` buffer
per layer shared by every request; each request owns a block table (the
logical → physical mapping) and exactly ``ceil(rows / block_size)``
blocks, returned to the host-side free list when it retires. The host owns
WHICH blocks belong to which request (plain integers, no device traffic);
the device owns the math. Block 0 is RESERVED as the garbage block: dead
slots' writes land there, so a retired slot still computing in the batch
can never scribble over a block recycled to another request.
"""

from __future__ import annotations

import hashlib
import zlib
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np
import torch

from ..parallel.mesh import WorldMesh
from .burnin import BurnInConfig, check_device
from .decode import (
    cache_rows,
    check_cache_dtype,
    check_serve_rules,
    pool_kv_heads,
)


def blocks_for_rows(rows: int, block_size: int) -> int:
    """Blocks needed to hold ``rows`` cache rows (0 rows → 0 blocks)."""
    if rows < 0:
        raise ValueError(f"rows must be >= 0, got {rows}")
    return -(-rows // block_size)


class BlockAllocator:
    """Host-side refcounted free-list allocator over ``num_blocks``
    physical blocks. The ``reserved`` leading blocks (block 0: the
    garbage block) are never handed out; ``alloc`` is all-or-nothing and
    returns ``None`` on exhaustion (admission control, not an error);
    ``free`` drops one reference per block and recycles a block (LIFO)
    only when its last reference drops."""

    def __init__(self, num_blocks: int, *, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(
                f"num_blocks ({num_blocks}) must exceed the reserved "
                f"garbage block count ({reserved})")
        self.num_blocks = num_blocks
        self.reserved = reserved
        self._free = list(range(num_blocks - 1, reserved - 1, -1))
        self._ref: dict[int, int] = {}
        self.high_water = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Physical blocks allocated, each counted once."""
        return len(self._ref)

    @property
    def refs_total(self) -> int:
        """Logical block references (what the tables would cost
        unshared)."""
        return sum(self._ref.values())

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` blocks at refcount 1, or ``None`` (never a partial
        grant)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        self.high_water = max(self.high_water, len(self._ref))
        return blocks

    def share(self, blocks: Sequence[int]) -> None:
        """Add one reference to each already-allocated block."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(
                    f"block {b} is not allocated — only a live block "
                    f"can be shared into another table")
        for b in blocks:
            self._ref[b] += 1

    def free(self, blocks) -> None:
        """Drop one reference per block; freeing an unallocated block
        (double free, a reserved block, a foreign id) raises."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(
                    f"block {b} is not allocated (double free, a "
                    f"reserved block, or a foreign id)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)

    def stats(self) -> dict[str, int]:
        return {
            "num_blocks": self.num_blocks,
            "reserved": self.reserved,
            "in_use": self.in_use,
            "free": self.free_blocks,
            "high_water": self.high_water,
            "refs_total": self.refs_total,
        }


def chain_chunks(tokens: Sequence[int], block_size: int,
                 offset: int = 0) -> list[tuple[int, ...]]:
    """Split ``tokens`` into the FULL block-grid chunks of a request's own
    blocks. ``offset`` is the number of leading rows of the first own block
    already holding content identical across requests (the template
    prefix's copied tail rows), so the first chunk covers ``block_size -
    offset`` tokens and every later chunk ``block_size``. A partial tail
    block is never a chunk: its remaining rows differ per request."""
    if not 0 <= offset < block_size:
        raise ValueError(
            f"offset must be in [0, block_size), got {offset}")
    out: list[tuple[int, ...]] = []
    start, width = 0, block_size - offset
    while start + width <= len(tokens):
        out.append(tuple(int(t) for t in tokens[start:start + width]))
        start += width
        width = block_size
    return out


def chunk_tokens_covered(k: int, block_size: int, offset: int = 0) -> int:
    """Prompt tokens covered by the first ``k`` full own-block chunks — the
    prefill-start offset after sharing ``k`` blocks (0 for k=0)."""
    return 0 if k == 0 else k * block_size - offset


def chain_key(chunks: Sequence[tuple], upto: int | None = None) -> bytes:
    """The :class:`PrefixIndex` key of ``chunks[:upto]``: it names the
    ENTIRE token history through that chunk."""
    if upto is None:
        upto = len(chunks)
    if upto < 1:
        raise ValueError("chain_key needs >= 1 chunk")
    parent: bytes | None = None
    for chunk in chunks[:upto]:
        parent = PrefixIndex._key(parent, chunk)
    return parent


class PrefixIndex:
    """Host-side prefix lookup: block-aligned token-hash chains → physical
    blocks, holding ONE allocator reference per indexed block.

    The key of a request's ``i``-th full own block is ``H(key_{i-1},
    tokens_i)`` (blake2b over the token text), so two requests share a key
    iff their prompts agree on every row the block holds and on everything
    before it — exactly when the cached K/V is identical. Each entry also
    keeps its token chunk and a match compares tokens outright, so a hash
    collision can never share a wrong block.

    The index's own reference keeps an indexed block resident past its
    writer's retirement until the LRU cap on retained-but-UNREFERENCED
    blocks (refcount 1, the index's own) evicts it. A match touches its
    entries leaf-first, so eviction takes chain suffixes before the
    prefixes that reach them; evicting an entry drops its descendants too.

    TIERED (the host-RAM spill, ``models/hostkv.py``): with a ``spill``
    adapter (``store(dev_blocks) → host_ids | None`` and ``free``), an
    eviction COPIES the entry's device-tier subtree host-side instead of
    dropping it — the entries stay indexed at ``tier="host"`` with their
    device references released — or, when the host pool cannot hold the
    whole subtree, drops it plainly (billed in :attr:`spill_dropped`). An
    unreferenced interior entry implies an unreferenced subtree (a reader
    references every ancestor), so a host entry never has a device-tier
    descendant and every matched chain is a device prefix followed by a
    host tail (:meth:`match_tiered`); the engine grants fresh device
    blocks, imports the rows and :meth:`promote`\\ s the entries back."""

    def __init__(self, alloc: BlockAllocator, capacity: int, *,
                 spill=None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.alloc = alloc
        self.capacity = capacity
        self.spill = spill
        # key → (block, token chunk, parent key, tier) in LRU order; tier
        # "dev": a device block carrying one allocator reference; "host": a
        # host-pool id (the bytes live in the spill adapter's pool)
        self._entries: OrderedDict[bytes, tuple[int, tuple, bytes | None,
                                                str]] = OrderedDict()
        self._children: dict[bytes, set[bytes]] = {}
        self.hit_blocks = 0
        self.lookups = 0
        self.spilled_blocks = 0        # entries spilled, cumulative
        self.spill_dropped = 0         # evictions a full host pool dropped
        self.host_hit_blocks = 0       # host-tier entries matched
        # why the last reclaim() freed nothing (None after a fruitful one):
        # "live" = device-tier entries exist but tables reference every one;
        # "empty" = nothing device-resident is retained
        self.reclaim_blocked: str | None = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def retained_unreferenced(self) -> list[bytes]:
        """DEVICE-tier indexed blocks no table references (refcount 1 =
        ours only), in LRU order — the eviction candidates the cap
        bounds."""
        return [k for k, (b, _t, _p, tier) in self._entries.items()
                if tier == "dev" and self.alloc.refcount(b) == 1]

    @property
    def host_tier(self) -> list[bytes]:
        """Spilled entries (host-resident chains), in LRU order."""
        return [k for k, (_b, _t, _p, tier) in self._entries.items()
                if tier == "host"]

    @staticmethod
    def _key(parent: bytes | None, chunk: tuple) -> bytes:
        h = hashlib.blake2b(parent or b"root", digest_size=16)
        h.update(",".join(str(t) for t in chunk).encode())
        return h.digest()

    def match(self, chunks: Sequence[tuple]) -> list[int]:
        """Longest DEVICE-resident indexed chain prefix of ``chunks`` → its
        physical blocks, with one reference ADDED to each (the caller maps
        them into a table and frees them at retirement like any owned
        block). Matched entries become most recent, the leaf last. A
        host-tier entry ends the walk (:meth:`match_tiered` goes on)."""
        return self.match_tiered(chunks, host=False)[0]

    def _walk(self, chunks: Sequence[tuple]
              ) -> tuple[list[tuple[bytes, int]], list[tuple[bytes, int]]]:
        """The tier-aware chain walk, shared by the admission match and the
        prefetch probe: ``(dev, tail)`` as ``(key, id)`` pairs, the
        device-resident prefix and then the spilled continuation. No
        references, no LRU touch, no statistics."""
        dev: list[tuple[bytes, int]] = []
        tail: list[tuple[bytes, int]] = []
        parent: bytes | None = None
        for chunk in chunks:
            key = self._key(parent, chunk)
            ent = self._entries.get(key)
            if ent is None or ent[1] != chunk:
                break
            if ent[3] == "host":
                tail.append((key, ent[0]))
            elif tail:
                break          # never a device entry below a host one
            else:
                dev.append((key, ent[0]))
            parent = key
        return dev, tail

    def match_tiered(self, chunks: Sequence[tuple], *, host: bool = True
                     ) -> tuple[list[int], list[tuple[bytes, int]]]:
        """``(dev_blocks, host_tail)``: the device-resident chain prefix
        (one reference added to each, as :meth:`match`) and the spilled
        continuation as ``(key, host_id)`` pairs, deepest last. Host
        entries take no reference: the caller that swaps them in grants
        device blocks, imports the rows and calls :meth:`promote`; one that
        cannot just walks away."""
        self.lookups += 1
        dev, tail = self._walk(chunks)
        if not host:
            tail = []
        blocks = [b for _k, b in dev]
        for key in reversed([k for k, _b in dev] + [k for k, _h in tail]):
            self._entries.move_to_end(key)      # the leaf ends most recent
        if blocks:
            self.alloc.share(blocks)
            self.hit_blocks += len(blocks)
        self.host_hit_blocks += len(tail)
        return blocks, tail

    def peek_host_tail(self, chunks: Sequence[tuple]
                       ) -> list[tuple[bytes, int]]:
        """The spilled continuation :meth:`match_tiered` of ``chunks``
        would return — read-only (no reference, no LRU touch, no
        statistics): the swap-in prefetch's probe, which must never move
        the eviction order."""
        return self._walk(chunks)[1]

    def promote(self, keys: Sequence[bytes], blocks: Sequence[int]) -> None:
        """Re-register swapped-in entries as device-resident: ``blocks[i]``
        (a freshly granted block whose rows the caller imported) replaces
        ``keys[i]``'s host id; the index takes one reference to it and
        frees the host copy. Keys must be host-tier, in chain order."""
        if len(keys) != len(blocks):
            raise ValueError(f"{len(keys)} keys for {len(blocks)} blocks")
        for key, block in zip(keys, blocks):
            ent = self._entries.get(key)
            if ent is None or ent[3] != "host":
                raise ValueError(
                    "promote() takes host-tier entries — the chain moved "
                    "under the caller (evicted or already promoted); "
                    "re-match before swapping in")
            self.alloc.share([block])
            if self.spill is not None:
                self.spill.free([ent[0]])
            self._entries[key] = (block, ent[1], ent[2], "dev")

    def register(self, chunks: Sequence[tuple],
                 blocks: Sequence[int]) -> None:
        """Index ``blocks[i]`` as holding ``chunks[i]`` (a prefilled
        request's full own blocks, in chain order). Device-tier nodes
        already indexed are skipped (the donor matched them); each new
        entry takes one reference. A host-tier node the donor prefilled
        again is promoted in place: the donor's block replaces the host
        copy (the same content)."""
        if len(chunks) != len(blocks):
            raise ValueError(
                f"{len(chunks)} chunks for {len(blocks)} blocks")
        parent: bytes | None = None
        for chunk, block in zip(chunks, blocks):
            key = self._key(parent, chunk)
            ent = self._entries.get(key)
            if ent is None:
                self.alloc.share([block])
                self._entries[key] = (block, chunk, parent, "dev")
                if parent is not None:
                    self._children.setdefault(parent, set()).add(key)
            elif ent[3] == "host":
                self.alloc.share([block])
                if self.spill is not None:
                    self.spill.free([ent[0]])
                self._entries[key] = (block, chunk, parent, "dev")
            self._entries.move_to_end(key)
            parent = key

    def seed_host(self, chunks: Sequence[tuple],
                  host_ids: Sequence[int]) -> int:
        """Warm bring-up: register ``chunks[i]`` as a HOST-tier entry
        holding ``host_ids[i]`` — rows the caller already adopted into this
        index's spill pool (``HostBlockPool.adopt``). The first admission
        that matches a seeded chain swaps it in through the tiered path
        (crc-verified load, import, :meth:`promote`). A node already
        indexed (either tier) keeps its entry and the duplicate row goes
        back to the spill pool. Returns the NEW host-tier entries."""
        if self.spill is None:
            raise ValueError(
                "seed_host needs a spill adapter — the seeded entries "
                "live in the host tier")
        if len(chunks) != len(host_ids):
            raise ValueError(
                f"{len(chunks)} chunks for {len(host_ids)} host ids")
        seeded = 0
        parent: bytes | None = None
        for chunk, hid in zip(chunks, host_ids):
            key = self._key(parent, chunk)
            if key not in self._entries:
                self._entries[key] = (int(hid), chunk, parent, "host")
                if parent is not None:
                    self._children.setdefault(parent, set()).add(key)
                seeded += 1
            else:
                self.spill.free([int(hid)])
            self._entries.move_to_end(key)
            parent = key
        return seeded

    def export_chains(self) -> list[tuple[list[tuple],
                                          list[tuple[str, int]]]]:
        """Every maximal indexed chain as ``(chunks, [(tier, id), …])``,
        root-first within a chain and most-recently-used LEAF first across
        chains (``id`` a device block for ``"dev"``, a host-pool row for
        ``"host"``). Read-only: no references, no LRU touch, no eviction
        counts — the close-time publish walk into a warm store, whose
        capacity then keeps the popular head."""
        out: list[tuple[list[tuple], list[tuple[str, int]]]] = []
        for leaf in reversed(self._entries):
            if self._children.get(leaf):
                continue
            chunks: list[tuple] = []
            ids: list[tuple[str, int]] = []
            k: bytes | None = leaf
            while k is not None:
                block, chunk, parent, tier = self._entries[k]
                chunks.append(chunk)
                ids.append((tier, block))
                k = parent
            chunks.reverse()
            ids.reverse()
            out.append((chunks, ids))
        return out

    def _drop(self, key: bytes) -> int:
        """Drop ``key`` and every descendant (unreachable once the parent
        is gone), releasing the index's device reference or host copy on
        each. Returns the number of entries dropped."""
        n = 0
        stack = [key]
        while stack:
            k = stack.pop()
            ent = self._entries.pop(k, None)
            if ent is None:
                continue
            block, _chunk, parent, tier = ent
            if tier == "dev":
                self.alloc.free([block])
            elif self.spill is not None:
                self.spill.free([block])
            if parent is not None and parent in self._children:
                self._children[parent].discard(k)
            stack.extend(self._children.pop(k, ()))
            n += 1
        return n

    def discard(self, key: bytes) -> int:
        """Drop ``key`` and its whole subtree, NO spill — the quarantine of
        a spilled chain whose rows failed their crc (the request prefills
        from tokens; the suspect bytes are never spilled again)."""
        return self._drop(key)

    def _evict(self, key: bytes) -> int:
        """Evict ``key``: spill its device-tier subtree host-side when a
        spill adapter is wired (all or nothing — a half-spilled chain would
        strand its tail), else, or when the host pool cannot hold it, drop
        it. Returns the device-tier entries released either way (what
        ``reclaim``'s callers budget against)."""
        if self.spill is None:
            return self._drop(key)
        if getattr(self.spill, "chain_level", False):
            return self._evict_chain_level(key)
        sub: list[bytes] = []          # the device-tier subtree, parents first
        stack = [key]
        while stack:
            k = stack.pop()
            ent = self._entries.get(k)
            if ent is None:
                continue
            if ent[3] == "dev":
                sub.append(k)
            stack.extend(self._children.get(k, ()))
        if not sub:
            return 0
        hids = self.spill.store([self._entries[k][0] for k in sub])
        if hids is None:
            # the host pool is full: drop plainly, billed; host-tier
            # descendants free no device block, so count the device ones
            self.spill_dropped += len(sub)
            self._drop(key)
            return len(sub)
        for k, hid in zip(sub, hids):
            block, chunk, parent, _tier = self._entries[k]
            self.alloc.free([block])
            self._entries[k] = (hid, chunk, parent, "host")
        self.spilled_blocks += len(sub)
        return len(sub)

    def _evict_chain_level(self, key: bytes) -> int:
        """Chain-level eviction (a ``chain_level`` spill: the fleet-shared
        store, ``hostkv.ChainSpill``): hand every root→leaf chain through
        the evicted subtree, ancestors included, to the adapter's
        ``store_chains`` — the store files whole content-addressed chains
        and shares their common rows — then drop the subtree. No host-tier
        entry is made; a later hit comes back through the store's
        ``fetch`` at admission. Returns the device entries released."""
        if key not in self._entries:
            return 0
        prefix: list[tuple] = []        # (chunk, block), root → parent
        k = self._entries[key][2]
        while k is not None:
            ent = self._entries[k]
            prefix.append((ent[1], ent[0]))
            k = ent[2]
        prefix.reverse()
        chains: list[tuple[list, list]] = []
        released = 0
        stack: list[tuple[bytes, list]] = [(key, prefix)]
        while stack:
            k, path = stack.pop()
            ent = self._entries.get(k)
            if ent is None:
                continue
            path = path + [(ent[1], ent[0])]
            released += 1
            kids = [c for c in self._children.get(k, ())
                    if c in self._entries]
            if kids:
                stack.extend((c, path) for c in kids)
            else:
                chains.append(([c for c, _b in path],
                               [b for _c, b in path]))
        self.spill.store_chains(chains)
        self.spilled_blocks += released
        self._drop(key)
        return released

    def trim(self) -> int:
        """Enforce the LRU cap: evict least-recently-used retained-but-
        unreferenced entries (NEVER a block a live table references) until
        at most ``capacity`` remain — spilled when the tier is wired.
        Returns the entries evicted."""
        n = 0
        while True:
            cands = self.retained_unreferenced
            if len(cands) <= self.capacity:
                return n
            n += self._evict(cands[0])

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` retained-but-unreferenced entries now
        (allocation pressure: a block a new admission needs beats a
        retained prefix, whatever the cap says). Returns the device blocks
        released; 0 means the caller should queue, and
        :attr:`reclaim_blocked` says why."""
        freed = 0
        while freed < n:
            cands = self.retained_unreferenced
            if not cands:
                break
            freed += self._evict(cands[0])
        if freed == 0:
            self.reclaim_blocked = (
                "live" if any(tier == "dev" for _b, _t, _p, tier
                              in self._entries.values()) else "empty")
        else:
            self.reclaim_blocked = None
        return freed

    def release(self) -> int:
        """Drop every entry, device references and host copies (end of a
        run). Returns the entries dropped."""
        n = 0
        while self._entries:
            n += self._drop(next(iter(self._entries)))
        self._children.clear()
        return n


_POOL_KEYS = ("k", "v", "k_scale", "v_scale")


def pool_transfer_keys(pool: dict) -> list[str]:
    """The pool entries a block transfer moves: the per-layer physical
    buffers (``k``/``v``, and the int8 scale sidecars when present) —
    never ``block_tables``/``pos``, the receiver's own bookkeeping."""
    return [k for k in _POOL_KEYS if k in pool]


def _ids_on(ids: list[int], dev: torch.device) -> torch.Tensor:
    """Block ids as an index on ``dev``; on the card from pinned memory
    without blocking (a pageable copy would wait for every queued wave)."""
    t = torch.tensor(ids, dtype=torch.long)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def export_block_rows(pool: dict, block_ids: Sequence[int]) -> dict:
    """Copy the physical content of ``block_ids`` out of ``pool``: ``{key:
    [per-layer [n, block_size, ...] tensors]}`` in block-id order, on the
    pool's device, for every transferable key — the transfer unit a
    different pool imports with :func:`import_block_rows` (rows past a
    request's position in its last block ride along as unreachable
    garbage on both sides). On the card the gathers are queued on the
    current stream, after every wave queued before them."""
    ids_h = [int(b) for b in block_ids]
    if len(ids_h) < 1:
        raise ValueError("export_block_rows needs >= 1 block id")
    ids = _ids_on(ids_h, pool["k"][0].device)
    return {k: [buf.index_select(0, ids) for buf in pool[k]]
            for k in pool_transfer_keys(pool)}


def _crc_bytes(buf: torch.Tensor) -> memoryview:
    """The bytes of ``buf`` in C order, as ``np.asarray(buf).tobytes()``
    gives them (bf16 has no numpy dtype: it goes through a byte view)."""
    if isinstance(buf, np.ndarray):
        return memoryview(np.ascontiguousarray(buf).reshape(-1).view(
            np.uint8))
    t = buf.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous().reshape(-1).view(torch.uint8)
    return memoryview(t.numpy())


def transfer_crc(payload: dict) -> int:
    """crc32 over an :func:`export_block_rows` payload's wire content —
    buffers in key-sorted, layer order — the reference's integrity
    primitive: the same rows give the same crc in both packages, on the
    card or on the host. A mismatch at the receiving side is a classified
    transfer failure, never a silent import of garbage rows."""
    crc = 0
    for k in sorted(payload):
        for buf in payload[k]:
            crc = zlib.crc32(_crc_bytes(buf), crc)
    return crc


def import_block_rows(pool: dict, block_ids: Sequence[int],
                      payload: dict) -> dict:
    """Write :func:`export_block_rows` ``payload`` into ``pool`` at
    ``block_ids`` (the receiver's own allocated blocks) IN PLACE
    (``index_copy_`` into the pool's own tensors) and return the same
    dict. The reference returns a new dict of donated buffers; here the
    captured wave graphs read the pool's tensors by address, so the
    buffers must stay the same tensors. A host payload is copied to the
    pool's device first (from pinned memory without blocking); the
    copies and writes are queued on the current stream. Importing into a
    reserved block is refused: the garbage block is every fenced write's
    target."""
    ids_h = [int(b) for b in block_ids]
    if any(b < 1 for b in ids_h):
        raise ValueError(
            f"cannot import into reserved block(s) "
            f"{sorted(set(b for b in ids_h if b < 1))} "
            f"— block 0 is the garbage block every fenced write targets")
    keys = pool_transfer_keys(pool)
    if sorted(payload) != sorted(keys):
        raise ValueError(
            f"payload keys {sorted(payload)} do not match the pool's "
            f"transferable keys {sorted(keys)} (cache_dtype mismatch "
            f"between the exporting and importing pools?)")
    n = len(ids_h)
    for k in keys:
        for buf in payload[k]:
            if int(buf.shape[0]) != n:
                raise ValueError(
                    f"payload[{k!r}] carries {int(buf.shape[0])} blocks "
                    f"for {n} block ids")
    dev = pool["k"][0].device
    ids = _ids_on(ids_h, dev)
    cur = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    for k in keys:
        for buf, src in zip(pool[k], payload[k]):
            if src.device != dev:
                src = src.to(dev, non_blocking=True)
            elif cur is not None:
                # a staged payload came from another stream's allocation:
                # keep its memory until this stream has read it
                src.record_stream(cur)
            buf.index_copy_(0, ids, src)
    return pool


def paged_pool_spec(cfg: BurnInConfig, max_len: int, block_size: int,
                    cache_dtype: str = "bf16") -> dict[str, int]:
    """Static pool geometry: ``rows`` is ``decode.cache_rows``'s buffer
    length for ``max_len`` (int8 keeps its 256-row grain), ``tables`` the
    per-slot block-table width covering them."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    rows = cache_rows(max_len, cache_dtype)
    tables = blocks_for_rows(rows, block_size)
    return {"rows": rows, "tables": tables, "block_size": block_size,
            "logical_rows": tables * block_size}


def init_paged_cache(cfg: BurnInConfig, slots: int, max_len: int, *,
                     block_size: int, num_blocks: int, rules=None,
                     cache_dtype: str = "bf16",
                     device="cuda") -> dict[str, Any]:
    """Zeroed paged pool on ``device``: per layer ``k``/``v``
    ``[num_blocks, block_size, kv, D]`` in ``cfg.dtype`` — int8 under
    ``cache_dtype="int8"``, with f32 ``k_scale``/``v_scale`` ``[num_blocks,
    block_size, kv]`` sidecars — ``block_tables`` ``[slots, tables]`` int32
    (all 0: every slot points at the garbage block until its first
    admission) and ``pos`` ``[slots]`` int32. The forwards update the pool
    IN PLACE (the reference's functional update donated the buffers for
    the same effect).

    With ``rules`` (a ``torch.distributed`` world mesh) the pool is this
    rank's, on its device: the KV-head axis holds ``kv_heads / tp`` heads
    where ``tp`` divides them and all of them otherwise (the reference
    replicates the head axis there); the block axis, the tables and the
    positions are every slot's on every rank (blocks are assigned
    dynamically, so a block-sharded pool would shuffle every gather)."""
    check_serve_rules(rules, cfg)
    if rules is not None and isinstance(rules.mesh, WorldMesh):
        device = rules.mesh.device
    dev = check_device(device)
    quant = check_cache_dtype(cache_dtype)
    spec = paged_pool_spec(cfg, max_len, block_size, cache_dtype)
    kv_shape = (num_blocks, block_size, pool_kv_heads(cfg, rules),
                cfg.head_dim)

    def zeros(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for _ in range(cfg.n_layers)]

    buf = torch.int8 if quant else cfg.dtype
    pool: dict[str, Any] = {
        "k": zeros(kv_shape, buf),
        "v": zeros(kv_shape, buf),
        "block_tables": torch.zeros((slots, spec["tables"]),
                                    dtype=torch.int32, device=dev),
        "pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
    }
    if quant:
        pool["k_scale"] = zeros(kv_shape[:3], torch.float32)
        pool["v_scale"] = zeros(kv_shape[:3], torch.float32)
    return pool
