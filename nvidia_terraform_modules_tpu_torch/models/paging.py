# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Block/paged KV-cache allocation — the port of the reference's
``models/paging.py`` (``blocks_for_rows``, :class:`BlockAllocator`,
``paged_pool_spec``, ``init_paged_cache`` for the bf16 and the int8 pool,
and the device tier of cross-request prefix sharing: ``chain_chunks``,
``chunk_tokens_covered``, ``chain_key`` and :class:`PrefixIndex`).

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
from collections import OrderedDict
from typing import Any, Sequence

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
    This is the reference's device tier; its host-RAM spill tier is not
    ported."""

    def __init__(self, alloc: BlockAllocator, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.alloc = alloc
        self.capacity = capacity
        # key → (block, token chunk, parent key) in LRU order
        self._entries: OrderedDict[bytes, tuple[int, tuple,
                                                bytes | None]] = \
            OrderedDict()
        self._children: dict[bytes, set[bytes]] = {}
        self.hit_blocks = 0
        self.lookups = 0
        # why the last reclaim() freed nothing (None after a fruitful
        # one): "live" = indexed blocks exist but tables reference every
        # one; "empty" = nothing indexed
        self.reclaim_blocked: str | None = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def retained_unreferenced(self) -> list[bytes]:
        """Indexed blocks no table references (refcount 1 = ours only), in
        LRU order — the eviction candidates the cap bounds."""
        return [k for k, (b, _t, _p) in self._entries.items()
                if self.alloc.refcount(b) == 1]

    @staticmethod
    def _key(parent: bytes | None, chunk: tuple) -> bytes:
        h = hashlib.blake2b(parent or b"root", digest_size=16)
        h.update(",".join(str(t) for t in chunk).encode())
        return h.digest()

    def match(self, chunks: Sequence[tuple]) -> list[int]:
        """Longest indexed chain prefix of ``chunks`` → its physical blocks,
        with one reference ADDED to each (the caller maps them into a table
        and frees them at retirement like any owned block). Matched entries
        become most recent, the leaf last."""
        self.lookups += 1
        keys, blocks = [], []
        parent: bytes | None = None
        for chunk in chunks:
            key = self._key(parent, chunk)
            ent = self._entries.get(key)
            if ent is None or ent[1] != chunk:
                break
            keys.append(key)
            blocks.append(ent[0])
            parent = key
        for key in reversed(keys):              # leaf ends most recent
            self._entries.move_to_end(key)
        if blocks:
            self.alloc.share(blocks)
            self.hit_blocks += len(blocks)
        return blocks

    def register(self, chunks: Sequence[tuple],
                 blocks: Sequence[int]) -> None:
        """Index ``blocks[i]`` as holding ``chunks[i]`` (a prefilled
        request's full own blocks, in chain order). Chain nodes already
        indexed are skipped (the donor matched them); each new entry takes
        one reference."""
        if len(chunks) != len(blocks):
            raise ValueError(
                f"{len(chunks)} chunks for {len(blocks)} blocks")
        parent: bytes | None = None
        for chunk, block in zip(chunks, blocks):
            key = self._key(parent, chunk)
            if key not in self._entries:
                self.alloc.share([block])
                self._entries[key] = (block, chunk, parent)
                if parent is not None:
                    self._children.setdefault(parent, set()).add(key)
            self._entries.move_to_end(key)
            parent = key

    def _drop(self, key: bytes) -> int:
        """Drop ``key`` and every descendant (unreachable once the parent
        is gone), freeing the index's reference on each. Returns the
        number of entries dropped."""
        n = 0
        stack = [key]
        while stack:
            k = stack.pop()
            ent = self._entries.pop(k, None)
            if ent is None:
                continue
            block, _chunk, parent = ent
            self.alloc.free([block])
            if parent is not None and parent in self._children:
                self._children[parent].discard(k)
            stack.extend(self._children.pop(k, ()))
            n += 1
        return n

    def trim(self) -> int:
        """Enforce the LRU cap: evict least-recently-used retained-but-
        unreferenced entries (NEVER a block a live table references) until
        at most ``capacity`` remain. Returns the entries evicted."""
        n = 0
        while True:
            cands = self.retained_unreferenced
            if len(cands) <= self.capacity:
                return n
            n += self._drop(cands[0])

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` retained-but-unreferenced entries now
        (allocation pressure: a block a new admission needs beats a
        retained prefix, whatever the cap says). Returns the blocks
        released; 0 means the caller should queue, and
        :attr:`reclaim_blocked` says why."""
        freed = 0
        while freed < n:
            cands = self.retained_unreferenced
            if not cands:
                break
            freed += self._drop(cands[0])
        if freed == 0:
            self.reclaim_blocked = "live" if self._entries else "empty"
        else:
            self.reclaim_blocked = None
        return freed

    def release(self) -> int:
        """Drop every entry (end of a run). Returns the entries dropped."""
        n = 0
        while self._entries:
            n += self._drop(next(iter(self._entries)))
        self._children.clear()
        return n


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
