# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Block/paged KV-cache allocation — the port of the reference's
``models/paging.py`` (``blocks_for_rows``, :class:`BlockAllocator`,
``paged_pool_spec``, ``init_paged_cache`` for the bf16 pool).

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

from typing import Any, Sequence

import torch

from .burnin import BurnInConfig, check_device


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


def paged_pool_spec(cfg: BurnInConfig, max_len: int,
                    block_size: int) -> dict[str, int]:
    """Static pool geometry: ``rows`` (the bf16 cache keeps ``max_len``
    rows), ``tables`` the per-slot block-table width covering them."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    rows = max_len
    tables = blocks_for_rows(rows, block_size)
    return {"rows": rows, "tables": tables, "block_size": block_size,
            "logical_rows": tables * block_size}


def init_paged_cache(cfg: BurnInConfig, slots: int, max_len: int, *,
                     block_size: int, num_blocks: int,
                     device="cuda") -> dict[str, Any]:
    """Zeroed paged pool on ``device``: per layer ``k``/``v``
    ``[num_blocks, block_size, kv, D]`` in ``cfg.dtype``, ``block_tables``
    ``[slots, tables]`` int32 (all 0: every slot points at the garbage
    block until its first admission) and ``pos`` ``[slots]`` int32.
    The forwards update the pool IN PLACE (the reference's functional
    update donated the buffers for the same effect)."""
    dev = check_device(device)
    spec = paged_pool_spec(cfg, max_len, block_size)
    kv_shape = (num_blocks, block_size, cfg.kv_heads, cfg.head_dim)

    def zeros():
        return torch.zeros(kv_shape, dtype=cfg.dtype, device=dev)

    return {
        "k": [zeros() for _ in range(cfg.n_layers)],
        "v": [zeros() for _ in range(cfg.n_layers)],
        "block_tables": torch.zeros((slots, spec["tables"]),
                                    dtype=torch.int32, device=dev),
        "pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
    }
