# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the paged KV cache's host side: the ``BlockAllocator``
invariants of ``tests/test_paging.py`` (no double grant, all-or-nothing,
block 0 never granted, LIFO recycling, refcounts, the fragmentation bound)
held by the port's copy, which must also replay any seeded operation
sequence exactly like the reference's allocator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import paging as jpaging
from nvidia_terraform_modules_tpu_torch.models import BurnInConfig
from nvidia_terraform_modules_tpu_torch.models.paging import (
    BlockAllocator,
    blocks_for_rows,
    init_paged_cache,
    paged_pool_spec,
)


def test_alloc_is_all_or_nothing_and_exhaustion_returns_none():
    a = BlockAllocator(6)
    got = a.alloc(3)
    assert got is not None and len(got) == 3
    assert a.alloc(3) is None
    assert a.in_use == 3 and a.free_blocks == 2
    assert a.alloc(2) is not None and a.free_blocks == 0


def test_block_zero_is_never_granted():
    a = BlockAllocator(5)
    got = a.alloc(4)
    assert got is not None and 0 not in got
    assert a.alloc(1) is None


def test_free_recycles_and_double_free_is_loud():
    a = BlockAllocator(4)
    got = a.alloc(3)
    a.free(got[:2])
    assert sorted(a.alloc(2)) == sorted(got[:2])
    with pytest.raises(ValueError, match="not allocated"):
        a.free(got[:1] + got[:1])
    with pytest.raises(ValueError, match="not allocated"):
        a.free([0])


def test_high_water_and_validation():
    a = BlockAllocator(8)
    g = a.alloc(5)
    a.free(g[:4])
    a.alloc(2)
    assert a.in_use == 3 and a.stats()["high_water"] == 5
    with pytest.raises(ValueError, match="exceed"):
        BlockAllocator(1)
    with pytest.raises(ValueError, match="allocate"):
        a.alloc(-1)


def test_share_adds_reference_and_free_only_frees_at_zero():
    a = BlockAllocator(5)
    got = a.alloc(2)
    a.share(got)
    assert a.refcount(got[0]) == 2 and a.refs_total == 4
    a.free(got)
    assert a.in_use == 2 and a.free_blocks == 2
    a.free(got)
    assert a.in_use == 0 and a.free_blocks == 4
    with pytest.raises(ValueError, match="not allocated"):
        a.share(got)


@pytest.mark.parametrize("bs", [1, 4, 16])
def test_fragmentation_bound_blocks_for_rows(bs):
    for rows in (0, 1, bs - 1, bs, bs + 1, 5 * bs + 3):
        n = blocks_for_rows(rows, bs)
        assert n * bs >= rows and (n * bs - rows < bs or rows == 0)
        assert n == jpaging.blocks_for_rows(rows, bs)
    with pytest.raises(ValueError, match="rows"):
        blocks_for_rows(-1, bs)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_replays_reference_on_seeded_op_sequences(seed):
    """Alloc/share/free in a seeded random order: the port's allocator
    grants the same block ids, refuses the same requests and reports the
    same stats as the reference's at every step."""
    rng = np.random.default_rng(seed)
    ours, ref = BlockAllocator(17), jpaging.BlockAllocator(17)
    held: list[list[int]] = []
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0 or not held:
            n = int(rng.integers(0, 6))
            got, want = ours.alloc(n), ref.alloc(n)
            assert got == want
            if got:
                held.append(got)
        elif op == 1:
            blocks = held[int(rng.integers(0, len(held)))]
            ours.share(blocks)
            ref.share(blocks)
            held.append(list(blocks))
        else:
            blocks = held.pop(int(rng.integers(0, len(held))))
            ours.free(blocks)
            ref.free(blocks)
        assert ours.stats() == ref.stats()


def test_paged_pool_spec_and_pool_layout_match_reference():
    kw = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=3)
    cfg = BurnInConfig(**kw, dtype=torch.bfloat16)
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.bfloat16)
    for max_len, bs in ((16, 4), (17, 4), (40, 16), (5, 8)):
        assert paged_pool_spec(cfg, max_len, bs) == \
            jpaging.paged_pool_spec(jcfg, max_len, bs)
    pool = init_paged_cache(cfg, 3, 17, block_size=4, num_blocks=9,
                            device="cpu")
    want = jpaging.init_paged_cache(jcfg, 3, 17, block_size=4, num_blocks=9)
    for key in ("k", "v"):
        assert len(pool[key]) == 3
        for t, j in zip(pool[key], want[key]):
            assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
            assert not t.any()
    assert tuple(pool["block_tables"].shape) == want["block_tables"].shape
    assert pool["block_tables"].dtype == torch.int32
    assert pool["pos"].dtype == torch.int32 and not pool["pos"].any()
