# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the paged KV cache's host side: the ``BlockAllocator``
invariants of ``tests/test_paging.py`` (no double grant, all-or-nothing,
block 0 never granted, LIFO recycling, refcounts, the fragmentation bound)
held by the port's copy, which must also replay any seeded operation
sequence exactly like the reference's allocator; and the prefix index's
chains (``chain_chunks``, ``chain_key``, ``chunk_tokens_covered``) and
``PrefixIndex``, whose match/register/trim/reclaim/release traces must
equal the reference's device tier call for call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import paging as jpaging
from nvidia_terraform_modules_tpu_torch.models import BurnInConfig
from nvidia_terraform_modules_tpu_torch.models.paging import (
    BlockAllocator,
    PrefixIndex,
    blocks_for_rows,
    chain_chunks,
    chain_key,
    chunk_tokens_covered,
    export_block_rows,
    import_block_rows,
    init_paged_cache,
    paged_pool_spec,
    pool_transfer_keys,
    transfer_crc,
)

TRANSFER_CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
                    seq_len=16, batch=2)
# (the config's dtype, the cache dtype): the f32 and bf16 pools, and the
# int8 pool with its f32 scale sidecars
TRANSFER_DTYPES = {"f32": (torch.float32, "bf16"),
                   "bf16": (torch.bfloat16, "bf16"),
                   "int8": (torch.float32, "int8")}


def seeded_pools(kind: str, seed: int, num_blocks: int = 9):
    """The same seeded content in a port pool (CPU) and a reference pool:
    ``(cfg, pool, jax_pool)``. bf16 rows cross as their bit patterns."""
    dtype, cache_dtype = TRANSFER_DTYPES[kind]
    cfg = BurnInConfig(**TRANSFER_CFG, dtype=dtype)
    jcfg = jburnin.BurnInConfig(**TRANSFER_CFG, dtype={
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])
    pool = init_paged_cache(cfg, 2, 24, block_size=4, num_blocks=num_blocks,
                            cache_dtype=cache_dtype, device="cpu")
    jpool = jpaging.init_paged_cache(jcfg, 2, 24, block_size=4,
                                     num_blocks=num_blocks,
                                     cache_dtype=cache_dtype)
    rng = np.random.default_rng(seed)
    for key in pool_transfer_keys(pool):
        for li, buf in enumerate(pool[key]):
            if buf.dtype == torch.int8:
                buf.copy_(torch.from_numpy(rng.integers(
                    -128, 128, buf.shape).astype(np.int8)))
            else:
                buf.copy_(torch.from_numpy(rng.standard_normal(
                    buf.shape).astype(np.float32)).to(buf.dtype))
            jpool[key][li] = jnp.asarray(to_numpy(buf))
    return cfg, pool, jpool


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as the reference's numpy array (bf16 as ml_dtypes')."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


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


def test_int8_pool_spec_and_layout_match_reference():
    kw = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2)
    cfg = BurnInConfig(**kw, dtype=torch.bfloat16)
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.bfloat16)
    for max_len, bs in ((16, 4), (300, 16), (256, 16), (5, 8)):
        assert paged_pool_spec(cfg, max_len, bs, "int8") == \
            jpaging.paged_pool_spec(jcfg, max_len, bs, "int8")
    pool = init_paged_cache(cfg, 3, 17, block_size=4, num_blocks=9,
                            cache_dtype="int8", device="cpu")
    want = jpaging.init_paged_cache(jcfg, 3, 17, block_size=4, num_blocks=9,
                                    cache_dtype="int8")
    assert set(pool) == set(want)
    for key, dtype in (("k", torch.int8), ("v", torch.int8),
                       ("k_scale", torch.float32), ("v_scale", torch.float32)):
        for t, j in zip(pool[key], want[key]):
            assert tuple(t.shape) == j.shape and t.dtype == dtype
            assert not t.any()
    assert tuple(pool["block_tables"].shape) == want["block_tables"].shape


@pytest.mark.parametrize("paged_kernel", ["off", "on"])
def test_forward_paged_int8_scales_ride_the_tables(paged_kernel):
    """An int8 pool through scattered blocks: the fresh rows and their
    scales land at the table's positions, equal to the dense int8 cache's,
    and the logits equal both the dense int8 cache's and the reference's
    paged int8 forward ("on" reads through the int8 paged kernel's plain
    version, "off" gathers rows and sidecars and runs K6's)."""
    import jax

    from nvidia_terraform_modules_tpu.models import decode as jdecode
    from nvidia_terraform_modules_tpu_torch.models import (
        forward_cached,
        forward_paged,
        init_cache,
        params_from_numpy,
    )

    kw = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              n_layers=2, rope=True)
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    prompt = np.random.default_rng(4).integers(0, 64, (1, 6)).astype(np.int32)
    table = np.array([[7, 2, 5, 3]], np.int32)
    dense = init_cache(cfg, 1, 16, cache_dtype="int8", device="cpu")
    pool = init_paged_cache(cfg, 1, 16, block_size=4, num_blocks=9,
                            cache_dtype="int8", device="cpu")
    # the int8 grain: 256 rows, a 64-entry table; the rest point at block 0
    assert tuple(pool["block_tables"].shape) == (1, 64)
    pool["block_tables"][0, :4] = torch.from_numpy(table[0])
    jpool = jpaging.init_paged_cache(jcfg, 1, 16, block_size=4,
                                     num_blocks=9, cache_dtype="int8")
    jpool["block_tables"] = jnp.asarray(pool["block_tables"].numpy())
    toks = torch.from_numpy(prompt).long()
    jtoks = jnp.asarray(prompt)
    for step in range(4):
        d_logits, dense = forward_cached(params, toks, dense, cfg)
        p_logits, pool = forward_paged(params, toks, pool, cfg,
                                       prefill_impl="dense",
                                       paged_kernel=paged_kernel)
        j_logits, jpool = jdecode.forward_paged(jp, jtoks, jpool, jcfg,
                                                prefill_impl="dense")
        torch.testing.assert_close(p_logits, d_logits, atol=1e-6, rtol=0)
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits),
                                   atol=1e-5, rtol=0)
        toks = d_logits[:, -1:].argmax(-1)
        jtoks = jnp.asarray(toks.numpy())
    n = int(pool["pos"][0])
    assert n == dense["pos"] == 9
    for li in range(cfg.n_layers):
        for key in ("k", "k_scale", "v", "v_scale"):
            logical = pool[key][li][torch.from_numpy(table[0]).long()]
            logical = logical.reshape((16,) + tuple(logical.shape[2:]))
            assert torch.equal(logical[:n], dense[key][li][0, :n]), key


@pytest.mark.parametrize("bs,offset", [(4, 0), (4, 3), (16, 0), (16, 6)])
@pytest.mark.parametrize("n", [0, 3, 17, 40])
def test_chain_helpers_equal_the_reference(bs, offset, n):
    toks = list(np.random.default_rng(n * 31 + bs).integers(0, 500, n))
    chunks = chain_chunks(toks, bs, offset)
    assert chunks == jpaging.chain_chunks(toks, bs, offset)
    for k in range(len(chunks) + 1):
        assert chunk_tokens_covered(k, bs, offset) == \
            jpaging.chunk_tokens_covered(k, bs, offset)
    for upto in range(1, len(chunks) + 1):
        assert chain_key(chunks, upto) == jpaging.chain_key(chunks, upto)
        assert chain_key(chunks[:upto]) == chain_key(chunks, upto)
    with pytest.raises(ValueError, match="offset"):
        chain_chunks(toks, bs, bs)
    with pytest.raises(ValueError, match="chunk"):
        chain_key(chunks, 0)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("capacity", [0, 2, 6])
def test_prefix_index_replays_reference_traces(seed, capacity):
    """Seeded admissions over a few shared chains: each prompt matches,
    allocates its unshared blocks, registers its chain, and retires later —
    with trims, pressure reclaims and a final release. Every return value,
    the index's size, its hit counters, why a reclaim came back empty and
    the allocator's state equal the reference's after every call."""
    rng = np.random.default_rng(seed)
    bs = 4
    stems = [list(rng.integers(0, 50, 12)) for _ in range(3)]
    sides = []
    for alloc_cls, index_cls in ((BlockAllocator, PrefixIndex),
                                 (jpaging.BlockAllocator,
                                  jpaging.PrefixIndex)):
        a = alloc_cls(40)
        sides.append((a, index_cls(a, capacity), {}, []))
    ops = rng.integers(0, 4, 60)
    for i, op in enumerate(ops):
        got = []
        for a, idx, owned, trace in sides:
            if op <= 1:                           # an admission
                stem = stems[i % 3][:4 + (i % 3) * 4]
                toks = stem + list(np.random.default_rng(i).integers(
                    0, 50, 1 + i % 5))
                chunks = chain_chunks(toks, bs)
                shared = idx.match(chunks)
                need = len(chunks) - len(shared) + 1
                own = a.alloc(need)
                if own is None and idx.reclaim(need - a.free_blocks):
                    own = a.alloc(need)
                if own is None:
                    a.free(shared)
                    out = ("held", tuple(shared), idx.reclaim_blocked)
                else:
                    blocks = shared + own
                    idx.register(chunks, blocks[:len(chunks)])
                    owned[i] = blocks
                    out = ("admitted", tuple(blocks))
            elif op == 2 and owned:               # the oldest retires
                req = min(owned)
                a.free(owned.pop(req))
                out = ("retired", req, idx.trim())
            else:
                out = ("reclaim", idx.reclaim(2), idx.reclaim_blocked)
            got.append((out, len(idx), idx.hit_blocks, idx.lookups,
                        a.stats(), sorted(idx.retained_unreferenced)))
        assert got[0] == got[1], i
    for a, idx, owned, _trace in sides:
        for blocks in owned.values():
            a.free(blocks)
    assert sides[0][1].release() == sides[1][1].release()
    assert sides[0][0].stats() == sides[1][0].stats()
    assert sides[0][0].in_use == 0


def test_prefix_index_never_evicts_a_referenced_block():
    a = BlockAllocator(12)
    idx = PrefixIndex(a, capacity=0)
    chunks = chain_chunks(list(range(12)), 4)
    blocks = a.alloc(3)
    idx.register(chunks, blocks)
    assert idx.trim() == 0 and len(idx) == 3      # the writer holds them
    assert idx.match(chunks) == blocks            # + one reference each
    a.free(blocks)
    assert idx.trim() == 0                        # the matcher holds them
    a.free(blocks)
    assert idx.trim() == 3 and len(idx) == 0 and a.in_use == 0
    assert idx.reclaim(1) == 0 and idx.reclaim_blocked == "empty"
    with pytest.raises(ValueError, match="capacity"):
        PrefixIndex(a, capacity=-1)


@pytest.mark.parametrize("kind", sorted(TRANSFER_DTYPES))
def test_export_import_round_trip_in_place_and_equal_to_reference(kind):
    """Blocks exported from one pool land bit for bit in another pool at
    other ids, in place (the pool's tensors and their addresses stay, the
    same dict comes back), untouched blocks keep their bytes, and the
    payload equals the reference's export of the same rows."""
    cfg, src, jsrc = seeded_pools(kind, 1)
    _, dst, _ = seeded_pools(kind, 2)
    keys = pool_transfer_keys(src)
    assert keys == jpaging.pool_transfer_keys(jsrc)
    before = {k: [b.clone() for b in dst[k]] for k in keys}
    ptrs = {k: [b.data_ptr() for b in dst[k]] for k in keys}
    payload = export_block_rows(src, [3, 5, 1])
    want = jpaging.export_block_rows(jsrc, [3, 5, 1])
    assert sorted(payload) == sorted(want)
    for k in keys:
        for got, ref in zip(payload[k], want[k]):
            assert tuple(got.shape) == ref.shape
            assert to_numpy(got).tobytes() == np.asarray(ref).tobytes()
    out = import_block_rows(dst, [7, 2, 8], payload)
    assert out is dst
    for k in keys:
        assert [b.data_ptr() for b in dst[k]] == ptrs[k]
        for li in range(cfg.n_layers):
            for s_b, d_b in zip((3, 5, 1), (7, 2, 8)):
                assert torch.equal(src[k][li][s_b].view(torch.uint8),
                                   dst[k][li][d_b].view(torch.uint8))
            assert torch.equal(dst[k][li][4], before[k][li][4])
    assert not dst["block_tables"].any() and not dst["pos"].any()


@pytest.mark.parametrize("kind", sorted(TRANSFER_DTYPES))
def test_transfer_crc_equals_the_reference_over_the_same_rows(kind):
    """``transfer_crc`` of the port's payload is the reference's crc of the
    reference's payload of the same rows; it survives a round trip, and a
    flipped element or another block order changes it."""
    _, src, jsrc = seeded_pools(kind, 4)
    _, dst, _ = seeded_pools(kind, 5)
    payload = export_block_rows(src, [3, 5, 1])
    crc = transfer_crc(payload)
    assert crc == jpaging.transfer_crc(
        jpaging.export_block_rows(jsrc, [3, 5, 1]))
    import_block_rows(dst, [7, 2, 8], payload)
    assert transfer_crc(export_block_rows(dst, [7, 2, 8])) == crc
    key = pool_transfer_keys(src)[0]
    bent = {k: [b.clone() for b in v] for k, v in payload.items()}
    bent[key][0].view(torch.uint8).view(-1)[0] ^= 1
    assert transfer_crc(bent) != crc
    assert transfer_crc(export_block_rows(src, [1, 5, 3])) != crc


def test_import_block_rows_refuses_as_the_reference():
    """The reserved block, a payload whose keys do not match the pool (a
    bf16 payload into an int8 pool) and a block-count mismatch refuse with
    the reference's messages, and an empty export too; nothing is
    written."""
    cfg = BurnInConfig(**TRANSFER_CFG, dtype=torch.float32)
    jcfg = jburnin.BurnInConfig(**TRANSFER_CFG, dtype=jnp.float32)
    bf = init_paged_cache(cfg, 1, 16, block_size=4, num_blocks=6,
                          device="cpu")
    q = init_paged_cache(cfg, 1, 16, block_size=4, num_blocks=6,
                         cache_dtype="int8", device="cpu")
    jbf = jpaging.init_paged_cache(jcfg, 1, 16, block_size=4, num_blocks=6)
    jq = jpaging.init_paged_cache(jcfg, 1, 16, block_size=4, num_blocks=6,
                                  cache_dtype="int8")
    payload = export_block_rows(bf, [2, 3])
    for k in payload:
        for b in payload[k]:
            b.fill_(1)
    jpayload = jpaging.export_block_rows(jbf, [2, 3])
    cases = ((bf, jbf, [0, 1]), (q, jq, [1, 2]), (bf, jbf, [1, 2, 3]))
    for (pool, jpool, ids), match in zip(cases, ("reserved block",
                                                 "transferable keys",
                                                 "block ids")):
        with pytest.raises(ValueError, match=match) as got:
            import_block_rows(pool, ids, payload)
        with pytest.raises(ValueError) as want:
            jpaging.import_block_rows(jpool, ids, jpayload)
        assert str(got.value) == str(want.value)
    assert not any(b.any() for k in ("k", "v") for b in bf[k] + q[k])
    with pytest.raises(ValueError, match=">= 1 block id"):
        export_block_rows(bf, [])
