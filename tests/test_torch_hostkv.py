# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the host KV tier on the CPU: ``models/hostkv.py``'s
``HostBlockPool`` and ``IndexSpill`` behind the tiered ``PrefixIndex``.

The tiered cases of the reference's ``tests/test_paging.py`` run the same
seeded operations on the reference (``models.paging``/``hostkv``) and on
the port, and compare the state after each: entries with their tiers and
ids (host ids included), refcounts, ``spilled_blocks``/``spill_dropped``,
the host pool's statistics and its crc stamps. A spill and a swap-in
round trip the rows bit for bit per cache dtype; a flipped host byte
raises ``HostSpillCorruptError`` from ``load`` and from ``stage``'s
future; the LRU never spills a live chain; a full host pool drops
plainly; the refcount sweep drains both tiers; ``peek_host_tail`` is
read-only and ``promote`` validates.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_paging import TRANSFER_DTYPES, seeded_pools, to_numpy

from nvidia_terraform_modules_tpu.models import hostkv as jhostkv
from nvidia_terraform_modules_tpu.models import paging as jpaging
from nvidia_terraform_modules_tpu_torch.models import hostkv, paging
from nvidia_terraform_modules_tpu_torch.models.paging import (
    chain_chunks,
    export_block_rows,
    import_block_rows,
    pool_transfer_keys,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors on a shared CPU: one intra-op thread a process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sides(kind="f32", *, host_blocks=8, cap=2, num_blocks=12, seed=7):
    """The reference's and the port's tiered wiring in miniature, over the
    same seeded device rows: one namespace each (``a``, ``idx``, ``host``,
    ``pool``, and the side's ``import_rows``)."""
    cfg, pool, jpool = seeded_pools(kind, seed, num_blocks=num_blocks)
    jcfg = types.SimpleNamespace(
        kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, n_layers=cfg.n_layers,
        dtype=jnp.bfloat16 if kind == "bf16" else jnp.float32)
    cache_dtype = TRANSFER_DTYPES[kind][1]
    out = []
    for pg, hk in ((jpaging, jhostkv), (paging, hostkv)):
        s = types.SimpleNamespace()
        s.a = pg.BlockAllocator(num_blocks)
        if hk is hostkv:
            s.pool = pool
            s.host = hk.HostBlockPool(cfg, host_blocks, block_size=4,
                                      cache_dtype=cache_dtype, device="cpu")

            def import_rows(s, ids, payload):
                import_block_rows(s.pool, ids, payload)
        else:
            s.pool = jpool
            s.host = hk.HostBlockPool(jcfg, host_blocks, block_size=4,
                                      cache_dtype=cache_dtype)

            def import_rows(s, ids, payload):
                s.pool = jpaging.import_block_rows(s.pool, ids, payload)
        s.import_rows = types.MethodType(import_rows, s)
        s.idx = pg.PrefixIndex(s.a, cap, spill=hk.IndexSpill(
            s.host, lambda s=s: s.pool))
        s.chunks = pg.chain_chunks
        out.append(s)
    return cfg, out


def state(s) -> tuple:
    """What the comparison holds: entries (key, tier, id) in LRU order,
    every block's refcount, the index's counters, the host pool's
    statistics and crc stamps."""
    return ([(k, tier, int(b)) for k, (b, _c, _p, tier)
             in s.idx._entries.items()],
            sorted(s.a._ref.items()), s.a.stats(), len(s.idx),
            s.idx.spilled_blocks, s.idx.spill_dropped,
            s.idx.host_hit_blocks, s.idx.hit_blocks, s.idx.lookups,
            s.idx.reclaim_blocked, s.host.stats(), sorted(s.host._crc.items()))


def both(ss, fn):
    """``fn(side)`` on the reference's side and the port's; their returns
    and their states must agree."""
    got = [fn(s) for s in ss]
    assert got[0] == got[1]
    assert state(ss[0]) == state(ss[1])
    return got[1]


def rows_bytes(s, blocks) -> dict:
    """The transferable rows of ``blocks`` as bytes, key → per layer."""
    if isinstance(s.pool["k"][0], torch.Tensor):
        pay = export_block_rows(s.pool, blocks)
        return {k: [to_numpy(b).tobytes() for b in v] for k, v in pay.items()}
    pay = jpaging.export_block_rows(s.pool, blocks)
    return {k: [np.asarray(b).tobytes() for b in v] for k, v in pay.items()}


@pytest.mark.parametrize("kind", sorted(TRANSFER_DTYPES))
def test_tiered_spill_swapin_roundtrip_bitwise(kind):
    """An evicted chain lands host-side (tier "host", device references
    released), the plain match stops at it, the tiered match names it
    without references, and a swap-in through fresh blocks reproduces
    every transferable buffer bit for bit — on both sides alike, the
    stamped crcs included. Both tiers drain at release."""
    cfg, ss = sides(kind, cap=0)
    chunks = chain_chunks(list(range(12)), 4)
    donor = both(ss, lambda s: s.a.alloc(3))
    both(ss, lambda s: s.idx.register(chunks, donor))
    before = [rows_bytes(s, donor) for s in ss]
    assert before[0] == before[1]
    both(ss, lambda s: s.a.free(donor))
    assert both(ss, lambda s: s.idx.trim()) == 3
    port = ss[1]
    assert len(port.idx.host_tier) == 3 and port.a.in_use == 0
    assert port.host.in_use == 3 and port.host.stored_blocks == 3
    assert both(ss, lambda s: s.idx.match(chunks)) == []
    dev, tail = both(ss, lambda s: s.idx.match_tiered(chunks))
    assert dev == [] and len(tail) == 3 and port.a.refs_total == 0
    fresh = both(ss, lambda s: s.a.alloc(3))
    ptrs = [b.data_ptr() for b in port.pool["k"]]

    def swap(s):
        s.import_rows(fresh, s.host.load([h for _k, h in tail]))
        s.idx.promote([k for k, _h in tail], fresh)
    both(ss, swap)
    assert [b.data_ptr() for b in port.pool["k"]] == ptrs
    assert port.host.in_use == 0 and port.host.loaded_blocks == 3
    for s in ss:
        assert rows_bytes(s, fresh) == before[0]
    assert both(ss, lambda s: s.idx.match(chunks)) == fresh
    both(ss, lambda s: (s.a.free(fresh), s.a.free(fresh), s.idx.release()))
    assert port.a.in_use == 0 and port.a.refs_total == 0
    assert port.host.in_use == 0


@pytest.mark.parametrize("kind", sorted(TRANSFER_DTYPES))
def test_host_stamp_is_transfer_crc_of_the_block(kind):
    """The stamp of each stored block is ``transfer_crc`` of its
    single-block payload, in the port and in the reference (whose stamp
    it equals); ``load`` and ``stage`` return the stored rows."""
    cfg, ss = sides(kind, cap=0, host_blocks=6)
    port = ss[1]
    chunks = chain_chunks(list(range(16)), 4)
    donor = both(ss, lambda s: s.a.alloc(4))
    want = export_block_rows(port.pool, donor)
    both(ss, lambda s: s.idx.register(chunks, donor))
    both(ss, lambda s: s.a.free(donor))
    both(ss, lambda s: s.idx.trim())
    tail = port.idx.peek_host_tail(chunks)
    for j, (_k, hid) in enumerate(tail):
        one = {k: [b[j:j + 1] for b in v] for k, v in want.items()}
        assert port.host._crc[hid] == paging.transfer_crc(one)
    hids = [h for _k, h in tail]
    for got in (port.host.load(hids), port.host.stage(hids).result()):
        for k in pool_transfer_keys(port.pool):
            for g, w in zip(got[k], want[k]):
                assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    port.host.close()


def test_tiered_crc_corruption_is_loud_and_classified():
    """A flipped host byte raises the classified HostSpillCorruptError
    from ``load`` and from ``stage``'s future (the worker verifies the
    snapshot it copies); an intact row still loads; the quarantine
    (``discard``) empties both tiers of the chain, and a freed id is
    refused as foreign — on both sides alike."""
    _, ss = sides(cap=0)
    port = ss[1]
    chunks = chain_chunks(list(range(8)), 4)
    donor = both(ss, lambda s: s.a.alloc(2))
    both(ss, lambda s: s.idx.register(chunks, donor))
    both(ss, lambda s: s.a.free(donor))
    both(ss, lambda s: s.idx.trim())
    (k1, h1), (_k2, h2) = both(ss, lambda s: s.idx.peek_host_tail(chunks))
    ss[0].host._bufs["k"][0][h2, 0, 0, 0] += 1
    port.host._bufs["k"][0][h2, 0, 0, 0] += 1
    for s, err in zip(ss, (jhostkv.HostSpillCorruptError,
                           hostkv.HostSpillCorruptError)):
        with pytest.raises(err, match="crc"):
            s.host.load([h2])
    with pytest.raises(hostkv.HostSpillCorruptError, match="crc"):
        port.host.stage([h2]).result()
    with pytest.raises(jhostkv.HostSpillCorruptError, match="crc"):
        ss[0].host.stage([h2])
    both(ss, lambda s: (s.host.load([h1]), None)[1])
    assert both(ss, lambda s: s.idx.discard(k1)) == 2
    assert len(port.idx) == 0 and port.host.in_use == 0
    for s in ss:
        with pytest.raises(ValueError, match="foreign"):
            s.host.load([h1])
    port.host.close()


def test_tiered_lru_never_spills_a_live_referenced_chain():
    """A chain a live table still references is never an eviction
    candidate — neither dropped nor spilled — until its reader retires."""
    _, ss = sides(cap=0)
    c1 = chain_chunks(list(range(8)), 4)
    c2 = chain_chunks([9, 9, 9, 9], 4)
    d1 = both(ss, lambda s: s.a.alloc(2))
    both(ss, lambda s: s.idx.register(c1, d1))
    d2 = both(ss, lambda s: s.a.alloc(1))
    both(ss, lambda s: s.idx.register(c2, d2))
    reader = both(ss, lambda s: s.idx.match(c1))
    both(ss, lambda s: (s.a.free(d1), s.a.free(d2)))
    both(ss, lambda s: s.idx.trim())
    port = ss[1]
    assert len(port.idx.host_tier) == 1
    assert all(port.a.refcount(b) >= 2 for b in d1)
    assert both(ss, lambda s: s.idx.match(c1)) == d1
    both(ss, lambda s: (s.a.free(d1), s.a.free(reader)))
    both(ss, lambda s: s.idx.trim())
    assert len(port.idx.host_tier) == 3 and port.a.in_use == 0
    both(ss, lambda s: s.idx.release())
    assert port.host.in_use == 0 and port.a.refs_total == 0


def test_tiered_host_exhaustion_falls_back_to_plain_drop():
    """A chain the host pool cannot hold whole is dropped (its device
    blocks freed, billed in ``spill_dropped``); a chain that fits still
    spills."""
    _, ss = sides(host_blocks=2, cap=0)
    ca = chain_chunks([5, 5, 5, 5], 4)
    cb = chain_chunks(list(range(12)), 4)
    da = both(ss, lambda s: s.a.alloc(1))
    both(ss, lambda s: s.idx.register(ca, da))
    db = both(ss, lambda s: s.a.alloc(3))
    both(ss, lambda s: s.idx.register(cb, db))
    both(ss, lambda s: (s.a.free(da), s.a.free(db)))
    assert both(ss, lambda s: s.idx.trim()) == 4
    port = ss[1]
    assert port.a.in_use == 0 and len(port.idx.host_tier) == 1
    assert port.idx.spilled_blocks == 1 and port.idx.spill_dropped == 3
    assert port.host.in_use == 1 and port.host.stored_blocks == 1
    assert both(ss, lambda s: s.idx.match_tiered(cb)) == ([], [])
    assert len(both(ss, lambda s: s.idx.peek_host_tail(ca))) == 1
    both(ss, lambda s: s.idx.release())
    assert port.host.in_use == 0


def test_tiered_refcount_leak_sweep_across_tiers():
    """Admit, share, spill, swap in, re-register over a host chain and
    retire, interleaved: every device block comes back, no reference is
    left, and the host pool ends empty."""
    _, ss = sides(cap=1, num_blocks=14)
    port = ss[1]
    initial = port.a.free_blocks
    c1 = chain_chunks(list(range(12)), 4)
    c2 = chain_chunks([7] * 8, 4)
    d1 = both(ss, lambda s: s.a.alloc(3))
    both(ss, lambda s: s.idx.register(c1, d1))
    d2 = both(ss, lambda s: s.a.alloc(2))
    both(ss, lambda s: s.idx.register(c2, d2))
    shared = both(ss, lambda s: s.idx.match(c1))
    both(ss, lambda s: (s.a.free(d1), s.a.free(d2)))
    both(ss, lambda s: s.idx.trim())
    assert len(port.idx.host_tier) >= 1
    both(ss, lambda s: s.a.free(shared))
    assert both(ss, lambda s: s.idx.reclaim(8)) > 0
    assert port.a.in_use == 0
    dev, tail = both(ss, lambda s: s.idx.match_tiered(c1))
    assert dev == [] and len(tail) == 3
    fresh = both(ss, lambda s: s.a.alloc(len(tail)))

    def swap(s):
        s.import_rows(fresh, s.host.load([h for _k, h in tail]))
        s.idx.promote([k for k, _h in tail], fresh)
        s.a.free(fresh)
    both(ss, swap)
    dup = both(ss, lambda s: s.a.alloc(2))
    both(ss, lambda s: s.idx.register(c2, dup))
    assert port.idx.host_tier == []
    both(ss, lambda s: (s.a.free(dup), s.idx.release()))
    assert port.a.in_use == 0 and port.a.refs_total == 0
    assert port.a.free_blocks == initial and port.host.in_use == 0


def test_tiered_peek_is_read_only_and_promote_validates():
    """``peek_host_tail`` takes no reference, moves no LRU entry and
    counts nothing; ``promote`` refuses a length mismatch and a key that
    is no longer host-tier, with the reference's messages."""
    _, ss = sides(cap=0)
    port = ss[1]
    chunks = chain_chunks(list(range(8)), 4)
    donor = both(ss, lambda s: s.a.alloc(2))
    both(ss, lambda s: s.idx.register(chunks, donor))
    both(ss, lambda s: (s.a.free(donor), s.idx.trim()))
    order = list(port.idx._entries)
    tail = both(ss, lambda s: s.idx.peek_host_tail(chunks))
    assert len(tail) == 2 and list(port.idx._entries) == order
    assert port.idx.lookups == 0 and port.idx.host_hit_blocks == 0
    assert port.a.refs_total == 0

    def refused(s, keys, blocks):
        with pytest.raises(ValueError) as exc:
            s.idx.promote(keys, blocks)
        return str(exc.value)
    assert "keys" in both(ss, lambda s: refused(s, [tail[0][0]], []))
    fresh = both(ss, lambda s: s.a.alloc(2))
    both(ss, lambda s: s.idx.promote([k for k, _h in tail], fresh))
    assert "host-tier" in both(
        ss, lambda s: refused(s, [tail[0][0]], [fresh[0]]))
    both(ss, lambda s: (s.a.free(fresh), s.idx.release()))
    assert port.a.in_use == 0 and port.host.in_use == 0


@pytest.mark.parametrize("seed", range(4))
def test_tiered_index_replays_reference_traces(seed):
    """Seeded admissions over a few chains through the tiered index: each
    matches tiered, swaps its host tail in (load, import, promote; or, on
    a dry pool, walks away), allocates its own blocks with pressure
    reclaims, registers and retires later, with trims and a final
    release — every return and the whole state (host ids included) equal
    the reference's after every call, and the swapped-in rows equal the
    reference's."""
    rng = np.random.default_rng(seed)
    _, ss = sides(cap=int(rng.integers(0, 3)), num_blocks=20,
                  host_blocks=int(rng.integers(4, 12)), seed=seed)
    stems = [list(rng.integers(0, 50, 12)) for _ in range(3)]
    owned = [{}, {}]
    for i, op in enumerate(rng.integers(0, 4, 50)):
        def step(s, own=None):
            own = owned[ss.index(s)]
            if op <= 1:
                stem = stems[i % 3][:4 + (i % 3) * 4]
                toks = stem + list(np.random.default_rng(i).integers(
                    0, 50, 1 + i % 5))
                chunks = s.chunks(toks, 4)
                shared, tail = s.idx.match_tiered(chunks)
                if tail:
                    fresh = s.a.alloc(len(tail))
                    if fresh is None and s.idx.reclaim(
                            len(tail) - s.a.free_blocks):
                        fresh = s.a.alloc(len(tail))
                    if fresh is not None:
                        s.import_rows(fresh, s.host.load(
                            [h for _k, h in tail]))
                        s.idx.promote([k for k, _h in tail], fresh)
                        shared = shared + fresh
                need = len(chunks) - len(shared) + 1
                mine = s.a.alloc(need)
                if mine is None and s.idx.reclaim(need - s.a.free_blocks):
                    mine = s.a.alloc(need)
                if mine is None:
                    s.a.free(shared)
                    return ("held", tuple(shared), s.idx.reclaim_blocked)
                blocks = shared + mine
                s.idx.register(chunks, blocks[:len(chunks)])
                own[i] = blocks
                return ("admitted", tuple(blocks), len(tail))
            if op == 2 and own:
                req = min(own)
                s.a.free(own.pop(req))
                return ("retired", req, s.idx.trim())
            return ("reclaim", s.idx.reclaim(2), s.idx.reclaim_blocked)
        both(ss, step)
        live = sorted({b for blocks in owned[1].values() for b in blocks})
        if live:
            assert rows_bytes(ss[0], live) == rows_bytes(ss[1], live), i
    for s, own in zip(ss, owned):
        for blocks in own.values():
            s.a.free(blocks)
    assert both(ss, lambda s: s.idx.release()) >= 0
    assert ss[1].a.in_use == 0 and ss[1].host.in_use == 0


def test_host_pool_validation_reset_and_layout():
    """The reference's refusals; the layout (per layer ``[host_blocks,
    block_size, kv, D]``, f32 sidecars for int8), its bytes and ``reset``
    (a fresh allocator over the same buffers); a CPU engine's pool is not
    pinned."""
    cfg, _ = sides("int8")
    for kw, match in (({"host_blocks": 0}, "host_blocks"),
                      ({"block_size": 0}, "block_size"),
                      ({"cache_dtype": "fp8"}, "cache_dtype")):
        args = {"host_blocks": 4, "block_size": 4, "cache_dtype": "int8",
                **kw}
        with pytest.raises(ValueError, match=match):
            hostkv.HostBlockPool(cfg, args.pop("host_blocks"), device="cpu",
                                 **args)
    host = hostkv.HostBlockPool(cfg, 5, block_size=4, cache_dtype="int8",
                                device="cpu")
    assert sorted(host._bufs) == ["k", "k_scale", "v", "v_scale"]
    assert host._bufs["k"][0].shape == (5, 4, cfg.kv_heads, cfg.head_dim)
    assert host._bufs["k"][0].dtype == torch.int8
    assert host._bufs["v_scale"][1].shape == (5, 4, cfg.kv_heads)
    assert host._bufs["v_scale"][1].dtype == torch.float32
    assert not host._bufs["k"][0].is_pinned()
    assert host.nbytes == cfg.n_layers * 2 * 5 * 4 * cfg.kv_heads * (
        cfg.head_dim + 4)
    _, pool, _ = seeded_pools("int8", 3)
    assert host.store(pool, [1, 2, 3]) == [0, 1, 2]
    assert host.store(pool, [4, 5, 6]) is None       # all or nothing
    assert host.stats()["in_use"] == 3
    bf = paging.init_paged_cache(cfg, 1, 16, block_size=4, num_blocks=6,
                                 device="cpu")
    with pytest.raises(ValueError, match="cache_dtype mismatch"):
        host.store(bf, [1])
    host.reset()
    assert host.stats() == {"host_blocks": 5, "in_use": 0, "free": 5,
                            "high_water": 0, "stored_blocks": 0,
                            "loaded_blocks": 0}
    with pytest.raises(ValueError, match="foreign"):
        host.load([0])


# ------------------------------------------ warm bring-up and the CDN tier


@pytest.mark.parametrize("kind", sorted(TRANSFER_DTYPES))
def test_adopt_stamps_rows_as_the_reference(kind):
    """``adopt`` of an exported payload (the warm join's door into a host
    pool): the same host ids, crc stamps and statistics as the reference's
    adopt of the same rows, all or nothing, and ``load`` returns the rows
    bit for bit."""
    cfg, ss = sides(kind, host_blocks=5)
    port = ss[1]
    got = both(ss, lambda s: s.host.adopt(
        (export_block_rows if s is port else jpaging.export_block_rows)(
            s.pool, [2, 3, 5])))
    assert got == [0, 1, 2]
    assert both(ss, lambda s: s.host.adopt(
        (export_block_rows if s is port else jpaging.export_block_rows)(
            s.pool, [1, 4, 6]))) is None
    want = export_block_rows(port.pool, [2, 3, 5])
    back = port.host.load(got)
    for k in want:
        for g, w in zip(back[k], want[k]):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    # numpy rows as a disk record holds them (bf16 as 16-bit patterns)
    rec = {k: [hostkv._record_array(b) for b in v] for k, v in want.items()}
    assert port.host.adopt({k: [b[:1] for b in v]
                            for k, v in rec.items()}) == [3]
    assert port.host._crc[3] == port.host._crc[0]


def test_seed_host_and_export_chains_equal_the_reference():
    """Warm seeding: ``seed_host`` files adopted rows as host-tier entries
    (a node already indexed keeps its entry and the duplicate row goes
    back), the tiered match swaps them in, and ``export_chains`` lists
    every maximal chain MRU-leaf first, read-only — state equal to the
    reference's after each step."""
    cfg, ss = sides("f32", host_blocks=8, cap=4)
    port = ss[1]
    toks = list(range(12))
    a = chain_chunks(toks, 4)
    b = chain_chunks(toks[:8] + [60, 61, 62, 63], 4)

    def seed(s, chunks, blocks):
        ex = (export_block_rows if s is port else jpaging.export_block_rows)
        return s.idx.seed_host(chunks, s.host.adopt(ex(s.pool, blocks)))
    assert both(ss, lambda s: seed(s, a, [1, 2, 3])) == 3
    assert both(ss, lambda s: seed(s, b, [1, 2, 4])) == 1
    assert port.host.in_use == 4
    donor = both(ss, lambda s: s.a.alloc(2))
    both(ss, lambda s: s.idx.register(chain_chunks([9] * 8, 4), donor))
    both(ss, lambda s: s.a.free(donor))
    got = both(ss, lambda s: s.idx.export_chains())
    assert [len(c) for c, _ids in got] == [2, 3, 3]
    assert got[0][1] == [("dev", donor[0]), ("dev", donor[1])]
    dev, tail = both(ss, lambda s: s.idx.match_tiered(a))
    assert dev == [] and len(tail) == 3
    with pytest.raises(ValueError, match="seed_host needs a spill"):
        paging.PrefixIndex(port.a, 2).seed_host(a, [0, 1, 2])
    both(ss, lambda s: s.idx.release())
    assert port.host.in_use == 0 and port.a.in_use == 0


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_chain_level_eviction_publishes_whole_chains(kind):
    """A ``ChainSpill`` index (the shared-store engine's): eviction hands
    every root→leaf chain through the evicted subtree to the store — the
    shared template rows filed once — then drops it, no host-tier entry
    made; index state and store ledger equal the reference's, and a fetch
    returns the evicted rows bit for bit."""
    cfg, pool, jpool = seeded_pools(kind, 5, num_blocks=12)
    jcfg = types.SimpleNamespace(kv_heads=cfg.kv_heads,
                                 head_dim=cfg.head_dim,
                                 n_layers=cfg.n_layers, dtype=jnp.float32)
    cache_dtype = TRANSFER_DTYPES[kind][1]
    stores = [jhostkv.WarmChainStore(jcfg, 16, block_size=4,
                                     cache_dtype=cache_dtype),
              hostkv.WarmChainStore(cfg, 16, block_size=4,
                                    cache_dtype=cache_dtype, device="cpu")]
    ss = []
    for pg, hk, st, pl in ((jpaging, jhostkv, stores[0], jpool),
                           (paging, hostkv, stores[1], pool)):
        s = types.SimpleNamespace(a=pg.BlockAllocator(12), pool=pl,
                                  host=st.pool)
        s.idx = pg.PrefixIndex(s.a, 0, spill=hk.ChainSpill(
            st, lambda s=s: s.pool))
        ss.append(s)
    tmpl = list(range(8))
    chains = [chain_chunks(tmpl + [40 + i] * 4, 4) for i in range(2)]
    want = export_block_rows(pool, [1, 2, 3])
    both(ss, lambda s: s.a.alloc(3))
    both(ss, lambda s: s.idx.register(chains[0], [1, 2, 3]))
    # a second request shares the template's two blocks
    assert both(ss, lambda s: s.idx.match(chains[1])) == [1, 2]
    both(ss, lambda s: s.a.alloc(1))
    both(ss, lambda s: s.idx.register(chains[1], [1, 2, 4]))
    both(ss, lambda s: s.a.free([1, 2, 3]))
    both(ss, lambda s: s.a.free([1, 2, 4]))
    assert both(ss, lambda s: s.idx.trim()) == 4
    assert len(ss[1].idx) == 0 and ss[1].a.in_use == 0
    got = [st.stats() for st in stores]
    assert got[0] == got[1]
    assert got[1]["chains"] == 2 and got[1]["blocks_in_use"] == 4
    n, rows, disk = stores[1].fetch(chains[0])
    assert (n, disk) == (3, False)
    for k in want:
        for g, w in zip(rows[k], want[k]):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    with pytest.raises(ValueError, match="leaked"):
        ss[1].idx.spill.free([0])
