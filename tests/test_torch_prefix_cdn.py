# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the durable prefix CDN on the CPU, against the JAX package
on the reference's own cases (``tests/test_prefix_cdn.py``).

The three tiers (the device pool, the fleet-shared ``WarmChainStore``, the
crash-safe ``DiskChainStore``) are a cache: every request equals its solo
greedy decode and the JAX engine's tokens on the same f32 weights, through
a whole-fleet SIGKILL and a cold rebuild over the same directory, and over
a tier whose frames were corrupted (each quarantined with the reason the
reference's store gives the same file) or that cannot be reached. The
directory format is the reference's: a directory written by one package at
f32 restores in the other with the same file names, catalog and ``seq``
order. The reference's slow matrix stays slow here.
"""

import functools
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import fleet as jfleet
from nvidia_terraform_modules_tpu.models import hostkv as jhostkv
from nvidia_terraform_modules_tpu.models.serving import (
    make_serve_engine as jax_engine,
)
from nvidia_terraform_modules_tpu.utils.traffic import shared_prefix_prompts
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    DiskChainStore,
    MultiProcTransport,
    WarmChainStore,
    greedy_decode,
    make_fleet,
    make_serve_engine,
    params_from_numpy,
)

CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
           seq_len=32, batch=2)

# what each seeded corruption does to a frame, and the reason it earns
_CORRUPTIONS = {
    "bitflip": "crc mismatch",
    "truncate_body": "truncated body",
    "truncate_header": "truncated header",
    "stale_key": "stale key",
    "bad_magic": "bad magic",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors on a shared CPU: one intra-op thread a process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _zipf_setup(seed=2, n=10, templates=3, wave_seed=0):
    jcfg = jburnin.BurnInConfig(**CFG, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    pairs = shared_prefix_prompts(n, seed=wave_seed, n_templates=templates,
                                  template_len=8, suffix_lo=1, suffix_hi=4,
                                  vocab=jcfg.vocab)
    prompts = tuple(np.asarray(p, np.int32) for _t, p in pairs)
    max_len = max(len(p) for p in prompts) + 7
    cfg = BurnInConfig(**CFG, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jcfg, jp, cfg, params, prompts, max_len


@functools.lru_cache(maxsize=None)
def _want(seed=2, n=10, templates=3, wave_seed=0):
    """Solo greedy decoding, held equal to the JAX engine's tokens."""
    jcfg, jp, cfg, params, prompts, max_len = _zipf_setup(
        seed, n, templates, wave_seed)
    solo = tuple(tuple(greedy_decode(params, torch.from_numpy(p)[None], 5,
                                     cfg, device="cpu")[0].tolist())
                 for p in prompts)
    ref = jax_engine(jp, jcfg, max_len=max_len, kv_block=4)(
        [jnp.asarray(p) for p in prompts], 5, slots=4)
    assert [tuple(int(t) for t in np.asarray(o)) for o in ref] == list(solo)
    return solo


def _assert_all_equal(outs, want, label=""):
    for i, (g, w) in enumerate(zip(outs, want)):
        assert g is not None, f"{label} request {i} unserved"
        assert [int(t) for t in np.asarray(g)] == list(w), \
            f"{label} request {i} diverged"


def _frames(spill_dir):
    """Every filed ``.pcd`` frame under the objects tree, sorted."""
    out = []
    objects = os.path.join(spill_dir, "objects")
    for shard in sorted(os.listdir(objects)):
        sdir = os.path.join(objects, shard)
        if os.path.isdir(sdir):
            out.extend(os.path.join(sdir, n) for n in sorted(os.listdir(sdir))
                       if n.endswith(".pcd"))
    return out


def _corrupt(fpath, kind, donor=None):
    raw = open(fpath, "rb").read()
    if kind == "bitflip":
        buf = bytearray(raw)
        buf[len(buf) - 8] ^= 0x40            # inside the pickled body
        raw = bytes(buf)
    elif kind == "truncate_body":
        raw = raw[:len(raw) // 2]
    elif kind == "truncate_header":
        raw = raw[:6]
    elif kind == "bad_magic":
        raw = b"XXXX" + raw[4:]
    elif kind == "stale_key":
        raw = open(donor, "rb").read()       # a good frame, misfiled
    open(fpath, "wb").write(raw)


def _cdn_engine(params, cfg, max_len, store):
    return make_serve_engine(params, cfg, max_len=max_len, kv_block=4,
                             share_prefix=True, prefix_keep_blocks=0,
                             shared_store=store, device="cpu")


def _store(cfg, disk):
    return WarmChainStore(cfg, 32, block_size=4, disk=disk, device="cpu")


# ------------------------------------------------- whole-fleet restart


def test_fleet_whole_kill_rebuild_disk_warm_bit_match_tier1(tmp_path):
    """An in-process fleet writes the template head through to disk; a
    process fleet over the same directory seeds its replicas from the
    restored store and equals it; every replica process is then SIGKILLed
    (no drain, no close) and a cold fleet rebuilt over the directory comes
    back warm from disk and equals the undisturbed run — each fleet's
    tokens the JAX engine's. The armed fleet bills one shared store
    against two private pools, as the reference's does."""
    jcfg, jp, cfg, params, prompts, max_len = _zipf_setup()
    want = _want()
    spill = str(tmp_path / "cdn")
    kw = dict(max_len=max_len, replicas=2, kv_block=4, share_prefix=True,
              disk_spill=spill, device="cpu")
    fleet = make_fleet(params, cfg, **kw)
    _assert_all_equal(fleet(prompts, 5, slots=4), want, "armed:")
    cdn = fleet.last_stats["fleet"]["cdn"]
    ref = jfleet.make_fleet(jp, jcfg, max_len=max_len, replicas=2,
                            kv_block=4, share_prefix=True,
                            disk_spill=str(tmp_path / "jax_cdn"))
    ref([jnp.asarray(p) for p in prompts], 5, slots=4)
    jcdn = ref.last_stats["fleet"]["cdn"]
    for key in ("residency_routed", "base_seeded_chains",
                "host_bytes_shared", "host_bytes_private_equiv"):
        assert cdn[key] == jcdn[key], key
    assert cdn["store"]["disk"]["stored_chains"] > 0
    assert cdn["host_bytes_private_equiv"] == 2 * cdn["host_bytes_shared"]

    fl_mp = make_fleet(params, cfg, transport=MultiProcTransport(),
                       join_timeout_s=120.0, **kw)
    tr = fl_mp.transport
    try:
        _assert_all_equal(fl_mp(prompts, 5, slots=4), want, "multiproc:")
        assert fl_mp.last_stats["fleet"]["cdn"]["base_seeded_chains"] > 0
        assert fl_mp.cdn_store.disk_restored > 0
        pids = [child[0].pid for child in tr._children.values()]
        assert len(pids) == 2
        for pid in pids:
            os.kill(pid, signal.SIGKILL)
        for proc, _chan in list(tr._children.values()):
            proc.join(10.0)
            assert not proc.is_alive()
    finally:
        fl_mp.close()

    rebuilt = make_fleet(params, cfg, **kw)
    assert rebuilt.cdn_store.disk_restored > 0
    _assert_all_equal(rebuilt(prompts, 5, slots=4), want, "rebuilt:")
    store = rebuilt.last_stats["fleet"]["cdn"]["store"]
    assert store["fetch_blocks"] > 0 and store["disk"]["quarantined"] == 0


def test_fleet_disk_spill_none_reproduces_stock_fleet_tier1(tmp_path):
    """``disk_spill=None`` is the stock fleet (no CDN record, no store),
    and the armed fleet serves the same tokens."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    want = _want()
    kw = dict(max_len=max_len, replicas=2, kv_block=4, share_prefix=True,
              device="cpu")
    stock = make_fleet(params, cfg, **kw)
    _assert_all_equal(stock(prompts, 5, slots=4), want, "stock:")
    assert stock.last_stats["fleet"]["cdn"] is None
    assert stock.cdn_store is None
    armed = make_fleet(params, cfg, disk_spill=str(tmp_path / "cdn"), **kw)
    _assert_all_equal(armed(prompts, 5, slots=4), want, "armed:")
    assert armed.last_stats["fleet"]["cdn"] is not None


def test_fleet_disk_spill_validation_is_loud(tmp_path):
    """A CDN without the prefix index, with the private tier wired by hand,
    or with ``cdn_blocks=0`` refuses with the reference's messages."""
    jcfg, jp, cfg, params, _, max_len = _zipf_setup()
    d = str(tmp_path / "never")
    for kw in (dict(disk_spill=d),
               dict(disk_spill=d, share_prefix=True, host_spill=True),
               dict(disk_spill=d, share_prefix=True, cdn_blocks=0)):
        with pytest.raises(ValueError) as got:
            make_fleet(params, cfg, max_len=max_len, replicas=2,
                       kv_block=4, **kw)
        with pytest.raises(ValueError) as want:
            jfleet.make_fleet(jp, jcfg, max_len=max_len, replicas=2,
                              kv_block=4, **kw)
        assert str(got.value) == str(want.value)
    assert not os.path.exists(d)


# --------------------------------------------------- seeded corruption


def test_disk_corruption_quarantined_serving_degrades_tier1(tmp_path):
    """A stale-key, a bitflipped and a truncated frame are quarantined at
    the restart scan with the reasons the reference's store gives the same
    files (moved aside, catalog holding the survivors), and serving over
    the gutted tier equals solo decoding."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    want = _want()
    spill = str(tmp_path / "cdn")
    eng = _cdn_engine(params, cfg, max_len, _store(cfg, DiskChainStore(spill)))
    _assert_all_equal(eng(prompts, 5, slots=4), want, "seed run:")
    frames = _frames(spill)
    assert len(frames) >= 3
    _corrupt(frames[0], "stale_key", donor=frames[1])
    _corrupt(frames[1], "bitflip")
    _corrupt(frames[2], "truncate_body")
    twin = str(tmp_path / "twin")
    shutil.copytree(spill, twin)
    disk = DiskChainStore(spill)
    jdisk = jhostkv.DiskChainStore(twin)
    assert disk.quarantined == jdisk.quarantined == 3
    assert disk.quarantine_reasons == jdisk.quarantine_reasons
    reasons = " | ".join(disk.quarantine_reasons)
    for why in ("crc mismatch", "truncated body", "stale key"):
        assert why in reasons
    assert len(os.listdir(os.path.join(spill, "quarantine"))) == 3
    assert disk.stats()["chains"] == len(frames) - 3
    eng2 = _cdn_engine(params, cfg, max_len, _store(cfg, disk))
    _assert_all_equal(eng2(prompts, 5, slots=4), want, "degraded:")


def test_disk_dead_tier_degrades_to_two_tier_path_tier1(tmp_path):
    """A file where the tier's directory should be kills the tier at
    construction: billed ``degraded``, ``dead``, every put and get a safe
    no-op, and the engine over the two tiers left serves exactly."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    want = _want()
    hostile = tmp_path / "not-a-dir"
    hostile.write_text("x")
    dead = DiskChainStore(str(hostile))
    assert dead.dead and dead.degraded > 0
    assert dead.put((tuple([1, 2, 3, 4]),), {}) is False
    assert dead.get(b"\x00" * 16) is None
    eng = _cdn_engine(params, cfg, max_len, _store(cfg, dead))
    _assert_all_equal(eng(prompts, 5, slots=4), want, "two-tier:")


def test_disk_directory_crosses_between_the_packages(tmp_path):
    """The on-disk format is the reference's: a directory the JAX engine
    filed at f32 restores in the port's store with the same file names,
    catalog and ``seq`` order (and the reverse), a record's rows giving
    the reference's ``transfer_crc``; an engine over the
    restored store serves exactly, hitting it."""
    jcfg, jp, cfg, params, prompts, max_len = _zipf_setup()
    want = _want()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jeng = jax_engine(jp, jcfg, max_len=max_len, kv_block=4,
                      share_prefix=True, prefix_keep_blocks=0,
                      shared_store=jhostkv.WarmChainStore(
                          jcfg, 32, block_size=4,
                          disk=jhostkv.DiskChainStore(jdir)))
    jeng([jnp.asarray(p) for p in prompts], 5, slots=4)
    peng = _cdn_engine(params, cfg, max_len, _store(cfg, DiskChainStore(pdir)))
    _assert_all_equal(peng(prompts, 5, slots=4), want, "port writes:")
    assert [os.path.basename(f) for f in _frames(jdir)] == \
        [os.path.basename(f) for f in _frames(pdir)]
    for src, mine, theirs in ((jdir, DiskChainStore, jhostkv.DiskChainStore),
                              (pdir, jhostkv.DiskChainStore,
                               DiskChainStore)):
        a, b = mine(src), theirs(src)
        assert a.hot_first() == b.hot_first()
        assert a._catalog == b._catalog and a.quarantined == 0
    from nvidia_terraform_modules_tpu.models import paging as jpaging
    from nvidia_terraform_modules_tpu_torch.models import paging

    # the same record (the engines' rows differ by an ulp between the
    # packages) read by each package: one crc
    for leaf in DiskChainStore(pdir).hot_first():
        (_c, pay), (_c2, jpay) = (DiskChainStore(pdir).get(leaf),
                                  jhostkv.DiskChainStore(pdir).get(leaf))
        assert paging.transfer_crc(pay) == jpaging.transfer_crc(jpay)
    store = _store(cfg, DiskChainStore(jdir))
    assert store.disk_restored == len(_frames(jdir))
    eng = _cdn_engine(params, cfg, max_len, store)
    _assert_all_equal(eng(prompts, 5, slots=4), want, "restored:")
    assert eng.last_stats["prefix"]["cdn"]["hit_blocks"] > 0


# --------------------------------------------- the slow sweep matrix


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tier", ["restore", "fallback"])
@pytest.mark.parametrize("kind", sorted(_CORRUPTIONS))
def test_corruption_matrix_slow(tmp_path, seed, tier, kind):
    """seed × read path × corruption kind: each kind quarantines with its
    reason at the restart scan (``restore``) and at a RAM-miss read
    (``fallback``), and serving equals solo decoding either way."""
    _, _, cfg, params, prompts, max_len = _zipf_setup(
        10 + seed, 8, 2, seed)
    want = _want(10 + seed, 8, 2, seed)
    spill = str(tmp_path / "cdn")
    eng = _cdn_engine(params, cfg, max_len, _store(cfg, DiskChainStore(spill)))
    _assert_all_equal(eng(prompts, 5, slots=4), want, "seed run:")
    frames = _frames(spill)
    assert len(frames) >= 2
    victim = frames[0]
    leaf = bytes.fromhex(os.path.basename(victim)[:-len(".pcd")])
    if tier == "restore":
        _corrupt(victim, kind, donor=frames[1])
        disk = DiskChainStore(spill)
    else:
        disk = DiskChainStore(spill)
        _corrupt(victim, kind, donor=frames[1])
        assert disk.get(leaf) is None
    assert disk.quarantined == 1
    assert _CORRUPTIONS[kind] in " ".join(disk.quarantine_reasons)
    store = _store(cfg, disk)
    store.clear()                        # force the disk path
    eng2 = _cdn_engine(params, cfg, max_len, store)
    _assert_all_equal(eng2(prompts, 5, slots=4), want, f"{tier}/{kind}:")
