# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the fleet's transport (``models/transport.py``) on the CPU,
against the JAX package (``tests/test_transport.py``).

The frame layer is loud and the reference's: ``pack_frame`` bytes equal the
reference's; a corrupt, truncated, reordered frame or a dead peer each
raises its own classified error, and only the timeout is transient. A
handoff payload's ``transfer_crc`` stamp and a weight snapshot's leaf crcs
(``HostParamSnapshot``, bf16 as its 16-bit patterns) equal the JAX
package's for the same rows and weights. Process isolation changes no
token: a ``transport="multiproc"`` fleet — replicas as spawned processes,
every admission poll a framed RPC — equals the in-process fleet, the JAX
engine and solo greedy, through a real ``SIGKILL`` of a replica, sampled
(spec dict and key data over the wire) and disaggregated; its children hold
no JAX module, and a child asked for a card it cannot see fails classified.
The launch tally that counts each replica's kernels is exact under
threads. The seed × kill-time matrix is slow, as the reference's.
"""

import functools
import multiprocessing as mp
import pickle
import threading
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import hostkv as jhostkv
from nvidia_terraform_modules_tpu.models import paging as jpaging
from nvidia_terraform_modules_tpu.models import transport as jtransport
from nvidia_terraform_modules_tpu.models.serving import (
    make_serve_engine as jax_engine,
)
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    FrameChannel,
    HostParamSnapshot,
    MultiProcTransport,
    SnapshotCorruptError,
    Transport,
    TransportCorruptFrame,
    TransportDead,
    TransportError,
    TransportProtocolError,
    TransportTimeout,
    greedy_decode,
    make_fleet,
    make_sampler,
    pack_frame,
    params_from_numpy,
    unpack_frame,
)
from nvidia_terraform_modules_tpu_torch.models.fleet import (
    FleetFault,
    FleetFaultProfile,
    FleetWorkerHung,
)
from nvidia_terraform_modules_tpu_torch.models.transport import (
    ReplicaDeviceError,
    _close_at_exit,
    decode_block_payload,
    decode_rng,
    decode_warm_chains,
    encode_block_payload,
    encode_rng,
    encode_warm_chains,
    start_parent_watchdog,
    warm_chains_nbytes,
)
from nvidia_terraform_modules_tpu_torch.ops import _build
from nvidia_terraform_modules_tpu_torch.utils.retry import (
    RetryPolicy,
    retry_call,
)
from nvidia_terraform_modules_tpu_torch.utils.traffic import (
    shared_prefix_prompts,
)

CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
           seq_len=32, batch=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _zipf_setup(n=10):
    jcfg = jburnin.BurnInConfig(**CFG, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(2), jcfg)
    pairs = shared_prefix_prompts(n, seed=0, n_templates=3, template_len=8,
                                  suffix_lo=1, suffix_hi=4, vocab=jcfg.vocab)
    prompts = tuple(np.asarray(p, np.int32) for _t, p in pairs)
    max_len = max(len(p) for p in prompts) + 7
    cfg = BurnInConfig(**CFG, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jcfg, jp, cfg, params, prompts, max_len


@functools.lru_cache(maxsize=None)
def _want(n_new: int):
    """Solo greedy, checked equal to the JAX single engine once."""
    jcfg, jp, cfg, params, prompts, max_len = _zipf_setup()
    solo = [greedy_decode(params, torch.tensor(p)[None], n_new, cfg,
                          device="cpu")[0].tolist() for p in prompts]
    jax_outs = jax_engine(jp, jcfg, max_len=max_len, kv_block=4)(
        [jnp.asarray(p) for p in prompts], n_new, slots=2)
    assert solo == [np.asarray(o).tolist() for o in jax_outs]
    return solo


def _assert_all_equal(outs, want, label=""):
    for i, (g, w) in enumerate(zip(outs, want)):
        assert g is not None, f"{label} request {i} unserved"
        assert g.tolist() == list(w), f"{label} request {i} diverged"


# ------------------------------------------------------------ frame codec


@pytest.mark.parametrize("seq,payload", [(0, b""), (7, b"replica"),
                                         (2 ** 40, bytes(range(256)) * 3)])
def test_transport_frames_are_the_reference_bytes(seq, payload):
    """``pack_frame`` gives the reference's bytes; ``unpack_frame`` returns
    the payload and checks the sequence."""
    frame = pack_frame(seq, payload)
    assert frame == jtransport.pack_frame(seq, payload)
    assert unpack_frame(frame) == payload
    assert unpack_frame(frame, expect_seq=seq) == payload


def test_transport_corrupt_truncated_and_reordered_frames_are_loud():
    frame = bytearray(pack_frame(3, b"tokens"))
    frame[-1] ^= 0x01
    with pytest.raises(TransportCorruptFrame, match="crc32"):
        unpack_frame(bytes(frame))
    good = pack_frame(3, b"tokens")
    with pytest.raises(TransportProtocolError, match="truncated"):
        unpack_frame(good[:10])
    with pytest.raises(TransportProtocolError, match="truncated"):
        unpack_frame(good[:-2])
    with pytest.raises(TransportProtocolError, match="magic"):
        unpack_frame(b"XXXX" + good[4:])
    with pytest.raises(TransportProtocolError, match="out-of-order"):
        unpack_frame(good, expect_seq=2)


def test_transport_error_taxonomy_classification():
    assert TransportTimeout.transient is True
    assert TransportDead.transient is False
    assert TransportProtocolError.transient is False
    for klass in (TransportTimeout, TransportDead, TransportProtocolError,
                  TransportCorruptFrame):
        assert issubclass(klass, TransportError)
    assert not issubclass(ReplicaDeviceError, TransportError)


def test_frame_channel_timeout_then_classified_retry_delivers_once():
    """A bounded receive that expires is a transient timeout; a wait again
    under ``utils/retry`` gets the late reply exactly once."""
    a, b = mp.Pipe(duplex=True)
    tx, rx = FrameChannel(a, label="tx"), FrameChannel(b, label="rx")
    try:
        with pytest.raises(TransportTimeout) as exc:
            rx.recv(0.05)
        assert exc.value.transient is True
        t = threading.Timer(0.15, tx.send, args=({"req": 4, "tok": 9},))
        t.start()
        attempts = []
        got = retry_call(
            lambda: rx.recv(0.05),
            policy=RetryPolicy(initial_s=0.01, multiplier=2.0, cap_s=0.1,
                               max_attempts=8, jitter=False),
            what="late reply", retryable=(TransportTimeout,),
            log=attempts.append)
        t.join()
        assert got == {"req": 4, "tok": 9}
        assert attempts
        with pytest.raises(TransportTimeout):
            rx.recv(0.02)
    finally:
        tx.close()
        rx.close()


def test_frame_channel_dead_peer_and_reordered_wire_frames():
    a, b = mp.Pipe(duplex=True)
    tx, rx = FrameChannel(a, label="tx"), FrameChannel(b, label="rx")
    tx.close()
    with pytest.raises(TransportDead):
        rx.recv(1.0)
    with pytest.raises(TransportDead):
        for _ in range(64):          # a closed pipe may buffer a write
            rx.send("into the void")
    rx.close()
    a, b = mp.Pipe(duplex=True)
    rx = FrameChannel(b, label="rx")
    try:
        a.send_bytes(pack_frame(1, pickle.dumps("second")))
        a.send_bytes(pack_frame(0, pickle.dumps("first")))
        with pytest.raises(TransportProtocolError, match="out-of-order"):
            rx.recv(1.0)
    finally:
        a.close()
        rx.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_block_payload_codec_stamps_the_reference_crc(dtype):
    """A handoff payload's stamp is the JAX package's ``transfer_crc`` of
    the same rows; it round-trips bit for bit and a flipped byte is loud on
    the decode side."""
    rng = np.random.default_rng(0)

    def bufs(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        if dtype == "int8":
            return (x * 40).astype(np.int8)
        return x

    ref = {"k": [bufs((2, 4, 2, 8)) for _ in range(3)],
           "v": [bufs((2, 4, 2, 8)) for _ in range(3)]}
    if dtype == "int8":
        ref["k_scale"] = [rng.random((2, 4, 2), np.float32) for _ in range(3)]
        ref["v_scale"] = [rng.random((2, 4, 2), np.float32) for _ in range(3)]
    if dtype == "bfloat16":
        ref = {k: [np.asarray(jnp.asarray(b, jnp.bfloat16)) for b in v]
               for k, v in ref.items()}
        port = {k: [torch.tensor(np.asarray(b, np.float32)).to(
            torch.bfloat16) for b in v] for k, v in ref.items()}
    else:
        port = {k: [torch.from_numpy(b) for b in v] for k, v in ref.items()}
    wire = encode_block_payload(port)
    assert wire["crc"] == jpaging.transfer_crc(
        {k: [jnp.asarray(b) for b in v] for k, v in ref.items()})
    back = decode_block_payload(pickle.loads(pickle.dumps(wire)))
    assert sorted(back) == sorted(port)
    for key in port:
        for got, want in zip(back[key], port[key]):
            assert got.dtype == want.dtype and torch.equal(got, want)
    corrupt = dict(wire)
    buf = bytearray(corrupt["data"][0])
    buf[5] ^= 0x01
    corrupt["data"] = [bytes(buf)] + list(corrupt["data"][1:])
    with pytest.raises(TransportCorruptFrame, match="transfer_crc"):
        decode_block_payload(corrupt)


def test_warm_chain_codec_drops_only_the_corrupt_chain():
    """The warm join's wire: each chain stamped on its own with the
    reference's ``transfer_crc`` of its rows, the byte count the
    ``warm_chains_bytes_total`` unit (rows, not framing), and a flipped
    byte drops that chain alone, counted."""
    rng = np.random.default_rng(3)
    chains = []
    for i in range(3):
        ref = {k: [rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
                   for _ in range(2)] for k in ("k", "v")}
        chains.append(((tuple(range(i, i + 4)), (9, 9, 9, 9)), ref))
    port = [(c, {k: [torch.from_numpy(b) for b in v] for k, v in p.items()})
            for c, p in chains]
    wire = encode_warm_chains(port)
    want = jtransport.encode_warm_chains(chains)
    assert [w[0] for w in wire] == [w[0] for w in want]
    assert [w[1]["crc"] for w in wire] == [w[1]["crc"] for w in want]
    assert warm_chains_nbytes(wire) == jtransport.warm_chains_nbytes(want) \
        == 3 * 4 * 2 * 4 * 2 * 8 * 4
    bad = pickle.loads(pickle.dumps(wire))
    buf = bytearray(bad[1][1]["data"][0])
    buf[0] ^= 0x10
    bad[1][1]["data"][0] = bytes(buf)
    back, dropped = decode_warm_chains(bad)
    assert dropped == 1 and [c for c, _p in back] == [chains[0][0],
                                                       chains[2][0]]
    for (_c, got), (_c2, src) in zip(back, [port[0], port[2]]):
        for k in src:
            for g, w in zip(got[k], src[k]):
                assert torch.equal(g, w)


@pytest.mark.parametrize("rng", [7, 2 ** 33 + 5, np.array([3, 99])])
def test_transport_rng_codec_roundtrip(rng):
    """A sampling key crosses the RUN frame as its ``[2]`` key data (the
    reference's ``PRNGKey`` words)."""
    back = decode_rng(pickle.loads(pickle.dumps(encode_rng(rng))))
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(rng))) \
        if isinstance(rng, int) else rng
    assert back.tolist() == np.asarray(want).astype(np.int64).tolist()
    assert encode_rng(None) is None and decode_rng(None) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_snapshot_leaf_crcs_equal_the_reference(dtype):
    """``HostParamSnapshot``: one crc a leaf in ``jax.tree.leaves`` order,
    each equal to the JAX package's for the same weights; the tree comes
    back bit for bit; a flipped leaf byte raises
    ``SnapshotCorruptError``."""
    jcfg = jburnin.BurnInConfig(**CFG, dtype=getattr(jnp, dtype))
    jp = jburnin.init_params(jax.random.PRNGKey(4), jcfg)
    cfg = BurnInConfig(**CFG, dtype=getattr(torch, dtype))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    snap = HostParamSnapshot(params)
    ref = jhostkv.HostParamSnapshot(jp)
    assert snap.crcs == ref.crcs and snap.nbytes == ref.nbytes
    wire = pickle.loads(pickle.dumps(snap.encode()))
    back = HostParamSnapshot.decode(wire, device="cpu")
    flat_a, flat_b = [], []
    jax.tree.map(flat_a.append, back)
    jax.tree.map(flat_b.append, params)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(flat_a, flat_b))
    arr, name = wire["leaves"][3]
    arr = arr.copy()
    arr.reshape(-1)[0] += 1
    wire["leaves"][3] = (arr, name)
    with pytest.raises(SnapshotCorruptError, match="leaf 3"):
        HostParamSnapshot.decode(wire, device="cpu")
    with pytest.raises(SnapshotCorruptError, match="leaf crcs"):
        HostParamSnapshot.decode(dict(wire, crcs=wire["crcs"][:-1]),
                                 device="cpu")


def test_transport_parent_watchdog_fires_on_reparent():
    fired = threading.Event()
    ppid = [4242]
    thread, stop = start_parent_watchdog(4242, poll_s=0.01,
                                         getppid=lambda: ppid[0],
                                         on_orphan=fired.set)
    try:
        assert not fired.wait(0.08)
        ppid[0] = 1
        assert fired.wait(2.0)
        thread.join(2.0)
        assert not thread.is_alive()
    finally:
        stop.set()
    quiet = threading.Event()
    thread2, stop2 = start_parent_watchdog(4242, poll_s=0.01,
                                           getppid=lambda: 4242,
                                           on_orphan=quiet.set)
    stop2.set()
    thread2.join(2.0)
    assert not thread2.is_alive() and not quiet.is_set()


def test_transport_atexit_close_reaps_via_weakref():
    class _Rec:
        closed = 0

        def close(self):
            _Rec.closed += 1

    rec = _Rec()
    ref = weakref.ref(rec)
    _close_at_exit(ref)
    assert _Rec.closed == 1
    del rec
    _close_at_exit(ref)
    assert _Rec.closed == 1


def test_fleet_worker_hung_classification_and_refusals():
    exc = FleetWorkerHung(["decode-1", "prefill-0"], 12.5)
    assert exc.workers == ["decode-1", "prefill-0"] and exc.timeout_s == 12.5
    assert "decode-1" in str(exc) and "12.5" in str(exc)
    _, _, cfg, params, _, max_len = _zipf_setup()
    with pytest.raises(ValueError, match="join_timeout_s"):
        make_fleet(params, cfg, max_len=max_len, replicas=2,
                   join_timeout_s=0.0)
    with pytest.raises(ValueError, match="transport"):
        make_fleet(params, cfg, max_len=max_len, replicas=2,
                   transport="carrier-pigeon")
    with pytest.raises(ValueError, match="spec|pickle"):
        make_fleet(params, cfg, max_len=max_len, replicas=2,
                   transport="multiproc",
                   sampler=make_sampler(top_k=2, temperature=0.5))
    with pytest.raises(ValueError, match="reply_timeout_s"):
        MultiProcTransport(reply_timeout_s=0.0)
    with pytest.raises(ValueError, match="spawn_timeout_s"):
        MultiProcTransport(spawn_timeout_s=-1.0)
    # a transport that cannot warm reports nothing, as the reference's
    assert Transport().warm_replica(0, {}) == {}


def test_launch_tally_is_exact_under_threads():
    """``_build.count`` under eight threads at once: the process's count is
    every launch, each thread's ``tally`` holds its own, and a capture's
    calls stay out of both."""
    name = "paged_decode"
    before = _build.launches[name]
    own: dict = {}
    go = threading.Barrier(8)

    def work(i):
        go.wait()
        with _build.tally() as t:
            for _ in range(2000 + i):
                _build.count(name)
            with _build.capture_tally() as cap:
                _build.count(name, 3)
            assert cap == {name: 3}
        own[i] = dict(t)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert _build.launches[name] - before == sum(2000 + i for i in range(8))
    assert own == {i: {name: 2000 + i} for i in range(8)}


def test_nested_tallies_close_by_identity():
    """An inner tally opened while the outer one is still equal to it
    (both empty) closes itself, not the outer: later launches in the outer
    block count there, and its exit finds it."""
    name = "paged_decode"
    with _build.tally() as outer:
        with _build.tally() as inner:
            pass
        _build.count(name, 2)
        with _build.tally() as inner2:
            _build.count(name)
    assert inner == {} and inner2 == {name: 1}
    assert outer == {name: 3}
    assert not getattr(_build._local, "tallies", [])


# ---------------------------------------------------------- multi-process


def test_fleet_multiproc_bit_matches_inproc_and_solo_tier1():
    """The multi-process fleet equals the in-process fleet, the JAX engine
    and solo greedy; a second call reuses the children; the children hold
    torch and the port, no JAX module; ``close()`` reaps them."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    want = _want(5)
    fl_in = make_fleet(params, cfg, max_len=max_len, replicas=2, kv_block=4,
                       share_prefix=True)
    _assert_all_equal(fl_in(prompts, 5, slots=4), want, "inproc:")
    fl_mp = make_fleet(params, cfg, max_len=max_len, replicas=2,
                       kv_block=4, share_prefix=True, transport="multiproc",
                       join_timeout_s=120.0)
    tr = fl_mp.transport
    try:
        _assert_all_equal(fl_mp(prompts, 5, slots=4), want, "multiproc:")
        st = fl_mp.last_stats["fleet"]
        assert st["served"] == len(prompts) and st["shed"] == 0
        pids = {i: child[0].pid for i, child in tr._children.items()}
        assert sorted(pids) == [0, 1]
        assert len(tr.spawns) == 2 and tr.params_nbytes > 0
        _assert_all_equal(fl_mp(prompts, 5, slots=4), want, "warm:")
        assert {i: c[0].pid for i, c in tr._children.items()} == pids
        for i in (0, 1):
            mods = set(tr.child_modules(i))
            assert "torch" in mods and "nvidia_terraform_modules_tpu_torch" \
                in mods
            assert not mods & {"jax", "jaxlib", "nvidia_terraform_modules_tpu"}
    finally:
        fl_mp.close()
    assert tr._children == {}


def test_fleet_multiproc_real_sigkill_redrives_bit_exact_tier1():
    """A seeded ``kill_replica`` is a real SIGKILL of the replica process at
    its first poll past the trigger; its requests redrive once, outputs
    exact; the next call respawns the dead child and keeps the survivor."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    want = _want(6)
    tr = MultiProcTransport()
    profile = FleetFaultProfile(
        [FleetFault("kill_replica", target=0, at_s=0.05)], seed=0)
    fleet = make_fleet(params, cfg, max_len=max_len, replicas=2, kv_block=4,
                       share_prefix=True, steal=False, faults=profile,
                       transport=tr, join_timeout_s=120.0)
    try:
        out = fleet(prompts, 6, slots=2)
        st = fleet.last_stats["fleet"]
        fr = st["faults"]
        assert st["served"] == len(prompts) and st["shed"] == 0
        assert fr["replica_down"] == 1 and fr["killed"] == ["replica-0"]
        assert fr["redriven"] >= 1
        _assert_all_equal(out, want, "after SIGKILL:")
        assert sorted(tr._children) == [1]
        survivor = tr._children[1][0].pid
        _assert_all_equal(fleet(prompts, 6, slots=2), want, "respawn:")
        assert fleet.last_stats["fleet"]["served"] == len(prompts)
        assert sorted(tr._children) == [1]
        assert tr._children[1][0].pid == survivor
    finally:
        fleet.close()


def test_fleet_multiproc_sampler_spec_and_rng_bit_match_tier1():
    """A sampler spec dict and the per-call key (an int seed, then its key
    data) cross the wire: sampled tokens equal the thread fleet's."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    spec = dict(temperature=0.7, top_k=3)
    fl_in = make_fleet(params, cfg, max_len=max_len, replicas=2, kv_block=4,
                       share_prefix=True, sampler=spec)
    want = [o.tolist() for o in fl_in(prompts, 5, slots=4, rng=11)]
    fl_mp = make_fleet(params, cfg, max_len=max_len, replicas=2, kv_block=4,
                       share_prefix=True, sampler=spec,
                       transport="multiproc", join_timeout_s=240.0)
    try:
        _assert_all_equal(fl_mp(prompts, 5, slots=4, rng=11), want,
                          "sampled:")
        _assert_all_equal(fl_mp(prompts, 5, slots=4, rng=np.array([0, 11])),
                          want, "key data:")
    finally:
        fl_mp.close()


def test_fleet_multiproc_disaggregate_bit_matches_inproc_tier1():
    """Prefill workers stay in this process; the crc-stamped handoff rides
    the ``kv_import`` RPC into a decode process; outputs exact."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    tr = MultiProcTransport()
    fleet = make_fleet(params, cfg, max_len=max_len, replicas=2,
                       disaggregate=True, prefill_workers=1, kv_block=4,
                       transport=tr, join_timeout_s=240.0)
    try:
        _assert_all_equal(fleet(prompts, 5, slots=4), _want(5), "disagg:")
        st = fleet.last_stats["fleet"]
        assert st["mode"] == "disaggregated"
        assert st["served"] == len(prompts) and st["shed"] == 0
        assert sorted(tr._children) == [0] and len(tr.pre_engines) == 1
    finally:
        fleet.close()


def test_fleet_multiproc_child_without_the_card_fails_classified():
    """A replica child asked for ``cuda`` that finds no CUDA device refuses
    at bring-up (``ReplicaDeviceError``, not retried); it never serves
    from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    fleet = make_fleet(params, cfg, max_len=max_len, replicas=1, kv_block=4,
                       transport="multiproc", device="cuda",
                       join_timeout_s=60.0)
    try:
        with pytest.raises(ReplicaDeviceError, match="no CUDA device"):
            fleet(prompts, 3, slots=2)
        assert fleet.transport.spawns == []
    finally:
        fleet.close()


@pytest.mark.slow
def test_fleet_multiproc_seed_by_killstep_matrix_slow():
    """Every (seed × kill time) cell serves the trace exactly through a real
    SIGKILL; one transport is shared across cells."""
    _, _, cfg, params, prompts, max_len = _zipf_setup()
    want = _want(6)
    tr = MultiProcTransport()
    try:
        for seed in (0, 1):
            for at_s in (0.02, 0.05, 0.15):
                profile = FleetFaultProfile(
                    [FleetFault("kill_replica", target=0, at_s=at_s)],
                    seed=seed)
                fleet = make_fleet(params, cfg, max_len=max_len, replicas=2,
                                   kv_block=4, share_prefix=True,
                                   steal=False, faults=profile,
                                   transport=tr, join_timeout_s=120.0)
                out = fleet(prompts, 6, slots=2)
                st = fleet.last_stats["fleet"]
                label = f"seed={seed} at_s={at_s}:"
                assert st["served"] == len(prompts), label
                assert st["shed"] == 0, label
                _assert_all_equal(out, want, label)
    finally:
        tr.close()


_EXIT_SCRIPT = """
import sys, threading, time, torch
from nvidia_terraform_modules_tpu_torch.models.fleet import (
    _FleetQueue, _take_next)
from nvidia_terraform_modules_tpu_torch.models.transport import start_worker
torch.set_num_threads(1)
x = torch.randn(512, 512)

def busy():
    for _ in range(400):
        x @ x

mode = sys.argv[1]
if mode == "daemon":
    threading.Thread(target=busy, daemon=True).start()
elif mode == "worker":
    start_worker(busy, "busy")
else:           # a prefill worker idle on an open, empty queue
    q = _FleetQueue(time.monotonic(), 0.01, lambda *a: None)
    start_worker(_take_next, "idle", (q,), queue=q)
time.sleep(0.3)
"""


@pytest.mark.parametrize("mode", ["daemon", "worker", "idle"])
def test_workers_are_joined_before_the_interpreter_finalizes(mode):
    """A daemon thread still inside a PyTorch operation when the main
    thread exits aborts the process as the interpreter finalizes
    ("terminate called without an active exception", -6): the fault a
    gloo rank showed after its work was done. ``start_worker`` threads are
    joined at exit, so such a process exits 0; one idle on an open queue
    is halted at its next poll, so the exit does not wait out the join's
    bound."""
    import subprocess
    import sys
    import time

    t0 = time.monotonic()
    done = subprocess.run([sys.executable, "-c", _EXIT_SCRIPT, mode],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(Path(__file__).resolve().parents[1]))
    took = time.monotonic() - t0
    if mode == "daemon":
        assert done.returncode == -6, (done.returncode, done.stderr[-500:])
        assert "terminate called without an active exception" in done.stderr
    else:
        assert done.returncode == 0, done.stderr[-2000:]
        assert took < 30, took


def test_a_wedged_bring_up_is_classified_not_waited_on(monkeypatch):
    """``MultiProcTransport.bring_up`` joins its spawn threads against a
    deadline (``spawn_timeout_s`` for each attempt and one more): a
    bring-up that never returns raises ``TransportDead`` naming the
    replica instead of hanging the caller."""
    import time

    release = threading.Event()
    tr = MultiProcTransport(spawn_timeout_s=0.05)
    monkeypatch.setattr(tr, "_param_wire", lambda: b"")
    monkeypatch.setattr(tr, "ensure_engine",
                        lambda i: release.wait(timeout=10.0))
    t0 = time.monotonic()
    try:
        with pytest.raises(TransportDead, match="replica-1: bring-up"):
            tr.bring_up([1])
        assert time.monotonic() - t0 < 5.0
    finally:
        release.set()
