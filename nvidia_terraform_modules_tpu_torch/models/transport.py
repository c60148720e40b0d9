# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The fleet's router↔replica transport — the port of the reference's
``models/transport.py``: one :class:`Transport` interface, two wires.

- :class:`InProcTransport`: each decode replica is a serve engine on a
  thread of this process polling the router's queue directly. On the card
  each replica thread runs on a CUDA stream of its own, so replicas overlap
  and one's readbacks never wait for another's waves.
- :class:`MultiProcTransport`: each decode replica is a spawned process
  (CUDA cannot fork) running its own engine; every ``AdmissionSource``
  poll crosses the process boundary as a length-prefixed, crc32-verified,
  sequence-numbered frame over an OS pipe (:func:`pack_frame` /
  :func:`unpack_frame`), every receive bounded. A ``kill_replica`` fault is
  a real ``SIGKILL`` of the replica at the admission poll where the
  in-process fault seam raises.

All router state stays router-side: the multi-process replica drives the
router's queue through :class:`_RPCAdmission`, one request/reply frame pair
a poll, answered by a parent-side thread (:class:`_ProcHandle`) that calls
the real queue. Routing, stealing, redrive and shedding run the same code
either way.

Errors are classified: :class:`TransportTimeout` is the transient one (the
receiver waits again under ``utils/retry``; a request is never sent again,
polls are not idempotent); :class:`TransportDead` (the peer is gone),
:class:`TransportProtocolError` and :class:`TransportCorruptFrame` (a
truncated, reordered or corrupt frame) are terminal — the replica is
classified dead and the router redrives its requests, and a replica whose
router is gone exits ``resilience.EXIT_PEER_DEAD``.

The wire carries:

- the donor weights, once per child: a :class:`~.hostkv.HostParamSnapshot`
  pickled once per configuration and crc-verified leaf by leaf in the child
  before its engine is built;
- handoff payloads (disaggregated serving): :func:`encode_block_payload`
  stamps ``paging.transfer_crc`` over the exported rows (bf16 as its 16-bit
  patterns) and :func:`decode_block_payload` verifies it on the far side;
- the per-call sampling key as its ``[2]`` key data (:func:`encode_rng`);
- a warm join's chains (:func:`encode_warm_chains`: each chain's rows
  crc-stamped on their own, so a corrupt one is dropped and billed in the
  engine's ``warm.seed_dropped`` while the rest seed), and at close the
  retained chains home to the parent's store through the
  ``publish_chains`` RPC, verified the same way;
- each run's launch counts (``ops._build.tally``) home in the DONE frame.

A child builds no kernel: the parent builds the library before it spawns
(``ops._build.build``, which also holds an ``fcntl`` lock), and the child
loads it. A child asked for the card that finds none raises
:class:`ReplicaDeviceError` at bring-up; it never serves from the CPU.

Not ported yet (ROADMAP Queue A item 9d, refused where reached): the AOT
warm of a replica (``Transport.warm_replica``).
"""

from __future__ import annotations

import atexit
import contextlib
import os
import pickle
import signal
import struct
import sys
import threading
import time
import weakref
import zlib
from typing import Callable

import numpy as np
import torch

from ..ops import _build
from ..utils.retry import RetriesExhausted, RetryPolicy, retry_call
from .resilience import EXIT_PEER_DEAD
from .serving import AdmissionSource, make_serve_engine

_AOT = "ROADMAP.md, Queue A item 9d (fleet stack: AOT warm cache)"

# ------------------------------------------------------ classified errors


class TransportError(RuntimeError):
    """Base of the transport's fault taxonomy. ``transient``: True means
    waiting can resolve it (retry under ``utils/retry``), False means the
    peer or the stream is gone (classify the replica dead and redrive)."""

    transient = False


class TransportTimeout(TransportError):
    """A bounded receive expired with no frame — TRANSIENT: the peer may be
    busy. The receiver waits again; it never sends again."""

    transient = True


class TransportDead(TransportError):
    """The peer is gone — EOF, a closed pipe, a dead process. TERMINAL."""


class TransportProtocolError(TransportError):
    """The frame stream is broken — bad magic, a truncated frame, a frame
    out of order. TERMINAL and loud: never resynchronised by guesswork."""


class TransportCorruptFrame(TransportProtocolError):
    """A frame's payload, or a handoff payload's rows, failed its crc."""


class ReplicaDeviceError(RuntimeError):
    """A replica child was asked for a device it cannot reach (no CUDA
    device in the child): the spawn fails loudly and is not retried."""


# the replica's wait for a reply: one bounded receive an attempt, capped
# backoff between attempts, then the router is classified dead
_REPLY_RETRY = RetryPolicy(initial_s=0.05, multiplier=2.0, cap_s=1.0,
                           max_attempts=4, jitter=False)

# a replica's bring-up (spawn + READY handshake): a transient failure costs
# a retry; one that fails every attempt propagates
_SPAWN_PROC_RETRY = RetryPolicy(initial_s=0.1, multiplier=2.0, cap_s=1.0,
                                max_attempts=3, jitter=False)


# ------------------------------------------------------------ frame codec

# magic, payload length, crc32(payload), the 64-bit per-direction sequence
_MAGIC = b"GFT1"
_HEADER = struct.Struct(">4sIIQ")
# the weight stream goes in frames of this many bytes: one frame of the whole
# snapshot (0.84 GB at the flagship) is read by ``Connection.recv_bytes`` in
# socket-sized pieces, each ``os.read`` asking for the whole remainder
_WIRE_CHUNK = 8 << 20


def pack_frame(seq: int, payload: bytes) -> bytes:
    """One wire frame: ``magic | len | crc32 | seq | payload`` — the
    reference's bytes. The length makes truncation detectable, the crc
    corruption, the sequence number reordering."""
    return _HEADER.pack(_MAGIC, len(payload),
                        zlib.crc32(payload), seq) + payload


def unpack_frame(frame: bytes, *, expect_seq: int | None = None) -> bytes:
    """Verify and strip one frame's header; returns the payload. A short
    or length-mismatched frame raises :class:`TransportProtocolError`, a
    crc mismatch :class:`TransportCorruptFrame`, a sequence number other
    than ``expect_seq`` :class:`TransportProtocolError`."""
    if len(frame) < _HEADER.size:
        raise TransportProtocolError(
            f"truncated frame: {len(frame)} byte(s) is shorter than "
            f"the {_HEADER.size}-byte header")
    magic, length, crc, seq = _HEADER.unpack_from(frame)
    if magic != _MAGIC:
        raise TransportProtocolError(
            f"bad frame magic {magic!r} (want {_MAGIC!r}) — the "
            f"stream is desynchronised or not a transport frame")
    payload = frame[_HEADER.size:]
    if len(payload) != length:
        raise TransportProtocolError(
            f"truncated frame: header promises {length} payload "
            f"byte(s), got {len(payload)}")
    if zlib.crc32(payload) != crc:
        raise TransportCorruptFrame(
            f"frame {seq} failed its crc32 — payload corrupted on "
            f"the wire")
    if expect_seq is not None and seq != expect_seq:
        raise TransportProtocolError(
            f"out-of-order frame: got seq {seq}, expected "
            f"{expect_seq} — refusing to resynchronise a broken "
            f"stream")
    return payload


class TransportMetrics:
    """The transport's instruments on the fleet's registry:
    ``transport_bytes_total``/``transport_frames_total`` (every frame
    through the parent side of a channel), ``transport_rtt_ms`` (the
    replica-measured poll round trips), ``transport_retries_total`` (reply
    retries), ``transport_child_respawn_total`` (a dead child replaced) and
    ``warm_chains_bytes_total`` (warm-chain rows over the pipes, either
    way). A disabled registry costs nothing."""

    def __init__(self, registry=None):
        self.enabled = registry is not None and registry.enabled
        if self.enabled:
            self._bytes = registry.counter("transport_bytes_total")
            self._frames = registry.counter("transport_frames_total")
            self._retries = registry.counter("transport_retries_total")
            self._rtt = registry.histogram("transport_rtt_ms")
            self._respawn = registry.counter(
                "transport_child_respawn_total")
            self._warm_bytes = registry.counter("warm_chains_bytes_total")

    def frame(self, nbytes: int) -> None:
        if self.enabled:
            self._bytes.inc(nbytes)
            self._frames.inc()

    def retries(self, n: int) -> None:
        if self.enabled and n:
            self._retries.inc(n)

    def rtt_ms(self, samples) -> None:
        if self.enabled:
            for s in samples:
                self._rtt.record(float(s))

    def respawn(self) -> None:
        if self.enabled:
            self._respawn.inc()

    def warm_bytes(self, nbytes: int) -> None:
        if self.enabled and nbytes:
            self._warm_bytes.inc(nbytes)


class FrameChannel:
    """One side of a framed duplex stream over a
    ``multiprocessing.connection.Connection``: each message is pickled and
    framed with this side's send sequence; each receive is BOUNDED
    (``timeout`` seconds, or one ``poll_s`` slice for ``None``) and checks
    length, crc and sequence. One thread sends and one receives on each
    side (the fleet serialises calls a replica), so the counters take no
    lock."""

    poll_s = 0.25

    def __init__(self, conn, *, metrics: TransportMetrics | None = None,
                 label: str = ""):
        self._conn = conn
        self._metrics = metrics
        self.label = label
        self._send_seq = 0
        self._recv_seq = 0

    def send(self, obj) -> None:
        self.send_raw(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL))

    def send_raw(self, payload: bytes) -> None:
        """Send payload bytes as they are (pickled upstream, or a piece of
        a chunked stream), framed on this channel."""
        frame = pack_frame(self._send_seq, payload)
        try:
            self._conn.send_bytes(frame)
        except (BrokenPipeError, EOFError, OSError) as exc:
            raise TransportDead(
                f"{self.label}: peer closed while sending frame "
                f"{self._send_seq}: {exc}") from exc
        self._send_seq += 1
        if self._metrics is not None:
            self._metrics.frame(len(frame))

    def send_chunked(self, payload: bytes, tag: str) -> None:
        """Send pickled ``payload`` as ``(tag, n_frames, n_bytes)`` and then
        ``n_frames`` raw frames of at most ``_WIRE_CHUNK`` bytes, each framed
        (crc, sequence) on this channel."""
        view = memoryview(payload)
        n = max(1, -(-len(view) // _WIRE_CHUNK))
        self.send((tag, n, len(view)))
        for i in range(n):
            self.send_raw(bytes(view[i * _WIRE_CHUNK:(i + 1) * _WIRE_CHUNK]))

    def recv_chunked(self, header, timeout: float | None):
        """The object :meth:`send_chunked` sent, given its header frame:
        its raw frames joined and unpickled."""
        _tag, n, total = header
        buf = bytearray(total)
        at = 0
        for _ in range(n):
            piece = self.recv_raw(timeout)
            buf[at:at + len(piece)] = piece
            at += len(piece)
        if at != total:
            raise TransportProtocolError(
                f"{self.label}: chunked payload of {at} byte(s), header "
                f"promised {total}")
        return pickle.loads(buf)

    def recv_raw(self, timeout: float | None) -> bytes:
        """Bounded receive of one frame's payload bytes (unpickled)."""
        budget = self.poll_s if timeout is None else timeout
        try:
            if not self._conn.poll(budget):
                raise TransportTimeout(
                    f"{self.label}: no frame within {budget:.3f}s "
                    f"(waiting for seq {self._recv_seq})")
            frame = self._conn.recv_bytes()
        except (BrokenPipeError, EOFError, OSError) as exc:
            raise TransportDead(
                f"{self.label}: peer closed the stream at seq "
                f"{self._recv_seq}: {exc}") from exc
        payload = unpack_frame(frame, expect_seq=self._recv_seq)
        self._recv_seq += 1
        if self._metrics is not None:
            self._metrics.frame(len(frame))
        return payload

    def recv(self, timeout: float | None):
        """Bounded receive: :class:`TransportTimeout` when nothing arrived,
        :class:`TransportDead` on EOF, :func:`unpack_frame`'s classes on a
        bad frame."""
        return pickle.loads(self.recv_raw(timeout))

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass                       # closed by the peer already


# -------------------------------------------- paged-block payload codec


def _wire_array(buf) -> tuple[np.ndarray, str]:
    """A buffer's host bytes as numpy (bf16 as its 16-bit patterns) and
    its torch dtype name."""
    t = torch.as_tensor(buf).detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def encode_block_payload(payload: dict) -> dict:
    """A ``paging.export_block_rows`` payload for the wire, stamped with
    ``paging.transfer_crc`` — the same crc as the reference's over the same
    rows. The receiving side re-derives it (:func:`decode_block_payload`)."""
    from .paging import transfer_crc

    keys = sorted(payload)
    bufs = [torch.as_tensor(b) for k in keys for b in payload[k]]
    arrs = [_wire_array(b) for b in bufs]
    return {
        "keys": keys,
        "layers": [len(payload[k]) for k in keys],
        "shapes": [tuple(a.shape) for a, _ in arrs],
        "dtypes": [name for _, name in arrs],
        "data": [a.tobytes() for a, _ in arrs],
        "crc": transfer_crc({k: [torch.as_tensor(b) for b in payload[k]]
                             for k in keys}),
    }


def decode_block_payload(wire: dict) -> dict:
    """Rebuild the block payload (host tensors) and verify its
    ``transfer_crc`` stamp; a mismatch raises
    :class:`TransportCorruptFrame`."""
    from .paging import transfer_crc

    bufs = []
    for data, name, shape in zip(wire["data"], wire["dtypes"],
                                 wire["shapes"]):
        bf16 = name == "bfloat16"
        t = torch.frombuffer(bytearray(data),
                             dtype=torch.int16 if bf16
                             else getattr(torch, name)).reshape(shape)
        bufs.append(t.view(torch.bfloat16) if bf16 else t)
    payload: dict = {}
    at = 0
    for k, n in zip(wire["keys"], wire["layers"]):
        payload[k] = bufs[at:at + n]
        at += n
    got = transfer_crc(payload)
    if got != wire["crc"]:
        raise TransportCorruptFrame(
            f"paged-block payload failed transfer_crc on the decode "
            f"side of the wire: got {got:#010x}, stamped "
            f"{wire['crc']:#010x}")
    return payload


def encode_warm_chains(chains) -> list:
    """Warm ``(chunks, payload)`` chains for the wire, each payload stamped
    on its own (:func:`encode_block_payload`): the receiver verifies, and
    can drop, one chain at a time."""
    return [(tuple(tuple(int(t) for t in c) for c in chunks),
             encode_block_payload(payload))
            for chunks, payload in chains]


def decode_warm_chains(wire_chains) -> tuple[list, int]:
    """The chains back, each payload's ``transfer_crc`` verified; a chain
    that fails is DROPPED and counted. Returns ``(chains, dropped)``."""
    chains: list = []
    dropped = 0
    for chunks, enc in wire_chains:
        try:
            chains.append((chunks, decode_block_payload(enc)))
        except TransportCorruptFrame:
            dropped += 1
    return chains, dropped


def warm_chains_nbytes(wire_chains) -> int:
    """Row bytes in an encoded warm-chain batch (the
    ``warm_chains_bytes_total`` unit: KV rows, not pickle framing)."""
    return sum(len(d) for _, enc in wire_chains for d in enc["data"])


def encode_rng(rng):
    """A per-call sampling key for the RUN frame: its ``[2]`` key data
    (``ops.sampling.key_data``: an int seed or raw key data)."""
    if rng is None:
        return None
    from ..ops.sampling import key_data

    return key_data(rng).numpy()


def decode_rng(wire):
    """The key the child's engine takes: ``[2]`` int64 key data."""
    return None if wire is None else torch.from_numpy(np.asarray(wire))


# ------------------------------------------------- child-side orphan reaper


def start_parent_watchdog(parent_pid: int, *, poll_s: float = 1.0,
                          getppid=os.getppid,
                          on_orphan: Callable[[], None] | None = None):
    """A daemon thread that polls ``getppid()`` and fires ``on_orphan``
    (default ``os._exit(EXIT_PEER_DEAD)``) once the child is reparented —
    the parent died, even before it registered the child. Returns
    ``(thread, stop_event)``; ``getppid``/``on_orphan`` are injectable."""
    if on_orphan is None:
        def on_orphan() -> None:
            os._exit(EXIT_PEER_DEAD)
    stop = threading.Event()

    def watch() -> None:
        while not stop.wait(poll_s):
            if getppid() != parent_pid:
                on_orphan()
                return

    thread = threading.Thread(target=watch, daemon=True,
                              name="transport-parent-watchdog")
    thread.start()
    return thread, stop


# --------------------------------------------------------- the interface


class Transport:
    """How the router reaches its decode replicas. ``configure`` binds a
    fleet shape (an unchanged configuration keeps its replicas across
    ``make_fleet`` calls); ``launch_decode`` starts one replica run and
    returns a :class:`ReplicaHandle`. ``process_isolated`` says a replica
    can die outside the fault plane (a crashed process), so the fleet runs
    its recovery loop always."""

    name = "base"
    process_isolated = False

    def configure(self, *, params, cfg, max_len: int, engine_kw: dict,
                  registry, n_dec: int, n_pre: int) -> None:
        raise NotImplementedError

    def ensure_engine(self, i: int):
        raise NotImplementedError

    def bring_up(self, ids) -> None:
        """Make replicas ``ids`` ready before their launches (a process
        transport spawns the missing children at once); default nothing."""

    def prefill_engine(self, i: int):
        """The disaggregated prefill side stays in this process in every
        transport (the handoff payload crosses, not the worker)."""
        raise NotImplementedError

    def launch_decode(self, i: int, queue, run_kw: dict, *,
                      on_error: Callable[[str, BaseException], None]
                      ) -> "ReplicaHandle":
        raise NotImplementedError

    def warm_replica(self, i: int, warm_kw: dict) -> dict:
        raise NotImplementedError(
            f"the AOT warm of a replica is not ported yet — {_AOT}")

    def close(self) -> None:
        """Release replica resources."""


class ReplicaHandle:
    """One replica run in flight: ``is_alive`` / bounded ``join`` for the
    monitor; ``result``/``stats``/``launches`` after the join; ``kill``
    the hard stop (SIGKILL for a process; a thread is abandoned)."""

    label = "?"
    error: BaseException | None = None

    def is_alive(self) -> bool:
        raise NotImplementedError

    def join(self, timeout: float) -> bool:
        """Bounded wait; True when the run finished inside ``timeout``."""
        raise NotImplementedError

    def result(self):
        return None

    def stats(self):
        return None

    def launches(self) -> dict:
        """The kernel launches this run made (``ops._build`` names)."""
        return {}

    def kill(self) -> None:
        """Hard-stop the replica if the transport can."""


# ------------------------------------------------------------ in-process


class _ThreadHandle(ReplicaHandle):
    """The in-process replica: the engine on a daemon thread against the
    router's queue, on the replica's own CUDA stream when it serves the
    card; its launches counted apart (``_build.tally``). ``result`` hands
    the outputs to the caller's stream: that stream waits for the event
    recorded after the engine returned, and each output is marked used
    there (``record_stream``), so its memory outlives the caller's reads."""

    def __init__(self, label: str, engine, queue, run_kw: dict, on_error,
                 stream=None) -> None:
        self.label = label
        self.error = None
        self._result = None
        self._engine = engine
        self._launches: dict = {}
        self._stream = stream
        self._done = None

        def work():
            from .fleet import ReplicaKilled

            try:
                with _build.tally() as own, _on_stream(stream):
                    self._launches = own
                    out = engine(
                        run_kw["prompts"], run_kw["budgets"],
                        slots=run_kw["slots"], eos_id=run_kw["eos_id"],
                        rng=run_kw["rng"], kv_blocks=run_kw["kv_blocks"],
                        admission=queue)
                    if stream is not None:
                        self._done = torch.cuda.Event()
                        self._done.record(stream)
                    self._result = out
            except ReplicaKilled:
                # the queue's dead flag, set before the raise, is the
                # monitor's signal: the replica is simply gone
                return
            except Exception as exc:     # noqa: BLE001 — classified below
                self.error = exc
                on_error(self.label, exc)

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"fleet-{label}")
        self._thread.start()

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: float) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def result(self):
        if self._done is not None and self._result:
            here = torch.cuda.current_stream(self._stream.device)
            here.wait_event(self._done)
            for out in self._result.values():
                if out.is_cuda:
                    out.record_stream(here)
        return self._result

    def stats(self):
        return self._engine.last_stats

    def launches(self) -> dict:
        return dict(self._launches)


def _on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for a CPU worker."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _engine_device(engine_kw: dict) -> torch.device:
    """The device the engines are built for (each engine checks it)."""
    return torch.device(engine_kw.get("device", "cuda"))


class InProcTransport(Transport):
    """Engines in this process, replicas as threads polling the queues
    directly — the exactness reference for every other transport. On the
    card each decode replica (and each prefill worker, through the fleet)
    gets a stream of its own, kept across calls."""

    name = "inproc"
    process_isolated = False

    def __init__(self):
        self._key = None
        self._registry = None
        self.dec_engines: list = []
        self.pre_engines: list = []
        self.streams: dict[int, torch.cuda.Stream] = {}

    def configure(self, *, params, cfg, max_len, engine_kw, registry,
                  n_dec, n_pre) -> None:
        key = (id(params), cfg, max_len, tuple(sorted(
            (k, repr(v)) for k, v in engine_kw.items())))
        self._registry = registry
        if key == self._key:
            # unchanged: keep the engines (their pools, graphs and
            # indexes), grow to the new shape
            while len(self.dec_engines) < n_dec:
                self.dec_engines.append(self._build())
            while len(self.pre_engines) < n_pre:
                self.pre_engines.append(self._build())
            return
        self._key = key
        self._params, self._cfg, self._max_len = params, cfg, max_len
        self._engine_kw = dict(engine_kw)
        self._dev = _engine_device(engine_kw)
        # one engine a replica, all on the fleet's registry: separate
        # pools, graphs and indexes, no state shared across threads
        self.dec_engines = [self._build() for _ in range(n_dec)]
        self.pre_engines = [self._build() for _ in range(n_pre)]

    def _build(self):
        return make_serve_engine(self._params, self._cfg,
                                 max_len=self._max_len,
                                 telemetry=self._registry,
                                 **self._engine_kw)

    def stream(self, i: int):
        """Replica ``i``'s CUDA stream (None on the CPU)."""
        if self._dev.type != "cuda":
            return None
        if i not in self.streams:
            self.streams[i] = torch.cuda.Stream(self._dev)
        return self.streams[i]

    def ensure_engine(self, i: int):
        while len(self.dec_engines) <= i:
            self.dec_engines.append(None)
        if self.dec_engines[i] is None:
            self.dec_engines[i] = self._build()
        return self.dec_engines[i]

    def prefill_engine(self, i: int):
        return self.pre_engines[i]

    def launch_decode(self, i, queue, run_kw, *, on_error):
        return _ThreadHandle(f"decode-{i}", self.dec_engines[i], queue,
                             run_kw, on_error, stream=self.stream(i))


# ---------------------------------------------------------- multi-process


class _RPCAdmission(AdmissionSource):
    """The replica-side proxy: each admission poll is one ``("REQ",
    method, args)`` frame to the router and one bounded wait for its
    ``("REP", ...)``. A reply that times out is waited for again under
    ``_REPLY_RETRY`` (never re-sent); an exhausted budget classifies the
    router dead. Round trips are measured here and sent home in DONE."""

    _SAMPLE_CAP = 256

    def __init__(self, chan: FrameChannel, reply_timeout_s: float):
        self._chan = chan
        self._reply_timeout_s = reply_timeout_s
        self.rtt_ms: list[float] = []
        self.retries = 0
        self.warm_dropped = 0            # warm chains corrupt on the wire

    def _call(self, method: str, *args):
        t0 = time.monotonic()
        self._chan.send(("REQ", method, args))

        def _note(_msg: str) -> None:
            self.retries += 1

        reply = retry_call(lambda: self._chan.recv(self._reply_timeout_s),
                           policy=_REPLY_RETRY,
                           what=f"{self._chan.label} {method} reply",
                           retryable=(TransportTimeout,), log=_note)
        if len(self.rtt_ms) < self._SAMPLE_CAP:
            self.rtt_ms.append((time.monotonic() - t0) * 1e3)
        tag, payload = reply
        if tag != "REP":
            raise TransportProtocolError(
                f"{self._chan.label}: expected a REP frame for {method}, "
                f"got {tag!r}")
        status, value = payload
        if status == "EXC":
            # the router-side queue method raised: surface it in the
            # engine as the in-process fault seam would
            raise RuntimeError(f"router-side {method}() failed: {value}")
        return value

    def candidate(self):
        return self._call("candidate")

    def pop(self, req) -> None:
        self._call("pop", int(req))

    def requeue(self, req) -> None:
        self._call("requeue", int(req))

    def tick(self) -> None:
        self._call("tick")

    def draining(self) -> bool:
        return self._call("draining")

    def waiting(self) -> int:
        return self._call("waiting")

    def exhausted(self) -> bool:
        return self._call("exhausted")

    def idle_wait(self) -> None:
        self._call("idle_wait")

    def wait_s(self, req) -> float:
        return self._call("wait_s", int(req))

    def kv_import(self, req):
        wire = self._call("kv_import", int(req))
        if wire is None:
            return None
        return dict(wire, first=torch.tensor(wire["first"]),
                    blocks=decode_block_payload(wire["blocks"]))

    def retired(self, req, tokens: int) -> None:
        self._call("retired", int(req), int(tokens))

    def warm_chains(self):
        """The joiner's warm chains over the wire, each verified here; a
        corrupt one is dropped and counted (folded into the engine's
        ``warm.seed_dropped`` in the DONE frame)."""
        wire = self._call("warm_chains")
        if not wire:
            return None
        chains, dropped = decode_warm_chains(wire)
        self.warm_dropped += dropped
        return chains or None

    def chain_sink(self):
        """The store stays with the router (its locks and host pool do not
        cross the pipe): when the router's queue has a sink, a proxy whose
        ``publish`` ships the chains home through ``publish_chains``."""
        return _ChainSinkProxy(self) if self._call("chain_sink") else None


class _ChainSinkProxy:
    """The child's stand-in for the router's chain sink: ``publish(chains)
    → stored``, each chain crc-stamped on its own, verified again
    router-side before it reaches the store."""

    def __init__(self, adm: _RPCAdmission):
        self._adm = adm

    def publish(self, chains) -> int:
        return self._adm._call("publish_chains", encode_warm_chains(chains))


def _recv_params(chan: FrameChannel, timeout_s: float, device):
    """The child's first message, the ``"PARAMS"`` stream (the pickled
    snapshot wire in ``_WIRE_CHUNK`` frames): every leaf's crc verified
    here, before any engine exists; a corrupt stream is
    :class:`TransportCorruptFrame` (the child exits classified and the
    parent's spawn retry respawns it)."""
    from .hostkv import HostParamSnapshot, SnapshotCorruptError

    msg = chan.recv(timeout_s)
    if not (isinstance(msg, tuple) and msg and msg[0] == "PARAMS"):
        raise TransportProtocolError(
            f"{chan.label}: expected PARAMS as the first frame, got "
            f"{msg!r:.80}")
    try:
        return HostParamSnapshot.decode(chan.recv_chunked(msg, timeout_s),
                                        device=device)
    except SnapshotCorruptError as exc:
        raise TransportCorruptFrame(
            f"{chan.label}: donor weight stream corrupt: {exc}") from exc


def _replica_child_main(conn, index: int, cfg, max_len: int,
                        engine_kw: dict, reply_timeout_s: float,
                        parent_pid: int | None = None,
                        threads: int | None = None) -> None:
    """The replica process: check its device, receive the weight stream,
    build the engine once, then serve RUN frames until EXIT (children
    persist across fleet calls). Every receive is bounded; a dead or
    desynchronised router exits ``EXIT_PEER_DEAD``. The parent-pid
    watchdog starts first, so a parent that dies mid-spawn still reaps
    this child."""
    if parent_pid is not None:
        start_parent_watchdog(parent_pid)
    if threads is not None:
        torch.set_num_threads(threads)
    chan = FrameChannel(conn, label=f"replica-{index}/child")
    try:
        dev = _engine_device(engine_kw)
        if dev.type == "cuda" and not torch.cuda.is_available():
            chan.send(("NODEVICE", index,
                       f"replica-{index} (pid {os.getpid()}) was asked for "
                       f"{dev} and finds no CUDA device"))
            return
        # generous: this bounds a dead parent, not a slow stream
        params = _recv_params(chan, max(reply_timeout_s, 60.0), dev)
        t0 = time.monotonic()
        engine = make_serve_engine(params, cfg, max_len=max_len,
                                   **engine_kw)
        chan.send(("READY", index, os.getpid(),
                   round(time.monotonic() - t0, 6)))
        while True:
            try:
                msg = chan.recv(None)   # idle between calls: bounded slices
            except TransportTimeout:
                continue
            if msg[0] == "EXIT":
                # nothing of this process outlives the engine: skip the
                # interpreter's teardown (the driver frees the context)
                chan.close()
                os._exit(0)
            if msg[0] == "MODULES":
                chan.send(("MODULES", sorted(
                    {m.split(".")[0] for m in list(sys.modules)})))
                continue
            if msg[0] != "RUN":
                raise TransportProtocolError(
                    f"replica-{index}: unexpected frame {msg[0]!r} while "
                    f"waiting for RUN")
            run_kw = msg[1]
            adm = _RPCAdmission(chan, reply_timeout_s)
            try:
                with _build.tally() as own:
                    res = engine(run_kw["prompts"], run_kw["budgets"],
                                 slots=run_kw["slots"],
                                 eos_id=run_kw["eos_id"],
                                 rng=decode_rng(run_kw.get("rng")),
                                 kv_blocks=run_kw["kv_blocks"],
                                 admission=adm)
            except (TransportError, RetriesExhausted):
                # the router's side of the wire failed mid-run: a peer
                # death, escalated to the classified exit below
                raise
            except Exception as exc:     # noqa: BLE001 — shipped home
                chan.send(("ERR", type(exc).__name__, str(exc),
                           adm.rtt_ms, adm.retries))
                continue
            out = {int(r): v.cpu().numpy() for r, v in res.items()}
            stats = engine.last_stats
            if adm.warm_dropped:
                # chains corrupt on the wire never reached seed_warm: the
                # engine could not bill them, so they are billed here
                prefix = dict(stats["prefix"])
                prefix["warm"] = dict(prefix["warm"], seed_dropped=(
                    prefix["warm"]["seed_dropped"] + adm.warm_dropped))
                stats = dict(stats, prefix=prefix)
            chan.send(("DONE", out, stats, adm.rtt_ms, adm.retries,
                       dict(own)))
    except (TransportError, RetriesExhausted):
        os._exit(EXIT_PEER_DEAD)
    finally:
        chan.close()


class _ProcHandle(ReplicaHandle):
    """One multi-process replica run, parent side: a daemon thread sends
    the RUN frame, then answers the replica's polls against the real
    router queue until DONE/ERR — or until a poll raises
    ``ReplicaKilled``, which becomes a real ``SIGKILL`` of the replica at
    that poll. An unexpected death (EOF, crash) sets the queue's ``dead``
    flag as the in-process fault seam does, and the router redrives."""

    poll_s = 0.05

    def __init__(self, transport: "MultiProcTransport", i: int, proc,
                 chan: FrameChannel, queue, run_kw: dict, on_error) -> None:
        self.label = f"decode-{i}"
        self.error = None
        self._transport = transport
        self._i = i
        self._proc = proc
        self._chan = chan
        self._queue = queue
        self._run_kw = run_kw
        self._on_error = on_error
        self._result = None
        self._stats = None
        self._launches: dict = {}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"fleet-rpc-{self.label}")
        self._thread.start()

    def _answer(self, method: str, args):
        if method == "chain_sink":
            # the replica learns only whether a sink exists
            return self._queue.chain_sink() is not None
        if method == "publish_chains":
            return self._publish(args[0])
        value = getattr(self._queue, method)(*args)
        if method == "warm_chains" and value:
            value = encode_warm_chains(value)
            self._transport.metrics.warm_bytes(warm_chains_nbytes(value))
        elif method == "kv_import" and value is not None:
            ready = value.get("ready")
            if ready is not None:
                ready.synchronize()       # the prefill worker's stream
            value = {"first": int(value["first"]),
                     "n_tokens": int(value["n_tokens"]),
                     "blocks": encode_block_payload(value["blocks"])}
        return value

    def _serve(self) -> None:
        from .fleet import ReplicaKilled

        try:
            try:
                self._chan.send(("RUN", self._run_kw))
                while True:
                    try:
                        msg = self._chan.recv(self.poll_s)
                    except TransportTimeout:
                        if not self._proc.is_alive():
                            raise TransportDead(
                                f"{self.label}: replica process "
                                f"pid={self._proc.pid} died "
                                f"(exitcode={self._proc.exitcode}) "
                                f"mid-run") from None
                        continue
                    if msg[0] == "REQ":
                        _, method, args = msg
                        try:
                            value = self._answer(method, args)
                        except ReplicaKilled:
                            # the fault plane fired at this poll: make it
                            # real (queue.dead is set; the router redrives)
                            self._sigkill()
                            return
                        except Exception as exc:  # noqa: BLE001 — to the replica
                            self._chan.send(("REP", (
                                "EXC", f"{type(exc).__name__}: {exc}")))
                            continue
                        self._chan.send(("REP", ("OK", value)))
                    elif msg[0] == "DONE":
                        (_, out, stats, rtt_ms, retries,
                         self._launches) = msg
                        self._result = {r: torch.from_numpy(v)
                                        for r, v in out.items()}
                        self._stats = stats
                        self._transport.metrics.rtt_ms(rtt_ms)
                        self._transport.metrics.retries(retries)
                        return
                    elif msg[0] == "ERR":
                        _, tname, text, rtt_ms, retries = msg
                        self._transport.metrics.rtt_ms(rtt_ms)
                        self._transport.metrics.retries(retries)
                        exc = RuntimeError(
                            f"[replica process {tname}] {text}")
                        self.error = exc
                        self._on_error(self.label, exc)
                        return
                    else:
                        raise TransportProtocolError(
                            f"{self.label}: unexpected frame {msg[0]!r} "
                            f"mid-run")
            except (TransportDead, TransportProtocolError) as exc:
                # terminal: the replica is dead as the in-process kill
                # seam marks it — the router's redrive recovers
                self.error = exc
                self._queue.dead = True
                self._transport._discard_child(self._i)
        finally:
            self._done.set()

    def _publish(self, wire_chains) -> int:
        """``publish_chains`` landing router-side: each chain's crc checked
        again before it touches the store (a corrupt one is dropped here),
        the rest handed to the real sink."""
        sink = self._queue.chain_sink()
        if sink is None:
            return 0
        self._transport.metrics.warm_bytes(warm_chains_nbytes(wire_chains))
        chains, _dropped = decode_warm_chains(wire_chains)
        return sink.publish(chains)

    def _sigkill(self) -> None:
        try:
            os.kill(self._proc.pid, signal.SIGKILL)
        except (ProcessLookupError, OSError):
            pass                          # already gone: the same outcome
        self._proc.join(5.0)
        self._transport._discard_child(self._i)

    def is_alive(self) -> bool:
        return not self._done.is_set()

    def join(self, timeout: float) -> bool:
        return self._done.wait(timeout)

    def result(self):
        return self._result

    def stats(self):
        return self._stats

    def launches(self) -> dict:
        return dict(self._launches)

    def kill(self) -> None:
        """SIGKILL the replica process (the hung-worker escape)."""
        if self._proc.is_alive():
            self._sigkill()
        self._done.set()


def _close_at_exit(ref) -> None:
    """The atexit backstop behind a weakref: close a still-live transport's
    children when the interpreter exits without ``close()``."""
    transport = ref()
    if transport is not None:
        transport.close()


class MultiProcTransport(Transport):
    """Replicas as persistent spawned processes, joined by framed OS pipes.
    ``launch_decode`` reuses a replica's live child and respawns a dead one
    (billed on ``transport_child_respawn_total``). ``close()`` runs at
    interpreter exit through a weakref, and each child exits
    ``EXIT_PEER_DEAD`` when reparented. ``spawn_s`` and ``wire_s`` hold the
    last bring-up's seconds (spawn to READY, and the weight frame's send)
    and ``params_nbytes`` the weight snapshot's bytes."""

    name = "multiproc"
    process_isolated = True

    def __init__(self, *, reply_timeout_s: float = 15.0,
                 spawn_timeout_s: float = 180.0):
        if reply_timeout_s <= 0:
            raise ValueError(
                f"reply_timeout_s must be > 0, got {reply_timeout_s}")
        if spawn_timeout_s <= 0:
            raise ValueError(
                f"spawn_timeout_s must be > 0, got {spawn_timeout_s}")
        self.reply_timeout_s = reply_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self.metrics = TransportMetrics(None)
        self._key = None
        self._lock = threading.Lock()
        self._children: dict[int, tuple] = {}     # i -> (proc, chan)
        self._params_wire: bytes | None = None    # pickled once a config
        self.params_nbytes = 0
        self.spawns: list[dict] = []              # each bring-up's seconds
        self._registry = None
        self._atexit_registered = False
        self.pre_engines: list = []

    def configure(self, *, params, cfg, max_len, engine_kw, registry,
                  n_dec, n_pre) -> None:
        sampler = engine_kw.get("sampler")
        if sampler is not None and not isinstance(sampler, dict):
            raise ValueError(
                "MultiProcTransport needs the sampler as a SPEC dict "
                "(dict(temperature=..., top_k=..., top_p=...)) — a sampler "
                "object does not cross the process boundary; "
                "make_serve_engine builds the same sampler from the spec on "
                "both sides")
        key = (id(params), cfg, max_len, tuple(sorted(
            (k, repr(v)) for k, v in engine_kw.items())))
        self.metrics = TransportMetrics(registry)
        self._registry = registry
        if key == self._key:
            while len(self.pre_engines) < n_pre:
                self.pre_engines.append(self._build_prefill())
            return
        self.close()
        self._key = key
        self._params, self._cfg, self._max_len = params, cfg, max_len
        self._engine_kw = dict(engine_kw)
        # the children check the device (ReplicaDeviceError); this process
        # builds only the prefill workers' engines
        self._dev = _engine_device(engine_kw)
        self._params_wire = None
        # prefill workers stay in this process: the crc-stamped handoff
        # payload crosses the boundary, not the worker
        self.pre_engines = [self._build_prefill() for _ in range(n_pre)]

    def _build_prefill(self):
        return make_serve_engine(self._params, self._cfg,
                                 max_len=self._max_len,
                                 telemetry=self._registry,
                                 **self._engine_kw)

    def ensure_engine(self, i: int):
        """Bring up (or reuse) replica ``i``'s child."""
        with self._lock:
            child = self._children.get(i)
        if child is not None:
            if child[0].is_alive():
                return child
            self._discard_child(i)
            self.metrics.respawn()
        child = self._spawn(i)
        with self._lock:
            self._children[i] = child
        return child

    def prefill_engine(self, i: int):
        return self.pre_engines[i]

    def bring_up(self, ids) -> None:
        """Spawn the children of ``ids`` that are missing or dead, all at
        once (each bring-up is seconds of interpreter start, device set-up
        and weight stream); the first failure is raised after all end."""
        with self._lock:
            todo = [i for i in ids if i not in self._children
                    or not self._children[i][0].is_alive()]
        if not todo:
            return
        self._param_wire()               # pickled once, before the threads
        errors: list = []

        def one(i):
            try:
                self.ensure_engine(i)
            except BaseException as exc:  # noqa: BLE001 — raised below
                errors.append(exc)

        threads = [threading.Thread(target=one, args=(i,), daemon=True,
                                    name=f"fleet-spawn-{i}") for i in todo]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]

    def _param_wire(self) -> bytes:
        """The weight stream, pickled once a configuration: one
        crc-stamped host snapshot framed to every child."""
        if self._params_wire is None:
            from .hostkv import HostParamSnapshot

            snap = HostParamSnapshot(self._params)
            self._params_wire = pickle.dumps(snap.encode(),
                                             pickle.HIGHEST_PROTOCOL)
            self.params_nbytes = snap.nbytes
        return self._params_wire

    def _spawn(self, i: int):
        """Bring up replica ``i`` (spawn + weights + READY), the whole unit
        retried under capped backoff."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        if self._dev.type == "cuda" and torch.cuda.is_available():
            _build.build()               # the children load, never build
        wire = self._param_wire()
        if not self._atexit_registered:
            self._atexit_registered = True
            atexit.register(_close_at_exit, weakref.ref(self))

        def bring_up():
            t0 = time.monotonic()
            parent_conn, child_conn = ctx.Pipe(duplex=True)
            proc = ctx.Process(
                target=_replica_child_main,
                args=(child_conn, i, self._cfg, self._max_len,
                      self._engine_kw, self.reply_timeout_s, os.getpid(),
                      torch.get_num_threads()),
                daemon=True, name=f"fleet-replica-{i}")
            proc.start()
            child_conn.close()
            chan = FrameChannel(parent_conn, metrics=self.metrics,
                                label=f"replica-{i}/router")
            try:
                tw = time.monotonic()
                # the weights ride the pipe (the same pickled bytes for
                # every child), crc-verified child-side before its build
                chan.send_chunked(wire, "PARAMS")
                wire_s = time.monotonic() - tw
                msg = chan.recv(self.spawn_timeout_s)
                if msg[0] == "NODEVICE":
                    raise ReplicaDeviceError(msg[2])
                if msg[0] != "READY" or msg[1] != i:
                    raise TransportProtocolError(
                        f"replica-{i}: bad READY handshake: {msg!r:.120}")
            except BaseException:
                chan.close()
                if proc.is_alive():
                    proc.terminate()
                proc.join(5.0)
                raise
            self.spawns.append({"replica": i,
                                "spawn_s": time.monotonic() - t0,
                                "wire_s": wire_s, "engine_s": msg[3],
                                "params_nbytes": self.params_nbytes})
            return proc, chan

        return retry_call(bring_up, policy=_SPAWN_PROC_RETRY,
                          what=f"replica-{i} process spawn",
                          retryable=(TransportError,))

    def _discard_child(self, i: int) -> None:
        with self._lock:
            child = self._children.pop(i, None)
        if child is not None:
            proc, chan = child
            chan.close()
            if proc.is_alive():
                proc.terminate()
            proc.join(5.0)

    def launch_decode(self, i, queue, run_kw, *, on_error):
        with self._lock:
            child = self._children.get(i)
        if child is not None and not child[0].is_alive():
            # killed (or crashed) in an earlier call: reap and respawn
            self._discard_child(i)
            self.metrics.respawn()
            child = None
        if child is None:
            child = self._spawn(i)
            with self._lock:
                self._children[i] = child
        proc, chan = child
        wire_kw = {
            "prompts": [torch.as_tensor(p).cpu() for p in run_kw["prompts"]],
            "budgets": [int(b) for b in run_kw["budgets"]],
            "slots": run_kw["slots"],
            "eos_id": run_kw["eos_id"],
            "rng": encode_rng(run_kw.get("rng")),
            "kv_blocks": run_kw["kv_blocks"],
        }
        return _ProcHandle(self, i, proc, chan, queue, wire_kw, on_error)

    def child_modules(self, i: int) -> list[str]:
        """The top-level module names loaded in replica ``i``'s child (the
        port's children import torch and the port only)."""
        _proc, chan = self._children[i]
        chan.send(("MODULES",))
        msg = chan.recv(self.spawn_timeout_s)
        if msg[0] != "MODULES":
            raise TransportProtocolError(
                f"replica-{i}: unexpected frame {msg[0]!r} while waiting "
                f"for MODULES")
        return msg[1]

    def close(self) -> None:
        """EXIT every child at once, then reap each within a shared
        budget: terminate, and SIGKILL what is still alive."""
        with self._lock:
            children, self._children = dict(self._children), {}
        for proc, chan in children.values():
            try:
                chan.send(("EXIT",))
            except TransportError:
                pass                      # already dead: reaped below
        for stop in (None, "terminate", "kill"):
            deadline = time.monotonic() + 2.0
            for proc, _chan in children.values():
                if stop == "terminate" and proc.is_alive():
                    proc.terminate()
                elif stop == "kill" and proc.is_alive():
                    os.kill(proc.pid, signal.SIGKILL)
                proc.join(max(0.0, deadline - time.monotonic()))
            if not any(proc.is_alive() for proc, _ in children.values()):
                break
        for _proc, chan in children.values():
            chan.close()
