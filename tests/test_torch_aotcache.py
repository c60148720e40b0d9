# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the warm cache (``models/aotcache.py``) on the CPU, against
the JAX package's (``tests/test_aotcache.py``'s cases).

- **The frame.** An entry stored by either package under one key string
  is probed whole by the other (``GAC1``, ``>II`` length and crc32, the
  pickled body).
- **Key separation.** ``describe_avals`` splits dtypes, shapes, tree
  structures and statics exactly where the reference's does; the engine's
  scope splits on every lever and the geometry, on both sides.
- **The family.** ``aot_registrations`` names the reference engine's
  pieces for the same prompt lengths (the port's ``kernel_library`` is a
  card-only entry).
- **Integrity.** Corrupt, truncated and stale entries are quarantined; a
  ``serialized`` entry that cannot be validated is demoted and the store
  converges; a library entry of other sources is refused and rebuilt, and
  so is one that does not load (the host's C compiler stands in for
  ``nvcc``).
- **Bit-match.** A warmed engine serves an unwarmed engine's tokens and
  the JAX engine's on the same f32 weights (``params_from_numpy``); a
  second bring-up hits every entry.
- **Concurrency, the fleet, the wire.** Two warmers on one directory
  never error (the port's temporary names are unique); an autoscaled
  fleet counts the JAX fleet's ``warm_compiles``; a process replica warms
  over ``WARM``/``WARMED``.
"""

import contextlib
import functools
import pickle
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import aotcache as jaot
from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import fleet as jfleet
from nvidia_terraform_modules_tpu.models import quantize as jquant
from nvidia_terraform_modules_tpu.models.serving import (
    make_serve_engine as jax_engine,
)
from nvidia_terraform_modules_tpu_torch.models import (
    AotCacheCorruptError,
    AotCompileCache,
    AutoscalePolicy,
    BurnInConfig,
    MultiProcTransport,
    QTensor,
    describe_avals,
    engine_fingerprint,
    make_fleet,
    make_serve_engine,
    params_from_numpy,
    quantize_params,
)
from nvidia_terraform_modules_tpu_torch.models import aotcache, serving
from nvidia_terraform_modules_tpu_torch.ops import _build
from nvidia_terraform_modules_tpu_torch.telemetry import Registry

CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
           seq_len=16, batch=2)
LENS = (3, 5, 7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors on a shared CPU: one intra-op thread a process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def library_cache_restored():
    """Activation is process-wide and sticky: each test leaves the kernel
    build's cache as it found it."""
    prev = _build.set_library_cache(None)
    _build.set_library_cache(prev)
    yield
    _build.set_library_cache(prev)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jburnin.BurnInConfig(**CFG, dtype=jnp.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = BurnInConfig(**CFG, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    prompts = tuple(np.asarray(jax.random.randint(
        jax.random.PRNGKey(40 + i), (3 + 2 * (i % 3),), 0, jcfg.vocab))
        for i in range(4))
    return jcfg, jp, cfg, params, prompts


@contextlib.contextmanager
def _xla_config_guard():
    """The JAX engine's warm points jax's persistent cache at its
    directory: restore the config afterwards (the reference test's
    guard)."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    prev = {k: getattr(jax.config, k) for k in keys}
    try:
        yield
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)
        jaot._reset_xla_cache()


def _deactivating(*engines):
    """Deactivate each engine's cache, the last activated first."""
    for engine in reversed(engines):
        if engine.aot_cache is not None:
            engine.aot_cache.deactivate()


# ---------------------------------------------------------- the frame


@pytest.mark.parametrize("payload", [None, {"digest": "ab" * 32,
                                            "lib": b"\x7fELF" + bytes(64)}],
                         ids=["traceonly", "serialized"])
def test_gac1_frame_crosses_both_packages(tmp_path, payload):
    """One key string, one file: what the port stores the reference probes
    whole, and the other way round — byte for byte the same frame."""
    mode = "traceonly" if payload is None else "serialized"
    mine = AotCompileCache(str(tmp_path / "port"))
    ref = jaot.AotCompileCache(str(tmp_path / "port"))
    key = "scope::wave_step::(*, )|float32[2x4]"
    assert mine.store(key, mode, payload) == mode
    want = {"key": key, "mode": mode, "payload": payload}
    assert ref.probe(key) == want
    assert ref._entry_path(key) == mine._entry_path(key)
    raw_port = open(mine._entry_path(key), "rb").read()
    other = "scope::admit_full_L3::(*, )|int32[1x3]"
    ref.store(other, mode, payload)
    assert mine.probe(other) == {"key": other, "mode": mode,
                                 "payload": payload}
    # the same body pickled by either side frames identically
    ref.store(key, mode, payload)
    assert open(mine._entry_path(key), "rb").read() == raw_port
    assert mine.stats()["quarantined"] == 0
    assert raw_port[:4] == b"GAC1"


# ---------------------------------------------------- key separation


def _sig_cases():
    """Pairs (port args, reference args) of the same abstract shape."""
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def j(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype)
    f32, bf16 = (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)
    i32 = (torch.int32, jnp.int32)
    cases = []
    for make in ((lambda a, d: (a((4, 8), d),)),
                 (lambda a, d: (a((8, 4), d),)),
                 (lambda a, d: (a((4, 8), d), a((4, 8), d))),
                 (lambda a, d: ((a((4, 8), d), a((4, 8), d)),)),
                 (lambda a, d: ([a((4, 8), d)],)),
                 (lambda a, d: (a((4, 8), d), None)),
                 (lambda a, d: (a((4, 8), d), 3)),
                 (lambda a, d: (a((4, 8), d), 4)),
                 (lambda a, d: (a((4, 8), d), "flash")),
                 (lambda a, d: ({"k": [a((2, 4), d)] * 2, "pos": a((2,), d)},)),
                 (lambda a, d: ({"k": [a((2, 4), d)] * 3, "pos": a((2,), d)},)),
                 (lambda a, d: (a((), d),))):
        for dt in (f32, bf16, i32):
            cases.append((make(t, dt[0]), make(j, dt[1])))
    return cases


def test_describe_avals_and_entry_key_separate_as_the_reference():
    """Two argument sets share a signature in the port exactly when they
    share one in the reference (dtypes, shapes, trees, None, statics); a
    ``QTensor`` separates its int8 data, scales and layout; keys split on
    scope and name."""
    cases = _sig_cases()
    mine = [describe_avals(p) for p, _ in cases]
    ref = [jaot.describe_avals(r) for _, r in cases]
    for a in range(len(cases)):
        for b in range(len(cases)):
            assert (mine[a] == mine[b]) == (ref[a] == ref[b]), (a, b)
    assert len(set(mine)) == len(cases)
    # a dict's order is not part of its signature, on both sides
    x = torch.empty((2,), device="meta")
    assert describe_avals({"a": x, "b": 1}) == describe_avals({"b": 1,
                                                               "a": x})
    assert mine[0] == "(*, )|float32[4x8]"
    q = torch.empty((8, 4), dtype=torch.int8, device="meta")
    s = torch.empty((4,), device="meta")
    sigs = {describe_avals((QTensor(q, s, scale_axis=1,
                                    dtype=torch.float32),)),
            describe_avals((QTensor(q, s, scale_axis=0,
                                    dtype=torch.float32),)),
            describe_avals((QTensor(q, s, scale_axis=1,
                                    dtype=torch.bfloat16),)),
            describe_avals((QTensor(q.float(), s, scale_axis=1,
                                    dtype=torch.float32),)),
            describe_avals((QTensor(q, s, scale_axis=1,
                                    dtype=torch.float32).T,))}
    assert len(sigs) == 5
    cache = AotCompileCache.__new__(AotCompileCache)
    cache.path = "/nonexistent"
    a32 = (torch.empty((4, 8), device="meta"),)
    keys = {cache.entry_key(sc, n, a32)
            for sc in ("scopeA", "scopeB") for n in ("wave", "admit")}
    assert len(keys) == 4
    assert cache.entry_key("s", "n", a32) != cache.entry_key(
        "s", "n", (torch.empty((4, 8), dtype=torch.bfloat16,
                               device="meta"),))


def _lever_grid(cfg, jcfg, params, jp):
    """One engine keyword set a lever (its port and JAX forms)."""
    from nvidia_terraform_modules_tpu.models import hostkv as jhostkv
    from nvidia_terraform_modules_tpu_torch.models import WarmChainStore

    grid = [({}, {}), ({"cache_dtype": "int8"}, {"cache_dtype": "int8"}),
            ({"sampler": {"top_k": 2}}, {"sampler": {"top_k": 2}}),
            ({"prefill_chunk": 4}, {"prefill_chunk": 4}),
            ({"spec_k": 2}, {"spec_k": 2}), ({"kv_block": 8}, {"kv_block": 8}),
            ({"policy": "sjf"}, {"policy": "sjf"}), ({"aging": 4}, {"aging": 4}),
            ({"share_prefix": True}, {"share_prefix": True}),
            ({"lazy_growth": True}, {"lazy_growth": True}),
            ({"prefix_keep_blocks": 8}, {"prefix_keep_blocks": 8}),
            ({"paged_kernel": "off"}, {"paged_kernel": "off"}),
            ({"share_prefix": True, "host_spill": True},
             {"share_prefix": True, "host_spill": True}),
            ({"share_prefix": True, "host_spill": True, "host_blocks": 8},
             {"share_prefix": True, "host_spill": True, "host_blocks": 8}),
            ({"share_prefix": True, "host_spill": True, "host_swap": "sync"},
             {"share_prefix": True, "host_spill": True,
              "host_swap": "sync"}),
            ({"share_prefix": True, "shared_store": WarmChainStore(
                cfg, 8, block_size=16, device="cpu")},
             {"share_prefix": True, "shared_store": jhostkv.WarmChainStore(
                 jcfg, 8, block_size=16)}),
            ({"prefix": [1, 2, 3]}, {"prefix": jnp.asarray([1, 2, 3])})]
    return [(dict(max_len=16, **m), dict(max_len=16, **r)) for m, r in grid] \
        + [(dict(max_len=20), dict(max_len=20)),
           (dict(max_len=16, params=quantize_params(
               params, dtype=torch.float32)),
            dict(max_len=16, params=jquant.quantize_params(
                jp, dtype=jnp.float32)))]


def test_engine_fingerprint_and_scope_separate_every_lever():
    """``run.aot_scope`` differs for every lever and the geometry, in the
    port as in the reference, and is the same for equal engines (no
    address in it); ``engine_fingerprint`` splits config, ``max_len`` and
    levers, independent of their order, and names torch and CUDA."""
    jcfg, jp, cfg, params, _ = _setup()
    mine, ref = [], []
    for m, r in _lever_grid(cfg, jcfg, params, jp):
        mine.append(make_serve_engine(m.pop("params", params), cfg,
                                      device="cpu", **m).aot_scope)
        ref.append(jax_engine(r.pop("params", jp), jcfg, **r).aot_scope)
    assert len(set(mine)) == len(mine)
    assert len(set(ref)) == len(ref)
    assert make_serve_engine(params, cfg, max_len=16,
                             device="cpu").aot_scope == mine[0]
    assert not set(mine) & set(ref)
    base = dict(cache_dtype="bf16", spec_k=0, kv_block=16)
    cfg2 = BurnInConfig(**CFG, dtype=torch.bfloat16)
    fps = {engine_fingerprint(cfg, 32, base, device="cpu"),
           engine_fingerprint(cfg, 48, base, device="cpu"),
           engine_fingerprint(cfg2, 32, base, device="cpu"),
           engine_fingerprint(cfg, 32, {**base, "cache_dtype": "int8"},
                              device="cpu"),
           engine_fingerprint(cfg, 32, {**base, "spec_k": 4}, device="cpu"),
           engine_fingerprint(cfg, 32, base, device="cpu",
                              mesh=type("M", (), {"shape": {"tp": 2}})())}
    assert len(fps) == 6
    fp = engine_fingerprint(cfg, 32, base, device="cpu")
    assert fp == engine_fingerprint(cfg, 32, dict(reversed(base.items())),
                                    device="cpu")
    assert fp.startswith(f"gac1|torch={torch.__version__}|cuda=")
    assert "|dev=cpu:cpux1|mesh=none|" in fp


# ---------------------------------------------------------- the family


_FAMILY = {"plain": {}, "sampled": {"sampler": {"top_k": 2}},
           "prefill_chunk": {"prefill_chunk": 4}, "spec_k": {"spec_k": 2},
           "spec_chunked": {"spec_k": 2, "prefill_chunk": 4},
           "lazy_growth": {"lazy_growth": True}, "prefix": {"prefix": "p"},
           "int8_cache": {"cache_dtype": "int8"}}


@pytest.mark.parametrize("name", list(_FAMILY))
def test_aot_registrations_name_the_reference_family(name, tmp_path):
    """The port's warm family at a geometry names the reference engine's
    pieces, in its order, for the same prompt lengths (on the CPU: no
    kernel library); and under each lever set, engines warmed with
    ``prime=False`` (the pieces alone, on misses), then ``prime=True``
    (hits and the prime) and ``prime=True`` on misses serve an unwarmed
    engine's tokens (the sampled engine at a fixed ``rng``)."""
    jcfg, jp, cfg, params, _ = _setup()
    kw = dict(_FAMILY[name])
    jkw = dict(kw)
    if "prefix" in kw:
        kw["prefix"], jkw["prefix"] = [1, 2, 3], jnp.asarray([1, 2, 3])

    def engine(**more):
        return make_serve_engine(params, cfg, max_len=16, kv_block=4,
                                 device="cpu", **kw, **more)
    cold = engine()
    mine = cold.aot_registrations(slots=2, prompt_lens=LENS)
    ref = jax_engine(jp, jcfg, max_len=16, kv_block=4,
                     **jkw).aot_registrations(slots=2, prompt_lens=LENS)
    assert [n for n, _f, _a in mine] == [n for n, _f, _a in ref]
    assert len({describe_avals(a) for _n, _f, a in mine}) == len(mine)

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n) for n in LENS]
    run_kw = dict(slots=2, rng=0 if "sampler" in kw else None)
    want = cold(prompts, 3, **run_kw)
    warmed = [engine(aot_cache=str(tmp_path / d)) for d in "aab"]
    try:
        for eng, prime, hit in zip(warmed, (False, True, True),
                                   (False, True, False)):
            w = eng.warm(slots=2, prompt_lens=LENS, n_new=3, prime=prime)
            assert not w["errors"], w
            assert w["hits" if hit else "misses"] == w["registered"] \
                == len(mine)
            assert w["primed"] == (len(LENS) if prime else 0)
            got = eng(prompts, 3, **run_kw)
            for g, x in zip(got, want):
                assert torch.equal(g, x)
    finally:
        _deactivating(*warmed)


# --------------------------------------------------------- integrity


def test_store_probe_and_corruption_quarantine(tmp_path):
    """The crc frame end to end: a stored entry probes back exactly; a
    flipped byte, a truncation, a stale key and a foreign magic each
    quarantine the file with its reason, as the reference's do; the temp
    file of a write never stays behind."""
    cache = AotCompileCache(str(tmp_path / "gac"))
    ref = jaot.AotCompileCache(str(tmp_path / "ref"))
    key = cache.entry_key("scope", "wave", (3,))
    assert cache.probe(key) is None
    assert cache.store(key, "traceonly", None) == "traceonly"
    assert cache.probe(key) == {"key": key, "mode": "traceonly",
                                "payload": None}
    assert cache.entries() and cache.stats()["quarantined"] == 0
    path = cache._entry_path(key)

    def plant(mutate, want):
        """The same fault in both packages' caches: the same verdict."""
        for c in (cache, ref):
            c.store(key, "traceonly", None)
            p = c._entry_path(key)
            raw = open(p, "rb").read()
            open(p, "wb").write(mutate(raw))
            assert c.probe(key) is None
            assert want in c.quarantine_reasons[-1]
        assert cache.quarantine_reasons[-1] == ref.quarantine_reasons[-1]

    plant(lambda raw: raw[:-1] + bytes([raw[-1] ^ 0xFF]), "crc mismatch")
    plant(lambda raw: raw[:7], "truncated header")
    plant(lambda raw: raw[:-3], "truncated body")
    plant(lambda raw: b"NOPE" + raw[4:], "bad magic")
    key2 = cache.entry_key("scope", "admit", (3,))
    cache.store(key2, "traceonly", None)
    cache.store(key, "traceonly", None)
    shutil.copyfile(cache._entry_path(key2), path)
    assert cache.probe(key) is None
    assert "stale entry" in cache.quarantine_reasons[-1]
    with pytest.raises(AotCacheCorruptError, match="bad magic"):
        cache._decode(b"NOPE" + b"\x00" * 16, key)
    assert cache.stats()["quarantined"] >= 1
    # a payload that refuses to pickle degrades to trace-only, loudly
    assert cache.store(key, "serialized", lambda: None) == "traceonly"
    assert cache.probe(key)["degraded"]
    assert not [f for f in (tmp_path / "gac").iterdir()
                if f.name.endswith(".tmp")]


def test_cache_pickles_by_path(tmp_path):
    """The cache ships to fleet children through ``engine_kw``: pickling
    keeps only the path, and the clone probes the same entries,
    inactive."""
    cache = AotCompileCache(str(tmp_path / "gac"))
    key = cache.entry_key("s", "n", (1,))
    cache.store(key, "traceonly", None)
    cache.activate()
    try:
        clone = pickle.loads(pickle.dumps(cache))
    finally:
        cache.deactivate()
    assert clone.path == cache.path
    assert clone.probe(key)["mode"] == "traceonly"
    assert clone.stats()["active"] is False


def test_serialized_entry_is_demoted_then_converges(tmp_path):
    """A ``serialized`` entry for a piece with no serialised form (a graph
    capture) is quarantined and stored again trace-only; the next
    bring-up hits every entry."""
    _, _, cfg, params, _ = _setup()
    cache_dir = str(tmp_path / "gac")
    engines = []
    try:
        for _ in range(3):
            engines.append(make_serve_engine(params, cfg, max_len=12,
                                             kv_block=4, device="cpu",
                                             aot_cache=cache_dir))
        eng, eng2, eng3 = engines
        eng.warm(slots=2, prompt_lens=(4,), n_new=2)
        name, _fn, args = eng.aot_registrations(slots=2,
                                                prompt_lens=(4,))[0]
        key = eng.aot_cache.entry_key(eng.aot_scope, name, args)
        eng.aot_cache.store(key, "serialized", (b"not a capture", 0, 0))
        w = eng2.warm(slots=2, prompt_lens=(4,), n_new=2)
        assert w["demoted"] == 1 and w["quarantined"] == 1
        assert w["misses"] == 1 and not w["errors"]
        assert "no serialised form" in eng2.aot_cache.quarantine_reasons[-1]
        assert eng2.aot_cache.probe(key)["mode"] == "traceonly"
        w3 = eng3.warm(slots=2, prompt_lens=(4,), n_new=2)
        assert w3["hits"] == w3["registered"] and w3["misses"] == 0
    finally:
        _deactivating(*engines)


def _stub_source(path, missing=()):
    """C source of a shared object that exports the kernel library's entry
    points (each returns 0), less ``missing``."""
    names = [n for n in (*_build._SIGNATURES, "tk_error_string")
             if n not in missing]
    path.write_text("".join(f"int {n}(void) {{ return 0; }}\n"
                            for n in names))
    return path


def _stub_library(out, missing=()):
    """A stand-in for the built kernel library, from the host's C
    compiler."""
    src = _stub_source(out.with_suffix(".c"), missing)
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(out), str(src)],
                   check=True)
    return out


def _stub_key(monkeypatch):
    """The library key without the card and ``nvcc`` (absent here)."""
    monkeypatch.setattr(aotcache, "library_key",
                        lambda digest: f"gac1|kernel_library|digest={digest}"
                                       f"|nvcc=test|dev=test")


def test_library_installs_from_the_cache_and_refuses_a_stale_one(
        tmp_path, monkeypatch):
    """The kernel build with a cache behind it (the library key's ``nvcc``
    and card stubbed on the CPU): a banked library installs into an empty
    build directory with no ``nvcc`` (stamp written); a library banked for
    other sources is quarantined as stale and the build goes to ``nvcc``
    (absent here: it raises); ``deactivate`` restores the build's
    previous cache."""
    _stub_key(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found (test)")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    cache = AotCompileCache(str(tmp_path / "gac"))
    digest = _build.library_digest()
    built = _stub_library(tmp_path / "libkernels.so")
    assert cache.bank_library(digest, built) == "serialized"
    cache.activate()
    try:
        assert _build._library_cache is cache
        path = _build.build()
        assert path.read_bytes() == built.read_bytes()
        assert (tmp_path / "build" / "stamp").read_text() == digest
        assert _build._last_source == "cache" and cache.installed == 1
        assert not list((tmp_path / "build").glob("*.o"))
        assert _build.library_path() == path
        # a second build finds the stamp: nothing installed again
        _build.build()
        assert _build._last_source == "stamp" and cache.installed == 1
        # a library built from other sources, banked under this key
        (tmp_path / "build" / "stamp").unlink()
        body = cache.probe(aotcache.library_key(digest))
        cache.store(aotcache.library_key(digest), "serialized",
                    dict(body["payload"], digest="0" * 64))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
        assert "stale library" in cache.quarantine_reasons[-1]
        assert cache.stats()["quarantined"] == 1
    finally:
        cache.deactivate()
    assert _build._library_cache is None or \
        _build._library_cache is not cache


def test_a_cached_library_that_fails_to_load_is_refused_and_rebuilt(
        tmp_path, monkeypatch):
    """A library entry whose bytes do not load — not a shared object (the
    load raises ``OSError``), or one that lacks an entry point
    (``AttributeError``) — is quarantined with the reason, the library is
    built by ``nvcc`` (a stub script: each compile touches its object, the
    link builds a full stand-in with the host's C compiler) and the
    rebuilt library is the one bound and banked; the next bring-up
    installs the banked rebuild. Each round builds into a directory of its
    own, so the library bound is the file of this round."""
    _stub_key(monkeypatch)
    stub_c = _stub_source(tmp_path / "full.c")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$*\" >> {log}\n"
        "out=; shared=\n"
        "while [ $# -gt 0 ]; do\n"
        "  case \"$1\" in -o) out=\"$2\"; shift;; -shared) shared=1;; esac\n"
        "  shift\n"
        "done\n"
        f"if [ -n \"$shared\" ]; then exec cc -shared -fPIC -o \"$out\" "
        f"{stub_c}; fi\n"
        ": > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    cache = AotCompileCache(str(tmp_path / "gac"))
    digest = _build.library_digest()
    key = aotcache.library_key(digest)
    lacking = _stub_library(tmp_path / "lacking.so",
                            missing=("tk_sample_draw",)).read_bytes()

    def bring_up(n):
        build = tmp_path / f"build{n}"
        monkeypatch.setattr(_build, "_BUILD", build)
        monkeypatch.setattr(_build, "_lib", None)
        return build, _build.lib()

    cache.activate()
    try:
        for n, (bad, raised) in enumerate(((b"not a shared object",
                                            "OSError"),
                                           (lacking, "AttributeError"))):
            cache.store(key, "serialized", {"digest": digest, "lib": bad})
            runs = len(log.read_text().splitlines()) if log.exists() else 0
            build, handle = bring_up(n)
            assert _build._last_source == "nvcc"
            reason = cache.quarantine_reasons[-1]
            assert "failed to load" in reason and raised in reason
            assert len(log.read_text().splitlines()) \
                == runs + len(_build.sources()) + 1
            assert handle.tk_sample_draw          # the rebuilt library
            lib_path = build / _build._LIB_NAME
            assert cache.probe(key)["payload"]["lib"] \
                == lib_path.read_bytes()
            assert sorted(p.name for p in build.iterdir()
                          if p.name.startswith(_build._LIB_NAME)) \
                == [_build._LIB_NAME]
        assert ["OSError" in r for r in cache.quarantine_reasons] \
            == [True, False]
        runs = len(log.read_text().splitlines())
        _build_dir, handle = bring_up(2)
        assert _build._last_source == "cache"
        assert len(log.read_text().splitlines()) == runs
        assert handle.tk_sample_draw
    finally:
        cache.deactivate()


# --------------------------------------------------------- bit-match


def test_warmed_engine_equals_unwarmed_and_the_jax_engine(tmp_path):
    """The acceptance gate: a warmed engine's tokens equal an unwarmed
    engine's and the JAX engine's (warmed too) on the same weights; the
    first warm misses every piece the JAX warm registers and primes each
    length; a second bring-up hits every entry, counted on the telemetry
    counters beside the ``engine_warmup_ms`` gauge."""
    jcfg, jp, cfg, params, prompts = _setup()
    lens = tuple(sorted({len(p) for p in prompts}))
    want = make_serve_engine(params, cfg, max_len=12, kv_block=4,
                             device="cpu")(prompts, 4, slots=2)
    reg = Registry()
    engines = []
    try:
        engines.append(make_serve_engine(
            params, cfg, max_len=12, kv_block=4, device="cpu",
            telemetry=reg, aot_cache=str(tmp_path / "port")))
        w1 = engines[0].warm(slots=2, prompt_lens=lens, n_new=4)
        got = engines[0](prompts, 4, slots=2)
        engines.append(make_serve_engine(
            params, cfg, max_len=12, kv_block=4, device="cpu",
            telemetry=reg, aot_cache=str(tmp_path / "port")))
        w2 = engines[1].warm(slots=2, prompt_lens=lens, n_new=4)
        again = engines[1](prompts, 4, slots=2)
    finally:
        _deactivating(*engines)
    with _xla_config_guard():
        jeng = jax_engine(jp, jcfg, max_len=12, kv_block=4,
                          aot_cache=str(tmp_path / "jax"))
        jw = jeng.warm(slots=2, prompt_lens=lens, n_new=4)
        jgot = jeng([jnp.asarray(p) for p in prompts], 4, slots=2)
    for g, a, w, j in zip(got, again, want, jgot):
        assert torch.equal(g, w) and torch.equal(a, w)
        assert np.array_equal(g.numpy(), np.asarray(j))
    for key in ("enabled", "registered", "misses", "hits", "primed"):
        assert w1[key] == jw[key], key
    assert w1["misses"] == w1["registered"] >= 1 and w1["hits"] == 0
    assert w1["primed"] == len(lens) and w1["warm_ms"] > 0
    assert not w1["errors"] and not w2["errors"]
    assert w2["hits"] == w2["registered"] == w1["registered"]
    counters, gauges, _ = reg.instruments()
    assert counters["aot_cache_miss_total"].value == w1["registered"]
    assert counters["aot_cache_hit_total"].value == w2["hits"]
    assert gauges["engine_warmup_ms"].value == w2["warm_ms"]
    assert gauges["join_first_token_ms"].value > 0


def test_two_warmers_on_one_directory_never_error(tmp_path):
    """Two warmers in threads on one directory, five times over: every
    warm ends without an error (each write's temporary name is unique),
    and a later bring-up hits every entry."""
    _, _, cfg, params, prompts = _setup()
    lens = tuple(sorted({len(p) for p in prompts}))
    engines = []
    try:
        for rnd in range(5):
            cache_dir = str(tmp_path / f"gac{rnd}")
            pair = [make_serve_engine(params, cfg, max_len=12, kv_block=4,
                                      device="cpu", aot_cache=cache_dir)
                    for _ in range(2)]
            engines += pair
            results: list = [None, None]

            def go(i, pair=pair, results=results):
                results[i] = pair[i].warm(slots=2, prompt_lens=lens,
                                          n_new=2, prime=False)
            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120.0)
            for r in results:
                assert r is not None and r["enabled"] and not r["errors"], r
                assert r["hits"] + r["misses"] == r["registered"]
        engines.append(make_serve_engine(params, cfg, max_len=12, kv_block=4,
                                         device="cpu", aot_cache=cache_dir))
        w = engines[-1].warm(slots=2, prompt_lens=lens, n_new=2)
        assert w["hits"] == w["registered"] and w["misses"] == 0, w
        assert engines[-1].aot_cache.stats()["quarantined"] == 0
    finally:
        _deactivating(*engines)


# --------------------------------------------------- the fleet, the wire


UP = dict(min_replicas=1, max_replicas=2, up_backlog=2.0, down_backlog=0.25,
          cooldown_s=0.0, seed=0)
FLEET_KW = dict(max_len=16, replicas=1, kv_block=4, est_token_s=0.01,
                steal=False)


def test_fleet_warm_compiles_equal_the_jax_fleets(tmp_path):
    """An autoscaled fleet with ``aot_cache`` warms every bring-up: the
    scale ledger's ``warm_compiles`` (base and joiners) and events equal
    the JAX fleet's for the same plan, ``warm_compile_errors`` is empty,
    the ``fleet_scale`` span carries ``warm_compile=True`` and the tokens
    equal the fleet's without the cache; a second call counts the same
    warms and probes the cache no more."""
    jcfg, jp, cfg, params, _ = _setup()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 3 + i % 4).astype(np.int32)
               for i in range(8)]
    want = make_fleet(params, cfg, autoscale=AutoscalePolicy(**UP),
                      device="cpu", **FLEET_KW)(prompts, 4, slots=2)
    reg = Registry()
    fleet = make_fleet(params, cfg, autoscale=AutoscalePolicy(**UP),
                       device="cpu", telemetry=reg,
                       aot_cache=str(tmp_path / "port"), **FLEET_KW)
    try:
        outs = fleet(prompts, 4, slots=2)
        sc = fleet.last_stats["fleet"]["scale"]
        probes = {k: c.value for k, c in reg.instruments()[0].items()
                  if k.startswith("aot_cache_")}
        # a second call: the replicas' engines are warm at this schedule
        # already, so their warms are counted and nothing is probed again
        again = fleet(prompts, 4, slots=2)
        sc2 = fleet.last_stats["fleet"]["scale"]
    finally:
        _build.set_library_cache(None)
    assert sc2["warm_compiles"] == sc["warm_compiles"]
    assert probes["aot_cache_miss_total"] > 0
    assert sc2["events"] == sc["events"] and not sc2["warm_compile_errors"]
    assert {k: c.value for k, c in reg.instruments()[0].items()
            if k.startswith("aot_cache_")} == probes
    for o, w in zip(again, outs):
        assert torch.equal(o, w)
    with _xla_config_guard():
        jf = jfleet.make_fleet(jp, jcfg,
                               autoscale=jfleet.AutoscalePolicy(**UP),
                               aot_cache=str(tmp_path / "jax"), **FLEET_KW)
        jf([jnp.asarray(p) for p in prompts], 4, slots=2)
    jsc = jf.last_stats["fleet"]["scale"]
    assert sc["events"] == jsc["events"] and sc["ups_executed"] >= 1
    assert sc["warm_compiles"] == jsc["warm_compiles"] \
        == 1 + sc["ups_executed"]
    assert sc["warm_compile_errors"] == [] == jsc["warm_compile_errors"]
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
    ups = [e for e in reg.events if e.get("name") == "fleet_scale"
           and e["args"].get("kind") == "up"]
    assert ups and all(e["args"]["warm_compile"] is True for e in ups)


def test_fleet_records_a_warm_whose_pieces_failed(tmp_path, monkeypatch):
    """A bring-up whose warm recorded a piece error is no warm compile:
    the scale ledger names each replica and piece in
    ``warm_compile_errors``, counts no ``warm_compiles``, the
    ``fleet_scale`` span carries ``warm_compile=False``, and the replicas
    launch cold and serve the fleet's tokens without the cache."""
    _, _, cfg, params, _ = _setup()
    real = serving.warm_engine

    def failing(*args, **kwargs):
        stats = real(*args, **kwargs)
        stats["errors"].append("wave_step: RuntimeError('planted')")
        return stats
    monkeypatch.setattr(serving, "warm_engine", failing)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 3 + i % 4).astype(np.int32)
               for i in range(8)]
    want = make_fleet(params, cfg, autoscale=AutoscalePolicy(**UP),
                      device="cpu", **FLEET_KW)(prompts, 4, slots=2)
    reg = Registry()
    fleet = make_fleet(params, cfg, autoscale=AutoscalePolicy(**UP),
                       device="cpu", telemetry=reg,
                       aot_cache=str(tmp_path / "port"), **FLEET_KW)
    try:
        outs = fleet(prompts, 4, slots=2)
    finally:
        _build.set_library_cache(None)
    sc = fleet.last_stats["fleet"]["scale"]
    assert sc["ups_executed"] >= 1 and sc["warm_compiles"] == 0
    assert sorted(sc["warm_compile_errors"]) == [
        f"replica-{i}: wave_step: RuntimeError('planted')"
        for i in range(1 + sc["ups_executed"])]
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
    ups = [e for e in reg.events if e.get("name") == "fleet_scale"
           and e["args"].get("kind") == "up"]
    assert ups and all(e["args"]["warm_compile"] is False for e in ups)


def test_process_replica_warms_over_the_wire(tmp_path):
    """A ``MultiProcTransport`` child warms on a ``WARM`` frame and sends
    its stats home in ``WARMED``: a first warm misses, a second hits every
    entry; a warm that fails in the child comes home as ``{"error": ...}``
    and the child stays up to warm again."""
    _, _, cfg, params, _ = _setup()
    tr = MultiProcTransport(reply_timeout_s=30.0, spawn_timeout_s=120.0)
    tr.configure(params=params, cfg=cfg, max_len=12,
                 engine_kw=dict(kv_block=4, device="cpu",
                                aot_cache=str(tmp_path / "gac")),
                 registry=None, n_dec=1, n_pre=0)
    try:
        warm_kw = dict(slots=2, kv_blocks=None, prompt_lens=(3, 5), n_new=2)
        first = tr.warm_replica(0, warm_kw)
        second = tr.warm_replica(0, warm_kw)
        bad = tr.warm_replica(0, dict(warm_kw, slots=0))
        proc, _chan = tr._children[0]
        alive = proc.is_alive()
        third = tr.warm_replica(0, warm_kw)
    finally:
        tr.close()
        _build.set_library_cache(None)
    assert first["enabled"] and first["misses"] == first["registered"] >= 1
    assert not first["errors"] and first["primed"] == 2
    assert second["hits"] == second["registered"] == first["registered"]
    assert "error" in bad and "slots" in bad["error"] and alive
    assert third["hits"] == third["registered"]
