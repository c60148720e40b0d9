# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the telemetry plane on the CPU.

The port keeps its own copy of the reference's stdlib-only ``telemetry``
package; the reference's unit contracts (exact quantiles and buckets, span
nesting, clock injection, the export goldens, the JSONL round trip, thread
safety, the disabled path) run against both copies, one case each.

The instrumented layers are held to the reference's: the port's serve
engine and the JAX engine on the same weights and traffic (the
reference's ``tests/test_telemetry.py`` engine configs, and chunked
prefill) emit the same spans, counters, final gauges and per-request
``tokens``/``decode_steps``; values that are times only have to be
positive. The speculative decoder's counters match too, and
``instrument_step`` returns the step unchanged when telemetry is off and
records the step and flash-probe instruments when it is on.
"""

import json
import math
import os
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvidia_terraform_modules_tpu.telemetry as jtel
import nvidia_terraform_modules_tpu_torch.telemetry as ptel
from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import hostkv as jhostkv
from nvidia_terraform_modules_tpu.models import serving as jserving
from nvidia_terraform_modules_tpu.models import speculative as jspec
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    WarmChainStore,
    init_params,
    instrument_step,
    make_serve_engine,
    make_speculative_decoder,
    make_train_step,
    params_from_numpy,
    synthetic_batch,
)


@pytest.fixture(params=["reference", "port"])
def tel(request):
    """The telemetry package under test: the reference's or the port's
    copy (the same contract, one case each)."""
    return jtel if request.param == "reference" else ptel


class FakeClock:
    """Deterministic injectable clock: advances a fixed tick per read."""

    def __init__(self, start=100.0, tick=0.5):
        self.now = start
        self.tick = tick

    def __call__(self):
        v = self.now
        self.now += self.tick
        return v


# ================================================================ histogram


def test_histogram_quantiles_exact_against_reference_sort(tel):
    rng = random.Random(7)
    values = [rng.uniform(0.01, 5000.0) for _ in range(2311)]
    h = tel.Registry().histogram("lat_ms")
    for v in values:
        h.record(v)
    ref = sorted(values)
    for q in (0.5, 0.9, 0.99, 0.0, 1.0):
        assert h.quantile(q) == ref[max(0, math.ceil(q * len(ref)) - 1)], q
    assert h.count == len(values)
    assert h.sum == pytest.approx(sum(values))


def test_histogram_bucket_counts_exact(tel):
    h = tel.Registry().histogram("b", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 1.0, 5.0, 50.0, 500.0):
        h.record(v)
    assert h.bucket_counts() == [
        (1.0, 2), (10.0, 3), (100.0, 4), (math.inf, 5)]


def test_histogram_rejects_bad_quantile_and_empty(tel):
    h = tel.Registry().histogram("x")
    assert h.quantile(0.5) is None
    with pytest.raises(ValueError):
        h.quantile(1.5)


# ============================================================ spans / clock


def test_span_nesting_depth_and_containment(tel, tmp_path):
    reg = tel.Registry(str(tmp_path))
    with reg.span("outer", phase="a"):
        with reg.span("inner") as sp:
            sp.args["found"] = 42
    spans = {e["name"]: e for e in reg.events if e["kind"] == "span"}
    assert spans["outer"]["depth"] == 0 and spans["inner"]["depth"] == 1
    assert spans["inner"]["args"]["found"] == 42
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-9
    assert all(e["clock"] == "real" for e in spans.values())


def test_clock_injection_real_and_simulated_share_schema(tel):
    reg = tel.Registry(clock=FakeClock(start=10.0, tick=1.0),
                       clock_id="sim", process="simproc")
    with reg.span("op"):
        pass
    reg.emit_span("manual", 3.0, 7.5, lane=2, clock="sim", status="ok")
    reg.event("mark", ts=4.0)
    span, manual, mark = reg.events
    assert span["ts"] == 10.0 and span["dur"] == pytest.approx(1.0)
    assert span["clock"] == "sim" and span["pid"] == "simproc"
    assert manual["tid"] == 2 and manual["dur"] == pytest.approx(4.5)
    assert mark["kind"] == "event" and mark["ts"] == 4.0
    real = tel.Registry()
    with real.span("op"):
        pass
    assert set(real.events[0]) == set(span)


def test_span_records_error_classification(tel):
    reg = tel.Registry()
    with pytest.raises(RuntimeError):
        with reg.span("boom"):
            raise RuntimeError("x")
    assert reg.events[0]["args"]["error"] == "RuntimeError"


# ================================================================= exports


def _golden_registry(tel):
    reg = tel.Registry(clock=FakeClock(start=100.0, tick=0.25), process="p0")
    reg.counter("train_steps").inc(3)
    reg.gauge("train_mfu").set(0.7)
    h = reg.histogram("train_step_ms", buckets=(1.0, 10.0))
    for v in (0.5, 2.0, 20.0):
        h.record(v)
    with reg.span("train_step", step_ms=250.0):
        pass
    reg.emit_span("op create", 1.0, 3.0, lane=1, pid="sim0", clock="sim",
                  status="ok")
    return reg


def test_prometheus_export_golden(tel):
    assert tel.prometheus_text(_golden_registry(tel)) == (
        "# TYPE train_steps counter\n"
        "train_steps 3\n"
        "# TYPE train_mfu gauge\n"
        "train_mfu 0.7\n"
        "# TYPE train_step_ms histogram\n"
        'train_step_ms_bucket{le="1"} 1\n'
        'train_step_ms_bucket{le="10"} 2\n'
        'train_step_ms_bucket{le="+Inf"} 3\n'
        "train_step_ms_sum 22.5\n"
        "train_step_ms_count 3\n"
        "# TYPE train_step_ms_p50 gauge\n"
        "train_step_ms_p50 2\n"
        "# TYPE train_step_ms_p90 gauge\n"
        "train_step_ms_p90 20\n"
        "# TYPE train_step_ms_p99 gauge\n"
        "train_step_ms_p99 20\n")


def test_summary_table_golden(tel):
    assert tel.summary_table(_golden_registry(tel)) == (
        "train_steps    counter    3\n"
        "train_mfu      gauge      0.7\n"
        "train_step_ms  histogram  n=3 p50=2 p90=20 p99=20\n")


def test_chrome_trace_golden_structure(tel):
    trace = tel.chrome_trace(_golden_registry(tel).events)["traceEvents"]
    xs = {e["name"]: e for e in trace if e["ph"] == "X"}
    assert xs["train_step"]["ts"] == 0.0
    assert xs["train_step"]["dur"] == pytest.approx(0.25e6)
    assert xs["op create"]["ts"] == pytest.approx(1.0e6)
    assert xs["op create"]["dur"] == pytest.approx(2.0e6)
    assert xs["op create"]["args"]["clock"] == "sim"
    names = {e["args"]["name"] for e in trace
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"p0", "sim0"}


def test_port_exports_equal_reference_exports():
    """The two copies render one registry's content identically."""
    regs = [_golden_registry(t) for t in (jtel, ptel)]
    assert ptel.prometheus_text(regs[1]) == jtel.prometheus_text(regs[0])
    assert ptel.summary_table(regs[1]) == jtel.summary_table(regs[0])
    strip = [{k: v for k, v in e.items() if k != "pid"} for e in
             ptel.chrome_trace(regs[1].events)["traceEvents"]]
    want = [{k: v for k, v in e.items() if k != "pid"} for e in
            jtel.chrome_trace(regs[0].events)["traceEvents"]]
    assert strip == want


def test_jsonl_roundtrip_and_kill_resilience(tel, tmp_path):
    reg = tel.Registry(str(tmp_path), process="w1")
    reg.event("resume", attempt=0, process=1, resumed_from=None)
    with reg.span("step"):
        pass
    events = tel.read_events(str(tmp_path))
    assert [e["name"] for e in events] == ["resume", "step"]
    assert events[0]["args"]["attempt"] == 0
    files = [f for f in os.listdir(tmp_path) if f.startswith("events-")]
    with open(tmp_path / files[0], "a") as fh:
        fh.write('{"ts": 1, "kind": "span", "na')
    assert len(tel.read_events(str(tmp_path))) == 2


def test_export_all_writes_three_artifacts(tel, tmp_path):
    reg = tel.Registry(str(tmp_path))
    reg.counter("c").inc()
    with reg.span("s"):
        pass
    paths = tel.export_all(reg, str(tmp_path))
    assert sorted(os.path.basename(p) for p in paths.values()) == [
        "metrics.prom", "summary.txt", "trace.json"]
    trace = json.load(open(paths["trace"]))
    assert any(e.get("name") == "s" for e in trace["traceEvents"])
    assert "# TYPE c counter" in open(paths["prometheus"]).read()


# ============================================================ thread safety


def test_counter_thread_safety_exact_total(tel):
    reg = tel.Registry()
    c = reg.counter("n")
    h = reg.histogram("h")

    def work():
        for _ in range(5000):
            c.inc()
            h.record(1.0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 40000 and h.count == 40000


# ============================================================ disabled path


def test_disabled_path_is_shared_singletons_and_zero_events(tel, tmp_path):
    null = tel.NULL
    assert null.enabled is False
    assert null.counter("a") is null.counter("b")
    assert null.counter("a") is null.histogram("h") is null.gauge("g")
    assert null.span("x") is null.span("y")
    with null.span("x"):
        null.counter("a").inc()
        null.event("e", k=1)
    assert null.events == []
    assert list(tmp_path.iterdir()) == []


def test_get_registry_defaults_to_null_and_env_enables(tel, tmp_path,
                                                       monkeypatch):
    prev = tel.set_registry(None)
    try:
        monkeypatch.delenv("TPU_TELEMETRY_DIR", raising=False)
        assert tel.get_registry() is tel.NULL
        tel.set_registry(None)
        monkeypatch.setenv("TPU_TELEMETRY_DIR", str(tmp_path))
        reg = tel.get_registry()
        assert reg.enabled and reg.directory == str(tmp_path)
        assert tel.get_registry() is reg
    finally:
        tel.set_registry(prev)


# ================================================= the serve engine's plane

_BASE = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=1,
             seq_len=16, batch=2)
# gauges of the reference's engine the port leaves out (none since the
# shared store's two, prefix_disk_hit_frac and prefix_disk_swapin_ms)
_LEFT_OUT: set = set()
# instruments whose values are times; the host tier's swap-in time is one
# where the engine spills (and 0 on both sides where it does not)
_TIMED = {"paged_decode_ms", "join_first_token_ms"}
_SPILL_TIMED = {"prefix_swapin_ms"}


def _models(seed=0):
    jcfg = jburnin.BurnInConfig(**_BASE, dtype=jnp.float32)
    cfg = BurnInConfig(**_BASE, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jcfg, jp, cfg, params


def _prompts(kind):
    rng = np.random.default_rng(5)
    if kind == "shared":
        # two 8-token templates over kv_block=4: two shareable full blocks
        tmpl = [rng.integers(0, 64, size=(8,)) for _ in range(2)]
        return [np.concatenate([tmpl[i % 2],
                                rng.integers(0, 64, size=(1 + i % 2,))])
                .astype(np.int32) for i in range(4)]
    n = 3 if kind == "three" else 4
    return [rng.integers(0, 64, size=(4 + 2 * (i % 2),)).astype(np.int32)
            for i in range(n)]


# (prompts, n_new, slots, engine keywords): the reference's
# tests/test_telemetry.py engine configs, and chunked prefill
ENGINE_CASES = {
    "request_spans": ("three", 4, 2, dict(max_len=12)),
    "gauges_kv_block4": ("four", 4, 2, dict(max_len=12, kv_block=4)),
    "share_prefix_lazy": ("shared", 5, 2, dict(max_len=16, kv_block=4,
                                               share_prefix=True,
                                               lazy_growth=True)),
    "spec_k2": ("four", 6, 2, dict(max_len=24, spec_k=2)),
    "chunked_prefill": ("four", 4, 2, dict(max_len=16, kv_block=4,
                                           prefill_chunk=4)),
    # the host KV tier: keep 0 and one slot, so every retirement spills and
    # each repeated template swaps back in
    "host_spill": ("shared", 4, 1, dict(max_len=16, kv_block=4,
                                        share_prefix=True,
                                        prefix_keep_blocks=0,
                                        host_spill=True)),
    # the shared store (a fresh RAM store a side): keep 0 publishes every
    # retirement's chain, each repeated template swaps back in from it
    "shared_store": ("shared", 4, 1, dict(max_len=16, kv_block=4,
                                          share_prefix=True,
                                          prefix_keep_blocks=0,
                                          shared_store=True)),
    # eos retirements, per wave and from the lagged scan (the eos is a
    # token the first request emits mid-stream)
    "eos_every_wave": ("four", 6, 2, dict(max_len=16, eos_check_every=1)),
    "eos_every_2_waves": ("four", 6, 2, dict(max_len=16,
                                             eos_check_every=2)),
}
_RUN_KEYS = ("eos_check_every",)


def _plane(reg):
    """What a run left in a registry: span names and arguments, counters,
    gauges and histogram counts."""
    counters, gauges, hists = reg.instruments()
    spans = [e for e in reg.events if e["kind"] == "span"]
    return {
        "names": sorted(e["name"] for e in spans),
        "requests": sorted(
            (e["args"]["request"], e["args"]["tokens"],
             e["args"]["decode_steps"]) for e in spans
            if e["name"] == "serve_request"),
        "prefills": sorted(
            (e["args"]["prompt_len"], e["args"].get("chunks"))
            for e in spans if e["name"] == "serve_prefill"),
        "request_args": [e["args"] for e in spans
                         if e["name"] == "serve_request"],
        "counters": {k: c.value for k, c in counters.items()},
        "gauges": {k: g.value for k, g in gauges.items()},
        "hists": {k: h.count for k, h in hists.items()},
    }


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_telemetry_equals_jax_engine(case):
    kind, n_new, slots, kw = ENGINE_CASES[case]
    run_kw = {k: kw[k] for k in _RUN_KEYS if k in kw}
    kw = {k: v for k, v in kw.items() if k not in _RUN_KEYS}
    jcfg, jp, cfg, params = _models()
    prompts = _prompts(kind)
    jprompts = [jnp.asarray(p) for p in prompts]
    if run_kw:
        first = jserving.make_serve_engine(jp, jcfg, **kw)(
            jprompts, n_new, slots=slots)[0]
        run_kw["eos_id"] = int(first[2])
    jreg, preg = jtel.Registry(), ptel.Registry()
    jkw = dict(kw)
    if kw.get("shared_store"):
        jkw["shared_store"] = jhostkv.WarmChainStore(jcfg, 16, block_size=4)
        kw["shared_store"] = WarmChainStore(cfg, 16, block_size=4,
                                            device="cpu")
    jout = jserving.make_serve_engine(jp, jcfg, telemetry=jreg, **jkw)(
        jprompts, n_new, slots=slots, **run_kw)
    engine = make_serve_engine(params, cfg, telemetry=preg, device="cpu",
                               **kw)
    pout = engine(prompts, n_new, slots=slots, **run_kw)
    for a, b in zip(pout, jout):
        assert a.tolist() == np.asarray(b).tolist()
    want, got = _plane(jreg), _plane(preg)
    assert got["names"] == want["names"]
    assert got["names"].count("serve_request") == len(prompts)
    assert got["requests"] == want["requests"]
    assert got["prefills"] == want["prefills"]
    assert got["counters"] == want["counters"]
    assert got["hists"] == want["hists"] == {"serve_request_ms":
                                             len(prompts)}
    assert set(want["gauges"]) - set(got["gauges"]) == _LEFT_OUT
    for name, value in got["gauges"].items():
        if name in _TIMED or (name in _SPILL_TIMED and (
                "host_spill" in kw or "shared_store" in kw)):
            assert value > 0 and want["gauges"][name] > 0, name
        else:
            assert value == want["gauges"][name], name
    if "host_spill" in kw:
        # the tier's gauges agree with the run's own spill record
        sp = engine.last_stats["prefix"]["spill"]
        assert sp["spilled_blocks"] > 0 and sp["swapins"] > 0
        assert got["gauges"]["prefix_spilled_blocks"] == sp["spilled_blocks"]
        assert got["gauges"]["prefix_swapin_ms"] == sp["swap_ms"]
        assert got["gauges"]["prefix_host_hit_frac"] == \
            sp["host_hit_frac"] > 0
    for args in got["request_args"]:
        assert args["prefill_ms"] > 0 and args["queue_wait_ms"] >= 0
    if "spec_k" in kw:
        per_req = [r[2] for r in got["requests"]]
        assert sum(per_req) == got["counters"]["serve_verify_slot_steps"] > 0


def test_engine_without_telemetry_emits_nothing():
    """The default registry is the null plane: the engine runs, nothing is
    recorded, and the tokens are the instrumented engine's."""
    _, _, cfg, params = _models()
    prompts = _prompts("four")
    assert ptel.get_registry() is ptel.NULL
    plain = make_serve_engine(params, cfg, max_len=12, device="cpu")(
        prompts, 4, slots=2)
    reg = ptel.Registry()
    traced = make_serve_engine(params, cfg, max_len=12, telemetry=reg,
                               device="cpu")(prompts, 4, slots=2)
    assert [t.tolist() for t in plain] == [t.tolist() for t in traced]
    assert ptel.NULL.events == [] and reg.events


def test_speculative_decoder_telemetry_equals_reference():
    jcfg, jp, cfg, params = _models()
    prompt = np.tile(np.arange(3, dtype=np.int32), 3)[None]
    jreg, preg = jtel.Registry(), ptel.Registry()
    jtoks, jsteps = jspec.make_speculative_decoder(
        jcfg, n_new=10, k=3, telemetry=jreg)(jp, jnp.asarray(prompt))
    ptoks, psteps = make_speculative_decoder(
        cfg, n_new=10, k=3, telemetry=preg, device="cpu")(
            params, torch.from_numpy(prompt))
    assert ptoks.tolist() == np.asarray(jtoks).tolist()
    assert psteps == int(jsteps)
    for name in ("spec_verify_steps", "spec_accepted_draft_tokens"):
        assert preg.counter(name).value == jreg.counter(name).value, name
    (span,) = [e for e in preg.events if e["name"] == "spec_decode"]
    assert span["args"] == {"n_new": 10, "verify_steps": psteps}
    assert make_speculative_decoder(cfg, n_new=4, device="cpu").__name__ \
        == "decoder"                     # disabled: the bare decoder


# ================================================== the train step's plane


def _train_cfg(**over):
    return BurnInConfig(**{**_BASE, "batch": 2, **over},
                        dtype=torch.float32)


def test_instrument_step_disabled_returns_original_function():
    def step(p, b):
        return p, 0.0

    assert instrument_step(step, _train_cfg(), ptel.NULL) is step
    assert instrument_step(step, _train_cfg(attn="flash"),
                           ptel.NULL) is step


@pytest.mark.parametrize("backward", ["fused", "split"])
def test_instrument_step_records_hist_gauges_span_and_probe(tmp_path,
                                                            backward):
    cfg = _train_cfg(attn="flash", flash_backward=backward)
    reg = ptel.Registry(str(tmp_path))
    step = instrument_step(make_train_step(cfg, device="cpu"), cfg, reg,
                           device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    for _ in range(3):
        params, loss = step(params, batch)
    assert torch.isfinite(loss)
    assert reg.histogram("train_step_ms").count == 3
    assert reg.counter("train_steps").value == 3
    assert reg.gauge("train_mfu").value > 0
    assert reg.gauge("train_tokens_per_s").value > 0
    # the probe ran once, before the first step
    assert reg.histogram("flash_fwd_ms").count == 1
    assert reg.histogram("flash_bwd_ms").count == 1
    assert reg.gauge("flash_fwd_mxu_frac").value > 0
    assert reg.gauge("flash_bwd_mxu_frac").value > 0
    events = ptel.read_events(str(tmp_path))
    assert sum(e["name"] == "train_step" for e in events) == 3


def test_instrument_step_probe_needs_flash():
    with pytest.raises(ValueError, match="attn='flash'"):
        instrument_step(lambda *a: a, _train_cfg(), ptel.Registry(),
                        kernel_probe=True, device="cpu")
    reg = ptel.Registry()
    cfg = _train_cfg()
    step = instrument_step(make_train_step(cfg, device="cpu"), cfg, reg,
                           device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step(params, synthetic_batch(torch.Generator().manual_seed(1), cfg,
                                 device="cpu"))
    assert reg.histogram("train_step_ms").count == 1
    assert reg.histogram("flash_fwd_ms").count == 0     # dense: no probe
