# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the instruments on the CPU: ``utils/device`` lookups,
``utils/timing``'s two-point method, the probes' records at tiny sizes
(the CPU's shares are against a nominal spec and mean nothing — the test
holds their keys and arithmetic, never a number) and ``utils/profiling``'s
trace files."""

import json
import os

import pytest
import torch

from nvidia_terraform_modules_tpu.utils import device as jdevice
from nvidia_terraform_modules_tpu_torch.ops import probes
from nvidia_terraform_modules_tpu_torch.telemetry import Registry
from nvidia_terraform_modules_tpu_torch.utils import device, profiling
from nvidia_terraform_modules_tpu_torch.utils import timing

H100 = "NVIDIA H100 80GB HBM3"


# ================================================================== device


def test_device_spec_h100_by_name_and_prefix():
    spec = device.device_spec(H100)
    assert spec == device.PEAK_SPECS[H100]
    assert (spec.bf16_tflops, spec.hbm_gbps, spec.hbm_gib, spec.ici_gbps,
            spec.f32_tflops) == (989.0, 3350.0, 80.0, 900.0, 67.0)
    # a longer name that starts with the table's, and a shorter one
    assert device.device_spec(H100 + " (MIG 1g.10gb)") is spec
    assert device.device_spec("NVIDIA H100") is spec


def test_device_spec_unknown_kind_gets_the_stub():
    spec = device.device_spec("Some Accelerator 9000")
    assert spec.kind == "Some Accelerator 9000"
    cpu = device.PEAK_SPECS["cpu"]
    assert (spec.bf16_tflops, spec.hbm_gbps) == (cpu.bf16_tflops,
                                                 cpu.hbm_gbps)
    # the nominal cpu entry: the same figures as the reference's
    ref = jdevice.PEAK_SPECS["cpu"]
    assert (cpu.bf16_tflops, cpu.hbm_gbps, cpu.hbm_gib, cpu.ici_gbps) == (
        ref.bf16_tflops, ref.hbm_gbps, ref.hbm_gib, ref.ici_gbps)


def test_device_spec_holds_no_tpu_entry():
    assert not [k for k in device.PEAK_SPECS if "TPU" in k]
    assert device.device_spec("TPU v5e").kind == "TPU v5e"     # the stub
    assert device.device_spec("TPU v5e").bf16_tflops == 0.5


def test_device_kind_without_a_card():
    assert device.device_kind("cpu") == "cpu"
    assert device.device_kind(torch.device("cpu")) == "cpu"
    if torch.cuda.is_available():
        assert device.device_kind() == torch.cuda.get_device_name(0)
        assert device.is_tpu()
    else:
        assert device.device_kind() == "cpu" and not device.is_tpu()


# ================================================================== timing


def test_delta_time_two_points_and_fallback(monkeypatch):
    times = {2: 0.5, 16: 1.2}
    monkeypatch.setattr(timing, "median_time",
                        lambda fn, *a, iters=5: times[fn()])
    # (t_hi - t_lo) / (hi - lo)
    got = timing.delta_time(lambda n: (lambda: n), iters_lo=2, iters_hi=16)
    assert got == pytest.approx(0.7 / 14)
    # noise made the long chain no slower: t_hi / iters_hi
    times[16] = 0.4
    got = timing.delta_time(lambda n: (lambda: n), iters_lo=2, iters_hi=16)
    assert got == pytest.approx(0.4 / 16)
    with pytest.raises(ValueError, match="iters_hi"):
        timing.delta_time(lambda n: (lambda: n), iters_lo=4, iters_hi=4)


def test_timed_and_median_time_run_the_function():
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    out, secs = timing.timed(fn, 1)
    assert out == 2 and secs >= 0
    calls.clear()
    assert timing.median_time(fn, 3, iters=3, warmup=2) >= 0
    assert calls == [3] * 5
    timing.sync(torch.ones(2))       # the reference's argument, ignored


# ================================================================== probes


def test_matmul_probe_record_on_cpu():
    rec = probes.matmul_probe(n=32, dtype=torch.float32, iters=1,
                              device="cpu")
    assert set(rec) == {"n", "seconds", "tflops", "roofline_fraction",
                        "device"}
    assert rec["n"] == 32 and rec["device"] == "cpu" and rec["seconds"] > 0
    assert rec["tflops"] == pytest.approx(2.0 * 32 ** 3 / rec["seconds"]
                                          / 1e12)
    assert rec["roofline_fraction"] == pytest.approx(
        rec["tflops"] / device.PEAK_SPECS["cpu"].bf16_tflops)


@pytest.mark.parametrize("mode,streams", [("read", 2.0), ("triad", 3.0)])
def test_hbm_probe_record_on_cpu(mode, streams):
    rec = probes.hbm_probe(mib=1, iters=1, mode=mode, device="cpu")
    assert set(rec) == {"mib", "mode", "seconds", "gibps",
                        "roofline_fraction", "device"}
    assert rec["mode"] == mode and rec["device"] == "cpu"
    assert rec["gibps"] == pytest.approx(streams * (1 << 20)
                                         / rec["seconds"] / (1 << 30))
    # judged against the full bandwidth in both modes (no TPU factor)
    peak = device.PEAK_SPECS["cpu"].hbm_gbps * 1e9 / (1 << 30)
    assert rec["roofline_fraction"] == pytest.approx(rec["gibps"] / peak)


def test_probes_refuse_bad_mode_and_a_missing_card():
    with pytest.raises(ValueError, match="read|triad"):
        probes.hbm_probe(mib=1, iters=1, mode="copy", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probes.matmul_probe(n=16, iters=1)


# =============================================================== profiling


def test_trace_once_writes_a_chrome_trace(tmp_path):
    reg = Registry()

    def step(x):
        return (x @ x).sum()

    out, path = profiling.trace_once(step, torch.ones(16, 16),
                                     log_dir=str(tmp_path / "t"))
    assert float(out) == 16.0 ** 3
    (trace,) = profiling.trace_artifacts(path)
    events = json.load(open(trace))["traceEvents"]
    assert any(e.get("name") == "step" for e in events)
    assert profiling.trace_artifacts(str(tmp_path / "none")) == []
    # annotate also emits a telemetry span when a registry is on
    with profiling.annotate("region", telemetry=reg):
        torch.ones(4).sum()
    assert [e["name"] for e in reg.events] == ["region"]
    assert os.path.dirname(trace) == path


def test_device_trace_nests_annotations(tmp_path):
    with profiling.device_trace(str(tmp_path), python_tracer_level=1):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(8).cumsum(0)
    (trace,) = profiling.trace_artifacts(str(tmp_path))
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert {"outer", "inner"} <= names
