# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Tensor-core and HBM micro-probes — the port of the reference's
``ops/probes.py``: achieved bf16 matmul TFLOP/s and streaming bandwidth,
as shares of the card's published peaks (``utils/device.py``).

Both are plain PyTorch (cuBLAS products, elementwise and reduction
kernels), as the reference leaves them to XLA: they measure the card,
not a kernel of this package. Each times a chain of ``iters`` and one of
``8 * iters`` dependent iterations (``utils/timing.delta_time``, medians
of synchronised runs), so the fixed cost of a call cancels. A probe runs
on ``device`` (the card unless the caller asks for the CPU) and its
result names the device it ran on; on the CPU the shares are against a
nominal spec and mean nothing.
"""

from __future__ import annotations

from typing import Any

import torch

from ..utils.device import device_kind, device_spec
from ..utils.timing import delta_time


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available (pass device='cpu' to run the probe on the host)")
    return dev


def matmul_probe(n: int = 4096, dtype=torch.bfloat16, iters: int = 8, *,
                 device="cuda") -> dict[str, Any]:
    """Chained square products ``acc = acc @ b`` (``[n, n]``, f32
    accumulation in cuBLAS, ``dtype`` out); returns achieved TFLOP/s and
    its share of the dense bf16 tensor-core peak."""
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=dev).to(dtype)
    b = torch.randn((n, n), generator=g, device=dev).to(dtype)

    def make_chain(length):
        def chain(a, b):
            acc = a
            for _ in range(length):
                acc = torch.matmul(acc, b)
            return acc
        return chain

    secs = delta_time(make_chain, a, b, iters_lo=iters,
                      iters_hi=8 * iters) * iters
    tflops = 2.0 * n * n * n * iters / secs / 1e12
    spec = device_spec(device_kind(dev))
    return {
        "n": n,
        "seconds": secs,
        "tflops": tflops,
        "roofline_fraction": tflops / spec.bf16_tflops,
        "device": spec.kind,
    }


def hbm_probe(mib: int = 512, iters: int = 8, mode: str = "read", *,
              device="cuda") -> dict[str, Any]:
    """Streaming bandwidth over two f32 vectors of ``mib`` MiB each;
    returns achieved GiB/s and its share of the card's HBM peak.

    * ``"read"``: a two-stream dot ``Σ x·y`` an iteration (``torch.dot``:
      each iteration reads both vectors once, and eager PyTorch hoists
      nothing out of the chain);
    * ``"triad"``: ``acc = y + 1.0001·acc`` in one kernel (read 2, write
      1).

    Both are judged against the full published bandwidth. The reference
    judges its triad against 0.83 of spec, a write-stream ceiling it
    measured on its TPU; no such factor is assumed for this card, whose
    own triad share ``PERF.md`` records."""
    dev = _device(device)
    n = mib * (1 << 20) // 4                       # f32 elements
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    y = torch.full((n,), 2.0, dtype=torch.float32, device=dev)

    if mode == "read":
        def make(length):
            def dot2(x, y):
                acc = torch.zeros((), dtype=torch.float32, device=dev)
                for _ in range(length):
                    acc = acc + torch.dot(x, y)
                return acc
            return dot2

        streams = 2.0                              # read x, read y
    elif mode == "triad":
        def make(length):
            def triad(x, y):
                acc = x
                for _ in range(length):
                    acc = torch.add(y, acc, alpha=1.0001)
                return acc
            return triad

        streams = 3.0                              # read acc, y; write acc
    else:
        raise ValueError(f"unknown hbm probe mode {mode!r}; use read|triad")

    secs = delta_time(make, x, y, iters_lo=iters, iters_hi=8 * iters) * iters
    moved = streams * x.numel() * x.element_size() * iters
    gibps = moved / secs / (1 << 30)
    spec = device_spec(device_kind(dev))
    peak_gibps = spec.hbm_gbps * 1e9 / (1 << 30)
    return {
        "mib": mib,
        "mode": mode,
        "seconds": secs,
        "gibps": gibps,
        "roofline_fraction": gibps / peak_gibps,
        "device": spec.kind,
    }
