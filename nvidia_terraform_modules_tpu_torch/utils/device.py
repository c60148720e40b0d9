# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Device discovery and per-card peak specs — the port of the reference's
``utils/device.py``.

The card's name (``torch.cuda.get_device_name``) is mapped onto a table of
published peaks, which the probes (``ops/probes.py``), the train step's
MFU gauge (``models/burnin.instrument_step``) and ``chip_smoke.py``'s
bounds divide by. The table holds the cards this package runs on; the
nominal ``cpu`` entry lets the probes run in the CPU tests (its peaks mean
nothing).
"""

from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Peak per-card numbers used to normalise probe results."""

    kind: str
    bf16_tflops: float        # dense tensor-core peak, bf16 in / f32 accumulate
    hbm_gbps: float           # device-memory bandwidth, GB/s
    hbm_gib: float            # device-memory capacity, GiB
    ici_gbps: float           # aggregate card-to-card bandwidth (NVLink), GB/s
    f32_tflops: float         # f32 outside the tensor cores (CUDA cores)


# NVIDIA's H100 SXM data sheet (dense rates, 700 W); the name is the one
# the card reports. The 80 GB of HBM3 are listed as 80 GiB, as the
# reference lists its chips' capacities.
PEAK_SPECS: dict[str, DeviceSpec] = {
    "NVIDIA H100 80GB HBM3": DeviceSpec("NVIDIA H100 80GB HBM3", 989.0,
                                        3350.0, 80.0, 900.0, 67.0),
    # nominal, so every probe also runs in the CPU tests
    "cpu": DeviceSpec("cpu", 0.5, 50.0, 16.0, 10.0, 0.5),
}


def device_kind(device=None) -> str:
    """Kind string of ``device`` (default: device 0): the CUDA card's
    name, or ``"cpu"`` for a CPU device or without a card."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def is_tpu() -> bool:
    """The reference's "is the accelerator here" test: True when device 0
    is a CUDA card."""
    import torch

    return torch.cuda.is_available()


@functools.lru_cache(maxsize=None)
def device_spec(kind: str | None = None) -> DeviceSpec:
    """Best-effort spec lookup (exact name, then a prefix either way);
    unknown kinds get the nominal stub under their own name."""
    k = kind if kind is not None else device_kind()
    if k in PEAK_SPECS:
        return PEAK_SPECS[k]
    for name, spec in PEAK_SPECS.items():
        if name != "cpu" and (k.startswith(name) or name.startswith(k)):
            return spec
    return dataclasses.replace(PEAK_SPECS["cpu"], kind=k)
