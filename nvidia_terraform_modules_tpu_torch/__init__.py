# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""nvidia_terraform_modules_tpu_torch — the PyTorch / NVIDIA H100 port.

A second package beside the JAX reference ``nvidia_terraform_modules_tpu``.
It mirrors the reference's module names (``models/``, ``ops/``, ``utils/``)
so every counterpart is easy to find, and it imports ``torch`` and
``numpy`` only: nothing of JAX and nothing of the reference package — what
it needs from there it keeps as its own copy.

The slice ported so far is the continuous-batching paged serve path:

- :mod:`.models.burnin` — config, parameters and the inference forward;
- :mod:`.models.decode` — cached and paged forwards, ``greedy_decode``;
- :mod:`.models.paging` — the block allocator and the paged pool;
- :mod:`.models.serving` — ``make_serve_engine`` (continuous batching);
- :mod:`.ops.flash_attention` / :mod:`.ops.decode_attention` — the two
  hand-written CUDA kernels of that path (sources in ``csrc/``), each with
  its plain PyTorch version beside it.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; on a CPU tensor every kernel wrapper runs its plain
version, on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
