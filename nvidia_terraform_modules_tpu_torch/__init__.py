# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""nvidia_terraform_modules_tpu_torch — the PyTorch / NVIDIA H100 port.

A second package beside the JAX reference ``nvidia_terraform_modules_tpu``.
It mirrors the reference's module names (``models/``, ``ops/``,
``parallel/``, ``utils/``) so every counterpart is easy to find, and it
imports ``torch`` and ``numpy`` only: nothing of JAX and nothing of the
reference package — what it needs from there it keeps as its own copy.

The slices ported so far:

- :mod:`.models.serving` — ``make_serve_engine`` (continuous batching over
  the paged pool of :mod:`.models.paging`, the forwards of
  :mod:`.models.decode`), in bf16 and with int8 weights and cache
  (:mod:`.models.quantize`);
- :mod:`.models.burnin` / :mod:`.models.optimizer` — the burn-in train
  step (SGD, AdamW), unsharded or with the sequence sharded over a mesh's
  ``sp`` axis (:mod:`.parallel`, ring and Ulysses attention);
- :mod:`.ops` — the hand-written CUDA kernels of those paths (sources in
  ``csrc/``), each with its plain PyTorch version beside it, and the ring
  and Ulysses attention built on them.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; on a CPU tensor every kernel wrapper runs its plain
version, on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
