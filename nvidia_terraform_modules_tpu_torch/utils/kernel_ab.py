# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""A/B timing of the attention kernels and the flagship train step across
two source trees of the port, on one card.

    python3 -m nvidia_terraform_modules_tpu_torch.utils.kernel_ab OLD NEW

``OLD`` and ``NEW`` are directories that each hold a copy of the package
(e.g. a ``git archive`` of the parent commit unpacked into an ignored
directory, and ``.``). The trees run in turns — OLD, NEW, NEW, OLD — each
in its own process with its own kernel build, so both versions are
compared on one card and the spread shows beside the difference. Each run
prints one JSON line: K1 at two serve prompt shapes and the train step's
per-layer ``[2, 4096, 16, 128]``, K5/K3/K4 at that shape (CUDA-event
medians, cold L2), and the median host time of a flagship bf16 SGD step
ending in a synchronise. A tree without the backward kernels (the serve
slice alone) reports K1 only.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

def measure(tree: str) -> dict:
    """Time the kernels and the train step of the package under ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    fa = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.ops.flash_attention")
    models = importlib.import_module("nvidia_terraform_modules_tpu_torch.models")
    timing = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.utils.timing")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab measures on a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out: dict = {"tree": tree, "package": str(Path(fa.__file__).parents[1])}
    for b, s in ((1, 304), (1, 512), (2, 4096)):
        q, k, v, do = (torch.randn((b, s, 16, 128), generator=g,
                                   device=dev).bfloat16() for _ in range(4))
        out[f"flash_fwd_{b}x{s}_ms"] = timing.cuda_median_ms(
            lambda: fa.flash_attention_fwd(q, k, v))
    if not hasattr(fa, "flash_dqdkv"):   # a tree from before the train step
        return out
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, delta)
    for name in ("flash_dqdkv", "flash_dq", "flash_dkv"):
        fn = getattr(fa, name)
        out[f"{name}_ms"] = timing.cuda_median_ms(
            lambda fn=fn: fn(*args, scale=128 ** -0.5))
    cfg = models.BurnInConfig(**models.FLAGSHIP_TRAIN, dtype=torch.bfloat16)
    state = {"p": models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)}
    batch = models.synthetic_batch(
        torch.Generator(device=dev).manual_seed(2), cfg, device=dev)
    step = models.make_train_step(cfg, lr=0.1, device=dev)

    def run():
        state["p"], loss = step(state["p"], batch)
        return loss

    timing.synced_ms(run, 1)                # warm-up
    losses, out["train_step_ms"] = timing.synced_ms(run, 5)
    out["last_loss"] = losses[-1].item()
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = argv
    for tree in (old, new, new, old):
        run = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True, timeout=600)
        if run.returncode:
            print(run.stderr, file=sys.stderr)
            return run.returncode
        print(run.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
