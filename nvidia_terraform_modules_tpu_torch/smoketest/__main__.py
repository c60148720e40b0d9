# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""CLI entry: ``python -m nvidia_terraform_modules_tpu_torch.smoketest``.

The command a validation Job's container runs, once a device (torchrun, or
one process a host under the indexed Job). Environment:

- ``TPU_SMOKETEST_EXPECTED_DEVICES`` — the devices the world must hold;
- ``TPU_SMOKETEST_LEVEL`` — psum | probes | burnin | full (``--level``
  on the command line overrides it);
- ``TPU_SMOKETEST_PLATFORM=cpu`` — run on the CPU over gloo; without it
  the run takes the card (NCCL) and, with no card, exits 1 with a
  message: it never falls back to the CPU;
- the world: ``TPU_SMOKETEST_HOSTS`` / ``TPU_SMOKETEST_COORDINATOR`` /
  ``JOB_COMPLETION_INDEX``, or torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` (``parallel/multihost.py``); none of them: a world of
  one.

Local rank 0 of each host prints the host's one JSON line; every rank
exits 0 iff the world's verdict is ``ok``.
"""

import argparse
import json
import os
import sys

from .runner import run_smoketest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nvidia_terraform_modules_tpu_torch.smoketest")
    parser.add_argument("--level",
                        default=os.environ.get("TPU_SMOKETEST_LEVEL",
                                               "probes"),
                        help="psum | probes | burnin | full")
    level = parser.parse_args(argv).level
    try:
        result = run_smoketest(level=level)
    except RuntimeError as exc:
        if "no CUDA device" not in str(exc):
            raise
        print(f"smoketest: {exc}", file=sys.stderr, flush=True)
        print(json.dumps({"ok": False, "level": level,
                          "device_error": str(exc)}), flush=True)
        return 1
    if result.checks.get("local_rank", 0) == 0:
        print(result.to_json(), flush=True)
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
