# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""In-cluster validation: the validation Job's payload, on GPUs."""

from .runner import SmokeResult, run_smoketest

__all__ = ["SmokeResult", "run_smoketest"]
