# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Leaf helpers of the port: layer primitives, workload traces, timing,
the host input pipeline."""

from .data import (  # noqa: F401
    input_pipeline,
    prefetch_to_device,
    token_stream,
)
