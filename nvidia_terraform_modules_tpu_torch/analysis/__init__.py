# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""graftlint, the runtime-convention static analysis of the port — the
port of the reference's ``analysis/`` package (its Python side; the HCL
rule pack stays with the Terraform simulator, which the port does not
carry).

* :mod:`.core` — the rule engine (Finding, Registry, severity overrides,
  suppressions, exit codes, JSON/SARIF);
* :mod:`.graftlint` + :mod:`.rules_graft` — the runtime-convention rule
  pack, the reference's rule for rule, with the torch forms of the RNG
  and host-sync conventions;
* :mod:`.lockgraph` — static lock-acquisition-order graph + cycles;
* :mod:`.lockwatch` — the runtime lock-order watchdog chaos tests arm.

``python -m nvidia_terraform_modules_tpu_torch.analysis`` is the CLI.

This module imports no heavy dependencies (no torch, no numpy): the
smoketest preflight pulls it in before any device exists.
"""

from .core import SEVERITIES, Finding, Registry, Rule, exit_code  # noqa: F401
from .graftlint import list_rules, run_graftlint  # noqa: F401
from .pysrc import PyContext  # noqa: F401
