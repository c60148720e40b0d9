# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""graftlint — the Python binding of the rule engine, the port of the
reference's ``analysis/graftlint.py``: one :class:`~.core.Registry`
instance, the rule decorator the ``rules_graft``/``lockgraph`` packs
register through, and :func:`run_graftlint` (build a
:class:`~.pysrc.PyContext`, run every enabled rule, filter, sort).

The rules encode the runtime conventions the port keeps by hand —
seeded RNG (string-seeded, or an explicit ``torch.Generator``), no host
sync in traced bodies, captured CUDA graphs or wave loops, injected
clocks, classified-never-silent errors, lock-ordered shared state,
bounded joins, atomic durable writes — so a violation fails CI before
it reaches a card.
"""

from __future__ import annotations

from typing import Optional

from .core import (  # noqa: F401  (re-exported shared API)
    SEVERITIES,
    Finding,
    Registry,
    Rule,
    exit_code,
)
from .pysrc import PyContext

REGISTRY = Registry(
    "graftlint",
    catalog_hint="(see `python -m nvidia_terraform_modules_tpu_torch.analysis "
                 "-rules` for the catalog)")

RULES: dict[str, Rule] = REGISTRY.rules


def rule(id: str, *, severity: str, family: str, summary: str):
    return REGISTRY.rule(id, severity=severity, family=family,
                         summary=summary)


@REGISTRY.loader
def _ensure_rules_loaded() -> None:
    from . import lockgraph, rules_graft  # noqa: F401


def list_rules() -> list[Rule]:
    return REGISTRY.list()


def run_graftlint(root: str, rel_to: Optional[str] = None,
                  overrides: Optional[dict[str, str]] = None,
                  ctx: Optional[PyContext] = None) -> list[Finding]:
    """Run every enabled graft rule over the Python tree at ``root``.

    ``overrides`` maps rule id → severity (or ``"off"`` to disable).
    Returns findings sorted by (file, line, rule), suppressions applied.
    """
    overrides = overrides or {}
    # a bad -severity flag is diagnosed before any source loads
    REGISTRY.check_overrides(overrides)
    if ctx is None:
        ctx = PyContext(root, rel_to)
    return REGISTRY.run(ctx, overrides, ctx.suppressions(RULES))
