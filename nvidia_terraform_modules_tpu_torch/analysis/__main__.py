# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""graftlint CLI — ``python -m nvidia_terraform_modules_tpu_torch.analysis``.

Usage:
    python -m nvidia_terraform_modules_tpu_torch.analysis [DIR]
        [-json | -sarif] [-severity RULE=LEVEL ...] [-rules]

DIR defaults to the installed runtime package itself, so a bare
invocation is the CI gate: exit 2 on error findings, 1 on warnings,
0 clean (info never fails a build). The reference's flag surface,
output formats and exit-code contract: a thin binding of the engine in
:mod:`.core`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .core import Finding, exit_code, findings_json, sarif_report
from .graftlint import list_rules, run_graftlint

_PY_SUFFIXES = (".py",)

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m nvidia_terraform_modules_tpu_torch.analysis",
        description="graftlint: runtime-convention static analysis for "
                    "the PyTorch runtime")
    p.add_argument("dir", nargs="?", default=_PACKAGE_DIR)
    p.add_argument("-json", action="store_true")
    p.add_argument("-sarif", action="store_true")
    p.add_argument("-severity", action="append", dest="severity",
                   metavar="RULE=LEVEL")
    p.add_argument("-rules", action="store_true",
                   help="list the rule catalog and exit")
    args = p.parse_args(argv)

    if args.rules:
        for r in list_rules():
            print(f"{r.id:32} {r.severity:8} {r.family:12} {r.summary}")
        return 0

    try:
        overrides: dict[str, str] = {}
        for kv in args.severity or []:
            if "=" not in kv:
                raise ValueError(
                    f"-severity expects RULE=LEVEL, got {kv!r}")
            rid, _, level = kv.partition("=")
            overrides[rid.strip()] = level.strip()
        findings = run_graftlint(args.dir, overrides=overrides)
    except (ValueError, OSError) as ex:
        # a bad flag or an unreadable tree is a diagnostic in every
        # output format, never a traceback
        findings = [Finding("error", "", str(ex), rule="graft-load")]
    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in ("error", "warning", "info")}
    rc = exit_code(findings)
    if args.sarif:
        print(json.dumps(
            sarif_report(findings, list_rules(), "graftlint",
                         _PY_SUFFIXES),
            indent=2, sort_keys=True))
        return rc
    if args.json:
        print(json.dumps(findings_json(findings, _PY_SUFFIXES),
                         indent=2, sort_keys=True))
        return rc
    for f in findings:
        where = f"{f.where}: " if f.where else ""
        print(f"{where}{f.severity}: {f.message} [{f.rule}]")
    print(f"{'Success! ' if rc == 0 else ''}{len(findings)} finding(s): "
          f"{counts['error']} error(s), {counts['warning']} warning(s), "
          f"{counts['info']} info.")
    return rc


if __name__ == "__main__":
    sys.exit(main())
