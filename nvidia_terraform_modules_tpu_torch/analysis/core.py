# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The language-agnostic static-analysis rule engine — the port of the
reference's ``analysis/core.py``, the parts graftlint uses (the
reference shares them with its Terraform linter, which the port does not
carry).

* :class:`Finding` — the one diagnostic record, rendered and serialised;
* :class:`Rule` + :class:`Registry` — the rule registry. Each tool owns
  a Registry instance; rule ids are unique per registry, rules carry a
  stable id, a family, a default severity and a check callable;
* per-rule severity overrides (``rule=level``, level ``off`` disables);
* suppression comments, parameterised by the tool's marker regex
  (``# graftlint: ignore[rule-id]``): a trailing comment covers its own
  line, a standalone comment covers the line below, ``*`` suppresses
  everything at that location;
* :meth:`Registry.run` — run every enabled rule over a tool-provided
  context, filter, sort;
* severity exit codes (2 = errors, 1 = warnings only, 0 = clean);
* the machine-readable surfaces — per-finding JSON records and SARIF
  2.1.0 documents, in the reference's schema, so a CI annotator parses
  both packages' findings alike.

Severities order ``error > warning > info``; ``info`` never fails a
build.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Container, Iterable, Iterator, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    severity: str   # "error" | "warning" | "info"
    where: str      # file:line
    message: str
    rule: str = ""  # stable rule id

    def __str__(self) -> str:
        # the reference's rendering, unchanged: the CLI formats findings
        # itself (file-first, rule-id suffix) for CI annotators
        return f"{self.severity}: {self.where}: {self.message}"

    @property
    def file(self) -> str:
        return self.where.rpartition(":")[0]

    @property
    def line(self) -> int:
        tail = self.where.rpartition(":")[2]
        return int(tail) if tail.isdigit() else 0


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str        # default; overridable per run
    family: str          # tool-defined axis ("tpu", "rng", "locking", …)
    summary: str
    check: Callable[..., Iterable]


class Registry:
    """One tool's rule catalog + the generic run loop.

    ``catalog_hint`` is appended to the unknown-rule-id error so the
    CLI points at its own ``-rules`` listing. Rule modules register
    lazily through :meth:`loader` (they import the registry back —
    eager loading would be a cycle), and :meth:`ensure_loaded` imports
    them exactly once.
    """

    def __init__(self, tool: str, catalog_hint: str = ""):
        self.tool = tool
        self.catalog_hint = catalog_hint
        self.rules: dict[str, Rule] = {}
        self._loaders: list[Callable[[], None]] = []
        self._loaded = False

    # ---- registration -----------------------------------------------
    def rule(self, id: str, *, severity: str, family: str, summary: str):
        """Register a rule. The check yields ``(where, message)`` pairs —
        stamped with the rule's severity — or full :class:`Finding`s when
        a single rule emits them itself (``graft-load``)."""
        if severity not in SEVERITIES:
            raise ValueError(f"rule {id!r}: bad default severity {severity!r}")

        def deco(fn):
            if id in self.rules:
                raise ValueError(f"duplicate rule id {id!r}")
            self.rules[id] = Rule(id=id, severity=severity, family=family,
                                  summary=summary, check=fn)
            return fn
        return deco

    def loader(self, fn: Callable[[], None]) -> Callable[[], None]:
        self._loaders.append(fn)
        return fn

    def ensure_loaded(self) -> None:
        if not self._loaded:
            self._loaded = True
            for fn in self._loaders:
                fn()

    def list(self) -> list[Rule]:
        self.ensure_loaded()
        return sorted(self.rules.values(), key=lambda r: (r.family, r.id))

    # ---- the run loop -----------------------------------------------
    def check_overrides(self, overrides: dict[str, str]) -> None:
        self.ensure_loaded()
        for rid, level in overrides.items():
            if level not in SEVERITIES and level != "off":
                raise ValueError(
                    f"-severity {rid}={level}: level must be one "
                    f"of {', '.join(SEVERITIES)} or off")
            if rid not in self.rules:
                hint = f" {self.catalog_hint}" if self.catalog_hint else ""
                raise ValueError(f"-severity {rid}: unknown rule id{hint}")

    def run(self, ctx, overrides: Optional[dict[str, str]] = None,
            suppressed: Optional[dict[tuple[str, int], set]] = None,
            ) -> list[Finding]:
        """Run every enabled rule over ``ctx`` (whatever the tool's rules
        consume). ``overrides`` maps rule id → severity (or ``"off"``);
        ``suppressed`` maps (file, line) → suppressed rule ids. Returns
        findings sorted by (file, line, rule, message)."""
        overrides = overrides or {}
        self.check_overrides(overrides)
        suppressed = suppressed or {}
        findings: list[Finding] = []
        for r in self.list():
            if overrides.get(r.id) == "off":
                continue
            for item in r.check(ctx):
                if isinstance(item, Finding):
                    f = item
                    f.rule = f.rule or r.id
                else:
                    where, message = item
                    f = Finding(r.severity, where, message, rule=r.id)
                eff = overrides.get(f.rule)
                if eff == "off":
                    continue
                if eff is not None:
                    f.severity = eff
                ids = suppressed.get((f.file, f.line), ())
                if f.rule in ids or "*" in ids:
                    continue
                findings.append(f)
        findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
        return findings


# ----------------------------------------------------------- suppression

def ignore_ids(tail: str, known: Container[str]) -> set:
    """The suppressed rule ids in an ignore comment's tail.

    The id list ends at the first token that is not a registered rule id
    (or ``*``): free prose after the list must never suppress extra
    rules just because a rule id happens to be an ordinary word someone
    typed in an explanation.
    """
    ids: set = set()
    for tok in re.split(r"[,\s]+", tail.strip()):
        if not tok:
            continue
        if tok != "*" and tok not in known:
            break
        ids.add(tok)
    return ids


def scan_suppressions(files: Iterator[tuple[str, str]],
                      marker: "re.Pattern[str]",
                      known: Container[str],
                      ) -> dict[tuple[str, int], set]:
    """(fname, line) → rule-ids suppressed there, for every ``(fname,
    text)`` pair in ``files`` whose lines carry ``marker`` comments
    (group 1 = the id-list tail).

    A trailing comment covers its own line; a standalone comment line
    covers the next line (the idiomatic "annotate the finding above it"
    placement). ``*`` suppresses every rule at that location.
    """
    out: dict[tuple[str, int], set] = {}
    for fname, text in files:
        for i, raw in enumerate(text.splitlines(), start=1):
            m = marker.search(raw)
            if not m:
                continue
            ids = ignore_ids(m.group(1), known)
            if not ids:
                continue
            target = i + 1 if raw.lstrip().startswith("#") else i
            out.setdefault((fname, target), set()).update(ids)
    return out


# ------------------------------------------------------------------ exit

def exit_code(findings: Iterable[Finding]) -> int:
    """Severity-based exit code: 2 = errors, 1 = warnings only, 0 = clean
    (info findings never fail a build)."""
    severities = {f.severity for f in findings}
    if "error" in severities:
        return 2
    if "warning" in severities:
        return 1
    return 0


# --------------------------------------------- machine-readable surfaces

def source_location(f: Finding,
                    suffixes: tuple[str, ...]) -> tuple[str, int] | None:
    """``(file, line)`` when a finding points at a real source artifact,
    else None. THE location filter for every machine-readable surface
    (JSON, SARIF): synthetic locations — pseudo-filenames with no source
    suffix and empty wheres — would make a CI annotator emit
    rejected/misplaced annotations. Line 0 (module-level findings in a
    1-based scheme) means file-only."""
    fname = f.file
    if not fname or not fname.endswith(suffixes):
        return None
    return fname, f.line


def finding_json(f: Finding, suffixes: tuple[str, ...]) -> dict:
    d = {"rule": f.rule, "severity": f.severity, "where": f.where,
         "message": f.message}
    loc = source_location(f, suffixes)
    if loc is not None:
        d["file"] = loc[0]
        if loc[1] >= 1:
            d["line"] = loc[1]
    return d


def findings_json(findings: Iterable[Finding],
                  suffixes: tuple[str, ...]) -> dict:
    """The ``-json`` document the CLI prints (the reference's schema)."""
    findings = list(findings)
    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in ("error", "warning", "info")}
    return {
        "format_version": "1.0",
        "clean": exit_code(findings) == 0,
        "error_count": counts["error"],
        "warning_count": counts["warning"],
        "info_count": counts["info"],
        "findings": [finding_json(f, suffixes) for f in findings],
    }


def sarif_report(findings: Iterable[Finding], rules: Iterable[Rule],
                 tool: str, suffixes: tuple[str, ...]) -> dict:
    """Minimal SARIF 2.1.0 — the format CI annotators and code-scanning
    UIs ingest natively; ``info`` maps to SARIF's ``note`` level."""
    level = {"error": "error", "warning": "warning", "info": "note"}
    results = []
    for f in findings:
        r = {"ruleId": f.rule, "level": level.get(f.severity, "warning"),
             "message": {"text": f.message}}
        loc = source_location(f, suffixes)
        if loc is not None:
            region = {"startLine": loc[1]} if loc[1] >= 1 else {}
            r["locations"] = [{"physicalLocation": {
                "artifactLocation": {"uri": loc[0]},
                **({"region": region} if region else {}),
            }}]
        results.append(r)
    return {
        "version": "2.1.0",
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "runs": [{
            "tool": {"driver": {
                "name": tool,
                "rules": [{
                    "id": r.id,
                    "shortDescription": {"text": r.summary},
                    "defaultConfiguration": {
                        "level": level.get(r.severity, "warning")},
                } for r in rules],
            }},
            "results": results,
        }],
    }
