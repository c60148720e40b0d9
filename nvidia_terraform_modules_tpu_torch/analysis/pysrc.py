# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The Python-source analysis context graftlint rules consume.

The port of the reference's ``analysis/pysrc.py``: a tree of parsed
``ast`` modules with cached texts, import-alias resolution, and the
``# graftlint: ignore[rule-id]`` suppression marker. Rules are
read-only consumers; everything here is computed once per run.

Paths in findings are RELATIVE to the scan anchor (the repo root when
scanning the shipped package, the tmp dir in tests), slash-separated on
every platform, so goldens and suppressions are location-stable.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator, Optional

from .core import Finding, scan_suppressions

# the suppression marker: `# graftlint: ignore[rule-id,rule-id] reason`.
# The bracketed list is the machine part; the tail after the bracket is
# the REQUIRED human reason (the gate test counts suppressions and
# rejects reasonless ones — an unexplained exemption is a convention
# violation of its own).
IGNORE_RE = re.compile(r"#\s*graftlint:\s*ignore\[([A-Za-z0-9_*,\- ]*)\]")


class PyContext:
    """Everything a graftlint rule may need, computed once per run.

    ``root`` is a directory (scanned recursively for ``*.py``, skipping
    ``__pycache__``/hidden dirs) or a single ``.py`` file. ``rel_to``
    anchors the relative paths findings carry; it defaults to ``root``'s
    parent so the shipped package scans as
    ``nvidia_terraform_modules_tpu_torch/...``.
    """

    def __init__(self, root: str, rel_to: Optional[str] = None):
        self.root = os.path.abspath(root)
        self.rel_to = os.path.abspath(
            rel_to if rel_to is not None else os.path.dirname(self.root))
        self.load_errors: list[Finding] = []
        self._texts: dict[str, str] = {}
        self._trees: dict[str, Optional[ast.Module]] = {}
        self._aliases: dict[str, dict[str, str]] = {}
        self._nodes: dict[str, list[ast.AST]] = {}
        # rules memoize per-file derived artifacts here (traced scopes,
        # jitted names) so no tree is re-derived across rules — the
        # smoketest preflight runs this scan on the Job's critical path
        self.memo: dict = {}
        self.files: list[str] = sorted(self._discover())

    def _discover(self) -> Iterator[str]:
        if os.path.isfile(self.root):
            yield self._rel(self.root)
            return
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for f in sorted(filenames):
                if f.endswith(".py"):
                    yield self._rel(os.path.join(dirpath, f))

    def _rel(self, path: str) -> str:
        return os.path.relpath(path, self.rel_to).replace(os.sep, "/")

    # ---- raw sources ------------------------------------------------
    def text(self, fname: str) -> str:
        if fname not in self._texts:
            with open(os.path.join(self.rel_to, fname),
                      encoding="utf-8") as fh:
                self._texts[fname] = fh.read()
        return self._texts[fname]

    def tree(self, fname: str) -> Optional[ast.Module]:
        """Parsed AST, or None when the file does not parse — contained,
        not fatal: the syntax error lands in :attr:`load_errors` (the
        ``graft-load`` rule surfaces it) and every other file keeps its
        findings."""
        if fname not in self._trees:
            try:
                self._trees[fname] = ast.parse(self.text(fname),
                                               filename=fname)
            except SyntaxError as ex:
                self._trees[fname] = None
                self.load_errors.append(Finding(
                    "error", f"{fname}:{ex.lineno or 0}",
                    f"file does not parse: {ex.msg}", rule="graft-load"))
        return self._trees[fname]

    def trees(self) -> Iterator[tuple[str, ast.Module]]:
        for fname in self.files:
            t = self.tree(fname)
            if t is not None:
                yield fname, t

    def nodes(self, fname: str) -> list[ast.AST]:
        """The file's full node list, walked once and shared: every rule
        that scans the whole tree iterates this instead of re-running
        ``ast.walk`` (the scan's dominant cost at package size)."""
        if fname not in self._nodes:
            t = self.tree(fname)
            self._nodes[fname] = [] if t is None else list(ast.walk(t))
        return self._nodes[fname]

    # ---- import-alias resolution ------------------------------------
    def aliases(self, fname: str) -> dict[str, str]:
        """Local name → canonical dotted prefix, from the file's import
        statements (``import numpy as np`` → ``np: numpy``; ``from
        functools import partial`` → ``partial: functools.partial``), so
        rules match ``np.random.seed`` and ``numpy.random.seed`` alike."""
        if fname not in self._aliases:
            amap: dict[str, str] = {}
            tree = self.tree(fname)
            for node in ast.walk(tree) if tree else ():
                if isinstance(node, ast.Import):
                    for a in node.names:
                        amap[a.asname or a.name.partition(".")[0]] = \
                            a.name if a.asname else a.name.partition(".")[0]
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    for a in node.names:
                        if a.name != "*":
                            amap[a.asname or a.name] = \
                                f"{node.module}.{a.name}"
            self._aliases[fname] = amap
        return self._aliases[fname]

    def resolve(self, fname: str, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, with the
        file's import aliases applied — or None for non-name expressions
        (calls, subscripts) anywhere in the chain."""
        d = dotted(node)
        if d is None:
            return None
        head, dot, rest = d.partition(".")
        base = self.aliases(fname).get(head, head)
        return f"{base}{dot}{rest}" if dot else base

    # ---- suppressions ------------------------------------------------
    def suppressions(self, known) -> dict[tuple[str, int], set]:
        return scan_suppressions(
            ((f, self.text(f)) for f in self.files), IGNORE_RE, known)

    def count_suppressions(self) -> list[tuple[str, int, str]]:
        """Every ``graftlint: ignore`` comment in the scanned tree, as
        ``(fname, line, tail-after-bracket)`` — the gate test's audit
        surface: suppressions are counted, capped, and must carry a
        reason string after the bracket."""
        out = []
        for fname in self.files:
            for i, raw in enumerate(self.text(fname).splitlines(), 1):
                m = IGNORE_RE.search(raw)
                if m:
                    out.append((fname, i,
                                raw[m.end():].strip(" \t—-#")))
        return out


# ---------------------------------------------------------- ast helpers

def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a pure Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def self_attr(node: ast.AST) -> Optional[str]:
    """``attr`` when node is exactly ``self.attr``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def walk_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested function or
    class definitions — the scope-local twin of :func:`ast.walk`."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))
