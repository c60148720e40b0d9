# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Static lock-acquisition-order graph + cycle detection (the port of the
reference's ``analysis/lockgraph.py``).

Builds the may-acquire graph over every scanned module: nodes are lock
creation sites (``file::Class.attr`` for ``self.x = threading.Lock()``,
``file::NAME`` for module-level locks), and an edge A → B means some
code path acquires B while holding A — either a directly nested
``with``, or a call made under A into a function whose transitive
may-acquire set contains B (an interprocedural fixpoint over the local
call graph). A cycle in that graph is a potential deadlock: two threads
entering the cycle from different nodes block each other forever.

Resolution is best-effort and deliberately conservative about
ambiguity: ``self.m()`` resolves within the class, bare names resolve
within the module, and ``obj.m()`` resolves across classes only when
exactly one scanned class defines ``m`` — an ambiguous method name
contributes no edge rather than a spurious cycle.

The runtime twin is :mod:`.lockwatch`, which observes the ACTUAL
acquisition order under chaos tests; this module predicts it from
source.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Optional

from .graftlint import rule
from .pysrc import PyContext, self_attr, walk_scope

_LOCK_FACTORIES = {"threading.Lock", "threading.RLock"}


@dataclasses.dataclass
class LockGraph:
    nodes: set
    # (holder, acquired) -> "file:line" of the first site creating it
    edges: dict

    def cycles(self) -> list[list[str]]:
        """Dependency cycles as node paths closed on the start node
        (``[A, B, A]``), deterministically ordered. Computed per
        strongly-connected component; within an SCC every node pair is
        mutually reachable, so one canonical cycle through the
        component (plus self-loops) is complete for the fail/pass
        question the gate asks."""
        adj: dict = {}
        for a, b in self.edges:
            adj.setdefault(a, set()).add(b)
        out = []
        for comp in _sccs(adj):
            if len(comp) == 1:
                n = comp[0]
                if n in adj.get(n, ()):
                    out.append([n, n])
                continue
            comp = sorted(comp)
            # canonical walk: from the smallest node, greedily step to
            # the smallest in-component unvisited successor (falling
            # back to the start) until closure
            path, cur = [comp[0]], comp[0]
            while True:
                succ = [b for b in adj.get(cur, ()) if b in comp
                        and b not in path[1:] and b != cur]
                nxt = min(succ) if succ else path[0]
                path.append(nxt)
                if nxt == path[0]:
                    break
                cur = nxt
            out.append(path)
        return sorted(out)


def _sccs(adj: dict) -> list[list]:
    """Tarjan's strongly-connected components, iterative."""
    index: dict = {}
    low: dict = {}
    on: set = set()
    stack: list = []
    comps: list[list] = []
    counter = [0]

    def strongconnect(root):
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                comps.append(comp)

    nodes = set(adj)
    for tos in adj.values():
        nodes.update(tos)
    for n in sorted(nodes):
        if n not in index:
            strongconnect(n)
    return comps


# ------------------------------------------------------------ collection

@dataclasses.dataclass
class _FnInfo:
    key: tuple                    # (fname, class-or-None, name)
    acquires: set                 # lock nodes taken directly
    # events: (holder-or-None, callee-candidate-keys, direct-lock-node,
    #          "file:line") — a `with` acquisition has direct set and no
    # candidates; a call has candidates and direct None
    events: list


def _collect(ctx: PyContext) -> dict[tuple, _FnInfo]:
    fns: dict[tuple, _FnInfo] = {}
    # registration pass over ALL files first, so obj.m() calls in file A
    # can resolve to the unique class defining m in file B
    method_owners: dict[str, set] = {}
    per_file_module_locks: dict[str, dict] = {}
    per_file_class_locks: dict[str, dict] = {}

    for fname, tree in ctx.trees():
        module_locks: dict = {}
        for n in tree.body:
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                    and ctx.resolve(fname, n.value.func) in _LOCK_FACTORIES:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        module_locks[t.id] = f"{fname}::{t.id}"
        per_file_module_locks[fname] = module_locks

        class_locks: dict[str, dict] = {}
        for n in tree.body:
            if not isinstance(n, ast.ClassDef):
                continue
            lock_map: dict = {}
            cond_alias: dict = {}
            for m in n.body:
                if not isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    continue
                method_owners.setdefault(m.name, set()).add((fname, n.name))
                for s in walk_scope(m):
                    if isinstance(s, ast.Assign) and \
                            isinstance(s.value, ast.Call):
                        r = ctx.resolve(fname, s.value.func)
                        for t in s.targets:
                            a = self_attr(t)
                            if a is None:
                                continue
                            if r in _LOCK_FACTORIES:
                                lock_map[a] = f"{fname}::{n.name}.{a}"
                            elif r == "threading.Condition":
                                # Condition(self._lock) IS that lock; a
                                # bare Condition() is its own node
                                arg = s.value.args[0] if s.value.args \
                                    else None
                                inner = self_attr(arg) \
                                    if arg is not None else None
                                cond_alias[a] = inner or a
            for a, target in cond_alias.items():
                lock_map[a] = lock_map.get(
                    target, f"{fname}::{n.name}.{a}")
            class_locks[n.name] = lock_map
        per_file_class_locks[fname] = class_locks

    # summary pass: one _FnInfo per function/method
    for fname, tree in ctx.trees():
        module_locks = per_file_module_locks[fname]

        def scan_function(fn, cls_name, lock_map):
            key = (fname, cls_name, fn.name)
            info = fns.setdefault(key, _FnInfo(key, set(), []))

            def lock_node(expr) -> Optional[str]:
                a = self_attr(expr)
                if a is not None:
                    return lock_map.get(a)
                if isinstance(expr, ast.Name):
                    return module_locks.get(expr.id)
                return None

            def visit(node, held):
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef, ast.Lambda)):
                        continue
                    h = held
                    if isinstance(child, ast.With):
                        for item in child.items:
                            ln = lock_node(item.context_expr)
                            if ln is not None:
                                info.acquires.add(ln)
                                info.events.append(
                                    (h[-1] if h else None, (), ln,
                                     f"{fname}:{child.lineno}"))
                                h = h + [ln]
                    if isinstance(child, ast.Call):
                        cands = ()
                        f = child.func
                        a = self_attr(f)
                        if a is not None and cls_name is not None:
                            cands = ((fname, cls_name, a),)
                        elif isinstance(f, ast.Name):
                            cands = ((fname, None, f.id),)
                        elif isinstance(f, ast.Attribute):
                            owners = method_owners.get(f.attr, ())
                            if len(owners) == 1:
                                (ofile, ocls), = owners
                                cands = ((ofile, ocls, f.attr),)
                        if cands:
                            info.events.append(
                                (h[-1] if h else None, cands, None,
                                 f"{fname}:{child.lineno}"))
                    visit(child, h)

            visit(fn, [])

        for n in tree.body:
            if isinstance(n, ast.ClassDef):
                for m in n.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        scan_function(
                            m, n.name,
                            per_file_class_locks[fname][n.name])
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_function(n, None, {})

    return fns


def build_lock_graph(ctx: PyContext) -> LockGraph:
    fns = _collect(ctx)

    # interprocedural fixpoint: may_acquire(fn) = direct ∪ callees'
    may: dict[tuple, set] = {k: set(i.acquires) for k, i in fns.items()}
    changed = True
    while changed:
        changed = False
        for key, info in fns.items():
            for _, cands, _, _ in info.events:
                for c in cands:
                    if c in may and not may[c] <= may[key]:
                        may[key] |= may[c]
                        changed = True

    nodes: set = set()
    edges: dict = {}
    for info in fns.values():
        nodes |= info.acquires
        for holder, cands, direct, where in info.events:
            if direct is not None:
                if holder is not None and holder != direct:
                    edges.setdefault((holder, direct), where)
                continue
            if holder is None:
                continue
            for c in cands:
                for acquired in may.get(c, ()):
                    if acquired != holder:
                        edges.setdefault((holder, acquired), where)
    return LockGraph(nodes=nodes, edges=edges)


@rule("graft-lock-cycle", severity="error", family="locking",
      summary="the static lock-acquisition-order graph must be acyclic")
def check_lock_cycles(ctx: PyContext) -> Iterator[tuple[str, str]]:
    g = build_lock_graph(ctx)
    for cyc in g.cycles():
        # anchor the finding at the first edge of the cycle
        where = g.edges.get((cyc[0], cyc[1])) or "lockgraph:0"
        path = " -> ".join(c.split("::", 1)[-1] for c in cyc)
        files = sorted({c.split("::", 1)[0] for c in cyc})
        yield (where,
               f"lock-order cycle {path} (locks created in "
               f"{', '.join(files)}) — two threads entering from "
               f"different ends deadlock; impose one global "
               f"acquisition order")
