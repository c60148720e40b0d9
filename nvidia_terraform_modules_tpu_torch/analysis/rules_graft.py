# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""The graft rule pack: runtime-convention checks over Python AST — the
port of the reference's ``analysis/rules_graft.py``, rule for rule, with
the same ids, severities and messages, so a tree with no torch idiom in
it gets exactly the reference's findings.

Each rule is the static form of a convention the runtime already
enforces by review: seeded RNG (PYTHONHASHSEED-immune replay), no host
sync inside traced bodies or wave loops, the injected telemetry clock,
classified-never-silent error handling (the ``HandoffCorruptError`` /
``HostSpillCorruptError`` pattern), lock-ordered thread-shared state,
and no reuse of buffers donated to a jit. Two rules also know the torch
forms of their convention: ``graft-unseeded-rng`` flags draws from
torch's global generator (a draw with no ``generator=``) and
``torch.manual_seed``; ``graft-host-sync-in-loop`` treats the body of a
``with torch.cuda.graph(...)`` capture as traced, a host loop that
replays a captured graph as a wave loop, and ``.cpu()``, ``.numpy()``
and ``synchronize()`` as syncs. All checks are best-effort syntactic
analyses — they resolve import aliases but do not infer types — tuned
so the clean idiom never fires and the violation idiom always does.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from .graftlint import rule
from .pysrc import PyContext, dotted, self_attr, walk_scope


@rule("graft-load", severity="error", family="core",
      summary="every scanned file must parse")
def check_load(ctx: PyContext):
    # force every tree so parse failures are collected, then surface
    # them — a broken file must fail the run, not silently drop its
    # findings
    for _ in ctx.trees():
        pass
    return list(ctx.load_errors)


# ------------------------------------------------------------------- rng

# draw methods whose module-level form uses the interpreter-global RNG
_GLOBAL_DRAWS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "getrandbits", "randbytes",
    "rand", "randn", "normal", "standard_normal", "permutation",
}
_RNG_FACTORIES = {
    "random.Random", "numpy.random.default_rng", "numpy.random.RandomState",
}
# torch's draws: without ``generator=`` each reads and advances the
# process-global generator (the port's convention is an explicit
# ``torch.Generator`` a stream); the ``*_like`` forms take none at all
_TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.multinomial", "torch.normal", "torch.bernoulli",
}
_TORCH_LIKE_DRAWS = {"torch.rand_like", "torch.randn_like",
                     "torch.randint_like"}
# reseeding torch's global generators: action at a distance, as
# random.seed is
_TORCH_RESEEDS = {
    "torch.manual_seed", "torch.random.manual_seed", "torch.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
}


def _seed_arg(call: ast.Call) -> Optional[ast.AST]:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg in ("seed", "x"):
            return kw.value
    return None


@rule("graft-unseeded-rng", severity="error", family="rng",
      summary="RNG draws must follow the string-seeded convention")
def check_unseeded_rng(ctx: PyContext):
    for fname, tree in ctx.trees():
        for node in ctx.nodes(fname):
            if not isinstance(node, ast.Call):
                continue
            r = ctx.resolve(fname, node.func)
            if r is None:
                continue
            where = f"{fname}:{node.lineno}"
            if r in _RNG_FACTORIES:
                seed = _seed_arg(node)
                if seed is None:
                    yield (where,
                           f"seedless {r}() draws from process entropy — "
                           f"replay breaks; seed from a string: "
                           f'random.Random(f"{{salt}}-{{seed}}")')
                elif isinstance(seed, ast.Constant) and \
                        isinstance(seed.value, (int, float)) and \
                        not isinstance(seed.value, bool):
                    yield (where,
                           f"integer-literal seed {r}({seed.value!r}) — "
                           f"literal seeds collide across components; "
                           f"derive the seed from a string salt "
                           f"(string-seeded convention)")
                elif isinstance(seed, ast.Call) and \
                        ctx.resolve(fname, seed.func) == "hash":
                    yield (where,
                           f"{r}(hash(...)) varies with PYTHONHASHSEED — "
                           f"derive the seed with a keyed digest "
                           f"(blake2b) per the string-seeded convention")
            elif r in ("random.seed", "numpy.random.seed"):
                yield (where,
                       f"{r}() reseeds the shared global RNG — action at "
                       f"a distance across every module; use a local "
                       f"string-seeded Random instead")
            elif (r.startswith("random.")
                  and r.partition(".")[2] in _GLOBAL_DRAWS) or \
                 (r.startswith("numpy.random.")
                  and r.rpartition(".")[2] in _GLOBAL_DRAWS):
                yield (where,
                       f"{r}() draws from the shared global RNG — any "
                       f"import-order or call-order change shifts the "
                       f"stream; draw from a local string-seeded Random")
            elif r in _TORCH_RESEEDS:
                yield (where,
                       f"{r}() reseeds torch's shared global generator — "
                       f"action at a distance across every module; draw "
                       f"from a local torch.Generator instead")
            elif r in _TORCH_LIKE_DRAWS or (
                    r in _TORCH_DRAWS
                    and not any(k.arg == "generator"
                                for k in node.keywords)):
                yield (where,
                       f"{r}() without generator= draws from torch's "
                       f"shared global generator — any import-order or "
                       f"call-order change shifts the stream; pass a "
                       f"local seeded torch.Generator")


# -------------------------------------------------- traced-scope helpers

# traced higher-order primitives → positional index of the body callable
_TRACED_CALLS = {
    "jax.lax.scan": (0,),
    "jax.lax.fori_loop": (2,),
    "jax.lax.while_loop": (0, 1),
    "jax.lax.cond": (1, 2),
    "jax.lax.map": (0,),
}

_JIT_WRAPPERS = ("jax.jit", "jax.pmap")


def _is_jit_expr(ctx: PyContext, fname: str, node: ast.AST) -> bool:
    """True for ``jax.jit``, ``jax.jit(...)``, and
    ``functools.partial(jax.jit, ...)`` decorator/value expressions."""
    if ctx.resolve(fname, node) in _JIT_WRAPPERS:
        return True
    if isinstance(node, ast.Call):
        rf = ctx.resolve(fname, node.func)
        if rf in _JIT_WRAPPERS:
            return True
        if rf == "functools.partial" and node.args and \
                ctx.resolve(fname, node.args[0]) in _JIT_WRAPPERS:
            return True
    return False


# context managers whose body is captured into a CUDA graph: host code
# there runs once, at capture, and replays never run it again
_CAPTURE_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}


def _is_capture(ctx: PyContext, fname: str, node: ast.AST) -> bool:
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(item.context_expr, ast.Call)
        and ctx.resolve(fname, item.context_expr.func) in _CAPTURE_CONTEXTS
        for item in node.items)


def _traced_scopes(ctx: PyContext, fname: str,
                   tree: ast.Module) -> list[ast.AST]:
    """Function/lambda nodes whose bodies run under trace: jit/pmap
    decorated defs, plus the body callables handed to scan/fori/while/
    cond (by literal lambda or by local def name), and the ``with``
    statements of a CUDA graph capture. Memoized per file — both the
    sync and wallclock rules need it."""
    cached = ctx.memo.get(("traced", fname))
    if cached is not None:
        return cached
    defs: dict[str, ast.AST] = {}
    for n in ctx.nodes(fname):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(n.name, n)
    marked: list[ast.AST] = []
    for n in ctx.nodes(fname):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_jit_expr(ctx, fname, d) for d in n.decorator_list):
                marked.append(n)
        elif _is_capture(ctx, fname, n):
            marked.append(n)
        elif isinstance(n, ast.Call):
            positions = _TRACED_CALLS.get(ctx.resolve(fname, n.func) or "")
            for p in positions or ():
                if p < len(n.args):
                    a = n.args[p]
                    if isinstance(a, ast.Lambda):
                        marked.append(a)
                    elif isinstance(a, ast.Name) and a.id in defs:
                        marked.append(defs[a.id])
    ctx.memo[("traced", fname)] = marked
    return marked


def _jitted_names(ctx: PyContext, fname: str, tree: ast.Module) -> set:
    """Local names bound to jitted callables: jit-decorated defs and
    ``name = jax.jit(...)`` / ``partial(jax.jit, ...)`` assignments."""
    cached = ctx.memo.get(("jitted", fname))
    if cached is not None:
        return cached
    names = set()
    for n in ctx.nodes(fname):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_jit_expr(ctx, fname, d) for d in n.decorator_list):
                names.add(n.name)
        elif isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and _is_jit_expr(ctx, fname, n.value):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    ctx.memo[("jitted", fname)] = names
    return names


# ------------------------------------------------------------- host sync

# the torch forms: a copy to the host (``.cpu()``, ``.numpy()``) and a
# wait on the device, a stream or an event (``synchronize()``)
_SYNC_ATTRS = {"item", "tolist", "block_until_ready", "cpu", "numpy",
               "synchronize"}
_SYNC_CALLS = {"numpy.asarray", "numpy.array", "jax.device_get"}


def _sync_calls(ctx: PyContext, fname: str, nodes: Iterator[ast.AST],
                casts: bool) -> Iterator[tuple[ast.Call, str]]:
    for n in nodes:
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) and n.func.attr in _SYNC_ATTRS:
            yield n, f".{n.func.attr}()"
            continue
        r = ctx.resolve(fname, n.func)
        if r in _SYNC_CALLS:
            yield n, f"{r}()"
        elif casts and r in ("float", "bool") and len(n.args) == 1 and \
                not isinstance(n.args[0], ast.Constant):
            yield n, f"{r}()"


def _drives_step(loop: ast.AST, jitted: set) -> Optional[str]:
    """What a host loop drives: ``"a jitted step"`` when its body calls a
    jitted name, ``"a captured graph"`` when it replays one
    (``.replay()``), else None."""
    replays = False
    for n in walk_scope(loop):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Name) and n.func.id in jitted:
            return "a jitted step"
        if isinstance(n.func, ast.Attribute) and n.func.attr == "replay":
            replays = True
    return "a captured graph" if replays else None


@rule("graft-host-sync-in-loop", severity="error", family="sync",
      summary="no device→host sync inside jitted/wave loop bodies")
def check_host_sync(ctx: PyContext):
    for fname, tree in ctx.trees():
        seen = set()
        # traced bodies: any sync there either breaks tracing or bakes a
        # trace-time constant — float()/bool() casts of tracers included
        for scope in _traced_scopes(ctx, fname, tree):
            for call, what in _sync_calls(ctx, fname, ast.walk(scope),
                                          casts=True):
                key = (call.lineno, call.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                yield (f"{fname}:{call.lineno}",
                       f"{what} inside a traced (jit/scan/fori) body — "
                       f"hoist the sync to host code outside the trace")
        # wave loops: host for/while loops that drive a jitted step or
        # replay a captured graph — a per-iteration sync serialises
        # device against host every wave
        jitted = _jitted_names(ctx, fname, tree)
        for loop in ctx.nodes(fname):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            drives = _drives_step(loop, jitted)
            if drives is None:
                continue
            for call, what in _sync_calls(ctx, fname, walk_scope(loop),
                                          casts=False):
                key = (call.lineno, call.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                yield (f"{fname}:{call.lineno}",
                       f"{what} inside a wave loop driving {drives} "
                       f"— forces a device→host sync every iteration; "
                       f"aggregate on device and sync once after the loop")


# ------------------------------------------------------------- wallclock

# epoch clocks: nondeterministic AND non-monotonic — never belong in
# runtime logic outside the allowlist
_EPOCH_CLOCKS = {
    "time.time", "time.time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}
# interval clocks: still nondeterministic, but deadline arithmetic in
# the threaded serving runtime is genuinely a real-time domain — those
# modules get a wider allowlist
_INTERVAL_CLOCKS = {
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
}
_WALLCLOCK = _EPOCH_CLOCKS | _INTERVAL_CLOCKS

# path fragments where wallclock reads are the point: the telemetry
# clock itself, retry backoff jitter, profiling, multihost barriers,
# the simulator/CLI layers, and this analysis package's own watchdog —
# the reference's list; the port's files keep the reference's names
_WALLCLOCK_ALLOW = (
    "telemetry/", "tfsim/", "smoketest/", "analysis/",
    "utils/timing.py", "utils/retry.py", "utils/profiling.py",
    "parallel/multihost.py",
)
# the threaded serving runtime: poll deadlines, heartbeat intervals and
# wave timers measure REAL elapsed time by design — interval clocks are
# fine there, epoch clocks still are not
_INTERVAL_ALLOW = _WALLCLOCK_ALLOW + (
    "models/fleet.py", "models/serving.py", "models/hostkv.py",
    "models/resilience.py", "models/checkpoint.py",
    "models/transport.py",
)


@rule("graft-wallclock-nondeterminism", severity="warning",
      family="determinism",
      summary="wallclock reads belong behind the injected clock")
def check_wallclock(ctx: PyContext):
    for fname, tree in ctx.trees():
        traced = _traced_scopes(ctx, fname, tree)
        in_trace = {id(n) for scope in traced for n in ast.walk(scope)}
        # default-arg wallclock calls are a bug in EVERY file: evaluated
        # once at import, frozen forever
        in_default = set()
        for n in ctx.nodes(fname):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                for d in (list(n.args.defaults)
                          + [k for k in n.args.kw_defaults if k]):
                    in_default.update(id(x) for x in ast.walk(d))
        for n in ctx.nodes(fname):
            if not isinstance(n, ast.Call) or \
                    ctx.resolve(fname, n.func) not in _WALLCLOCK:
                continue
            r = ctx.resolve(fname, n.func)
            allow = _INTERVAL_ALLOW if r in _INTERVAL_CLOCKS \
                else _WALLCLOCK_ALLOW
            allowed = any(frag in fname for frag in allow)
            where = f"{fname}:{n.lineno}"
            if id(n) in in_default:
                yield (where,
                       f"{r}() in default-argument position is evaluated "
                       f"once at import and frozen — default to None and "
                       f"read the clock inside the body")
            elif id(n) in in_trace:
                yield (where,
                       f"{r}() inside a traced body becomes a trace-time "
                       f"constant — every retrace bakes a new value; "
                       f"pass time in as an argument")
            elif not allowed:
                yield (where,
                       f"{r}() outside the telemetry-clock/backoff "
                       f"allowlist — inject the clock (telemetry "
                       f"`clock=`) or take `now` as a parameter so "
                       f"replay and tests stay deterministic")


# ---------------------------------------------------------- silent except

_BROAD = {"Exception", "BaseException"}


def _broad_types(ctx: PyContext, fname: str,
                 h: ast.ExceptHandler) -> Optional[str]:
    """The broad type name a handler catches, None for specific types."""
    if h.type is None:
        return "bare"
    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    for t in types:
        r = ctx.resolve(fname, t)
        if r in _BROAD:
            return r
    return None


@rule("graft-silent-except", severity="warning", family="errors",
      summary="broad except must classify, not swallow")
def check_silent_except(ctx: PyContext):
    for fname, tree in ctx.trees():
        lines = ctx.text(fname).splitlines()
        for node in ctx.nodes(fname):
            if not isinstance(node, ast.Try):
                continue
            for h in node.handlers:
                broad = _broad_types(ctx, fname, h)
                if broad is None:
                    continue
                # an explicit ruff blind-except exemption on the handler
                # line is an already-reviewed broad catch — respect it
                # rather than demanding a second suppression marker
                if 0 < h.lineno <= len(lines) and \
                        "noqa: BLE001" in lines[h.lineno - 1]:
                    continue
                reraises = any(isinstance(n, ast.Raise)
                               for n in walk_scope(h))
                if reraises:
                    continue
                where = f"{fname}:{h.lineno}"
                if broad == "bare":
                    # a bare handler has no bound name to inspect: if it
                    # does not re-raise it swallowed KeyboardInterrupt
                    yield (where,
                           "bare except swallows KeyboardInterrupt/"
                           "SystemExit along with real errors — catch a "
                           "classified type (HandoffCorruptError "
                           "pattern) or re-raise")
                    continue
                used = h.name is not None and any(
                    isinstance(n, ast.Name) and n.id == h.name
                    and isinstance(n.ctx, ast.Load)
                    for n in walk_scope(h))
                if not used:
                    yield (where,
                           f"except {broad} swallows the error without "
                           f"classifying it — map it to a typed error "
                           f"(HostSpillCorruptError pattern), log it, "
                           f"or re-raise")


# -------------------------------------------------- unlocked shared state

_LOCK_FACTORIES = {"threading.Lock", "threading.RLock",
                   "threading.Condition"}

_MUTATORS = {"append", "appendleft", "add", "remove", "discard", "pop",
             "popleft", "clear", "update", "insert", "extend",
             "setdefault", "popitem"}


def _method_writes(method: ast.AST, lock_attrs: set,
                   ) -> Iterator[tuple[str, int, bool]]:
    """(attr, line, held) for every write to ``self.<attr>`` in a
    method: assignments, augmented assigns, item stores/deletes, and
    mutating container-method calls."""

    def visit(node: ast.AST, held: bool) -> Iterator[tuple[str, int, bool]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            h = held
            if isinstance(child, ast.With):
                if any(self_attr(item.context_expr) in lock_attrs
                       for item in child.items):
                    h = True
            if isinstance(child, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = child.targets if isinstance(child, ast.Assign) \
                    else [child.target]
                for t in targets:
                    a = self_attr(t)
                    if a is not None and a not in lock_attrs:
                        yield a, child.lineno, held
                    elif isinstance(t, ast.Subscript):
                        a = self_attr(t.value)
                        if a is not None:
                            yield a, child.lineno, held
            elif isinstance(child, ast.Delete):
                for t in child.targets:
                    if isinstance(t, ast.Subscript):
                        a = self_attr(t.value)
                        if a is not None:
                            yield a, child.lineno, held
            elif isinstance(child, ast.Call) and \
                    isinstance(child.func, ast.Attribute) and \
                    child.func.attr in _MUTATORS:
                a = self_attr(child.func.value)
                if a is not None:
                    yield a, child.lineno, held
            yield from visit(child, h)

    yield from visit(method, False)


@rule("graft-unlocked-shared-state", severity="error", family="locking",
      summary="attributes locked anywhere must be locked everywhere")
def check_unlocked_shared_state(ctx: PyContext):
    for fname, tree in ctx.trees():
        for cls in ctx.nodes(fname):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            lock_attrs = set()
            for m in methods:
                for n in walk_scope(m):
                    if isinstance(n, ast.Assign) and \
                            isinstance(n.value, ast.Call) and \
                            ctx.resolve(fname, n.value.func) \
                            in _LOCK_FACTORIES:
                        for t in n.targets:
                            a = self_attr(t)
                            if a is not None:
                                lock_attrs.add(a)
            if not lock_attrs:
                continue
            writes = []
            for m in methods:
                for attr, line, held in _method_writes(m, lock_attrs):
                    writes.append((m.name, attr, line, held))
            protected = {attr for mname, attr, _, held in writes
                         if held and mname != "__init__"}
            for mname, attr, line, held in writes:
                if held or attr not in protected:
                    continue
                if mname == "__init__" or mname.endswith("_locked"):
                    # __init__ publishes no shared state yet; *_locked
                    # names the convention "caller already holds it"
                    continue
                yield (f"{fname}:{line}",
                       f"self.{attr} is written under the lock elsewhere "
                       f"in {cls.name} but written here without it — "
                       f"this write races; hold the lock (or name the "
                       f"method *_locked if the caller holds it)")


# ----------------------------------------------------------- donated reuse

def _donators(ctx: PyContext, fname: str,
              tree: ast.Module) -> dict[str, tuple[int, ...]]:
    """Local callable name → donated positional-argument indices, from
    jit decorations and assignments carrying ``donate_argnums``."""

    def positions(call: ast.Call) -> tuple[int, ...]:
        for kw in call.keywords:
            if kw.arg == "donate_argnums":
                v = kw.value
                if isinstance(v, ast.Constant) and isinstance(v.value, int):
                    return (v.value,)
                if isinstance(v, (ast.Tuple, ast.List)):
                    out = tuple(e.value for e in v.elts
                                if isinstance(e, ast.Constant)
                                and isinstance(e.value, int))
                    if out:
                        return out
        return ()

    out: dict[str, tuple[int, ...]] = {}
    for n in ctx.nodes(fname):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in n.decorator_list:
                if isinstance(d, ast.Call) and \
                        _is_jit_expr(ctx, fname, d):
                    pos = positions(d)
                    if pos:
                        out[n.name] = pos
        elif isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and _is_jit_expr(ctx, fname, n.value):
            pos = positions(n.value)
            if pos:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = pos
    return out


def _stmt_stores(stmt: ast.AST) -> set:
    """Every dotted name stored ANYWHERE in a statement (including
    nested bodies) — the conservative revive set."""
    stores = set()
    for n in walk_scope(stmt):
        if isinstance(n, (ast.Name, ast.Attribute)) and \
                isinstance(n.ctx, (ast.Store, ast.Del)):
            d = dotted(n)
            if d is not None:
                stores.add(d)
    return stores


@rule("graft-donated-reuse", severity="error", family="memory",
      summary="a buffer donated to a jit is dead after the call")
def check_donated_reuse(ctx: PyContext):
    """The reference's rule, verbatim. Torch has no buffer donation (no
    ``donate_argnums``), so over the port it finds nothing; it stays so
    that a tree with jit code gets the reference's findings."""
    for fname, tree in ctx.trees():
        donators = _donators(ctx, fname, tree)
        if not donators:
            continue
        scopes = [tree] + [n for n in ctx.nodes(fname)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
        for scope in scopes:
            yield from _scan_donations(fname, scope.body, donators, {})


def _stmt_nodes(stmt: ast.AST) -> Iterator[ast.AST]:
    """The statement's own expression nodes, excluding nested statement
    bodies (those are scanned recursively with their own dead-set)."""
    skip = set()
    for attr in ("body", "orelse", "finalbody", "handlers"):
        for sub in getattr(stmt, attr, []) or []:
            skip.add(id(sub))
    stack = [c for c in ast.iter_child_nodes(stmt) if id(c) not in skip]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(c for c in ast.iter_child_nodes(n)
                     if id(c) not in skip)


def _scan_donations(fname: str, body: list, donators: dict,
                    dead: dict) -> Iterator[tuple[str, str]]:
    """Linear scan of one statement list. ``dead`` maps a dotted buffer
    name to the (line, callee) that donated it; loads of dead names are
    findings, stores revive. Nested bodies are scanned with a copy of
    the dead-set; any store anywhere in a compound statement revives
    conservatively (a maybe-reassigned buffer is not reported)."""
    for stmt in body:
        nodes = list(_stmt_nodes(stmt))
        # loads of already-dead buffers (checked against the dead-set
        # BEFORE this statement's own donations take effect)
        for n in nodes:
            if isinstance(n, (ast.Name, ast.Attribute)) and \
                    isinstance(n.ctx, ast.Load):
                d = dotted(n)
                if d in dead:
                    line, callee = dead.pop(d)  # report once per buffer
                    yield (f"{fname}:{n.lineno}",
                           f"{d} was donated to {callee}() at line "
                           f"{line} — its device buffer is freed by "
                           f"donate_argnums; rebind it from the call's "
                           f"result before reuse")
        # this statement's donations
        donated: dict[str, tuple[int, str]] = {}
        for n in nodes:
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id in donators:
                for p in donators[n.func.id]:
                    if p < len(n.args):
                        d = dotted(n.args[p])
                        if d is not None:
                            donated[d] = (n.lineno, n.func.id)
        stores = _stmt_stores(stmt)
        for d, site in donated.items():
            if d not in stores:
                dead[d] = site
        for d in stores:
            dead.pop(d, None)
        # nested statement lists: loops re-check their own body with the
        # post-body dead-set once more, so a buffer donated on iteration
        # N and read at the top of iteration N+1 is caught
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            inner = dict(dead)
            sink = list(_scan_donations(fname, stmt.body, donators, inner))
            yield from sink
            if not sink:
                # second pass models the back-edge: only when the first
                # pass was clean (avoid duplicate straight-line reports)
                yield from _scan_donations(fname, stmt.body, donators,
                                           dict(inner))
            yield from _scan_donations(fname, stmt.orelse, donators,
                                       dict(dead))
        elif not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
            # nested defs are separate scopes, scanned on their own
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub:
                    yield from _scan_donations(fname, sub, donators,
                                               dict(dead))
            for h in getattr(stmt, "handlers", []) or []:
                yield from _scan_donations(fname, h.body, donators,
                                           dict(dead))


# ---------------------------------------------------------- unbounded recv

# the serving runtime: the files where a blocking receive or join can
# wedge a router, a replica, or the caller's fleet join — every wait
# there must be bounded (the transport seam's FrameChannel discipline)
_RECV_SCOPE = (
    "models/fleet.py", "models/serving.py", "models/transport.py",
    "models/hostkv.py", "models/resilience.py",
)
# receive-shaped methods that block forever without a timeout
_RECV_METHODS = {"get", "recv", "recv_bytes", "accept"}
# the bounded-receive idiom: a function that polls (or sets a socket
# timeout on) the connection before reading has bounded its own wait —
# FrameChannel.recv's poll-then-recv_bytes shape
_RECV_GUARDS = {"poll", "settimeout"}


@rule("graft-unbounded-recv", severity="error", family="liveness",
      summary="serving-runtime recv/join must carry a timeout")
def check_unbounded_recv(ctx: PyContext):
    """A socket/pipe/queue receive or a thread/process join without a
    timeout inside the serving runtime is a latent hang: a dead peer
    (a SIGKILLed replica process, a wedged worker) then blocks the
    router forever instead of raising a classified, retryable error.
    Flags zero-argument ``.join()`` and timeout-less
    ``.get()``/``.recv()``/``.recv_bytes()``/``.accept()`` in the
    serving-runtime files, except receives in a function that bounds
    its own wait with ``.poll(...)``/``.settimeout(...)`` first."""
    for fname, _tree in ctx.trees():
        if not any(frag in fname for frag in _RECV_SCOPE):
            continue
        for fn in ctx.nodes(fname):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            guarded = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _RECV_GUARDS
                for n in walk_scope(fn))
            for n in walk_scope(fn):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)):
                    continue
                attr = n.func.attr
                where = f"{fname}:{n.lineno}"
                if attr == "join" and not n.args and not n.keywords:
                    yield (where,
                           "unbounded .join() in the serving runtime — "
                           "a wedged worker hangs the caller forever; "
                           "join with a timeout and classify the "
                           "stragglers (fleet joins raise "
                           "FleetWorkerHung)")
                elif attr in _RECV_METHODS and not n.args \
                        and not any(k.arg == "timeout"
                                    for k in n.keywords) \
                        and not guarded:
                    yield (where,
                           f"unbounded .{attr}() in the serving "
                           f"runtime — a dead peer blocks this wait "
                           f"forever; pass a timeout (or poll the "
                           f"connection first) and raise the "
                           f"classified transport error on expiry")


# ---------------------------------------------------- spawn retry/classify

# process-spawning constructors: a child whose bring-up can fail
# TRANSIENTLY (fork/exec pressure, an interpreter that dies before the
# handshake) and must therefore never be a bare call in the serving
# runtime
_SPAWN_CALLS = {"Process", "Popen"}
# the classified-bring-up idiom: the spawn — or an ENCLOSING function;
# transport's ``_spawn`` wraps the nested ``bring_up`` closure — runs
# under ``utils/retry.retry_call``, whose policy bounds the attempts
# and whose exhaustion raises the classified terminal error the fleet
# converts to a DEAD target that redrives
_SPAWN_GUARDS = {"retry_call"}


def _function_chains(tree):
    """Every function def paired with its enclosing-function chain
    (outermost first, nested defs included) — the scope lineage a
    guard search walks, so a closure handed to a retry wrapper one
    level up still counts as guarded."""
    out: list[tuple[ast.AST, list]] = []

    def visit(node, chain):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, chain))
                visit(child, chain + [child])
            else:
                visit(child, chain)

    visit(tree, [])
    return out


def _calls_guard(scope) -> bool:
    for n in walk_scope(scope):
        if isinstance(n, ast.Call):
            callee = n.func
            if isinstance(callee, ast.Name) and \
                    callee.id in _SPAWN_GUARDS:
                return True
            if isinstance(callee, ast.Attribute) and \
                    callee.attr in _SPAWN_GUARDS:
                return True
    return False


@rule("graft-spawn-no-retry-classify", severity="error",
      family="liveness",
      summary="serving-runtime process spawns must retry then classify")
def check_spawn_no_retry_classify(ctx: PyContext):
    """A ``Process``/``Popen`` spawn in the serving runtime without a
    classified retry path is a latent hang-or-crash: a transient
    bring-up failure (fork pressure, a child that dies before its
    handshake) either wedges the caller or escapes as an unclassified
    exception, instead of retrying under a bounded policy and — on
    exhaustion — raising the terminal classification the fleet turns
    into a DEAD target whose requests redrive. Flags spawn-shaped
    calls in the serving-runtime files whose enclosing function chain
    never calls ``retry_call`` (the guard search walks ENCLOSING
    functions: a nested ``bring_up`` closure handed to ``retry_call``
    one level up is the blessed idiom)."""
    for fname, tree in ctx.trees():
        if not any(frag in fname for frag in _RECV_SCOPE):
            continue
        for fn, chain in _function_chains(tree):
            if any(_calls_guard(s) for s in (*chain, fn)):
                continue
            for n in walk_scope(fn):
                if not isinstance(n, ast.Call):
                    continue
                callee = n.func
                name = callee.attr if isinstance(callee, ast.Attribute) \
                    else callee.id if isinstance(callee, ast.Name) \
                    else None
                if name in _SPAWN_CALLS:
                    yield (f"{fname}:{n.lineno}",
                           f"bare {name}() spawn in the serving "
                           f"runtime — a transient bring-up failure "
                           f"crashes or wedges the caller; wrap the "
                           f"spawn in utils/retry.retry_call with a "
                           f"bounded policy and classify exhaustion "
                           f"as the terminal (DEAD, redrive) error")


# ---------------------------------------------- durable write atomicity

# where durable serving-runtime state lives: model/engine persistence
# (checkpoints, the AOT compile cache, the disk prefix tier, elastic
# supervisor state) and the shared utils. tfsim's state files have
# their own locking/backup discipline and are out of scope here.
_DURABLE_SCOPE = ("models/", "utils/")
# the atomic-durability idiom's signals: a scope that renames a tmp
# file into place (os.replace/os.rename) — or at least fsyncs what it
# wrote — has done the crash-safety work this rule checks for
_ATOMIC_CALLS = {"os.replace", "os.rename", "os.fsync"}
# never-atomic pathlib one-shots (no handle to fsync, no tmp+rename)
_PATH_WRITES = {"write_bytes", "write_text"}


def _write_mode(ctx: PyContext, fname: str, call: ast.Call):
    """The constant mode string of an ``open``/``io.open`` call when it
    WRITES (contains w/x/a), else None. Dynamic modes are skipped —
    best-effort, like every rule here."""
    if ctx.resolve(fname, call.func) not in ("open", "io.open"):
        return None
    mode = call.args[1] if len(call.args) >= 2 else next(
        (kw.value for kw in call.keywords if kw.arg == "mode"), None)
    if mode is None:
        return None                      # default "r": a read
    if not (isinstance(mode, ast.Constant)
            and isinstance(mode.value, str)):
        return None
    return mode.value if set(mode.value) & set("wxa") else None


def _scope_is_atomic(ctx: PyContext, fname: str, scope: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call)
        and ctx.resolve(fname, n.func) in _ATOMIC_CALLS
        for n in walk_scope(scope))


def _tmp_marked(node: ast.AST) -> bool:
    """True when the written path's expression names the TMP half of
    the atomic idiom (``tmp = f"{path}.tmp.{pid}"``; the os.replace
    that publishes it may live in an outer scope or a helper)."""
    return "tmp" in ast.unparse(node).lower()


@rule("graft-durable-write-no-atomic", severity="error",
      family="durability",
      summary="durable serving-runtime writes must be tmp+replace/fsync")
def check_durable_write_no_atomic(ctx: PyContext):
    """A serving-runtime file written WITHOUT the atomic durability
    idiom is a torn-state bug waiting for a SIGKILL: a reader after
    the crash sees a half-written frame where the contract (checkpoint
    shards, the GAC1 AOT cache, the PCD1 disk prefix tier, supervisor
    state) promises either the old record or the new one. Flags
    write-mode ``open()`` calls (and the never-atomic
    ``Path.write_bytes``/``write_text``) in the durable-scope files
    whose function scope neither renames a tmp file into place
    (``os.replace``/``os.rename``) nor fsyncs, and whose target path
    is not itself the tmp half of the idiom. The blessed shape:
    write ``f"{path}.tmp.{pid}"``, flush + ``os.fsync``, then
    ``os.replace(tmp, path)``."""
    for fname, tree in ctx.trees():
        if not any(frag in fname for frag in _DURABLE_SCOPE):
            continue
        scopes = [tree] + [n for n in ctx.nodes(fname)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
        for scope in scopes:
            if _scope_is_atomic(ctx, fname, scope):
                continue
            for n in walk_scope(scope):
                if not isinstance(n, ast.Call):
                    continue
                where = f"{fname}:{n.lineno}"
                mode = _write_mode(ctx, fname, n)
                if mode is not None and n.args \
                        and not _tmp_marked(n.args[0]):
                    yield (where,
                           f"open(..., {mode!r}) writes durable "
                           f"serving-runtime state in place — a crash "
                           f"mid-write leaves a torn file where "
                           f"readers expect old-or-new; write to a "
                           f"tmp name, flush + os.fsync, then "
                           f"os.replace(tmp, path) (the aotcache/"
                           f"DiskChainStore idiom)")
                elif isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _PATH_WRITES \
                        and not _tmp_marked(n.func.value):
                    yield (where,
                           f".{n.func.attr}() writes durable state in "
                           f"one unsynced shot — no handle to fsync, "
                           f"no tmp+rename; use the atomic idiom "
                           f"(tmp file + os.fsync + os.replace)")
