# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Runtime lock-order watchdog: the dynamic twin of :mod:`.lockgraph`
(the port of the reference's ``analysis/lockwatch.py``).

:func:`armed` patches ``threading.Lock``/``threading.RLock`` (and,
optionally, guards ``time.sleep``) so every lock CREATED inside the
window is wrapped in a :class:`WatchedLock` named by its creation site.
The watch then observes, per thread, the actual acquisition order and
aggregates it into the same edge representation the static pass
predicts — an edge A → B for every "acquired B while holding A" — plus
every ``time.sleep`` executed while holding a watched lock (the
hold-across-blocking-poll anti-pattern that turns a slow poll into a
fleet-wide stall).

Chaos/scale tests arm it around fleet bring-up and assert
``watch.cycles() == []`` and ``watch.held_sleeps == []``: an ordering
cycle that only materialises under a kill/redrive interleaving fails
loudly instead of deadlocking a chip job. Locks are NAMED BY CREATION
SITE, so every instance of a class maps to one graph node — order is a
property of the code path, not the instance — and nested acquisition of
two same-site instances shows up as a self-loop cycle.

Overhead is one dict update per acquisition; the watch's own state is
guarded by a real (unwatched) lock captured at import time.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

from .lockgraph import LockGraph

# the genuine factories, captured before any arming can patch them
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_PKG = "nvidia_terraform_modules_tpu_torch"


def _site(skip_file: str) -> str:
    """file:line of the nearest caller frame outside this module,
    package-relative when the frame lives inside the package."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == skip_file:
        f = f.f_back
    if f is None:
        return "<unknown>:0"
    fn = f.f_code.co_filename.replace(os.sep, "/")
    _, sep, tail = fn.rpartition(f"{_PKG}/")
    short = f"{_PKG}/{tail}" if sep else fn.rpartition("/")[2]
    return f"{short}:{f.f_lineno}"


class WatchedLock:
    """A threading.Lock/RLock proxy that reports acquisition order.

    Unknown attributes delegate to the wrapped lock, so
    ``threading.Condition`` (which borrows ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` from RLocks) keeps working —
    a ``wait()`` releases the inner lock directly, which is fine: the
    waiting thread is blocked, so it can record no new edges until the
    tracked re-acquire path runs again.
    """

    def __init__(self, inner, name: str, watch: "LockWatch"):
        self._inner = inner
        self._name = name
        self._watch = watch

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._watch._note_acquire(self._name)
        return got

    def release(self):
        self._watch._note_release(self._name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, item):
        return getattr(self._inner, item)


class LockWatch:
    """Aggregated order observations from every WatchedLock."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        # (holder, acquired) -> acquisition count
        self.edges: dict = {}
        # (lock-name, "file:line" of the sleep) -> count
        self.held_sleep_sites: dict = {}
        self.lock_names: set = set()
        self.acquisitions = 0

    # ---- observation hooks (hot path) --------------------------------
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _note_acquire(self, name: str) -> None:
        s = self._stack()
        with self._mu:
            self.acquisitions += 1
            self.lock_names.add(name)
            if s:
                edge = (s[-1], name)
                self.edges[edge] = self.edges.get(edge, 0) + 1
        s.append(name)

    def _note_release(self, name: str) -> None:
        s = self._stack()
        # release the topmost matching entry: watched locks may release
        # out of LIFO order (handoff patterns), the stack must not drift
        for i in range(len(s) - 1, -1, -1):
            if s[i] == name:
                del s[i]
                break

    def _note_sleep(self, where: str) -> None:
        s = self._stack()
        if not s:
            return
        with self._mu:
            key = (s[-1], where)
            self.held_sleep_sites[key] = \
                self.held_sleep_sites.get(key, 0) + 1

    # ---- verdicts ----------------------------------------------------
    def graph(self) -> LockGraph:
        with self._mu:
            # the count-valued edge dict satisfies LockGraph's shape
            # contract (keys are (holder, acquired) pairs)
            return LockGraph(nodes=set(self.lock_names),
                             edges=dict(self.edges))

    def cycles(self) -> list:
        return self.graph().cycles()

    @property
    def held_sleeps(self) -> list:
        """Sorted (lock-name, sleep-site, count) triples — every
        time.sleep executed while holding a watched lock."""
        with self._mu:
            return sorted((lock, site, n) for (lock, site), n
                          in self.held_sleep_sites.items())

    def report(self) -> dict:
        with self._mu:
            edges = {f"{a} -> {b}": n
                     for (a, b), n in sorted(self.edges.items())}
        return {
            "locks": sorted(self.lock_names),
            "acquisitions": self.acquisitions,
            "edges": edges,
            "cycles": [" -> ".join(c) for c in self.cycles()],
            "lock_held_sleeps": [
                {"lock": lock, "sleep_at": site, "count": n}
                for lock, site, n in self.held_sleeps],
        }


@contextlib.contextmanager
def armed(guard_sleep: bool = True):
    """Patch the lock factories (and time.sleep) for the duration.

    Only locks CREATED while armed are watched — pre-existing locks
    (interpreter internals, torch, logging) stay untouched, which keeps
    the window safe to open around any fleet bring-up. The yielded
    :class:`LockWatch` keeps observing its locks after the window
    closes, so ``armed`` wraps the bring-up and the assertions can run
    on the full test's activity.
    """
    watch = LockWatch()
    here = __file__

    def make(factory):
        def create():
            return WatchedLock(factory(), _site(here), watch)
        return create

    orig_lock, orig_rlock = threading.Lock, threading.RLock
    orig_sleep = time.sleep
    threading.Lock = make(orig_lock)
    threading.RLock = make(orig_rlock)
    if guard_sleep:
        def sleep(seconds):
            watch._note_sleep(_site(here))
            orig_sleep(seconds)
        time.sleep = sleep
    try:
        yield watch
    finally:
        threading.Lock = orig_lock
        threading.RLock = orig_rlock
        if guard_sleep:
            time.sleep = orig_sleep
