"""Lock-witness: runtime lock-order recording (a lightweight Python TSan).

Reference behavior: the kernel-lockdep idea applied to the engine's host
locks. The static pass (analysis/concur_check.py) PROVES lock discipline
from source; this module VALIDATES that model against real interleavings:
every lock created through the factories below records, per thread, the
set of locks held while a new acquisition blocks, into one process-wide
lock-ORDER graph keyed by lock *name* (the "lock class", in lockdep
terms — all instances of `QueryCache._lock` are one node). A cycle in
that graph at session teardown means two threads CAN deadlock under some
interleaving, even if this run's scheduling never hit it — the witness
fails the run with both acquisition stacks.

Usage:
- lock-owning modules create locks via ``lockdep.lock("Class._attr")`` /
  ``rlock`` / ``condition`` instead of ``threading.Lock()`` et al. With
  the witness DISABLED (production default) the factories return the
  plain threading primitives — zero overhead, byte-identical behavior.
- tests/conftest.py sets ``SR_TPU_LOCK_WITNESS=1`` before the first
  starrocks_tpu import (module-level singletons create their locks at
  import time), so tier-1 + the chaos suite run every lock through
  DebugLock; a session-teardown fixture asserts no order cycles.
- tests that deliberately seed inversions build a private ``Witness()``
  so the global graph (and the teardown gate) stays clean.

This module is imported by every lock-owning layer, so it imports NOTHING
from the package (stdlib only) — see module_boundary_manifest.json.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from threading import get_ident


class LockOrderError(RuntimeError):
    """Raised on a certain deadlock (re-acquiring a held non-reentrant
    lock); potential deadlocks (order cycles) are reported at teardown."""


def _site(skip_internal=True) -> str:
    """Cheap caller site (file:line in func), skipping lockdep/threading
    frames — captured at every push, so kept to a frame walk (full stacks
    are only formatted when a NEW graph edge is witnessed)."""
    f = sys._getframe(1)
    here = os.path.dirname(os.path.abspath(__file__))
    while f is not None and skip_internal:
        fn = f.f_code.co_filename
        if not fn.startswith(os.path.join(here, "lockdep")) \
                and "threading" not in os.path.basename(fn):
            break
        f = f.f_back
    if f is None:
        return "?"
    return f"{f.f_code.co_filename}:{f.f_lineno} in {f.f_code.co_name}"


class Witness:
    """The order graph + per-thread held stacks. One global instance
    (``WITNESS``) backs the factories; tests may build private ones."""

    def __init__(self):
        self._mu = threading.Lock()   # guards the edge dict only; never
        #                               held while any witnessed lock is
        #                               acquired (leaf in the order graph)
        self._edges: dict = {}        # guarded_by: _mu — (a, b) -> info
        self._tls = threading.local()

    # --- per-thread held stack ------------------------------------------------
    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def before_block(self, lock):
        """Called before a BLOCKING acquire: record held -> acquiring
        edges (the held-while-waiting edges) and catch self-deadlock."""
        held = self._held()
        if not held:
            return
        for h, _site_str in held:
            if h is lock and not lock.reentrant:
                raise LockOrderError(
                    f"self-deadlock: thread {get_ident()} re-acquiring "
                    f"non-reentrant lock {lock.name!r} it already holds")
        for h, held_site in held:
            self._edge(h.name, lock.name, held_site)

    def _edge(self, a: str, b: str, held_site: str):
        """Record one a -> b order edge (a's holder waited on b)."""
        if a == b:
            return  # same lock class: reentrancy / sibling instance
        key = (a, b)
        with self._mu:
            info = self._edges.get(key)
            if info is not None:
                info["count"] += 1
                return
            self._edges[key] = {
                "count": 1,
                "thread": get_ident(),
                "held_at": held_site,
                "acquire_stack": "".join(
                    traceback.format_stack(limit=16)[:-2]),
            }

    def on_event_set(self, event):
        """Called when a witnessed Event fires while this thread holds
        locks: record event -> held edges ("this event only fires after
        these locks are taken") — the REVERSE direction of the held ->
        event edges `before_block` records at wait sites. Together they
        close the classic handoff deadlock into a visible cycle: thread
        1 parks on E holding A (edge A -> E), thread 2 can only reach
        its `E.set()` under A (edge E -> A) — neither run has to hang
        for `order_cycles()` to report A -> E -> A."""
        for h, held_site in self._held():
            self._edge(event.name, h.name, held_site)

    def push(self, lock):
        self._held().append((lock, _site()))

    def pop(self, lock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    # --- graph queries --------------------------------------------------------
    def edges(self) -> dict:
        with self._mu:
            return dict(self._edges)

    def order_cycles(self) -> list:
        """Cycles in the name graph, each as the list of nodes along it.
        Any cycle = a potential deadlock (two threads can interleave the
        recorded orders against each other)."""
        with self._mu:
            adj: dict = {}
            for a, b in self._edges:
                adj.setdefault(a, set()).add(b)
                adj.setdefault(b, set())
        # Tarjan SCC, iterative; SCCs with >1 node (or a self-edge, which
        # before_block already filters) are cycles
        index: dict = {}
        low: dict = {}
        onstack: set = set()
        stack: list = []
        sccs: list = []
        counter = [0]
        for root in sorted(adj):
            if root in index:
                continue
            work = [(root, iter(sorted(adj[root])))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            onstack.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        onstack.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    if w in onstack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    scc = []
                    while True:
                        w = stack.pop()
                        onstack.discard(w)
                        scc.append(w)
                        if w == v:
                            break
                    if len(scc) > 1:
                        sccs.append(sorted(scc))
        return sccs

    def render(self, cycles=None) -> str:
        """Human-readable cycle report: the cycle's nodes plus, for every
        edge inside it, where the held lock was taken and the full stack
        of the acquisition that recorded the edge — "both stacks"."""
        if cycles is None:
            cycles = self.order_cycles()
        if not cycles:
            return "lock witness: no order cycles"
        edges = self.edges()
        out = []
        for scc in cycles:
            out.append(f"lock-order cycle over {scc}:")
            members = set(scc)
            for (a, b), info in sorted(edges.items()):
                if a in members and b in members:
                    out.append(
                        f"  {a} -> {b} (x{info['count']}, thread "
                        f"{info['thread']}):\n"
                        f"    {a} held at {info['held_at']}\n"
                        f"    {b} acquired at:\n" + "".join(
                            "      " + ln + "\n"
                            for ln in info["acquire_stack"].splitlines()))
        return "\n".join(out)

    def reset(self):
        with self._mu:
            self._edges.clear()


class DebugLock:
    """threading.Lock wrapper that feeds the witness. Non-reentrant:
    re-acquiring from the holding thread raises LockOrderError instead of
    deadlocking the test run."""

    reentrant = False

    __slots__ = ("name", "_witness", "_block")

    def __init__(self, name: str, witness: Witness):
        self.name = name
        self._witness = witness
        self._block = threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        if blocking:
            self._witness.before_block(self)
        ok = self._block.acquire(blocking, timeout)
        if ok:
            self._witness.push(self)
        return ok

    def release(self):
        self._block.release()
        self._witness.pop(self)

    def locked(self):
        return self._block.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class DebugRLock:
    """Reentrant witness lock. Implements the _is_owned/_release_save/
    _acquire_restore protocol so threading.Condition can wrap it (the
    default Condition._is_owned probe is wrong for any RLock)."""

    reentrant = True

    __slots__ = ("name", "_witness", "_block", "_owner", "_count")

    def __init__(self, name: str, witness: Witness):
        self.name = name
        self._witness = witness
        self._block = threading.Lock()
        # owner/count are written only by the thread that holds (or is
        # becoming the holder of) _block — the lock itself is the guard
        self._owner = None   # lint: unguarded-ok — holder-thread only
        self._count = 0      # lint: unguarded-ok — holder-thread only

    def acquire(self, blocking=True, timeout=-1):
        me = get_ident()
        if self._owner == me:
            self._count += 1
            return True
        if blocking:
            self._witness.before_block(self)
        ok = self._block.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._count = 1
            self._witness.push(self)
        return ok

    def release(self):
        if self._owner != get_ident():
            raise RuntimeError("cannot release un-acquired DebugRLock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            self._block.release()
            self._witness.pop(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # --- Condition protocol ---------------------------------------------------
    def _is_owned(self):
        return self._owner == get_ident()

    def _release_save(self):
        count = self._count
        self._count = 0
        self._owner = None
        self._block.release()
        self._witness.pop(self)
        return count

    def _acquire_restore(self, count):
        self._witness.before_block(self)
        self._block.acquire()
        self._owner = get_ident()
        self._count = count
        self._witness.push(self)


class DebugEvent:
    """threading.Event wrapper that feeds the witness: `wait` records
    held -> event edges via `before_block`, `set` records the reverse
    event -> held edges via `on_event_set`. Reentrant and never pushed
    onto the held stack — any number of threads may park on one event,
    and holding it is not a concept. Covers the serving pool's
    `_Work.done` handoff (NEXT: Event-based handoffs were the one
    synchronization primitive the witness couldn't see)."""

    reentrant = True

    __slots__ = ("name", "_witness", "_ev")

    def __init__(self, name: str, witness: Witness):
        self.name = name
        self._witness = witness
        self._ev = threading.Event()

    def wait(self, timeout=None):
        self._witness.before_block(self)
        return self._ev.wait(timeout)

    def set(self):
        self._witness.on_event_set(self)
        self._ev.set()

    def clear(self):
        self._ev.clear()

    def is_set(self):
        return self._ev.is_set()


# --- factories ----------------------------------------------------------------

WITNESS = Witness()

_enabled = os.environ.get("SR_TPU_LOCK_WITNESS", "") not in ("", "0", "false")


def enabled() -> bool:
    return _enabled


def enable():
    """Turn the witness on for locks created FROM NOW ON (existing plain
    locks stay plain — set SR_TPU_LOCK_WITNESS before the first package
    import to cover the module-level singletons)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def lock(name: str, witness: Witness | None = None):
    """A mutex for ``self._lock = lockdep.lock("Class._lock")`` fields.
    Plain threading.Lock when the witness is off."""
    if not _enabled:
        return threading.Lock()
    return DebugLock(name, witness or WITNESS)


def rlock(name: str, witness: Witness | None = None):
    if not _enabled:
        return threading.RLock()
    return DebugRLock(name, witness or WITNESS)


def event(name: str, witness: Witness | None = None):
    """An Event whose wait/set sites join the lock-order graph (the
    serving pool's worker -> connection-thread handoff). Plain
    threading.Event when the witness is off."""
    if not _enabled:
        return threading.Event()
    return DebugEvent(name, witness or WITNESS)


def condition(name: str, witness: Witness | None = None):
    """A Condition whose underlying mutex is witnessed (the condition's
    wait/notify protocol rides DebugRLock's Condition hooks)."""
    if not _enabled:
        return threading.Condition()
    return threading.Condition(DebugRLock(name, witness or WITNESS))
