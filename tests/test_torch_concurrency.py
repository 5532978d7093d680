"""Port counterpart of tests/test_concurrency.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). Multithreaded stress + lock-witness tests (ISSUE 6).

The runtime half of the concurrency contract: N threads hammer the
engine's shared registries — QueryRegistry register/cancel/snapshot,
MemoryAccountant charge/release, query-cache get/put/invalidate — with
the DebugLock witness recording every acquisition order (conftest enables
it process-wide). Afterward the accountant books must balance to zero and
the global order graph must be acyclic. Plus regression tests for the two
pre-existing races this round fixed (MetricRegistry get-or-create,
QueryRegistry.last_kill_result) and unit tests for the witness itself.
"""

from __future__ import annotations

import threading

import pytest

from starrocks_tpu_torch import lockdep
from starrocks_tpu_torch.cache.query_cache import QueryCache
from starrocks_tpu_torch.runtime.lifecycle import (
    MemoryAccountant,
    QueryContext,
    QueryRegistry,
)
from starrocks_tpu_torch.runtime.metrics import Counter, Gauge, MetricRegistry


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)


N_THREADS = 8
N_ITERS = 150


def _run_threads(fn, n=N_THREADS):
    errs = []

    def wrap(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001 — surfaced via the assert
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts), "stress thread wedged"
    assert errs == [], errs[:3]


# --- the witness itself --------------------------------------------------------

def test_witness_enabled_for_suite():
    assert lockdep.enabled()
    assert isinstance(Counter("t_w_enabled")._lock, lockdep.DebugLock)


def test_factories_plain_when_disabled():
    lockdep.disable()
    try:
        assert type(lockdep.lock("x")).__name__ == "lock"
        assert not isinstance(lockdep.rlock("x"), lockdep.DebugRLock)
    finally:
        lockdep.enable()


def test_seeded_inversion_reports_cycle_with_both_stacks():
    w = lockdep.Witness()  # private graph: the session gate stays clean
    a = lockdep.DebugLock("T.A", w)
    b = lockdep.DebugLock("T.B", w)
    order_ab = threading.Event()

    def t1():
        with a:
            with b:
                pass
        order_ab.set()

    def t2():
        order_ab.wait(5)
        with b:
            with a:
                pass

    th1 = threading.Thread(target=t1)
    th2 = threading.Thread(target=t2)
    th1.start()
    th2.start()
    th1.join(5)
    th2.join(5)
    cycles = w.order_cycles()
    assert cycles == [["T.A", "T.B"]]
    report = w.render(cycles)
    # both stacks: where the held lock was taken, and the acquirer's stack
    assert "T.A -> T.B" in report and "T.B -> T.A" in report
    assert "held at" in report and "acquired at" in report
    assert "test_torch_concurrency.py" in report


def test_one_way_nesting_no_cycle():
    w = lockdep.Witness()
    outer = lockdep.DebugLock("T.outer", w)
    inner = lockdep.DebugLock("T.inner", w)

    def worker(_i):
        for _ in range(50):
            with outer:
                with inner:
                    pass

    _run_threads(worker, n=4)
    assert w.order_cycles() == []
    assert ("T.outer", "T.inner") in w.edges()


def test_event_handoff_inversion_reports_cycle():
    """Seeded Event-handoff deadlock shape (the NEXT "witness coverage
    for threading.Event-based handoffs" item): thread 1 parks on the
    event while holding A — edge A -> E via before_block — and thread 2
    fires the event under A — edge E -> A via on_event_set. Neither run
    hangs (the wait has a timeout and the ordering is seeded), but the
    two edges close the waiter-holds-lock-the-setter-needs cycle."""
    w = lockdep.Witness()
    a = lockdep.DebugLock("T.A", w)
    done = lockdep.DebugEvent("T.done", w)
    waited = threading.Event()

    def waiter():
        with a:
            done.wait(0.05)   # parks holding A: records A -> T.done
        waited.set()

    def setter():
        waited.wait(5)        # seeded order: the wait edge lands first
        with a:
            done.set()        # fires under A: records T.done -> A

    th1 = threading.Thread(target=waiter)
    th2 = threading.Thread(target=setter)
    th1.start()
    th2.start()
    th1.join(5)
    th2.join(5)
    assert ["T.A", "T.done"] in w.order_cycles()
    edges = w.edges()
    assert ("T.A", "T.done") in edges and ("T.done", "T.A") in edges


def test_event_handoff_correct_order_no_cycle():
    """The serving-pool shape: the worker sets the done event holding no
    lock, the connection thread waits holding no lock — no edges at all,
    let alone a cycle."""
    w = lockdep.Witness()
    a = lockdep.DebugLock("T.A", w)
    done = lockdep.DebugEvent("T.done", w)
    with a:
        pass           # the lock is used, but never across the handoff
    done.set()
    assert done.wait(1)
    assert w.edges() == {} and w.order_cycles() == []


def test_event_factory_obeys_witness_toggle():
    assert isinstance(lockdep.event("t_ev"), lockdep.DebugEvent)
    lockdep.disable()
    try:
        ev = lockdep.event("t_ev_plain")
        assert not isinstance(ev, lockdep.DebugEvent)
        assert type(ev).__name__ == "Event"
    finally:
        lockdep.enable()


def test_self_deadlock_raises_instead_of_hanging():
    w = lockdep.Witness()
    mu = lockdep.DebugLock("T.mu", w)
    mu.acquire()
    try:
        with pytest.raises(lockdep.LockOrderError, match="self-deadlock"):
            mu.acquire()
    finally:
        mu.release()


def test_debug_rlock_is_reentrant_and_condition_capable():
    w = lockdep.Witness()
    rl = lockdep.DebugRLock("T.rl", w)
    with rl:
        with rl:
            assert rl._is_owned()
    assert not rl._is_owned()
    # Condition protocol: wait() must fully release (another thread can
    # acquire) and re-acquire on notify
    cond = threading.Condition(lockdep.DebugRLock("T.cond", w))
    ready = []

    def waiter():
        with cond:
            ready.append("waiting")
            cond.wait(timeout=10)
            ready.append("woken")

    t = threading.Thread(target=waiter)
    t.start()
    while "waiting" not in ready:
        pass
    with cond:  # acquirable only because wait() released the lock
        cond.notify_all()
    t.join(10)
    assert ready == ["waiting", "woken"]


# --- regression: the two pre-existing races ------------------------------------

def test_metric_registry_get_or_create_race():
    """runtime/metrics.py:26 (pre-fix): an unlocked setdefault minted
    divergent Counter instances under contention and constructed a
    throwaway per call. Every thread must get the SAME instance and no
    increment may be lost."""
    reg = MetricRegistry()
    instances = []
    mu = threading.Lock()

    def worker(_i):
        c = reg.counter("stress_total", "the contended one")
        with mu:
            instances.append(c)
        for _ in range(N_ITERS):
            c.inc()

    _run_threads(worker)
    assert len({id(c) for c in instances}) == 1
    assert reg.counter("stress_total").value == N_THREADS * N_ITERS
    # gauge twin, and kind is stable across get-or-create
    g = reg.gauge("stress_gauge")
    assert isinstance(g, Gauge) and reg.gauge("stress_gauge") is g


def test_last_kill_result_under_lock():
    """runtime/lifecycle.py (pre-fix): last_kill_result was mutated
    outside _lock. Now folded under it (and annotated guarded_by, which
    tools/concur_lint.py enforces): hammer cancels against a churning
    registry and read through the locked accessor."""
    reg = QueryRegistry()

    def worker(i):
        for k in range(N_ITERS):
            if i % 2 == 0:
                ctx = reg.register(QueryContext(f"select {i}"))
                reg.cancel(ctx.qid)
                reg.deregister(ctx)
            else:
                reg.cancel(10_000_000 + k)  # never-registered: no-op path
                assert reg.kill_result() in ("delivered", "not-running")

    _run_threads(worker)
    # the last writer is interleaving-dependent, but the value must be a
    # coherent one (never None/torn after thousands of cross-thread kills)
    assert reg.kill_result() in ("delivered", "not-running")
    assert reg.snapshot() == []

    ctx = reg.register(QueryContext("select 1"))
    assert reg.cancel(ctx.qid) is True
    assert reg.kill_result() == "delivered"


# --- the combined stress: registries + accountant + cache under DebugLock ------

class _FakeTable:
    """Minimal HostTable shape for cache byte accounting."""

    arrays: dict = {}
    valids: dict = {}
    schema = ()


class _FakeCatalog:
    def __init__(self):
        self._v = {}

    def bump(self, t):
        self._v[t] = self._v.get(t, 0) + 1

    def data_version(self, t):
        return self._v.get(t, 0)


def test_stress_registry_accountant_cache_balance_and_no_cycles():
    reg = QueryRegistry()
    acct = MemoryAccountant()
    cache = QueryCache()
    cat = _FakeCatalog()
    before = acct.snapshot()

    def worker(i):
        for k in range(N_ITERS):
            ctx = reg.register(QueryContext(f"select {i} /* {k} */",
                                            group=f"g{i % 3}"))
            try:
                acct.charge(ctx, 1024 * (1 + i), f"stage{k % 4}")
                acct.charge(ctx, 512, "merge")
                tbl = f"t{k % 5}"
                skey = (i % 4, k % 7)
                hit = cache.lookup_result(skey, cat)
                if hit is None:
                    cache.store_result(
                        skey, _FakeTable(), plan=None,
                        versions={tbl: cat.data_version(tbl)})
                cache.put_partial(("frag", i % 3), ("seg", k % 5),
                                  _FakeTable(), rows=10)
                cache.get_partial(("frag", i % 3), ("seg", k % 5))
                if k % 11 == 0:
                    cat.bump(tbl)
                    cache.invalidate_table(tbl)
                if k % 3 == 0:
                    reg.cancel(ctx.qid)
                reg.snapshot()
            finally:
                acct.release_query(ctx)
                reg.deregister(ctx)

    _run_threads(worker)
    after = acct.snapshot()
    assert after["process_bytes"] == before["process_bytes"] == 0
    assert after["group_bytes"] == {}
    assert reg.snapshot() == []
    # every lock in this path ran through DebugLock: the global order
    # graph must stay acyclic (the session-teardown gate re-asserts this
    # over the WHOLE suite's interleavings)
    assert lockdep.WITNESS.order_cycles() == []


def test_accountant_charge_is_atomic_under_contention():
    acct = MemoryAccountant()
    ctxs = [QueryContext(f"q{i}", group="g") for i in range(N_THREADS)]
    for i, c in enumerate(ctxs):
        c.qid = i + 1

    def worker(i):
        for _ in range(N_ITERS):
            acct.charge(ctxs[i], 100, "s")

    _run_threads(worker)
    snap = acct.snapshot()
    assert snap["process_bytes"] == N_THREADS * N_ITERS * 100
    assert snap["group_bytes"]["g"] == N_THREADS * N_ITERS * 100
    for c in ctxs:
        acct.release_query(c)
    assert acct.snapshot() == {"process_bytes": 0, "group_bytes": {}}
