"""Port counterpart of tests/test_serving.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). High-concurrency serving tier (runtime/serving.py + workgroup lanes).

Covers the round-12 serving contract:
- statement gate semantics (readers overlap, writers exclusive+preferred);
- the warm plan+result fast path answers repeated statements in ~sub-ms
  without parse/analyze/optimize/compile;
- 8-thread mixed workload over one tier: every result matches its oracle,
  and teardown leaks nothing (accountant bytes, admission slots, registry
  entries, pool queue) with an acyclic lock-witness graph;
- priority lanes: strict ordering under a saturated global queue, aging
  promotion of a starved low-priority waiter, and the preemption hint
  nudging the lowest-priority RUNNING query when a lane backs up;
- KILL of a queued AND a running query from a sibling MySQL connection;
- the MemoryAccountant's process ceiling consulting a real (injectable)
  RSS probe.
"""

import threading
import time

import pytest

from starrocks_tpu_torch.runtime import failpoint, lifecycle
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.lifecycle import ACCOUNTANT, REGISTRY
from starrocks_tpu_torch.runtime.serving import ServingTier, StatementGate
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.runtime.workgroup import WorkgroupManager


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)


def Session(*args, **kwargs):
    """The port's Session on the CPU (its entry points default to the
    card)."""
    kwargs.setdefault("device", "cpu")
    return _Session(*args, **kwargs)



def _mk_session(rows: int = 12) -> Session:
    s = Session()
    s.sql("create table t (a int, b int)")
    vals = ", ".join(f"({i}, {i % 3})" for i in range(1, rows + 1))
    s.sql(f"insert into t values {vals}")
    s.sql("create table u (k int, v int)")
    s.sql("insert into u values (0, 100), (1, 200), (2, 300)")
    return s


def _hold(site: str):
    """Arm failpoint `site` so that the first statement to reach it blocks
    there until released: (reached, release) events. The statement holds
    its admission slot or pool worker meanwhile, and a KILL delivered
    while it waits lands at the lifecycle checkpoint right after."""
    reached, release = threading.Event(), threading.Event()

    def action():
        reached.set()
        release.wait(30)

    failpoint.arm(site, action=action, times=1)
    return reached, release


@pytest.fixture
def qcache_on():
    prev = config.get("enable_query_cache")
    config.set("enable_query_cache", True)
    yield
    config.set("enable_query_cache", prev)


# --- statement gate -----------------------------------------------------------


def test_statement_gate_readers_overlap_writers_exclusive():
    g = StatementGate()
    assert g.try_shared()
    assert g.try_shared()  # readers stack
    entered = []

    def writer():
        with g.exclusive():
            entered.append("w")

    th = threading.Thread(target=writer)
    th.start()
    deadline = time.monotonic() + 5
    while not g._writers_waiting and time.monotonic() < deadline:
        time.sleep(0.005)
    # writer preference: a QUEUED writer bars new readers
    assert not g.try_shared()
    assert not entered  # two readers still inside
    g.release_shared()
    assert not entered
    g.release_shared()
    th.join(timeout=5)
    assert entered == ["w"]
    assert g.try_shared()  # gate reusable after the writer
    g.release_shared()


# --- warm fast path -----------------------------------------------------------


def test_warm_fast_path_skips_planning_and_answers_fast(qcache_on):
    from starrocks_tpu_torch.runtime.serving import SERVE_FAST_PATH

    s = _mk_session()
    tier = ServingTier(s, pool_size=2)
    try:
        sess = tier.new_session()
        q = "select b, sum(a) from t group by b order by b"
        exp = tier.execute(sess, q).rows()   # cold: analyze+optimize+compile
        tier.execute(sess, q)                # warms the result tier
        fp0 = SERVE_FAST_PATH.value
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            got = tier.execute(sess, q).rows()
            lat.append((time.perf_counter() - t0) * 1000)
            assert got == exp
        assert SERVE_FAST_PATH.value >= fp0 + 30  # all inline, no pool hop
        p50 = sorted(lat)[len(lat) // 2]
        # sub-ms on an idle box; 2ms bound absorbs CI scheduler noise
        assert p50 < 2.0, f"warm fast path p50 {p50:.3f}ms"
        # statement is invisible to parse/analyze: plan cache served it
        assert tier.cache.plan_cache.stats()["hits"] >= 30
    finally:
        tier.shutdown()


def test_fast_path_invalidated_by_dml_and_ddl(qcache_on):
    s = _mk_session()
    tier = ServingTier(s, pool_size=2)
    try:
        sess = tier.new_session()
        q = "select sum(a) from t"
        assert tier.execute(sess, q).rows() == [(78,)]
        tier.execute(sess, q)
        # DML through the tier takes the exclusive side and invalidates
        # the result tier; the NEXT read sees the new row
        tier.execute(sess, "insert into t values (100, 0)")
        assert tier.execute(sess, q).rows() == [(178,)]
        # DDL bumps the schema epoch: cached plans for the old shape drop
        tier.execute(sess, "alter table t add column c int")
        assert tier.execute(sess, "select sum(a) from t").rows() == [(178,)]
    finally:
        tier.shutdown()


# --- 8-thread mixed workload --------------------------------------------------


def test_8_thread_mixed_workload_oracle_and_zero_leaks(qcache_on):
    from starrocks_tpu_torch import lockdep

    s = _mk_session(rows=24)
    tier = ServingTier(s, pool_size=4)
    mem_before = ACCOUNTANT.snapshot()["process_bytes"]
    reg_before = len(REGISTRY.snapshot())
    queries = [
        "select b, sum(a) from t group by b order by b",
        "select count(*) from t",
        "select t.b, sum(u.v) from t join u on t.b = u.k "
        "group by t.b order by t.b",
        "select a from t where b = 1 order by a limit 3",
        "select max(a) - min(a) from t",
    ]
    try:
        oracle_sess = tier.new_session()
        expected = {q: tier.execute(oracle_sess, q).rows() for q in queries}
        errors: list = []

        def client(i: int):
            sess = tier.new_session()
            try:
                for k in range(10):
                    q = queries[(i + k) % len(queries)]
                    got = tier.execute(sess, q).rows()
                    if got != expected[q]:
                        errors.append((q, got, expected[q]))
            except Exception as e:  # noqa: BLE001 — surfaced via errors
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errors, errors[:3]

        # mixed phase: concurrent DML (exclusive) against reads (shared)
        def writer(i: int):
            sess = tier.new_session()
            try:
                for k in range(3):
                    tier.execute(
                        sess, f"insert into u values ({10 + i}, {i * k})")
                    tier.execute(sess, "select count(*) from t")
            except Exception as e:  # noqa: BLE001
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errors, errors[:3]
        n = tier.execute(oracle_sess, "select count(*) from u").rows()
        assert n == [(3 + 4 * 3,)]
    finally:
        tier.shutdown()
    # zero leaked bytes / slots / registry entries / queued work
    assert ACCOUNTANT.snapshot()["process_bytes"] == mem_before
    assert len(REGISTRY.snapshot()) == reg_before
    wm = getattr(s.catalog, "workgroups", None)
    if wm is not None:
        st = wm.queue_stats()
        assert st["running"] == 0 and st["queued"] == 0
    assert tier.pool.pending() == 0
    assert lockdep.WITNESS.order_cycles() == []


# --- priority lanes -----------------------------------------------------------


@pytest.fixture
def queue_knobs():
    prev = {k: config.get(k) for k in (
        "query_queue_concurrency", "query_queue_timeout_s",
        "query_queue_aging_s", "query_queue_preempt_hint_s")}
    yield
    for k, v in prev.items():
        config.set(k, v)


def _wait_queued(wm: WorkgroupManager, n: int, timeout: float = 5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if wm.queue_stats()["queued"] >= n:
            return
        time.sleep(0.005)
    raise AssertionError(f"never saw {n} queued waiters")


def test_priority_ordering_under_saturated_global_queue(queue_knobs):
    wm = WorkgroupManager()
    wm.create("lo", {"priority": 0})
    wm.create("hi", {"priority": 5})
    config.set("query_queue_concurrency", 1)
    config.set("query_queue_timeout_s", 10.0)
    config.set("query_queue_aging_s", 1000.0)   # ~strict priority
    config.set("query_queue_preempt_hint_s", 0.0)
    holder_release = wm.admit("lo")  # occupies the single global slot
    order: list = []

    def waiter(group: str):
        rel = wm.admit(group)
        order.append(group)
        rel()

    t_lo = threading.Thread(target=waiter, args=("lo",))
    t_lo.start()
    _wait_queued(wm, 1)
    t_hi = threading.Thread(target=waiter, args=("hi",))
    t_hi.start()
    _wait_queued(wm, 2)
    holder_release()
    t_lo.join(timeout=10)
    t_hi.join(timeout=10)
    # FIFO would admit lo first; priority lanes admit hi first
    assert order == ["hi", "lo"]
    st = wm.queue_stats()
    assert st["running"] == 0 and st["queued"] == 0
    assert st["admitted"] >= 3 and st["queue_wait_ms"] > 0


def test_aging_promotes_starved_low_priority_waiter(queue_knobs,
                                                   monkeypatch):
    from starrocks_tpu_torch.runtime import workgroup

    class _Clock:
        """The admission lanes' clock, moved forward by the test instead
        of by a sleep."""
        offset = 0.0

        def monotonic(self):
            return time.monotonic() + self.offset

    clock = _Clock()
    monkeypatch.setattr(workgroup, "time", clock)
    wm = WorkgroupManager()
    wm.create("lo", {"priority": 0})
    wm.create("hi", {"priority": 5})
    config.set("query_queue_concurrency", 1)
    config.set("query_queue_timeout_s", 10.0)
    config.set("query_queue_aging_s", 0.05)  # one priority step per 50ms
    config.set("query_queue_preempt_hint_s", 0.0)
    holder_release = wm.admit("hi")
    order: list = []

    def waiter(group: str):
        rel = wm.admit(group)
        order.append(group)
        rel()

    t_lo = threading.Thread(target=waiter, args=("lo",))
    t_lo.start()
    _wait_queued(wm, 1)
    clock.offset += 0.6  # lo ages ~12 steps — now outbids a fresh priority-5
    t_hi = threading.Thread(target=waiter, args=("hi",))
    t_hi.start()
    _wait_queued(wm, 2)
    holder_release()
    t_lo.join(timeout=10)
    t_hi.join(timeout=10)
    assert order[0] == "lo"  # aging beat the fresh high-priority arrival


def test_preempt_hint_nudges_lowest_priority_running(queue_knobs):
    wm = WorkgroupManager()
    wm.create("g", {"concurrency_limit": 1, "priority": 0})
    config.set("query_queue_concurrency", 0)
    config.set("query_queue_timeout_s", 10.0)
    config.set("query_queue_preempt_hint_s", 0.05)
    victim_ctx: list = []
    release_evt = threading.Event()

    def running_query():
        with lifecycle.query_scope("select slow", group="g") as ctx:
            victim_ctx.append(ctx)
            rel = wm.admit("g")
            release_evt.wait(timeout=10)
            rel()

    th = threading.Thread(target=running_query)
    th.start()
    deadline = time.monotonic() + 5
    while not victim_ctx and time.monotonic() < deadline:
        time.sleep(0.005)
    while wm.queue_stats()["running"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)

    def queued_query():
        with lifecycle.query_scope("select queued", group="g"):
            rel = wm.admit("g")
            rel()

    t2 = threading.Thread(target=queued_query)
    t2.start()
    # the backed-up lane must nudge the running victim within ~hint_s
    deadline = time.monotonic() + 5
    while not victim_ctx[0].degraded and time.monotonic() < deadline:
        time.sleep(0.01)
    assert victim_ctx[0].degraded
    assert "preemption hint" in victim_ctx[0].degrade_reason
    release_evt.set()
    th.join(timeout=10)
    t2.join(timeout=10)
    st = wm.queue_stats()
    assert st["running"] == 0 and st["queued"] == 0


# --- KILL from a sibling connection ------------------------------------------


def test_kill_queued_and_running_from_sibling_connection(queue_knobs):
    from chip_smoke import MySQLClient

    from starrocks_tpu_torch.runtime.mysql_service import MySQLServer

    s = _mk_session()
    # A holds at the dispatch failpoint (with its global admission slot)
    # until the test releases it — no sleeping UDF
    reached, release = _hold("executor::before_dispatch")
    config.set("query_queue_concurrency", 1)  # victim B queues behind A
    config.set("query_queue_timeout_s", 30.0)
    srv = MySQLServer(s, port=0).start()
    try:
        a = MySQLClient(srv.port)
        b = MySQLClient(srv.port)
        c = MySQLClient(srv.port)
        results: dict = {}

        def run(tag, client):
            try:
                results[tag] = client.query(
                    "select max(a) from t where b >= 0")
            except RuntimeError as e:
                results[tag + "_err"] = str(e)

        ta = threading.Thread(target=run, args=("a", a))
        ta.start()
        # wait until A is RUNNING (holds the global slot)
        qid_a = qid_b = None
        deadline = time.monotonic() + 10
        assert reached.wait(10)
        _, rows = c.query("show processlist")
        live = [r for r in rows if "max(a)" in r[-1]]
        qid_a = int(live[0][0]) if live else None
        assert qid_a is not None
        tb = threading.Thread(target=run, args=("b", b))
        tb.start()
        # wait until B is QUEUED at admission (stage workgroup::queued)
        while qid_b is None and time.monotonic() < deadline:
            _, rows = c.query("show processlist")
            queued = [r for r in rows
                      if "max(a)" in r[-1] and int(r[0]) != qid_a
                      and r[-2] == "workgroup::queued"]
            if queued:
                qid_b = int(queued[0][0])
            time.sleep(0.01)
        assert qid_b is not None, "second query never queued at admission"
        # kill the QUEUED query: it unblocks from the admission wait
        c.query(f"kill query {qid_b}")
        tb.join(timeout=10)
        assert not tb.is_alive()
        assert "QueryCancelledError" in results.get("b_err", "")
        # kill the RUNNING query: it dies at its next stage boundary, the
        # checkpoint right after the failpoint it is held at
        c.query(f"kill query {qid_a}")
        release.set()
        ta.join(timeout=20)
        assert not ta.is_alive()
        assert "QueryCancelledError" in results.get("a_err", ""), results
        # sibling connection and engine survive: next query is correct
        _, rows = c.query("select count(*) from t")
        assert rows == [("12",)]
        st = s.workgroups().queue_stats()
        assert st["running"] == 0 and st["queued"] == 0
    finally:
        release.set()
        failpoint.disarm("executor::before_dispatch")
        srv.shutdown()


# --- RSS probe (NEXT 7c) ------------------------------------------------------


def test_rss_probe_enforces_process_ceiling():
    acct = lifecycle.MemoryAccountant(rss_reader=lambda: 123_000_000)
    config.set("process_mem_limit_bytes", 1_000_000)
    try:
        ctx = lifecycle.QueryContext("select 1")
        ctx.qid = 7
        with pytest.raises(lifecycle.MemLimitExceeded, match="bytes RSS"):
            acct.charge(ctx, 10, "stage::x")
    finally:
        config.set("process_mem_limit_bytes", 0)
        acct.release_query(ctx)
    assert acct.snapshot()["process_bytes"] == 0


def test_rss_probe_caches_between_intervals_and_accounted_still_wins():
    calls = []

    def reader():
        calls.append(1)
        return 50

    acct = lifecycle.MemoryAccountant(rss_reader=reader)
    assert acct.rss_bytes() == 50
    assert acct.rss_bytes() == 50
    assert len(calls) == 1  # cached within RSS_PROBE_INTERVAL_S
    # accounted bytes over the limit still fail even with a tiny RSS
    config.set("process_mem_limit_bytes", 1_000)
    try:
        ctx = lifecycle.QueryContext("select 1")
        ctx.qid = 8
        with pytest.raises(lifecycle.MemLimitExceeded):
            acct.charge(ctx, 2_000, "stage::y")
    finally:
        config.set("process_mem_limit_bytes", 0)
        acct.release_query(ctx)


def test_real_statm_reader_reports_positive_rss():
    assert lifecycle._read_statm_rss() > 0


# --- KILL of a POOL-queued statement (NEXT 7f) --------------------------------


def test_pool_queued_statement_is_registered_and_killable():
    """A statement waiting for an executor-pool slot (every worker busy)
    must already be visible at stage serve::queued and die on KILL
    without ever reaching a worker."""
    s = _mk_session()
    # A holds the single worker at the dispatch failpoint until released
    reached, release = _hold("executor::before_dispatch")
    reg_before = len(REGISTRY.snapshot())
    tier = ServingTier(s, pool_size=1)
    try:
        results: dict = {}

        def run(tag, sql):
            sess = tier.new_session()
            try:
                results[tag] = tier.execute(sess, sql)
            except BaseException as e:  # noqa: BLE001 — recorded for asserts
                results[tag + "_err"] = e

        ta = threading.Thread(
            target=run, args=("a", "select max(a) from t"))
        ta.start()
        # A occupies the single worker (held past the queued stage)
        assert reached.wait(10)
        deadline = time.monotonic() + 10
        tb = threading.Thread(
            target=run, args=("b", "select min(b) from t"))
        tb.start()
        # B must appear in PROCESSLIST at stage serve::queued while it
        # waits for the (saturated) pool — the round-13 gap: it was
        # invisible and unkillable until a worker picked it up
        qid_b = None
        while qid_b is None and time.monotonic() < deadline:
            queued = [r for r in REGISTRY.snapshot()
                      if "min(b)" in r[-1]
                      and r[-2] == "serve::queued"]
            if queued:
                qid_b = queued[0][0]
            time.sleep(0.005)
        assert qid_b is not None, "pool-queued statement never registered"
        assert REGISTRY.cancel(qid_b) is True
        assert REGISTRY.kill_result() == "delivered"
        tb.join(timeout=10)
        assert not tb.is_alive()
        err = results.get("b_err")
        assert isinstance(err, lifecycle.QueryCancelledError), err
        release.set()
        ta.join(timeout=10)
        assert not ta.is_alive()
        assert "a" in results  # the running statement finishes untouched
        # unwind is complete: no registry entries, no queue leftovers
        assert len(REGISTRY.snapshot()) == reg_before
        assert tier.pool.pending() == 0
    finally:
        release.set()
        failpoint.disarm("executor::before_dispatch")
        tier.shutdown()
