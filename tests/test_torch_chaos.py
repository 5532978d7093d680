"""Port counterpart of tests/test_chaos.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). Failpoint-driven chaos suite for the query lifecycle manager.

Every scenario injects a fault (raise at a named failpoint, KILL
mid-stage, deadline mid-spill, memory limit mid-join) and asserts the
lifecycle contract (runtime/lifecycle.py):

1. the query fails CLEANLY with a typed error;
2. the NEXT query on the same session returns oracle-correct results;
3. nothing leaked: admission slots back to zero, the TabletStore journal
   lock acquirable, the memory accountant's before/after snapshots
   identical, and no stray query-cache bytes.

Reference behavior: StarRocks' failpoint-scripted SQL regression suites
(be/src/base/failpoint/fail_point.h) + the kill/timeout paths of
qe/ConnectContext and the BE fragment cancellation plane.
"""

import threading
import time

import pytest

from starrocks_tpu_torch.runtime import failpoint, lifecycle
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.failpoint import FailPointError
from starrocks_tpu_torch.runtime.lifecycle import (
    ACCOUNTANT, REGISTRY, MemLimitExceeded, QueryCancelledError,
    QueryTimeoutError,
)
from starrocks_tpu_torch.runtime.session import Session as _Session


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


pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _reset_lifecycle_knobs():
    """Every scenario leaves the process exactly as it found it."""
    yield
    config.set("query_timeout_s", 0.0)
    config.set("query_mem_limit_bytes", 0)
    config.set("query_mem_soft_limit_bytes", 0)
    config.set("process_mem_limit_bytes", 0)
    config.set("batch_rows_threshold", 0)
    config.set("spill_batch_rows", 0)
    config.set("enable_query_cache", False)


def _advance(dt: float):
    """A failpoint action: the running query's clock moves `dt` seconds
    forward (its start and its deadline move back), so a deadline passes
    without the test sleeping."""
    def action():
        ctx = lifecycle.current()
        ctx.t0 -= dt
        if ctx.deadline is not None:
            ctx.deadline -= dt
    return action


def _hold():
    """A failpoint action that blocks the first statement to reach it
    until released, and the (action, reached, release) triple: a KILL
    delivered meanwhile lands at the lifecycle checkpoint right after the
    failpoint."""
    reached, release = threading.Event(), threading.Event()

    def action():
        if not reached.is_set():
            reached.set()
            release.wait(30)

    return action, reached, release


def _mk_session(rows: int = 8) -> Session:
    s = Session()
    s.sql("create table t (a int, b int)")
    vals = ", ".join(f"({i}, {i % 3})" for i in range(1, rows + 1))
    s.sql(f"insert into t values {vals}")
    return s


def _leak_snapshot(s: Session) -> dict:
    wm = getattr(s.catalog, "workgroups", None)
    return {
        "process_bytes": ACCOUNTANT.snapshot()["process_bytes"],
        "slots": sum(wm.running.values()) if wm is not None else 0,
        "qcache_bytes": s.cache.qcache.resident_bytes,
        "registry": len(REGISTRY.snapshot()),
    }


def _assert_clean(s: Session, before: dict):
    assert _leak_snapshot(s) == before
    if s.store is not None:
        assert s.store._journal_lock.acquire(blocking=False), \
            "journal lock leaked"
        s.store._journal_lock.release()


def _probe_correct(s: Session, rows: int = 8):
    """Oracle check for the standard fixture table."""
    got = s.sql("select b, sum(a) from t group by b order by b").rows()
    exp = {}
    for i in range(1, rows + 1):
        exp[i % 3] = exp.get(i % 3, 0) + i
    assert got == sorted(exp.items())


# --- 1..5: injected raise at every executor-stage family ---------------------


@pytest.mark.parametrize("site", [
    "executor::before_run",
    "executor::before_compile",
    "executor::before_dispatch",
    "executor::fetch_results",
    "scan::chunk_to_device",
])
def test_raise_at_stage_fails_clean_and_next_query_correct(site):
    s = _mk_session()
    before = _leak_snapshot(s)
    with failpoint.scoped(site):
        with pytest.raises(FailPointError, match=site):
            s.sql("select b, sum(a) from t group by b")
    _assert_clean(s, before)
    _probe_correct(s)


# --- 6: raise inside the spill/batched loop ----------------------------------


def test_raise_mid_spill_batch_loop():
    s = _mk_session(rows=64)
    config.set("batch_rows_threshold", 16)
    before = _leak_snapshot(s)
    with failpoint.scoped("spill::batch_loop"):
        with pytest.raises(FailPointError):
            s.sql("select b, sum(a) from t group by b")
    _assert_clean(s, before)
    config.set("batch_rows_threshold", 0)
    _probe_correct(s, rows=64)


# --- 7: journal-write fault leaves the lock free and the store serving -------


def test_journal_write_fault_releases_lock(tmp_path):
    s = Session(data_dir=str(tmp_path / "db"))
    s.sql("create table t (a int, b int)")
    s.sql("insert into t values (1, 0), (2, 1)")
    before = _leak_snapshot(s)
    with failpoint.scoped("journal::write"):
        with pytest.raises(FailPointError):
            s.sql("insert into t values (3, 2)")
    _assert_clean(s, before)
    # the journal lock is free and the session immediately reusable
    s.sql("insert into t values (4, 0)")
    got = s.sql("select sum(a) from t").rows()
    assert got[0][0] in (7, 10)  # the faulted row may or may not have landed
    # whatever landed, the store must be internally consistent on replay
    s2 = Session(data_dir=str(tmp_path / "db"))
    assert s2.sql("select sum(a) from t").rows() == got


# --- 8: cache-store fault with the query cache enabled -----------------------


def test_qcache_store_fault_leaks_no_bytes():
    s = _mk_session()
    config.set("enable_query_cache", True)
    before = _leak_snapshot(s)
    with failpoint.scoped("qcache::store_result"):
        with pytest.raises(FailPointError):
            s.sql("select b, sum(a) from t group by b")
    _assert_clean(s, before)
    _probe_correct(s)


# --- 9: KILL mid-stage (cooperative cancellation) ----------------------------


def test_kill_mid_stage_unwinds_and_session_reusable():
    s = _mk_session()

    def kill_current():
        ctx = lifecycle.current()
        assert ctx is not None
        REGISTRY.cancel(ctx.qid, requester="root", admin=True)

    before = _leak_snapshot(s)
    with failpoint.scoped("executor::before_dispatch", action=kill_current):
        with pytest.raises(QueryCancelledError, match="cancelled at stage"):
            s.sql("select b, sum(a) from t group by b")
    _assert_clean(s, before)
    _probe_correct(s)


# --- 10: KILL landing after the last checkpoint is a documented no-op --------


def test_kill_race_after_last_checkpoint_is_noop():
    s = _mk_session()
    killed = []

    def late_kill():
        ctx = lifecycle.current()
        killed.append(REGISTRY.cancel(ctx.qid, requester="root", admin=True))

    # executor::result_ready sits AFTER the final checkpoint by design: a
    # kill delivered there finds a query with no checkpoints left, so the
    # query completes and the kill is a no-op (the documented race result)
    with failpoint.scoped("executor::result_ready", action=late_kill):
        got = s.sql("select sum(a) from t").rows()
    assert killed == [True]  # delivered...
    assert got == [(36,)]    # ...but the query completed normally
    # and a later kill of the finished id reports not-running
    assert s.sql("kill query 999999").endswith("KILL is a no-op")


# --- 11: deadline firing mid-spill -------------------------------------------


def test_deadline_mid_spill_raises_timeout():
    s = _mk_session(rows=64)
    config.set("batch_rows_threshold", 16)
    config.set("query_timeout_s", 0.05)
    before = _leak_snapshot(s)
    with failpoint.scoped("spill::batch_loop",
                          action=_advance(0.06)):
        with pytest.raises(QueryTimeoutError, match="query_timeout_s"):
            s.sql("select b, sum(a) from t group by b")
    _assert_clean(s, before)
    config.set("query_timeout_s", 0.0)
    config.set("batch_rows_threshold", 0)
    _probe_correct(s, rows=64)


# --- 12: hard memory limit mid-grace-join ------------------------------------


def test_mem_limit_mid_grace_join_names_stage():
    s = Session()
    s.sql("create table l (k int, v int)")
    s.sql("create table r (k int, w int)")
    lv = ", ".join(f"({i % 7}, {i})" for i in range(200))
    rv = ", ".join(f"({i % 7}, {i * 2})" for i in range(200))
    s.sql(f"insert into l values {lv}")
    s.sql(f"insert into r values {rv}")
    config.set("batch_rows_threshold", 50)  # force the Grace join path
    exp = s.sql("select sum(l.v + r.w) from l, r where l.k = r.k").rows()
    config.set("query_mem_limit_bytes", 1)  # any charge breaks it
    before = _leak_snapshot(s)
    with pytest.raises(MemLimitExceeded) as ei:
        s.sql("select sum(l.v + r.w) from l, r where l.k = r.k")
    assert "at stage" in str(ei.value)  # names the offending stage
    _assert_clean(s, before)
    config.set("query_mem_limit_bytes", 0)
    assert s.sql(
        "select sum(l.v + r.w) from l, r where l.k = r.k").rows() == exp


# --- 13: deadline inside the per-segment partial-agg cache path --------------


def test_deadline_in_partial_cache_admits_no_partial_entries(tmp_path):
    s = Session(data_dir=str(tmp_path / "db"))
    s.sql("create table seg (a int, b int)")
    # two inserts -> two manifest segments, so the partial tier iterates
    s.sql("insert into seg values " + ", ".join(
        f"({i}, {i % 4})" for i in range(40)))
    s.sql("insert into seg values " + ", ".join(
        f"({i}, {i % 4})" for i in range(40, 80)))
    config.set("enable_query_cache", True)
    before = _leak_snapshot(s)
    config.set("query_timeout_s", 0.05)
    with failpoint.scoped("qcache::partial_segment",
                          action=_advance(0.06)):
        with pytest.raises(QueryTimeoutError):
            s.sql("select b, sum(a) from seg group by b")
    # deferred LRU admission: the aborted attempt left NO partial entries
    assert not [k for k in s.cache.qcache._entries if k[0] == "p"]
    _assert_clean(s, before)
    config.set("query_timeout_s", 0.0)
    got = s.sql("select b, sum(a) from seg group by b order by b").rows()
    exp = {}
    for i in range(80):
        exp[i % 4] = exp.get(i % 4, 0) + i
    assert got == sorted(exp.items())
    # and the healthy rerun DID populate the partial tier
    assert [k for k in s.cache.qcache._entries if k[0] == "p"]


# --- 14: admission-slot release is exception-safe (the leak regression) ------


def test_admission_slot_released_when_query_raises_after_admission():
    s = _mk_session()
    s.sql("create resource group rg_one with (concurrency_limit = 1)")
    s.sql("set resource_group = 'rg_one'")
    wm = s.workgroups()
    before_timeouts = wm.timeout_total
    with failpoint.scoped("executor::before_run"):
        with pytest.raises(FailPointError):
            s.sql("select sum(a) from t")
    assert wm.running.get("rg_one", 0) == 0, "admission slot leaked"
    # the single slot is immediately reusable — no queue timeout
    t0 = time.monotonic()
    _probe_correct(s)
    assert time.monotonic() - t0 < 5.0
    assert wm.timeout_total == before_timeouts
    s.sql("set resource_group = ''")
    s.sql("drop resource group rg_one")


# --- 15: KILL unblocks a query QUEUED on admission ---------------------------


def test_kill_unblocks_admission_queue():
    s = _mk_session()
    s.sql("create resource group rg_q with (concurrency_limit = 1)")
    config.set("query_queue_timeout_s", 30.0)
    wm = s.workgroups()
    hold_release = wm.admit("rg_q")  # occupy the only slot out-of-band
    try:
        errors, started = [], threading.Event()
        blocked = Session(s.catalog)
        blocked.sql("set resource_group = 'rg_q'")

        def run_blocked():
            started.set()
            try:
                blocked.sql("select count(*) from t")
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        th = threading.Thread(target=run_blocked)
        th.start()
        started.wait()
        # find the queued query and kill it: it must unblock well before
        # the 30s queue timeout
        deadline = time.monotonic() + 5
        qid = None
        while qid is None and time.monotonic() < deadline:
            snap = [r for r in REGISTRY.snapshot() if "count(*)" in r[7]]
            if snap:
                qid = snap[0][0]
            time.sleep(0.01)
        assert qid is not None
        REGISTRY.cancel(qid, requester="root", admin=True)
        th.join(timeout=5)
        assert not th.is_alive()
        assert errors and isinstance(errors[0], QueryCancelledError)
    finally:
        hold_release()
        config.set("query_queue_timeout_s", 10.0)
        s.sql("drop resource group rg_q")


# --- 16: soft memory limit degrades instead of failing -----------------------


def test_soft_limit_degrades_declines_cache_admission():
    s = _mk_session()
    config.set("enable_query_cache", True)
    config.set("query_mem_soft_limit_bytes", 1)  # degrade on first charge
    got = s.sql("select b, sum(a) from t group by b order by b").rows()
    assert got  # the query SUCCEEDS (soft limit never fails a query)
    # ...but declined full-result cache admission under memory pressure
    assert not [k for k in s.cache.qcache._entries if k[0] == "r"]
    assert s.cache.qcache.resident_bytes == 0
    config.set("query_mem_soft_limit_bytes", 0)
    # without pressure the same query is admitted
    s.sql("select b, sum(a) from t group by b order by b")
    assert [k for k in s.cache.qcache._entries if k[0] == "r"]


# --- 17: KILL QUERY over the live MySQL wire ---------------------------------


def test_kill_query_over_mysql_service_interrupts_within_one_stage():
    from chip_smoke import MySQLClient

    from starrocks_tpu_torch.runtime.mysql_service import MySQLServer

    s = _mk_session(rows=64)
    config.set("batch_rows_threshold", 8)  # multi-stage: 8 spill batches
    srv = MySQLServer(s, port=0).start()
    try:
        a = MySQLClient(srv.port)
        b = MySQLClient(srv.port)
        result = {}

        def run_victim():
            try:
                result["rows"] = a.query("select b, sum(a) from t group by b")
            except RuntimeError as e:
                result["err"] = str(e)

        # the victim is held at its first spill batch; the kill from
        # connection B lands mid-stream and takes effect at that batch's
        # boundary, before the next batch runs
        hold, reached, release = _hold()
        with failpoint.scoped("spill::batch_loop", action=hold):
            th = threading.Thread(target=run_victim)
            th.start()
            assert reached.wait(10), "victim query never reached a batch"
            cols, rows = b.query("show processlist")
            live = [r for r in rows if "group by" in r[-1]]
            qid = int(live[0][0]) if live else None
            assert qid is not None, "victim query never appeared"
            t_kill = time.monotonic()
            b.query(f"kill query {qid}")
            release.set()
            th.join(timeout=10)
            assert not th.is_alive()
        assert "err" in result, f"expected kill, got {result}"
        assert "QueryCancelledError" in result["err"]
        # interrupted within ~one stage boundary, not after the full query
        assert time.monotonic() - t_kill < 2.0
        # the connection and session survive: next query is correct
        cols, rows = a.query("select sum(a) from t")
        assert rows == [(str(sum(range(1, 65))),)]
    finally:
        srv.shutdown()
        config.set("batch_rows_threshold", 0)


# --- 18: POST /api/query/{id}/cancel over the HTTP service -------------------


def test_http_cancel_endpoint():
    import http.client
    import json as _json

    from starrocks_tpu_torch.runtime.http_service import SqlHttpServer

    s = _mk_session(rows=64)
    srv = SqlHttpServer(s).start()
    try:
        # unknown id: documented no-op
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.request("POST", "/api/query/999999/cancel")
        resp = _json.loads(conn.getresponse().read())
        assert resp["cancelled"] is False
        # live query (driven directly on the shared session from a worker
        # thread; the registry is process-wide so HTTP sees it)
        config.set("batch_rows_threshold", 8)
        errors = []

        def victim():
            try:
                s.sql("select b, sum(a) from t group by b")
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        hold, reached, release = _hold()
        with failpoint.scoped("spill::batch_loop", action=hold):
            th = threading.Thread(target=victim)
            th.start()
            assert reached.wait(10)
            qid = None
            conn = http.client.HTTPConnection(
                "127.0.0.1", srv.port, timeout=10)
            conn.request("GET", "/api/queries")
            for row in _json.loads(conn.getresponse().read()):
                if "group by" in row["sql"]:
                    qid = row["id"]
            assert qid is not None
            conn = http.client.HTTPConnection(
                "127.0.0.1", srv.port, timeout=10)
            conn.request("POST", f"/api/query/{qid}/cancel")
            assert _json.loads(conn.getresponse().read())["cancelled"] is True
            release.set()
            th.join(timeout=10)
        assert errors and isinstance(errors[0], QueryCancelledError)
        _probe_correct(s, rows=64)
    finally:
        srv.stop()
        config.set("batch_rows_threshold", 0)


# --- 19: the TPC-H q1 acceptance pair: timeout, then oracle-correct rerun ----


def test_tpch_q1_timeout_then_correct_rerun():
    """Q1 past a 10 ms deadline (its clock moved 20 ms at dispatch) fails
    clean; the rerun equals the JAX package's rows."""
    from starrocks_tpu.runtime.session import Session as JSession
    from starrocks_tpu.storage.catalog import tpch_catalog as jax_catalog

    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.tpch_queries import QUERIES
    from torch_tpch_parity import rows_match

    cat = tpch_catalog(sf=0.01)
    s = Session(cat)
    before = _leak_snapshot(s)
    s.sql("set query_timeout_s = 0.01")
    with failpoint.scoped("executor::before_dispatch",
                          action=_advance(0.02)):
        with pytest.raises(QueryTimeoutError):
            s.sql(QUERIES[1])
    _assert_clean(s, before)
    s.sql("set query_timeout_s = 0")
    got = s.sql(QUERIES[1]).rows()
    want = JSession(jax_catalog(sf=0.01)).sql(QUERIES[1]).rows()
    assert rows_match(got, want)


# --- 20: ADMIN SET failpoint surface + information_schema accounting ---------


def test_admin_set_failpoint_times_and_introspection():
    s = _mk_session()
    s.sql("admin set failpoint 'executor::before_run' = 'enable:times=2'")
    for _ in range(2):
        with pytest.raises(FailPointError):
            s.sql("select count(*) from t")
    # times exhausted: the third run passes
    assert s.sql("select count(*) from t").rows() == [(8,)]
    rows = dict(
        (r[0], (r[1], r[3])) for r in s.sql(
            "select name, armed, times_remaining, hits "
            "from information_schema.fail_points").rows()
        if r[0] == "executor::before_run")
    armed, hits = rows["executor::before_run"]
    assert armed == 1 and hits >= 3
    s.sql("admin set failpoint 'executor::before_run' = 'disable'")
    with pytest.raises(ValueError, match="unknown failpoint action"):
        s.sql("admin set failpoint 'x' = 'frobnicate'")


# --- 21: non-admin users cannot kill other users' queries --------------------


def test_kill_permissions():
    s = _mk_session()
    s.sql("create user 'bob' identified by 'pw'")
    s.sql("grant select on t to 'bob'")
    seen = {}

    def cross_kill():
        ctx = lifecycle.current()
        try:
            REGISTRY.cancel(ctx.qid, requester="bob", admin=False)
        except PermissionError as e:
            seen["err"] = str(e)
        # owner (or admin) succeeds where the stranger failed
        seen["own"] = REGISTRY.cancel(ctx.qid, requester="root", admin=False)

    with failpoint.scoped("executor::before_dispatch", action=cross_kill):
        with pytest.raises(QueryCancelledError):
            s.sql("select b, sum(a) from t group by b")
    assert "cannot kill" in seen["err"] and seen["own"] is True
    _probe_correct(s)


# --- 22: hybrid skew-aware join — zero leaked spill partitions on unwind -----


def _mk_skew_join_session(rows: int = 400) -> Session:
    """Two join tables sized past a 50-row threshold, the build side
    carrying one heavy-hitter key (half its rows), so the hybrid executor
    runs all three lanes: broadcast, resident, and spilled partitions."""
    s = Session()
    s.sql("create table jl (k int, v int)")
    s.sql("create table jr (k int, w int)")
    # jr is the SMALLER relation (so the optimizer keeps it on the build
    # side); hot key 1 owns half of it, cold keys appear ~2x each (below
    # the 50-row-batch skew threshold), spread over several partitions
    lv = ", ".join(f"({i % 101}, {i})" for i in range(2 * rows))
    rv = ", ".join(f"({1 if i % 2 else i % 101}, {i})" for i in range(rows))
    s.sql(f"insert into jl values {lv}")
    s.sql(f"insert into jr values {rv}")
    return s


_Q_HYBRID = "select sum(jl.v + jr.w) from jl, jr where jl.k = jr.k"


def _join_counters(s: Session) -> dict:
    out = {}

    def walk(p):
        out.update({k: v for k, (v, _) in p.counters.items()})
        for c in p.children:
            walk(c)

    walk(s.last_profile)
    return out


def test_hybrid_spill_fault_leaks_no_partitions():
    from starrocks_tpu_torch.runtime import batched

    s = _mk_skew_join_session()
    config.set("batch_rows_threshold", 50)
    exp = s.sql(_Q_HYBRID).rows()
    cs = _join_counters(s)
    assert cs.get("join_skew_keys", 0) >= 1, cs       # the lane under test
    assert cs.get("join_spilled_partitions", 0) >= 1, cs
    before = _leak_snapshot(s)
    with failpoint.scoped("hybrid::spill_partition"):
        with pytest.raises(FailPointError):
            s.sql(_Q_HYBRID)
    # the unwind released every materialized-but-unconsumed partition
    assert batched.SPILL_PARTS_LIVE.value == 0
    _assert_clean(s, before)
    assert s.sql(_Q_HYBRID).rows() == exp


def test_hybrid_kill_mid_broadcast_lane_unwinds_clean():
    from starrocks_tpu_torch.runtime import batched

    s = _mk_skew_join_session()
    config.set("batch_rows_threshold", 50)
    exp = s.sql(_Q_HYBRID).rows()

    def kill_current():
        ctx = lifecycle.current()
        assert ctx is not None
        REGISTRY.cancel(ctx.qid, requester="root", admin=True)

    before = _leak_snapshot(s)
    with failpoint.scoped("hybrid::broadcast_lane", action=kill_current):
        with pytest.raises(QueryCancelledError, match="cancelled at stage"):
            s.sql(_Q_HYBRID)
    assert batched.SPILL_PARTS_LIVE.value == 0
    _assert_clean(s, before)
    assert s.sql(_Q_HYBRID).rows() == exp


def test_hybrid_deadline_mid_spill_partition():
    from starrocks_tpu_torch.runtime import batched

    s = _mk_skew_join_session()
    config.set("batch_rows_threshold", 50)
    exp = s.sql(_Q_HYBRID).rows()
    config.set("query_timeout_s", 0.05)
    before = _leak_snapshot(s)
    with failpoint.scoped("hybrid::spill_partition",
                          action=_advance(0.06)):
        with pytest.raises(QueryTimeoutError, match="query_timeout_s"):
            s.sql(_Q_HYBRID)
    assert batched.SPILL_PARTS_LIVE.value == 0
    _assert_clean(s, before)
    config.set("query_timeout_s", 0.0)
    assert s.sql(_Q_HYBRID).rows() == exp


def test_hybrid_mem_hard_limit_names_stage_and_frees_partitions():
    from starrocks_tpu_torch.runtime import batched

    s = _mk_skew_join_session()
    config.set("batch_rows_threshold", 50)
    exp = s.sql(_Q_HYBRID).rows()
    config.set("query_mem_limit_bytes", 1)  # any charge breaks it
    before = _leak_snapshot(s)
    with pytest.raises(MemLimitExceeded) as ei:
        s.sql(_Q_HYBRID)
    assert "at stage" in str(ei.value)
    assert batched.SPILL_PARTS_LIVE.value == 0
    _assert_clean(s, before)
    config.set("query_mem_limit_bytes", 0)
    assert s.sql(_Q_HYBRID).rows() == exp


# --- audit-log terminal records under chaos (observability plane) ------------
#
# The audit contract (runtime/audit.py): EVERY terminal state leaves
# exactly ONE record, registered at the same unwind hook that releases
# slots/bytes — so a chaos kill that leaks nothing must still be fully
# accounted for in the flight recorder.


def _audit_records_for(qid: int) -> list:
    from starrocks_tpu_torch.runtime.audit import AUDIT

    return [r for r in AUDIT.snapshot() if r["query_id"] == qid]


def test_killed_query_leaves_exactly_one_audit_record():
    s = _mk_session()
    seen = []

    def kill_current():
        ctx = lifecycle.current()
        seen.append(ctx.qid)
        REGISTRY.cancel(ctx.qid, requester="root", admin=True)

    before = _leak_snapshot(s)
    with failpoint.scoped("executor::before_dispatch", action=kill_current):
        with pytest.raises(QueryCancelledError):
            s.sql("select b, sum(a) from t group by b")
    recs = _audit_records_for(seen[0])
    assert len(recs) == 1
    assert recs[0]["state"] == "cancelled"
    assert recs[0]["error"]  # the kill reason rides the record
    assert recs[0]["stage"]  # ... and the stage it landed in
    _assert_clean(s, before)
    _probe_correct(s)


def test_timed_out_query_leaves_exactly_one_audit_record():
    from starrocks_tpu_torch.runtime.audit import AUDIT

    s = _mk_session(rows=64)
    config.set("batch_rows_threshold", 16)
    config.set("query_timeout_s", 0.05)
    before = _leak_snapshot(s)
    n0 = AUDIT.stats()["registered"]
    with failpoint.scoped("spill::batch_loop",
                          action=_advance(0.06)):
        with pytest.raises(QueryTimeoutError):
            s.sql("select b, sum(a) from t group by b")
    assert AUDIT.stats()["registered"] - n0 == 1
    rec = AUDIT.snapshot()[-1]
    assert rec["state"] == "timeout"
    assert "query_timeout_s" in rec["error"]
    assert rec["ms"] >= 50
    _assert_clean(s, before)
    config.set("query_timeout_s", 0.0)
    config.set("batch_rows_threshold", 0)
    _probe_correct(s, rows=64)


def test_failpoint_failed_query_leaves_exactly_one_audit_record():
    s = _mk_session()
    seen = []
    before = _leak_snapshot(s)

    def note_qid():
        seen.append(lifecycle.current().qid)
        raise FailPointError("executor::fetch_results (chaos)")

    with failpoint.scoped("executor::fetch_results", action=note_qid):
        with pytest.raises(FailPointError):
            s.sql("select b, sum(a) from t group by b")
    recs = _audit_records_for(seen[0])
    assert len(recs) == 1
    assert recs[0]["state"] == "error"
    assert recs[0]["stage"]  # terminal stage attributed (unwind-dependent)
    _assert_clean(s, before)
    _probe_correct(s)
