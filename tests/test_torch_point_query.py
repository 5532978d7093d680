"""Port counterpart of tests/test_point_query.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). Short-circuit point-query plane (runtime/point.py + storage probe API).

The lane's contract: every statement it serves must be VALUE-IDENTICAL to
the full analytic path (`SET enable_short_circuit = off`) across the whole
torture matrix — hit / miss / deleted / multi-version rows, IN lists,
projections, interleaved DML — while staying inside the lifecycle plane
(killable in flight, chaos-clean at its failpoint, zero leaked slots or
bytes) and riding the per-table statement gate so point traffic on one
table never queues behind DML on another.
"""

import threading
import time

import pytest

from starrocks_tpu_torch.runtime import failpoint, lifecycle, point
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.failpoint import FailPointError
from starrocks_tpu_torch.runtime.lifecycle import (
    ACCOUNTANT, REGISTRY, QueryCancelledError,
)
from starrocks_tpu_torch.runtime.serving import (
    _FAST_MISS, ServingTier, StatementGate, SERVE_POINT_INLINE,
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



@pytest.fixture(autouse=True)
def _lane_knob():
    prev = config.get("enable_short_circuit")
    config.set("enable_short_circuit", True)
    yield
    config.set("enable_short_circuit", prev)


def _mk(tmp_path, name="db"):
    s = Session(data_dir=str(tmp_path / name))
    s.sql("create table kv (k bigint, v varchar, n bigint, primary key(k))")
    s.sql("insert into kv values "
          "(1, 'a', 10), (2, 'b', 20), (3, 'c', 30), (4, 'd', null)")
    return s


def _ab(s, sql):
    """Run `sql` through the lane and through the full path; both must
    agree on rows AND column names."""
    config.set("enable_short_circuit", True)
    on = s.sql(sql)
    config.set("enable_short_circuit", False)
    off = s.sql(sql)
    config.set("enable_short_circuit", True)
    assert on.rows() == off.rows(), sql
    assert on.column_names == off.column_names, sql
    return on


def _leak_snapshot(s):
    wm = getattr(s.catalog, "workgroups", None)
    return {
        "process_bytes": ACCOUNTANT.snapshot()["process_bytes"],
        "slots": sum(wm.running.values()) if wm is not None else 0,
        "registry": len(REGISTRY.snapshot()),
    }


# --- equality torture matrix --------------------------------------------------


def test_point_select_matrix_equals_full_path(tmp_path):
    s = _mk(tmp_path)
    lookups0 = point.POINT_LOOKUPS.value
    _ab(s, "select * from kv where k = 2")                 # hit, star
    _ab(s, "select v from kv where k = 2")                 # projection
    _ab(s, "select n, v from kv where k = 3")              # reordered proj
    _ab(s, "select v from kv where k = 99")                # miss
    _ab(s, "select * from kv where k in (1, 3, 99)")       # mixed IN
    _ab(s, "select * from kv where k in (2, 2, 2)")        # duplicate keys
    _ab(s, "select n from kv where k = 4")                 # NULL value col
    assert point.POINT_LOOKUPS.value > lookups0


def test_point_sees_deleted_and_multiversion_rows(tmp_path):
    s = _mk(tmp_path)
    # multi-version: upsert the same key twice; the lane must serve the
    # LIVE version (delvec masks the superseded row)
    s.sql("insert into kv values (2, 'b2', 21)")
    s.sql("insert into kv values (2, 'b3', 22)")
    r = _ab(s, "select v, n from kv where k = 2")
    assert r.rows() == [("b3", 22)]
    # deleted: a point read of a delvec'd key is a miss, identically
    config.set("enable_short_circuit", False)
    s.sql("delete from kv where k = 3")
    config.set("enable_short_circuit", True)
    r = _ab(s, "select * from kv where k = 3")
    assert r.rows() == []
    # reinsert after delete is visible again
    s.sql("insert into kv values (3, 'c9', 33)")
    r = _ab(s, "select v from kv where k = 3")
    assert r.rows() == [("c9",)]


def test_point_dml_equals_full_path_end_state(tmp_path):
    """Apply the same UPDATE/DELETE script through the lane and through
    the full path on twin stores; final table contents must agree."""
    script = [
        "update kv set n = 77 where k = 1",
        "delete from kv where k = 2",
        "update kv set n = null where k = 3",
        "update kv set n = 0 where k = 99",        # zero-hit update
        "delete from kv where k = 99",             # zero-hit delete
        "delete from kv where k in (3, 4)",
    ]
    s_on = _mk(tmp_path, "on")
    s_off = _mk(tmp_path, "off")
    affected_on, affected_off = [], []
    for stmt in script:
        config.set("enable_short_circuit", True)
        affected_on.append(s_on.sql(stmt))
        config.set("enable_short_circuit", False)
        affected_off.append(s_off.sql(stmt))
    assert affected_on == affected_off
    config.set("enable_short_circuit", False)
    full = "select k, v, n from kv order by k"
    assert s_on.sql(full).rows() == s_off.sql(full).rows()
    config.set("enable_short_circuit", True)


def test_point_update_varchar_column(tmp_path):
    """The lane's delta-write path handles varchar SET columns (the full
    analytic path cannot compile a string-literal CASE rewrite); verify
    the write through both read paths."""
    s = _mk(tmp_path)
    assert s.sql("update kv set v = 'zz', n = 77 where k = 1") == 1
    r = _ab(s, "select v, n from kv where k = 1")
    assert r.rows() == [("zz", 77)]


def test_point_read_your_writes_interleaved(tmp_path):
    s = _mk(tmp_path)
    for i in range(5):
        s.sql(f"update kv set n = {100 + i} where k = 1")
        assert s.sql("select n from kv where k = 1").rows() == [(100 + i,)]
    s.sql("delete from kv where k = 1")
    assert s.sql("select n from kv where k = 1").rows() == []
    s.sql("insert into kv values (1, 'back', 1)")
    assert s.sql("select v from kv where k = 1").rows() == [("back",)]


def test_off_keeps_lane_cold(tmp_path):
    s = _mk(tmp_path)
    config.set("enable_short_circuit", False)
    before = point.POINT_LOOKUPS.value
    s.sql("select * from kv where k = 1")
    s.sql("update kv set n = 5 where k = 1")
    assert point.POINT_LOOKUPS.value == before
    config.set("enable_short_circuit", True)


def test_point_statement_class_and_profile(tmp_path):
    s = _mk(tmp_path)
    r = s.sql("select v from kv where k = 1")
    assert r.profile is not None and r.profile.name == "point"
    assert s.last_profile is r.profile
    # non-PK predicates never enter the lane
    before = point.POINT_LOOKUPS.value
    s.sql("select v from kv where n = 10")
    assert point.POINT_LOOKUPS.value == before


# --- lifecycle: KILL + chaos --------------------------------------------------


def test_kill_in_flight_point_query(tmp_path):
    s = _mk(tmp_path)

    def kill_current():
        ctx = lifecycle.current()
        assert ctx is not None
        REGISTRY.cancel(ctx.qid, requester="root", admin=True)

    before = _leak_snapshot(s)
    with failpoint.scoped("point::probe", action=kill_current):
        with pytest.raises(QueryCancelledError, match="cancelled at stage"):
            s.sql("select * from kv where k = 1")
    assert _leak_snapshot(s) == before
    # lane healthy afterwards
    assert s.sql("select v from kv where k = 1").rows() == [("a",)]


def test_chaos_raise_at_point_probe_zero_leaks(tmp_path):
    s = _mk(tmp_path)
    before = _leak_snapshot(s)
    with failpoint.scoped("point::probe"):
        with pytest.raises(FailPointError, match="point::probe"):
            s.sql("select * from kv where k = 1")
    assert _leak_snapshot(s) == before
    assert s.store._journal_lock.acquire(blocking=False)
    s.store._journal_lock.release()
    assert s.sql("select v from kv where k = 1").rows() == [("a",)]


def test_chaos_raise_at_delete_rows_zero_leaks(tmp_path):
    s = _mk(tmp_path)
    before = _leak_snapshot(s)
    with failpoint.scoped("store::delete_rows"):
        with pytest.raises(FailPointError, match="store::delete_rows"):
            s.sql("delete from kv where k = 1")
    assert _leak_snapshot(s) == before
    # the failed delete left the row intact and the store serving
    assert s.sql("select v from kv where k = 1").rows() == [("a",)]
    assert s.sql("delete from kv where k = 1") == 1
    assert s.sql("select v from kv where k = 1").rows() == []


# --- per-table statement gate (NEXT 7g) ---------------------------------------


def test_gate_point_read_flows_past_dml_on_other_table():
    g = StatementGate()
    with g.exclusive("x", frozenset()):
        # reads of another table flow freely
        assert g.try_shared(frozenset(("y",)))
        g.release_shared(frozenset(("y",)))
        # reads of the DML's table are barred
        assert not g.try_shared(frozenset(("x",)))
        # footprint-unknown readers are barred by ANY table writer
        assert not g.try_shared()
    # gate fully released
    assert g.try_shared(frozenset(("x",)))
    g.release_shared(frozenset(("x",)))


def test_gate_global_exclusive_excludes_table_traffic():
    g = StatementGate()
    assert g.try_shared(frozenset(("y",)))
    entered = []

    def ddl():
        with g.exclusive():
            entered.append("ddl")

    th = threading.Thread(target=ddl)
    th.start()
    deadline = time.monotonic() + 5
    while not g._writers_waiting and time.monotonic() < deadline:
        time.sleep(0.005)
    # a QUEUED global writer bars new readers of any kind
    assert not g.try_shared(frozenset(("z",)))
    assert not entered
    g.release_shared(frozenset(("y",)))
    th.join(timeout=5)
    assert entered == ["ddl"]
    assert g.try_shared()
    g.release_shared()


def test_gate_table_writer_waits_for_same_table_reader():
    g = StatementGate()
    assert g.try_shared(frozenset(("x",)))
    entered = []

    def dml():
        with g.exclusive("x", frozenset()):
            entered.append("w")

    th = threading.Thread(target=dml)
    th.start()
    deadline = time.monotonic() + 5
    while not g._table_writers_waiting.get("x") \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not entered
    # writer preference: new readers of x are barred while it waits
    assert not g.try_shared(frozenset(("x",)))
    # ...but readers of unrelated tables still flow
    assert g.try_shared(frozenset(("y",)))
    g.release_shared(frozenset(("y",)))
    g.release_shared(frozenset(("x",)))
    th.join(timeout=5)
    assert entered == ["w"]


def test_tier_point_inline_and_isolation_from_other_table_dml(tmp_path):
    s = Session(data_dir=str(tmp_path / "tier"))
    s.sql("create table pk_t (k bigint, v varchar, primary key(k))")
    s.sql("insert into pk_t values (1, 'one'), (2, 'two')")
    s.sql("create table locked (k bigint, v varchar, primary key(k))")
    s.sql("insert into locked values (1, 'x')")
    tier = ServingTier(s, pool_size=2)
    try:
        c = tier.new_session()
        n0 = SERVE_POINT_INLINE.value
        assert tier.execute(c, "select v from pk_t where k = 2").rows() \
            == [("two",)]
        assert SERVE_POINT_INLINE.value == n0 + 1
        # while DML holds `locked` exclusively, the point read of pk_t is
        # still served inline (per-table gate), not queued behind it
        with tier.gate.exclusive("locked", frozenset()):
            assert tier.execute(c, "select v from pk_t where k = 1").rows() \
                == [("one",)]
            assert SERVE_POINT_INLINE.value == n0 + 2
            # a point read of the LOCKED table must decline the inline
            # lane (gate contended) and go to the writer-ordered pool path
            assert tier._try_point_inline(
                c, "select v from locked where k = 1") is _FAST_MISS
        # point DML through the tier keeps working
        assert tier.execute(c, "update pk_t set v = 'uno' where k = 1") == 1
        assert tier.execute(c, "select v from pk_t where k = 1").rows() \
            == [("uno",)]
    finally:
        tier.shutdown()


def test_tier_point_inline_respects_off_switch(tmp_path):
    s = Session(data_dir=str(tmp_path / "tier2"))
    s.sql("create table pk_t (k bigint, v varchar, primary key(k))")
    s.sql("insert into pk_t values (1, 'one')")
    tier = ServingTier(s, pool_size=2)
    try:
        c = tier.new_session()
        config.set("enable_short_circuit", False)
        n0 = SERVE_POINT_INLINE.value
        assert tier.execute(c, "select v from pk_t where k = 1").rows() \
            == [("one",)]
        assert SERVE_POINT_INLINE.value == n0
    finally:
        config.set("enable_short_circuit", True)
        tier.shutdown()


# --- conservative fallbacks ---------------------------------------------------


def test_fallback_shapes_never_enter_lane(tmp_path):
    s = _mk(tmp_path)
    s.sql("create view vv as select * from kv")
    before = point.POINT_LOOKUPS.value
    falls = [
        "select * from kv where k = 1 and n = 10",   # non-PK residual
        "select * from kv where k > 1",              # range, not point
        "select * from vv where k = 1",              # view
        "select v from kv where k = 1 or k = 2",     # OR, not IN
    ]
    config.set("enable_short_circuit", False)
    off_rows = [s.sql(q).rows() for q in falls]
    config.set("enable_short_circuit", True)
    on_rows = [s.sql(q).rows() for q in falls]
    assert on_rows == off_rows
    assert point.POINT_LOOKUPS.value == before


def test_in_list_cap_falls_back(tmp_path):
    s = _mk(tmp_path)
    before = point.POINT_LOOKUPS.value
    keys = ", ".join(str(i) for i in range(point.MAX_POINT_KEYS + 1))
    r = _ab(s, f"select k from kv where k in ({keys})")
    assert sorted(r.rows()) == [(1,), (2,), (3,), (4,)]
    assert point.POINT_LOOKUPS.value == before  # over cap: analytic path


# --- static gate: R8 point-query-scope ----------------------------------------


def test_src_lint_r8_point_scope():
    import ast
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "sr_src_lint", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "src_lint.py"))
    sl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sl)

    class _MS:
        def __init__(self, rel, src):
            self.rel, self.src, self.tree = rel, src, ast.parse(src)
            self.path = rel

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    point_src = open(os.path.join(repo, sl.POINT_MODULE)).read()
    sess_src = open(os.path.join(repo, sl.SESSION_MODULE)).read()
    good = [_MS(sl.POINT_MODULE, point_src), _MS(sl.SESSION_MODULE, sess_src)]
    assert sl.lint_point_scope(good) == []
    # serving-side execution call: exactly the laundering R8 exists for
    bad = good + [_MS(
        os.path.join("starrocks_tpu", "runtime", "serving.py"),
        "def f(session, sql):\n    return point.try_execute(session, sql)\n")]
    f = sl.lint_point_scope(bad)
    assert len(f) == 1 and "point-query-scope" in f[0]
    # a second entry inside session.py but outside _sql_inner is equally bad
    rogue = sess_src + "\ndef rogue(s, t):\n    return point.try_execute(s, t)\n"
    f = sl.lint_point_scope(
        [_MS(sl.POINT_MODULE, point_src), _MS(sl.SESSION_MODULE, rogue)])
    assert len(f) == 1
