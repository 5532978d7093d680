"""Port counterpart of tests/test_audit_events.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). Observability-plane tests: structured audit log, system event
journal, metrics time-series ring, and the ADMIN DIAGNOSE bundle
(reference analog: FE plugin/AuditEvent + fe.audit.log, SHOW PROC-style
event views, and the BE metrics webpage — SURVEY §1/§5).

The contracts under test:

- every top-level statement — success, error, point-lane — leaves
  exactly ONE audit record with its terminal state, via both surfaces
  (AUDIT.snapshot and information_schema.audit_log);
- every ring is hard-bounded (audit, pending included; events; metrics
  history) and the JSONL sink never exceeds ~2x its rotation threshold;
- the event taxonomy is closed (off-taxonomy emission raises);
- heartbeat loss/reconnect transitions journal exactly once per outage;
- ADMIN DIAGNOSE returns one parseable JSON document with every
  flight-recorder section present.
"""

import json
import os

import pytest

from starrocks_tpu_torch.runtime import events
from starrocks_tpu_torch.runtime.audit import AUDIT, diagnostic_bundle
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.events import EVENTS, TAXONOMY
from starrocks_tpu_torch.runtime.events import emit as emit_event
from starrocks_tpu_torch.runtime.metrics import HISTORY
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
def _restore_obs_knobs():
    yield
    config.set("enable_audit_log", True)
    config.set("audit_log_ring", 1024)
    config.set("audit_log_path", "")
    config.set("audit_log_rotate_mb", 8)
    config.set("events_ring_size", 512)
    config.set("metrics_history_capacity", 120)


def _sess():
    s = Session()
    s.sql("create table t (a int, b int)")
    s.sql("insert into t values (1, 2), (2, 3), (1, 4)")
    return s


# --- audit log ---------------------------------------------------------------


def test_audit_exactly_one_record_per_statement():
    s = _sess()  # 2 records already: create + insert
    n0 = AUDIT.stats()["registered"]
    s.sql("select b, sum(a) sa from t group by b")
    with pytest.raises(Exception):
        s.sql("select no_such_col from t")
    recs = AUDIT.snapshot()
    assert AUDIT.stats()["registered"] - n0 == 2
    ok, bad = recs[-2], recs[-1]
    assert ok["state"] == "done" and ok["stmt_class"] == "read"
    assert ok["tables"] == "t" and ok["rows"] == 3
    assert ok["mem_peak_bytes"] > 0  # the accountant's high-water mark
    assert bad["state"] == "error"
    # the same two records through the SQL surface
    got = s.sql("select state from information_schema.audit_log "
                "order by seq").rows()
    assert [r[0] for r in got[-2:]] == ["done", "error"]


def test_audit_point_lane_records(tmp_path):
    s = Session(data_dir=str(tmp_path / "db"))
    s.sql("create table kv (k bigint, v varchar, primary key(k))")
    s.sql("insert into kv values (1, 'a'), (2, 'b')")
    n0 = AUDIT.stats()["registered"]
    assert s.sql("select v from kv where k = 2").rows() == [("b",)]
    recs = AUDIT.snapshot()
    assert AUDIT.stats()["registered"] - n0 == 1
    assert recs[-1]["stmt_class"] == "point"
    assert recs[-1]["state"] == "done" and recs[-1]["tables"] == "kv"


def test_audit_ring_hard_bounded():
    s = _sess()
    config.set("audit_log_ring", 4)
    for _ in range(10):
        s.sql("select count(*) from t")
    st = AUDIT.stats()
    assert st["retained"] == 4
    assert len(AUDIT.snapshot()) == 4
    assert st["dropped"] > 0


class _FakeCtx:
    """Terminal-shaped context for driving the audit sink directly
    (rotation needs megabytes of records; real queries would dominate
    the test's runtime)."""

    def __init__(self, i):
        self.qid = i
        self.profile = None
        self.stmt_class = "read"
        self.sql = "select /* pad */ " + "x" * 600
        self.user = "root"
        self.tables = ("t",)
        self.state = "done"
        self.last_stage = "fetch_results"
        self.queue_wait_ms = 0
        self.rows = 1
        self.mem_peak = 0
        self.degraded = False

    def elapsed_ms(self):
        return 1

    def cancel_reason(self):
        return None


def test_audit_jsonl_sink_rotates_and_stays_bounded(tmp_path):
    path = str(tmp_path / "audit.jsonl")
    config.set("audit_log_rotate_mb", 1)
    config.set("audit_log_path", path)
    rotate_bytes = 1 << 20
    try:
        # ~700B/line x 4000 crosses the 1MB threshold twice over
        for i in range(4000):
            AUDIT.record_query(_FakeCtx(i))
        AUDIT.flush()
        assert os.path.exists(path + ".1"), "sink never rotated"
        sizes = [os.path.getsize(p) for p in (path, path + ".1")]
        slack = 4096  # one record of overshoot headroom
        assert all(sz <= rotate_bytes + slack for sz in sizes), sizes
        assert sum(sizes) <= 2 * rotate_bytes + slack, sizes
        with open(path) as f:
            last = json.loads(f.readlines()[-1])
        assert last["stmt_class"] == "read" and len(last["stmt"]) == 512
    finally:
        config.set("audit_log_path", "")
        config.set("audit_log_rotate_mb", 8)


# --- event journal -----------------------------------------------------------


def test_event_ring_bounded_and_counts_survive_eviction():
    EVENTS.clear()
    config.set("events_ring_size", 3)
    for _ in range(8):
        emit_event("compaction", table="t", rows=1, rowsets_merged=2)
    assert len(EVENTS.snapshot()) == 3
    assert EVENTS.stats()["compaction"] == 8  # lifetime, not ring
    ev = EVENTS.snapshot()[-1]
    assert ev["name"] == "compaction" and ev["detail"]["table"] == "t"
    assert ev["seq"] == 8


def test_event_off_taxonomy_raises():
    with pytest.raises(ValueError, match="closed taxonomy"):
        emit_event("made_up_event", x=1)
    assert "made_up_event" not in EVENTS.stats()


def test_events_sql_surface():
    emit_event("checkpoint", seq=7, tail_ops=0)
    got = Session().sql(
        "select name, detail from information_schema.events "
        "order by seq").rows()
    assert got and got[-1][0] == "checkpoint"
    assert json.loads(got[-1][1])["seq"] == 7
    assert all(name in TAXONOMY for name, _d in got)


def test_soft_mem_degrade_emits_event():
    n0 = EVENTS.stats().get("soft_mem_degrade", 0)
    s = _sess()
    config.set("query_mem_soft_limit_bytes", 1)
    try:
        s.sql("select b, sum(a) from t group by b")
    finally:
        config.set("query_mem_soft_limit_bytes", 0)
    assert EVENTS.stats().get("soft_mem_degrade", 0) > n0


# --- heartbeat loss / reconnect ----------------------------------------------


def test_heartbeat_loss_and_reconnect_journal_once_per_outage():
    from starrocks_tpu_torch.runtime.cluster import Heartbeater

    hb = Heartbeater("127.0.0.1", 1, "w1", autostart=False)
    base_loss = EVENTS.stats().get("heartbeat_loss", 0)
    base_rec = EVENTS.stats().get("heartbeat_reconnect", 0)
    hb._observe(False)   # outage starts: journaled
    hb._observe(False)   # still down: silent (once per outage)
    hb._observe(False)
    hb._observe(True)    # back: reconnect with the failure count
    hb._observe(True)    # healthy steady-state: silent
    assert EVENTS.stats().get("heartbeat_loss", 0) == base_loss + 1
    assert EVENTS.stats().get("heartbeat_reconnect", 0) == base_rec + 1
    rec = [e for e in EVENTS.snapshot()
           if e["name"] == "heartbeat_reconnect"][-1]
    assert rec["detail"] == {"worker": "w1", "after_failures": 3}


# --- metrics history ---------------------------------------------------------


def test_metrics_history_ring_bounded_and_sample_shape():
    HISTORY.clear()
    config.set("metrics_history_capacity", 5)
    for _ in range(12):
        HISTORY.sample()
    samples = HISTORY.snapshot()
    assert len(samples) == 5
    s = samples[-1]
    assert set(s) == {"ts", "counters", "gauges", "histograms"}
    # counter entries are deltas: an idle process samples no movement
    assert all(v > 0 for v in s["counters"].values())


def test_metrics_history_counter_deltas():
    s = _sess()
    HISTORY.clear()
    HISTORY.sample()
    s.sql("select count(*) from t")
    HISTORY.sample()
    last = HISTORY.snapshot()[-1]
    assert last["counters"].get("sr_tpu_queries_total", 0) >= 1


def test_metrics_history_sql_surface():
    HISTORY.sample()
    got = Session().sql(
        "select name, kind from information_schema.metrics_history "
        "where kind = 'gauge'").rows()
    assert got  # gauges are always present (memory/cache gauges)


# --- ADMIN DIAGNOSE ----------------------------------------------------------


def test_admin_diagnose_bundle():
    s = _sess()
    s.sql("select b, sum(a) from t group by b")
    out = s.sql("admin diagnose")
    bundle = json.loads(out)
    for section in ("generated_ts", "running", "memory", "profiles",
                    "audit_tail", "audit_stats", "events_tail",
                    "event_counts", "metrics_history", "lock_witness",
                    "failpoints", "config_non_default", "cache"):
        assert section in bundle, section
    assert bundle["audit_tail"], "bundle carries no audit tail"
    assert bundle["audit_tail"][-1]["stmt_class"] == "read"
    assert isinstance(bundle["lock_witness"]["cycles"], int)
    # direct-call parity (the /api/debug/bundle handler calls this)
    assert set(diagnostic_bundle(s)) == set(bundle)


def test_admin_diagnose_requires_admin():
    s = _sess()
    s.sql("create user 'bob' identified by 'pw'")
    s2 = Session(catalog=s.catalog, cache=s.cache)
    s2.current_user = "bob"
    with pytest.raises(PermissionError):
        s2.sql("admin diagnose")
