"""Port counterpart of tests/test_ingest.py, and of the ingest half of
tests/test_chaos.py, run against starrocks_tpu_torch on the CPU: HTTP
stream load, routine-load poller, micro-batch group commit, txn-label
exactly-once, gate footprints, compaction hygiene, the enable_ingest_plane
kill switch, and faults at stage/commit/label-journal/poll.

Where the reference waits on the clock (the poll interval, a batch's age,
a killer thread's sleep), these tests drive the same paths without
sleeping: the poll thread's interval is an hour and the test ticks it
(`IngestPoller.poll_once`), a group commit ripens by its row count, and a
KILL is delivered from a failpoint action.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from starrocks_tpu_torch.ingest import (
    IngestBackpressure,
    IngestError,
    parse_csv,
    parse_json,
)
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.http_service import SqlHttpServer
from starrocks_tpu_torch.runtime.serving import StatementGate, _read_footprint
from starrocks_tpu_torch.runtime import failpoint, lifecycle
from starrocks_tpu_torch.runtime.failpoint import FailPointError
from starrocks_tpu_torch.runtime.lifecycle import (
    ACCOUNTANT, REGISTRY, QueryCancelledError,
)
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.runtime.workload import WORKLOAD

_HOUR = 3600.0  # a poll interval no test waits out: ticks are driven


def Session(*args, **kwargs):
    """The port's Session on the CPU (its entry points default to the
    card)."""
    kwargs.setdefault("device", "cpu")
    return _Session(*args, **kwargs)


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)


@pytest.fixture(autouse=True)
def _reset_ingest_knobs():
    yield
    for knob, dflt in (
        ("enable_ingest_plane", True),
        ("ingest_batch_rows", 4096),
        ("ingest_batch_age_ms", 200),
        ("ingest_staging_limit_bytes", 64 << 20),
        ("ingest_compact_commits", 32),
        ("ingest_compact_bytes", 64 << 20),
        ("ingest_poll_interval_s", 0.5),
        ("enable_query_cache", False),
        ("enable_plan_cache", True),
    ):
        try:
            config.set(knob, dflt)
        except KeyError:
            pass


def _mk(s=None, table="ti"):
    """Session + fast-commit plane + a PK table to load into."""
    s = s or Session()
    s.sql(f"create table {table} (k int, v int, primary key (k))")
    plane = s.ingest_plane()
    config.set("ingest_batch_age_ms", 5)
    return s, plane


# --- direct plane API --------------------------------------------------------

def test_load_commits_and_label_replays():
    s, plane = _mk()
    r1 = plane.load(s, "ti", [{"k": 1, "v": 10}, {"k": 2, "v": 20}],
                    label="L1")
    assert r1["rows"] == 2 and r1["table"] == "ti"
    assert not r1.get("replayed")
    assert s.sql("select k, v from ti order by k").rows() == [
        (1, 10), (2, 20)]
    # exactly-once: the same label is a durable no-op answering with the
    # ORIGINAL receipt, and no rows are re-applied
    r2 = plane.load(s, "ti", [{"k": 1, "v": 999}], label="L1")
    assert r2["replayed"] and r2["commit_seq"] == r1["commit_seq"]
    assert s.sql("select v from ti where k = 1").rows() == [(10,)]


def test_load_upserts_on_pk():
    s, plane = _mk()
    plane.load(s, "ti", [{"k": 1, "v": 1}], label="a")
    plane.load(s, "ti", [{"k": 1, "v": 2}], label="b")
    assert s.sql("select v from ti where k = 1").rows() == [(2,)]
    assert s.sql("select count(*) from ti").rows() == [(1,)]


def test_load_rejects_bad_targets_and_rows():
    s, plane = _mk()
    s.sql("create view vw as select k from ti")
    with pytest.raises(IngestError, match="unknown table"):
        plane.load(s, "nope", [{"k": 1}])
    with pytest.raises(IngestError, match="view"):
        plane.load(s, "vw", [{"k": 1}])
    with pytest.raises(IngestError, match="empty load"):
        plane.load(s, "ti", [])
    with pytest.raises(IngestError, match="unknown column"):
        plane.load(s, "ti", [{"k": 1, "zzz": 2}])
    with pytest.raises(IngestError, match="PRIMARY KEY"):
        plane.load(s, "ti", [{"k": None, "v": 2}])
    # nothing staged after the rejections
    assert plane.stats()["staged_bytes"] == 0


def test_group_commit_folds_concurrent_loads():
    s, plane = _mk()
    # the batch ripens when the third row stages (never by age)
    config.set("ingest_batch_age_ms", 3_600_000)
    config.set("ingest_batch_rows", 3)
    receipts = []

    def one(i):
        receipts.append(plane.load(
            s, "ti", [{"k": i, "v": i}], label=f"g{i}"))

    ts = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    # all three requests folded into ONE micro-batch commit
    assert len({r["commit_seq"] for r in receipts}) == 1
    assert all(r["batch_rows"] == 3 for r in receipts)
    assert s.sql("select count(*) from ti").rows() == [(3,)]


def test_backpressure_rejects_before_staging():
    s, plane = _mk()
    config.set("ingest_staging_limit_bytes", 1)
    with pytest.raises(IngestBackpressure):
        plane.load(s, "ti", [{"k": 1, "v": 1}], label="bp")
    assert plane.stats()["staged_bytes"] == 0
    # retry with the SAME label succeeds once the budget recovers
    config.set("ingest_staging_limit_bytes", 64 << 20)
    r = plane.load(s, "ti", [{"k": 1, "v": 1}], label="bp")
    assert not r.get("replayed") and r["rows"] == 1


def test_load_classifies_as_load_workload():
    s, plane = _mk()
    def loads():
        return sum(row["count"] for row in WORKLOAD.snapshot()
                   if row["stmt_class"] == "load")

    before = loads()
    plane.load(s, "ti", [{"k": 7, "v": 7}], label="wl")
    assert loads() > before


# --- body parsing ------------------------------------------------------------

def test_parse_csv_mapping_separator_and_nulls():
    s, _plane = _mk()
    h = s.catalog.get_table("ti")
    assert parse_csv(h, "1,10\n2,20\n") == [
        {"k": 1, "v": 10}, {"k": 2, "v": 20}]
    # explicit column mapping, custom separator, '' and \N as NULL
    assert parse_csv(h, "5|\n6|\\N\n", columns=["k", "v"], sep="|") == [
        {"k": 5, "v": None}, {"k": 6, "v": None}]
    assert parse_csv(h, "9", columns=["k"]) == [{"k": 9}]
    with pytest.raises(IngestError, match="arity"):
        parse_csv(h, "1,2,3")
    with pytest.raises(IngestError, match="unknown column"):
        parse_csv(h, "1", columns=["zzz"])


def test_parse_json_shapes():
    s, _plane = _mk()
    h = s.catalog.get_table("ti")
    assert parse_json(h, '{"k": 1, "v": 2}') == [{"k": 1, "v": 2}]
    assert parse_json(h, '[{"k": 1}, {"K": 2}]') == [{"k": 1}, {"k": 2}]
    assert parse_json(h, '{"rows": [{"k": 3}]}') == [{"k": 3}]
    # NDJSON: one object per line
    assert parse_json(h, '{"k": 1}\n{"k": 2}\n') == [{"k": 1}, {"k": 2}]
    with pytest.raises(IngestError, match="unknown column"):
        parse_json(h, '{"zzz": 1}')
    with pytest.raises(IngestError):
        parse_json(h, '"scalar"')


# --- HTTP stream load --------------------------------------------------------

def _put(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body.encode(),
        headers=headers or {}, method="PUT")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else {}


def test_http_stream_load_end_to_end():
    srv = SqlHttpServer(Session()).start()
    try:
        sess = srv.tier.template
        sess.sql("create table web (k int, v varchar, primary key (k))")
        sess.ingest_plane()
        config.set("ingest_batch_age_ms", 5)
        # CSV with a label
        code, body = _put(srv.port, "/api/load/web?label=h1", "1,aa\n2,bb\n")
        assert code == 200 and body["status"] == "ok"
        assert body["rows"] == 2 and "ms" in body
        # JSON format
        code, body = _put(srv.port, "/api/load/web?format=json&label=h2",
                          '[{"k": 3, "v": "cc"}]')
        assert code == 200 and body["rows"] == 1
        # column mapping: only k, v fills NULL
        code, body = _put(srv.port, "/api/load/web?columns=k", "4\n")
        assert code == 200
        r = sess.sql("select k, v from web order by k").rows()
        assert r == [(1, "aa"), (2, "bb"), (3, "cc"), (4, None)]
        # label replay answers the ORIGINAL receipt, applies nothing
        code, body = _put(srv.port, "/api/load/web?label=h1", "1,zz\n")
        assert code == 200 and body["replayed"]
        assert sess.sql("select v from web where k = 1").rows() == [("aa",)]
        # parse errors are 400s, unknown table too
        code, body = _put(srv.port, "/api/load/web", "1,2,3\n")
        assert code == 400 and "arity" in body["error"]
        code, _ = _put(srv.port, "/api/load/missing", "1\n")
        assert code == 400
        # backpressure maps to 429
        config.set("ingest_staging_limit_bytes", 1)
        code, body = _put(srv.port, "/api/load/web", "9,x\n")
        assert code == 429 and body["status"] == "backpressure"
        config.set("ingest_staging_limit_bytes", 64 << 20)
        # GET /api/ingest: plane stats + job rows
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/api/ingest") as r:
            doc = json.loads(r.read())
        assert doc["ingest"]["commits"] >= 3
        assert doc["ingest"]["staged_bytes"] == 0
        assert doc["jobs"] == []
    finally:
        srv.stop()


# --- durability: labels and jobs survive restart -----------------------------

def test_label_replay_survives_restart_via_tail_and_image(tmp_path):
    s = Session(data_dir=str(tmp_path / "db"))
    s, plane = _mk(s)
    r1 = plane.load(s, "ti", [{"k": 1, "v": 1}], label="dur")
    # journal-tail replay: a fresh process sees the label without any
    # image having been cut
    s2 = Session(data_dir=str(tmp_path / "db"))
    r2 = s2.ingest_plane().load(s2, "ti", [{"k": 1, "v": 99}], label="dur")
    assert r2["replayed"] and r2["commit_seq"] == r1["commit_seq"]
    assert s2.sql("select v from ti where k = 1").rows() == [(1,)]
    # image replay: checkpoint folds the ledger into the image, the tail
    # resets, and the label STILL replays
    s2.checkpoint_metadata()
    s3 = Session(data_dir=str(tmp_path / "db"))
    r3 = s3.ingest_plane().load(s3, "ti", [{"k": 1, "v": 98}], label="dur")
    assert r3["replayed"]
    assert s3.sql("select v from ti where k = 1").rows() == [(1,)]


# --- routine-load poller -----------------------------------------------------

def test_routine_load_job_tails_file_and_persists_offsets(tmp_path):
    s = Session(data_dir=str(tmp_path / "db"))
    s, plane = _mk(s)
    config.set("ingest_poll_interval_s", _HOUR)
    src = tmp_path / "feed.csv"
    src.write_text("1,10\n2,20\n")
    spec = {"table": "ti", "path": str(src), "format": "csv"}
    s.sql(f"admin set ingest_job 'j1' = '{json.dumps(spec)}'")
    assert plane.poller.stats()["running"]
    plane.poller.poll_once()
    assert s.sql("select count(*) from ti").rows() == [(2,)]
    # appended bytes load incrementally; a HALF-WRITTEN tail line (no
    # newline) must wait for the next tick, not load garbage
    with open(src, "a") as f:
        f.write("3,30\n4,4")
    plane.poller.poll_once()
    assert s.sql("select count(*) from ti").rows() == [(3,)]
    plane.poller.poll_once()  # extra ticks must NOT load the partial line
    assert s.sql("select count(*) from ti").rows() == [(3,)]
    with open(src, "a") as f:
        f.write("0\n")
    plane.poller.poll_once()
    assert s.sql("select v from ti where k = 4").rows() == [(40,)]
    # information_schema.ingest_jobs surfaces the job row
    rows = s.sql(
        "select name, table_name, state, rows_loaded from "
        "information_schema.ingest_jobs").rows()
    assert rows == [("j1", "ti", "RUNNING", 4)]
    # restart: the job + offsets replay, nothing double-loads
    s.checkpoint_metadata()
    plane.poller.stop()  # first incarnation "exits"
    s2 = Session(data_dir=str(tmp_path / "db"))
    plane2 = s2.ingest_plane()
    assert plane2.poller.stats()["running"]
    plane2.poller.poll_once()
    assert s2.sql("select count(*) from ti").rows() == [(4,)]
    snap = plane2.poller.snapshot()
    assert snap[0]["offsets"] == {str(src): len(src.read_bytes())}
    # drop stops the (last) poll thread entirely
    s2.sql("admin set ingest_job 'j1' = 'drop'")
    assert plane2.poller.stats() == {"jobs": 0, "running": False}
    assert not any(t.name == "sr-tpu-ingest-poll" and t.is_alive()
                   for t in threading.enumerate())


def test_ingest_job_spec_validation():
    s, plane = _mk()
    with pytest.raises(IngestError, match="table and path"):
        s.sql("admin set ingest_job 'bad' = '{\"path\": \"/tmp/x\"}'")
    with pytest.raises(IngestError, match="unknown table"):
        s.sql('admin set ingest_job \'bad\' = '
              '\'{"table": "nope", "path": "/tmp/x"}\'')
    assert plane.poller.stats() == {"jobs": 0, "running": False}


# --- statement-gate footprints -----------------------------------------------

def test_gate_matrix_table_exclusive_vs_readers():
    g = StatementGate()
    with g.exclusive("x"):
        # ingest commit on x: reads of OTHER tables flow freely...
        assert g.try_shared(frozenset({"y"}))
        g.release_shared(frozenset({"y"}))
        # ...reads of x stall, and so do strong (unknown-footprint) readers
        assert not g.try_shared(frozenset({"x"}))
        assert not g.try_shared(None)
    # commit done: both admit again
    assert g.try_shared(frozenset({"x"}))
    g.release_shared(frozenset({"x"}))
    assert g.try_shared(None)
    g.release_shared(None)


def test_read_footprint_upgrades_via_plan_cache():
    s = Session()
    s.sql("create table base (a int)")
    s.sql("create table other (b int)")
    s.sql("create view v as select a from base")
    cat, cache = s.catalog, s.cache
    # plain table read: token scan already proves the footprint
    assert _read_footprint("select a from base", cat, cache) == \
        frozenset({"base"})
    # view read COLD: not provable by tokens -> strong reader (None)
    assert _read_footprint("select a from v", cat, cache) is None
    # after one execution the analyzed plan is cached and the SAME text
    # upgrades to an exact per-table claim THROUGH the view
    s.sql("select a from v")
    assert _read_footprint("select a from v", cat, cache) == \
        frozenset({"base"})
    # catalog-only reads claim no base table at all (weakest reader)
    s.sql("select 1")
    assert _read_footprint("select 1", cat, cache) == frozenset()
    # non-reads never claim
    assert _read_footprint("insert into base values (1)", cat, cache) \
        is None


# --- kill switch -------------------------------------------------------------

def test_enable_ingest_plane_off_rejects_and_stays_threadless():
    s, plane = _mk()
    config.set("enable_ingest_plane", False)
    with pytest.raises(IngestError, match="disabled"):
        plane.load(s, "ti", [{"k": 1, "v": 1}])
    with pytest.raises(IngestError, match="disabled"):
        s.sql("admin set ingest_job 'j' = '{\"table\":\"ti\","
              "\"path\":\"/tmp/x\"}'")
    plane.poller.ensure_started()
    assert plane.poller.stats()["running"] is False
    assert not any(t.name == "sr-tpu-ingest-poll" and t.is_alive()
                   for t in threading.enumerate())
    # existing statement paths are untouched by the disabled plane
    s.sql("insert into ti values (5, 50)")
    assert s.sql("select v from ti where k = 5").rows() == [(50,)]


# --- small-segment hygiene ---------------------------------------------------

def test_micro_batch_commits_trigger_compaction(tmp_path):
    s = Session(data_dir=str(tmp_path / "db"))
    s, plane = _mk(s)
    config.set("ingest_compact_commits", 3)
    for i in range(3):
        plane.load(s, "ti", [{"k": i, "v": i}], label=f"c{i}")
    # 3 micro-batch commits tripped the trigger: rowsets merged to one
    m = s.store.read_manifest("ti")
    assert len(m["rowsets"]) == 1
    assert s.sql("select count(*) from ti").rows() == [(3,)]
    # debt reset: the next load does NOT immediately re-compact
    plane.load(s, "ti", [{"k": 9, "v": 9}], label="c9")
    assert len(s.store.read_manifest("ti")["rowsets"]) == 2


def test_partial_agg_cache_survives_micro_batches_and_compaction(tmp_path):
    config.set("enable_query_cache", True)
    s = Session(data_dir=str(tmp_path / "db"))
    s.sql("create table agg (k int, v double, primary key (k))")
    plane = s.ingest_plane()
    config.set("ingest_batch_age_ms", 5)
    vals = ",".join(f"({i}, {float(i)})" for i in range(2000))
    s.sql(f"insert into agg values {vals}")
    q = "select k % 5 g, sum(v) sv, count(*) c from agg group by g order by g"
    s.sql(q)  # cold: states cached per segment

    def counters():
        return {k: v for k, (v, _) in s.last_profile.counters.items()}

    # a micro-batch commit lands a NEW segment: the partial tier reuses
    # the cached state for the old one and scans only the delta
    plane.load(s, "agg", [{"k": 2000 + i, "v": float(2000 + i)}
                          for i in range(100)], label="seg2")
    r = s.sql(q)
    c = counters()
    assert c.get("qcache_partial_hits", 0) >= 1
    assert c.get("qcache_rows_saved", 0) >= 2000
    got = {row[0]: (row[1], row[2]) for row in r.rows()}
    for g in range(5):
        vs = [float(i) for i in range(2100) if i % 5 == g]
        assert abs(got[g][0] - sum(vs)) < 1e-3 and got[g][1] == len(vs)
    # force the ingest-side compaction trigger; results must stay exact
    # (the rewritten segment invalidates its states via the store listener)
    config.set("ingest_compact_commits", 1)
    plane.load(s, "agg", [{"k": 5000, "v": 5000.0}], label="seg3")
    assert len(s.store.read_manifest("agg")["rowsets"]) == 1
    got = {row[0]: (row[1], row[2]) for row in s.sql(q).rows()}
    vals = [float(i) for i in range(2100)] + [5000.0]
    for g in range(5):
        vs = [v for v in vals if int(v) % 5 == g]
        assert abs(got[g][0] - sum(vs)) < 1e-3 and got[g][1] == len(vs)


# --- the ingest half of tests/test_chaos.py ----------------------------------

def _ingest_leaks(s, plane) -> dict:
    wm = getattr(s.catalog, "workgroups", None)
    return {
        "process_bytes": ACCOUNTANT.snapshot()["process_bytes"],
        "slots": sum(wm.running.values()) if wm is not None else 0,
        "qcache_bytes": s.cache.qcache.resident_bytes,
        "registry": len(REGISTRY.snapshot()),
        "ingest_staged": plane.stats()["staged_bytes"],
    }


def _audit_records_for(qid: int) -> list:
    from starrocks_tpu_torch.runtime.audit import AUDIT

    return [r for r in AUDIT.snapshot() if r["query_id"] == qid]


def test_ingest_commit_fault_fails_whole_batch_atomically():
    """A fault before the append fails the WHOLE batch: no partial rows
    become visible, nothing stays staged, and a retry with the SAME
    label commits exactly once (not a replay — the label never landed)."""
    s, plane = _mk()
    plane.load(s, "ti", [{"k": 1, "v": 1}], label="seed")
    before = _ingest_leaks(s, plane)
    with failpoint.scoped("ingest::commit"):
        with pytest.raises((IngestError, FailPointError)):
            plane.load(s, "ti", [{"k": 2, "v": 2}, {"k": 3, "v": 3}],
                       label="L")
    assert s.sql("select count(*) from ti").rows() == [(1,)]
    assert _ingest_leaks(s, plane) == before
    r = plane.load(s, "ti", [{"k": 2, "v": 2}, {"k": 3, "v": 3}],
                   label="L")
    assert "replayed" not in r
    assert s.sql("select count(*) from ti").rows() == [(3,)]


def test_ingest_label_journal_fault_retry_is_idempotent(tmp_path):
    """A fault AFTER the append but BEFORE the label journal: the retry
    re-upserts the same keys (PK delta path), so the net effect is
    exactly-once — and the label then replays as a durable no-op,
    including across a restart."""
    s = Session(data_dir=str(tmp_path / "db"))
    s, plane = _mk(s)
    before = _ingest_leaks(s, plane)
    with failpoint.scoped("ingest::label_journal"):
        with pytest.raises((IngestError, FailPointError)):
            plane.load(s, "ti", [{"k": 1, "v": 1}], label="L1")
    assert _ingest_leaks(s, plane) == before
    r = plane.load(s, "ti", [{"k": 1, "v": 1}], label="L1")
    assert "replayed" not in r  # the faulted attempt never journaled it
    assert s.sql("select k, v from ti").rows() == [(1, 1)]
    r2 = plane.load(s, "ti", [{"k": 1, "v": 9}], label="L1")
    assert r2["replayed"] is True
    assert s.sql("select k, v from ti").rows() == [(1, 1)]
    s2 = Session(data_dir=str(tmp_path / "db"))
    r3 = s2.ingest_plane().load(s2, "ti", [{"k": 1, "v": 9}], label="L1")
    assert r3["replayed"] is True
    assert s2.sql("select k, v from ti").rows() == [(1, 1)]


def test_ingest_kill_while_staged_unwinds_clean():
    """KILL lands while the load waits for its micro-batch: the staged
    rows unstage (no leak), nothing commits, and the load leaves exactly
    one audit record in state 'cancelled'. The KILL is delivered from the
    stage failpoint; the batch (an hour's age, a million rows) never
    ripens, so the wait loop's checkpoint is where it lands."""
    s, plane = _mk()
    config.set("ingest_batch_age_ms", 3_600_000)
    config.set("ingest_batch_rows", 1_000_000)
    before = _ingest_leaks(s, plane)
    qids = []

    def kill_current():
        qids.append(lifecycle.current().qid)
        REGISTRY.cancel(qids[0], requester="root", admin=True)

    with failpoint.scoped("ingest::stage", action=kill_current):
        with pytest.raises(QueryCancelledError):
            plane.load(s, "ti", [{"k": 5, "v": 5}], label="K")
    assert _ingest_leaks(s, plane) == before
    assert s.sql("select count(*) from ti").rows() == [(0,)]
    recs = _audit_records_for(qids[0])
    assert len(recs) == 1
    assert recs[0]["state"] == "cancelled"


def test_ingest_backpressure_event_and_zero_leak():
    """Over-budget staging rejects the load BEFORE anything stages (zero
    leak) and emits the ingest_backpressure event; after the budget is
    restored the SAME label loads normally."""
    from starrocks_tpu_torch.runtime.events import EVENTS

    s, plane = _mk()
    config.set("ingest_staging_limit_bytes", 1)
    before = _ingest_leaks(s, plane)
    n0 = EVENTS.stats().get("ingest_backpressure", 0)
    with pytest.raises(IngestBackpressure):
        plane.load(s, "ti", [{"k": 1, "v": 1}], label="B")
    assert EVENTS.stats().get("ingest_backpressure", 0) == n0 + 1
    assert _ingest_leaks(s, plane) == before
    assert s.sql("select count(*) from ti").rows() == [(0,)]
    config.set("ingest_staging_limit_bytes", 64 << 20)
    r = plane.load(s, "ti", [{"k": 1, "v": 1}], label="B")
    assert "replayed" not in r
    assert s.sql("select count(*) from ti").rows() == [(1,)]


def test_ingest_group_commit_audits_once_per_load():
    """Loads folded into ONE micro-batch commit still audit once EACH;
    the shared commit is the matching commit_seq on their receipts."""
    from starrocks_tpu_torch.runtime.audit import AUDIT

    s, plane = _mk()
    config.set("ingest_batch_age_ms", 3_600_000)
    config.set("ingest_batch_rows", 3)
    AUDIT.flush()
    n0 = AUDIT.stats()["registered"]
    out = {}

    def load(i):
        out[i] = plane.load(s, "ti", [{"k": i, "v": i}], label=f"g{i}")

    threads = [threading.Thread(target=load, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    AUDIT.flush()
    assert AUDIT.stats()["registered"] - n0 == 3
    assert len({r["commit_seq"] for r in out.values()}) == 1  # one batch
    assert s.sql("select count(*) from ti").rows() == [(3,)]
    assert plane.stats()["staged_bytes"] == 0


def test_ingest_poller_fault_surfaces_on_job_and_loop_survives(tmp_path):
    """A fault at ingest::poll fails that tick, journals an
    ingest_job_error event, and the NEXT tick (fault disarmed) loads the
    file — the poll loop never dies with its job."""
    from starrocks_tpu_torch.runtime.events import EVENTS

    s = Session(data_dir=str(tmp_path / "db"))
    s, plane = _mk(s)
    config.set("ingest_poll_interval_s", _HOUR)
    src = tmp_path / "in.csv"
    src.write_text("1,10\n2,20\n")
    n0 = EVENTS.stats().get("ingest_job_error", 0)
    spec = json.dumps({"table": "ti", "path": str(src)})
    with failpoint.scoped("ingest::poll", times=2):
        s.sql(f"admin set ingest_job 'j' = '{spec}'")
        plane.poller.poll_once()
        plane.poller.poll_once()
    assert EVENTS.stats().get("ingest_job_error", 0) == n0 + 2
    assert s.sql("select errors from information_schema.ingest_jobs"
                 ).rows() == [(2,)]
    plane.poller.poll_once()
    assert s.sql("select count(*) from ti").rows() == [(2,)]
    s.sql("admin set ingest_job 'j' = 'drop'")
    assert plane.poller.stats() == {"jobs": 0, "running": False}
