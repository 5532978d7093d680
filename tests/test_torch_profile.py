"""Port counterpart of tests/test_profile.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). EXPLAIN ANALYZE + query-profile service (reference analogs:
be/src/common/runtime_profile.h per-operator counters, FE ProfileManager
+ audit log, /api/query profile endpoints).

Covers: per-operator est-vs-observed annotation against the feedback
observation channel on a join+agg (monolithic single-chip AND the
distributed fragment path, byte-identical result rows), ProfileManager
retention/LRU/slow-ring bounds, histogram bucket math + Prometheus
exposition golden, Chrome trace-event export schema, killed-query
profiles reporting the failed stage, and a chaos scenario asserting the
profile store leaks nothing across mid-execute failures."""

import json
import re

import pytest

import starrocks_tpu_torch.sql.distributed as D
from starrocks_tpu_torch.runtime import failpoint
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.metrics import Histogram
from starrocks_tpu_torch.runtime.profile import (
    PROFILE_MANAGER, ProfileManager, trace_json)
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog

from starrocks_tpu_torch.storage.tpch_queries import QUERIES


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


JOIN_AGG = ("select t.a, sum(t.b) sb from t join u on t.a = u.a "
            "group by t.a order by t.a")


def _small_sess():
    s = Session()
    s.sql("create table t (a int, b int)")
    s.sql("insert into t values (1,2),(1,3),(2,4),(3,5),(2,6)")
    s.sql("create table u (a int, c int)")
    s.sql("insert into u values (1,10),(1,11),(2,20)")
    return s


def _ann(out: str, node: str) -> dict:
    """Parse the [#o est=.. rows=.. cap=..] annotation off a node line."""
    m = re.search(rf"{node}\[[^\n]*\[#(\d+)([^\]]*)\]", out)
    assert m, f"no annotation on {node} in:\n{out}"
    d = {"ord": int(m.group(1))}
    for k, v in re.findall(r"(est|rows|cap)=(\d+)", m.group(2)):
        d[k] = int(v)
    return d


# --- per-operator attribution -------------------------------------------------


def test_explain_analyze_monolithic_observed_rows():
    s = _small_sess()
    base = s.sql(JOIN_AGG).rows()
    out = s.sql("explain analyze " + JOIN_AGG)
    # join true cardinality: a=1 (2x2) + a=2 (2x1) = 6; agg groups = 2
    j = _ann(out, "Join")
    assert j["rows"] == 6 and j["cap"] >= 6
    a = _ann(out, "Agg")
    assert a["rows"] == len(base) == 2
    assert "est=" in out
    # the annotation's observed rows are the same channel the plan-feedback
    # store learns from: the recorded capacity for the join key covers the
    # observed count
    fb = list(s.cache.feedback._entries.values())
    caps = [c for e in fb for c in e["caps"].get("local", {}).items()]
    jc = {k: v for k, v in caps if k.startswith("join_")}
    assert jc and all(v >= 6 for v in jc.values())
    # EXPLAIN ANALYZE executed the real query; result rows unperturbed
    assert s.sql(JOIN_AGG).rows() == base


def test_explain_analyze_counter_groups():
    s = _small_sess()
    out = s.sql("explain analyze " + JOIN_AGG)
    # per-operator counter group renders on the annotated tree and the
    # profile's op# lines agree with the flattened legacy counters
    assert re.search(r"op#\d+ join rows=6", out)


@pytest.fixture(scope="module")
def dist_sess(eight_devices):
    old = D.SHARD_THRESHOLD_ROWS
    old_sh = D.SHUFFLE_AGG_MIN_GROUPS
    D.SHARD_THRESHOLD_ROWS = 10_000
    D.SHUFFLE_AGG_MIN_GROUPS = 4_000
    yield Session(tpch_catalog(sf=0.01), dist_shards=8)
    D.SHARD_THRESHOLD_ROWS = old
    D.SHUFFLE_AGG_MIN_GROUPS = old_sh


def test_explain_analyze_fragment_path_q5(dist_sess):
    """TPC-H q5 (join+agg) annotated on BOTH dist paths: the monolithic
    SPMD program and the fragment IR path produce byte-identical result
    rows and both attribute observed rows per operator."""
    s = dist_sess
    q5 = QUERIES[5]
    outs, rows = {}, {}
    for frag in (False, True):
        config.set("dist_fragments", frag)
        try:
            rows[frag] = s.sql(q5).rows()
            outs[frag] = s.sql("explain analyze " + q5)
        finally:
            config.set("dist_fragments", True)
    assert rows[False] == rows[True]  # byte-identity across paths
    for frag, out in outs.items():
        a = _ann(out, "Agg")
        assert a["rows"] == len(rows[frag]), f"frag={frag}:\n{out}"
        assert re.search(r"Join\[[^\n]*rows=\d+", out), f"frag={frag}"
        assert "ctrs{" in out, f"frag={frag}: no counter groups"
    # fragment run carries per-fragment timings in the profile tail
    assert re.search(r"fragment_\d+_(compile|execute)", outs[True])


# --- ProfileManager retention -------------------------------------------------


def _entry(qid, ms=1, sql="select 1", state="done"):
    return dict(qid=qid, user="root", sql=sql, state=state, ms=ms,
                rows=0, queue_wait_ms=0, stage="executor::fetch_results",
                profile=None)


def test_profile_manager_retention_and_lru():
    pm = ProfileManager()
    config.set("profile_history_size", 4)
    try:
        for q in range(1, 8):
            pm.register(**_entry(q))
        assert pm.stats()["entries"] == 4
        assert [e["query_id"] for e in pm.snapshot()] == [4, 5, 6, 7]
        # get() is an LRU touch: qid 4 survives the next eviction, 5 goes
        assert pm.get(4)["query_id"] == 4
        pm.register(**_entry(8))
        got = [e["query_id"] for e in pm.snapshot()]
        assert 4 in got and 5 not in got
        assert pm.get(5) is None
    finally:
        config.set("profile_history_size", 64)


def test_profile_manager_bytes_budget():
    pm = ProfileManager()
    config.set("profile_history_bytes", 4096)
    try:
        big = "select '" + "x" * 2000 + "'"
        for q in range(1, 6):
            pm.register(**_entry(q, sql=big))
        st = pm.stats()
        assert st["bytes"] <= 4096 and st["entries"] >= 1
    finally:
        config.set("profile_history_bytes", 8 << 20)


def test_profile_manager_slow_ring():
    pm = ProfileManager()
    config.set("slow_query_ms", 100)
    config.set("profile_history_size", 2)
    try:
        pm.register(**_entry(1, ms=500))   # slow
        pm.register(**_entry(2, ms=1))
        pm.register(**_entry(3, ms=1))
        pm.register(**_entry(4, ms=1))     # 1 evicted from history
        e = pm.get(1)                      # ...but the slow ring kept it
        assert e is not None and e["slow"] is True
        assert pm.get(2) is None           # fast + evicted = gone
        # ring itself is bounded
        for q in range(10, 10 + 2 * ProfileManager.SLOW_RING):
            pm.register(**_entry(q, ms=500))
        assert pm.stats()["slow"] <= ProfileManager.SLOW_RING
    finally:
        config.set("slow_query_ms", 0)
        config.set("profile_history_size", 64)


def test_slow_query_flag_in_query_log():
    s = _small_sess()
    config.set("slow_query_ms", 1)  # everything counts as slow
    try:
        s.sql("select a from t")
        r = s.sql("select query_id, slow from information_schema.query_log "
                  "where statement like '%from t%' and slow = 1")
        assert r.rows(), "slow flag never set in query_log"
        qid = r.rows()[-1][0]
        assert qid > 0
        assert PROFILE_MANAGER.get(qid)["slow"] is True
    finally:
        config.set("slow_query_ms", 0)


# --- histogram math + exposition ----------------------------------------------


def test_histogram_bucket_math_and_exposition_golden():
    h = Histogram("sr_tpu_unit_test_ms", "unit test", buckets=(1, 10, 100))
    for v in (0.5, 1.0, 5, 50, 500):
        h.observe(v)
    counts, s, n = h.snapshot()
    # 0.5 and 1.0 land in le=1 (inclusive upper bound), 5 in le=10,
    # 50 in le=100, 500 in +Inf
    assert counts == [2, 1, 1, 1] and n == 5 and s == 556.5
    golden = [
        "# HELP sr_tpu_unit_test_ms unit test",
        "# TYPE sr_tpu_unit_test_ms histogram",
        'sr_tpu_unit_test_ms_bucket{le="1"} 2',
        'sr_tpu_unit_test_ms_bucket{le="10"} 3',
        'sr_tpu_unit_test_ms_bucket{le="100"} 4',
        'sr_tpu_unit_test_ms_bucket{le="+Inf"} 5',
        "sr_tpu_unit_test_ms_sum 556.5",
        "sr_tpu_unit_test_ms_count 5",
    ]
    assert h.render() == golden
    # percentile interpolates within the owning bucket; +Inf clamps
    assert 0 < h.percentile(0.5) <= 10
    assert h.percentile(0.99) == 100  # clamped to largest finite bound
    assert Histogram("sr_tpu_unit_empty").percentile(0.5) == 0.0


def test_latency_histograms_observe_by_statement_class():
    from starrocks_tpu_torch.runtime.lifecycle import (
        LATENCY_DML_MS, LATENCY_READ_MS)

    r0, d0 = LATENCY_READ_MS.value, LATENCY_DML_MS.value
    s = _small_sess()  # DDL + DML
    s.sql("select a from t")
    assert LATENCY_READ_MS.value > r0
    assert LATENCY_DML_MS.value > d0
    from starrocks_tpu_torch.runtime.metrics import metrics

    text = metrics.render_prometheus()
    for fam in ("sr_tpu_query_latency_ms_read", "sr_tpu_compile_ms"):
        assert f"# TYPE {fam} histogram" in text
        assert f'{fam}_bucket{{le="+Inf"}}' in text
        assert f"{fam}_sum" in text and f"{fam}_count" in text


# --- trace export -------------------------------------------------------------


def test_trace_export_schema():
    s = _small_sess()
    s.sql("select a, sum(b) sb from t group by a")
    qid = s.sql("select max(query_id) from information_schema.query_log"
                ).rows()[0][0]
    e = PROFILE_MANAGER.get(qid)
    assert e is not None
    tr = trace_json(e)
    assert set(tr) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert tr["displayTimeUnit"] == "ms"
    evs = tr["traceEvents"]
    assert evs, "no trace events for an executed query"
    names = {ev["name"] for ev in evs}
    # the full lifecycle is visible: parse -> analyze -> optimize ->
    # compile -> fetch
    for stage in ("parse", "analyze", "optimize", "compile_and_run",
                  "fetch_results"):
        assert stage in names, f"{stage} missing from {names}"
    last = 0.0
    for ev in evs:
        assert ev["ph"] == "X" and ev["dur"] >= 0
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert ev["ts"] >= last  # sorted for the viewer
        last = ev["ts"]


def test_trace_synthesizes_admission_wait():
    e = {"query_id": 7, "sql": "select 1", "state": "done", "ms": 12,
         "queue_wait_ms": 5, "user": "root",
         "profile": {"name": "query", "spans": [["parse", 1000.0, 0.001]],
                     "counters": {}, "infos": {}, "children": []}}
    tr = trace_json(e)
    names = [ev["name"] for ev in tr["traceEvents"]]
    assert names[0] == "admission_wait"
    assert tr["traceEvents"][0]["dur"] == pytest.approx(5000)  # us


# --- failure paths ------------------------------------------------------------


def test_killed_query_profile_reports_failed_stage():
    s = _small_sess()
    with failpoint.scoped("executor::before_run"):
        with pytest.raises(failpoint.FailPointError):
            s.sql("select a, sum(b) q from t group by a")
    qid = s.sql("select max(query_id) from information_schema.query_log"
                ).rows()[0][0]
    e = PROFILE_MANAGER.get(qid)
    # wire rows for the SQL above succeed (the SELECT on query_log bumps
    # qid by one — the failed query is the one before it)
    if e is None or e["state"] != "error":
        e = PROFILE_MANAGER.get(qid - 1)
    assert e is not None and e["state"] == "error"
    assert e["stage"], "failed query retained no stage"


def test_chaos_profile_store_zero_leak():
    """Mid-execute failures must not grow the profile store past its
    bounds or corrupt its byte accounting — the chaos invariant."""
    s = _small_sess()
    config.set("profile_history_size", 8)
    try:
        for i in range(12):
            with failpoint.scoped("executor::before_run"):
                with pytest.raises(failpoint.FailPointError):
                    s.sql(f"select a + {i} from t")
        st = PROFILE_MANAGER.stats()
        assert st["entries"] <= 8
        assert st["slow"] <= ProfileManager.SLOW_RING
        # byte accounting stays consistent with the retained entries
        with PROFILE_MANAGER._lock:
            real = sum(e["_bytes"] for e in PROFILE_MANAGER._entries.values())
            assert real == PROFILE_MANAGER._bytes
    finally:
        config.set("profile_history_size", 64)


# --- SQL surfaces -------------------------------------------------------------


def test_show_profile_for_query_and_info_schema():
    s = _small_sess()
    s.sql("select a, sum(b) sp from t group by a")
    qid = s.sql("select max(query_id) from information_schema.query_profiles"
                ).rows()[0][0]
    out = s.sql(f"show profile for query {qid - 1}")
    assert f"query {qid - 1} " in out
    r = s.sql("select query_id, state, ms from "
              "information_schema.query_profiles")
    assert any(row[0] == qid for row in r.rows())
    assert s.sql("show profile for query 999999").startswith("no profile")
