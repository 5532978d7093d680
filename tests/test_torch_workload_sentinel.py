"""Port counterpart of tests/test_workload_sentinel.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). Workload intelligence plane (round 19): per-fingerprint workload
aggregator, plan-regression sentinel, declarative alert rules, and the
stuck-query watchdog (reference behavior: FE big-query-log / workload
analysis, the history-based plan manager's regression demotion, and
metric-driven alerting — SURVEY §1/§5).

The contracts under test:

- the workload aggregator folds every terminal statement into bounded
  (fingerprint, class) rolling shapes with identical rows through all
  three surfaces (SHOW WORKLOAD, information_schema.workload_summary,
  GET /api/workload);
- the sentinel's full round trip: baseline -> token move -> sustained
  regression -> FeedbackStore quarantine (+ plan_regression event,
  consult() answering None, record() refusing) -> recovery -> re-
  admission with the poisoned entry dropped; and the executor linkage
  (quarantined fingerprints plan estimate-driven on a live session);
- alert fire/resolve hysteresis under a fake clock: for_s continuity,
  undecidable samples clearing pending fires, ratio min_denom gating,
  histogram-percentile references, and the ADMIN SET alert surface;
- the watchdog flags wedged queries exactly once per (query, stage),
  never flags young/healthy ones, and prunes finished state;
- the event taxonomy closed over the four new names;
- the OTLP/JSON export is byte-stable (golden fixture) and live on
  GET /api/query/{id}/otel.
"""

import json
import urllib.request

import pytest

from starrocks_tpu_torch.runtime import lifecycle
from starrocks_tpu_torch.runtime.alerts import ALERTS, DEFAULT_RULES, AlertEngine
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.events import EVENTS, TAXONOMY
from starrocks_tpu_torch.runtime.feedback import FEEDBACK_QUARANTINED, FeedbackStore
from starrocks_tpu_torch.runtime.profile import PROFILE_MANAGER, otel_json
from starrocks_tpu_torch.runtime.sentinel import SENTINEL
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.runtime.watchdog import WATCHDOG, StuckQueryWatchdog
from starrocks_tpu_torch.runtime.workload import WORKLOAD, sql_shape


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


_KNOBS = ("enable_workload_stats", "workload_max_entries",
          "enable_plan_sentinel", "sentinel_min_baseline",
          "sentinel_confirm", "sentinel_readmit", "sentinel_band",
          "enable_alerts", "enable_watchdog", "enable_query_cache",
          "plan_feedback")


@pytest.fixture(autouse=True)
def _restore_round19_state():
    before = {k: config.get(k) for k in _KNOBS}
    yield
    for k, v in before.items():
        config.set(k, v)
    SENTINEL.clear()
    ALERTS.reset()
    WATCHDOG.clear()


class _Ctx:
    """Terminal-shaped context for driving the aggregator/sentinel
    directly (the audit-test idiom: real queries would dominate the
    runtime of bound/eviction/regression cases)."""

    def __init__(self, qid=1, sql="select 1", stmt_class="read",
                 state="done", ms=1, rows=1, fb_fp=None, fb_token=None,
                 fb_store=None):
        self.qid = qid
        self.profile = None
        self.stmt_class = stmt_class
        self.sql = sql
        self.user = "root"
        self.tables = ()
        self.state = state
        self.last_stage = "fetch_results"
        self.queue_wait_ms = 0
        self.rows = rows
        self.mem_peak = 0
        self.degraded = False
        self._ms = ms
        if fb_fp is not None:
            self.fb_fp = fb_fp
            self.fb_token = fb_token
            self.fb_store = fb_store

    def elapsed_ms(self):
        return self._ms

    def cancel_reason(self):
        return None


# --- workload aggregator -----------------------------------------------------


def test_sql_shape_scrubs_literals():
    a = sql_shape("SELECT a FROM t WHERE a > 5 AND s = 'x'")
    b = sql_shape("select  a from t\nwhere a > 99 and s = 'other'")
    assert a == b == "select a from t where a > ? and s = ?"


def test_workload_folds_repeats_into_one_shape():
    WORKLOAD.clear()
    for i in range(5):
        WORKLOAD.record_query(_Ctx(
            qid=i, sql=f"select a from t where a > {i}", ms=10 + i,
            rows=2))
    WORKLOAD.record_query(_Ctx(qid=9, sql="select 1", state="error"))
    rows = WORKLOAD.snapshot()
    assert len(rows) == 2  # heaviest first
    top = rows[0]
    assert top["count"] == 5 and top["stmt_class"] == "read"
    assert top["fingerprint"].startswith("sql:")
    assert top["avg_rows"] == 2.0 and top["errors"] == 0
    assert top["p50_ms"] > 0 and top["p99_ms"] >= top["p50_ms"]
    assert top["sample_sql"] == "select a from t where a > 4"
    assert rows[1]["errors"] == 1
    st = WORKLOAD.stats()
    assert st["entries"] == 2 and st["registered"] == 6


def test_workload_entries_hard_bounded_lru():
    WORKLOAD.clear()
    config.set("workload_max_entries", 4)
    try:
        for i in range(10):
            WORKLOAD.record_query(_Ctx(qid=i, sql=f"select {i} as c{i}"))
        st = WORKLOAD.stats()
        assert st["entries"] == 4 and st["evicted"] == 6
        # least-recently-updated evicted first: the survivors are the tail
        shapes = {r["sample_sql"] for r in WORKLOAD.snapshot()}
        assert shapes == {f"select {i} as c{i}" for i in range(6, 10)}
    finally:
        config.set("workload_max_entries", 512)


def test_workload_pending_bounded_without_readers():
    WORKLOAD.clear()
    config.set("workload_max_entries", 2)
    try:
        for i in range(100):  # never read between records
            WORKLOAD.record_query(_Ctx(qid=i, sql=f"select {i} x{i}"))
        assert len(WORKLOAD._pending) <= 8  # cap * 4
        assert WORKLOAD.stats()["entries"] <= 2
    finally:
        config.set("workload_max_entries", 512)


def test_workload_class_p99_feeds_watchdog():
    WORKLOAD.clear()
    for i in range(30):
        WORKLOAD.record_query(_Ctx(qid=i, sql="select a from t", ms=10))
    p99, n = WORKLOAD.class_p99("read")
    assert n == 30 and p99 > 0
    assert WORKLOAD.class_p99("no_such_class") == (0.0, 0)


def test_workload_disabled_records_nothing():
    WORKLOAD.clear()
    config.set("enable_workload_stats", False)
    try:
        WORKLOAD.record_query(_Ctx())
        assert WORKLOAD.stats()["registered"] == 0
    finally:
        config.set("enable_workload_stats", True)


def test_show_workload_info_schema_parity():
    WORKLOAD.clear()
    s = Session()
    s.sql("create table wt (a int, b int)")
    s.sql("insert into wt values (1, 2), (2, 3)")
    for _ in range(3):
        s.sql("select b, sum(a) sa from wt group by b")
    shown = s.sql("show workload")
    assert shown and all(len(t) == 21 for t in shown)
    by_key = {(r["fingerprint"], r["stmt_class"]): r
              for r in WORKLOAD.snapshot()}
    matched = 0
    for t in shown:
        r = by_key.get((t[0], t[1]))
        if r is not None and r["count"] == t[2]:
            assert tuple(r.values()) == t
            matched += 1
    assert matched >= len(shown) - 1  # SHOW itself lands a new record
    got = s.sql("select * from information_schema.workload_summary").rows()
    assert got and len(got[0]) == 21
    assert {g[0] for g in got} >= {t[0] for t in shown}


def test_workload_http_surface_parity():
    WORKLOAD.clear()
    from starrocks_tpu_torch.runtime.http_service import SqlHttpServer

    srv = SqlHttpServer(Session()).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/query",
            data=json.dumps({"sql": "select 1"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/api/workload",
                timeout=10) as r:
            wl = json.loads(r.read().decode())
    finally:
        srv.stop()
    assert isinstance(wl["workload"], list) and wl["workload"]
    local = WORKLOAD.snapshot()
    assert set(wl["workload"][0]) == set(local[0])
    assert {e["fingerprint"] for e in wl["workload"]} \
        == {e["fingerprint"] for e in local}


# --- plan-regression sentinel ------------------------------------------------


def _observe(store, fp, token, ms, qid=1):
    SENTINEL.observe(_Ctx(qid=qid, ms=ms, fb_fp=fp, fb_token=token,
                          fb_store=store))


def test_sentinel_quarantine_and_readmission_round_trip():
    SENTINEL.clear()
    config.set("sentinel_min_baseline", 3)
    config.set("sentinel_confirm", 2)
    config.set("sentinel_readmit", 2)
    store = FeedbackStore()
    fp = "fp-roundtrip"
    n_reg = EVENTS.stats().get("plan_regression", 0)
    for i in range(4):  # baseline under token 1
        _observe(store, fp, 1, 10, qid=i)
    # token moved (the feedback-driven plan changed) and latency blew up
    _observe(store, fp, 2, 100, qid=10)
    assert not store.is_quarantined(fp)  # one bad obs is not a verdict
    _observe(store, fp, 2, 100, qid=11)
    assert store.is_quarantined(fp)
    assert EVENTS.stats().get("plan_regression", 0) == n_reg + 1
    ev = [e for e in EVENTS.snapshot()
          if e["name"] == "plan_regression"][-1]
    assert ev["detail"]["qid"] == 11
    assert ev["detail"]["observed_ms"] == 100.0
    # quarantined: consult answers None (estimate-driven planning) and
    # record refuses to keep learning on the poisoned entry
    nq = FEEDBACK_QUARANTINED.value
    assert store.consult(fp, None) is None
    assert FEEDBACK_QUARANTINED.value == nq + 1
    assert store.quarantined()[fp]["baseline_ms"] == pytest.approx(10.0)
    snap = {e["fingerprint"]: e for e in SENTINEL.snapshot()}
    assert snap[fp]["quarantined"] is True
    # recovery: consecutive runs back at the quarantined baseline
    _observe(store, fp, None, 11, qid=12)
    assert store.is_quarantined(fp)  # one good obs is not recovery
    _observe(store, fp, None, 11, qid=13)
    assert not store.is_quarantined(fp)  # readmitted, learning restarts
    assert store.stats()["quarantined"] == 0
    snap = {e["fingerprint"]: e for e in SENTINEL.snapshot()}
    assert snap[fp]["quarantined"] is False and snap[fp]["n"] == 1


def test_sentinel_bad_recovery_obs_resets_progress():
    SENTINEL.clear()
    config.set("sentinel_confirm", 1)
    config.set("sentinel_readmit", 2)
    store = FeedbackStore()
    fp = "fp-relapse"
    for i in range(3):
        _observe(store, fp, 1, 10, qid=i)
    _observe(store, fp, 2, 200, qid=5)
    assert store.is_quarantined(fp)
    _observe(store, fp, None, 11, qid=6)   # recov = 1
    _observe(store, fp, None, 200, qid=7)  # relapse: recov resets
    _observe(store, fp, None, 11, qid=8)   # recov = 1 again
    assert store.is_quarantined(fp)


def test_sentinel_benign_token_move_adopts_baseline():
    SENTINEL.clear()
    config.set("sentinel_min_baseline", 3)
    store = FeedbackStore()
    fp = "fp-benign"
    for i in range(3):
        _observe(store, fp, 1, 10, qid=i)
    _observe(store, fp, 2, 11, qid=5)  # moved, but within the band
    assert not store.is_quarantined(fp)
    snap = {e["fingerprint"]: e for e in SENTINEL.snapshot()}
    assert snap[fp]["token"] == 2 and snap[fp]["watching"] is False


def test_sentinel_thin_baseline_never_judges():
    SENTINEL.clear()
    config.set("sentinel_min_baseline", 5)
    config.set("sentinel_confirm", 1)
    store = FeedbackStore()
    fp = "fp-thin"
    _observe(store, fp, 1, 10, qid=1)
    _observe(store, fp, 2, 500, qid=2)  # 1 obs is no baseline
    assert not store.is_quarantined(fp)


def test_sentinel_ignores_non_terminal_and_errored_runs():
    SENTINEL.clear()
    store = FeedbackStore()
    SENTINEL.observe(_Ctx(state="error", ms=999, fb_fp="fp-err",
                          fb_token=1, fb_store=store))
    SENTINEL.observe(_Ctx(state="done", ms=5))  # no consult coordinates
    assert SENTINEL.snapshot() == []


def test_sentinel_executor_linkage_estimate_driven_fallback(tmp_path):
    """Live-session half of the round trip: a real query lands a sentinel
    baseline through the terminal hook, and quarantining its fingerprint
    makes the executor plan estimate-driven (consult answers None, no
    feedback_hits) while results stay correct."""
    SENTINEL.clear()
    config.set("enable_query_cache", False)  # repeats must reach consult
    s = Session(data_dir=str(tmp_path / "db"))
    s.sql("create table la (k bigint, v bigint)")
    s.sql("create table lb (k bigint, w bigint)")
    s.sql("insert into la values (1, 10), (2, 20), (1, 30)")
    s.sql("insert into lb values (1, 1), (2, 2)")
    q = ("select count(*) c, sum(la.v + lb.w) s from la join lb "
         "on la.k = lb.k")
    r1 = s.sql(q).rows()
    fps = [e["fingerprint"] for e in SENTINEL.snapshot()]
    assert len(fps) == 1, "one consult fingerprint must reach the sentinel"
    fp = fps[0]
    s.sql(q)
    assert {e["fingerprint"]: e for e in SENTINEL.snapshot()}[fp]["n"] == 2

    store = s.cache.feedback
    store.quarantine(fp, 10_000_000.0)  # sidecar-inherited quarantine
    nq = FEEDBACK_QUARANTINED.value
    r2 = s.sql(q)
    assert r2.rows() == r1
    assert FEEDBACK_QUARANTINED.value > nq, \
        "quarantined consult must answer None (estimate-driven plan)"
    prof = s.last_profile
    assert prof.counters.get("feedback_hits", (0, ""))[0] == 0
    # fresh observations at the (huge) baseline re-admit the fingerprint
    s.sql(q)
    s.sql(q)
    assert not store.is_quarantined(fp)


# --- alert rules -------------------------------------------------------------


def _sample(counters=None, gauges=None, hists=None):
    return {"ts": 0.0, "counters": counters or {},
            "gauges": gauges or {}, "histograms": hists or {}}


def test_alert_fire_resolve_hysteresis_fake_clock():
    eng = AlertEngine()
    eng.set_rule("g1_high", {"metric": "g1", "op": ">", "threshold": 5,
                             "for_s": 10, "resolve_s": 10})
    n_fire = EVENTS.stats().get("alert_fire", 0)
    n_res = EVENTS.stats().get("alert_resolve", 0)
    hot = _sample(gauges={"g1": 10})
    cold = _sample(gauges={"g1": 0})
    eng.evaluate(hot, now=1000.0)
    eng.evaluate(hot, now=1005.0)
    state = {r["name"]: r for r in eng.snapshot()}
    assert state["g1_high"]["state"] == "ok"  # for_s not yet continuous
    eng.evaluate(hot, now=1010.0)
    state = {r["name"]: r for r in eng.snapshot()}
    assert state["g1_high"]["state"] == "firing"
    assert state["g1_high"]["fired_ts"] == 1010.0
    assert state["g1_high"]["value"] == 10.0
    assert EVENTS.stats().get("alert_fire", 0) == n_fire + 1
    # condition clears: resolve needs resolve_s of continuous quiet
    eng.evaluate(cold, now=1012.0)
    assert {r["name"]: r for r in eng.snapshot()}["g1_high"]["state"] \
        == "firing"
    eng.evaluate(cold, now=1022.0)
    state = {r["name"]: r for r in eng.snapshot()}
    assert state["g1_high"]["state"] == "ok"
    assert state["g1_high"]["fires"] == 1
    assert EVENTS.stats().get("alert_resolve", 0) == n_res + 1
    # flapping below for_s never fires again
    eng.evaluate(hot, now=1030.0)
    eng.evaluate(cold, now=1035.0)
    eng.evaluate(hot, now=1040.0)
    assert {r["name"]: r for r in eng.snapshot()}["g1_high"]["fires"] == 1
    assert EVENTS.stats().get("alert_fire", 0) == n_fire + 1


def test_alert_undecidable_sample_clears_pending_fire():
    eng = AlertEngine()
    eng.set_rule("g2_high", {"metric": "g2", "op": ">", "threshold": 5,
                             "for_s": 5})
    eng.evaluate(_sample(gauges={"g2": 10}), now=100.0)
    eng.evaluate(_sample(), now=104.0)  # metric vanished: undecidable
    eng.evaluate(_sample(gauges={"g2": 10}), now=106.0)
    state = {r["name"]: r for r in eng.snapshot()}
    assert state["g2_high"]["state"] == "ok", \
        "hysteresis must demand CONTINUOUS signal, not cumulative"


def test_alert_ratio_rule_min_denom_gate():
    eng = AlertEngine()
    eng.set_rule("err_rate", {"metric": "c_err", "denom": "c_tot",
                              "min_denom": 5, "op": ">",
                              "threshold": 0.5, "for_s": 0})
    eng.evaluate(_sample(counters={"c_err": 1, "c_tot": 1}), now=1.0)
    assert {r["name"]: r for r in eng.snapshot()}["err_rate"]["state"] \
        == "ok", "1 error / 1 statement must not fire a RATE alert"
    eng.evaluate(_sample(counters={"c_err": 4, "c_tot": 6}), now=2.0)
    state = {r["name"]: r for r in eng.snapshot()}
    assert state["err_rate"]["state"] == "firing"
    assert state["err_rate"]["value"] == pytest.approx(4 / 6)


def test_alert_histogram_percentile_reference():
    eng = AlertEngine()
    eng.set_rule("slow_p99", {"metric": "h1:p99", "op": ">",
                              "threshold": 100, "for_s": 0})
    eng.evaluate(_sample(
        hists={"h1": {"p50": 1, "p95": 2, "p99": 500, "count": 9}}),
        now=1.0)
    assert {r["name"]: r for r in eng.snapshot()}["slow_p99"]["state"] \
        == "firing"


def test_alert_default_rules_and_spec_validation():
    assert set(DEFAULT_RULES) <= {r["name"] for r in ALERTS.snapshot()}
    # every default rule watches a metric the registry actually declares
    from starrocks_tpu_torch.runtime import cluster, lifecycle as _lc  # noqa: F401
    from starrocks_tpu_torch.runtime.metrics import metrics

    text = metrics.render_prometheus()
    for spec in DEFAULT_RULES.values():
        assert spec["metric"] in text, spec["metric"]
        if "denom" in spec:
            assert spec["denom"] in text
    eng = AlertEngine()
    with pytest.raises(ValueError, match="threshold"):
        eng.set_rule("bad", {"metric": "m"})
    with pytest.raises(ValueError, match="op"):
        eng.set_rule("bad", {"metric": "m", "op": "!=", "threshold": 1})


def test_admin_set_alert_sql_surface():
    s = Session()
    spec = ('{"metric": "sr_tpu_admission_queued", "op": ">", '
            '"threshold": 1, "for_s": 0}')
    s.sql(f"admin set alert 'probe_rule' = '{spec}'")
    got = s.sql("select name, state, metric from "
                "information_schema.alerts").rows()
    by_name = {g[0]: g for g in got}
    assert by_name["probe_rule"][1] == "ok"
    assert by_name["probe_rule"][2] == "sr_tpu_admission_queued"
    s.sql("admin set alert 'probe_rule' = 'off'")
    assert "probe_rule" not in {r["name"] for r in ALERTS.snapshot()}
    with pytest.raises(ValueError, match="alert spec"):
        s.sql("admin set alert 'broken' = 'not json'")


def test_admin_set_alert_requires_admin():
    s = Session()
    s.sql("create user 'wanda' identified by 'pw'")
    s2 = Session(catalog=s.catalog, cache=s.cache)
    s2.current_user = "wanda"
    with pytest.raises(PermissionError):
        s2.sql("admin set alert 'x' = 'off'")


# --- stuck-query watchdog ----------------------------------------------------


class _FakeRegistry:
    def __init__(self):
        self.rows = []

    def snapshot(self):
        return list(self.rows)


def _wd_row(qid, elapsed_ms, stage, sql="select a from t",
            state="running"):
    return (qid, "root", state, elapsed_ms, "default", 0, stage, sql)


def test_watchdog_stage_wedge_flags_once(monkeypatch):
    wd = StuckQueryWatchdog()
    reg = _FakeRegistry()
    monkeypatch.setattr(lifecycle, "REGISTRY", reg)
    n0 = EVENTS.stats().get("query_stuck", 0)
    reg.rows = [_wd_row(1, 5000, "executor::run")]
    assert wd.scan(now=100.0) == []  # first sight starts the stage timer
    assert wd.scan(now=120.0) == []  # under the 30s budget
    got = wd.scan(now=140.0)
    assert got == [(1, "executor::run", "stage_wedged")]
    assert EVENTS.stats().get("query_stuck", 0) == n0 + 1
    ev = [e for e in EVENTS.snapshot() if e["name"] == "query_stuck"][-1]
    assert ev["detail"]["reason"] == "stage_wedged"
    assert wd.scan(now=200.0) == []  # once per (query, stage)
    # stage advanced: the timer restarts, no immediate re-flag
    reg.rows = [_wd_row(1, 9000, "executor::fetch_results")]
    assert wd.scan(now=201.0) == []
    got = wd.scan(now=240.0)
    assert got == [(1, "executor::fetch_results", "stage_wedged")]


def test_watchdog_class_p99_trigger_and_guards(monkeypatch):
    WORKLOAD.clear()
    wd = StuckQueryWatchdog()
    reg = _FakeRegistry()
    monkeypatch.setattr(lifecycle, "REGISTRY", reg)
    for i in range(25):  # warm the read class past watchdog_min_class_obs
        WORKLOAD.record_query(_Ctx(qid=i, sql="select a from t", ms=10))
    reg.rows = [
        _wd_row(1, 500_000, "executor::run"),           # way past 10x p99
        _wd_row(2, 500, "executor::run"),               # under min_ms
        _wd_row(3, 500_000, "executor::run",
                sql="insert into t values (1)"),        # cold dml class
        _wd_row(4, 500_000, "executor::run", state="queued"),
    ]
    got = wd.scan(now=10.0)
    assert got == [(1, "executor::run", "class_p99")]
    assert wd.stats()["flagged"] == 1
    # finished queries free their tracking state
    reg.rows = []
    wd.scan(now=11.0)
    assert wd.stats() == {"tracked": 0, "flagged": 0, "running": False}


def test_watchdog_zero_false_positives_on_healthy_traffic(monkeypatch):
    WORKLOAD.clear()
    wd = StuckQueryWatchdog()
    reg = _FakeRegistry()
    monkeypatch.setattr(lifecycle, "REGISTRY", reg)
    for i in range(50):
        WORKLOAD.record_query(_Ctx(qid=i, sql="select a from t", ms=20))
    now = 0.0
    for tick in range(10):  # queries churn faster than any budget
        reg.rows = [_wd_row(100 + tick, 2000, f"stage{tick % 3}")]
        assert wd.scan(now=now) == []
        now += 5.0
    assert wd.stats()["flagged"] == 0


# --- taxonomy ----------------------------------------------------------------


def test_taxonomy_closed_over_round19_events():
    assert {"plan_regression", "query_stuck", "alert_fire",
            "alert_resolve"} <= TAXONOMY
    with pytest.raises(ValueError, match="closed taxonomy"):
        from starrocks_tpu_torch.runtime.events import emit

        emit("alert_flap", x=1)


# --- OTLP trace export -------------------------------------------------------

_OTEL_ENTRY = {
    "query_id": 7, "user": "root", "sql": "select 1", "state": "done",
    "ms": 3, "queue_wait_ms": 1.0, "stage": "fetch_results", "rows": 1,
    "profile": {"name": "query", "spans": [["parse", 0.001, 0.002]],
                "children": []},
}

# ids are sha256("sr_tpu_query:7") / sha256("sr_tpu_span:7:{root,0,1}")
# prefixes — deterministic, so the whole document is a golden fixture
_OTEL_GOLDEN = {"resourceSpans": [{
    "resource": {"attributes": [
        {"key": "service.name",
         "value": {"stringValue": "starrocks_tpu"}},
        {"key": "telemetry.sdk.name",
         "value": {"stringValue": "starrocks_tpu.profile"}},
    ]},
    "scopeSpans": [{
        "scope": {"name": "starrocks_tpu.profile", "version": "1"},
        "spans": [
            {"traceId": "baeaa776a4a0877d645b257e2f247456",
             "spanId": "344a0deb3bbf8d44", "parentSpanId": "",
             "name": "query", "kind": 2,
             "startTimeUnixNano": "0", "endTimeUnixNano": "3000000",
             "attributes": [
                 {"key": "db.system",
                  "value": {"stringValue": "starrocks_tpu"}},
                 {"key": "db.statement",
                  "value": {"stringValue": "select 1"}},
                 {"key": "db.user", "value": {"stringValue": "root"}},
                 {"key": "sr_tpu.query_id", "value": {"intValue": "7"}},
                 {"key": "sr_tpu.state", "value": {"stringValue": "done"}},
                 {"key": "sr_tpu.rows", "value": {"intValue": "1"}},
                 {"key": "sr_tpu.queue_wait_ms",
                  "value": {"intValue": "1"}},
                 {"key": "sr_tpu.stage",
                  "value": {"stringValue": "fetch_results"}},
             ],
             "status": {"code": 1}},
            {"traceId": "baeaa776a4a0877d645b257e2f247456",
             "spanId": "fb94ececec367dbc",
             "parentSpanId": "344a0deb3bbf8d44",
             "name": "admission_wait", "kind": 1,
             "startTimeUnixNano": "0", "endTimeUnixNano": "1000000",
             "attributes": [{"key": "sr_tpu.phase_path",
                             "value": {"stringValue": "lifecycle"}}],
             "status": {"code": 0}},
            {"traceId": "baeaa776a4a0877d645b257e2f247456",
             "spanId": "d3a6b7f9e6571360",
             "parentSpanId": "344a0deb3bbf8d44",
             "name": "parse", "kind": 1,
             "startTimeUnixNano": "1000000",
             "endTimeUnixNano": "3000000",
             "attributes": [{"key": "sr_tpu.phase_path",
                             "value": {"stringValue": "query"}}],
             "status": {"code": 0}},
        ]}]}]}


def test_otel_export_golden_fixture():
    assert otel_json(dict(_OTEL_ENTRY)) == _OTEL_GOLDEN
    # byte-stable across calls (deterministic ids, no wall-clock reads)
    assert json.dumps(otel_json(dict(_OTEL_ENTRY)), sort_keys=True) \
        == json.dumps(otel_json(dict(_OTEL_ENTRY)), sort_keys=True)


def test_otel_export_error_status():
    entry = dict(_OTEL_ENTRY, state="cancelled")
    doc = otel_json(entry)
    root = doc["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    assert root["status"] == {"code": 2, "message": "cancelled"}


def test_otel_http_endpoint_live():
    from starrocks_tpu_torch.runtime.http_service import SqlHttpServer

    srv = SqlHttpServer(Session()).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/query",
            data=json.dumps(
                {"sql": "select 1 + 1 as two"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            json.loads(r.read())
        qid = PROFILE_MANAGER.snapshot()[-1]["query_id"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/api/query/{qid}/otel",
                timeout=10) as r:
            doc = json.loads(r.read().decode())
    finally:
        srv.stop()
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert spans[0]["kind"] == 2 and spans[0]["name"] == "query"
    assert spans[0]["status"] == {"code": 1}
    assert all(sp["traceId"] == spans[0]["traceId"] for sp in spans)
    assert all(sp["parentSpanId"] == spans[0]["spanId"]
               for sp in spans[1:])
