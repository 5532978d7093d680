"""The port's fault-tolerant cluster runtime: coordinator/worker fragment
scheduling over the host exchange plane (starrocks_tpu_torch/runtime/
cluster_exec.py) — the port's counterpart of tests/test_cluster_exec.py,
held to the same contract. The workers run on the CPU because the
coordinator's Session does: the device travels in the bootstrap payload.

What's under test, end to end with REAL worker processes:
  * a multi-fragment SQL query (hash exchange) scheduled across workers
    answers oracle-identical to the single-process engine, cold and warm;
  * DML between queries triggers version-based table re-sync;
  * SIGKILL of a worker MID-FRAGMENT -> the fragment is re-placed and the
    query still answers correctly within `cluster_fragment_retries`, the
    heartbeat plane journals `heartbeat_loss` and the dead-workers gauge
    rises;
  * a respawned worker reconnects: gauge decrements exactly once,
    `heartbeat_reconnect` journals once, registration (exchange addr)
    re-advertises;
  * a network partition (blackholed worker) times out and re-places;
  * losing EVERY worker exhausts retries into a typed WorkerLostError
    carrying worker id + fragment id, with no worker process or query
    scope left behind (the lost worker must never wedge a query or
    corrupt the coordinator).

The observability plane sees it too: the stock heartbeat_loss alert
fires on the dead-worker gauge and resolves after the respawn, and a
query lost with every worker leaves no admission slot, accountant byte or
registry entry behind and one `error` audit record.

Monitor-side unit tests (no subprocesses) drive the ALIVE->DEAD->ALIVE
round trip with a fake clock via ClusterMonitor._scan(now).

Every wait is bounded (socket timeouts, thread joins with a timeout).
"""

import os
import socket
import threading
import time

import pytest
import torch

import starrocks_tpu_torch.sql.distributed as D
from starrocks_tpu_torch.runtime import cluster_exec as CE
from starrocks_tpu_torch.runtime import lifecycle
from starrocks_tpu_torch.runtime.cluster import (
    ALIVE, DEAD, WORKERS_DEAD, ClusterMonitor,
)
from starrocks_tpu_torch.runtime.cluster_exec import (
    ClusterRuntime, WorkerLostError,
)
from starrocks_tpu_torch.runtime.alerts import ALERTS
from starrocks_tpu_torch.runtime.audit import AUDIT
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.events import EVENTS
from starrocks_tpu_torch.runtime.lifecycle import ACCOUNTANT, REGISTRY
from starrocks_tpu_torch.runtime.session import Session


def _gauge_alert_sample(v: float) -> dict:
    """History-ring-shaped sample for ALERTS.evaluate (gauges section)."""
    return {"gauges": {"sr_tpu_cluster_workers_dead": float(v)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in six processes on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The canonical 3-fragment query: scan+shuffle join, shuffled agg, topn.
SQL = ("select d.v, sum(t.b) s from t join d on t.a = d.k "
       "group by d.v order by s desc, d.v limit 5")


# ---------------------------------------------------------------------------
# wire protocol (no subprocesses)
# ---------------------------------------------------------------------------

def test_wire_roundtrip_small():
    a, b = socket.socketpair()
    try:
        a.settimeout(5)
        b.settimeout(5)
        CE._send_msg(a, {"type": "PING", "n": 3}, {"x": list(range(10))})
        hdr, payload = CE._recv_msg(b)
        assert hdr == {"type": "PING", "n": 3}
        assert payload == {"x": list(range(10))}
        # headers may ride with no payload frame at all
        CE._send_msg(b, {"type": "OK"})
        hdr2, payload2 = CE._recv_msg(a)
        assert hdr2 == {"type": "OK"} and payload2 is None
    finally:
        a.close()
        b.close()


def test_wire_roundtrip_chunked_large():
    """A payload bigger than the 1 MB send slice crosses intact (the
    chunked-send path that keeps big BOOTSTRAP frames from tripping the
    0.1 s poll timeout)."""
    a, b = socket.socketpair()
    blob = {"data": b"\xab" * (3 << 20)}
    got = {}

    def rx():
        b.settimeout(5)
        got["msg"] = CE._recv_msg(b)

    th = threading.Thread(target=rx)
    th.start()
    try:
        a.settimeout(0.1)  # force the send loop through its timeout ticks
        ticks = []
        CE._send_msg(a, {"type": "BOOTSTRAP"}, blob,
                     on_wait=lambda: ticks.append(1))
        th.join(timeout=10)
        assert not th.is_alive()
        hdr, payload = got["msg"]
        assert hdr["type"] == "BOOTSTRAP"
        assert payload["data"] == blob["data"]
    finally:
        a.close()
        b.close()


def test_worker_lost_error_fields():
    e = WorkerLostError("w3", 7, "connection refused")
    assert e.worker_id == "w3" and e.fid == 7
    assert "w3" in str(e) and "7" in str(e)


# ---------------------------------------------------------------------------
# monitor round trip with a fake clock (satellite: reconnect semantics)
# ---------------------------------------------------------------------------

def test_monitor_reconnect_fake_clock():
    """beat -> (clock jump) DEAD -> beat -> ALIVE: exactly one
    heartbeat_loss, exactly one heartbeat_reconnect, gauge decremented
    exactly once, registration preserved across the outage. interval_s=60
    parks the real watchdog thread so `_scan(now)` is the only clock."""
    mon = ClusterMonitor(port=0, interval_s=60.0, miss_limit=3,
                         bind_host="127.0.0.1")
    try:
        reg = {"addr": ["127.0.0.1", 4242], "fragments": [0, 2]}
        mon.beat("wA", reg)
        assert mon.members()["wA"]["state"] == ALIVE
        assert mon.registration("wA") == reg

        now = time.monotonic()
        loss0 = EVENTS.stats().get("heartbeat_loss", 0)
        mon._scan(now + 60.0 * 3 + 1)  # past interval_s * miss_limit
        assert mon.members()["wA"]["state"] == DEAD
        assert WORKERS_DEAD.value == 1
        assert EVENTS.stats().get("heartbeat_loss", 0) == loss0 + 1

        # a second scan while already DEAD must not double-journal
        mon._scan(now + 60.0 * 3 + 2)
        assert EVENTS.stats().get("heartbeat_loss", 0) == loss0 + 1
        assert WORKERS_DEAD.value == 1

        # reconnect: one beat flips DEAD->ALIVE, gauge drops exactly once,
        # one heartbeat_reconnect, registration re-advertised
        rec0 = EVENTS.stats().get("heartbeat_reconnect", 0)
        mon.beat("wA", reg)
        assert mon.members()["wA"]["state"] == ALIVE
        assert WORKERS_DEAD.value == 0
        assert EVENTS.stats().get("heartbeat_reconnect", 0) == rec0 + 1
        assert mon.registration("wA") == reg

        # further beats are plain refreshes: no extra reconnect events
        mon.beat("wA", reg)
        assert EVENTS.stats().get("heartbeat_reconnect", 0) == rec0 + 1
        assert WORKERS_DEAD.value == 0
    finally:
        mon.close()


def test_monitor_flap_decrements_gauge_once():
    """Two workers die; one flaps back repeatedly — the gauge tracks the
    SET of DEAD workers (recomputed under the lock), never double
    decrements."""
    mon = ClusterMonitor(port=0, interval_s=60.0, miss_limit=3,
                         bind_host="127.0.0.1")
    try:
        mon.beat("w0")
        mon.beat("w1")
        now = time.monotonic()
        mon._scan(now + 400)
        assert WORKERS_DEAD.value == 2
        for _ in range(3):  # flapping beats from w0 only
            mon.beat("w0")
        assert WORKERS_DEAD.value == 1
        mon.beat("w1")
        assert WORKERS_DEAD.value == 0
    finally:
        mon.close()


# ---------------------------------------------------------------------------
# live cluster: coordinator + 2 worker processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    """One shared 2-worker cluster + coordinator session for the module.

    Tests below run IN ORDER (file order; tier-1 runs with -p no:randomly)
    and the final test deliberately kills the whole fleet, so it must stay
    last."""
    old_shard, old_groups = D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS
    old_dist = config.get("dist_fragments")
    old_to = config.get("cluster_exec_timeout_s")
    D.SHARD_THRESHOLD_ROWS = 100
    D.SHUFFLE_AGG_MIN_GROUPS = 10
    s = Session(device="cpu", dist_shards=2)
    s.sql("create table t (a int, b int)")
    s.sql("insert into t values "
          + ", ".join(f"({i % 97}, {i % 7})" for i in range(400)))
    s.sql("create table d (k int, v int)")
    s.sql("insert into d values "
          + ", ".join(f"({i}, {i * 10})" for i in range(97)))
    config.set("dist_fragments", True)
    oracle = s.sql(SQL).rows()  # single-process oracle, pre-attach
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers' torch threads
    cr = ClusterRuntime(n_workers=2, shards=2, hb_interval_s=0.1,
                        hb_miss_limit=3).start(s)
    cr.attach(s)
    try:
        yield s, cr, oracle
    finally:
        s.catalog.cluster_runtime = None
        cr.stop()
        config.set("dist_fragments", old_dist)
        config.set("cluster_exec_timeout_s", old_to)
        D.SHARD_THRESHOLD_ROWS = old_shard
        D.SHUFFLE_AGG_MIN_GROUPS = old_groups
        os.environ.pop("OMP_NUM_THREADS", None)


def _pad(sql: str, n: int) -> str:
    """Unique query text per run so the coordinator query cache can't
    short-circuit the cluster path."""
    return sql + " " * n


def test_cluster_query_matches_oracle(cluster):
    s, cr, oracle = cluster
    got = s.sql(_pad(SQL, 1)).rows()
    assert got == oracle
    assert s.last_profile.infos["cluster_workers"] == 2
    assert cr.stats()["fragments_total"] >= 2


def test_cluster_warm_run_uses_worker_cache(cluster):
    s, cr, oracle = cluster
    shipped0 = sum(len(w.plans) for w in cr.workers())
    got = s.sql(_pad(SQL, 2)).rows()
    assert got == oracle
    # identical logical plan -> same fingerprint -> nothing new shipped
    assert sum(len(w.plans) for w in cr.workers()) == shipped0


def test_cluster_dml_resyncs_tables(cluster):
    s, cr, oracle = cluster
    s.sql("insert into t values (0, 100)")
    got = s.sql(_pad(SQL, 3)).rows()
    s.catalog.cluster_runtime = None  # local oracle for the new data
    try:
        want = s.sql(_pad(SQL, 4)).rows()
    finally:
        s.catalog.cluster_runtime = cr
    assert got == want


def test_kill_worker_mid_fragment_retries_and_alerts(cluster):
    """The headline contract: SIGKILL a worker while it holds an in-flight
    fragment. The query must NOT wedge, must answer oracle-correct via
    re-placement, and the observability plane must see the death."""
    s, cr, _ = cluster
    s.catalog.cluster_runtime = None
    try:
        oracle = s.sql(_pad(SQL, 5)).rows()
    finally:
        s.catalog.cluster_runtime = cr
    loss0 = EVENTS.stats().get("heartbeat_loss", 0)
    retries0 = cr.stats()["retries_total"]
    cr.inject_fault("w0", "delay", seconds=2.0, times=1)
    res = {}

    def run():
        try:
            res["rows"] = s.sql(_pad(SQL, 6)).rows()
        except Exception as e:  # noqa: BLE001 — surfaced via assert below
            res["err"] = e

    th = threading.Thread(target=run)
    th.start()
    time.sleep(0.6)  # let the query reach the delayed fragment on w0
    cr.kill_worker("w0")
    th.join(timeout=90)
    assert not th.is_alive(), "query wedged after worker SIGKILL"
    assert "err" not in res, res
    assert res.get("rows") == oracle, res
    assert cr.stats()["retries_total"] > retries0

    # heartbeat plane: coordinator-side loss event + gauge within 5s
    deadline = time.monotonic() + 5
    while (time.monotonic() < deadline
           and EVENTS.stats().get("heartbeat_loss", 0) <= loss0):
        time.sleep(0.05)
    assert EVENTS.stats().get("heartbeat_loss", 0) > loss0
    assert WORKERS_DEAD.value >= 1
    # the stock heartbeat_loss alert fires on the gauge
    af0 = EVENTS.stats().get("alert_fire", 0)
    ALERTS.evaluate(_gauge_alert_sample(WORKERS_DEAD.value))
    assert EVENTS.stats().get("alert_fire", 0) == af0 + 1


def test_respawn_reconnects_and_resolves(cluster):
    """Replacement worker re-registers over the heartbeat plane: gauge
    back to zero, exactly one reconnect event, addr re-advertised — and
    the revived worker serves fragments again."""
    s, cr, _ = cluster
    rec0 = EVENTS.stats().get("heartbeat_reconnect", 0)
    cr.respawn_worker("w0")
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and WORKERS_DEAD.value > 0:
        time.sleep(0.05)
    assert WORKERS_DEAD.value == 0
    assert EVENTS.stats().get("heartbeat_reconnect", 0) == rec0 + 1
    assert "addr" in cr.monitor.registration("w0")
    ar0 = EVENTS.stats().get("alert_resolve", 0)
    ALERTS.evaluate(_gauge_alert_sample(0.0))
    assert EVENTS.stats().get("alert_resolve", 0) == ar0 + 1
    s.catalog.cluster_runtime = None
    try:
        oracle = s.sql(_pad(SQL, 7)).rows()
    finally:
        s.catalog.cluster_runtime = cr
    assert s.sql(_pad(SQL, 8)).rows() == oracle
    assert len(cr.alive_workers()) == 2


def test_partition_blackhole_replaces_fragment(cluster):
    """A blackholed worker (receives, never replies) looks like a network
    partition: the per-request deadline promotes it to _WorkerGone and the
    fragment re-places onto the healthy worker."""
    s, cr, _ = cluster
    s.catalog.cluster_runtime = None
    try:
        oracle = s.sql(_pad(SQL, 9)).rows()
    finally:
        s.catalog.cluster_runtime = cr
    retries0 = cr.stats()["retries_total"]
    config.set("cluster_exec_timeout_s", 1.5)
    try:
        cr.inject_fault("w1", "blackhole", seconds=8.0, times=1)
        got = s.sql(_pad(SQL, 10)).rows()
    finally:
        config.set("cluster_exec_timeout_s", 30.0)
    assert got == oracle
    assert cr.stats()["retries_total"] > retries0
    time.sleep(1.0)  # drain w1's blackhole window before the next test


def test_total_worker_loss_raises_typed_error_without_leaks(cluster):
    """LAST (kills the whole fleet): retry exhaustion surfaces a typed
    WorkerLostError naming worker + fragment; no worker process and no
    query scope is left behind, the coordinator leaks NOTHING — no
    admission slots, no accountant bytes, no registry entries — audit
    records the statement as `error`, and the catalog still answers
    locally."""
    s, cr, _ = cluster
    # quiesce, then baseline the accountant with no query in flight
    s.catalog.cluster_runtime = None
    try:
        s.sql(_pad(SQL, 11)).rows()
    finally:
        s.catalog.cluster_runtime = cr
    base_bytes = ACCOUNTANT.snapshot()["process_bytes"]
    cr.kill_worker("w0")
    cr.kill_worker("w1")
    config.set("cluster_exec_timeout_s", 2.0)
    try:
        with pytest.raises(WorkerLostError) as ei:
            s.sql(_pad(SQL, 12)).rows()
    finally:
        config.set("cluster_exec_timeout_s", 30.0)
    assert ei.value.fid >= 0
    assert ei.value.worker_id
    assert lifecycle.current() is None
    assert not any(w.alive_process() for w in cr.workers())
    assert cr.alive_workers() == []
    wm = s.catalog.workgroups
    slots = sum(wm.running.values()) if wm is not None else 0
    assert slots == 0, f"leaked admission slots: {slots}"
    assert len(REGISTRY.snapshot()) == 0
    leak = ACCOUNTANT.snapshot()["process_bytes"] - base_bytes
    assert leak == 0, f"leaked {leak} accountant bytes"
    AUDIT.flush()
    last = AUDIT.snapshot()[-1]
    assert last["state"] == "error", last
    # catalog intact: a local (non-cluster) query still answers
    s.catalog.cluster_runtime = None
    assert s.sql(_pad(SQL, 13)).rows() == s.sql(_pad(SQL, 14)).rows()


def test_failed_start_leaves_no_worker_running(monkeypatch):
    """A fleet whose second worker fails its bootstrap stops the workers
    it already spawned (and its monitor) before the error surfaces."""
    s = Session(device="cpu", dist_shards=2)
    cr = ClusterRuntime(n_workers=2, shards=2)
    real = cr._bootstrap_worker
    spawned = []

    def flaky(handle):
        spawned.append(handle)
        if len(spawned) == 2:
            raise RuntimeError("bootstrap refused")
        return real(handle)

    monkeypatch.setattr(cr, "_bootstrap_worker", flaky)
    with pytest.raises(RuntimeError, match="bootstrap refused"):
        cr.start(s)
    for h in spawned:
        assert h.proc.wait(timeout=30) is not None
    assert cr.workers() == []
