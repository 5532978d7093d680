"""The port's fragment IR (sql/fragments.py) and fragment executor: the
port's counterpart of tests/test_dist_fragments.py.

- golden plan shapes, and the fragment IR's events equal to the JAX
  package's event for event (kind, keys, payload, placements, capacities
  and bytes) on the same plans;
- fragment rows byte-identical to the monolithic program's;
- the fragment stats on the profile;
- a two-process query over gloo (tests/torch_dist_worker.py), checked
  against the contract: the JAX package's in-mesh two-process test is red
  in every run, so it is no reference here;
- the same query through the host exchange plane (runtime/cluster_exec.py)
  with its fragments in another process.

The JAX package's `test_annotated_plan_passes_declared_check` is
`test_annotated_plan_declares_every_exchange`: one LExchange per recorded
event, and the annotated plan verifies in declared mode
(analysis/plan_check.check_distribution)."""

import threading

import pytest
import torch

import starrocks_tpu.sql.distributed as JD
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

import starrocks_tpu_torch.sql.distributed as D
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.sql.distributed import REPLICATED, SHARDED
from starrocks_tpu_torch.sql.logical import LExchange, walk_plan
from starrocks_tpu_torch.storage.catalog import tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import QUERIES

SHUFFLE_AGG = ("select l_suppkey, l_linestatus, sum(l_quantity) q "
               "from lineitem group by l_suppkey, l_linestatus "
               "order by q desc, l_suppkey limit 5")
SCAN = "select l_orderkey, l_quantity from lineitem where l_quantity < 3"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in six processes on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def thresholds():
    old = [(m, m.SHARD_THRESHOLD_ROWS, m.SHUFFLE_AGG_MIN_GROUPS)
           for m in (D, JD)]
    for m in (D, JD):
        m.SHARD_THRESHOLD_ROWS = 10_000  # SF 0.01: lineitem+orders shard
        m.SHUFFLE_AGG_MIN_GROUPS = 4_000
    config.set("dist_fragments", True)
    yield
    config.set("dist_fragments", True)
    for m, a, b in old:
        m.SHARD_THRESHOLD_ROWS, m.SHUFFLE_AGG_MIN_GROUPS = a, b


@pytest.fixture(scope="module")
def cat():
    return tpch_catalog(sf=0.01)


@pytest.fixture()
def sess(cat, thresholds):
    return Session(cat, device="cpu", dist_shards=8)


def _ir_of(sess, sql):
    """Run `sql` in fragment mode and return its FragmentIR."""
    de = sess._executor()
    de._frag_ir_memo.clear()
    sess.sql(sql)
    new = list(de._frag_ir_memo.values())
    assert len(new) == 1, "expected exactly one new fragment IR"
    return new[0][0]


def _kinds(ir):
    return [(ev.kind, ev.payload) for ev in ir.events]


# --- golden plan shapes -----------------------------------------------------------


def test_scan_only_fragments(sess):
    """Sharded filter-scan: one interior fragment + the coordinator-gather
    sink — the minimal two-fragment plan."""
    ir = _ir_of(sess, SCAN)
    assert len(ir.fragments) == 2
    assert _kinds(ir) == [("gather", "rows")]
    interior, sink = ir.fragments
    assert not interior.sink and interior.deps == ()
    assert sink.sink and sink.deps == (interior.fid,)
    assert sink.out_mode == REPLICATED
    assert ir.events[0].out_mode == REPLICATED


def test_hash_join_fragments(sess):
    """Q18: the semi-join's build side hash-repartitions ROWS onto the
    probe's placement, then the TopN gathers."""
    ir = _ir_of(sess, QUERIES[18])
    assert len(ir.fragments) == 3
    assert _kinds(ir) == [("hash", "rows"), ("gather", "topn")]
    assert ir.events[0].out_mode == ("hash", "orders.o_orderkey")
    assert ir.events[0].keys
    assert ir.fragments[-1].sink


def test_broadcast_join_fragments(sess):
    """Q10: the smaller sharded build side broadcasts instead of
    repartitioning both sides."""
    ir = _ir_of(sess, QUERIES[10])
    assert len(ir.fragments) == 3
    assert _kinds(ir) == [("broadcast", "rows"), ("gather", "partial")]
    assert ir.events[0].out_mode == REPLICATED


def test_shuffle_agg_fragments(sess):
    """Multi-key high-cardinality group-by: partial states hash-partition
    by the group keys (shuffle-final aggregation)."""
    D.SHUFFLE_AGG_MIN_GROUPS = 100
    ir = _ir_of(sess, SHUFFLE_AGG)
    assert _kinds(ir) == [("hash", "partial"), ("gather", "topn")]
    assert ir.events[0].out_mode == SHARDED  # multi-key: no single token
    assert len(ir.events[0].keys) == 2


def test_annotated_plan_declares_every_exchange(sess):
    """The annotated plan carries one explicit LExchange per recorded
    exchange edge, and verifies in DECLARED mode: plan_check checks the
    declarations instead of re-simulating the compiler's exchange
    decisions."""
    from starrocks_tpu_torch.analysis import plan_check

    for sql in (QUERIES[10], QUERIES[18]):
        ir = _ir_of(sess, sql)
        n_ex = len({id(n) for n in walk_plan(ir.annotated)
                    if isinstance(n, LExchange)})
        assert n_ex == len(ir.events)
        findings = plan_check.check_distribution(
            ir.annotated, sess.catalog, managed_exchanges=False)
        errs = [f for f in findings if f.severity == "error"]
        assert errs == [], [str(f) for f in errs]


GOLDEN = {"scan": SCAN, "q3": QUERIES[3], "q5": QUERIES[5],
          "q10": QUERIES[10], "q18": QUERIES[18], "shuffle_agg": SHUFFLE_AGG}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_fragment_events_equal_jax(cat, thresholds, eight_devices, name):
    """The port's plans equal the JAX package's node for node, so its
    fragment IR must too: every event's kind, keys, payload, placements,
    per-shard capacity and bytes, and every fragment's shape."""
    for m in (D, JD):
        m.SHUFFLE_AGG_MIN_GROUPS = 100 if name == "shuffle_agg" else 4_000
    t8 = Session(cat, device="cpu", dist_shards=8)
    j8 = JSession(jax_tpch_catalog(sf=0.01), dist_shards=8)
    tir = _ir_of(t8, GOLDEN[name])
    j8.sql(GOLDEN[name])
    (jir, _), = j8._dist_executor._frag_ir_memo.values()

    def events(ir):
        return [(e.kind, tuple(map(repr, e.keys)), e.payload,
                 repr(e.out_mode), repr(e.child_mode), e.rows, e.nbytes,
                 repr(e.parent), e.side, repr(e.child)) for e in ir.events]

    def frags(ir):
        return [(f.fid, f.sink, f.deps, repr(f.out_mode), repr(f.root),
                 None if f.exchange is None else f.exchange.kind)
                for f in ir.fragments]

    assert events(tir) == events(jir)
    assert frags(tir) == frags(jir)
    assert tir.stats() == jir.stats()


# --- byte identity with the monolithic program -------------------------------------


@pytest.mark.parametrize("qid", [1, 3, 10, 18])
def test_fragment_rows_byte_identical_to_monolithic(sess, qid):
    rf = sess.sql(QUERIES[qid]).rows()
    try:
        config.set("dist_fragments", False)
        rm = sess.sql(QUERIES[qid]).rows()
    finally:
        config.set("dist_fragments", True)
    assert rf == rm  # exact: the same ops in the same order


def test_fragment_stats_on_profile(sess):
    sess.sql(QUERIES[10])
    prof = sess.last_profile
    assert prof.infos["fragments"] >= 3
    assert prof.infos["exchanges"] >= 2
    assert prof.infos["n_shards"] == 8
    assert prof.counters["exchange_rows"][0] > 0
    assert prof.counters["exchange_bytes"][0] > 0


def test_ir_derivation_writes_no_knob(sess, monkeypatch):
    """The IR derivation's throwaway run reads the kernel strategies as
    `auto` without setting them: the settings other threads read stay."""
    config.set("join_probe_strategy", "pallas_sorted")
    writes = []
    monkeypatch.setattr(config, "set", lambda *a, **k: writes.append(a))
    try:
        _ir_of(sess, QUERIES[10])
        assert writes == []
        assert config.get("join_probe_strategy") == "pallas_sorted"
    finally:
        monkeypatch.undo()
        config.set("join_probe_strategy", "auto")


def test_scoped_knobs_are_this_threads_alone():
    config.set("topn_strategy", "pallas")
    try:
        seen = {}
        with config.scoped({"topn_strategy": "auto"}):
            t = threading.Thread(target=lambda: seen.update(
                other=config.get("topn_strategy")))
            t.start()
            t.join(timeout=30)
            seen["here"] = config.get("topn_strategy")
        assert seen == {"here": "auto", "other": "pallas"}
        assert config.get("topn_strategy") == "pallas"
        with pytest.raises(KeyError):
            with config.scoped({"no_such_knob": 1}):
                pass
    finally:
        config.set("topn_strategy", "auto")


# --- two processes ---------------------------------------------------------------


def test_two_process_fragment_sql():
    """Two processes join one gloo group (2 x 4 shards) and run the SAME
    SQL through the fragment executor and monolithically: each holds only
    its shards, the hash exchange and the counter sums cross the process
    boundary, and the rows equal an in-process 8-shard mesh's."""
    from torch_dist_worker import run_two_processes

    outs, rcs = run_two_processes()
    joined = "\n".join(outs)
    for out, rc in zip(outs, rcs):
        assert rc == 0, out[-2000:]
    for pid in (0, 1):
        assert f"proc {pid}: sql ok=True spans_processes=True" in joined


def test_two_process_fragment_sql_host_exchange(thresholds):
    """The same contract over the host exchange plane: a coordinator
    schedules every fragment onto one spawned worker process, boundary
    payloads crossing as columnar batches over sockets."""
    from starrocks_tpu_torch.runtime.cluster_exec import ClusterRuntime

    D.SHARD_THRESHOLD_ROWS = 100
    D.SHUFFLE_AGG_MIN_GROUPS = 10
    s = Session(device="cpu", dist_shards=2)
    s.sql("create table t (a int, b int)")
    s.sql("insert into t values "
          + ", ".join(f"({i % 97}, {i % 7})" for i in range(400)))
    s.sql("create table d (k int, v int)")
    s.sql("insert into d values "
          + ", ".join(f"({i}, {i * 10})" for i in range(97)))
    sql = ("select d.v, sum(t.b) s from t join d on t.a = d.k "
           "group by d.v order by s desc, d.v limit 5")
    oracle = s.sql(sql).rows()
    irs = list(s._executor()._frag_ir_memo.values())
    assert any(ev.kind == "hash" for ir, _scans in irs for ev in ir.events)
    cr = ClusterRuntime(n_workers=1, shards=2).start(s)
    try:
        cr.attach(s)
        got = s.sql(sql + " ").rows()  # pad: dodge the plan cache
        assert got == oracle
        assert cr.stats()["fragments_total"] >= 3
    finally:
        s.catalog.cluster_runtime = None
        cr.stop()
