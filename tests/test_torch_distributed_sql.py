"""The port's distributed SQL (sql/distributed.py, runtime/dist_executor.py)
against its own single-shard Session, test for test the port's counterpart
of tests/test_distributed_sql.py.

An 8-shard port Session (an in-process mesh on the CPU) must give the
1-shard Session's rows: exact but for floats, which agree to 1e-9 relative
(the reference's `_same`). Where the JAX package's tests read collectives
from HLO, these read the mesh's collective counts (`Mesh.moves`). The
comparison with the JAX package's 8-shard Session is in
tests/test_torch_distributed_jax.py."""

import math

import numpy as np
import pandas as pd
import pytest
import torch

import starrocks_tpu_torch.sql.distributed as D
from starrocks_tpu_torch.column import HostTable
from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.runtime.config import (
    AUTO_STRATEGIES, KERNEL_STRATEGIES, config,
)
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import Catalog, tpch_catalog
from starrocks_tpu_torch.storage.datagen.ssb import ssb_catalog
from starrocks_tpu_torch.storage.ssb_queries import FLAT_QUERIES
from starrocks_tpu_torch.storage.tpch_queries import (
    DIST_QUERIES, QUERIES, STAT_QUERIES, TOPN_QUERIES,
)

# Q1 scan-agg; Q3/Q5/Q10 sharded lineitem x sharded orders + replicated
# dims; Q6 filter-agg; Q12 shuffle join; Q14/Q19 part joins; Q18 IN-subquery
# semi join over sharded tables
DIST_TPCH = [1, 3, 5, 6, 10, 12, 14, 19, 18]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in six processes on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def thresholds():
    old = D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS
    D.SHARD_THRESHOLD_ROWS = 10_000  # SF 0.01: lineitem+orders shard
    D.SHUFFLE_AGG_MIN_GROUPS = 4_000  # SF 0.01 orderkeys take SHUFFLE
    yield
    D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS = old


@pytest.fixture(scope="module")
def cat():
    return tpch_catalog(sf=0.01)


@pytest.fixture()
def sessions(cat, thresholds):
    for k, v in AUTO_STRATEGIES.items():
        config.set(k, v)
    return Session(cat, device="cpu"), Session(cat, device="cpu",
                                                dist_shards=8)


def _same(r1, r8, qid, rel=1e-9):
    assert len(r1) == len(r8), f"{qid}: {len(r1)} vs {len(r8)} rows"
    a = sorted(r1, key=str)
    b = sorted(r8, key=str)
    for i, (x, y) in enumerate(zip(a, b)):
        for xv, yv in zip(x, y):
            if isinstance(xv, float) and isinstance(yv, float):
                assert abs(xv - yv) <= max(abs(xv), 1) * rel, f"{qid} row {i}"
            else:
                assert xv == yv, f"{qid} row {i}: {xv!r} vs {yv!r}"


def _moves(s8, q):
    mesh = s8._executor().mesh
    mesh.reset_moves()
    rows = s8.sql(q).rows()
    return rows, dict(mesh.moves)


@pytest.mark.parametrize("qid", DIST_TPCH)
def test_tpch_distributed_matches_single(sessions, qid):
    s1, s8 = sessions
    _same(s1.sql(QUERIES[qid]).rows(), s8.sql(QUERIES[qid]).rows(),
          f"Q{qid}")


def test_ssb_distributed(thresholds):
    D.SHUFFLE_AGG_MIN_GROUPS = 32_768
    cat = ssb_catalog(sf=0.005)
    s1 = Session(cat, device="cpu")
    s8 = Session(cat, device="cpu", dist_shards=8)
    for qid in ["q1.1", "q2.1", "q3.1", "q4.1"]:
        _same(s1.sql(FLAT_QUERIES[qid]).rows(),
              s8.sql(FLAT_QUERIES[qid]).rows(), qid)


def test_distributed_topn_counter_sums_shards(sessions):
    s1, s8 = sessions
    q = "select l_orderkey from lineitem order by l_orderkey limit 7"
    assert s1.sql(q).rows() == s8.sql(q).rows()
    c1 = s1.last_profile.counters.get("topn_rows_pruned", (0,))[0]
    c8 = s8.last_profile.counters.get("topn_rows_pruned", (0,))[0]
    assert c1 > 0
    # per-shard pruned counts are SUMMED over the shards: a max would give
    # one shard's count (~1/8 of the single-node total)
    assert c8 > 0.55 * c1


def test_distributed_adaptive_recompile(sessions):
    s1, s8 = sessions
    # a high-cardinality group-by on an EXPRESSION (no NDV stats: the
    # planner cannot seed capacity) overflows its group capacity and reruns
    q = """select l_orderkey % 3000 k, sum(l_quantity) q from lineitem
           group by l_orderkey % 3000 order by q desc, k limit 5"""
    r1, r8 = s1.sql(q).rows(), s8.sql(q).rows()
    assert [r[1] for r in r1] == [r[1] for r in r8]
    prof = s8.last_profile
    assert prof.counters["recompiles"][0] >= 1 and len(
        [c for c in prof.children if c.name.startswith("attempt_")]) >= 2


def test_colocate_join_no_shuffle(cat, thresholds):
    """lineitem/orders share hash distribution on orderkey: the join runs
    with NO all_to_all (colocate join)."""
    s1 = Session(cat, device="cpu")
    s8 = Session(cat, device="cpu", dist_shards=8)
    q = """select o_orderpriority, count(*) c, sum(l_quantity) q
           from orders, lineitem where o_orderkey = l_orderkey
           group by o_orderpriority order by 1"""
    rows, moves = _moves(s8, q)
    assert s1.sql(q).rows() == rows
    assert "all_to_all" not in moves
    (ir, scans), = s8._executor()._frag_ir_memo.values()
    assert any(isinstance(m, tuple) and m[0] == "hash" for _, m in scans)


def test_shuffle_final_agg(sessions):
    """A high-cardinality GROUP BY on an UNALIGNED key routes partial
    states through the hash exchange (an all_to_all) instead of gathering
    them, and still matches the single shard."""
    s1, s8 = sessions
    D.SHUFFLE_AGG_MIN_GROUPS = 1_000  # SF 0.01 partkeys (2000) take SHUFFLE
    q = ("select l_partkey, sum(l_quantity) q, count(*) c "
         "from lineitem group by l_partkey")
    rows, moves = _moves(s8, q)
    _same(s1.sql(q).rows(), rows, "shuffle-agg")
    assert len(moves.get("all_to_all", ())) >= 1


def test_colocate_aggregation_no_exchange(sessions):
    """GROUP BY on the table's hash-distribution key aggregates fully
    shard-local: no all_to_all."""
    s1, s8 = sessions
    q = ("select l_orderkey, sum(l_quantity) q, count(*) c from lineitem "
         "group by l_orderkey")
    rows, moves = _moves(s8, q)
    _same(s1.sql(q).rows(), rows, "colocate-agg")
    assert "all_to_all" not in moves


def test_distributed_full_sort_global_order(sessions):
    """Full ORDER BY over a sharded table: range exchange + local sort give
    EXACT global order (not just the multiset)."""
    s1, s8 = sessions
    q = "select l_extendedprice from lineitem order by l_extendedprice desc"
    rows, moves = _moves(s8, q)
    assert [r[0] for r in s1.sql(q).rows()] == [r[0] for r in rows]
    assert len(moves.get("all_to_all", ())) >= 1  # the range exchange
    q2 = "select l_shipdate from lineitem order by l_shipdate"
    assert s1.sql(q2).rows() == s8.sql(q2).rows()


def _tnull_session():
    rng = np.random.default_rng(42)
    s = Session(device="cpu")
    s.sql("create table tnull (v int, g varchar)")
    words = ["amber", "brick", "coral", "dune", "ember", "frost"]
    rows = []
    for _ in range(4000):
        v = "null" if rng.random() < 0.1 else str(int(rng.integers(-500, 500)))
        rows.append(f"({v}, '{words[int(rng.integers(0, len(words)))]}')")
    s.sql("insert into tnull values " + ", ".join(rows))
    return s


NULL_SORTS = [
    "select v from tnull order by v",                    # nulls last
    "select v from tnull order by v desc",               # nulls first
    "select v from tnull order by v asc nulls first",
    "select v from tnull order by v desc nulls last",
    "select g from tnull order by g",                    # dict codes
    "select g from tnull order by g desc",
]


def test_distributed_sort_nulls_and_dict_keys(thresholds):
    """Exact global order through the range exchange for the NULL-sentinel
    branch and dictionary-encoded varchar keys."""
    D.SHARD_THRESHOLD_ROWS = 300
    s = _tnull_session()
    s8 = Session(s.catalog, device="cpu", dist_shards=8)
    for q in NULL_SORTS:
        assert s.sql(q).rows() == s8.sql(q).rows(), q


def test_distributed_topn_gathers_topk_only(sessions):
    """ORDER BY..LIMIT: per-shard TopN + compact, so the gather moves at
    most 1024 rows a shard, and the rows match the single shard."""
    s1, s8 = sessions
    q = """select l_orderkey, l_linenumber, l_extendedprice from lineitem
           order by l_extendedprice desc, l_orderkey, l_linenumber limit 37"""
    rows, moves = _moves(s8, q)
    assert s1.sql(q).rows() == rows
    assert moves.get("all_gather"), "expected gathers in the TopN plan"
    assert max(moves["all_gather"]) <= 1024, moves


def test_distributed_window_partition_shuffle(sessions):
    """PARTITION BY windows run shard-local after a partition-key shuffle:
    the rows match the single shard's."""
    s1, s8 = sessions
    q = DIST_QUERIES["W2"]
    rows, moves = _moves(s8, q)
    _same(s1.sql(q).rows(), rows, "window-shuffle")
    assert s8.last_profile.infos["exchanges"] >= 1


def _fuzz_session(t1, t2):
    s = Session(device="cpu")
    s.sql("create table t1 (g varchar, h int, x double, y int, k int)")
    s.sql("create table t2 (k int, w double, c varchar)")
    for df, name in ((t1, "t1"), (t2, "t2")):
        rows = []
        for r in df.itertuples(index=False):
            vals = []
            for v in r:
                if v is None or (isinstance(v, float) and math.isnan(v)):
                    vals.append("null")
                elif isinstance(v, str):
                    vals.append(f"'{v}'")
                else:
                    vals.append(repr(v))
            rows.append("(" + ", ".join(vals) + ")")
        s.sql(f"insert into {name} values " + ", ".join(rows))
    return s


def test_distributed_fuzz(thresholds):
    """Random query specs (tests/test_fuzz_sql.py's generator) agree
    between one shard and eight."""
    from test_fuzz_sql import _norm, gen_spec, make_tables, spec_to_sql

    D.SHARD_THRESHOLD_ROWS = 300
    rng = np.random.default_rng(777)
    t1, t2 = make_tables(rng)
    s1 = _fuzz_session(t1, t2)
    s8 = Session(s1.catalog, device="cpu", dist_shards=8)
    for _ in range(10):
        sql = spec_to_sql(gen_spec(rng))
        assert _norm(s1.sql(sql).rows()) == _norm(s8.sql(sql).rows()), sql


def _catalog(tables: dict):
    cat = Catalog()
    for name, data in tables.items():
        cat.register(name, HostTable.from_pydict(data))
    return cat


def test_string_key_join_dict_alignment(thresholds):
    """String join keys from DIFFERENT tables compare by VALUE: both sides'
    equal strings must reach the same shard."""
    rng = np.random.default_rng(7)
    words1 = [f"w{i:03d}" for i in range(40)]
    words2 = [f"w{i:03d}" for i in range(20, 60)]  # overlapping, shifted codes
    n = 30_000
    cat = _catalog({
        "s1": {"k": [words1[i] for i in rng.integers(0, 40, n)],
               "x": list(range(n))},
        "s2": {"k": [words2[i] for i in rng.integers(0, 40, n)],
               "y": list(rng.integers(0, 1000, n))}})
    q = ("SELECT s1.k AS k, count(*) AS c, sum(y) AS sy FROM s1 "
         "JOIN s2 ON s1.k = s2.k GROUP BY s1.k ORDER BY k")
    single = Session(cat, device="cpu").sql(q).rows()
    dist = Session(cat, device="cpu", dist_shards=8).sql(q).rows()
    d1 = pd.DataFrame([r[0] for r in cat.get_table("s1").table.to_pylist()],
                      columns=["k"])
    d2 = pd.DataFrame(cat.get_table("s2").table.to_pylist(), columns=["k", "y"])
    m = d1.merge(d2, on="k")
    exp = (m.groupby("k").agg(c=("y", "size"), sy=("y", "sum"))
           .reset_index().sort_values("k"))
    expected = [(r.k, int(r.c), int(r.sy)) for r in exp.itertuples()]
    assert [(k, int(c), int(sy)) for k, c, sy in single] == expected
    _same(single, dist, "string_join")


def test_unpackable_multikey_join_hash_fallback(thresholds):
    """Key tuples past 63 packed bits join via a splitmix64 fingerprint +
    equality residuals: one shard and eight agree with pandas."""
    rng = np.random.default_rng(11)
    n = 30_000
    a = rng.integers(0, 500, n)
    b = rng.choice([0.5, 1.5, 2.5, -3.0, 1e12], n)
    a2 = rng.integers(0, 500, n)
    b2 = rng.choice([0.5, 1.5, 2.5, -3.0, 7.0], n)
    cat = _catalog({"f1": {"a": list(a), "b": list(b), "x": list(range(n))},
                    "f2": {"a": list(a2), "b": list(b2), "y": list(range(n))}})
    q = ("SELECT a, count(*) AS c, sum(y) AS sy FROM ("
         "SELECT f1.a AS a, y FROM f1 JOIN f2 "
         "ON f1.a = f2.a AND f1.b = f2.b) t GROUP BY a ORDER BY a")
    single = Session(cat, device="cpu").sql(q).rows()
    dist = Session(cat, device="cpu", dist_shards=8).sql(q).rows()
    m = pd.DataFrame({"a": a, "b": b}).merge(
        pd.DataFrame({"a": a2, "b": b2, "y": range(n)}), on=["a", "b"])
    exp = (m.groupby("a").agg(c=("y", "size"), sy=("y", "sum"))
           .reset_index().sort_values("a"))
    expected = [(int(r.a), int(r.c), int(r.sy)) for r in exp.itertuples()]
    assert [(int(aa), int(c), int(sy)) for aa, c, sy in single] == expected
    _same(single, dist, "hash_multikey")


def test_string_expression_key_join_distributed(thresholds):
    """String EXPRESSION join keys (fresh per-side dicts) cannot align at
    the column level: the planner gathers the build side instead of
    shuffling both sides by incomparable codes."""
    rng = np.random.default_rng(13)
    n = 30_000
    w1 = [f"K{i:03d}" for i in range(40)]
    w2 = [f"k{i:03d}" for i in range(20, 60)]
    cat = _catalog({
        "e1": {"k": [w1[i] for i in rng.integers(0, 40, n)],
               "x": list(range(n))},
        "e2": {"k": [w2[i] for i in rng.integers(0, 40, n)],
               "y": list(rng.integers(0, 100, n))}})
    q = ("SELECT count(*) AS c, sum(y) AS sy FROM e1 JOIN e2 "
         "ON lower(e1.k) = lower(e2.k)")
    single = Session(cat, device="cpu").sql(q).rows()
    dist = Session(cat, device="cpu", dist_shards=8).sql(q).rows()
    assert single[0][0] > 0
    _same(single, dist, "string_expr_join")


# --- the kernel strategies over the shards ---------------------------------------


KERNEL_RUNS = [
    # (query, kernel whose plain version the shards must call)
    (STAT_QUERIES["S1"], "segment_sum"),
    (STAT_QUERIES["S2"], "segment_sum"),
    (TOPN_QUERIES["N1"], "topn_select"),
    (QUERIES[5], "probe_searchsorted"),
]


@pytest.mark.parametrize("i", range(len(KERNEL_RUNS)))
def test_kernel_strategies_over_shards(cat, thresholds, i):
    """Under the kernel strategies the per-shard stages call the kernels'
    wrappers (their plain versions on the CPU): S1/S2's per-shard PARTIAL
    of float moments, N1's per-shard top-N, Q5's local joins; the rows
    equal the single shard's under the same strategies (S1/S2's f32 block
    sums to the kernel contract's 1e-5)."""
    q, kernel = KERNEL_RUNS[i]
    try:
        for k, v in KERNEL_STRATEGIES.items():
            config.set(k, v)
        want = Session(cat, device="cpu").sql(q).rows()
        kernels.reset_counts()
        got = Session(cat, device="cpu", dist_shards=8).sql(q).rows()
        calls = kernels.counts()[kernel]["calls"]
    finally:
        for k, v in AUTO_STRATEGIES.items():
            config.set(k, v)
    assert calls > 0
    _same(want, got, kernel, rel=1e-5 if kernel == "segment_sum" else 1e-9)


def test_hash_join_kernels_over_shards(cat, thresholds):
    """`join_probe_strategy = 'pallas'`: Q3's local joins build and probe
    the open-addressing table on every shard."""
    config.set("join_probe_strategy", "pallas")
    try:
        want = Session(cat, device="cpu").sql(QUERIES[3]).rows()
        kernels.reset_counts()
        got = Session(cat, device="cpu", dist_shards=8).sql(QUERIES[3]).rows()
        counts = kernels.counts()
    finally:
        config.set("join_probe_strategy", "auto")
    assert counts["hash_build"]["calls"] > 0
    assert counts["hash_probe"]["calls"] > 0
    assert got == want


def test_dist_session_needs_a_device():
    """Without CUDA, Session(dist_shards=8) raises unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(tpch_catalog(sf=0.001), dist_shards=8)


@pytest.mark.parametrize("qid", [5, 10, 18])
def test_dist_intermediates_free_without_the_cyclic_collector(sessions, qid):
    """A finished distributed query leaves no intermediate tensor alive:
    the distributed compiler's emit closures reference each other through
    their memo, which held every shard's operator outputs until Python's
    cyclic collector ran (TPC-H Q5 at SF 10 on an NVIDIA H100: 45.9 GB
    still allocated after its run), and so did the upstream fragments'
    outputs a fragment resumed from (40.4 GB after Q5). Measured as
    tests/test_torch_tpcds_gen.py measures the single-device planner: live
    tensor storages with the collector off, after a warm run against
    before it."""
    import gc

    def live_bytes():
        seen = {}
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.layout == torch.strided:
                st = o.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    _s1, s8 = sessions
    s8.sql(QUERIES[qid]).rows()  # warm the placements and statistics
    gc.collect()
    gc.disable()
    try:
        before = live_bytes()
        s8.sql(QUERIES[qid]).rows()
        after = live_bytes()
    finally:
        gc.enable()
    assert s8.last_profile.infos["fragments"] >= 3
    assert after - before < (1 << 18), (before, after)


def test_dist_path_takes_the_partial_cache(tmp_path):
    """A cacheable aggregation over a stored table takes the per-segment
    partial-aggregation tier on the distributed path too (the tier is
    host-orchestrated over the manifest's segments, as in the reference):
    after an INSERT only the new segment aggregates again, and the rows
    equal the single-shard Session's."""
    s8 = Session(device="cpu", data_dir=str(tmp_path), dist_shards=8)
    s8.sql("create table t (k int, v double)")
    for lo in (0, 2000):
        s8.sql("insert into t values " + ",".join(
            f"({i % 5},{float(i)})" for i in range(lo, lo + 2000)))
    q = "select k, sum(v) s, count(*) c from t group by k order by k"
    s8.sql("set enable_query_cache = on")
    try:
        s8.sql(q)
        s8.sql("insert into t values " + ",".join(
            f"({i % 5},{float(i)})" for i in range(4000, 5000)))
        got = s8.sql(q).rows()
        counters = {k: v for k, (v, _) in
                    s8.last_profile.counters.items()}
        want = Session(s8.catalog, device="cpu").sql(q).rows()
    finally:
        s8.sql("set enable_query_cache = off")
    assert counters["qcache_partial_hits"] == 2
    assert counters["qcache_partial_recomputed"] == 1
    assert got == want
