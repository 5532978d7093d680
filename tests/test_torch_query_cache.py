"""The two-tier query cache of the PyTorch port (starrocks_tpu_torch/cache/)
against the JAX package: the cases of tests/test_query_cache.py through
both Sessions, each over its own data_dir where the case stores tables.

Held: rows equal to the reference's (and to an uncached run), and the
cache's own counters (qcache_hits / qcache_misses / qcache_partial_hits /
qcache_rows_saved) equal to the reference's at every step — a warm hit
that never executes, a stale entry dropped by INSERT, a SET of a trace
knob that misses, nondeterministic queries never cached, LRU eviction past
`query_cache_capacity_mb`, `enable_query_cache = off` uncached, and the
partial tier's delta reuse after an append, its string-dictionary merge,
the recompute after an upsert and after a compaction. The distributed
partial merge is in the distributed tests, an external table's changed
files in tests/test_torch_external_tables.py, and the verified result key
(analysis/key_check.py) in tests/test_torch_plan_verifier.py.
"""

import numpy as np
import pytest
import torch

from starrocks_tpu.cache.query_cache import QCACHE_EVICTIONS as J_EVICTIONS
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import Catalog as JCatalog

from starrocks_tpu_torch.cache.query_cache import QCACHE_EVICTIONS
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.session import Session as TSession
from starrocks_tpu_torch.storage.catalog import Catalog as TCatalog

from torch_tpch_parity import reset_knobs, rows_match

COUNTERS = ("qcache_hits", "qcache_misses", "qcache_partial_hits",
            "qcache_rows_saved")
AGG = "select k, sum(v) as s, count(*) as c from t group by k order by k"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def qcache_on():
    reset_knobs()
    _set(enable_query_cache=True)
    yield
    reset_knobs()


def _set(**kv):
    for cfg in (jcfg, tcfg):
        for k, v in kv.items():
            cfg.set(k, v)


def _counters(pair):
    """(JAX counters, port counters) of the last query, the cache's."""
    js, ts = pair
    j = {k: v for k, (v, _) in js.last_profile.counters.items()
         if k in COUNTERS}
    t = {k: v for k, (v, _) in ts.last_profile.counters.items()
         if k in COUNTERS}
    return j, t


def _q(pair, text):
    """One query through both Sessions: equal rows and equal cache
    counters. Returns (port rows, port counters)."""
    js, ts = pair
    want = js.sql(text).rows()
    got = ts.sql(text).rows()
    assert rows_match(got, want), (text, got, want)
    j, t = _counters(pair)
    assert t == j, (text, t, j)
    return got, t


def _sql(pair, text):
    for s in pair:
        s.sql(text)


def _mem_pair(n=1000):
    data = {"k": np.arange(n) % 7, "v": np.arange(n) * 1.0}
    jc, tc = JCatalog(), TCatalog()
    jc.register("t", JHostTable.from_pydict(data))
    tc.register("t", THostTable.from_pydict(data))
    return JSession(jc), TSession(tc, device="cpu")


def _stored_pair(tmp_path, ddl="create table t (k int, v double)",
                 batches=((0, 2000), (2000, 4000)), row=None):
    pair = (JSession(data_dir=str(tmp_path / "jax")),
            TSession(device="cpu", data_dir=str(tmp_path / "port")))
    _sql(pair, ddl)
    row = row or (lambda i: f"({i % 5},{float(i)})")
    for lo, hi in batches:  # one rowset file per INSERT
        _sql(pair, "insert into t values " + ",".join(
            row(i) for i in range(lo, hi)))
    return pair


# --- full-result tier ----------------------------------------------------------


def test_full_result_hit_identical():
    pair = _mem_pair()
    r1, _ = _q(pair, AGG)
    r2, c = _q(pair, AGG)
    assert c.get("qcache_hits") == 1 and r2 == r1
    # the hit path never touched the optimizer
    assert "optimize" not in pair[1].last_profile.counters


def test_insert_drops_stale_entry():
    pair = _mem_pair()
    _q(pair, AGG)
    assert _q(pair, AGG)[1].get("qcache_hits") == 1
    _sql(pair, "insert into t values (1, 99.0)")
    r, c = _q(pair, AGG)
    assert c.get("qcache_hits", 0) == 0 and c.get("qcache_misses") == 1
    got = {row[0]: row[1] for row in r}
    exp = {k: sum(float(i) for i in range(1000) if i % 7 == k)
           for k in range(7)}
    exp[1] += 99.0
    assert all(abs(got[k] - exp[k]) < 1e-6 for k in exp)


def test_set_trace_knob_misses():
    pair = _mem_pair()
    _q(pair, AGG)
    _set(enable_runtime_filters=not tcfg.get("enable_runtime_filters"))
    assert _q(pair, AGG)[1].get("qcache_hits", 0) == 0


@pytest.mark.parametrize("q", ["select rand() as r from t limit 1",
                               "select now() as n from t limit 1"])
def test_nondeterministic_never_cached(q):
    js, ts = _mem_pair()
    for _ in range(2):
        ts.sql(q)
        js.sql(q)
        assert "qcache_uncacheable" in ts.last_profile.infos
        assert "qcache_uncacheable" in js.last_profile.infos
        j, t = _counters((js, ts))
        assert t == j == {}


def test_lru_eviction_tiny_budget():
    pair = _mem_pair()
    _set(query_cache_capacity_mb=0)  # every store evicts at once
    e0, je0 = QCACHE_EVICTIONS.value, J_EVICTIONS.value
    _q(pair, AGG)
    assert _q(pair, AGG)[1].get("qcache_hits", 0) == 0
    assert QCACHE_EVICTIONS.value - e0 == J_EVICTIONS.value - je0 > 0
    assert pair[1].cache.qcache.resident_bytes == 0


def test_off_is_uncached():
    _set(enable_query_cache=False)
    pair = _mem_pair()
    _q(pair, AGG)
    assert _q(pair, AGG)[1] == {}
    assert pair[1].cache.qcache.resident_bytes == 0


# --- partial-aggregation tier (stored tables) ----------------------------------


def test_partial_tier_delta_reuse(tmp_path):
    pair = _stored_pair(tmp_path)
    assert _q(pair, AGG)[1].get("qcache_partial_hits") == 0
    assert _q(pair, AGG)[1].get("qcache_hits") == 1
    # append a THIRD segment: the full-result entry drops, the partial tier
    # reuses the 2 cached states and scans only the new 1000 rows
    _sql(pair, "insert into t values " + ",".join(
        f"({i % 5},{float(i)})" for i in range(4000, 5000)))
    r, c = _q(pair, AGG)
    assert c.get("qcache_partial_hits") == 2
    assert c.get("qcache_rows_saved") == 4000
    assert pair[1].last_profile.counters["qcache_partial_recomputed"][0] \
        == 1
    got = {row[0]: (row[1], row[2]) for row in r}
    for k in range(5):
        vs = [float(i) for i in range(5000) if i % 5 == k]
        assert abs(got[k][0] - sum(vs)) < 1e-3 and got[k][1] == len(vs)


def test_partial_tier_string_keys_and_avg(tmp_path):
    names = ["aa", "bb", "cc"]
    pair = _stored_pair(
        tmp_path, "create table t (g varchar, v double)",
        ((0, 1500), (1500, 3000)),
        lambda i: f"('{names[i % 3]}',{float(i)})")
    q = "select g, avg(v) as a, count(*) as c from t group by g order by g"
    _set(enable_query_cache=False)
    base = _q(pair, q)[0]
    _set(enable_query_cache=True)
    assert rows_match(_q(pair, q)[0], base)
    _sql(pair, "insert into t values " + ",".join(
        f"('{names[i % 3]}',{float(i)})" for i in range(3000, 3600)))
    r, c = _q(pair, q)
    assert c.get("qcache_partial_hits") == 2
    for g, a, n in r:
        vs = [float(i) for i in range(3600) if names[i % 3] == g]
        assert n == len(vs) and abs(a - sum(vs) / len(vs)) < 1e-9


def test_upsert_delvec_recomputes_segment(tmp_path):
    pair = _stored_pair(
        tmp_path, "create table t (k int, v double, primary key (k))",
        ((0, 100), (100, 200)), lambda i: f"({i},{float(i)})")
    q = "select sum(v) as s, count(*) as c from t"
    _q(pair, q)
    # the upsert rewrites k=5: segment 1 gains a delete-vector entry and a
    # new rowset lands; only those segments aggregate again
    _sql(pair, "insert into t values (5, 500.0)")
    r, c = _q(pair, q)
    assert r[0][1] == 200
    assert abs(r[0][0] - (sum(range(200)) - 5.0 + 500.0)) < 1e-6
    assert c.get("qcache_partial_hits") == 1
    assert pair[1].last_profile.counters["qcache_partial_recomputed"][0] \
        == 2


def test_direct_store_compaction_invalidates(tmp_path):
    pair = _stored_pair(tmp_path)
    _q(pair, AGG)
    assert _q(pair, AGG)[1].get("qcache_hits") == 1
    for s in pair:
        s.store.compact_table("t")
    r, c = _q(pair, AGG)
    assert c.get("qcache_hits", 0) == 0
    # the compacted file is a new segment: its state recomputes
    assert c.get("qcache_partial_hits") == 0
    _set(enable_query_cache=False)
    assert _q(pair, AGG)[0] == r
