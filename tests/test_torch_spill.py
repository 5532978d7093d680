"""The spill executors of the PyTorch port (starrocks_tpu_torch/runtime/
batched.py) against the JAX package, through both Sessions at the same
knobs.

The SQL of the reference's own spill scripts: tests/test_spill_sort.py,
tests/test_spill_window.py, tests/test_join_engine.py family 1 (the six
hybrid-join tests) and tests/test_storage.py::test_grace_join_spill. Each
query runs with `batch_rows_threshold` / `spill_batch_rows` forcing the
spill path in both packages; the rows must equal the JAX package's (and,
where the reference's test checks one, its oracle), the port's profile
must name the executor that ran, the hybrid join's partition counters must
equal the reference's, and `SPILL_PARTS_LIVE` must be back at 0. Also the
host bucket function: the C++ and numpy versions bit-identical to the
reference's splitmix64 on edge keys.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from starrocks_tpu import native as jnative
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.runtime import batched as jbatched
from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import Catalog as JCatalog

from starrocks_tpu_torch import native as tnative
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.runtime import batched as tbatched
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.session import Session as TSession
from starrocks_tpu_torch.storage.catalog import Catalog as TCatalog

from torch_spill_parity import node_view
from torch_tpch_parity import reset_knobs, rows_match

JOIN_COUNTERS = ("join_skew_keys", "join_spilled_partitions",
                 "join_resident_partitions", "join_subpartitions",
                 "join_oversized_passes", "join_max_pass_build",
                 "join_skew_probe_rows")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()
    assert tbatched.SPILL_PARTS_LIVE.value == 0


def _knobs(**kv):
    for cfg in (jcfg, tcfg):
        for k, v in kv.items():
            cfg.set(k, v)


def _pair(tables: dict):
    """(JAX Session, port Session on the CPU) over the same tables:
    {name: (columns, unique_keys, valids)}."""
    jc, tc = JCatalog(), TCatalog()
    for name, (data, uk, valids) in tables.items():
        for cat, HT in ((jc, JHostTable), (tc, THostTable)):
            ht = HT.from_pydict(data)
            ht.valids.update(valids or {})
            cat.register(name, ht, unique_keys=uk)
    return JSession(jc), TSession(tc, device="cpu")


def _jax_counters(session) -> dict:
    out = {}

    def walk(p):
        out.update({k: v for k, (v, _) in p.counters.items()})
        for c in p.children:
            walk(c)

    walk(session.last_profile)
    return out


def _both(pair, q, ordered=True, executor=None):
    """Rows of `q` in both Sessions, held equal (sorted when the query
    leaves the order open); the port's rows."""
    js, ts = pair
    want = js.sql(q).rows()
    got = ts.sql(q).rows()
    if not ordered:
        want = sorted(want, key=str)
        got = sorted(got, key=str)
    assert rows_match(got, want), (q, got[:3], want[:3])
    if executor is not None:
        assert node_view(ts.last_profile, executor) is not None, [
            c.name for c in ts.last_profile.children]
    return got


# --- tests/test_spill_sort.py -------------------------------------------------


SORT_QUERIES = [
    "select k, v, s from big order by v, k",
    "select k, v from big where k < 250 order by v desc, k desc",
    "select k, v, s from big order by s, v nulls first limit 500",
    "select k + 1 as k1, v from big order by k1 desc, v limit 100",
]


@pytest.fixture(scope="module")
def sort_tables():
    rng = np.random.default_rng(3)
    n = 50_000
    vals = rng.integers(-1000, 1000, n).astype(float) / 4
    nulls = rng.random(n) < 0.05
    return {"big": ({
        "k": rng.integers(0, 500, n),
        "v": [None if nz else float(x) for x, nz in zip(vals, nulls)],
        "s": [f"s{i % 97}" for i in range(n)],
    }, (), None)}


def test_spill_sort_matches_jax_and_the_device_sort(sort_tables):
    base = [_pair(sort_tables)[1].sql(q).rows() for q in SORT_QUERIES]
    _knobs(batch_rows_threshold=4096, spill_batch_rows=7000)
    pair = _pair(sort_tables)
    for q, b in zip(SORT_QUERIES, base):
        got = _both(pair, q, executor="spill_sort")
        assert got == b  # the in-memory sort, row for row
        node = node_view(pair[1].last_profile, "spill_sort")
        assert node["batches"] == 8 and node["lexsort_s"] > 0


# --- tests/test_spill_window.py -----------------------------------------------


WINDOW_QUERIES = [
    """select u, ts, row_number() over (partition by u order by ts, amt) rn,
              sum(amt) over (partition by u order by ts, amt) running
       from ev where ts < 60000""",
    """select u, ts, lag(amt, 1) over (partition by u order by ts, amt) p,
              rank() over (partition by u order by amt desc, ts) r
       from ev""",
]


def test_spill_window_matches_jax_and_the_device_window():
    rng = np.random.default_rng(4)
    n = 40_000
    tables = {"ev": ({
        "u": rng.integers(0, 900, n),
        "ts": rng.integers(0, 100_000, n),
        "amt": np.round(rng.random(n) * 100, 2),
    }, (), None)}
    base = [sorted(_pair(tables)[1].sql(q).rows(), key=str)
            for q in WINDOW_QUERIES]
    _knobs(batch_rows_threshold=4096, spill_batch_rows=6000)
    pair = _pair(tables)
    for q, b in zip(WINDOW_QUERIES, base):
        got = _both(pair, q, ordered=False, executor="spill_window")
        assert rows_match(sorted(got, key=str), b)
        assert node_view(pair[1].last_profile,
                         "spill_window")["partition_groups"] == 7


def test_spill_window_null_partition_keys_one_group():
    rng = np.random.default_rng(7)
    n = 9000
    keys = [None if i % 7 == 0 else int(i % 50) for i in range(n)]
    tables = {"t": ({"k": keys, "v": rng.integers(0, 1000, n)}, (), None)}
    q = "select k, count(*) over (partition by k) c from t"
    base = sorted(_pair(tables)[1].sql(q).rows(), key=str)
    _knobs(batch_rows_threshold=1024, spill_batch_rows=2000)
    got = _both(_pair(tables), q, ordered=False, executor="spill_window")
    assert sorted(got, key=str) == base


def test_streaming_window_skewed_partition_beyond_budget():
    """One PARTITION BY group holds ~90% of the rows: the streaming path
    (global host sort, peer-cut chunks, carried running state) runs."""
    rng = np.random.RandomState(7)
    n = 4000
    g = np.where(rng.rand(n) < 0.9, 1, rng.randint(2, 6, n)).astype(np.int64)
    o = rng.randint(0, 300, n).astype(np.int64)  # many peer ties
    v = rng.randint(-50, 50, n).astype(np.int64)
    tables = {"skw": ({"g": g, "o": o, "v": v}, (), None)}
    q = ("select g, o, v, "
         "rank() over (partition by g order by o) rk, "
         "dense_rank() over (partition by g order by o) dk, "
         "sum(v) over (partition by g order by o) rs, "
         "min(v) over (partition by g order by o) rmin, "
         "count(v) over (partition by g order by o) rc "
         "from skw")
    base = sorted(_pair(tables)[1].sql(q).rows())
    _knobs(batch_rows_threshold=512, spill_batch_rows=512)
    pair = _pair(tables)
    got = _both(pair, q, ordered=False, executor="spill_window")
    assert node_view(pair[1].last_profile,
                     "spill_window")["stream_chunks"] >= 8
    assert sorted(got) == base


def test_streaming_window_null_carry():
    n = 1200
    tables = {"nls": ({
        "g": np.zeros(n, np.int64), "o": np.arange(n, dtype=np.int64),
        "v": [float(i) if i < 600 else None for i in range(n)]}, (), None)}
    _knobs(batch_rows_threshold=256, spill_batch_rows=256)
    got = _both(_pair(tables),
                "select o, sum(v) over (partition by g order by o) rs, "
                "min(v) over (partition by g order by o) rm from nls",
                ordered=False, executor="spill_window")
    rows = {r[0]: (r[1], r[2]) for r in got}
    full = float(np.arange(600).sum())
    assert rows[599] == rows[700] == rows[1199] == (full, 0.0)


# --- tests/test_join_engine.py family 1: the hybrid join ----------------------


def _skew_tables(rng, n_probe=60_000, n_build=24_000, hot_frac=0.5,
                 domain=3_000, build_nulls=False):
    bk = rng.integers(0, domain, n_build)
    bk[: int(n_build * hot_frac)] = 7
    rng.shuffle(bk)
    pk = rng.integers(0, int(domain * 1.2), n_probe)
    valids = {"k": np.arange(n_build) % 7 != 0} if build_nulls else None
    return {
        "probe": ({"k": list(pk.astype(int)),
                   "v": list(rng.integers(0, 100, n_probe).astype(int))},
                  (), None),
        "build": ({"k": list(bk.astype(int)),
                   "w": list(rng.integers(0, 100, n_build).astype(int))},
                  (), valids),
    }


def _hybrid(pair, q, grace_too=True):
    """q through both Sessions under the hybrid executor (join counters
    held to the reference's), then under `grace`; the port's rows."""
    got = _both(pair, q, executor="hybrid")
    jc = _jax_counters(pair[0])
    tc = {k: v for k, (v, _) in pair[1].last_profile.counters.items()}
    assert {k: tc.get(k) for k in JOIN_COUNTERS} == {
        k: jc.get(k) for k in JOIN_COUNTERS}
    if grace_too:
        _knobs(join_hybrid_strategy="grace")
        assert _both(pair, q, executor="grace") == got
        _knobs(join_hybrid_strategy="auto")
    return got, tc


@pytest.fixture
def spill_knobs():
    _knobs(batch_rows_threshold=8_192, spill_batch_rows=8_192)


def test_hybrid_inner_skewed_vs_jax_and_grace(spill_knobs):
    pair = _pair(_skew_tables(np.random.default_rng(11)))
    _, cs = _hybrid(pair, "SELECT sum(v + w) sv, count(*) c FROM probe, "
                          "build WHERE probe.k = build.k")
    assert cs["join_skew_keys"] >= 1 and "join_spilled_partitions" in cs


def test_hybrid_one_hot_key_no_full_spill(spill_knobs):
    pair = _pair(_skew_tables(np.random.default_rng(13), hot_frac=0.75))
    _, cs = _hybrid(pair, "SELECT count(*) c, sum(w) sw FROM probe, build "
                          "WHERE probe.k = build.k", grace_too=False)
    assert cs["join_skew_keys"] >= 1
    assert cs["join_spilled_partitions"] == 0
    assert cs["join_resident_partitions"] >= 1


def test_hybrid_left_outer_zipf_vs_jax(spill_knobs):
    rng = np.random.default_rng(17)
    n, m = 30_000, 15_000
    pk = np.minimum(rng.zipf(1.1, n) - 1, 20_000 - 1).astype(np.int64)
    bk = np.concatenate([np.arange(10_000),
                         rng.integers(0, 20_000, m - 10_000)])
    pair = _pair({
        "probe": ({"k": list(pk.astype(int)), "v": list(range(n))}, (), None),
        "build": ({"k": list(bk.astype(int)),
                   "w": list(rng.integers(0, 50, m).astype(int))}, (), None),
    })
    got, _ = _hybrid(pair, "SELECT count(*) c, count(w) cw, sum(v) sv, "
                           "sum(w) sw FROM probe LEFT JOIN build "
                           "ON probe.k = build.k")
    dfp = pd.DataFrame({"k": pk, "v": np.arange(n)})
    mg = dfp.merge(pd.DataFrame({"k": bk, "w": pair[1].catalog.get_table(
        "build").table.arrays["w"]}), on="k", how="left")
    assert [tuple(int(x) for x in r) for r in got] == [
        (len(mg), int(mg.w.notna().sum()), int(mg.v.sum()),
         int(mg.w.sum()))]


def test_hybrid_semi_anti_vs_jax(spill_knobs):
    pair = _pair(_skew_tables(np.random.default_rng(19), n_probe=40_000,
                              n_build=20_000))
    for q in ("SELECT count(*) c, sum(v) sv FROM probe WHERE k IN "
              "(SELECT k FROM build)",
              "SELECT count(*) c, sum(v) sv FROM probe WHERE k NOT IN "
              "(SELECT k FROM build) AND k IS NOT NULL"):
        _hybrid(pair, q)


def test_hybrid_null_build_keys(spill_knobs):
    pair = _pair(_skew_tables(np.random.default_rng(23), n_probe=30_000,
                              n_build=15_000, build_nulls=True))
    _hybrid(pair, "SELECT count(*) c FROM probe, build "
                  "WHERE probe.k = build.k", grace_too=False)


def test_hybrid_string_keys_fall_back_dict_aligned(spill_knobs):
    """String keys cannot be host-partitioned: the plan keeps the in-memory
    join, which aligns the two sides' dictionaries."""
    rng = np.random.default_rng(29)
    words1 = [f"w{i:04d}" for i in range(400)]
    words2 = [f"w{i:04d}" for i in range(200, 600)]
    n, m = 30_000, 12_000
    pair = _pair({
        "probe": ({"k": [words1[i] for i in rng.integers(0, 400, n)],
                   "v": list(range(n))}, (), None),
        "build": ({"k": [words2[i] for i in rng.integers(0, 400, m)],
                   "w": list(rng.integers(0, 9, m).astype(int))}, (), None),
    })
    _both(pair, "SELECT count(*) c, sum(v) sv FROM probe, build "
                "WHERE probe.k = build.k")
    assert not {"hybrid", "grace"} & {
        c.name for c in pair[1].last_profile.children}


# --- tests/test_storage.py::test_grace_join_spill -----------------------------


def test_grace_join_spill():
    rng = np.random.default_rng(5)
    n, m = 50_000, 20_000
    pair = _pair({
        "fact": ({"k": list(rng.integers(0, 30_000, n)),
                  "v": list(rng.integers(0, 100, n))}, (), None),
        "dim": ({"k": list(np.arange(m)),
                 "w": list(rng.integers(0, 10, m))}, [("k",)], None),
    })
    _knobs(batch_rows_threshold=8_000, spill_batch_rows=8_000)
    q = ("SELECT w, count(*) c, sum(v) sv FROM fact, dim "
         "WHERE fact.k = dim.k GROUP BY w ORDER BY w")
    r = _both(pair, q, executor="hybrid")
    assert pair[1].sql(q).rows() == r  # cached programs + adopted caps
    _knobs(join_hybrid_strategy="grace")
    assert _both(pair, q, executor="grace") == r
    assert node_view(pair[1].last_profile,
                     "grace")["grace_partitions"] == 7


# --- the host bucket function --------------------------------------------------


EDGE_KEYS = np.array(
    [0, 1, -1, 2, -2, 7, 1 << 31, -(1 << 31), (1 << 32) + 3,
     np.iinfo(np.int64).max, np.iinfo(np.int64).min,
     np.iinfo(np.int64).max - 1, np.iinfo(np.int64).min + 1,
     123456789012345, -987654321098765], dtype=np.int64)


def _reference_numpy_buckets(keys, nb):
    """The reference's numpy splitmix64 (starrocks_tpu/native.py fallback)."""
    with np.errstate(over="ignore"):
        z = keys.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(nb)).astype(np.int32)


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 8, 64, 1000, (1 << 31) - 1])
def test_bucket_function_is_the_references_bit_for_bit(nb):
    rng = np.random.default_rng(nb % 97)
    # past 2^16 keys the C++ function splits the work across threads
    keys = np.concatenate([EDGE_KEYS, rng.integers(
        np.iinfo(np.int64).min, np.iinfo(np.int64).max, 70_000,
        dtype=np.int64)])
    want = _reference_numpy_buckets(keys, nb)
    assert np.array_equal(tnative.hash_partition_i64(keys, nb), want)
    assert np.array_equal(tnative.hash_partition_i64_np(keys, nb), want)
    assert np.array_equal(jnative.hash_partition_i64(keys, nb), want)


def test_salted_split_is_the_references():
    """The recursive salted split: the same sub-partitions, in the same
    order, with the same recorded heavy hitters."""
    rng = np.random.default_rng(1)
    rk = np.concatenate([rng.integers(0, 40, 20_000),
                         np.full(5000, 3)]).astype(np.int64)
    lk = rng.integers(0, 40, 8000).astype(np.int64)
    outs = []
    for mod in (jbatched, tbatched):
        out, stats = [], {"sub": 0, "oversized": 0, "hot": []}
        mod._salted_split(lk, rk, np.arange(lk.size), np.arange(rk.size),
                          4096, "inner", 1000, np.uint64(1), 0, out, stats)
        outs.append((out, stats))
    (jo, js), (to, ts) = outs
    assert ts == js and len(to) == len(jo)
    for (tp, tb), (jp, jb) in zip(to, jo):
        assert np.array_equal(tp, jp) and np.array_equal(tb, jb)
