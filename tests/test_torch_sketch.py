"""HLL and BITMAP sketches of the PyTorch port (`ops/sketch.py`,
`exprs/functions_sketch.py`, the sketch aggregates of `ops/aggregate.py`)
against the JAX package's.

- Registers and planes are bit-identical on seeded values, INT64_MIN/MAX,
  NULLs and dead rows included; estimates are equal integers, a group
  whose estimate lies near x.5 included.
- The scalar sketch functions are evaluated by both compilers; the
  reference's sketch SQL scripts (tests/test_sketch_types.py, at smaller
  row counts and without the distributed cases) run through both Sessions.
"""

import numpy as np
import pytest
import torch

from starrocks_tpu.ops import sketch as js
from starrocks_tpu.ops.aggregate import _string_hash_lut as j_hash_lut

from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.ops import sketch as ts
from starrocks_tpu_torch.ops.aggregate import _string_hash_lut as t_hash_lut

from torch_function_parity import C, L, chunk_pair, check_spec, run_pair, \
    session_pair
from torch_tpch_parity import reset_knobs

INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


def _values(n=20000, seed=3):
    rng = np.random.default_rng(seed)
    v = rng.integers(INT64_MIN, INT64_MAX, n, dtype=np.int64, endpoint=True)
    v[:6] = [INT64_MIN, INT64_MAX, 0, -1, 1, INT64_MIN + 1]
    v[6:2006] = rng.integers(0, 300, 2000)  # repeats
    valid = rng.random(n) > 0.1
    gid = rng.integers(0, 9, n).astype(np.int32)  # 8 groups; 8 = dead rows
    return v, valid, gid


@pytest.mark.parametrize("p", [4, 12, 14])
def test_hll_rows_and_registers_are_bit_identical(p):
    v, valid, gid = _values()
    ji, jr = js.hll_rows(v, valid, p)
    ti, tr = ts.hll_rows(torch.from_numpy(v), torch.from_numpy(valid), p)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jr), tr.numpy())
    jreg = js.hll_registers_from_values(v, valid, gid, 8, p)
    treg = ts.hll_registers_from_values(
        torch.from_numpy(v), torch.from_numpy(valid), torch.from_numpy(gid),
        8, p)
    assert treg.dtype == torch.int8 and treg.shape == (8, 1 << p)
    assert np.array_equal(np.asarray(jreg), treg.numpy())
    assert np.array_equal(np.asarray(js.hll_estimate(jreg)),
                          ts.hll_estimate(treg).numpy())
    ju = js.hll_union_registers(jreg, np.array([0, 1, 1, 0, 2, 2, 2, 3]), 3)
    tu = ts.hll_union_registers(treg, torch.tensor([0, 1, 1, 0, 2, 2, 2, 3]),
                                3)
    assert np.array_equal(np.asarray(ju), tu.numpy())


def test_clz64_over_every_bit_position():
    w = np.array([0] + [1 << b for b in range(63)] + [INT64_MIN, -1, 3, 5],
                 dtype=np.int64)
    want = np.asarray(js._clz64(w.view(np.uint64)))
    assert np.array_equal(ts._clz64(torch.from_numpy(w)).numpy(), want)


def test_hll_estimate_is_the_same_integer_near_half():
    """The estimate is round(f64); groups whose unrounded estimate lies
    within 0.05 of x.5 must round alike in both packages."""
    rng = np.random.default_rng(11)
    m = 1 << 12
    regs = np.zeros((4000, m), np.int8)
    for g in range(4000):  # a spread of cardinalities, sparse to dense
        k = int(rng.integers(1, 40000))
        idx = rng.integers(0, m, k)
        rho = np.minimum(rng.geometric(0.5, k), 53)
        np.maximum.at(regs[g], idx, rho.astype(np.int8))
    r = regs.astype(np.float64)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / np.exp2(-r).sum(axis=1)
    zeros = (regs == 0).sum(axis=1)
    lc = m * np.log(m / np.maximum(zeros, 1))
    est = np.where((raw <= 2.5 * m) & (zeros > 0), lc, raw)
    near = np.abs(est - np.floor(est) - 0.5) < 0.05
    assert near.sum() >= 50
    assert np.array_equal(np.asarray(js.hll_estimate(regs)),
                          ts.hll_estimate(torch.from_numpy(regs)).numpy())


@pytest.mark.parametrize("nbits", [8, 100, 4096, 65536])
def test_bitmap_planes_are_bit_identical(nbits):
    v, valid, gid = _values(8000, seed=nbits)
    v = v % (nbits + 50) - 20  # in and out of the domain
    jp = js.bitmap_from_values(v, valid, nbits)
    tp = ts.bitmap_from_values(torch.from_numpy(v), torch.from_numpy(valid),
                               nbits)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    jg = js.bitmap_union_from_values(v, valid, gid, 8, nbits)
    tg = ts.bitmap_union_from_values(torch.from_numpy(v),
                                     torch.from_numpy(valid),
                                     torch.from_numpy(gid), 8, nbits)
    assert np.array_equal(np.asarray(jg), tg.numpy())
    ju = js.bitmap_union_planes(jp, gid, 8)
    tu = ts.bitmap_union_planes(tp, torch.from_numpy(gid), 8)
    assert np.array_equal(np.asarray(ju), tu.numpy())
    assert np.array_equal(np.asarray(ju), np.asarray(jg))
    assert np.array_equal(np.asarray(js.bitmap_count(jg)),
                          ts.bitmap_count(tg).numpy())
    narrow = jg[:, : max(1, jg.shape[1] // 2)]
    for op in ("and", "or", "xor", "andnot"):
        assert np.array_equal(
            np.asarray(js.bitmap_binary(jg, narrow, op)),
            ts.bitmap_binary(tg, torch.from_numpy(np.asarray(narrow)),
                             op).numpy())
    probe = v[:8]
    assert np.array_equal(
        np.asarray(js.bitmap_contains(jg, probe)),
        ts.bitmap_contains(tg, torch.from_numpy(probe)).numpy())


def test_string_hash_lut_matches_the_reference():
    from starrocks_tpu.column.dict_encoding import StringDict as JD
    from starrocks_tpu_torch.column.dict_encoding import StringDict as TD

    vals = ["", "a", "naïve café", "x" * 70, "a\x00b", "DELIVER IN PERSON"]
    assert np.array_equal(j_hash_lut(JD.from_strings(vals)[0]),
                          t_hash_lut(TD.from_strings(vals)[0]))


@pytest.fixture(scope="module")
def chunks():
    return chunk_pair()


SCALARS = {
    "hll_hash": [("hll_cardinality", ("hll_hash", (C, "s"))),
                 ("hll_hash", (C, "j")), ("hll_hash", (C, "f"))],
    "hll_empty": [("hll_cardinality", ("hll_empty",))],
    "to_bitmap": [("to_bitmap", ("pmod", (C, "j"), (L, 65536))),
                  ("bitmap_count", ("to_bitmap", (C, "i")))],
    "bitmap_and": [("bitmap_count", ("bitmap_and",
                                     ("to_bitmap", ("pmod", (C, "j"),
                                                    (L, 64))),
                                     ("bitmap_from_string", (L, "1,2,3"))))],
    "bitmap_or": [("bitmap_or", ("to_bitmap", (C, "sh")),
                   ("bitmap_from_string", (L, "1,2,3")))],
    "bitmap_xor": [("bitmap_xor", ("to_bitmap", (C, "sh")),
                    ("bitmap_from_string", (L, "1,2,70")))],
    "bitmap_andnot": [("bitmap_andnot", ("bitmap_from_string", (L, "1,2,70")),
                       ("to_bitmap", (C, "sh")))],
    "bitmap_contains": [("bitmap_contains", ("bitmap_from_string",
                                             (L, "1,2,3,64")), (C, "sh"))],
}


@pytest.mark.parametrize("fn", sorted(SCALARS))
def test_scalar_sketch_function_matches_jax(chunks, fn):
    for spec in SCALARS[fn]:
        check_spec(chunks, spec)


# --- the reference's sketch SQL scripts (tests/test_sketch_types.py) --------


def _rng_tables():
    rng = np.random.default_rng(6)
    n = 20000
    g = rng.integers(0, 4, n)
    v = rng.integers(0, 5000, n)
    dim = rng.integers(1, 4, n)
    names = [f"user{i}" for i in range(4000)]
    return {
        "t": {"g": g, "s": [f"u{x}" for x in v], "v": v, "dim": dim,
              "dy": rng.integers(0, 10, n), "site": rng.integers(0, 2, n),
              "a": rng.integers(0, 100, n), "b": rng.integers(0, 300, n)},
        "raw": {"p": rng.integers(0, 8, n), "u": rng.integers(0, 2000, n)},
        "t1": {"u": names}, "t2": {"u": list(reversed(names))},
    }


SKETCH_SETUP = [
    "create table daily as select p, hll_sketch(u) as users from raw "
    "group by p",
    "create table bdaily as select dy, site, bitmap_agg(v) as users from t "
    "group by dy, site",
    "create table by_dim as select dim, bitmap_agg(v) as users from t "
    "group by dim",
    "create table sk1 as select hll_sketch(u) as h from t1",
    "create table sk2 as select hll_sketch(u) as h from t2",
]
SKETCH_QUERIES = [
    "select approx_count_distinct(v) from t",
    "select ndv(v) from t",
    "select g, approx_count_distinct(s) from t group by g order by g",
    "select hll_union_agg(users) from daily",
    "select hll_cardinality(hll_union(users)) from daily",
    "select g, bitmap_union_count(to_bitmap(v)) from t group by g order by g",
    "select site, bitmap_union_count(users) from bdaily group by site "
    "order by site",
    "select intersect_count(users, dim, 1, 2) from by_dim",
    "select bitmap_count(bitmap_and(a.users, b.users)), "
    "bitmap_count(bitmap_or(a.users, b.users)), bitmap_contains(a.users, 0) "
    "from by_dim a, by_dim b where a.dim = 1 and b.dim = 2",
    "select hll_union_agg(h) from (select h from sk1 union all "
    "select h from sk2) x",
    "select bitmap_count(bitmap_or(to_bitmap(a), to_bitmap(b))) from t "
    "where a = 1",
    "select g, approx_count_distinct(v), bitmap_union_count(v) from t "
    "group by g order by g",
    "select dim, hll_cardinality(hll_sketch(s)), bitmap_count(bitmap_union("
    "to_bitmap(a))) from t group by dim order by dim",
    "select approx_count_distinct(g * 1.5) from t",
]


@pytest.fixture(scope="module")
def sketch_sessions():
    reset_knobs()
    pair = session_pair(_rng_tables())
    for text in SKETCH_SETUP:
        run_pair(pair, text)
    return pair


@pytest.mark.parametrize("k", range(len(SKETCH_QUERIES)))
def test_sketch_script_matches_jax(sketch_sessions, k):
    got = run_pair(sketch_sessions, SKETCH_QUERIES[k])
    assert got[0] == "rows"


@pytest.mark.parametrize("kind", ["hll", "bitmap"])
def test_in_memory_sketch_columns(kind):
    """A CREATE TABLE with an HLL / BITMAP column in memory, appended with
    per-key sketches: their union equals the JAX package's one-pass
    answer over the raw rows, exactly (stored sketch columns are slice
    5c; the reference's in-memory tables cannot append sketch columns:
    their declared empty arrays are rank 1)."""
    from starrocks_tpu_torch.runtime.session import Session

    rng = np.random.default_rng(8)
    u = rng.integers(0, 4096, 5000)
    u[0] = 4095  # the catalog bound makes bitmap_agg's width 4096 bits
    raw = {"raw": {"k": rng.integers(0, 3, 5000), "u": u}}
    js, ts = session_pair(raw)
    if kind == "hll":
        ddl = "create table agg_t (k int, users hll(12))"
        sk = "select k, hll_sketch(u) as users from raw group by k"
        q, want = ("select hll_union_agg(users) from agg_t",
                   "select approx_count_distinct(u) from raw")
        t = TT.HLL(12)
    else:
        ddl = "create table agg_t (k int, users bitmap(4096))"
        sk = "select k, bitmap_agg(u) as users from raw group by k"
        q, want = ("select bitmap_union_count(users) from agg_t",
                   "select bitmap_union_count(to_bitmap(u)) from raw")
        t = TT.BITMAP(4096)
    ts.sql(ddl)
    rows = ts.sql(sk).rows()
    ht = THostTable.from_pydict({"k": [r[0] for r in rows],
                                 "users": [r[1] for r in rows]},
                                types={"k": TT.INT, "users": t})
    ts._append(ts.catalog.get_table("agg_t"), ht)
    assert ts.sql(q).rows() == js.sql(want).rows()
    assert ts.sql("select count(*) from agg_t").rows() == [(3,)]


@pytest.mark.parametrize("kind", ["hll", "bitmap"])
def test_stored_sketch_columns_wait_for_slice_5c(tmp_path, kind):
    """The reference's HLL and BITMAP storage round trips
    (tests/test_sketch_types.py::test_hll_storage_roundtrip,
    test_bitmap_storage_roundtrip) through both Sessions, each over its own
    data_dir: the sketch rows go through the write path as rank-2 int8
    registers / planes, a restart reads them back, and every estimate and
    count equals the JAX package's; ALTER TABLE ADD COLUMN of the type
    reads NULL for the old rows. (The name is kept from when the port
    raised here.)"""
    from starrocks_tpu import types as JT
    from starrocks_tpu.column import HostTable as JHostTable
    from starrocks_tpu.runtime.session import Session as JSession
    from starrocks_tpu_torch.runtime.session import Session as TSession

    rng = np.random.default_rng(8 if kind == "hll" else 12)
    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    pair = (JSession(data_dir=dirs[0]),
            TSession(device="cpu", data_dir=dirs[1]))
    if kind == "hll":
        raw = {"raw": {"k": rng.integers(0, 3, 20_000),
                       "u": rng.integers(0, 9_000, 20_000)}}
        ddl = "create table agg_t (k int, users hll(12))"
        rows = run_pair(session_pair(raw),
                        "select k, hll_sketch(u) as users from raw "
                        "group by k order by k")[1]
        types = (JT.HLL(12), TT.HLL(12))
        queries = ["select hll_union_agg(users) from agg_t",
                   "select k, hll_cardinality(users) from agg_t order by k"]
    else:
        def planes(vs):
            b = np.zeros(512, dtype=np.uint8)
            for x in vs:
                b[x >> 3] |= 1 << (x & 7)
            return b.astype(np.int8).tobytes()

        vals = [sorted(set(rng.integers(0, 4096, 50).tolist()))
                for _ in range(3)]
        ddl = "create table agg_t (k int, users bitmap(4096))"
        rows = [(i, planes(v)) for i, v in enumerate(vals)]
        types = (JT.BITMAP(4096), TT.BITMAP(4096))
        queries = ["select k, bitmap_count(users) from agg_t order by k",
                   "select bitmap_union_count(users) from agg_t"]
    run_pair(pair, ddl)
    data = {"k": [r[0] for r in rows], "users": [r[1] for r in rows]}
    for sess, HT, typ, IT in ((pair[0], JHostTable, types[0], JT.INT),
                              (pair[1], THostTable, types[1], TT.INT)):
        sess._append(sess.catalog.get_table("agg_t"),
                     HT.from_pydict(data, types={"k": IT, "users": typ}))
    restarted = (JSession(data_dir=dirs[0]),
                 TSession(device="cpu", data_dir=dirs[1]))
    for q in queries:
        got = run_pair(restarted, q)
        assert got[0] == "rows" and got[1]
    if kind == "bitmap":
        assert run_pair(restarted, queries[0])[1] == [
            (i, len(vals[i])) for i in range(3)]
    # ALTER TABLE ADD COLUMN of the sketch type on a stored table
    col = "more hll(12)" if kind == "hll" else "more bitmap(4096)"
    fn = "hll_cardinality" if kind == "hll" else "bitmap_count"
    run_pair(restarted, f"alter table agg_t add column {col}")
    got = run_pair(restarted, f"select k, {fn}(more) from agg_t order by k")
    # bitmap_count of a NULL bitmap is 0 in both packages (as in StarRocks)
    empty = None if kind == "hll" else 0
    assert got == ("rows", [(r[0], empty) for r in rows])
