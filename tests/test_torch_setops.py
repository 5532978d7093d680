"""Set operations in the PyTorch port (ops/setops.py and the planner's
LUnion) against the JAX package's, on the same inputs.

`union_all` and `concat_many` take chunks with different string
dictionaries, mixed numeric types (ints of two widths, decimals of two
scales, decimal with double), NULLs and dead rows; the outputs are
compared column for column with the JAX package's: types, decoded
strings, values, validity and the selection mask. Then UNION, UNION ALL,
INTERSECT and EXCEPT through SQL, over `catalog_from_numpy` tables that
copy the data of tests/test_sql_frontend.py's set-operation tests, and
B1-B4 (`BREADTH_QUERIES`) at SF 0.01, against the JAX Session. INTERSECT
ALL and EXCEPT ALL (a window, row_number per row group, over UNION ALL)
and their chains over duplicates and NULLs, against the JAX Session and
tests/test_sql_frontend.py's expected rows.
"""

from decimal import Decimal

import numpy as np
import pytest

from starrocks_tpu import types as JT
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.column.column import Chunk as JChunk
from starrocks_tpu.ops import setops as jsetops
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.column.column import Chunk as TChunk
from starrocks_tpu_torch.ops import setops as tsetops
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import catalog_from_numpy, tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import BREADTH_QUERIES

from torch_tpch_parity import (
    AUTO_KNOBS, KERNEL_KNOBS, reset_knobs, rows_match, set_knobs, tcfg,
)


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


def _types(pkg, names):
    t = {"int": pkg.INT, "bigint": pkg.BIGINT, "double": pkg.DOUBLE,
         "dec2": pkg.DECIMAL(15, 2), "dec4": pkg.DECIMAL(12, 4)}
    return {k: t[v] for k, v in names.items()}


def _pair(data, types, n_live):
    """(jax chunk, port chunk) of the same columns; rows past n_live dead."""
    jh = JHostTable.from_pydict(data, types=_types(JT, types))
    th = THostTable.from_pydict(data, types=_types(TT, types))
    jc, tc = jh.to_chunk(), th.to_chunk(device="cpu")
    live = np.arange(jc.capacity) < n_live
    import jax.numpy as jnp
    import torch

    jc = JChunk(jc.schema, jc.data, jc.valid, jnp.asarray(live))
    tc = TChunk(tc.schema, tc.data, tc.valid, torch.from_numpy(live), "cpu")
    return jc, tc


def _side(seed, n, strings, types):
    rng = np.random.default_rng(seed)
    data = {
        "s": [strings[i] if i % 9 else None
              for i in rng.integers(0, len(strings), n)],
        "a": [int(v) if v % 11 else None for v in rng.integers(-99, 99, n)],
        "b": rng.integers(-10 ** 6, 10 ** 6, n).tolist(),
        "c": np.round(rng.uniform(-100, 100, n), 2).tolist(),
        "d": np.round(rng.uniform(-100, 100, n), 2).tolist(),
    }
    return _pair(data, types, n - 5)


def _assert_same(jc, tc):
    assert len(jc.schema) == len(tc.schema)
    for i, (jf, tf) in enumerate(zip(jc.schema.fields, tc.schema.fields)):
        assert jf.name == tf.name and repr(jf.type) == repr(tf.type)
        jd, td = np.asarray(jc.data[i]), tc.data[i].numpy()
        if jf.type.is_string:
            assert list(jf.dict.values) == list(tf.dict.values)
        assert np.array_equal(jd, td), jf.name
        jv, tv = jc.valid[i], tc.valid[i]
        assert (jv is None) == (tv is None)
        if jv is not None:
            assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(jc.sel_mask()), tc.sel_mask().numpy())
    assert JHostTable.from_chunk(jc).to_pylist() == \
        THostTable.from_chunk(tc).to_pylist()


LEFT = {"a": "int", "b": "int", "c": "dec2", "d": "dec2"}
RIGHT = {"a": "bigint", "b": "int", "c": "dec4", "d": "double"}


@pytest.mark.parametrize("seed", [1, 2])
def test_union_all_matches_jax(seed):
    ja, ta = _side(seed, 1500, ["x", "pear", "apple", "fig"], LEFT)
    jb, tb = _side(seed + 10, 700, ["fig", "kiwi", "zz", "apple", "a"], RIGHT)
    jout, tout = jsetops.union_all(ja, jb), tsetops.union_all(ta, tb)
    _assert_same(jout, tout)
    assert tout.capacity == ta.capacity + tb.capacity
    # the same dictionary on both sides passes through, not re-merged
    jself, tself = jsetops.union_all(ja, ja), tsetops.union_all(ta, ta)
    _assert_same(jself, tself)
    assert tself.schema.fields[0].dict is ta.schema.fields[0].dict


def test_concat_many_matches_jax():
    parts = [_side(s, 300 + 100 * s, ["p", "q"], LEFT) for s in range(3)]
    # same-dictionary parts: one concatenation per column
    same = [parts[0]] + [(j.__class__(parts[0][0].schema, j.data, j.valid,
                                      j.sel),
                          t.__class__(parts[0][1].schema, t.data, t.valid,
                                      t.sel, "cpu"))
                         for j, t in parts[1:]]
    for chunks in (parts, same):
        jout = jsetops.concat_many([j for j, _ in chunks])
        tout = tsetops.concat_many([t for _, t in chunks])
        _assert_same(jout, tout)


# --- DECIMAL(38) children (the JAX package keeps one int64 per decimal here,
# so these hold the port to exact Python decimals instead) ------------------

# the largest magnitudes still fit 38 digits at the other side's scale 4
D38 = [Decimal("1701411834604692317316873037158841.05"), Decimal("-1.05"),
       None, Decimal("-9999999999999999999999999999999999.99"),
       Decimal("0.01")]
OTHER = {
    "d38s4": (TT.DECIMAL(38, 4), [Decimal("12345678901234567890123.4567"),
                                  None, Decimal("-0.0001")]),
    # a DECIMAL(15) column takes its logical values as floats
    "d15s3": (TT.DECIMAL(15, 3), [123456789012.345, -7.001, None]),
    "bigint": (TT.BIGINT, [-(2 ** 63), 2 ** 63 - 1, None]),
    "double": (TT.DOUBLE, [0.5, None, -2.25]),
}


@pytest.mark.parametrize("other", sorted(OTHER))
@pytest.mark.parametrize("d38_first", [True, False])
def test_union_all_decimal38_widens_exactly(other, d38_first):
    t, vals = OTHER[other]
    a = THostTable.from_pydict({"v": D38}, types={"v": TT.DECIMAL(38, 2)})
    b = THostTable.from_pydict({"v": vals}, types={"v": t})
    ca, cb = a.to_chunk(device="cpu"), b.to_chunk(device="cpu")
    first, second = (ca, cb) if d38_first else (cb, ca)
    out = tsetops.union_all(first, second)
    got = [r[0] for r in THostTable.from_chunk(out).to_pylist()]
    left, right = (D38, vals) if d38_first else (vals, D38)
    out_t = out.schema.fields[0].type
    if other == "double":
        assert out_t == TT.DOUBLE
        # the limbs' value in f64, then divided by 10^scale (as a cast to
        # DOUBLE does): within two roundings of the exact value
        assert got == [None if v is None else pytest.approx(float(v), rel=3e-16)
                       for v in left + right]
        return
    scale = max(2, t.scale or 0)
    assert out_t.is_decimal128 and out_t.scale == scale
    assert out.data[0].shape == (out.capacity, 4)
    assert got == [None if v is None else Decimal(str(v))
                   for v in left + right]
    assert all(v.as_tuple().exponent == -scale for v in got if v is not None)


def test_union_all_decimal38_mixed_scale_sql():
    cat = catalog_from_numpy(
        {"t": [("k", "BIGINT", np.arange(6, dtype=np.int64), None, None)]})
    ts = Session(cat, device="cpu")
    got = ts.sql(
        "select v from ("
        " select cast(k as decimal(38,1)) * cast(k as decimal(38,1))"
        " * cast(100000000000000000 as decimal(38,0)) v from t where k < 4"
        " union all select cast(k as decimal(38,4)) - cast(2 as decimal(38,4))"
        " from t where k >= 4"
        " union all select cast(k as decimal(15,3)) from t where k = 5) u"
        " order by v").rows()
    want = sorted([Decimal(k * k * 10 ** 17) for k in range(4)]
                  + [Decimal(2), Decimal(3), Decimal(5)])
    assert [r[0] for r in got] == want
    assert all(r[0].as_tuple().exponent == -4 for r in got)


# --- through SQL (the data of tests/test_sql_frontend.py) -----------------------


def _codes(vals):
    """(codes, sorted dictionary, valid) of a string column with NULLs."""
    d = sorted({v for v in vals if v is not None}) or [""]
    codes = np.array([d.index(v) if v is not None else 0 for v in vals],
                     np.int32)
    valid = np.array([v is not None for v in vals])
    return codes, d, (None if valid.all() else valid)


def _table(rows):
    xs = [r[0] for r in rows]
    ss = [r[1] for r in rows]
    xv = np.array([x is not None for x in xs])
    codes, d, sv = _codes(ss)
    return [("x", "INT", np.array([x or 0 for x in xs], np.int32), None,
             None if xv.all() else xv),
            ("s", "VARCHAR", codes, d, sv)]


TABLES = {
    "ua": [(1, "p"), (2, "q")],
    "ub": [(2, "q"), (3, "r")],
    "ia": [(1, "p"), (2, "q"), (2, "q"), (None, "n")],
    "ib": [(2, "q"), (3, "r"), (None, "n")],
    "ba": [(1, "a"), (1, "a"), (1, "a"), (2, "b"), (3, None), (3, None),
           (None, None)],
    "bb": [(1, "a"), (1, "a"), (3, None), (None, None), (None, None),
           (9, "z")],
}

SETOP_SQL = {
    "union_all": "select x, s from ua union all select x, s from ub "
                 "order by x",
    "union": "select x, s from ua union select x, s from ub order by x",
    "union_group": "select s, count(*) c from (select x, s from ua union "
                   "all select x, s from ub) u group by s order by s",
    "union_in": "select x from ia where x in (select x from ua union "
                "select x from ub) order by x",
    "intersect": "select x, s from ia intersect select x, s from ib "
                 "order by x nulls last",
    "except": "select x, s from ia except select x, s from ib "
              "order by x nulls last",
    "intersect_nulls": "select x, s from ba intersect select x, s from bb "
                       "order by x nulls last, s",
    "except_nulls": "select x, s from ba except select x, s from bb "
                    "order by x nulls last, s",
    "union_chain": "select x, s from ba union select x, s from bb union "
                   "select x, s from ua order by x nulls last, s",
    "union_mixed": "select x from ua union all select x * 1.5 from ub "
                   "order by x",
}


@pytest.fixture(scope="module")
def setop_sessions():
    spec = {name: _table(rows) for name, rows in TABLES.items()}
    from starrocks_tpu import types as JT_
    from starrocks_tpu.column.column import Field, Schema
    from starrocks_tpu.column.dict_encoding import StringDict
    from starrocks_tpu.storage.catalog import Catalog

    jcat = Catalog()
    for name, cols in spec.items():
        fields, arrays, valids = [], {}, {}
        for col, tname, values, dvals, valid in cols:
            t = JT_.INT if tname == "INT" else JT_.VARCHAR
            d = None if dvals is None else StringDict.from_values(dvals)
            fields.append(Field(col, t, True, d))
            arrays[col] = values
            if valid is not None:
                valids[col] = valid
        jcat.register(name, JHostTable(Schema(tuple(fields)), arrays, valids))
    return JSession(jcat), Session(catalog_from_numpy(spec), device="cpu")


@pytest.mark.parametrize("name", sorted(SETOP_SQL))
def test_setops_sql_match_jax(setop_sessions, name):
    js, ts = setop_sessions
    want = js.sql(SETOP_SQL[name]).rows()
    got = ts.sql(SETOP_SQL[name]).rows()
    assert rows_match(got, want)
    assert got


def test_setops_sql_known_answers(setop_sessions):
    """tests/test_sql_frontend.py's expected rows."""
    _, ts = setop_sessions
    assert ts.sql(SETOP_SQL["union_all"]).rows() == [
        (1, "p"), (2, "q"), (2, "q"), (3, "r")]
    assert ts.sql(SETOP_SQL["union"]).rows() == [(1, "p"), (2, "q"), (3, "r")]
    assert ts.sql(SETOP_SQL["union_group"]).rows() == [
        ("p", 1), ("q", 2), ("r", 1)]
    assert ts.sql(SETOP_SQL["intersect"]).rows() == [(2, "q"), (None, "n")]
    assert ts.sql(SETOP_SQL["except"]).rows() == [(1, "p")]


# INTERSECT ALL / EXCEPT ALL: the analyzer's rewrite onto UNION ALL and a
# row_number() window per row group; ba and bb hold duplicates and NULLs
BAG_SQL = {
    "intersect_all": "select x, s from ba intersect all select x, s from bb "
                     "order by x nulls last, s",
    "except_all": "select x, s from ba except all select x, s from bb "
                  "order by x nulls last, s",
    "except_all_rev": "select x, s from bb except all select x, s from ba "
                      "order by x nulls last, s",
    "intersect_all_chain": "select x, s from ba intersect all select x, s "
                           "from bb intersect all select x, s from ba "
                           "order by x nulls last, s",
    "except_all_chain": "select x, s from ba except all select x, s from bb "
                        "except all select x, s from ia "
                        "order by x nulls last, s",
}
# tests/test_sql_frontend.py's expected rows
BAG_KNOWN = {
    "intersect_all": [(1, "a"), (1, "a"), (3, None), (None, None)],
    "except_all": [(1, "a"), (2, "b"), (3, None)],
    "intersect_all_chain": [(1, "a"), (1, "a"), (3, None), (None, None)],
}


@pytest.mark.parametrize("name", sorted(BAG_SQL))
def test_bag_setops_match_jax(setop_sessions, name):
    js, ts = setop_sessions
    want = js.sql(BAG_SQL[name]).rows()
    got = ts.sql(BAG_SQL[name]).rows()
    assert rows_match(got, want) and got
    if name in BAG_KNOWN:
        assert got == BAG_KNOWN[name]


def test_bag_setops_mixing_raises(setop_sessions):
    """A chain mixing INTERSECT ALL with INTERSECT is refused by both."""
    for s in setop_sessions:
        with pytest.raises(Exception, match="mixing"):
            s.sql("select x, s from ba intersect all select x, s from bb "
                  "intersect select x, s from ba")


@pytest.fixture(scope="module")
def tpch_sessions():
    return (JSession(jax_tpch_catalog(sf=0.01)),
            Session(tpch_catalog(sf=0.01), device="cpu"))


@pytest.mark.parametrize("strategy", ["auto", "kernels"])
@pytest.mark.parametrize("qid", ["B1", "B2", "B3", "B4"])
def test_breadth_setops_match_jax(tpch_sessions, qid, strategy):
    js, ts = tpch_sessions
    want = js.sql(BREADTH_QUERIES[qid]).rows()
    set_knobs(tcfg, KERNEL_KNOBS if strategy == "kernels" else AUTO_KNOBS)
    got = ts.sql(BREADTH_QUERIES[qid]).rows()
    assert rows_match(got, want) and got
    if qid == "B2":
        assert got == [(271,)]
    if qid == "B3":
        assert got == [(1020,)]
