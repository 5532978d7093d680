"""DECIMAL(38) in the PyTorch port (ops/dec128.py and its call sites)
against the JAX package's, on the same inputs, exactly.

Each limb function takes seeded 128-bit values, including values near
+-2^127, sums and products that wrap mod 2^128, and limbs whose 16-bit
halves have their top bit set; both packages' outputs are compared limb
for limb, and the arithmetic also against Python integers. Then
DECIMAL(38) sums, minima, maxima, counts, group keys, join keys, ORDER BY
keys and comparisons through SQL (tables from `catalog_from_numpy`, the
port having no DDL), and B5 (`BREADTH_QUERIES`) at SF 0.01, against the
JAX Session.
"""

import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.ops import dec128 as jd
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import Catalog as JCatalog
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch.column.host_table import (
    HostTable as THostTable, _dec128_to_int, _int_to_dec128)
from starrocks_tpu_torch.ops import dec128 as td
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import catalog_from_numpy, tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import BREADTH_QUERIES

from torch_tpch_parity import (
    AUTO_KNOBS, KERNEL_KNOBS, jcfg, reset_knobs, rows_match, set_knobs, tcfg,
)

M128 = (1 << 128) - 1
# near +-2^127, across the limb boundaries, and 16-bit halves with their top
# bit set (the last two, read as two's complement)
EDGE = [0, 1, -1, 2, -2, (1 << 127) - 1, -(1 << 127), (1 << 127) - 2,
        -(1 << 127) + 1, (1 << 64) - 1, -(1 << 64), (1 << 63), -(1 << 63),
        (1 << 32) - 1, 1 << 32, 10 ** 37, -(10 ** 37) - 12345,
        0x8000_8000_8000_8000_8000_8000_8000_8000 - (1 << 128),
        0x7FFF_8000_FFFF_8000 << 40]


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


def _signed(u: int) -> int:
    u &= M128
    return u - (1 << 128) if u >= 1 << 127 else u


def _values(seed: int, n: int = 400) -> list:
    """Seeded signed 128-bit ints: the edge values, random full-width
    values, and random small ones."""
    rng = np.random.default_rng(seed)
    out = list(EDGE)
    for _ in range(n):
        w = int(rng.integers(1, 128))
        v = int.from_bytes(rng.bytes(16), "little") & ((1 << w) - 1)
        out.append(-v if rng.random() < 0.5 else v)
    return out


def _limbs(vals) -> np.ndarray:
    return np.array([_int_to_dec128(int(v)) for v in vals], dtype=np.int64)


def _ints(limbs) -> list:
    return [_dec128_to_int(r) for r in np.asarray(limbs)]


def _both(fn, *args):
    """fn over the same numpy inputs in both packages, as numpy."""
    j = getattr(jd, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                          for a in args])
    t = getattr(td, fn)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in args])
    if isinstance(j, tuple):
        return [np.asarray(x) for x in j], [x.numpy() for x in t]
    return np.asarray(j), t.numpy()


def test_limb_round_trip():
    vals = _values(1)
    assert _ints(_limbs(vals)) == vals
    from starrocks_tpu.column.host_table import _int_to_dec128 as j_int

    assert all(j_int(v) == _int_to_dec128(v) for v in vals)


@pytest.mark.parametrize("seed", [2, 3])
def test_from_i64_and_to_f64(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 500),
                        np.array([0, -1, 1, -(1 << 63), (1 << 63) - 1])])
    j, t = _both("from_i64", x)
    assert np.array_equal(j, t)
    assert _ints(t) == [int(v) for v in x]
    limbs = _limbs(_values(seed))
    j, t = _both("to_f64", limbs)
    assert j.dtype == t.dtype == np.float64
    assert np.array_equal(j, t)
    assert np.allclose(t, [float(v) for v in _values(seed)], rtol=1e-15)


@pytest.mark.parametrize("seed", [4, 5])
def test_compares_and_sort_ops(seed):
    va = _values(seed)
    vb = list(reversed(_values(seed + 100)))[:len(va)]
    vb[:10] = va[:10]  # equal pairs
    a, b = _limbs(va), _limbs(vb)
    j, t = _both("cmp_limbs", a)
    assert all(np.array_equal(x, y) for x, y in zip(j, t))
    j, t = _both("lt", a, b)
    assert np.array_equal(j, t)
    assert t.tolist() == [x < y for x, y in zip(va, vb)]
    j, t = _both("eq", a, b)
    assert np.array_equal(j, t)
    assert t.tolist() == [x == y for x, y in zip(va, vb)]
    valid = np.arange(len(va)) % 7 != 3
    js = jd.sort_ops(jnp.asarray(a), jnp.asarray(valid))
    ts = td.sort_ops(torch.from_numpy(a), torch.from_numpy(valid))
    assert len(js) == len(ts) == 5
    assert all(np.array_equal(np.asarray(x), y.numpy())
               for x, y in zip(js, ts))
    # the operands order rows as the signed values do
    order = np.lexsort([o.numpy() for o in ts[:4]])
    assert [va[i] for i in order] == sorted(va)


@pytest.mark.parametrize("seed", [6, 7])
def test_arithmetic_wraps_mod_2_128(seed):
    va = _values(seed)
    vb = _values(seed + 50)[:len(va)]
    a, b = _limbs(va), _limbs(vb)
    for fn, ref in (("add", lambda x, y: x + y), ("sub", lambda x, y: x - y),
                    ("mul", lambda x, y: x * y)):
        j, t = _both(fn, a, b)
        assert np.array_equal(j, t), fn
        assert _ints(t) == [_signed(ref(x, y)) for x, y in zip(va, vb)], fn
    j, t = _both("neg", a)
    assert np.array_equal(j, t)
    assert _ints(t) == [_signed(-x) for x in va]
    for c in (0, 1, 7, 10 ** 9, (1 << 31) - 1):
        j, t = _both("mul_small", a, c)
        assert np.array_equal(j, t)
        assert _ints(t) == [_signed(x * c) for x in va]
    for k in (0, 1, 9, 10, 20, 38):
        j, t = _both("rescale", a, k)
        assert np.array_equal(j, t)
        assert _ints(t) == [_signed(x * 10 ** k) for x in va]


def test_half_limbs():
    a = _limbs(_values(8))
    j, t = _both("_to_halves", a)
    assert np.array_equal(j, t)
    j2, t2 = _both("_from_halves", t)
    assert np.array_equal(j2, t2) and np.array_equal(t2, a)


# --- through SQL ---------------------------------------------------------------


def _dec_table(seed: int, n: int = 3000):
    """A fact table with DECIMAL(38,2) / DECIMAL(38,0) columns (NULLs in
    one), a dictionary-coded group column and a DECIMAL(15,2) column."""
    rng = np.random.default_rng(seed)
    big = [int(v) * 10 ** 20 + int(w) for v, w in zip(
        rng.integers(-10 ** 15, 10 ** 15, n), rng.integers(0, 10 ** 18, n))]
    big[:4] = [(1 << 125), -(1 << 125), 0, -1]
    small = rng.integers(-50, 50, n)
    key = [int(k) * (10 ** 30) + 7 for k in rng.integers(-20, 20, n)]
    valid = rng.random(n) > 0.1
    grp = rng.integers(0, 5, n).astype(np.int32)
    price = rng.integers(-10 ** 9, 10 ** 9, n)
    return {
        "fact": [
            ("g", "VARCHAR", grp, ["a", "b", "c", "d", "e"], None),
            ("big", "DECIMAL(38,2)", _limbs(big), None, None),
            ("nb", "DECIMAL(38,2)", _limbs(small), None, valid),
            ("k", "DECIMAL(38,0)", _limbs(key), None, None),
            ("price", "DECIMAL(15,2)", price, None, None),
        ],
        "dim": [
            ("dk", "DECIMAL(38,0)",
             _limbs([int(k) * (10 ** 30) + 7 for k in range(-25, 25, 2)]),
             None, None),
            ("label", "BIGINT", np.arange(-25, 25, 2, dtype=np.int64), None,
             None),
        ],
    }


def _jax_catalog(spec: dict):
    """The same tables in a JAX catalog."""
    from starrocks_tpu import types as JT
    from starrocks_tpu.column.column import Field, Schema
    from starrocks_tpu.column.dict_encoding import StringDict

    cat = JCatalog()
    for name, cols in spec.items():
        fields, arrays, valids = [], {}, {}
        for col, tname, values, dvals, valid in cols:
            kind, _, rest = tname.partition("(")
            if kind == "DECIMAL":
                p, s = (int(x) for x in rest.rstrip(")").split(","))
                t = JT.DECIMAL(p, s)
            else:
                t = JT.LogicalType(JT.TypeKind[kind])
            d = None if dvals is None else StringDict.from_values(list(dvals))
            fields.append(Field(col, t, True, d))
            arrays[col] = np.asarray(values, dtype=t.np_dtype)
            if valid is not None:
                valids[col] = np.asarray(valid, dtype=bool)
        cat.register(name, JHostTable(Schema(tuple(fields)), arrays, valids))
    return cat


SQL = {
    "sum_min_max": "select g, sum(big) s, min(big) mn, max(big) mx, "
                   "sum(nb) sn, min(nb) mnn, max(nb) mxn, count(nb) c "
                   "from fact group by g order by g",
    "global": "select sum(big) s, min(nb) mn, max(nb) mx, count(*) c "
              "from fact",
    "key": "select k, count(*) c, sum(nb) s from fact group by k "
           "order by k",
    "sort": "select big, nb from fact order by nb desc nulls last, big "
            "limit 40",
    "sort_asc": "select k, big from fact order by big, k limit 25",
    "join": "select label, count(*) c, max(big) mx from fact join dim "
            "on k = dk group by label order by label",
    "compare": "select count(*) c from fact where big > nb and k <= 0 "
               "and nb <> 3",
    "arith": "select g, sum(big + nb) a, sum(big - price) b, "
             "max(nb * nb) p from fact group by g order by g",
    "cast": "select g, sum(cast(price as decimal(38,2))) s, "
            "min(cast(price as decimal(38,6))) mn from fact group by g "
            "order by g",
    "in_list": "select count(*) c from fact where nb in (3, -7, 12.5)",
}


@pytest.fixture(scope="module")
def dec_sessions():
    spec = _dec_table(11)
    return (JSession(_jax_catalog(spec)),
            Session(catalog_from_numpy(spec), device="cpu"))


@pytest.mark.parametrize("strategy", ["auto", "kernels"])
@pytest.mark.parametrize("name", sorted(SQL))
def test_dec128_sql_matches_jax(dec_sessions, name, strategy):
    js, ts = dec_sessions
    want = js.sql(SQL[name]).rows()
    set_knobs(tcfg, KERNEL_KNOBS if strategy == "kernels" else AUTO_KNOBS)
    got = ts.sql(SQL[name]).rows()
    assert got == want
    assert got and all(type(a) is type(b) for a, b in zip(got[0], want[0]))
    if name == "sum_min_max":
        assert isinstance(got[0][1], decimal.Decimal)


def test_dec128_host_columns_round_trip():
    vals = [decimal.Decimal("12345678901234567890123456.78"), None, 3, 2.5,
            "-0.01", decimal.Decimal(-(10 ** 35))]
    from starrocks_tpu import types as JT
    from starrocks_tpu_torch import types as TT

    j = JHostTable.from_pydict({"x": vals}, types={"x": JT.DECIMAL(38, 2)})
    t = THostTable.from_pydict({"x": vals}, types={"x": TT.DECIMAL(38, 2)})
    assert np.array_equal(j.arrays["x"], t.arrays["x"])
    assert np.array_equal(j.valids["x"], t.valids["x"])
    assert t.to_pylist() == j.to_pylist()
    back = THostTable.from_chunk(t.to_chunk(device="cpu"))
    assert back.to_pylist() == t.to_pylist()


@pytest.mark.parametrize("strategy", ["auto", "kernels"])
def test_b5_matches_jax(strategy):
    want = JSession(jax_tpch_catalog(sf=0.01)).sql(
        BREADTH_QUERIES["B5"]).rows()
    s = Session(tpch_catalog(sf=0.01), device="cpu")
    set_knobs(tcfg, KERNEL_KNOBS if strategy == "kernels" else AUTO_KNOBS)
    got = s.sql(BREADTH_QUERIES["B5"]).rows()
    assert rows_match(got, want) and got == want
    assert len(got) == 3 and isinstance(got[0][1], decimal.Decimal)
    assert jcfg.get("segment_strategy") == "auto"
