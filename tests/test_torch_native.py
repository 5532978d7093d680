"""The native filter-sum lane of the PyTorch port (`SET segment_strategy =
'native'`: runtime/executor.py `_try_native_scan_agg` over the host C++
function in csrc/host/fused_filter_sum.cpp) against the JAX package's.

The C++ function is held to the reference's copy (native/sr_native.cpp)
and to numpy on seeded int64 columns, every compare op and the sum with
and without a second factor. Through SQL, on the data of
tests/test_storage.py's native-lane test (built with `catalog_from_numpy`,
the port having no DDL): the lane's rows equal `auto`'s and the JAX
Session's, it is taken for the q1.x shape (`native_fused ==
'filter_sum'`), an empty match gives NULL, and a NULL-bearing column
declines it. On SSB-flat: NL1-NL3 (`NATIVE_QUERIES`) take the lane and
q1.1-q1.3 (a DECIMAL sum) decline it, with the rows of `auto`.
"""

import numpy as np
import pytest

from starrocks_tpu import native as jnative
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import Catalog as JCatalog
from starrocks_tpu.storage.datagen.ssb import ssb_catalog as jax_ssb_catalog

from starrocks_tpu_torch import native
from starrocks_tpu_torch.ops import segment as tseg
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import catalog_from_numpy
from starrocks_tpu_torch.storage.datagen.ssb import ssb_catalog
from starrocks_tpu_torch.storage.ssb_queries import FLAT_QUERIES, NATIVE_QUERIES

from torch_tpch_parity import jcfg, reset_knobs, tcfg


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


def _np_lane(cols, ops, vals, a, b):
    keep = np.ones(len(a), bool)
    for c, op, v in zip(cols, ops, vals):
        keep &= {0: c == v, 1: c != v, 2: c < v, 3: c <= v, 4: c > v,
                 5: c >= v}[op]
    prod = a[keep] if b is None else a[keep] * b[keep]
    return int(prod.sum()), int(keep.sum())


@pytest.mark.parametrize("n", [1000, 1 << 17])  # one thread / eight
@pytest.mark.parametrize("with_b", [True, False])
def test_fused_filter_sum_matches_the_reference(n, with_b):
    rng = np.random.default_rng(n + with_b)
    cols = [rng.integers(0, 12, n), rng.integers(-5, 5, n),
            rng.integers(0, 50, n)]
    a = rng.integers(-10 ** 6, 10 ** 6, n)
    b = rng.integers(0, 11, n) if with_b else None
    for ops, vals in (([5, 3, 2], [1, 3, 25]), ([0, 1, 4], [4, -2, 10]),
                      ([2], [0]), ([4, 5], [11, 100])):
        k = len(ops)
        got = native.fused_filter_sum_i64(cols[:k], ops, vals, a, b)
        assert got == _np_lane(cols[:k], ops, vals, a, b)
        want = jnative.fused_filter_sum_i64(cols[:k], ops, vals, a, b)
        if want is not None:  # the reference's lane where its build exists
            assert got == want


def test_lane_rejects_ragged_columns():
    with pytest.raises(ValueError):
        native.fused_filter_sum_i64([np.arange(5)], [0], [1], np.arange(4))


# tests/test_storage.py's data and queries
def _storage_data():
    i = np.arange(5000)
    nn_valid = i % 97 != 0
    return {"f": [
        ("d", "BIGINT", 19940101 + i % 300, None, None),
        ("disc", "BIGINT", i % 11, None, None),
        ("qty", "BIGINT", i % 50, None, None),
        ("price", "BIGINT", i * 7 % 1000, None, None),
        ("nn", "BIGINT", np.where(nn_valid, i, 0), None, nn_valid),
    ]}


LANE_SQL = [
    "select sum(price * disc) rev from f where d >= 19940110 and "
    "d <= 19940210 and disc >= 4 and disc <= 6 and qty < 25",
    "select sum(price) p from f where disc = 3",
    # empty match: the sum of nothing stays NULL on both paths
    "select sum(price * disc) rev from f where qty > 10000",
    # NULL-bearing column in the sum: the lane declines
    "select sum(nn) z from f where disc >= 9",
    # another shape (grouped): the lane declines
    "select disc, sum(price) p from f where qty < 3 group by disc "
    "order by disc",
]
TAKES_LANE = [True, True, True, False, False]


@pytest.fixture(scope="module")
def lane_sessions():
    from starrocks_tpu import types as JT
    from starrocks_tpu.column.column import Field, Schema

    spec = _storage_data()
    fields, arrays, valids = [], {}, {}
    for col, _, values, _, valid in spec["f"]:
        fields.append(Field(col, JT.BIGINT, True))
        arrays[col] = np.asarray(values, np.int64)
        if valid is not None:
            valids[col] = valid
    jcat = JCatalog()
    jcat.register("f", JHostTable(Schema(tuple(fields)), arrays, valids))
    return JSession(jcat), Session(catalog_from_numpy(spec), device="cpu")


@pytest.mark.parametrize("k", range(len(LANE_SQL)))
def test_native_lane_sql_matches_auto_and_jax(lane_sessions, k):
    js, ts = lane_sessions
    base = ts.sql(LANE_SQL[k]).rows()
    want = js.sql(LANE_SQL[k]).rows()
    tcfg.set("segment_strategy", "native")
    jcfg.set("segment_strategy", "native")
    r = ts.sql(LANE_SQL[k])
    jr = js.sql(LANE_SQL[k])
    assert r.rows() == base == want == jr.rows()
    took = r.profile.infos.get("native_fused") == "filter_sum"
    assert took == TAKES_LANE[k]
    if took:
        assert r.profile.counters["native_fused_rows"][0] == 5000
        assert jr.profile.infos.get("native_fused") == "filter_sum"
    if k == 2:
        assert base == [(None,)]


def test_native_routes_other_reductions_as_scatter():
    """Under `native` a reduction the lane does not take runs exactly as
    under `scatter`, as in the reference."""
    tcfg.set("segment_strategy", "native")
    assert tseg._strategy() == "scatter" and not tseg._use_mxu()
    tcfg.set("segment_strategy", "bogus")
    with pytest.raises(ValueError, match="unknown segment_strategy"):
        tseg._strategy()


@pytest.fixture(scope="module")
def ssb_sessions():
    return (JSession(jax_ssb_catalog(sf=0.005)),
            Session(ssb_catalog(sf=0.005), device="cpu"))


@pytest.mark.parametrize("q", sorted(NATIVE_QUERIES) + ["q1.1", "q1.2",
                                                         "q1.3"])
def test_ssb_lane_takes_nl_and_declines_q1(ssb_sessions, q):
    js, ts = ssb_sessions
    text = NATIVE_QUERIES.get(q) or FLAT_QUERIES[q]
    base = ts.sql(text).rows()
    tcfg.set("segment_strategy", "native")
    jcfg.set("segment_strategy", "native")
    r = ts.sql(text)
    jr = js.sql(text)
    assert r.rows() == base == jr.rows()
    assert base[0][0] is not None
    took = r.profile.infos.get("native_fused") == "filter_sum"
    assert took == q.startswith("NL")
    assert (jr.profile is not None and jr.profile.infos.get(
        "native_fused") == "filter_sum") == took
