"""TPC-DS in the PyTorch port: the generator, the query texts, the window
queries and q67.

- `storage/datagen/tpcds.py` is a copy of the JAX package's generator:
  every one of the 24 tables at SF 0.01 (seed 11) equals the reference's,
  column by column (types, values, NULLs, dictionaries), and so do the
  unique keys the catalog registers.
- The port's query texts (`storage/tpcds_queries.py`) are the tests'
  copies; its WINDOW_QUERIES are the queries whose plans hold a window
  in both packages.
- q67 (ROLLUP, then rank() <= 10: the window top-N) at SF 0.003 against
  tests/test_tpcds_q67.py's pandas oracle, its `window_topn_pruned`
  counter, and `topn=10` in EXPLAIN.
"""

import numpy as np
import pytest

import test_tpcds_q67 as ref_q67
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.datagen import tpcds as jgen

from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.datagen import tpcds as tgen
from starrocks_tpu_torch.storage.tpcds_queries import (
    ALL_QUERIES, KERNEL_QUERIES, KERNEL_RUN_QUERIES, Q67, QUERIES,
    WINDOW_QUERIES,
)

from torch_tpch_parity import reset_knobs

TABLES = sorted(jgen.gen_tpcds(0.001))


@pytest.fixture(scope="module")
def tables():
    return jgen.gen_tpcds(0.01), tgen.gen_tpcds(0.01)


@pytest.mark.parametrize("name", TABLES)
def test_generator_table_matches_jax(tables, name):
    jt, tt = tables[0][name], tables[1][name]
    assert [f.name for f in tt.schema] == [f.name for f in jt.schema]
    for jf, tf in zip(jt.schema, tt.schema):
        assert repr(tf.type) == repr(jf.type), tf.name
        assert tf.nullable == jf.nullable, tf.name
        a, b = jt.arrays[jf.name], tt.arrays[tf.name]
        assert a.dtype == b.dtype and np.array_equal(a, b), tf.name
        va, vb = jt.valids.get(jf.name), tt.valids.get(tf.name)
        assert (va is None) == (vb is None), tf.name
        if va is not None:
            assert np.array_equal(va, vb), tf.name
        if jf.dict is not None:
            assert list(tf.dict.values) == list(jf.dict.values), tf.name
    assert tgen.TPCDS_UNIQUE_KEYS.get(name) == jgen.TPCDS_UNIQUE_KEYS.get(name)


def test_port_query_texts_are_the_tests_copies():
    from tpcds_queries import QUERIES as TEST_QUERIES

    assert QUERIES == TEST_QUERIES
    assert Q67 == ref_q67.Q67
    assert len(ALL_QUERIES) == 99
    assert set(KERNEL_QUERIES) <= set(KERNEL_RUN_QUERIES)
    assert set(WINDOW_QUERIES) <= set(KERNEL_RUN_QUERIES)


def test_window_queries_plan_a_window_in_both_packages():
    reset_knobs()
    cats = (jgen.tpcds_catalog(sf=0.001), tgen.tpcds_catalog(sf=0.001))
    js, ts = JSession(cats[0]), Session(cats[1], device="cpu")
    plans = {q: (js.sql("explain " + t), ts.sql("explain " + t))
             for q, t in ALL_QUERIES.items()}
    assert all(a == b for a, b in plans.values())
    assert sorted(q for q, (_, t) in plans.items() if "Window[" in t) == \
        sorted(WINDOW_QUERIES)


@pytest.fixture(scope="module")
def q67_scale():
    reset_knobs()
    return jgen.tpcds_catalog(sf=0.003), tgen.tpcds_catalog(sf=0.003)


def test_q67_matches_the_pandas_oracle(q67_scale):
    """tests/test_tpcds_q67.py's comparison, with the port's rows."""
    jcat, tcat = q67_scale
    got = Session(tcat, device="cpu").sql(Q67).rows()
    exp = ref_q67.oracle(jcat)
    assert len(got) == min(len(exp), 100) and got

    def norm(v):
        return None if v is None or (isinstance(v, float) and v != v) else v

    keys = ref_q67.KEYS
    exp_rows = [tuple(norm(r[k]) for k in keys) + (round(r["sumsales"], 2),
                                                   r["rk"])
                for _, r in exp.iterrows()]
    exp_rows.sort(key=lambda t: tuple((x is None, x) for x in t[:8])
                  + (t[8], t[9]))
    got_rows = [tuple(norm(v) for v in r[:8]) + (round(r[8], 2), r[9])
                for r in got]
    assert got_rows == exp_rows[:100]


def test_q67_window_topn_counter_and_explain(q67_scale):
    """The rk <= 10 filter becomes the window top-N: EXPLAIN shows topn=10
    in both packages, and the port reports the rows its prefilter dropped
    and its rank mask pruned, as the reference does."""
    jcat, tcat = q67_scale
    js, ts = JSession(jcat), Session(tcat, device="cpu")
    want = js.sql(Q67).rows()
    got = ts.sql(Q67).rows()
    assert got == want
    ctr = {k: v for k, (v, _) in ts.last_profile.counters.items()}
    jctr = js.last_profile.counters
    assert ctr["window_topn_pruned"] == jctr["window_topn_pruned"][0] >= 0
    # the same prefilter branch (the strided ladder under `auto`) in both
    assert ctr["window_topn_prefiltered"] == \
        jctr["window_topn_prefiltered"][0] > 0
    assert "topn=10" in ts.sql("explain " + Q67)
    assert ts.sql("explain " + Q67) == js.sql("explain " + Q67)


def test_query_intermediates_free_without_the_cyclic_collector():
    """A finished query leaves no intermediate tensor alive: the planner's
    emit closures reference each other, and their memo of every operator's
    output was freed only by Python's cyclic collector (q49 at SF 0.1 held
    381 MB past its end on the CPU; on the card the same kept gigabytes
    allocated into the next query). Measured as the bytes of live tensor
    storages, with the collector off, after a warm run against before it
    (the device cache holds the same columns at both points)."""
    import gc

    import torch

    def live_bytes():
        seen = {}
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.layout == torch.strided:
                st = o.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    reset_knobs()
    s = Session(tgen.tpcds_catalog(sf=0.01), device="cpu")
    s.sql(ALL_QUERIES["q49"]).rows()  # warm the caches and statistics
    gc.collect()
    gc.disable()
    try:
        before = live_bytes()
        assert s.sql(ALL_QUERIES["q49"]).rows()
        after = live_bytes()
    finally:
        gc.enable()
    assert after - before < (1 << 20), (before, after)
