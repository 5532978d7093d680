"""The port's 8-shard Session against the JAX package's 8-shard Session
(the 8 virtual CPU devices of tests/conftest.py), on the queries of
tests/test_distributed_sql.py: TPC-H SF 0.01, SSB-flat SF 0.005, the full
sorts (NULLs and dictionary keys included), the distributed top-N and the
PARTITION BY window. Integers, decimals, dates and strings must match
exactly and floats to 6 significant digits (the reduction orders differ);
queries whose sort keys order every row are compared in order."""

import pytest
import torch

import starrocks_tpu.sql.distributed as JD
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog
from starrocks_tpu.storage.datagen.ssb import ssb_catalog as jax_ssb_catalog

import starrocks_tpu_torch.sql.distributed as D
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog
from starrocks_tpu_torch.storage.datagen.ssb import ssb_catalog
from starrocks_tpu_torch.storage.ssb_queries import FLAT_QUERIES
from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

from torch_tpch_parity import reset_knobs, rows_match
from test_torch_distributed_sql import NULL_SORTS, _tnull_session

TPCH = ["Q1", "Q3", "Q5", "Q6", "Q10", "Q12", "Q14", "Q18", "Q19", "W2", "O1"]
ORDERED = {"Q1", "Q5", "Q6", "Q12", "Q14", "Q19", "O1"}
TOPN = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
        "order by l_extendedprice desc, l_orderkey, l_linenumber limit 37")
SORT = "select l_extendedprice from lineitem order by l_extendedprice desc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in six processes on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def thresholds(eight_devices):
    old = [(m, m.SHARD_THRESHOLD_ROWS, m.SHUFFLE_AGG_MIN_GROUPS)
           for m in (D, JD)]
    for m in (D, JD):
        m.SHARD_THRESHOLD_ROWS = 10_000
        m.SHUFFLE_AGG_MIN_GROUPS = 4_000
    reset_knobs()
    yield
    for m, a, b in old:
        m.SHARD_THRESHOLD_ROWS, m.SHUFFLE_AGG_MIN_GROUPS = a, b


@pytest.fixture(scope="module")
def catalogs():
    return jax_tpch_catalog(sf=0.01), tpch_catalog(sf=0.01)


def _agree(want, got, ordered, name):
    if not ordered:
        want, got = sorted(want, key=str), sorted(got, key=str)
    assert rows_match(got, want), f"{name}: {got[:3]} vs {want[:3]}"


@pytest.mark.parametrize("q", TPCH)
def test_tpch_8_shards_match_jax(catalogs, thresholds, q):
    jcat, tcat = catalogs
    want = JSession(jcat, dist_shards=8).sql(DIST_QUERIES[q]).rows()
    got = Session(tcat, device="cpu", dist_shards=8).sql(
        DIST_QUERIES[q]).rows()
    _agree(want, got, q in ORDERED, q)


def test_topn_and_full_sort_match_jax(catalogs, thresholds):
    jcat, tcat = catalogs
    j8 = JSession(jcat, dist_shards=8)
    t8 = Session(tcat, device="cpu", dist_shards=8)
    for q in (TOPN, SORT):
        assert t8.sql(q).rows() == j8.sql(q).rows(), q


def test_ssb_8_shards_match_jax(thresholds):
    for m in (D, JD):
        m.SHUFFLE_AGG_MIN_GROUPS = 32_768
    j8 = JSession(jax_ssb_catalog(sf=0.005), dist_shards=8)
    t8 = Session(ssb_catalog(sf=0.005), device="cpu", dist_shards=8)
    for q in ("q1.1", "q2.1", "q3.1", "q4.1"):
        _agree(j8.sql(FLAT_QUERIES[q]).rows(), t8.sql(FLAT_QUERIES[q]).rows(),
               False, q)


def test_null_and_dict_sorts_match_jax(thresholds):
    """The NULL-sentinel and dictionary-key branches of the range exchange,
    in exact order, on the same seeded table in both packages."""
    import numpy as np

    for m in (D, JD):
        m.SHARD_THRESHOLD_ROWS = 300
    t = _tnull_session()
    j = JSession()
    j.sql("create table tnull (v int, g varchar)")
    rows = t.sql("select v, g from tnull").rows()
    j.sql("insert into tnull values " + ", ".join(
        f"({'null' if v is None else v}, '{g}')" for v, g in rows))
    assert np.array_equal(
        np.asarray(j.catalog.get_table("tnull").table.arrays["v"]),
        t.catalog.get_table("tnull").table.arrays["v"])
    j8 = JSession(j.catalog, dist_shards=8)
    t8 = Session(t.catalog, device="cpu", dist_shards=8)
    for q in NULL_SORTS:
        assert t8.sql(q).rows() == j8.sql(q).rows(), q
