"""The port's top-N path on the CPU: N1-N3 (`TOPN_QUERIES`, ORDER BY ..
LIMIT over lineitem and orders) against the JAX package and a pandas
oracle, and the candidates' threshold reduction against the full stable
sort.

- N1-N3 at SF 0.01 through `Session(..., device="cpu")` under
  `topn_strategy` 'pallas', 'auto' and 'lexsort' answer exactly as the JAX
  Session under 'auto' and as a pandas stable sort of the table in row
  order (ties by the lower row), and under 'pallas' each reaches the
  top-N kernel's wrapper with k = 1024 (`pad_capacity` of every LIMIT up
  to 1024);
- `ops/sort.first_kk_desc` returns the indices of the full stable
  descending sort: seeded and hypothesis cases with heavy ties, all-equal
  keys, INT64_MIN/INT64_MAX, 1 to 64 blocks, fewer live rows than kk, and
  kk both at most and above the number of blocks (its two thresholds),
  on the keys themselves (the `auto` route) and on the kernel's plain
  candidates (the `pallas` route).
"""

import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.ops.sort import first_kk_desc
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import TOPN_QUERIES

from tpch_oracle import load_frames

SF = 0.01
I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)
# N3 with a filter that leaves fewer live rows than its LIMIT and k
FEW_LIVE = ("SELECT o_orderkey, o_custkey, o_totalprice, o_orderdate "
            "FROM orders WHERE o_orderdate >= DATE '1998-02-01' "
            "ORDER BY o_totalprice DESC, o_orderkey LIMIT 1000")
TEXTS = {**TOPN_QUERIES, "N3_few_live": FEW_LIVE}


def _reset_knobs(cfg):
    for name, _, _, mutable, _ in tcfg.items():
        # a knob a plane module defines when it loads may not be in the
        # other registry yet
        if mutable and name in cfg._fields:
            cfg.set(name, cfg._fields[name].default)


@pytest.fixture(autouse=True)
def _default_knobs():
    _reset_knobs(tcfg)
    _reset_knobs(jcfg)
    yield
    _reset_knobs(tcfg)


@pytest.fixture(scope="module")
def jax_catalog():
    return jax_tpch_catalog(sf=SF)


@pytest.fixture(scope="module")
def jax_rows(jax_catalog):
    _reset_knobs(jcfg)
    s = JSession(jax_catalog)
    return {q: s.sql(t).rows() for q, t in TEXTS.items()}


def _oracle(frames, q):
    """A pandas stable sort of the table in row order: ties keep the lower
    row first, as the engine's sort does."""
    if q in ("N1", "N2"):
        li = frames["lineitem"]
        if q == "N1":
            return li.sort_values(
                ["l_extendedprice", "l_orderkey", "l_linenumber"],
                ascending=[False, True, True], kind="stable").head(100)[
                ["l_orderkey", "l_linenumber", "l_extendedprice"]]
        return li.sort_values("l_quantity", ascending=False,
                              kind="stable").head(100)[
            ["l_orderkey", "l_linenumber", "l_quantity"]]
    o = frames["orders"]
    since = "1995-01-01" if q == "N3" else "1998-02-01"
    o = o[o.o_orderdate >= pd.Timestamp(since)]
    return o.sort_values(["o_totalprice", "o_orderkey"],
                         ascending=[False, True], kind="stable").head(1000)[
        ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate"]]


def _norm(v):
    if isinstance(v, pd.Timestamp):
        return v.strftime("%Y-%m-%d")
    if isinstance(v, (np.integer, int, np.floating, float)):
        return float(v)
    return str(v)


@pytest.fixture(scope="module")
def oracle_rows(jax_catalog):
    frames = load_frames(jax_catalog)
    return {q: [tuple(_norm(v) for v in r)
                for r in _oracle(frames, q).itertuples(index=False)]
            for q in TEXTS}


@pytest.fixture(scope="module")
def port_catalog():
    return tpch_catalog(sf=SF)


@pytest.mark.parametrize("strategy", ["pallas", "auto", "lexsort"])
@pytest.mark.parametrize("q", list(TEXTS))
def test_topn_queries_match_jax_and_oracle(port_catalog, jax_rows,
                                           oracle_rows, strategy, q):
    s = Session(port_catalog, device="cpu")
    s.sql(f"SET topn_strategy = '{strategy}'")
    kernels.reset_counts()
    got = s.sql(TEXTS[q]).rows()
    assert len(got) > 0
    assert got == jax_rows[q]
    assert [tuple(_norm(v) for v in r) for r in got] == oracle_rows[q]
    assert kernels.topn_select.launches == 0
    if strategy == "pallas":
        assert kernels.topn_select.calls >= 1
        assert kernels.topn_select.last_shape[1] == 1024
    else:
        assert kernels.topn_select.calls == 0


def test_few_live_rows_fewer_than_limit(jax_rows):
    assert 0 < len(jax_rows["N3_few_live"]) < 1000


def _reduction_cases(seed=21):
    rng = np.random.default_rng(seed)
    cases = []
    for nb in (1, 2, 7, 64):
        cases.append((f"ties{nb}", rng.integers(-3, 3, nb * 1024)))
        cases.append((f"wide{nb}", rng.integers(-(1 << 62), 1 << 62,
                                                nb * 1024)))
    cases.append(("all_equal", np.full(5 * 1024, 7)))
    x = rng.integers(-2, 2, 8 * 1024)
    x[rng.integers(0, len(x), 900)] = I64MIN
    x[rng.integers(0, len(x), 300)] = I64MAX
    cases.append(("int64_extremes", x))
    x = np.full(4 * 1024, I64MIN)
    x[rng.integers(0, len(x), 50)] = rng.integers(-9, 9, 50)
    cases.append(("fewer_live_than_kk", x))
    cases.append(("all_dead", np.full(3 * 1024, I64MIN)))
    return [(n, np.asarray(x, np.int64)) for n, x in cases]


def _full(x, kk):
    return torch.sort(x, descending=True, stable=True).indices[:kk]


@pytest.mark.parametrize("case", [c[0] for c in _reduction_cases()])
def test_threshold_reduction_equals_full_sort(case):
    x = torch.from_numpy(dict(_reduction_cases())[case])
    for kk in (1, 5, 7, 64, 100, 1024, 4096):
        assert torch.equal(first_kk_desc(x, kk), _full(x, kk)), kk
    # the pallas route: the kernel's plain candidates, then the reduction
    cv, ci = kernels.topn_select_plain(x, 1024)
    assert torch.equal(first_kk_desc(cv, 1024), _full(cv, 1024))


@settings(max_examples=80, deadline=None)
@given(blocks=st.integers(1, 64), domain=st.sampled_from([1, 2, 5, 1 << 40]),
       extremes=st.integers(0, 200),
       kk=st.sampled_from([1, 2, 7, 33, 64, 100, 1024, 2048]),
       seed=st.integers(0, 2**32 - 1))
def test_threshold_reduction_hypothesis(blocks, domain, extremes, kk, seed):
    rng = np.random.default_rng(seed)
    n = blocks * 1024
    x = rng.integers(-domain, domain + 1, n)
    x[rng.integers(0, n, extremes)] = I64MIN
    x[rng.integers(0, n, extremes // 4)] = I64MAX
    t = torch.from_numpy(x.astype(np.int64))
    assert torch.equal(first_kk_desc(t, kk), _full(t, kk))
    cv, _ = kernels.topn_select_plain(t, min(kk, 1024))
    assert torch.equal(first_kk_desc(cv, kk), _full(cv, kk))
