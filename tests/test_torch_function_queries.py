"""The `functions` path's queries (FUNCTION_QUERIES F1-F11, the rest of
the scalar-function surface over TPC-H) at SF 0.01 in the PyTorch port,
against the JAX Session under both strategy sets.

- Under `auto` the rows agree exactly, floats to 6 significant digits.
- Under the kernel strategies the same, except the float cells of the
  queries that reach the segment-sum kernel (F1, F10, F11): those are f32
  block sums in both packages, held to each other at STAT_KERNEL_REL.
- The port calls each kernel wrapper as often as the JAX package calls the
  matching Pallas entry point (segment_sum ×2 in F1 and F11, ×1 in F10;
  topn_select ×1 in F3).
- F10 runs a Python UDF registered in both packages (FUNCTION_UDF).
"""

import pytest

from starrocks_tpu.ops import pallas_kernels as jpk
from starrocks_tpu.runtime import udf as judf
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.runtime import udf as tudf
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import (
    FUNCTION_QUERIES, FUNCTION_UDF,
)

from torch_tpch_parity import (
    AUTO_KNOBS, KERNEL_KNOBS, STAT_KERNEL_REL, jcfg, reset_knobs, rows_match,
    set_knobs, tcfg,
)

SF = 0.01
SEGMENT_SUM_QUERIES = {"F1", "F10", "F11"}
JAX_KERNELS = {"segment_sum": "segment_sum_pallas",
               "topn_select": "topn_select_pallas"}


@pytest.fixture(scope="module")
def answers():
    """The JAX package's rows under both strategy sets, and its Pallas
    calls per query under the kernel strategies."""
    reset_knobs()
    cat = jax_tpch_catalog(sf=SF)
    JSession(cat).sql(FUNCTION_UDF)
    rows, calls, counter = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for port_name, jax_name in JAX_KERNELS.items():
            fn = getattr(jpk, jax_name)

            def counted(*a, _fn=fn, _n=port_name, **k):
                counter[_n] = counter.get(_n, 0) + 1
                return _fn(*a, **k)

            mp.setattr(jpk, jax_name, counted)
        for strategy, knobs in (("auto", AUTO_KNOBS),
                                ("kernels", KERNEL_KNOBS)):
            set_knobs(jcfg, knobs)
            try:
                for q, text in FUNCTION_QUERIES.items():
                    counter.clear()
                    rows[(strategy, q)] = JSession(cat).sql(text).rows()
                    if strategy == "kernels":
                        calls[q] = dict(counter)
            finally:
                set_knobs(jcfg, AUTO_KNOBS)
    yield {"rows": rows, "calls": calls}
    judf._REGISTRY.clear()


@pytest.fixture(scope="module")
def port_session(answers):
    s = Session(tpch_catalog(sf=SF), device="cpu")
    s.sql(FUNCTION_UDF)
    yield s
    tudf._REGISTRY.clear()
    reset_knobs()


@pytest.mark.parametrize("strategy", ["auto", "kernels"])
@pytest.mark.parametrize("q", sorted(FUNCTION_QUERIES, key=lambda k: int(k[1:])))
def test_function_query_matches_jax(answers, port_session, q, strategy):
    knobs = KERNEL_KNOBS if strategy == "kernels" else AUTO_KNOBS
    set_knobs(tcfg, knobs)
    kernels.reset_counts()
    try:
        got = port_session.sql(FUNCTION_QUERIES[q]).rows()
    finally:
        set_knobs(tcfg, AUTO_KNOBS)
    want = answers["rows"][(strategy, q)]
    rel = (STAT_KERNEL_REL
           if strategy == "kernels" and q in SEGMENT_SUM_QUERIES else 1e-6)
    assert got and rows_match(got, want, rel=rel), (got[:3], want[:3])
    if strategy == "kernels":
        port_calls = {k: v["calls"] for k, v in kernels.counts().items()
                      if v["calls"]}
        assert port_calls == answers["calls"][q]


def test_kernel_calls_of_the_path(answers):
    """The JAX package's Pallas calls at SF 0.01 on this path, as the port
    is held to them above."""
    assert answers["calls"]["F1"] == {"segment_sum": 2}
    assert answers["calls"]["F3"] == {"topn_select": 1}
    assert answers["calls"]["F10"] == {"segment_sum": 1}
    assert answers["calls"]["F11"] == {"segment_sum": 2}


def test_unnest_capacity_and_udf_seconds(port_session):
    """F5's unnest overflows its first capacity (4x the lineitem chunk) no
    more than the adaptive loop allows, and F10 records its host seconds."""
    port_session.sql(FUNCTION_QUERIES["F5"])
    assert port_session.last_profile.counters["recompiles"][0] <= 1
    port_session.sql(FUNCTION_QUERIES["F10"])
    assert port_session.last_profile.counters["udf"][0] > 0
