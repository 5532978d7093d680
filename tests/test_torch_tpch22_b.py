"""The PyTorch port's second slice as a whole, part B: TPC-H Q12-Q22 and
the statistical queries S1/S2 from SQL text on the CPU at SF 0.01,
against the JAX package and the pandas oracle (part A,
tests/test_torch_tpch22_a.py, holds Q1-Q11).

Every query runs through `Session(..., device="cpu")` under the `auto`
strategies and under the kernel strategies (`segment_strategy =
'pallas'`, `join_probe_strategy = 'pallas_sorted'`, `topn_strategy =
'pallas'`). TPC-H rows equal the JAX package's and the oracle's:
integers, decimals, dates and strings exactly, in order; floats to 6
significant digits. Under the kernel strategies the port makes as many
calls of each kernel wrapper (its plain version on the CPU) as the JAX
package makes of the Pallas kernel it replaces: Q20 two sorted-build
probes, S1 two segment sums, S2 fourteen.

S1/S2 (variance / stddev / covariance / correlation) under `auto` sum
their float64 moments exactly as the reference does: 6 significant
digits. Under `pallas` both packages sum f32 row blocks, each in its own
order inside a block, and the variance's cancellation magnifies that:
port vs JAX to a relative STAT_KERNEL_REL, and vs the float64 answers to
STAT_F32_VS_F64_REL (tests/torch_tpch_parity.py gives the measurements).
"""

import pytest
import torch

from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import STAT_QUERIES

from tpch_oracle import ORACLES, load_frames
from tpch_queries import QUERIES
from torch_tpch_parity import (
    AUTO_KNOBS, KERNEL_KNOBS, SF, STAT_F32_VS_F64_REL, STAT_KERNEL_REL,
    jax_answers, oracle_match, port_run, reset_knobs, rows_match,
)

QIDS = tuple(range(12, 23))


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


@pytest.fixture(scope="module")
def jax_catalog():
    return jax_tpch_catalog(sf=SF)


@pytest.fixture(scope="module")
def reference(jax_catalog):
    texts = {q: QUERIES[q] for q in QIDS}
    texts.update(STAT_QUERIES)
    return jax_answers(jax_catalog, texts)


@pytest.fixture(scope="module")
def oracle_frames(jax_catalog):
    return load_frames(jax_catalog)


@pytest.fixture(scope="module")
def port_session():
    return Session(tpch_catalog(sf=SF), device="cpu")


def _new_calls(calls):
    return {k: v for k, v in calls.items()
            if k in ("probe_searchsorted", "segment_sum")}


@pytest.mark.parametrize("strategy", ["auto", "kernels"])
@pytest.mark.parametrize("qid", QIDS)
def test_query_matches_jax_and_oracle(reference, oracle_frames, port_session,
                                      qid, strategy):
    knobs = KERNEL_KNOBS if strategy == "kernels" else AUTO_KNOBS
    got, calls = port_run(port_session, QUERIES[qid], knobs)
    want = reference["rows"].get((strategy, qid), reference["rows"][("auto", qid)])
    assert rows_match(got, want), f"Q{qid} differs from JAX"
    assert oracle_match(got, ORACLES[qid](oracle_frames), qid), \
        f"Q{qid} differs from the oracle"
    if strategy == "auto":
        assert calls == {}
    else:
        assert _new_calls(calls) == reference["calls"].get(qid, {}), (qid, calls)


@pytest.mark.parametrize("qid", ["S1", "S2"])
def test_stat_query_under_auto(reference, port_session, qid):
    got, calls = port_run(port_session, STAT_QUERIES[qid], AUTO_KNOBS)
    assert got and calls == {}
    assert rows_match(got, reference["rows"][("auto", qid)])


@pytest.mark.parametrize("qid", ["S1", "S2"])
def test_stat_query_under_kernel_strategies(reference, port_session, qid):
    got, calls = port_run(port_session, STAT_QUERIES[qid], KERNEL_KNOBS)
    assert got
    assert rows_match(got, reference["rows"][("kernels", qid)],
                      rel=STAT_KERNEL_REL)
    assert rows_match(got, reference["rows"][("auto", qid)],
                      rel=STAT_F32_VS_F64_REL)
    assert _new_calls(calls) == reference["calls"][qid], calls


def test_jax_reference_routes(reference):
    """The reference's own routes under its kernel strategies, as counted:
    Q20 two sorted probes, S1 two segment sums, S2 fourteen; Q20's rows are
    its `auto` rows."""
    assert reference["rows"][("kernels", 20)] == reference["rows"][("auto", 20)]
    assert reference["calls"][20] == {"probe_searchsorted": 2}
    assert reference["calls"]["S1"] == {"segment_sum": 2}
    assert reference["calls"]["S2"] == {"segment_sum": 14}
