"""The PyTorch port's second slice as a whole, part A: TPC-H Q1-Q11 from
SQL text on the CPU at SF 0.01, against the JAX package and the pandas
oracle (tests/test_torch_tpch22_b.py holds Q12-Q22 and S1/S2).

Every query runs through `Session(..., device="cpu")` under the `auto`
strategies and under the kernel strategies (`segment_strategy =
'pallas'`, `join_probe_strategy = 'pallas_sorted'`, `topn_strategy =
'pallas'`). The rows equal the JAX package's and the oracle's:
integers, decimals, dates and strings exactly, in order; floats to 6
significant digits. Under the kernel strategies the port makes as many
calls of each kernel wrapper (its plain version on the CPU) as the JAX
package makes of the Pallas kernel it replaces — Q9 one sorted-build
probe.
"""

import pytest
import torch

from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog

from tpch_oracle import ORACLES, load_frames
from tpch_queries import QUERIES
from torch_tpch_parity import (
    AUTO_KNOBS, KERNEL_KNOBS, SF, jax_answers, oracle_match, port_run,
    reset_knobs, rows_match,
)

QIDS = tuple(range(1, 12))


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
    return jax_answers(jax_catalog, {q: QUERIES[q] for q in QIDS})


@pytest.fixture(scope="module")
def oracle_frames(jax_catalog):
    return load_frames(jax_catalog)


@pytest.fixture(scope="module")
def port_session():
    return Session(tpch_catalog(sf=SF), device="cpu")


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
        new = {k: v for k, v in calls.items()
               if k in ("probe_searchsorted", "segment_sum")}
        assert new == reference["calls"].get(qid, {}), (qid, calls)


def test_jax_answers_alike_under_both_strategies(reference):
    """TPC-H sums only integers and decimals, so the reference's rows are
    the same under its kernel strategies; Q9 reaches its sorted probe."""
    assert reference["rows"][("kernels", 9)] == reference["rows"][("auto", 9)]
    assert reference["calls"][9] == {"probe_searchsorted": 1}


def test_port_query_texts_are_the_tests_copy():
    """chip_smoke.py and tools/torch_parity.py drive the port with its own
    copy of the query texts (the port imports nothing from tests/)."""
    from starrocks_tpu_torch.storage.tpch_queries import QUERIES as PORT_QUERIES

    assert PORT_QUERIES == QUERIES
