"""The batched (host-streamed) aggregation of the PyTorch port over TPC-H
at SF 0.01: Q1, Q6, S1, S2 and B7 of SPILL_QUERIES with lineitem streamed
in 8 batches, against the JAX package and against the port's in-memory
path (tests/torch_spill_parity.py): every query under `auto`, and Q1/Q6
(integer and decimal sums only) under the kernel strategies too. S1, S2
and B7 under the kernel strategies, with their segment_sum counts, are in
tests/test_torch_spill_kernels.py."""

import pytest
import torch

from torch_spill_parity import (  # noqa: F401 — fixture
    _default_knobs, check_spill_query, jax_spill_rows, port_catalog,
    port_in_memory,
)

QIDS = ("Q1", "Q6", "S1", "S2", "B7")
CASES = [(q, "auto") for q in QIDS] + [("Q1", "kernels"), ("Q6", "kernels")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cat():
    return port_catalog()


@pytest.fixture(scope="module")
def jax_rows():
    return jax_spill_rows(QIDS, ("auto",))


@pytest.fixture(scope="module")
def in_memory(cat):
    out = port_in_memory(cat, QIDS, ("auto",))
    out.update(port_in_memory(cat, ("Q6",), ("kernels",)))
    # Q1's in-memory rows under the kernel strategies are its `auto` rows
    # (integer and decimal sums are exact under every strategy)
    out[("kernels", "Q1")] = out[("auto", "Q1")]
    return out


@pytest.mark.parametrize("q,strategy", CASES)
def test_batched_aggregation_matches_jax(cat, jax_rows, in_memory, q,
                                         strategy):
    node = check_spill_query(q, strategy, cat, jax_rows, in_memory)
    assert node["batches"] == 8 and node["d2h_syncs"] == 1
    assert node["h2d_batches"] == 8 and node["h2d_bytes"] > 0
