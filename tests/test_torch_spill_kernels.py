"""The batched aggregation of the PyTorch port under the kernel strategies
over TPC-H at SF 0.01: S2 of SPILL_QUERIES (S1 and B7 in
tests/test_torch_spill_b7.py), whose float sums
take the segment-sum kernel (its plain version on the CPU) in every
PARTIAL batch and in the FINAL merge. Rows against the JAX package under
the same strategies and against the port's in-memory path; a warm run
makes exactly (in-memory calls) x (batches + 1) segment_sum calls
(tests/torch_spill_parity.py)."""

import pytest
import torch

from torch_spill_parity import (  # noqa: F401 — fixture
    _default_knobs, check_spill_query, jax_spill_rows, port_catalog,
    port_in_memory,
)

QIDS = ("S2",)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The scatter-free sums are matmuls: two threads, not the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cat():
    return port_catalog()


@pytest.fixture(scope="module")
def jax_rows():
    return jax_spill_rows(QIDS, ("kernels",))


@pytest.fixture(scope="module")
def in_memory(cat):
    return port_in_memory(cat, QIDS, ("kernels",))


@pytest.mark.parametrize("q", QIDS)
def test_batched_kernel_sums_match_jax_and_the_derived_count(
        cat, jax_rows, in_memory, q):
    node = check_spill_query(q, "kernels", cat, jax_rows, in_memory)
    assert node["batches"] == 8
