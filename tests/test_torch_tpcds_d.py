"""TPC-DS on the PyTorch port, group d: its queries at SF 0.01 on the CPU
against the JAX package, under `auto` and (its window and kernel queries)
under the kernel strategies; the rules are tests/torch_tpcds_parity.py's."""

import pytest

from torch_tpcds_parity import (
    GROUPS, check_auto, check_kernels, fixtures, kernel_queries,
)

reference, port_session, _default_knobs, _one_torch_thread = fixtures("d")


@pytest.mark.parametrize("q", GROUPS["d"])
def test_auto_matches_jax(reference, port_session, q):
    check_auto(reference, port_session, q)


@pytest.mark.parametrize("q", kernel_queries("d"))
def test_kernels_match_jax(reference, port_session, q):
    check_kernels(reference, port_session, q)
