"""Shared machinery of the TPC-DS parity tests of the PyTorch port
(tests/test_torch_tpcds_a.py .. _f.py): each file takes one group of the
99 queries (q1-q99: `tests/tpcds_queries.py` and q67 of
`tests/test_tpcds_q67.py`) at SF 0.01, seed 11, and holds the port to the
JAX package.

- Under `auto`: every query of the group, the port's rows against the JAX
  Session's, exact but for floats (6 significant digits); no kernel
  wrapper is called.
- Under the kernel strategies: the group's window queries and the queries
  that call a kernel (`KERNEL_RUN_QUERIES`). Each kernel wrapper is called
  as often as `KERNEL_QUERIES` says (measured at this scale). The queries
  that call `segment_sum` sum float moments in f32 row blocks (the
  reference's contract) and are held to the JAX package under its kernel
  strategies at SEGMENT_SUM_REL (a relative 1e-4: q77 and q80 differ
  past the 6th digit); so are q6 and q41 (a sorted probe each), at 6
  digits. The other kernels (topn_select, probe_searchsorted) are exact:
  the reference's rows under its kernel strategies equal its rows under
  `auto` for every one of these queries (measured), so the port's rows
  there must equal its own `auto` rows exactly and the JAX package's
  `auto` rows to 6 digits.

The groups split the JAX package's CPU time (about 230 s in all) into six
files of about 40 s each; every JAX answer is computed once per file in a
module fixture, and its compiled programs are dropped when the file ends.
"""

from __future__ import annotations

import pytest
import torch

from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.datagen.tpcds import (
    tpcds_catalog as jax_tpcds_catalog,
)

from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.datagen.tpcds import tpcds_catalog
from starrocks_tpu_torch.storage.tpcds_queries import (
    ALL_QUERIES, KERNEL_QUERIES, KERNEL_RUN_QUERIES, SEGMENT_SUM_QUERIES,
    SEGMENT_SUM_REL,
)

from torch_tpch_parity import (
    AUTO_KNOBS, KERNEL_KNOBS, port_run, reset_knobs, rows_match, set_knobs,
)

SF = 0.01
# queries the JAX package also answers under its kernel strategies
JAX_KERNEL_QUERIES = frozenset(SEGMENT_SUM_QUERIES) | {"q6", "q41"}
GROUPS = {
    "a": ("q1", "q6", "q11", "q13", "q20", "q26", "q27", "q28", "q29", "q33",
          "q36", "q38", "q40", "q44", "q49", "q50", "q72", "q73", "q96"),
    "b": ("q2", "q5", "q10", "q18", "q19", "q23", "q24", "q39", "q43", "q45",
          "q48", "q52", "q63", "q71", "q74", "q78", "q82", "q92", "q93",
          "q99"),
    "c": ("q3", "q7", "q12", "q35", "q41", "q46", "q54", "q56", "q59", "q60",
          "q66", "q67", "q69", "q70", "q75", "q77", "q83", "q90", "q98"),
    "d": ("q4",),
    "e": ("q8", "q9", "q14", "q15", "q16", "q30", "q31", "q32", "q42", "q53",
          "q57", "q58", "q61", "q64", "q68", "q76", "q85", "q87", "q88",
          "q89"),
    "f": ("q17", "q21", "q22", "q25", "q34", "q37", "q47", "q51", "q55",
          "q62", "q65", "q79", "q80", "q81", "q84", "q86", "q91", "q94",
          "q95", "q97"),
}


def kernel_queries(group: str) -> tuple:
    return tuple(q for q in GROUPS[group] if q in KERNEL_RUN_QUERIES)


def jax_answers(group: str) -> dict:
    """{(strategy, q): rows} of the JAX Session for the group's queries:
    "auto" for each, "kernels" for those in JAX_KERNEL_QUERIES."""
    import jax

    reset_knobs()
    cat = jax_tpcds_catalog(sf=SF)
    s = JSession(cat)
    rows = {("auto", q): s.sql(ALL_QUERIES[q]).rows() for q in GROUPS[group]}
    set_knobs(jcfg, KERNEL_KNOBS)
    try:
        ks = JSession(cat)
        for q in GROUPS[group]:
            if q in JAX_KERNEL_QUERIES:
                rows[("kernels", q)] = ks.sql(ALL_QUERIES[q]).rows()
    finally:
        set_knobs(jcfg, AUTO_KNOBS)
        jax.clear_caches()
    return rows


def check_auto(reference, port_session, q):
    got, calls = port_run(port_session, ALL_QUERIES[q], AUTO_KNOBS)
    assert calls == {}, (q, calls)
    assert rows_match(got, reference[("auto", q)]), f"{q} differs from JAX"


def check_kernels(reference, port_session, q):
    got, calls = port_run(port_session, ALL_QUERIES[q], KERNEL_KNOBS)
    assert calls == KERNEL_QUERIES.get(q, {}), (q, calls)
    if q in JAX_KERNEL_QUERIES:
        rel = SEGMENT_SUM_REL if q in SEGMENT_SUM_QUERIES else 1e-6
        assert rows_match(got, reference[("kernels", q)], rel=rel), \
            f"{q} differs from JAX under the kernel strategies"
    else:
        own, _ = port_run(port_session, ALL_QUERIES[q], AUTO_KNOBS)
        assert got == own, f"{q}: the exact kernels changed the rows"
        assert rows_match(got, reference[("auto", q)]), \
            f"{q} differs from JAX"


def fixtures(group: str):
    """The module fixtures of one group's file: (reference, port_session,
    default knobs, one torch thread)."""

    @pytest.fixture(autouse=True, scope="module")
    def _one_torch_thread():
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)

    @pytest.fixture(scope="module")
    def reference():
        return jax_answers(group)

    @pytest.fixture(scope="module")
    def port_session():
        return Session(tpcds_catalog(sf=SF), device="cpu")

    @pytest.fixture(autouse=True)
    def _default_knobs():
        reset_knobs()
        yield
        reset_knobs()

    return reference, port_session, _default_knobs, _one_torch_thread
