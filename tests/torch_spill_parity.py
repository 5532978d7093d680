"""Shared machinery of the TPC-H spill parity tests of the PyTorch port
(tests/test_torch_spill_agg.py, _kernels.py, _b7.py, _tpch.py): SPILL_QUERIES
at SF 0.01 with `batch_rows_threshold = spill_batch_rows = 8192`, so
lineitem (60,037 rows) streams in 8 batches and orders in 2.

Every query runs in a fresh Session of each package, so both start from
the same capacities (the batched aggregation's first run holds 4096 group
slots; its tightened capacity, 1024, takes the f32 segment-sum kernel
from the second run on). The port's rows are held to the JAX package's
and to the port's own rows without the threshold (the in-memory path).

Launch counts: the JAX package's counters count traces on this path (its
per-batch programs are jitted), so the port is held to a count derived
from the plan instead: a warm run under the kernel strategies makes, per
batch and once more in the FINAL merge, as many segment_sum calls as the
in-memory (COMPLETE) run of the same query makes.
"""

from __future__ import annotations

import pytest

from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.runtime import batched as tbatched
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.session import Session as TSession
from starrocks_tpu_torch.storage.catalog import tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import (
    SPILL_EXECUTORS, SPILL_QUERIES,
)

def node_view(profile, name: str):
    """A spill executor's child of a port RuntimeProfile as one dict (its
    infos and its counters' values), or None when the query has none."""
    for c in profile.children:
        if c.name == name:
            return {**c.infos, **{k: v for k, (v, _u) in c.counters.items()}}
    return None


from torch_tpch_parity import (
    AUTO_KNOBS, KERNEL_KNOBS, STAT_F32_VS_F64_REL, STAT_KERNEL_REL,
    reset_knobs, rows_match, set_knobs,
)

SF = 0.01
SPILL_ROWS = 8192
SPILL_KNOBS = {"batch_rows_threshold": SPILL_ROWS,
               "spill_batch_rows": SPILL_ROWS}
# the queries whose rows can differ between the strategy sets (f32 sums)
KERNEL_ROW_QUERIES = ("B7", "S1", "S2")
UNORDERED = ("W1",)
# B7's rounded cells (column: unit): s = round(avg(sqrt(..)), 4),
# pe = round(sum(..), 3); f32 sums in another order may move them by one
# unit in their rounded place (tests/test_torch_functions.py)
B7_ROUNDED_UNIT = {4: 1e-4, 12: 1e-3}


def knobs_of(strategy: str) -> dict:
    return KERNEL_KNOBS if strategy == "kernels" else AUTO_KNOBS


def jax_spill_rows(qids, strategies=("auto", "kernels")) -> dict:
    """{(strategy, q): rows} of the JAX package with the threshold: `auto`
    for every query, the kernel strategies for B7, S1 and S2; a fresh
    Session per query."""
    cat = jax_tpch_catalog(sf=SF)
    reset_knobs()
    out = {}
    try:
        for strategy in strategies:
            set_knobs(jcfg, {**knobs_of(strategy), **SPILL_KNOBS})
            for q in qids:
                if strategy == "kernels" and q not in KERNEL_ROW_QUERIES:
                    continue
                out[(strategy, q)] = JSession(cat).sql(
                    SPILL_QUERIES[q]).rows()
    finally:
        reset_knobs()
    return out


def port_in_memory(cat, qids, strategies=("auto", "kernels")) -> dict:
    """{(strategy, q): (rows, segment_sum calls)} of the port without the
    threshold (the in-memory COMPLETE path), one Session."""
    reset_knobs()
    s = TSession(cat, device="cpu")
    out = {}
    try:
        for strategy in strategies:
            set_knobs(tcfg, knobs_of(strategy))
            for q in qids:
                kernels.reset_counts()
                rows = s.sql(SPILL_QUERIES[q]).rows()
                out[(strategy, q)] = (
                    rows, kernels.counts()["segment_sum"]["calls"])
    finally:
        reset_knobs()
    return out


def port_catalog():
    return tpch_catalog(sf=SF)


def _sorted(q, rows):
    return sorted(rows, key=str) if q in UNORDERED else rows


def agree(q, got, want, rel) -> bool:
    got, want = _sorted(q, got), _sorted(q, want)
    if q != "B7" or rel <= 1e-6:
        return rows_match(got, want, rel=rel)

    def rest(rows):
        return [tuple(v for i, v in enumerate(r) if i not in B7_ROUNDED_UNIT)
                for r in rows]

    if len(got) != len(want) or not rows_match(rest(got), rest(want),
                                               rel=rel):
        return False
    return all(abs(g[i] - w[i]) <= max(
        unit * (1 + 1e-9), rel * max(abs(g[i]), abs(w[i])))
        for g, w in zip(got, want) for i, unit in B7_ROUNDED_UNIT.items())


def check_spill_query(q, strategy, cat, jax_rows, in_memory,
                      warm_runs: int = 1):
    """One spill query, cold then (for the f32 queries under the kernel
    strategies) warm, in a fresh port Session: rows against the JAX
    package and the in-memory path, the executor that ran, the gauge, and
    the derived segment_sum count."""
    set_knobs(tcfg, {**knobs_of(strategy), **SPILL_KNOBS})
    s = TSession(cat, device="cpu")
    kernels.reset_counts()
    got = s.sql(SPILL_QUERIES[q]).rows()
    cold_calls = kernels.counts()["segment_sum"]["calls"]
    node = node_view(s.last_profile, SPILL_EXECUTORS[q])
    assert node is not None, [c.name for c in s.last_profile.children]
    assert tbatched.SPILL_PARTS_LIVE.value == 0
    want = jax_rows.get((strategy, q)) or jax_rows[("auto", q)]
    f32 = strategy == "kernels" and q in KERNEL_ROW_QUERIES
    assert agree(q, got, want, STAT_KERNEL_REL if f32 else 1e-6), (
        q, got[:2], want[:2])
    base_rows, base_calls = in_memory[(strategy, q)]
    assert agree(q, got, base_rows, STAT_F32_VS_F64_REL if f32 else 1e-6)
    if not f32:
        assert cold_calls == 0
        return node
    batches = node["batches"]
    expected = base_calls * (batches + 1)
    assert base_calls > 0 and cold_calls in (0, expected), (
        cold_calls, expected)
    # a warm run's tightened capacity takes the kernel (the cold run did
    # already where 4096 group slots were no bar: a global aggregation)
    for _ in range(warm_runs if cold_calls == 0 else 0):
        kernels.reset_counts()
        warm = s.sql(SPILL_QUERIES[q]).rows()
        assert kernels.counts()["segment_sum"]["calls"] == expected
        assert node_view(s.last_profile, "batched")["batches"] == batches
        assert agree(q, warm, base_rows, STAT_F32_VS_F64_REL)
    return node


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()
