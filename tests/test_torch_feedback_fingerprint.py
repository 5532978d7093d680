"""The plan-feedback fingerprint of the PyTorch port
(starrocks_tpu_torch/runtime/feedback.py `plan_fingerprint`): it tracks the
plan-shaping knobs (tests/test_plan_feedback.py::test_fingerprint_tracks_
knobs), and, unlike the reference's, the plan's whole structure, so one
query's learned capacities never seed another's program (ROADMAP,
reference defects). The rest of the feedback loop:
tests/test_torch_feedback.py.
"""

import pytest

from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.feedback import plan_fingerprint
from starrocks_tpu_torch.runtime.session import Session as TSession



@pytest.fixture(autouse=True)
def _default_knobs():
    """The port's knobs back at their values after each test (this file
    runs no JAX Session, whose registry lacks some of the port's knobs
    until its cache modules load)."""
    before = {name: value for name, value, *_ in tcfg.items()}
    yield
    for name, value in before.items():
        tcfg.set(name, value, force=True)


def test_fingerprint_tracks_knobs_and_the_whole_plan():
    from starrocks_tpu_torch.sql.analyzer import Analyzer
    from starrocks_tpu_torch.sql.parser import parse
    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.tpch_queries import (
        QUERIES, STAT_QUERIES,
    )

    cat = tpch_catalog(sf=0.001)

    def fp(text):
        return plan_fingerprint(Analyzer(cat).analyze(parse(text)))

    f1 = fp(QUERIES[1])
    tcfg.set("enable_mv_rewrite", not tcfg.get("enable_mv_rewrite"))
    assert fp(QUERIES[1]) != f1, "an OPT_KEY knob flip changes it"
    tcfg.set("enable_mv_rewrite", not tcfg.get("enable_mv_rewrite"))
    assert fp(QUERIES[1]) == f1
    # distinct plans, distinct fingerprints (the reference's repr-based
    # one gives Q1, Q9, Q13 and S2 one fingerprint: ROADMAP, reference
    # defects)
    texts = [*QUERIES.values(), *STAT_QUERIES.values()]
    assert len({fp(t) for t in texts}) == len(texts)


def test_learned_caps_stay_with_their_own_query():
    """Q13's learned capacity must not seed S2's program: under the kernel
    strategies S2 keeps its 14 segment_sum calls after Q13 in one Session.
    (The reference's colliding fingerprints hand S2 Q13's 1500 group slots
    there, and S2 then runs without the kernel.)"""
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.config import KERNEL_STRATEGIES
    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.tpch_queries import (
        QUERIES, STAT_QUERIES,
    )

    for k, v in KERNEL_STRATEGIES.items():
        tcfg.set(k, v)
    s = TSession(tpch_catalog(sf=0.01), device="cpu")
    s.sql(QUERIES[13])
    kernels.reset_counts()
    s.sql(STAT_QUERIES["S2"])
    assert kernels.counts()["segment_sum"]["calls"] == 14
    assert s.last_profile.find("attempt_0").infos["capacities"][
        "agg_0"] == 1024


def test_self_join_of_a_cte_records_no_cards():
    """TPC-DS q47 joins three copies of one CTE (v1, v1_lag, v1_lead) that
    scan the same table:alias set, so a scanset-keyed observation cannot
    tell the copies from their joins. The reference records one anyway; on
    the next run its DP joins v1_lag with v1_lead first, a many-to-many
    join on three string keys (at SF 0.1: 481,319,721 rows where the first
    run's plan had 16,275; the reference runs out of memory). The port
    records no cards for such a query: the second run keeps the first
    run's plan and rows (ROADMAP, reference defects)."""
    from starrocks_tpu_torch.sql.logical import plan_tree_str
    from starrocks_tpu_torch.storage.datagen.tpcds import tpcds_catalog
    from starrocks_tpu_torch.storage.tpcds_queries import ALL_QUERIES

    s = TSession(tpcds_catalog(sf=0.01, seed=11), device="cpu")
    first = s.sql(ALL_QUERIES["q47"])
    entry = next(iter(s.cache.feedback._entries.values()))
    assert entry["cards"] == {}
    second = s.sql(ALL_QUERIES["q47"])
    assert second.profile.counters["feedback_hits"][0] == 1
    assert plan_tree_str(second.plan) == plan_tree_str(first.plan)
    assert second.rows() == first.rows()
