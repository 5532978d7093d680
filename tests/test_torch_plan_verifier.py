"""Port counterpart of tests/test_plan_verifier.py: golden bad-plan
fixtures that MUST fail strict, and the clean-corpus guarantee (every
TPC-H/SSB/TPC-DS query's plan passes), over starrocks_tpu_torch.

The plan passes (plan_check, key_check) are copies of the reference's and
run unchanged. The jaxpr audits of trace_check are re-derived for eager
torch (analysis/trace_check.py): the float64 promotion is seen by a torch
dispatch mode over one run, and a profile counter's merge by the mesh's
record of its reductions (the in-process mesh of parallel/mesh.py), so the
reference's counter fixtures become programs over that mesh.
"""

import numpy as np
import pytest
import torch

from starrocks_tpu_torch.analysis import Finding, VerifyError, report
from starrocks_tpu_torch.analysis import key_check, plan_check, trace_check
from starrocks_tpu_torch.exprs.ir import AggExpr, Call, Col, Lit
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.sql.logical import (
    LAggregate, LFilter, LJoin, LProject, LScan, LSort,
)
from starrocks_tpu_torch.storage.catalog import tpch_catalog


def Session(*args, **kwargs):
    """The port's Session on the CPU (its entry points default to the
    card)."""
    kwargs.setdefault("device", "cpu")
    return _Session(*args, **kwargs)


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)


@pytest.fixture(scope="module")
def catalog():
    return tpch_catalog(sf=0.001)


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


def _counter_total(profile, name) -> float:
    """A counter summed over a RuntimeProfile and its children (attempts
    carry the compile-time findings)."""
    own = profile.counters.get(name, (0, ""))[0]
    return own + sum(_counter_total(c, name) for c in profile.children)

# --- golden fixture 1: schema mismatch ---------------------------------------


def test_schema_mismatch_rejected(catalog):
    scan = LScan("nation", "nation", ("n_nationkey", "n_name"))
    bad = LFilter(scan, Call("eq", Col("nation.n_regionkey"), Lit(1)))
    findings = plan_check.check_plan(bad, catalog)
    errs = _errors(findings)
    assert errs, "schema mismatch must be an error finding"
    f = errs[0]
    assert f.invariant == "schema-agreement"
    assert "n_regionkey" in f.message
    assert "Filter" in f.node  # names the offending op
    with pytest.raises(VerifyError):
        report(findings, level="strict")


def test_schema_join_condition_and_duplicates(catalog):
    l = LScan("nation", "n1", ("n_nationkey",))
    r = LScan("region", "r1", ("r_regionkey",))
    bad = LJoin(l, r, "inner",
                Call("eq", Col("n1.n_nationkey"), Col("r1.r_name")))
    errs = _errors(plan_check.check_plan(bad, catalog))
    assert any(f.invariant == "schema-agreement" and "r_name" in f.message
               for f in errs)
    # ambiguous outputs: same alias+column from both sides
    dup = LJoin(LScan("nation", "n1", ("n_nationkey",)),
                LScan("nation", "n1", ("n_nationkey",)), "inner",
                Call("eq", Col("n1.n_nationkey"), Col("n1.n_nationkey")))
    errs = _errors(plan_check.check_plan(dup, catalog))
    assert any("ambiguous" in f.message or "duplicate" in f.message
               for f in errs)


def test_dtype_mismatch_rejected(catalog):
    # joining an int key against a dict-coded string column compares codes
    # to values
    l = LScan("nation", "n1", ("n_nationkey",))
    r = LScan("region", "r1", ("r_name",))
    bad = LJoin(l, r, "inner",
                Call("eq", Col("n1.n_nationkey"), Col("r1.r_name")))
    findings = plan_check.check_dtypes(bad, catalog)
    assert any(f.invariant == "dtype-agreement" for f in _errors(findings))


# --- golden fixture 2: replicated-operand join without exchange --------------


def test_replicated_join_without_exchange_rejected(catalog):
    from starrocks_tpu_torch.sql.distributed import REPLICATED, SHARDED

    probe = LScan("nation", "n1", ("n_nationkey", "n_name"))
    build = LScan("customer", "c1", ("c_custkey", "c_nationkey"))
    join = LJoin(probe, build, "inner",
                 Call("eq", Col("n1.n_nationkey"), Col("c1.c_nationkey")))
    # declared physical plan: replicated probe x partitioned build, NO
    # exchange — each shard would join the whole probe against one build
    # fragment and the "result" is per-shard garbage
    modes = {id(probe): REPLICATED, id(build): SHARDED}
    findings = plan_check.check_distribution(
        join, catalog, scan_modes=modes, managed_exchanges=False)
    errs = _errors(findings)
    assert any(f.invariant == "distribution"
               and "replicated probe" in f.message
               and "Join" in f.node for f in errs)
    with pytest.raises(VerifyError):
        report(findings, level="strict")
    # same operands WITH compiler-managed exchanges: legal
    clean = plan_check.check_distribution(
        join, catalog, scan_modes=modes, managed_exchanges=True)
    assert not _errors(clean)


def test_uncolocated_sharded_join_needs_exchange(catalog):
    from starrocks_tpu_torch.sql.distributed import SHARDED

    a = LScan("orders", "o", ("o_orderkey", "o_custkey"))
    b = LScan("lineitem", "l", ("l_orderkey",))
    join = LJoin(a, b, "inner",
                 Call("eq", Col("o.o_orderkey"), Col("l.l_orderkey")))
    modes = {id(a): SHARDED, id(b): SHARDED}
    errs = _errors(plan_check.check_distribution(
        join, catalog, scan_modes=modes, managed_exchanges=False))
    assert any("not colocated" in f.message for f in errs)
    # hash-colocated on the join keys: no exchange needed even undeclared
    modes = {id(a): ("hash", "o.o_orderkey"), id(b): ("hash", "l.l_orderkey")}
    plan2 = LAggregate(join, (("k", Col("o.o_orderkey")),),
                       (("n", AggExpr("count", None)),))
    findings = plan_check.check_distribution(
        plan2, catalog, scan_modes=modes, managed_exchanges=False)
    assert not [f for f in _errors(findings) if "Join" in f.node]


# --- golden fixture 3: non-psum profile counter on a sharded stage -----------


def _counter_program(merge: str, shards=None):
    """A program over the 8-shard in-process mesh whose `~ctr_` counter
    merges each shard's count by `merge` (psum or pmax) over `shards`
    (all by default)."""
    from starrocks_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8, device="cpu")
    x = torch.ones(64, dtype=torch.int64)

    def run():
        per_shard = [c.sum() for c in x.chunk(8)]  # per-shard counts
        picked = per_shard if shards is None else [per_shard[i]
                                                   for i in shards]
        ctr = getattr(mesh, merge)(picked)
        return None, {"~ctr_rows_pruned@0": ctr}

    return run, mesh


def _audit(run, mesh):
    return trace_check.audit_program(run, checks_of=lambda r: r[1],
                                     mesh=mesh)[1]


def test_non_psum_counter_rejected():
    findings = _audit(*_counter_program("pmax"))
    errs = _errors(findings)
    assert any(f.invariant == "non-psum-counter" for f in errs), findings
    with pytest.raises(VerifyError):
        report(findings, level="strict")


def test_psum_counter_clean():
    findings = _audit(*_counter_program("psum"))
    assert not [f for f in findings if f.invariant == "non-psum-counter"], \
        findings


# --- golden fixture 3b: counter merged only within a subgroup of shards ----


def test_subgroup_psum_counter_rejected():
    """A counter summed over shards 0-3 only: the other group's partial is
    lost to any later merge."""
    findings = _audit(*_counter_program("psum", shards=[0, 1, 2, 3]))
    errs = _errors(findings)
    assert any(f.invariant == "subgroup-psum-counter" for f in errs), findings
    # the grouped merge must NOT also satisfy the plain psum check
    assert not [f for f in findings if f.invariant == "non-psum-counter"], \
        findings
    with pytest.raises(VerifyError):
        report(findings, level="strict")


def test_distributed_corpus_counters_clean(catalog):
    """The REAL distributed compiler's counters must audit clean (they
    psum on sharded stages by construction): a sharded run under strict
    verification, on both execution paths."""
    import starrocks_tpu_torch.sql.distributed as D

    prev = D.SHARD_THRESHOLD_ROWS
    D.SHARD_THRESHOLD_ROWS = 10_000
    config.set("plan_verify_level", "strict")
    try:
        s = Session(tpch_catalog(sf=0.01), dist_shards=8)
        for frag in ("true", "false"):
            s.sql(f"SET dist_fragments = {frag}")
            res = s.sql("select l_returnflag, count(*) n, "
                        "sum(l_quantity) q from lineitem "
                        "group by l_returnflag order by n desc limit 3")
            assert res.table.num_rows == 3
            assert _counter_total(res.profile, "verify_findings") == 0
    finally:
        config.set("plan_verify_level", "off")
        config.set("dist_fragments", True)
        D.SHARD_THRESHOLD_ROWS = prev


# --- the re-derived float64 promotion (warn, as in the reference) -----------


def test_f64_promotion_seen_by_the_dispatch_audit():
    x32 = torch.arange(8, dtype=torch.float32)
    y64 = torch.arange(8, dtype=torch.float64)
    _, findings = trace_check.audit_program(lambda: x32 + y64)
    assert [f.invariant for f in findings] == ["f64-promotion"]
    assert findings[0].severity == "warn" and "add" in findings[0].node
    # an explicit cast at the column boundary is what the finding asks for
    _, findings = trace_check.audit_program(
        lambda: x32.to(torch.float64) + y64)
    assert findings == []


def test_f64_promotion_planted_in_a_query_program(catalog, monkeypatch):
    """A float32 column widened inside a real program is seen on its first
    run through the executor's hook (warn: reported and counted, the
    query still answers)."""
    import starrocks_tpu_torch.ops.aggregate as agg
    from starrocks_tpu_torch import analysis

    real = agg.hash_aggregate

    def widening(chunk, *a, **k):
        w = torch.ones(chunk.capacity, dtype=torch.float32)
        _ = w * torch.ones(chunk.capacity, dtype=torch.float64)
        return real(chunk, *a, **k)

    import starrocks_tpu_torch.sql.physical as phys

    monkeypatch.setattr(phys, "hash_aggregate", widening)
    config.set("plan_verify_level", "warn")
    try:
        n0 = analysis.findings_total()
        s = Session(tpch_catalog(sf=0.001))
        r = s.sql("select n_regionkey, count(*) c from nation "
                  "group by n_regionkey order by n_regionkey")
        assert r.rows()[0] == (0, 5)
        assert analysis.findings_total() > n0
        assert _counter_total(r.profile, "verify_findings") >= 1
        # warm: the program is no longer fresh, nothing is re-audited
        n1 = analysis.findings_total()
        s.sql("select n_regionkey, count(*) c from nation "
              "group by n_regionkey order by n_regionkey")
        assert analysis.findings_total() == n1
    finally:
        config.set("plan_verify_level", "off")


# --- golden fixture 4: knob read during trace but outside the cache key ------


def test_knob_outside_key_rejected():
    config.define("_test_rogue_knob", 7, True, "verifier fixture knob")
    try:
        with config.record_reads() as reads:
            config.get("_test_rogue_knob")
        findings = key_check.check_trace_reads(reads)
        errs = _errors(findings)
        assert any(f.invariant == "knob-outside-key"
                   and "_test_rogue_knob" in f.node for f in errs)
        with pytest.raises(VerifyError):
            report(findings, level="strict")
    finally:
        config._fields.pop("_test_rogue_knob", None)


def test_declared_trace_knob_clean():
    config.define("_test_keyed_knob", 7, True, "verifier fixture knob",
                  trace=True)
    try:
        with config.record_reads() as reads:
            config.get("_test_keyed_knob")
        assert key_check.check_trace_reads(reads) == []
        # and the declaration alone puts it in the program cache key
        assert ("_test_keyed_knob", 7) in config.trace_key()
    finally:
        config._fields.pop("_test_keyed_knob", None)


def test_engine_trace_reads_are_keyed(catalog):
    """End-to-end round-7 regression: build and run a real program,
    record every knob read, and require the read-set to be covered by
    the key."""
    from starrocks_tpu_torch.runtime.executor import DeviceCache
    from starrocks_tpu_torch.sql.analyzer import Analyzer
    from starrocks_tpu_torch.sql.optimizer import optimize
    from starrocks_tpu_torch.sql.parser import parse
    from starrocks_tpu_torch.sql.physical import Caps, compile_plan

    plan = optimize(Analyzer(catalog).analyze(parse(
        "select n_name, count(*) c from nation, customer "
        "where n_nationkey = c_nationkey group by n_name")), catalog)
    caps = Caps({})
    with config.record_reads() as reads:
        compiled = compile_plan(plan, catalog, caps)
        cache = DeviceCache("cpu")
        inputs = tuple(
            cache.chunk_for(catalog.get_table(t), a, cols)
            for t, a, cols in compiled.scans)
        compiled.fn(inputs)  # the knob reads inside operators happen here
    assert reads, "the window saw no knob read"
    assert key_check.check_trace_reads(reads) == [], reads


def test_opt_key_covers_optimizer_reads(catalog):
    from starrocks_tpu_torch.sql.analyzer import Analyzer
    from starrocks_tpu_torch.sql.optimizer import optimize
    from starrocks_tpu_torch.sql.parser import parse

    plan = Analyzer(catalog).analyze(parse(
        "select * from (select n_name, rank() over (order by n_nationkey) r "
        "from nation) t where r <= 3"))
    with config.record_reads() as reads:
        optimize(plan, catalog)
    assert key_check.check_opt_reads(reads) == [], reads


# --- capacity monotonicity + null semantics ----------------------------------


def test_capacity_monotonicity_flags_non_monotone_estimate(catalog):
    # a Sort claiming more output rows than its limit allows is only
    # constructible by corrupting the estimate: emulate with a bound probe
    scan = LScan("customer", "c", ("c_custkey",))
    sort = LSort(scan, ((Col("c.c_custkey"), True, False),), limit=10)
    assert plan_check._row_bound(sort, catalog) == 10.0
    clean = plan_check.check_capacities(sort, catalog)
    assert not _errors(clean)


def test_null_comparison_warned(catalog):
    scan = LScan("nation", "n", ("n_nationkey",))
    bad = LFilter(scan, Call("eq", Col("n.n_nationkey"), Lit(None)))
    findings = plan_check.check_null_semantics(bad, catalog)
    assert any(f.invariant == "null-semantics" for f in findings)
    assert all(f.severity == "warn" for f in findings)  # advisory only


# --- strict end-to-end through the Session -----------------------------------


def test_strict_mode_executes_clean_queries():
    config.set("plan_verify_level", "strict")
    try:
        s = Session(tpch_catalog(sf=0.001))
        res = s.sql("select n_name from nation order by n_name limit 5")
        assert res.table.num_rows == 5
    finally:
        config.set("plan_verify_level", "off")


# --- the whole corpus verifies clean -----------------------------------------


def _corpus_plans():
    from starrocks_tpu_torch.storage.ssb_queries import FLAT_QUERIES as SSB
    from starrocks_tpu_torch.storage.tpcds_queries import (
        ALL_QUERIES as TPCDS)
    from starrocks_tpu_torch.storage.tpch_queries import QUERIES as TPCH

    return [("tpch", f"q{k}", v) for k, v in sorted(TPCH.items())] + \
        [("ssb", k, v) for k, v in sorted(SSB.items())] + \
        [("tpcds", k, v) for k, v in sorted(TPCDS.items())]


@pytest.fixture(scope="module")
def corpus_sessions():
    from starrocks_tpu_torch.storage.datagen.ssb import ssb_catalog
    from starrocks_tpu_torch.storage.datagen.tpcds import tpcds_catalog

    return {
        "tpch": Session(tpch_catalog(sf=0.001)),
        "ssb": Session(ssb_catalog(sf=0.002)),
        "tpcds": Session(tpcds_catalog(sf=0.002)),
    }


@pytest.mark.parametrize("suite,name,text", _corpus_plans())
def test_corpus_plan_clean(corpus_sessions, suite, name, text):
    """Every corpus query's optimized plan passes the structural passes
    with zero error findings (warn-severity advisories allowed), and its
    distributed lowering is legal under managed exchanges."""
    from starrocks_tpu_torch.sql.analyzer import Analyzer
    from starrocks_tpu_torch.sql.optimizer import optimize
    from starrocks_tpu_torch.sql.parser import parse

    sess = corpus_sessions[suite]
    plan = optimize(Analyzer(sess.catalog).analyze(parse(text)),
                    sess.catalog)
    findings = plan_check.check_plan(plan, sess.catalog)
    findings += plan_check.check_distribution(plan, sess.catalog)
    errs = _errors(findings)
    assert not errs, f"{suite}/{name}: {[str(f) for f in errs]}"


# --- the key audits of the query cache and of plan feedback -----------------
# (the counterparts of tests/test_query_cache.py::test_check_cache_reads_*,
# ::test_strict_declines_to_cache_on_escapee and tests/test_plan_feedback.py
# ::test_check_feedback_reads_audit)


def test_check_cache_reads_flags_undeclared_knob():
    from starrocks_tpu_torch.analysis.key_check import check_cache_reads

    assert check_cache_reads({"enable_query_cache"}) == []      # cache_key
    assert check_cache_reads({"runtime_filter_strategy"}) == []  # trace
    assert check_cache_reads({"enable_mv_rewrite"}) == []        # opt key
    assert check_cache_reads({"max_recompiles"}) == []           # host loop
    bad = check_cache_reads({"some_undeclared_knob"})
    assert len(bad) == 1 and bad[0].invariant == "knob-outside-result-key"


def test_strict_declines_to_cache_on_escapee(monkeypatch):
    """An undeclared knob read during a cached execution fails strict mode
    (and the result is not stored); warn mode answers and declines."""
    from starrocks_tpu_torch.runtime import executor as ex

    s = Session(tpch_catalog(sf=0.001))
    if "test_unkeyed_knob" not in config._fields:  # escapee probe knob
        config.define("test_unkeyed_knob", 7)
    real_uncached = ex.Executor._execute_plain_uncached

    def leaky(self, plan, profile):
        config.get("test_unkeyed_knob")
        return real_uncached(self, plan, profile)

    monkeypatch.setattr(ex.Executor, "_execute_plain_uncached", leaky)
    q = "select n_regionkey, count(*) from nation group by n_regionkey"
    config.set("enable_query_cache", True)
    try:
        config.set("plan_verify_level", "strict")
        with pytest.raises(VerifyError):
            s.sql(q)
        assert s.cache.qcache.resident_bytes == 0
        config.set("plan_verify_level", "warn")
        assert len(s.sql(q).rows()) == 5
        assert s.cache.qcache.resident_bytes == 0
    finally:
        config.set("plan_verify_level", "off")
        config.set("enable_query_cache", False)
        config._fields.pop("test_unkeyed_knob", None)


def test_check_feedback_reads_audit():
    from starrocks_tpu_torch.analysis.key_check import check_feedback_reads

    assert check_feedback_reads({"plan_feedback"}) == []
    assert check_feedback_reads({"join_recursive_repartition"}) == []
    bad = check_feedback_reads({"serve_pool_size"})
    assert len(bad) == 1
    assert bad[0].invariant == "knob-outside-feedback-key"
