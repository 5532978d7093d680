"""Port counterpart of tests/test_observability.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). Profile / config / metrics / failpoint tests (reference analog:
RuntimeProfile + configbase + metrics + failpoint behaviors, SURVEY §5)."""

import pytest

from starrocks_tpu_torch.runtime import failpoint
from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.metrics import QUERIES_TOTAL, metrics
from starrocks_tpu_torch.runtime.profile import RuntimeProfile
from starrocks_tpu_torch.runtime.session import Session as _Session


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)


def Session(*args, **kwargs):
    """The port's Session on the CPU (its entry points default to the
    card)."""
    kwargs.setdefault("device", "cpu")
    return _Session(*args, **kwargs)



def _sess():
    s = Session()
    s.sql("create table t (a int, b double)")
    s.sql("insert into t values (1, 2.0), (2, 3.0), (1, 4.0)")
    return s


def test_profile_collected():
    s = _sess()
    r = s.sql("select a, sum(b) from t group by a")
    prof = r.profile
    assert prof is not None
    assert "analyze" in prof.counters
    assert prof.find("attempt_0") is not None
    rendered = prof.render()
    assert "compile_and_run" in rendered


def test_explain_analyze():
    s = _sess()
    out = s.sql("explain analyze select a, sum(b) s from t group by a")
    assert "Agg[" in out and "compile_and_run" in out


def test_config_registry():
    assert config.get("default_agg_groups") == 1024
    config.set("max_recompiles", 4)
    assert config.get("max_recompiles") == 4
    config.set("max_recompiles", 6)
    with pytest.raises(KeyError):
        config.set("no_such_option", 1)
    # the port's registry holds mutable knobs only: a private registry
    # stands in for the reference's immutable `chunk_align`
    frozen = type(config)()
    frozen.define("chunk_align", 1024, False, "row-capacity alignment")
    with pytest.raises(PermissionError):
        frozen.set("chunk_align", 512)
    items = dict((n, v) for n, v, *_ in config.items())
    assert "enable_zonemap_pruning" in items


def test_metrics_prometheus():
    before = QUERIES_TOTAL.value
    s = _sess()
    s.sql("select count(*) c from t group by a > 0")
    assert QUERIES_TOTAL.value > before
    text = metrics.render_prometheus()
    assert "# TYPE sr_tpu_queries_total counter" in text


def test_failpoint_injection():
    s = _sess()
    with failpoint.scoped("executor::before_run"):
        with pytest.raises(failpoint.FailPointError):
            s.sql("select count(*) c from t group by a > 0")
    # disarmed: works again
    r = s.sql("select count(*) c from t group by a > 0")
    assert r.rows() == [(3,)]
    assert failpoint._registry.hits("executor::before_run") >= 2


def test_failpoint_action_and_times():
    calls = []
    with failpoint.scoped("executor::before_run", action=lambda: calls.append(1), times=1):
        s = _sess()
        s.sql("select count(*) c from t group by a > 0")
        s.sql("select count(*) c from t group by a > 0")
    assert calls == [1]  # times=1 limited the injection


def test_program_cache_and_cap_adoption():
    s = _sess()
    q = "select a, sum(b) s from t group by a order by a"
    r1 = s.sql(q).rows()
    r2 = s.sql(q).rows()
    assert r1 == r2
    # the port builds its eager program per attempt, so no wall clock
    # tells a cached run apart: the program bucket's adopted capacities
    # do — the repeat runs one attempt, with no recompile
    prof = s.last_profile
    assert prof.counters["recompiles"][0] == 0
    assert [c.name for c in prof.children] == ["attempt_0"]
    # learned capacities: an overflowing query runs 1 attempt the second time
    s.sql("insert into t values (3, 1.0), (4, 1.0), (5, 1.0)")
    qq = "select a, count(*) c from t group by a order by a"
    s.sql(qq)
    s.sql(qq)
    attempts = sum(1 for c in s.last_profile.children if c.name.startswith("attempt"))
    assert attempts == 1


def test_program_cache_retrace_safe_after_dict_change():
    # regression: cached programs must retrace cleanly when a string
    # dictionary (jit-static schema metadata) changes after DML
    s = Session()
    s.sql("create table rc (g int, s varchar)")
    s.sql("insert into rc values (1, 'a'), (2, 'b')")
    q = "select s, count(*) c from rc group by s order by s"
    assert s.sql(q).rows() == [("a", 1), ("b", 1)]
    s.sql("insert into rc values (3, 'zzz')")
    assert s.sql(q).rows() == [("a", 1), ("b", 1), ("zzz", 1)]


def test_batched_aggregation_spill_path():
    # host-offload streaming (spill analog): results identical to one-shot
    from starrocks_tpu_torch.storage.catalog import tpch_catalog

    cat = tpch_catalog(sf=0.005)
    q = """select l_returnflag, sum(l_quantity) q, count(*) c,
           avg(l_discount) a, min(l_extendedprice) mn
           from lineitem where l_shipdate <= date '1998-09-02'
           group by l_returnflag order by l_returnflag"""
    ref = Session(cat).sql(q).rows()
    config.set("batch_rows_threshold", 4000)
    try:
        s = Session(cat)
        got = s.sql(q).rows()
        assert got == ref
        # the port's spill executors report on their own child of the
        # query profile ("batched"), the reference's on the attempt
        info = s.last_profile.find("batched").infos
        assert info["batches"] >= 2
        # high-cardinality group-by: overflow-recompile inside the batched path
        q2 = "select l_orderkey, sum(l_quantity) s from lineitem group by l_orderkey"
        config.set("batch_rows_threshold", 0)
        ref2 = sorted(Session(cat).sql(q2).rows())  # one-shot oracle
        config.set("batch_rows_threshold", 4000)
        got2 = sorted(Session(cat).sql(q2).rows())
        assert got2 == ref2
    finally:
        config.set("batch_rows_threshold", 0)


def test_show_profile_statement():
    s = Session()
    s.sql("CREATE TABLE t (a BIGINT)")
    s.sql("INSERT INTO t VALUES (1), (2)")
    assert s.sql("SHOW PROFILE") == "no queries yet"
    s.sql("SELECT sum(a) FROM t")
    out = s.sql("SHOW PROFILE")
    assert "attempt_0" in out or "query" in out
