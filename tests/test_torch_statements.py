"""Statements in the PyTorch port (runtime/session.py, storage/catalog.py)
against the JAX package's Session, on the same scripts.

Each script runs through the JAX Session and the port's
`Session(device="cpu")`, in memory and over each package's own data_dir
under tmp_path; every statement must return the same thing (rows, counts,
lists, text, None) or raise the same error. Covered: the invalidation
repro (a table replaced under a Session, then keys past the old maximum
through a GROUP BY and a unique join), CREATE/INSERT/DELETE/UPDATE/ALTER
and CTAS, SHOW, DESCRIBE and SHOW CREATE, EXPLAIN text at TPC-H SF 0.01 and
over stored tables, and the storage views of information_schema. The
statements the port leaves to later slices raise NotImplementedError naming
the slice.
"""

import numpy as np
import pytest

from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import Catalog as JCatalog
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import Catalog, tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import QUERIES

from torch_sql_scripts import (  # noqa: F401 (fixture)
    _default_knobs, outcome, run_both, same_outcome, sessions,
)

MODES = ["memory", "data_dir"]


def _pair(mode, tmp_path):
    return sessions(tmp_path if mode == "data_dir" else None)


# --- step 0: invalidation ------------------------------------------------------


def test_invalidation_repro_register_replaces_table():
    """A table registered again under a live Session: the port must serve
    the new rows, as the JAX Session does (its register bumps a version
    and a listener drops the device cache)."""
    q = "select k, sum(v) from t group by k order by k desc limit 2"
    got = {}
    for pkg, cat, HT, S in (("jax", JCatalog(), JHostTable, JSession),
                            ("port", Catalog(), THostTable, Session)):
        cat.register("t", HT.from_pydict(
            {"k": np.arange(10), "v": np.ones(10, dtype=np.int64)}))
        s = S(cat) if pkg == "jax" else S(cat, device="cpu")
        first = (s.sql(q).rows(), s.sql("select count(*) from t").rows())
        cat.register("t", HT.from_pydict(
            {"k": np.arange(100), "v": np.full(100, 2, dtype=np.int64)}))
        got[pkg] = (first, s.sql(q).rows(),
                    s.sql("select count(*) from t").rows())
    assert got["port"] == got["jax"]
    assert got["port"][0] == ([(9, 1), (8, 1)], [(10,)])
    assert got["port"][1:] == ([(99, 2), (98, 2)], [(100,)])


@pytest.mark.parametrize("mode", MODES)
def test_keys_past_old_maximum_reach_group_by_and_unique_join(mode, tmp_path):
    """After INSERT adds keys above the old maximum, a GROUP BY and a
    unique join must see them: a stale optimized plan or stale bounds
    (dense-aggregation domain, LUT-join eligibility, packed bit widths)
    would drop them."""
    js, ts = _pair(mode, tmp_path)
    small = ", ".join(f"({i}, {i % 3})" for i in range(20))
    big = ", ".join(f"({i}, 7)" for i in range(1000, 3000, 7))
    dims = ", ".join(f"({i}, 'd{i % 5}')" for i in range(0, 3000, 3))
    script = [
        "create table f (k bigint, v bigint)",
        "create table d (k bigint, name varchar, primary key(k))",
        f"insert into f values {small}",
        f"insert into d values {dims}",
        "select k, sum(v) s from f group by k order by k desc limit 3",
        "select count(*) c, sum(f.v) s from f join d on f.k = d.k",
        "select d.name, count(*) c from f join d on f.k = d.k "
        "group by d.name order by d.name",
        f"insert into f values {big}",
        "select k, sum(v) s from f group by k order by k desc limit 3",
        "select count(*) c, sum(f.v) s from f join d on f.k = d.k",
        "select d.name, count(*) c from f join d on f.k = d.k "
        "group by d.name order by d.name",
        "insert into d values (4000, 'far'), (999999, 'farther')",
        "insert into f values (4000, 1), (999999, 2), (999999, 3)",
        "select d.name, count(*) c, sum(f.v) s from f join d on f.k = d.k "
        "group by d.name order by d.name",
        "select k, count(*) c from f group by k order by c desc, k desc "
        "limit 2",
    ]
    out = run_both(js, ts, script)
    assert out[8][1] == [(2995, 7), (2988, 7), (2981, 7)]
    assert out[13][1][0][0] == "d0" and ("far", 1, 1) in out[13][1]


# --- statement return values -----------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_statement_return_values(mode, tmp_path):
    js, ts = _pair(mode, tmp_path)
    script = [
        "create table t (a int not null, b varchar, c decimal(10,2), "
        "d date, e double, primary key(a)) distributed by hash(a) buckets 4",
        "insert into t values (1, 'x', 1.50, date '2024-01-02', 0.5), "
        "(2, 'y', 2.25, date '2024-02-03', null), "
        "(3, null, -0.75, null, 2.5)",
        "insert into t (a, b) values (4, 'z'), (1, 'x2')",
        "select * from t order by a",
        "update t set c = c + 1, e = 9.0 where a >= 2",
        "select a, c, e from t order by a",
        "delete from t where b = 'z' or c is null",
        "delete from t where a > 100",
        "select count(*), sum(c) from t",
        "create table u as select a, c from t where a < 3",
        "select * from u order by a",
        "insert into u select a + 10, c * 2 from t",
        "select a, c from u order by a",
        "create view v as select b, count(*) n from t group by b",
        "select * from v order by b",
        "show tables",
        "show full tables",
        "describe t",
        "describe v",
        "show create table t",
        "show create table v",
        "alter table u add column note double",
        "insert into u values (50, 1.25, 2.5)",
        "select * from u order by a",
        "alter table u drop column note",
        "describe u",
        "alter table t drop column a",
        "drop view v",
        "drop table u",
        "drop table if exists nothing",
        "drop table nothing",
        "show tables",
        "select * from u",
        "insert into __dual__ values (1)",
        "delete from t",
        "select count(*) from t",
    ]
    out = run_both(js, ts, script)
    assert out[1] == ("value", 3) and out[6] == ("value", 2)
    assert out[15][1] == ["t", "u", "v"]


@pytest.mark.parametrize("mode", MODES)
def test_alter_add_varchar_then_insert(mode, tmp_path):
    """ALTER TABLE ADD COLUMN of a VARCHAR, then INSERT. Over a data_dir
    both packages agree. In memory the reference raises IndexError (its
    concat_tables remaps the added column's codes through an empty
    dictionary); the port fills the old rows with NULL, as the stored
    table reads them back."""
    js, ts = _pair(mode, tmp_path)
    run_both(js, ts, ["create table u (a bigint)",
                      "insert into u values (1), (2)",
                      "alter table u add column note varchar"])
    ins, q = "insert into u values (3, 'n')", "select * from u order by a"
    if mode == "data_dir":
        run_both(js, ts, [ins, q, "select note, count(*) from u group by "
                          "note order by note"])
        return
    assert outcome(js, ins) == ("error", "IndexError")
    assert ts.sql(ins) == 1
    assert ts.sql(q).rows() == [(1, None), (2, None), (3, "n")]


@pytest.mark.parametrize("mode", MODES)
def test_ddl_dml_types_and_nulls(mode, tmp_path):
    """DECIMAL(38), DATETIME, BOOLEAN and NULLs through INSERT VALUES,
    INSERT .. SELECT (positional), CTAS and UPDATE."""
    js, ts = _pair(mode, tmp_path)
    script = [
        "create table w (id bigint, big decimal(30,4), ts datetime, "
        "flag boolean, small decimal(9,3), s varchar)",
        "insert into w values (1, 12345678901234567890.1234, "
        "'2024-01-01 08:00:00', true, 1.5, 'p'), "
        "(2, -0.0001, null, false, null, null), "
        "(3, null, '2023-12-31 23:59:59', null, 2.125, 'q')",
        "select * from w order by id",
        "insert into w select id + 3, big * 2, ts, flag, small, s from w",
        "select id, big, small, s from w order by id",
        "select sum(big), min(small), max(ts), count(flag) from w",
        "create table w2 as select s, sum(big) sb, count(*) n from w "
        "group by s",
        "select * from w2 order by s",
        "update w set small = small * 2 where id > 3",
        "select id, small from w order by id",
        "delete from w where flag",
        "select id from w order by id",
    ]
    run_both(js, ts, script)


# --- SHOW / DESCRIBE / information_schema --------------------------------------


STORAGE_VIEWS = [
    "tables", "schemata", "views", "columns", "statistics",
    "column_statistics", "tablets", "partitions", "rowsets",
    "materialized_views", "key_column_usage", "table_constraints",
    "referential_constraints", "loads", "compactions",
]


def _info(session, view):
    return session.sql(f"select * from information_schema.{view}").rows()


@pytest.mark.parametrize("mode", MODES)
def test_information_schema_storage_views(mode, tmp_path):
    js, ts = _pair(mode, tmp_path)
    run_both(js, ts, [
        "create table a (k bigint, s varchar, primary key(k)) "
        "distributed by hash(k) buckets 3",
        "create table p (x bigint, v double) partition by range(x) ("
        " partition lo values less than (100),"
        " partition hi values less than (maxvalue))"
        if mode == "data_dir" else "create table p (x bigint, v double)",
        "insert into a values (1, 'a'), (2, 'b'), (3, 'c'), (4, 'd')",
        "insert into a values (2, 'B')",
        "insert into p values (1, 1.5), (150, 2.5), (7, 3.5)",
        "create view va as select k from a",
        "create materialized view mva as select s, count(*) n from a "
        "group by s",
        "select count(*) from a",
    ])
    for view in STORAGE_VIEWS:
        assert _info(ts, view) == _info(js, view), view
    # after a base-table change the MV is stale in both
    run_both(js, ts, ["insert into a values (9, 'z')"])
    assert _info(ts, "materialized_views") == _info(js, "materialized_views")


@pytest.mark.parametrize("view", ["query_log", "processlist", "metrics",
                                  "resource_groups", "table_privileges",
                                  "fail_points", "ingest_jobs", "alerts"])
def test_information_schema_plane_views_raise(view):
    """The views of the serving and observability planes (slice 8) and of
    the ingest plane (ingest_jobs, the last slice) answer with the
    reference's columns and types; none raises."""
    s = Session(Catalog(), device="cpu")
    text = f"select * from information_schema.{view}"
    got = s.sql(text).table.schema
    want = JSession(JCatalog()).sql(text).table.schema
    assert [(f.name, repr(f.type)) for f in got] == [
        (f.name, repr(f.type)) for f in want]


@pytest.mark.parametrize("text,slice_no", [
    ("create user bob identified by 'pw'", 8),
    ("grant select on t to bob", 8),
    ("kill query 3", 8),
    ("show processlist", 8),
    ("show profile", 8),
    ("set resource_group = 'rg'", 8),
    ("admin set failpoint 'x' = 'off'", 8),
    ("explain analyze select 1", 8),
])
def test_later_statements_raise_naming_their_slice(text, slice_no):
    """The plane statements of slice 8 are ported: each answers as the
    reference's does (same result type; SHOW PROFILE and EXPLAIN ANALYZE
    render a tree), after the same set-up in both packages. So are the
    ingest plane's statements: over a location no file matches, CREATE
    EXTERNAL TABLE raises the reference's error, and ADMIN SET ingest_job
    answers as the reference's does."""
    assert slice_no == 8
    setup = ["create table t (k int)", "create user bob identified by 'pw'",
             "create resource group rg with (concurrency_limit = 2)"]
    out = []
    for sess in (JSession(JCatalog()), Session(Catalog(), device="cpu")):
        for st in setup:
            if st != text:
                sess.sql(st)
        try:
            out.append(sess.sql(text))
        except ValueError as e:  # 'off' is no failpoint action in either
            out.append(f"{type(e).__name__}: {e}")
    want, got = out
    assert type(got) is type(want), (got, want)
    if isinstance(got, list):
        assert len(got) == len(want)
    if text.startswith("explain analyze"):
        assert got.splitlines()[0] == want.splitlines()[0]
    for sess in (JSession(JCatalog()), Session(Catalog(), device="cpu")):
        with pytest.raises(ValueError, match="no parquet/ORC files match"):
            sess.sql("create external table x from '/nowhere'")
    assert Session(Catalog(), device="cpu").sql(
        "admin set ingest_job 'j' = 'drop'") == JSession(JCatalog()).sql(
        "admin set ingest_job 'j' = 'drop'")


def test_array_column_statements_match_jax():
    """CREATE TABLE with an ARRAY column and an INSERT, in memory, in both
    packages (stored ones are slice 5c)."""
    js, ts = sessions()
    run_both(js, ts, [
        "create table t2 (a array<int>, s array<varchar>)",
        "insert into t2 values (array(1, 2, 3), array('x')), "
        "(array(4), array('y', 'x')), (null, null)",
        "select a, s, array_length(a) from t2 order by array_length(a)"])


@pytest.mark.parametrize("col,probe", [("hll", "hll_cardinality(h)"),
                                       ("bitmap", "bitmap_count(h)")])
def test_sketch_column_statements_match_jax(col, probe):
    """CREATE TABLE with an HLL / BITMAP column, in memory, in both
    packages. An INSERT into it fails in the reference (its declared empty
    sketch arrays are rank 1; ROADMAP: reference defects); the port takes
    the rows."""
    js, ts = sessions()
    run_both(js, ts, [f"create table t3 (k int, h {col})",
                      f"select k, {probe} from t3"])
    with pytest.raises(ValueError):
        js.sql("insert into t3 values (1, null)")
    assert ts.sql("insert into t3 values (1, null)") == 1
    assert ts.sql(f"select k, {probe} from t3").rows() == \
        [(1, None if col == "hll" else 0)]


def test_load_csv_raises(tmp_path):
    """load_csv is ported (tests/test_torch_load_csv.py); it raises where
    the reference's does: an unknown table, and a file that is not
    there."""
    for sess in (Session(device="cpu", data_dir=str(tmp_path / "p")),
                 JSession(data_dir=str(tmp_path / "j"))):
        with pytest.raises(ValueError, match="unknown table"):
            sess.load_csv("t", str(tmp_path / "x.csv"))
        sess.sql("create table t (k int)")
        with pytest.raises(FileNotFoundError):
            sess.load_csv("t", str(tmp_path / "x.csv"))


# --- EXPLAIN ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_pair():
    return (JSession(jax_tpch_catalog(sf=0.01, seed=42)),
            Session(tpch_catalog(sf=0.01, seed=42), device="cpu"))


@pytest.mark.parametrize("q", [1, 3, 5, 9, 13, 18, 20, 22])
def test_explain_text_equals_reference(tpch_pair, q):
    js, ts = tpch_pair
    assert ts.sql("explain " + QUERIES[q]) == js.sql("explain " + QUERIES[q])


def test_explain_over_stored_tables_equals_reference(tmp_path):
    """EXPLAIN over stored tables plans from the loaded data's statistics
    and dictionaries: they must equal the reference's, node for node."""
    js, ts = sessions(tmp_path)
    rows = ", ".join(f"({i}, {i % 13}, 'n{i % 17}', {i * 0.5})"
                     for i in range(400))
    dims = ", ".join(f"({i}, 'g{i % 4}')" for i in range(13))
    run_both(js, ts, [
        "create table f (id bigint, k bigint, s varchar, x double, "
        "primary key(id)) distributed by hash(id) buckets 4",
        "create table d (k bigint, g varchar, primary key(k))",
        f"insert into f values {rows}",
        f"insert into d values {dims}",
        "insert into f values (5, 3, 'n99', 1.0)",
    ])
    for q in ["select s, count(*) from f group by s order by s",
              "select d.g, sum(f.x) from f join d on f.k = d.k "
              "where f.s > 'n3' group by d.g order by d.g",
              "select id, x from f order by x desc, id limit 5"]:
        assert ts.sql("explain " + q) == js.sql("explain " + q), q
        assert same_outcome(outcome(js, q), outcome(ts, q)), q


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path,
                                                             monkeypatch):
    """`Session(data_dir=...)` and `Session(catalog)` run on `cuda`: without
    a CUDA device they raise, and `device="cpu"` runs on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(data_dir=str(tmp_path / "db"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(Catalog())
    s = Session(device="cpu", data_dir=str(tmp_path / "db"))
    assert s.device.type == "cpu" and s.cache.device.type == "cpu"
    assert s.sql("create table t (a bigint)") is None
    assert s.sql("insert into t values (1), (2)") == 2


def test_a_dropped_session_releases_its_device_cache():
    """The catalog's invalidation listener must not keep a dropped
    Session's DeviceCache (and its device tensors) alive; the live
    Session's cache still hears every change."""
    import gc
    import weakref

    cat = Catalog()
    cat.register("t", THostTable.from_pydict({"k": np.arange(5)}))
    s1, s2 = Session(cat, device="cpu"), Session(cat, device="cpu")
    assert s1.sql("select count(*) from t").rows() == [(5,)]
    assert s2.sql("select count(*) from t").rows() == [(5,)]
    ref = weakref.ref(s1.cache)
    del s1
    gc.collect()
    assert ref() is None
    cat.register("t", THostTable.from_pydict({"k": np.arange(7)}))
    assert s2.sql("select count(*) from t").rows() == [(7,)]
    assert len(cat._listeners) == 1
