"""Port counterpart of tests/test_info_schema_concurrency.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). information_schema breadth + concurrent multi-client sessions
(VERDICT r4 item 10; reference: be/src/schema_scanner/ + the FE audit log)."""

import threading

import pytest

from starrocks_tpu_torch.column import HostTable
from starrocks_tpu_torch.runtime.mysql_service import MySQLServer
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.storage.catalog import Catalog

from chip_smoke import MySQLClient


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



@pytest.fixture()
def sess(tmp_path):
    s = Session(data_dir=str(tmp_path))
    s.sql("create table facts (k int, v double)")
    s.sql("insert into facts values (1, 1.5), (2, 2.5), (3, null)")
    s.sql("create view v_facts as select k from facts where v is not null")
    s.sql("create materialized view mv_sum as "
          "select k, sum(v) as s from facts group by k")
    return s


def test_schemata_views_tables(sess):
    r = sess.sql("select schema_name from information_schema.schemata "
                 "order by 1").rows()
    assert r == [("default",), ("information_schema",)]
    r = dict(sess.sql("select table_name, table_type "
                      "from information_schema.tables").rows())
    assert r["facts"] == "BASE TABLE"
    assert r["v_facts"] == "VIEW"
    assert r["mv_sum"] == "MATERIALIZED VIEW"
    r = dict((a, (b, c)) for a, b, c in sess.sql(
        "select table_name, view_definition, view_type "
        "from information_schema.views").rows())
    assert "select k from facts" in r["v_facts"][0]
    assert r["mv_sum"][1] == "MATERIALIZED VIEW"


def test_statistics_and_storage_views(sess):
    stats = {(t, c): (n, mn, mx, az) for t, c, n, mn, mx, az in sess.sql(
        "select * from information_schema.statistics").rows()}
    assert stats[("facts", "k")][:3] == (3, "1", "3")  # exact NDV + bounds
    tablets = sess.sql("select table_name, rows from "
                       "information_schema.tablets where table_name = "
                       "'facts'").rows()
    assert sum(r[1] for r in tablets) == 3
    parts = sess.sql("select table_name, partition_name, rows from "
                     "information_schema.partitions "
                     "where table_name = 'facts'").rows()
    assert sum(p[2] for p in parts) == 3


def test_query_log(sess):
    sess.sql("select count(*) from facts")
    log = sess.sql("select user, statement, state, rows from "
                   "information_schema.query_log").rows()
    assert any("count(*)" in r[1] and r[0] == "root" and r[2] == "OK"
               for r in log)
    with pytest.raises(Exception):
        sess.sql("select nope from facts")
    log = sess.sql("select statement, state from "
                   "information_schema.query_log").rows()
    assert any(r[1] == "ERR" and "nope" in r[0] for r in log)


def test_show_full_tables_over_the_wire(sess):
    srv = MySQLServer(sess, port=0).start()
    try:
        c = MySQLClient(srv.port)
        cols, rows = c.query("show full tables")
        assert cols == ["table_name", "table_type"]
        d = dict(rows)
        assert d["facts"] == "BASE TABLE" and d["v_facts"] == "VIEW"
        c.quit()
    finally:
        srv.shutdown()


def test_concurrent_sessions_ddl_query_insert(sess):
    """Two byte-level MySQL clients + direct session traffic running DDL,
    INSERT, and SELECT concurrently must serialize correctly (no torn
    state, every client sees its own writes)."""
    srv = MySQLServer(sess, port=0).start()
    errors = []

    def worker(wid: int):
        try:
            c = MySQLClient(srv.port)
            c.query(f"create table w{wid} (a int, b varchar)")
            total = 0
            for i in range(10):
                c.query(f"insert into w{wid} values ({i}, 'x{wid}_{i}')")
                total += 1
                _, rows = c.query(f"select count(*) from w{wid}")
                assert rows == [(str(total),)], (wid, i, rows)
                # interleave reads of the shared table + info schema
                _, rows = c.query("select count(*) from facts")
                assert rows[0][0] >= "3"
                c.query("select table_name from information_schema.tables")
            _, rows = c.query(
                f"select b from w{wid} where a = 7")
            assert rows == [(f"x{wid}_7",)]
            c.query(f"drop table w{wid}")
            c.quit()
        except Exception as e:  # noqa: BLE001
            errors.append((wid, repr(e)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    srv.shutdown()
    assert not errors, errors
    assert all(f"w{i}" not in sess.catalog.tables for i in range(3))


def test_info_schema_long_tail(tmp_path):
    """The round-5 view breadth (reference: be/src/schema_scanner/ ~60
    views): every view answers through plain SELECT with typed columns."""
    s = Session(data_dir=str(tmp_path / "db"))
    s.sql("create table base (k int, v varchar) "
          "distributed by hash(k) buckets 2")
    s.sql("insert into base values (1, 'x'), (2, 'y'), (2, 'z')")
    s.sql("create materialized view mvx as "
          "select v, count(*) c from base group by v")
    s.sql("create user io_user identified by 'p'")
    s.sql("grant select on base to io_user")
    s.sql("""create function io_twice(a bigint) returns bigint as '
def io_twice(a):
    return a * 2
'""")
    s.sql("create resource group io_rg with (concurrency_limit = 2)")

    q = lambda v: s.sql(f"select * from information_schema.{v}").rows()  # noqa: E731
    assert ("mvx", ) == tuple(r[0] for r in q("materialized_views"))
    mv = q("materialized_views")[0]
    assert mv[3] == 1 and mv[2] == 3  # fresh, 3 groups... rows
    assert [r[0] for r in q("routines")] == ["io_twice"]
    assert any(r[0] == "max_recompiles" for r in q("session_variables"))
    assert any(r[0] == "max_recompiles" for r in q("global_variables"))
    assert ("'io_user'@'%'", "base", "SELECT") in q("table_privileges")
    assert any(g == "'root'@'%'" for g, *_ in q("user_privileges"))
    assert q("referential_constraints") == []
    assert q("engines")[0][0] == "OLAP_TPU"
    assert q("character_sets")[0][0] == "utf8mb4"
    assert q("collations")[0][0] == "utf8mb4_bin"
    rowsets = q("rowsets")
    assert {r[0] for r in rowsets} >= {"base"}
    assert sum(r[3] for r in rowsets if r[0] == "base") == 3
    loads = q("loads")
    assert any(r[1] == "base" and r[2] == 3 for r in loads)
    assert q("compactions") == []  # nothing compacted yet
    stats = q("column_statistics")
    assert ("base", "k", 2) in stats
    # unique-key views populate for PRIMARY KEY tables
    s.sql("create table pkt (id int, x int, primary key (id))")
    assert ("pkt", "id", "UNIQUE") in q("key_column_usage")
    assert ("pkt", "UNIQUE") in q("table_constraints")
    # the ingest plane's view of external tables: none here, in the
    # reference's columns
    assert q("external_tables") == []
    assert [f.name for f in s.sql(
        "select * from information_schema.external_tables").table.schema
    ] == ["table_name", "location"]
