"""Port counterpart of tests/test_service_dml.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). HTTP SQL service + DML (DELETE/TRUNCATE/CTAS) + scalar function tests."""

import json
import urllib.request

import pytest

from starrocks_tpu_torch.runtime.http_service import SqlHttpServer
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



def _post(port, sql):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query",
        data=json.dumps({"sql": sql}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_service_end_to_end():
    srv = SqlHttpServer(Session()).start()
    try:
        code, _ = _post(srv.port, "create table t (a int, b varchar)")
        assert code == 200
        _post(srv.port, "insert into t values (1, 'x'), (2, 'y')")
        code, body = _post(srv.port, "select b, count(*) c from t group by b order by b")
        assert code == 200
        assert body["columns"] == ["b", "c"]
        assert body["rows"] == [["x", 1], ["y", 1]]
        # error surface
        code, body = _post(srv.port, "select nope from t")
        assert code == 400 and "unknown column" in body["error"]
        # metrics + profile + tables endpoints
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics") as r:
            assert b"sr_tpu_queries_total" in r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/profile") as r:
            assert b"compile_and_run" in r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/tables") as r:
            assert json.loads(r.read()) == ["t"]
    finally:
        srv.stop()


def test_delete_truncate_ctas(tmp_path):
    s = Session(data_dir=str(tmp_path / "db"))
    s.sql("create table t (a int, b varchar)")
    s.sql("insert into t values (1,'x'),(2,'y'),(3,'x'),(null,'z')")
    assert s.sql("delete from t where b = 'x'") == 2
    assert s.sql("select a from t order by a nulls last").rows() == [(2,), (None,)]
    # NULL-predicate rows are kept (a > 10 is NULL for a=NULL)
    assert s.sql("delete from t where a > 10") == 0
    # persistence across restart
    s2 = Session(data_dir=str(tmp_path / "db"))
    assert s2.sql("select count(*) c from t").rows() == [(2,)]
    assert s2.sql("create table t2 as select b, count(*) c from t group by b") == 2
    assert s2.sql("select b, c from t2 order by b").rows() == [("y", 1), ("z", 1)]
    assert s2.sql("truncate table t") == 2
    assert s2.sql("select count(*) c from t").rows() == [(0,)]


def test_scalar_function_breadth():
    s = Session()
    s.sql("create table f (s varchar, x double, d date, n decimal(10,2))")
    s.sql("insert into f values ('  Hello ', 2.7182, '2023-07-15', 12.34)")
    r = s.sql("""select length(trim(s)), upper(trim(s)),
        replace(trim(s), 'l', 'L'), concat('<', trim(s), '>'),
        round(x, 2), floor(x), ceil(x), sqrt(4.0), power(2, 10),
        greatest(x, 3.0), least(x, 1.0), round(n, 1),
        datediff(d, date '2023-07-01'), dayofweek(d), quarter(d)
        from f""")
    assert r.rows() == [(5, "HELLO", "HeLLo", "<Hello>", 2.72, 2.0, 3.0, 2.0,
                         1024.0, 3.0, 1.0, 12.3, 14, 7, 3)]
    # NULL propagation through math fns: sqrt(-1) and ln(0) -> NULL
    r2 = s.sql("select sqrt(0.0 - 1.0), ln(0.0) from f")
    assert r2.rows() == [(None, None)]


def test_primary_key_upsert_update_set(tmp_path):
    d = str(tmp_path / "pkdb")
    s = Session(data_dir=d)
    s.sql("create table pk (k int, v varchar, n int, primary key(k))")
    s.sql("insert into pk values (1, 'a', 10), (2, 'b', 20)")
    s.sql("insert into pk values (2, 'B', 99), (3, 'c', 30)")
    assert s.sql("select k, v, n from pk order by k").rows() == [
        (1, "a", 10), (2, "B", 99), (3, "c", 30)]
    s.sql("update pk set n = n * 2 where k >= 2")
    assert s.sql("select k, n from pk order by k").rows() == [(1, 10), (2, 198), (3, 60)]
    # restart: PK metadata survives; upsert still applies
    s2 = Session(data_dir=d)
    s2.sql("insert into pk values (1, 'A!', 1)")
    assert s2.sql("select k, v, n from pk order by k").rows() == [
        (1, "A!", 1), (2, "B", 198), (3, "c", 60)]
    # SET + config/metrics virtual tables
    s2.sql("set max_recompiles = 5")
    assert s2.sql(
        "select value from information_schema.be_configs where name = 'max_recompiles'"
    ).rows() == [("5",)]
    s2.sql("set max_recompiles = 6")
    assert s2.sql("select count(*) c from information_schema.metrics").rows()[0][0] > 0
    # planner uses the PK for unique-build joins
    plan = s2.sql("explain select pk.v from pk, pk p2 where pk.k = p2.k")
    assert "Join[inner" in plan
