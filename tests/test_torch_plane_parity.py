"""The serving planes of the port held to the JAX package's, statement for
statement: the same SQL through both packages' MySQL front doors gives the
same wire bytes (text and binary resultsets; floats, whose last digits
depend on reduction order, by value), through both HTTP front doors the
same rows, EXPLAIN ANALYZE the same annotated plan tree (the profile's
timings below it are not compared), and every plane view of
information_schema the same columns and types. TPC-H SF 0.01, seed 42,
the port on the CPU."""

import http.client
import json
import math
import re

import pytest

from starrocks_tpu.runtime.http_service import SqlHttpServer as JHttp
from starrocks_tpu.runtime.mysql_service import MySQLServer as JMySQL
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import Catalog as JCatalog
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch import lockdep
from starrocks_tpu_torch.runtime.http_service import SqlHttpServer
from starrocks_tpu_torch.runtime.mysql_service import MySQLServer
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import Catalog, tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import (
    BREADTH_QUERIES, QUERIES, TOPN_QUERIES,
)

from chip_smoke import MySQLClient

SF = 0.01


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness."""
    yield
    cycles = lockdep.WITNESS.order_cycles()
    assert not cycles, lockdep.WITNESS.render(cycles)


@pytest.fixture(scope="module")
def doors():
    """(JAX MySQL, port MySQL, JAX HTTP, port HTTP) over one tier each."""
    js = JSession(jax_tpch_catalog(sf=SF))
    ts = Session(tpch_catalog(sf=SF), device="cpu")
    jm = JMySQL(js, port=0).start()
    tm = MySQLServer(ts, port=0).start()
    jh = JHttp(js, port=0, tier=jm.tier).start()
    th = SqlHttpServer(ts, port=0, tier=tm.tier).start()
    yield jm, tm, jh, th
    for srv in (jh, th):
        srv.httpd.shutdown()
    for srv in (jm, tm):
        srv.shutdown()


def _split_row(p: bytes) -> list:
    """A text resultset row's cells (bytes, None for NULL)."""
    pos, out = 0, []
    while pos < len(p):
        if p[pos] == 0xFB:
            out.append(None)
            pos += 1
            continue
        n, pos = MySQLClient._lenenc(p, pos)
        out.append(p[pos:pos + n])
        pos += n
    return out


def _cells_agree(a, b) -> bool:
    if a == b:
        return True
    if a is None or b is None:
        return False
    try:
        fa, fb = float(a), float(b)
    except ValueError:
        return False
    return math.isclose(fa, fb, rel_tol=1e-6)


def _wire_agree(got: list, want: list):
    """Packets equal byte for byte, but row cells that parse as floats,
    which agree to 6 significant digits (the reduction order differs)."""
    assert len(got) == len(want)
    ncols = None
    eofs = 0
    for g, w in zip(got, want):
        if ncols is None:
            assert g == w
            if g[0] in (0x00, 0xFF):
                return
            ncols = g[0]
            continue
        if eofs < 1 or (g[0] == 0xFE and len(g) < 9):
            assert g == w
            eofs += g[0] == 0xFE and len(g) < 9
            continue
        if g != w:
            cg, cw = _split_row(g), _split_row(w)
            assert len(cg) == len(cw) == ncols
            assert all(_cells_agree(a, b) for a, b in zip(cg, cw)), (cg, cw)


WIRE_TEXTS = {
    "Q1": QUERIES[1], "Q3": QUERIES[3], "Q6": QUERIES[6],
    "Q10": QUERIES[10], "Q13": QUERIES[13], "Q18": QUERIES[18],
    "N1": TOPN_QUERIES["N1"], "B5": BREADTH_QUERIES["B5"],
    "nulls": "select s_suppkey, nullif(s_nationkey, 3) n "
             "from supplier order by s_suppkey limit 12",
    "null_strings": "select n.n_name, r.r_name from nation n left join "
                    "region r on n.n_regionkey = r.r_regionkey "
                    "and r.r_regionkey > 2 order by n.n_nationkey",
    "dates": "select o_orderdate, o_orderkey from orders "
             "order by o_orderdate, o_orderkey limit 5",
    "show": "show tables",
    "explain": "explain " + QUERIES[6],
    "error": "select no_such_column from nation",
}


@pytest.mark.parametrize("name", sorted(WIRE_TEXTS))
def test_mysql_text_resultsets_equal_on_the_wire(doors, name):
    jm, tm, _, _ = doors
    jc = MySQLClient(jm.port)
    tc = MySQLClient(tm.port)
    try:
        for _ in range(2):  # cold, then through the warm paths
            _wire_agree(tc.query_raw(WIRE_TEXTS[name]),
                        jc.query_raw(WIRE_TEXTS[name]))
    finally:
        jc.quit()
        tc.quit()


def test_prepared_point_lookups_equal_binary_rows(tmp_path):
    """COM_STMT_PREPARE/EXECUTE point SELECTs on a stored PRIMARY KEY
    table (the point lane) and an UPDATE through it: the same binary
    resultset bytes from both servers."""
    script = ["create table kv (k bigint, s varchar, d date, v double, "
              "primary key(k)) distributed by hash(k) buckets 4",
              "insert into kv values (1, 'a', '2024-01-02', 1.5), "
              "(2, null, '2023-12-31', -2.25), (3, 'c', null, null)"]
    servers = []
    for make, srv_cls, sub in ((JSession, JMySQL, "j"),
                               (Session, MySQLServer, "t")):
        kw = {} if make is JSession else {"device": "cpu"}
        s = make(data_dir=str(tmp_path / sub), **kw)
        for st in script:
            s.sql(st)
        servers.append(srv_cls(s, port=0).start())
    try:
        clients = [MySQLClient(srv.port) for srv in servers]
        sids = [c.stmt_prepare("select * from kv where k = ?")[0]
                for c in clients]
        for k in (1, 2, 3, 9):
            got, want = (c.execute_raw(sid, [k])
                         for c, sid in zip(reversed(clients),
                                           reversed(sids)))
            assert got == want, k
        upd = [c.query("update kv set s = 'z' where k = 2") for c in clients]
        assert upd[0] == upd[1]
        got, want = (c.execute_raw(sid, [2])
                     for c, sid in zip(reversed(clients), reversed(sids)))
        assert got == want
        for c in clients:
            c.quit()
    finally:
        for srv in servers:
            srv.shutdown()


@pytest.mark.parametrize("q", [1, 3, 10, 18])
def test_http_query_rows_equal(doors, q):
    _, _, jh, th = doors
    bodies = []
    for srv in (jh, th):
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        c.request("POST", "/query", json.dumps({"sql": QUERIES[q]}))
        r = c.getresponse()
        assert r.status == 200
        bodies.append(json.loads(r.read()))
    want, got = bodies
    assert got["columns"] == want["columns"]
    assert len(got["rows"]) == len(want["rows"])
    for g, w in zip(got["rows"], want["rows"]):
        assert all(_cells_agree(str(a), str(b)) for a, b in zip(g, w))


def _tree(text: str) -> str:
    """EXPLAIN ANALYZE's annotated plan: the lines above the profile."""
    return text.split("\nquery:")[0]


@pytest.mark.parametrize("q", [1, 3, 5, 10])
def test_explain_analyze_tree_equal(q):
    """The executed plan with each node's ordinal, estimate, observed rows,
    capacity and counter group — the reference's tree, line for line, on
    the second run (both packages' capacities tightened once)."""
    js = JSession(jax_tpch_catalog(sf=SF))
    ts = Session(tpch_catalog(sf=SF), device="cpu")
    for _ in range(2):
        want = js.sql("explain analyze " + QUERIES[q])
        got = ts.sql("explain analyze " + QUERIES[q])
    assert _tree(got) == _tree(want)
    times = re.compile(r"\d+\.\d+ms")
    assert times.search(got) and "attempt_0:" in got


PLANE_VIEWS = ["resource_groups", "routines", "session_variables",
               "global_variables", "table_privileges", "user_privileges",
               "engines", "character_sets", "collations", "queries",
               "processlist", "fail_points", "query_log", "query_profiles",
               "be_configs", "metrics", "audit_log", "events",
               "metrics_history", "workload_summary", "alerts"]


@pytest.mark.parametrize("view", PLANE_VIEWS)
def test_plane_view_columns_equal(view):
    text = f"select * from information_schema.{view}"
    got = Session(Catalog(), device="cpu").sql(text).table.schema
    want = JSession(JCatalog()).sql(text).table.schema
    assert [(f.name, repr(f.type)) for f in got] == [
        (f.name, repr(f.type)) for f in want]


@pytest.mark.parametrize("text", [
    "show grants", "show resource groups", "show workload",
    "show grants for bob"])
def test_plane_statements_equal(text):
    setup = ["create user bob identified by 'pw'",
             "create table t (k int)", "grant select on t to bob",
             "create resource group rg with (concurrency_limit = 3, "
             "priority = 2)"]
    out = []
    for s in (JSession(JCatalog()), Session(Catalog(), device="cpu")):
        for st in setup:
            s.sql(st)
        out.append(s.sql(text))
    want, got = out
    if text == "show workload":  # process-wide: compare the row shape
        assert {len(r) for r in got} <= {len(r) for r in want} | {
            len(want[0]) if want else 0} or not got
        return
    assert got == want


# --- the copied plane modules ------------------------------------------------

# module -> the definitions the port adapts (their reasons in the port's
# text): lifecycle measures torch tensors and device Chunks (`_nbytes`);
# http_service takes `--device` (`serve`, `__main__`); profile's device
# knob describes what
# the port records (`enable_device_profile`); the tier drops a failed
# statement's error as it re-raises it, so no reference cycle keeps the
# statement's device tensors alive (`ServingTier.execute`)
ADAPTED = {
    "lifecycle": {"_nbytes"},
    "http_service": {"serve", "__main__"},
    "profile": {"enable_device_profile"},
    "serving": {"execute"},
}
PLANE_MODULES = ["lifecycle", "profile", "auth", "workgroup", "audit",
                 "workload", "alerts", "sentinel", "watchdog", "point",
                 "serving", "mysql_service", "http_service", "metrics",
                 "failpoint", "events"]


def _without(text: str, names: set) -> list:
    """The module's lines with the named definitions blanked: functions
    and methods at any depth, `config.define("<name>", ...)` calls and the
    `if __name__ == "__main__":` block."""
    import ast

    lines = text.splitlines()
    drop = set()
    for node in ast.walk(ast.parse(text)):
        hit = False
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            hit = node.name in names
        elif isinstance(node, ast.If):
            hit = "__main__" in names and "__main__" in ast.unparse(node.test)
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            args = node.value.args
            hit = (ast.unparse(node.value.func) == "config.define" and args
                   and isinstance(args[0], ast.Constant)
                   and args[0].value in names)
        if hit:
            first = min([node.lineno] + [d.lineno for d in getattr(
                node, "decorator_list", ())])
            drop.update(range(first, node.end_lineno + 1))
    return [ln for i, ln in enumerate(lines, 1) if i not in drop]


@pytest.mark.parametrize("mod", PLANE_MODULES)
def test_plane_module_differs_from_the_reference_only_in_imports(mod):
    """The plane modules are the reference's text; a line that differs may
    only be an import, outside the definitions the port adapts."""
    import difflib
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    ref = (root / "starrocks_tpu" / "runtime" / f"{mod}.py").read_text()
    port = (root / "starrocks_tpu_torch" / "runtime" / f"{mod}.py"
            ).read_text()
    names = ADAPTED.get(mod, set())
    if mod == "http_service":  # the module docstring lists the endpoints
        ref, port = (t.split('"""', 2)[2] for t in (ref, port))
    changed = [ln[1:].strip() for ln in difflib.unified_diff(
        _without(ref, names), _without(port, names), lineterm="", n=0)
        if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]
    assert all(ln.startswith(("import ", "from ")) or not ln
               for ln in changed), changed


@pytest.mark.parametrize("shards", [None, 2])
def test_device_profile_knob_on_the_cpu(shards):
    """`SET enable_device_profile` (the reference attaches XLA's cost and
    memory analysis): on the CPU every attempt says the card's facts do
    not apply, on one shard and on a mesh; off, no attempt carries them."""
    from starrocks_tpu_torch.runtime.config import config

    s = Session(tpch_catalog(sf=SF), device="cpu", dist_shards=shards)
    prev = config.get("enable_device_profile")
    try:
        config.set("enable_device_profile", True)
        s.sql(QUERIES[3])
        tries = [c for c in s.last_profile.children
                 if c.name.startswith("attempt_")]
        assert tries and all(c.infos["device_profile"]
                             == "not applicable: cpu tensors" for c in tries)
        config.set("enable_device_profile", False)
        s.sql(QUERIES[3])
        assert not any("device_profile" in c.infos
                       for c in s.last_profile.children)
    finally:
        config.set("enable_device_profile", prev)
