"""Views, materialized views and the transparent MV rewrite in the PyTorch
port (runtime/session.py, sql/mv_rewrite.py) against the JAX package's.

The cases of tests/test_mv_rewrite.py and of test_sql_frontend.py's view
tests run through both Sessions: every query's rows and whether its
EXPLAIN scans the MV must agree, with `enable_mv_rewrite` on and off;
DML on a base table makes the rewrite stop until the next REFRESH. The MV
definitions, views and their freshness survive a restart over a data_dir.
"""

import pytest

from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import Catalog as JCatalog
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import Catalog, tpch_catalog

from torch_sql_scripts import (  # noqa: F401 (fixture)
    _default_knobs, outcome, run_both, same_outcome, sessions,
)

MV_SALES = """create materialized view mv_sales as
    select region, prod, sum(qty) as sum_qty, count(qty) as cnt_qty,
           sum(price) as sum_price, count(*) as n_rows,
           min(price) as min_price, max(price) as max_price
    from sales group by region, prod"""


def _sales(HT):
    n = 500
    return HT.from_pydict({
        "region": [["east", "west", "north"][i % 3] for i in range(n)],
        "prod": [f"p{i % 7}" for i in range(n)],
        "qty": [(i * 13) % 50 for i in range(n)],
        "price": [float((i * 7) % 90) + 0.5 for i in range(n)],
    })


@pytest.fixture()
def pair():
    jc, tc = JCatalog(), Catalog()
    jc.register("sales", _sales(JHostTable))
    tc.register("sales", _sales(THostTable))
    js, ts = JSession(jc), Session(tc, device="cpu")
    run_both(js, ts, [MV_SALES])
    return js, ts


def _uses(s, q, mv="mv_sales"):
    return f"Scan[{mv}" in s.sql("explain " + q)


def _check(js, ts, q, mv="mv_sales"):
    """Same rewrite decision and rows in both, rewrite on and off; the
    port's rows with and without the rewrite agree too. Returns whether
    the MV was used."""
    used = _uses(ts, q, mv)
    assert used == _uses(js, q, mv), q
    on = run_both(js, ts, [q])[0]
    for cfg in (jcfg, tcfg):
        cfg.set("enable_mv_rewrite", False)
    try:
        assert not _uses(ts, q, mv)
        off = run_both(js, ts, [q])[0]
    finally:
        for cfg in (jcfg, tcfg):
            cfg.set("enable_mv_rewrite", True)
    assert same_outcome(off, on), q
    return used


@pytest.mark.parametrize("q,uses", [
    ("select region, prod, sum(qty) from sales group by region, prod "
     "order by 1, 2", True),
    ("select region, sum(qty), count(*), min(price), max(price) "
     "from sales group by region order by 1", True),
    ("select sum(qty), count(*) from sales", True),
    ("select region, avg(qty) from sales group by region order by 1", True),
    ("select prod, sum(price) from sales where region = 'east' "
     "group by prod order by 1", True),
    ("select region, sum(price) from sales where qty > 10 group by region "
     "order by 1", False),
])
def test_rewrite_cases(pair, q, uses):
    js, ts = pair
    assert _check(js, ts, q) is uses


def test_staleness_disables_until_refresh(pair):
    js, ts = pair
    q = ("select region, prod, sum(qty) from sales "
         "group by region, prod order by 1, 2")
    assert _check(js, ts, q)
    run_both(js, ts, ["insert into sales values ('east', 'p0', 999, 1.0)"])
    assert not _check(js, ts, q)  # base moved: the MV is stale
    assert any(r[2] >= 999 for r in ts.sql(q).rows())
    out = run_both(js, ts, ["refresh materialized view mv_sales"])
    assert out[0] == ("value", 21)
    assert _check(js, ts, q)
    for dml in ("delete from sales where qty = 999",
                "update sales set qty = qty + 1 where region = 'west'"):
        run_both(js, ts, [dml])
        assert not _check(js, ts, q), dml
        run_both(js, ts, ["refresh materialized view mv_sales"])
        assert _check(js, ts, q)


def test_mv_filter_containment(pair):
    js, ts = pair
    run_both(js, ts, ["""create materialized view mv_east as
        select prod, sum(qty) as sum_qty from sales
        where region = 'east' group by prod"""])
    assert _check(js, ts, "select prod, sum(qty) from sales where region = "
                  "'east' group by prod order by 1", "mv_east")
    assert not _check(js, ts, "select prod, sum(qty) from sales where "
                      "region = 'west' group by prod order by 1", "mv_east")


def test_tpch_query_reads_mv():
    js = JSession(jax_tpch_catalog(sf=0.01, seed=42))
    ts = Session(tpch_catalog(sf=0.01, seed=42), device="cpu")
    run_both(js, ts, ["""create materialized view mv_q1 as
        select l_returnflag, l_linestatus,
               sum(l_quantity) as sum_qty,
               sum(l_extendedprice) as sum_base_price,
               count(l_quantity) as cnt_qty,
               count(l_extendedprice) as cnt_price,
               count(*) as count_order
        from lineitem
        where l_shipdate <= date '1998-09-02'
        group by l_returnflag, l_linestatus"""])
    q = """select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
              sum(l_extendedprice) as sum_base_price,
              avg(l_quantity) as avg_qty, count(*) as count_order
           from lineitem where l_shipdate <= date '1998-09-02'
           group by l_returnflag, l_linestatus
           order by l_returnflag, l_linestatus"""
    assert ts.sql("explain " + q) == js.sql("explain " + q)
    assert _check(js, ts, q, "mv_q1")


@pytest.mark.parametrize("mode", ["memory", "data_dir"])
def test_views_and_materialized_views(mode, tmp_path):
    js, ts = sessions(tmp_path if mode == "data_dir" else None)
    out = run_both(js, ts, [
        "create table vb (g varchar, v int)",
        "insert into vb values ('a', 1), ('a', 2), ('b', 5)",
        "create view vv as select g, sum(v) s from vb group by g",
        "select g, s from vv where s > 2 order by g",
        "select count(*) c from vv",
        "create materialized view mv as select g, count(*) c from vb "
        "group by g",
        "select g, c from mv order by g",
        "insert into vb values ('b', 6)",
        "select g, c from mv order by g",
        "refresh materialized view mv",
        "select g, c from mv order by g",
        "select vb.g, vv.s from vb, vv where vb.g = vv.g group by vb.g, "
        "vv.s order by 1",
        "create view vv as select 1",
        "create materialized view vb as select 1",
        "create materialized view bad as select zzz from vb",
        "show create table mv",
        "show create table vv",
        "select * from information_schema.views",
        "refresh materialized view nothing",
    ])
    assert out[9] == ("value", 2)
    assert "bad" not in ts.catalog.mv_defs
    if mode == "data_dir":
        # views and MV definitions replay; MVs re-materialize
        js = JSession(data_dir=str(tmp_path / "jax"))
        ts = Session(device="cpu", data_dir=str(tmp_path / "port"))
        run_both(js, ts, [
            "select g, s from vv order by g",
            "select g, c from mv order by g",
            "select * from information_schema.materialized_views",
            "drop table mv",
        ])
        js = JSession(data_dir=str(tmp_path / "jax"))
        ts = Session(device="cpu", data_dir=str(tmp_path / "port"))
    run_both(js, ts, ["drop table vv", "select * from vv", "show tables",
                      "select * from mv"])


def test_view_scoping_and_cycles():
    js, ts = sessions()
    run_both(js, ts, [
        "create table bt (a int)",
        "create table bu (a int)",
        "insert into bt values (1)",
        "insert into bu values (99)",
        "create view bv as select a from bt;",
        "with bt as (select a from bu) select a from bv",
        "create view c1 as select a from bt",
    ])
    for s in (js, ts):
        s.catalog.views["c1"] = "select a from c2"
        s.catalog.views["c2"] = "select a from c1"
    assert outcome(ts, "select * from c1") == outcome(js, "select * from c1")
    with pytest.raises(Exception, match="cyclic"):
        ts.sql("select * from c1")
