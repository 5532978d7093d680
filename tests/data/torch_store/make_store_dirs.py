"""Make the data directories the store-format tests and chip_smoke.py open.

    JAX_PLATFORMS=cpu python tests/data/torch_store/make_store_dirs.py \
        [--npz-tree DIR] [--uncompressed-tree DIR]

- `reference_dir/`: a data directory the JAX package writes (its parquet
  rowsets through pyarrow, the journal, the manifests and the
  plan-feedback sidecar) from STATEMENTS and from TPC-H SF 0.01 `orders`,
  `customer`, `nation` and `region` (seed 42), loaded by INSERT ... SELECT;
  and `reference_answers.json`, each query of ANSWER_QUERIES with the rows
  the JAX package gives over that directory (chip_smoke.py's `answer_rows`).
- `npz_dir/` (with `--npz-tree`): the same STATEMENTS written by the
  PyTorch port at DIR, a checkout of a commit whose TabletStore wrote
  `.npz` rowsets (58c45b7 and before), run in a child process with DIR
  first on the import path.
- `uncompressed_dir/` (with `--uncompressed-tree`): the same, by a port
  whose TabletStore wrote UNCOMPRESSED parquet with PLAIN numeric pages and
  one row group (0b903f7 to ca9e01a).

`--compare-bytes` prints the data files' bytes of the same statements as
written by each package (`reference_snappy`, `port`), and writes nothing
here. `--tpch-bytes SF [--port-tree DIR]` prints the bytes of each TPC-H
table at SF as one parquet file, pyarrow's defaults over the JAX
package's `_to_arrow` (its store's files) against the port's
`write_table` (of this checkout, or of DIR, run in a child process). The committed port directories stay as they were written: they
hold the reading of older files.

Needs the JAX package and pyarrow (and the old tree for `--npz-tree`);
nothing that reads these directories does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SF = 0.01
SEED = 42

# every stored type, NULLs, a RANGE-partitioned table, a PRIMARY KEY table
# after an upsert (delete vectors), ADD and DROP COLUMN, a DELETE rewrite
STATEMENTS = [
    "create table t (k bigint, i int, si smallint, ti tinyint, b boolean, "
    "f float, d double, p decimal(12,2), w decimal(30,4), dt date, "
    "ts datetime, v varchar(20), a array<int>, sa array<varchar>) "
    "distributed by hash(k) buckets 2",
    "insert into t values "
    "(1, 10, 100, 1, true, 1.5, 2.25, 1.50, 123456789012345678901.2345, "
    "date '2024-01-02', '2024-01-02 03:04:05', 'alpha', array(1, 2, 3), "
    "array('x', 'y')), "
    "(2, null, null, null, null, null, null, null, null, null, null, null, "
    "null, null), "
    "(3, -30, -300, -3, false, -1.25, -7.5, -2.25, -5.0001, "
    "date '1999-12-31', '1999-12-31 23:59:59', 'héllo', array(), "
    "array('z')), "
    "(4, 40, 4, 4, true, 0.0, 1e300, 99999.99, 0.0001, date '1970-01-01', "
    "'1970-01-01 00:00:00', '', array(-7), array())",
    "insert into t values (5, 50, 5, 5, false, 3.5, -0.5, 0.01, "
    "-99999999999999999999.9999, date '2038-01-19', '2038-01-19 03:14:07', "
    "'alpha', array(5, 5), array('y', 'x', 'y'))",
    "create table p (x bigint, v double, s varchar) partition by range(x) ("
    " partition lo values less than (100),"
    " partition mid values less than (1000),"
    " partition hi values less than (maxvalue)) "
    "distributed by hash(x) buckets 2",
    "insert into p values (1, 1.5, 'a'), (150, 2.5, null), (7, 3.5, 'b'), "
    "(5000, null, 'c'), (999, 4.5, 'a')",
    "create table kv (k bigint, v varchar, n int, primary key(k)) "
    "distributed by hash(k) buckets 3",
    "insert into kv values (1, 'a', 10), (2, 'b', 20), (3, 'c', 30), "
    "(4, 'd', 40), (5, null, 50)",
    "insert into kv values (2, 'B', 21), (4, 'D', null), (6, 'f', 60)",
    "create table al (k bigint, x int) distributed by hash(k) buckets 2",
    "insert into al values (1, 10), (2, 20), (3, 30)",
    "alter table al add column y varchar",
    "insert into al values (4, 40, 'four')",
    "alter table al drop column x",
    "insert into al values (5, 'five')",
    "delete from p where x = 7",
]

TPCH_TABLES = ("region", "nation", "customer", "orders")

TPCH_Q13 = """select c_count, count(*) as custdist from (
  select c_custkey, count(o_orderkey) as c_count
  from customer left outer join orders on c_custkey = o_custkey
    and o_comment not like '%special%requests%'
  group by c_custkey) as c_orders
group by c_count order by custdist desc, c_count desc"""

ANSWER_QUERIES = {
    "types": "select * from t order by k",
    "partitioned": "select * from p order by x",
    "primary_key": "select * from kv order by k",
    "altered": "select * from al order by k",
    "q13": TPCH_Q13,
    "orders_by_priority": (
        "select o_orderpriority, count(*) c, sum(o_totalprice) s, "
        "min(o_orderdate) d0, max(o_orderdate) d1 from orders "
        "group by o_orderpriority order by o_orderpriority"),
    "customers_by_region": (
        "select r_name, n_name, count(*) c, sum(c_acctbal) b "
        "from customer, nation, region where c_nationkey = n_nationkey "
        "and n_regionkey = r_regionkey group by r_name, n_name "
        "order by r_name, n_name"),
}


def _write(s, tpch_catalog):
    """STATEMENTS, then the TPC-H tables loaded by INSERT ... SELECT."""
    for text in STATEMENTS:
        s.sql(text)
    cat = tpch_catalog(sf=SF, seed=SEED)
    for name in TPCH_TABLES:
        h = cat.tables[name]
        cols = ", ".join(f"{f.name} {f.type!r}" for f in h.schema)
        s.sql(f"create table {name} ({cols}) distributed by hash("
              f"{h.schema.fields[0].name}) buckets 2")
        s.catalog.register(f"stage_{name}", h.table)
        s.sql(f"insert into {name} select * from stage_{name}")
        s.sql(f"drop table stage_{name}")


def _reference_session(out: str):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from starrocks_tpu.runtime.session import Session
    from starrocks_tpu.storage.catalog import tpch_catalog

    shutil.rmtree(out, ignore_errors=True)
    s = Session(data_dir=out)
    _write(s, tpch_catalog)
    return s


def _reference_dir(out: str):
    from chip_smoke import answer_rows

    s = _reference_session(out)
    answers = {q: answer_rows(s.sql(text).rows())
               for q, text in ANSWER_QUERIES.items()}
    with open(os.path.join(HERE, "reference_answers.json"), "w") as f:
        json.dump({"sf": SF, "seed": SEED, "queries": ANSWER_QUERIES,
                   "answers": answers}, f, indent=1)
        f.write("\n")


def _data_bytes(d: str) -> dict:
    """The bytes of each table's data files (rowset_*) under d."""
    return {t: sum(os.path.getsize(os.path.join(d, t, f))
                   for f in os.listdir(os.path.join(d, t))
                   if f.startswith("rowset_"))
            for t in sorted(os.listdir(d))
            if os.path.isdir(os.path.join(d, t))}


def _compare_bytes() -> dict:
    """The data files' bytes of reference_dir's statements written by the
    JAX package (pyarrow's defaults: SNAPPY, dictionary pages) and by the
    port (its own writer, in the same layout but for VARCHAR's sorted
    dictionaries), in a temporary directory."""
    import tempfile

    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import tpch_catalog

    with tempfile.TemporaryDirectory() as tmp:
        ref, port = os.path.join(tmp, "reference"), os.path.join(tmp, "port")
        _reference_session(ref)
        _write(Session(device="cpu", data_dir=port), tpch_catalog)
        out = {"sf": SF, "reference_snappy": _data_bytes(ref),
               "port": _data_bytes(port)}
    for k in ("reference_snappy", "port"):
        out[k]["total"] = sum(out[k].values())
    return out


def _port_tpch_files(sf: float, out: str):
    """Each TPC-H table at `sf` as one file under `out`, written by the
    port on the import path."""
    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.formats.parquet_write import (
        write_table)

    for name, h in tpch_catalog(sf=sf, seed=SEED).tables.items():
        write_table(h.table, os.path.join(out, f"{name}.parquet"))


def _tpch_bytes(sf: float, tree) -> dict:
    """{table: (pyarrow's bytes, the port's bytes, ratio)}, one file per
    table, and the totals."""
    import tempfile

    import pyarrow.parquet as pq

    from starrocks_tpu.storage.catalog import tpch_catalog
    from starrocks_tpu.storage.store import _to_arrow

    tree = os.path.abspath(tree or REPO)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--write-tpch", tmp, "--sf", str(sf)],
                       env=env, check=True, cwd=tree)
        for name, h in tpch_catalog(sf=sf, seed=SEED).tables.items():
            ref = os.path.join(tmp, f"{name}.pyarrow")
            pq.write_table(_to_arrow(h.table), ref)
            a = os.path.getsize(ref)
            b = os.path.getsize(os.path.join(tmp, f"{name}.parquet"))
            out[name] = (a, b, round(b / a, 3))
    a, b = (sum(v[i] for v in out.values()) for i in (0, 1))
    out["total"] = (a, b, round(b / a, 3))
    return {"sf": sf, "port_tree": tree, "pyarrow_port_ratio": out}


def _port_dir(out: str, ext: str):
    """STATEMENTS written at `out` by the port on the import path, whose
    data files must end in `ext`."""
    from starrocks_tpu_torch.runtime.session import Session

    shutil.rmtree(out, ignore_errors=True)
    s = Session(device="cpu", data_dir=out)
    for text in STATEMENTS:
        s.sql(text)
    files = [f for _, _, fs in os.walk(out) for f in fs
             if f.startswith("rowset_")]
    assert files and all(f.endswith(ext) for f in files), files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npz-tree", default=None,
                    help="a checkout whose port writes .npz rowsets")
    ap.add_argument("--uncompressed-tree", default=None,
                    help="a checkout whose port writes UNCOMPRESSED parquet")
    ap.add_argument("--tpch-bytes", type=float, default=None, metavar="SF",
                    help="print each TPC-H table's bytes as one file, "
                    "pyarrow's defaults against the port's writer")
    ap.add_argument("--port-tree", default=None,
                    help="with --tpch-bytes: a checkout whose writer to use")
    ap.add_argument("--write-npz", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--write-tpch", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sf", type=float, default=SF, help=argparse.SUPPRESS)
    ap.add_argument("--write-parquet", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--compare-bytes", action="store_true",
                    help="print both packages' data-file bytes for the "
                    "same statements; write nothing here")
    args = ap.parse_args(argv)
    if args.write_npz:
        _port_dir(args.write_npz, ".npz")
        return 0
    if args.write_parquet:
        _port_dir(args.write_parquet, ".parquet")
        return 0
    if args.write_tpch:
        _port_tpch_files(args.sf, args.write_tpch)
        return 0
    sys.path.insert(0, REPO)
    if args.compare_bytes:
        print(json.dumps(_compare_bytes()))
        return 0
    if args.tpch_bytes:
        print(json.dumps(_tpch_bytes(args.tpch_bytes, args.port_tree)))
        return 0
    _reference_dir(os.path.join(HERE, "reference_dir"))
    for tree, flag, out in ((args.npz_tree, "--write-npz", "npz_dir"),
                            (args.uncompressed_tree, "--write-parquet",
                             "uncompressed_dir")):
        if tree:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            flag, os.path.join(HERE, out)],
                           env=env, check=True, cwd=tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
