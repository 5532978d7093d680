"""The TabletStore's data files against the JAX package's: one data
directory, opened by either package.

The reference writes its rowsets as parquet through pyarrow; the port
writes parquet with its own writer (storage/formats/parquet_write.py) and
reads both with its own reader. Held here, on the CPU at small sizes:

- a directory one package writes reads in the other with the writer's own
  rows, for every stored type with NULLs, a RANGE-partitioned table, a
  PRIMARY KEY table after upserts (delete vectors), ADD and DROP COLUMN,
  compaction, DELETE and TRUNCATE rewrites, and HLL/BITMAP columns;
- the port's files read in `pq.read_table` as the reference's files of
  the same statements read, and the manifests (file names, live columns,
  zonemaps, delete vectors, partitions) equal the reference's;
- a mixed directory (the reference writes, the port inserts, upserts and
  compacts) reopens in both;
- the committed directories (tests/data/torch_store/, made by
  make_store_dirs.py): one the reference wrote, whose answers the port
  gives, and one the port wrote as `.npz` rowsets before it wrote
  parquet, which still opens and compacts into parquet;
- the reference's plan-feedback sidecar in a directory is never applied to
  another plan (its fingerprints collide: ROADMAP, reference defects): S2
  keeps its 14 segment_sum calls after Q13 under the kernel strategies.
"""

import json
import os
import shutil
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest

from starrocks_tpu import types as JT
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.runtime.session import Session as JSession

from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.runtime.session import Session as TSession

from torch_sql_scripts import _default_knobs  # noqa: F401 (fixture)
from chip_smoke import answers_agree
from torch_tpch_parity import rows_match

HERE = os.path.dirname(os.path.abspath(__file__))
STORE_DATA = os.path.join(HERE, "data", "torch_store")
sys.path.insert(0, STORE_DATA)
from make_store_dirs import STATEMENTS  # noqa: E402

PACKAGES = {"reference": lambda d: JSession(data_dir=str(d)),
            "port": lambda d: TSession(device="cpu", data_dir=str(d))}


def _open(pkg: str, d):
    return PACKAGES[pkg](d)


def _other(pkg: str) -> str:
    return "port" if pkg == "reference" else "reference"


def _rows(session, queries) -> list:
    return [session.sql(q).rows() for q in queries]


def _data_files(d) -> list:
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
                  if f.startswith("rowset_"))


def _compact(session, table):
    session.store.compact_table(table)
    session.catalog.get_table(table).invalidate()


# (statements, queries): each script runs in the writing package; the
# reader reopens the directory and must give the writer's rows
SCRIPTS = {
    "types": (STATEMENTS[:3], ["select * from t order by k",
                               "select count(*), sum(i), min(v), max(dt) "
                               "from t"]),
    "partitioned": (
        STATEMENTS[3:5] + ["insert into p values (20, 9.5, 'z'), "
                           "(2000, 1.0, 'y')"],
        ["select * from p order by x",
         "select count(*) from p where x < 100"]),
    "primary_key": (
        STATEMENTS[5:8] + ["insert into kv values (1, 'A', 11), "
                            "(6, 'F', 61), (7, 'g', 70)"],
        ["select * from kv order by k", "select count(*) from kv"]),
    "alter": (STATEMENTS[8:14], ["select * from al order by k"]),
    "rewrite": (
        STATEMENTS[3:5] + ["delete from p where s = 'a'",
                           "insert into p values (3, 3.0, 'q')"],
        ["select * from p order by x"]),
    "truncate": (
        STATEMENTS[8:10] + ["truncate table al",
                             "insert into al values (9, 90)"],
        ["select * from al order by k"]),
}
COMPACT = {"primary_key": "kv", "alter": "al", "types": "t"}


def _write(pkg, d, script):
    s = _open(pkg, d)
    for text in script:
        s.sql(text)
    return s


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_a_directory_reads_in_the_other_package(tmp_path, script, writer):
    """The reader gives the writer's rows, before and (where the script
    names a table) after the writer compacts."""
    statements, queries = SCRIPTS[script]
    d = tmp_path / "d"
    w = _write(writer, d, statements)
    want = _rows(w, queries)
    got = _rows(_open(_other(writer), d), queries)
    for q, g, x in zip(queries, got, want):
        assert rows_match(g, x), (q, g, x)
    if script in COMPACT:
        _compact(w, COMPACT[script])
        assert _rows(w, queries) == want
        got = _rows(_open(_other(writer), d), queries)
        for q, g, x in zip(queries, got, want):
            assert rows_match(g, x), (q, g, x)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_files_read_in_pyarrow_and_manifests_equal(tmp_path, script):
    """The same statements in both packages: equal manifests, data files
    of the same names, and each port file read by `pq.read_table` equal
    to the reference's file of that name (values and Arrow types)."""
    statements, _ = SCRIPTS[script]
    js = _write("reference", tmp_path / "jax", statements)
    ts = _write("port", tmp_path / "port", statements)
    if script in COMPACT:
        for s in (js, ts):
            _compact(s, COMPACT[script])
    for table in ts.store.table_names():
        assert (ts.store.read_manifest(table)
                == js.store.read_manifest(table)), table
    ours = _data_files(tmp_path / "port")
    theirs = _data_files(tmp_path / "jax")
    assert ours and [os.path.relpath(p, tmp_path / "port") for p in ours] \
        == [os.path.relpath(p, tmp_path / "jax") for p in theirs]
    for a, b in zip(ours, theirs):
        assert a.endswith(".parquet")
        ta, tb = pq.read_table(a), pq.read_table(b)
        assert ta.to_pylist() == tb.to_pylist(), a
        assert ([str(f.type).replace("element", "item") for f in ta.schema]
                == [str(f.type).replace("element", "item")
                    for f in tb.schema]), a
        meta = pq.ParquetFile(a).metadata
        assert meta.num_row_groups == 1
        assert meta.row_group(0).column(0).compression == "SNAPPY"


def test_the_two_repros(tmp_path):
    """Motivation's repros: a 4-row table through both packages each way
    (the port once raised reading the reference's parquet with np.load,
    and the reference could not read the port's .npz files)."""
    script = ["CREATE TABLE t (k BIGINT, v VARCHAR(20), p DECIMAL(12,2), "
              "dt DATE) DISTRIBUTED BY HASH(k) BUCKETS 2",
              "INSERT INTO t VALUES (1, 'a', 1.25, DATE '2024-01-01'), "
              "(2, 'b', NULL, DATE '2024-02-29'), (3, NULL, -3.50, NULL), "
              "(4, 'd', 4.00, DATE '1970-01-01')"]
    for writer in PACKAGES:
        d = tmp_path / writer
        want = _write(writer, d, script).sql(
            "select * from t order by k").rows()
        got = _open(_other(writer), d).sql(
            "select * from t order by k").rows()
        assert got == want and len(got) == 4, writer


def test_mixed_directory_reopens_in_both(tmp_path):
    """The reference writes, the port inserts, upserts, deletes and
    compacts, the reference reopens: both give the rows of the reference
    running the whole sequence in a directory of its own."""
    first = STATEMENTS[:3] + STATEMENTS[5:8]
    then = ["insert into t values (6, 60, 6, 6, true, 6.5, 6.25, 6.00, "
            "6.0006, date '2006-06-06', '2006-06-06 06:06:06', 'six', "
            "array(6), array('s'))",
            "insert into kv values (3, 'C', 31), (8, 'h', 80)",
            "delete from t where k = 2"]
    queries = ["select * from t order by k", "select * from kv order by k"]
    d = tmp_path / "mixed"
    _write("reference", d, first)
    ts = _write("port", d, then)
    _compact(ts, "kv")
    _compact(ts, "t")
    want = _rows(_write("reference", tmp_path / "alone", first + then),
                 queries)
    for pkg in PACKAGES:
        got = _rows(_open(pkg, d), queries)
        for q, g, x in zip(queries, got, want):
            assert rows_match(g, x), (pkg, q, g, x)
    files = _data_files(d / "kv")
    assert len(files) == 3 and all(f.endswith(".parquet") for f in files)


def _answers():
    with open(os.path.join(STORE_DATA, "reference_answers.json")) as f:
        return json.load(f)


def test_committed_reference_directory_gives_its_answers(tmp_path):
    """The directory the reference wrote (its journal, manifests, pyarrow's
    SNAPPY parquet and its plan-feedback sidecar) opens in the port, and
    every answer equals the reference's; a port insert and compaction in
    it then read back in the reference."""
    ans = _answers()
    d = tmp_path / "db"
    shutil.copytree(os.path.join(STORE_DATA, "reference_dir"), d)
    ts = _open("port", d)
    for q, text in ans["queries"].items():
        assert answers_agree(ts.sql(text).rows(), ans["answers"][q]), q
    ts.sql("insert into orders select * from orders where o_orderkey < 100")
    _compact(ts, "orders")
    want = ts.sql(ans["queries"]["orders_by_priority"]).rows()
    got = _open("reference", d).sql(ans["queries"]["orders_by_priority"])
    assert rows_match(got.rows(), want)


def test_npz_directory_still_opens(tmp_path):
    """A directory the port wrote as `.npz` rowsets (before parquet) gives
    the reference's answers to the same statements; an insert there adds a
    parquet file beside the `.npz` ones, and compaction merges both into
    parquet, which the reference then reads."""
    ans = _answers()
    d = tmp_path / "db"
    shutil.copytree(os.path.join(STORE_DATA, "npz_dir"), d)
    assert all(f.endswith(".npz") for f in _data_files(d))
    ts = _open("port", d)
    for q in ("types", "partitioned", "primary_key", "altered"):
        text = ans["queries"][q]
        assert answers_agree(ts.sql(text).rows(), ans["answers"][q]), q
    ts.sql("insert into kv values (1, 'one', 1), (9, 'nine', 9)")
    kinds = {os.path.splitext(f)[1] for f in _data_files(d / "kv")}
    assert kinds == {".npz", ".parquet"}
    want = ts.sql("select * from kv order by k").rows()
    _compact(ts, "kv")
    assert all(f.endswith(".parquet") for f in _data_files(d / "kv"))
    assert ts.sql("select * from kv order by k").rows() == want
    assert _open("reference", d).sql(
        "select * from kv order by k").rows() == want


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("kind", ["hll", "bitmap"])
def test_sketch_columns_read_in_the_other_package(tmp_path, kind, writer):
    """HLL registers and BITMAP planes (BYTE_ARRAY rows of int8), with a
    NULL row, read in the other package; an ADD COLUMN of the type reads
    NULL for the old rows."""
    rng = np.random.default_rng(5)
    w = 1 << 12 if kind == "hll" else 512
    rows = rng.integers(0, 6 if kind == "hll" else 127, (3, w),
                        dtype=np.int8)
    data = {"k": [0, 1, 2],
            "users": [rows[0].tobytes(), None, rows[2].tobytes()]}
    ddl = ("create table s (k int, users hll(12))" if kind == "hll" else
           "create table s (k int, users bitmap(4096))")
    fn = "hll_cardinality" if kind == "hll" else "bitmap_count"
    queries = [f"select k, {fn}(users) from s order by k"]
    d = tmp_path / "d"
    s = _open(writer, d)
    s.sql(ddl)
    HT, typ, it = ((JHostTable, JT, JT.INT) if writer == "reference"
                   else (THostTable, TT, TT.INT))
    st = typ.HLL(12) if kind == "hll" else typ.BITMAP(4096)
    s._append(s.catalog.get_table("s"),
              HT.from_pydict(data, types={"k": it, "users": st}))
    want = _rows(s, queries)
    r = _open(_other(writer), d)
    assert _rows(r, queries) == want
    add = "hll(12)" if kind == "hll" else "bitmap(4096)"
    r.sql(f"alter table s add column more {add}")
    got = r.sql(f"select k, {fn}(more) from s order by k").rows()
    assert [g[0] for g in got] == [0, 1, 2]
    assert _rows(_open(writer, d), queries) == want


def test_reference_feedback_sidecar_is_not_applied_to_another_plan(tmp_path):
    """The reference's sidecar in a data directory, learned over Q13 (whose
    fingerprint the reference shares with S2), opens in the port without
    harm: under the kernel strategies the port's S2 after Q13 keeps its 14
    segment_sum calls and the reference's rows."""
    from starrocks_tpu.storage.catalog import tpch_catalog as jtpch
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.config import (
        KERNEL_STRATEGIES, config as tcfg)
    from starrocks_tpu_torch.storage.catalog import tpch_catalog as ttpch
    from starrocks_tpu_torch.storage.tpch_queries import (
        QUERIES, STAT_QUERIES)

    d = tmp_path / "d"
    js = JSession(jtpch(sf=0.01), data_dir=str(d))
    js.sql(QUERIES[13])
    want = js.sql(STAT_QUERIES["S2"]).rows()
    with open(d / "plan_feedback.json") as f:
        assert json.load(f)["entries"]
    for k, v in KERNEL_STRATEGIES.items():
        tcfg.set(k, v)
    ts = TSession(ttpch(sf=0.01), device="cpu", data_dir=str(d))
    ts.sql(QUERIES[13])
    kernels.reset_counts()
    got = ts.sql(STAT_QUERIES["S2"]).rows()
    assert kernels.counts()["segment_sum"]["calls"] == 14
    assert rows_match(got, want, rel=1e-4)
    # and the port's sidecar in the reference: the same rows
    js2 = JSession(jtpch(sf=0.01), data_dir=str(d))
    assert rows_match(js2.sql(STAT_QUERIES["S2"]).rows(), want)


def test_pages_and_row_groups_read_back(tmp_path, monkeypatch):
    """Data files of many pages (the port's writer at 64 values a page)
    and of many row groups and small dictionary-encoded pages (the same
    files rewritten by pyarrow): strings, string lists and NULLs read back
    in both packages as written."""
    from starrocks_tpu_torch.storage.formats import parquet_write

    monkeypatch.setattr(parquet_write, "PAGE_VALUES", 64)
    rows = ", ".join(
        f"({i}, {'null' if i % 7 == 3 else repr(f'w{i % 37}')}, "
        f"array({', '.join(repr(f's{(i + j) % 11}') for j in range(i % 4))}),"
        f" {i * 3})" for i in range(1000))
    script = ["create table m (k bigint, v varchar, a array<varchar>, "
              "n int) distributed by hash(k) buckets 2",
              f"insert into m values {rows}"]
    q = ["select * from m order by k", "select v, count(*) from m "
         "group by v order by v"]
    d = tmp_path / "d"
    want = _rows(_write("port", d, script), q)
    assert _rows(_open("reference", d), q) == want
    for f in _data_files(d / "m"):
        pq.write_table(pq.read_table(f), f, row_group_size=100,
                       data_page_size=512, compression="snappy")
        assert pq.ParquetFile(f).metadata.num_row_groups > 1
    assert _rows(_open("port", d), q) == want
