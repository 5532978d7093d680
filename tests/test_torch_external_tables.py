"""External parquet/ORC tables in the port, read without pyarrow.

The counterparts of tests/test_external_tables.py run the same statements
through both packages. The readers (storage/formats/parquet.py, orc.py)
are then held on their own against pyarrow's read of files pyarrow wrote
(codecs, dictionary on and off, data pages v1 and v2, several row groups
and stripes, NULLs, every column type of TPC-H and of the reference's
DECIMAL(38) and date tests) and against the reference's
`HostTable.from_arrow` of the same file: columns, validity masks and
types. Tests may import pyarrow; the port never does.
"""

from __future__ import annotations

import datetime
import decimal
import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pyarrow.parquet as pq
import pytest

from starrocks_tpu.column.host_table import HostTable as JHostTable
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.storage.external import (
    ExternalTableHandle, _read_files)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "torch_formats"))
from make_lzo import orc_to_lzo  # noqa: E402


def Session(*args, **kwargs):
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


@pytest.fixture()
def ext_dir(tmp_path):
    d = tmp_path / "lake"
    d.mkdir()
    for i in range(3):
        t = pa.table({
            "k": pa.array([i * 10 + j for j in range(10)], pa.int64()),
            "cat": pa.array([f"c{(i * 10 + j) % 4}" for j in range(10)]),
            "x": pa.array([float(j) + i for j in range(10)], pa.float64()),
        })
        pq.write_table(t, d / f"part-{i}.parquet")
    return str(d)


def _rows_both(stmts, query, **kw):
    out = []
    for mk in (Session, JSession):
        s = mk(**kw)
        for st in stmts:
            s.sql(st)
        out.append(s.sql(query).rows())
    return out


# --- the counterparts of tests/test_external_tables.py ----------------------

def test_external_scan_and_joins(ext_dir):
    create = f"create external table lake from '{ext_dir}'"
    for q in ("select count(*), min(k), max(k) from lake",
              "select cat, count(*), sum(x) from lake group by cat "
              "order by cat"):
        got, want = _rows_both([create], q)
        assert got == want
    assert got[0][0] == "c0" and sum(r[1] for r in got) == 30
    joins = [create, "create table dim (cat varchar, label varchar)",
             "insert into dim values ('c0', 'zero'), ('c1', 'one')"]
    got, want = _rows_both(
        joins, "select d.label, count(*) from lake l join dim d "
        "on l.cat = d.cat group by d.label order by 1")
    assert got == want and [x[0] for x in got] == ["one", "zero"]


def test_external_metadata_only_row_count(ext_dir):
    h = ExternalTableHandle("lake", ext_dir)
    assert h.row_count == 30        # footers only
    assert h._table is None         # no data loaded yet
    assert len(h.schema.names) == 3
    assert h._table is None


def test_external_rejects_writes(ext_dir):
    s = Session()
    s.sql(f"create external table lake from '{ext_dir}'")
    for stmt in ("insert into lake values (1, 'c0', 1.0)",
                 "delete from lake where k = 1",
                 "update lake set x = 0 where k = 1"):
        with pytest.raises(ValueError, match="EXTERNAL"):
            s.sql(stmt)
    # DROP unregisters without touching the files
    s.sql("drop table lake")
    assert len(os.listdir(ext_dir)) == 3


def test_external_glob_and_info_schema(ext_dir):
    s = Session()
    s.sql(f"create external table l2 from '{ext_dir}/part-*.parquet'")
    assert s.sql("select count(*) from l2").rows() == [(30,)]
    r = dict(s.sql("select table_name, table_type from "
                   "information_schema.tables").rows())
    assert "l2" in r
    got, want = _rows_both(
        [f"create external table l2 from '{ext_dir}/part-*.parquet'"],
        "select table_name, location from information_schema.external_tables")
    assert got == want == [("l2", f"{ext_dir}/part-*.parquet")]


def test_external_defs_survive_restart(ext_dir, tmp_path):
    store = tmp_path / "store"
    s = Session(data_dir=str(store))
    s.sql(f"create external table lake from '{ext_dir}'")
    assert s.sql("select count(*) from lake").rows() == [(30,)]
    s2 = Session(data_dir=str(store))
    assert s2.sql("select count(*) from lake").rows() == [(30,)]
    # a new file appears after CREATE: refresh sees it
    pq.write_table(pa.table({"k": pa.array([99], pa.int64()),
                             "cat": pa.array(["c9"]),
                             "x": pa.array([1.0], pa.float64())}),
                   ext_dir + "/part-9.parquet")
    s2.catalog.get_table("lake").invalidate()
    s2.cache.invalidate("lake")
    assert s2.sql("select count(*) from lake").rows() == [(31,)]
    # the image carries the definition too: a checkpoint then a restart
    s2.checkpoint_metadata()
    os.remove(os.path.join(str(store), "external_tables.json"))
    s3 = Session(data_dir=str(store))
    assert s3.sql("select count(*) from lake").rows() == [(31,)]
    s3.sql("drop table lake")
    s4 = Session(data_dir=str(store))
    assert s4.catalog.get_table("lake") is None


def test_changed_files_are_noticed_without_a_manual_refresh(ext_dir):
    """data_version from file stats: the query cache and the DeviceCache
    notice a file that appeared, with no invalidate() call."""
    from starrocks_tpu_torch.runtime.config import config

    s = Session()
    s.sql(f"create external table lake from '{ext_dir}'")
    prev = config.get("enable_query_cache")
    config.set("enable_query_cache", True)
    try:
        q = "select count(*), sum(k) from lake"
        assert s.sql(q).rows() == [(30, 435)]
        assert s.sql(q).rows() == [(30, 435)]  # a cache hit
        pq.write_table(pa.table({"k": pa.array([100], pa.int64()),
                                 "cat": pa.array(["c0"]),
                                 "x": pa.array([0.5], pa.float64())}),
                       ext_dir + "/part-5.parquet")
        assert s.sql(q).rows() == [(31, 535)]
    finally:
        config.set("enable_query_cache", prev)


def test_external_rejects_load_csv_and_alter(ext_dir, tmp_path):
    s = Session()
    s.sql(f"create external table lake from '{ext_dir}'")
    csv = tmp_path / "x.csv"
    csv.write_text("1,c0,1.0\n")
    with pytest.raises(ValueError, match="EXTERNAL"):
        s.load_csv("lake", str(csv))
    with pytest.raises(ValueError, match="EXTERNAL"):
        s.sql("alter table lake add column extra int")


def test_external_orc_table(tmp_path):
    """ORC external tables read through the same lazy host-table path as
    parquet; a data_dir that holds ORC files next to the port's store."""
    d = tmp_path / "orcdir"
    d.mkdir()
    t1 = pa.table({"k": [1, 2, 3], "v": ["a", "b", "a"]})
    t2 = pa.table({"k": [4, 5], "v": ["c", "a"]})
    po.write_table(t1, str(d / "part1.orc"))
    po.write_table(t2, str(d / "part2.orc"))

    s = Session()
    s.sql(f"create external table eorc from '{d}'")
    # schema/rowcount from footers only
    assert s.sql("describe eorc") == [
        ("k", "BIGINT", "YES"), ("v", "VARCHAR", "YES")]
    assert s.sql("select count(*) from eorc").rows() == [(5,)]
    create = f"create external table eorc from '{d}'"
    for q in ("select v, count(*) c from eorc group by v order by v",
              "select sum(k) from eorc where v = 'a'"):
        got, want = _rows_both([create], q)
        assert got == want
    assert got == [(9,)]
    with pytest.raises(ValueError, match="EXTERNAL"):
        s.sql("insert into eorc values (9, 'z')")
    s = Session(data_dir=str(d))
    s.sql("create table u (a int, b varchar)")
    s.sql("insert into u values (1, 'aa'), (null, 'bb'), (3, null)")
    s2 = Session(data_dir=str(d))
    rows = s2.sql("select a, b from u order by a nulls first").rows()
    assert rows == [(None, "bb"), (1, "aa"), (3, None)]


# --- the readers on their own ------------------------------------------------

N = 3000


def _every_type() -> pa.Table:
    """Every column type of TPC-H plus the reference's DECIMAL(38) and
    date tests, with NULLs in most columns."""
    rng = np.random.default_rng(3)

    def nulls(vals, every):
        return [None if i % every == 0 else v for i, v in enumerate(vals)]

    day0 = datetime.date(1992, 1, 1)
    return pa.table({
        "key": pa.array(np.arange(N) * 7 - 9000, pa.int64()),
        "i32": pa.array(nulls(rng.integers(-2**31, 2**31 - 1, N).tolist(), 7),
                        pa.int32()),
        "i16": pa.array(rng.integers(-2**15, 2**15 - 1, N), pa.int16()),
        "i8": pa.array(rng.integers(-128, 127, N), pa.int8()),
        "flag": pa.array(nulls([bool(v) for v in rng.integers(0, 2, N)], 5)),
        "f64": pa.array(nulls(rng.normal(size=N).tolist(), 9), pa.float64()),
        "f32": pa.array(rng.normal(size=N).astype(np.float32), pa.float32()),
        "status": pa.array(nulls([("F", "O", "P")[v] for v in
                                  rng.integers(0, 3, N)], 11)),
        "comment": pa.array([f"comment {i} é" * (i % 3) for i in range(N)]),
        "d": pa.array(nulls([day0 + datetime.timedelta(days=int(v))
                             for v in rng.integers(0, 2500, N)], 13)),
        "price": pa.array(nulls([decimal.Decimal(int(v)).scaleb(-2)
                                 for v in rng.integers(-10**9, 10**9, N)],
                                17), pa.decimal128(15, 2)),
        "big": pa.array(nulls([decimal.Decimal(int(v) * 10**21 + 5).scaleb(-4)
                               for v in rng.integers(-10**6, 10**6, N)], 19),
                        pa.decimal128(38, 4)),
    })


def _assert_like_the_reference(path: str, table: pa.Table):
    """The port's read of `path` equals the reference's from_arrow of
    pyarrow's read: schema (names, types), columns and masks."""
    got = _read_files([path])
    want = JHostTable.from_arrow(table)
    assert [(f.name, str(f.type)) for f in got.schema] == \
        [(f.name, str(f.type)) for f in want.schema]
    for f in want.schema:
        a, b = got.arrays[f.name], want.arrays[f.name]
        if f.type.is_string:
            a = got.schema.field(f.name).dict.values[a]
            b = f.dict.values[b]
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        va, vb = got.valids.get(f.name), want.valids.get(f.name)
        assert (va is None) == (vb is None), f.name
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=f.name)


@pytest.mark.parametrize("codec", ["snappy", "gzip", "none"])
@pytest.mark.parametrize("dictionary", [True, False])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
def test_parquet_reader_equals_pyarrow(tmp_path, codec, dictionary,
                                       page_version):
    table = _every_type()
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, compression=codec, use_dictionary=dictionary,
                   data_page_version=page_version, row_group_size=1000,
                   data_page_size=4096)
    assert pq.ParquetFile(path).metadata.num_row_groups == 3
    _assert_like_the_reference(path, pq.read_table(path))


@pytest.mark.parametrize("codec", ["uncompressed", "zlib"])
@pytest.mark.parametrize("dictionary", [0.0, 1.0])
def test_orc_reader_equals_pyarrow(tmp_path, codec, dictionary):
    """NONE and ZLIB; strings direct (threshold 0, pyarrow's default) and
    dictionary-encoded; several stripes."""
    table = _every_type()
    path = str(tmp_path / "t.orc")
    po.write_table(table, path, compression=codec,
                   dictionary_key_size_threshold=dictionary,
                   stripe_size=4096, batch_size=500)
    if codec == "uncompressed":  # (pyarrow sizes stripes after zlib)
        assert po.ORCFile(path).nstripes > 1
    _assert_like_the_reference(path, po.ORCFile(path).read())


@pytest.mark.parametrize("fmt", ["parquet", "orc", "orc_lzo"])
def test_external_table_of_every_type_matches_the_reference(tmp_path, fmt):
    """Through SQL: the same directory of files as an external table in
    both packages gives the same rows (DECIMAL(38) as Decimal values).
    ORC LZO files are ZLIB ones recompressed by
    tests/data/torch_formats/make_lzo.py; the reference reads them
    through pyarrow (the ORC library's LZO decoder)."""
    table = _every_type()
    d = tmp_path / "t"
    d.mkdir()
    for i, part in enumerate((table.slice(0, 1700), table.slice(1700))):
        if fmt == "parquet":
            pq.write_table(part, str(d / f"p{i}.parquet"))
        elif fmt == "orc":
            po.write_table(part, str(d / f"p{i}.orc"))
        else:
            src = str(tmp_path / f"zlib{i}.orc")
            po.write_table(part, src, compression="zlib",
                           row_index_stride=1 << 20)
            orc_to_lzo(src, str(d / f"p{i}.orc"))
    got, want = _rows_both([f"create external table t from '{d}'"],
                           "select * from t order by key")
    assert len(got) == N and got == want


def test_unported_formats_raise_a_named_error(tmp_path):
    """An ORC STRUCT column raises NotImplementedError naming the feature
    and the file; nothing falls back to another reader. (Parquet BROTLI,
    which raised here until the port had its decoder, now reads as the
    reference reads it.)"""
    path = str(tmp_path / "b.parquet")
    table = _every_type()
    pq.write_table(table, path, compression="brotli")
    _assert_like_the_reference(path, pq.read_table(path))
    opath = str(tmp_path / "s.orc")
    po.write_table(pa.table({"s": [{"x": 1}, {"x": 2}]}), opath)
    with pytest.raises(NotImplementedError,
                       match="s.orc.*STRUCT|STRUCT.*s.orc"):
        _read_files([opath])
