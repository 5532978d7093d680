"""The TabletStore's parquet writer (storage/formats/parquet_write.py)
against pyarrow's defaults, the layout the JAX package's store writes.

Held here, on the CPU at small sizes:

- `native.snappy_compress` gives blocks that pyarrow's snappy and the
  port's own decoder take back, on edge sizes around the 64 KiB block and
  on runs, random bytes, text and a 5 MiB TPC-H column, within 1.10x of
  pyarrow's compressor on TPC-H columns;
- the RLE/bit-packed hybrid of levels and dictionary indices (repeated runs
  where a group of 8 starts 8 or more equal values) decodes back;
- the store's files (insert, compaction, DELETE rewrite) read in pyarrow
  as SNAPPY with RLE_DICTIONARY on every non-BOOLEAN column and give the
  reference's rows;
- a dictionary past 1 MiB ends in PLAIN pages, and such a chunk (flat,
  DECIMAL(38), HLL and LIST) reads back exactly in pyarrow, the port's
  reader and the store's;
- float dictionaries keep -0.0, 0.0 and NaN payloads bit for bit;
- a directory the port wrote before (UNCOMPRESSED, PLAIN numeric pages)
  still opens with its answers, and compacts into the new layout;
- the statistics equal pyarrow's of the same Arrow table;
- at TPC-H SF 0.01, one file per table, the port's bytes are within 1.15x
  of pyarrow's defaults, per table and in total;
- the options (UNCOMPRESSED, no dictionary, row groups, DECIMAL
  annotation), and a failing compressor or build makes the write raise.
"""

import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from starrocks_tpu import types as JT
from starrocks_tpu.column import Field as JField
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.column import Schema as JSchema
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import tpch_catalog as jtpch
from starrocks_tpu.storage.store import _to_arrow

from starrocks_tpu_torch import native
from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import Field as TField
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.column import Schema as TSchema
from starrocks_tpu_torch.runtime.session import Session as TSession
from starrocks_tpu_torch.storage import store as tstore
from starrocks_tpu_torch.storage.catalog import tpch_catalog as ttpch
from starrocks_tpu_torch.storage.formats.parquet import ParquetFile, _Thrift
from starrocks_tpu_torch.storage.formats.parquet_write import write_table

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "data", "torch_store"))
from make_store_dirs import STATEMENTS  # noqa: E402

SF = 0.01
SEED = 42


@pytest.fixture(scope="module")
def tpch():
    """(the reference's, the port's) TPC-H catalogs at SF 0.01."""
    return jtpch(sf=SF, seed=SEED), ttpch(sf=SF, seed=SEED)


def _plain_strings(ht, name: str) -> bytes:
    """A VARCHAR column as PLAIN byte arrays (what a page holds)."""
    f = ht.schema.field(name)
    vals = f.dict.values[ht.arrays[name]]
    return b"".join(len(v.encode()).to_bytes(4, "little") + v.encode()
                    for v in vals)


def _column_bytes(ht, name: str) -> bytes:
    f = ht.schema.field(name)
    if f.type.is_string:
        return _plain_strings(ht, name)
    return np.ascontiguousarray(ht.arrays[name]).tobytes()


# --- snappy ------------------------------------------------------------------

_RNG = np.random.default_rng(17)
SNAPPY_CASES = {
    "empty": b"",
    "one_byte": b"x",
    "block_less_1": _RNG.integers(0, 4, 65535, dtype=np.uint8).tobytes(),
    "block": _RNG.integers(0, 4, 65536, dtype=np.uint8).tobytes(),
    "block_plus_1": _RNG.integers(0, 4, 65537, dtype=np.uint8).tobytes(),
    "long_runs": b"".join(bytes([c]) * int(n) for c, n in zip(
        _RNG.integers(0, 256, 300), _RNG.integers(1, 3000, 300))),
    "random": _RNG.integers(0, 256, 300_000, dtype=np.uint8).tobytes(),
    "text": (b"It was the best of times, it was the worst of times, it "
             b"was the age of wisdom, it was the age of foolishness; ")
    * 4000,
}


@pytest.mark.parametrize("case", sorted(SNAPPY_CASES) + ["tpch_5mib"])
def test_snappy_compress_round_trips(case, tpch):
    """pyarrow's snappy and the port's decoder take the block back."""
    if case == "tpch_5mib":  # PLAIN l_shipinstruct at SF 0.06: 6.2 MB
        li = ttpch(sf=0.06, seed=SEED).tables["lineitem"].table
        data = _column_bytes(li, "l_shipinstruct")[:5 << 20]
        assert len(data) == 5 << 20
    else:
        data = SNAPPY_CASES[case]
    block = native.snappy_compress(data)
    assert len(block) <= 32 + len(data) + len(data) // 6
    back = pa.decompress(block.tobytes(), decompressed_size=len(data),
                         codec="snappy").to_pybytes()
    assert back == data
    assert native.snappy_decompress(block, len(data)).tobytes() == data


TPCH_COLUMNS = [("lineitem", "l_orderkey"), ("lineitem", "l_extendedprice"),
                ("lineitem", "l_shipdate"), ("lineitem", "l_shipinstruct"),
                ("orders", "o_totalprice"), ("orders", "o_clerk"),
                ("part", "p_name"), ("partsupp", "ps_supplycost")]


@pytest.mark.parametrize("table,column", TPCH_COLUMNS)
def test_snappy_within_pyarrow_on_tpch_columns(table, column, tpch):
    """At most 1.10x the bytes of pyarrow's snappy on the same column."""
    _, tc = tpch
    data = _column_bytes(tc.tables[table].table, column)
    ours = len(native.snappy_compress(data))
    theirs = len(pa.compress(data, codec="snappy"))
    assert ours <= 1.10 * theirs, (ours, theirs)


# --- the RLE/bit-packed hybrid -----------------------------------------------

def _hybrid_cases():
    rng = np.random.default_rng(3)
    runs = np.repeat(rng.integers(0, 1000, 400), rng.integers(1, 30, 400))
    return {
        "one_run": (np.full(1000, 7), 3),
        "short_tail_run": (np.array([1, 2, 3, 4, 5, 5, 5]), 3),
        "literals": (rng.integers(0, 1 << 13, 5000), 13),
        "runs_and_literals": (runs, 10),
        "levels": (rng.random(4099) < 0.9, 1),
        "width_32": (rng.integers(0, 1 << 32, 777, dtype=np.uint64), 32),
    }


@pytest.mark.parametrize("case", sorted(_hybrid_cases()))
def test_rle_hybrid_decodes_back(case):
    vals, width = _hybrid_cases()[case]
    vals = np.asarray(vals).astype(np.uint32)
    enc = native.rle_hybrid_encode(vals, width)
    dec, used = native.rle_bp_decode(enc, width, len(vals))
    assert used == len(enc) and np.array_equal(dec.view(np.uint32), vals)


def test_rle_hybrid_layout():
    """8 equal values from a group start make a repeated run; a run that
    starts inside a group stays bit-packed; the tail of equal values after
    no bit-packed run is a repeated run."""
    enc = native.rle_hybrid_encode(np.full(20, 5, dtype=np.uint32), 3)
    assert enc.tobytes() == bytes([20 << 1, 5])
    vals = np.array([1, 2] + [6] * 8, dtype=np.uint32)
    enc = native.rle_hybrid_encode(vals, 3).tobytes()
    assert enc[0] == (2 << 1) | 1 and len(enc) == 1 + 2 * 3
    vals = np.array([1] * 8 + [2, 3, 4], dtype=np.uint32)
    enc = native.rle_hybrid_encode(vals, 3).tobytes()
    assert enc[:2] == bytes([8 << 1, 1]) and enc[2] == (1 << 1) | 1


# --- the store's files in pyarrow --------------------------------------------

STORE_SCRIPTS = {
    "insert": (STATEMENTS[:3], None),
    "compaction": (STATEMENTS[:3] + STATEMENTS[5:8], ("t", "kv")),
    "rewrite": (STATEMENTS[3:5] + ["delete from p where s = 'a'"], None),
}


def _data_files(d) -> list:
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
                  if f.startswith("rowset_"))


@pytest.mark.parametrize("op", sorted(STORE_SCRIPTS))
def test_store_files_are_snappy_dictionary_files(tmp_path, op):
    """The port's TabletStore files read in pyarrow as SNAPPY with
    RLE_DICTIONARY on every non-BOOLEAN column (PLAIN for BOOLEAN), one
    row group, and the rows of the reference's file of the same name."""
    statements, compact = STORE_SCRIPTS[op]
    sessions = {}
    for pkg, make in (("port", lambda d: TSession(device="cpu",
                                                 data_dir=str(d))),
                      ("jax", lambda d: JSession(data_dir=str(d)))):
        s = make(tmp_path / pkg)
        for text in statements:
            s.sql(text)
        for table in compact or ():
            s.store.compact_table(table)
        sessions[pkg] = s
    ours = _data_files(tmp_path / "port")
    theirs = _data_files(tmp_path / "jax")
    assert ours and len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert os.path.basename(a) == os.path.basename(b)
        assert pq.read_table(a).to_pylist() == pq.read_table(b).to_pylist()
        meta = pq.ParquetFile(a).metadata
        assert meta.num_row_groups == 1
        rg = meta.row_group(0)
        for i in range(rg.num_columns):
            c = rg.column(i)
            assert c.compression == "SNAPPY", (a, c.path_in_schema)
            if c.physical_type == "BOOLEAN":
                assert not c.has_dictionary_page
                assert "RLE_DICTIONARY" not in c.encodings
            else:
                assert c.has_dictionary_page, (a, c.path_in_schema)
                assert "RLE_DICTIONARY" in c.encodings
            assert c.total_compressed_size <= c.total_uncompressed_size + 64


def _data_pages(path: str, column: int = 0) -> list:
    """[(encoding, values)] of one column chunk's data pages."""
    meta = pq.ParquetFile(path).metadata
    raw = open(path, "rb").read()
    out = []
    for g in range(meta.num_row_groups):
        c = meta.row_group(g).column(column)
        pos = c.dictionary_page_offset or c.data_page_offset
        end = pos + c.total_compressed_size
        while pos < end:
            th = _Thrift(raw, pos)
            ph = th.struct()
            pos = th.pos + ph[3]
            if ph[1] == 0:
                out.append((ph[5][2], ph[5][1]))
    return out


def _fallback_tables(kind: str, n: int):
    """(port table, reference table) of one column whose dictionary passes
    1 MiB: distinct values, some repeated, some NULL."""
    rng = np.random.default_rng(23)
    valid = rng.random(n) > 0.05
    if kind in ("bigint", "double"):
        a = (rng.integers(-(1 << 60), 1 << 60, n) if kind == "bigint"
             else rng.standard_normal(n))
        a[::7] = a[0]
        types = (TT.BIGINT, JT.BIGINT) if kind == "bigint" else (
            TT.DOUBLE, JT.DOUBLE)
    elif kind == "decimal38":
        a = np.zeros((n, 4), dtype=np.int64)
        a[:, 1:] = rng.integers(0, 1 << 32, (n, 3))
        a[::3, 0] = 0xFFFFFFFF  # negative values
        types = (TT.DECIMAL(38, 4), JT.DECIMAL(38, 4))
    elif kind == "hll":
        a = rng.integers(0, 7, (n, 1 << 12), dtype=np.int8)
        types = (TT.HLL(12), JT.HLL(12))
    else:  # a LIST column
        lens = rng.integers(0, 5, n)
        a = np.zeros((n, 5), dtype=np.int64)
        a[:, 0] = lens
        a[:, 1:] = rng.integers(-(1 << 62), 1 << 62, (n, 4))
        types = (TT.ARRAY(TT.BIGINT), JT.ARRAY(JT.BIGINT))
    tt = THostTable(TSchema((TField("x", types[0], True),)), {"x": a},
                    {"x": valid})
    jt = JHostTable(JSchema((JField("x", types[1], True),)), {"x": a},
                    {"x": valid})
    return tt, jt


FALLBACK_ROWS = {"bigint": 200_000, "double": 200_000, "decimal38": 90_000,
                 "hll": 2_000, "list": 100_000}


@pytest.mark.parametrize("kind", sorted(FALLBACK_ROWS))
def test_dictionary_past_1mib_falls_back_to_plain(tmp_path, kind):
    """The chunk's pages go RLE_DICTIONARY, then PLAIN from the check where
    the dictionary reached 1 MiB; pyarrow, the port's reader and the
    store's read give the rows back."""
    tt, jt = _fallback_tables(kind, FALLBACK_ROWS[kind])
    path = str(tmp_path / "f.parquet")
    write_table(tt, path)
    pages = _data_pages(path)
    encs = [e for e, _ in pages]
    k = encs.index(0)
    assert k > 0 and set(encs[:k]) == {8} and set(encs[k:]) == {0}, encs
    want = _to_arrow(jt).to_pylist()
    assert pq.read_table(path).to_pylist() == want
    got = tstore._read_parquet(path, ["x"], None, tt.schema)["x"]
    a, v = tt.arrays["x"], tt.valids["x"]
    assert np.array_equal(got[1], v)
    if kind == "list":  # lanes past a row's length are not stored
        live = (np.arange(4)[None, :] < a[:, :1]) & v[:, None]
        assert np.array_equal(got[0][:, 0][v], a[:, 0][v])
        assert np.array_equal(got[0][:, 1:5][live], a[:, 1:][live])
    else:
        assert np.array_equal(got[0][v], a[v])


def test_float_dictionary_keeps_bit_patterns(tmp_path):
    """-0.0, 0.0 and NaNs of different payloads are different dictionary
    entries and read back bit for bit."""
    bits = np.array([0x0000000000000000, 0x8000000000000000,
                     0x7FF8000000000000, 0x7FF8000000000001,
                     0xFFF8000000000002, 0x3FF0000000000000],
                    dtype=np.uint64)
    a = np.tile(bits, 50).view(np.float64)
    t = THostTable(TSchema((TField("d", TT.DOUBLE, True),
                            TField("f", TT.FLOAT, True))),
                   {"d": a, "f": a.astype(np.float32)})
    path = str(tmp_path / "f.parquet")
    write_table(t, path)
    got = ParquetFile(path).read()
    assert np.array_equal(got["d"].data.view(np.uint64), a.view(np.uint64))
    assert np.array_equal(got["f"].data.view(np.uint32),
                          a.astype(np.float32).view(np.uint32))
    back = pq.read_table(path)["d"].to_numpy().view(np.uint64)
    assert np.array_equal(back, a.view(np.uint64))
    assert pq.ParquetFile(path).metadata.row_group(0).column(0) \
        .has_dictionary_page


def test_uncompressed_directory_still_opens(tmp_path):
    """A directory the port wrote before this layout (UNCOMPRESSED, PLAIN
    numeric pages: tests/data/torch_store/uncompressed_dir) gives the
    reference's answers; an insert adds a SNAPPY file beside the old ones,
    and compaction merges both into SNAPPY, which the reference reads."""
    import json
    import shutil

    from chip_smoke import answers_agree

    store_data = os.path.join(HERE, "data", "torch_store")
    with open(os.path.join(store_data, "reference_answers.json")) as f:
        ans = json.load(f)
    d = tmp_path / "db"
    shutil.copytree(os.path.join(store_data, "uncompressed_dir"), d)

    def codecs(table):
        return {pq.ParquetFile(f).metadata.row_group(0).column(0).compression
                for f in _data_files(d / table)}

    assert codecs("kv") == {"UNCOMPRESSED"}
    ts = TSession(device="cpu", data_dir=str(d))
    for q in ("types", "partitioned", "primary_key", "altered"):
        text = ans["queries"][q]
        assert answers_agree(ts.sql(text).rows(), ans["answers"][q]), q
    ts.sql("insert into kv values (1, 'one', 1), (9, 'nine', 9)")
    assert codecs("kv") == {"UNCOMPRESSED", "SNAPPY"}
    want = ts.sql("select * from kv order by k").rows()
    ts.store.compact_table("kv")
    ts.catalog.get_table("kv").invalidate()
    assert codecs("kv") == {"SNAPPY"}
    assert ts.sql("select * from kv order by k").rows() == want
    assert JSession(data_dir=str(d)).sql(
        "select * from kv order by k").rows() == want


# --- statistics --------------------------------------------------------------

def _stats_columns():
    """{name: (port type, reference type, values, valid)}: every flat type
    pyarrow keeps min and max for, with NULLs, NaN, infinities and zeros of
    both signs."""
    rng = np.random.default_rng(31)
    n = 3000
    valid = rng.random(n) > 0.1
    f = rng.standard_normal(n) * 1e3
    f[::97] = np.nan
    f[5], f[6] = -0.0, 0.0
    zeros = np.where(np.arange(n) % 2 == 0, 0.0, -0.0)
    ints = rng.integers
    cols = {
        "ti": (TT.TINYINT, JT.TINYINT, ints(-128, 128, n, dtype=np.int8)),
        "si": (TT.SMALLINT, JT.SMALLINT,
               ints(-3e4, 3e4, n).astype(np.int16)),
        "i": (TT.INT, JT.INT, ints(-1 << 31, 1 << 31, n).astype(np.int32)),
        "bi": (TT.BIGINT, JT.BIGINT,
               ints(-1 << 63, 1 << 63, n, dtype=np.int64)),
        "dt": (TT.DATE, JT.DATE, ints(-3000, 30000, n).astype(np.int32)),
        "ts": (TT.DATETIME, JT.DATETIME,
               ints(-1 << 50, 1 << 50, n, dtype=np.int64)),
        "dec": (TT.DECIMAL(12, 2), JT.DECIMAL(12, 2),
                ints(-1e11, 1e11, n).astype(np.int64)),
        "b": (TT.BOOLEAN, JT.BOOLEAN, rng.random(n) < 0.3),
        "d": (TT.DOUBLE, JT.DOUBLE, f),
        "fl": (TT.FLOAT, JT.FLOAT, f.astype(np.float32)),
        "zeros": (TT.DOUBLE, JT.DOUBLE, zeros),
        "nan": (TT.DOUBLE, JT.DOUBLE, np.full(n, np.nan)),
        "inf": (TT.FLOAT, JT.FLOAT,
                np.where(valid, np.inf, -np.inf).astype(np.float32)),
    }
    out = {k: (t, j, a, valid) for k, (t, j, a) in cols.items()}
    out["no_nulls"] = (TT.BIGINT, JT.BIGINT, np.arange(n, dtype=np.int64),
                       None)
    out["all_null"] = (TT.INT, JT.INT, np.zeros(n, dtype=np.int32),
                       np.zeros(n, dtype=bool))
    return out


@pytest.fixture(scope="module")
def stats_files(tmp_path_factory):
    cols = _stats_columns()
    tt = THostTable(TSchema(tuple(TField(k, c[0], True)
                                  for k, c in cols.items())),
                    {k: c[2] for k, c in cols.items()},
                    {k: c[3] for k, c in cols.items()})
    jt = JHostTable(JSchema(tuple(JField(k, c[1], True)
                                  for k, c in cols.items())),
                    {k: c[2] for k, c in cols.items()},
                    {k: c[3] for k, c in cols.items() if c[3] is not None})
    d = tmp_path_factory.mktemp("stats")
    ours, theirs = str(d / "port.parquet"), str(d / "pyarrow.parquet")
    write_table(tt, ours)
    pq.write_table(_to_arrow(jt), theirs)
    return pq.ParquetFile(ours).metadata, pq.ParquetFile(theirs).metadata


@pytest.mark.parametrize("column", sorted(_stats_columns()))
def test_statistics_equal_pyarrows(stats_files, column):
    ours, theirs = (m.row_group(0).column(m.schema.names.index(column))
                    .statistics for m in stats_files)
    assert ours.null_count == theirs.null_count
    assert ours.has_min_max == theirs.has_min_max
    if theirs.has_min_max:
        for a, b in ((ours.min, theirs.min), (ours.max, theirs.max)):
            assert type(a) is type(b) and a == b
            if isinstance(a, float):
                assert np.signbit(a) == np.signbit(b)


# --- bytes at SF 0.01 --------------------------------------------------------

TPCH_TABLES = ["lineitem", "orders", "customer", "part", "partsupp",
               "supplier", "nation", "region"]


@pytest.fixture(scope="module")
def tpch_bytes(tpch, tmp_path_factory):
    """{table: (the port's bytes, pyarrow's defaults' bytes)}, one file per
    table."""
    jc, tc = tpch
    d = tmp_path_factory.mktemp("tpch")
    out = {}
    for name in TPCH_TABLES:
        ours, theirs = str(d / f"{name}.port"), str(d / f"{name}.pyarrow")
        write_table(tc.tables[name].table, ours)
        pq.write_table(_to_arrow(jc.tables[name].table), theirs)
        out[name] = (os.path.getsize(ours), os.path.getsize(theirs))
        assert pq.read_table(ours).equals(pq.read_table(theirs).cast(
            pq.read_table(ours).schema)), name
    return out


@pytest.mark.parametrize("table", TPCH_TABLES + ["total"])
def test_tpch_bytes_within_pyarrows(tpch_bytes, table):
    ours, theirs = (tpch_bytes[table] if table != "total" else
                    [sum(v[i] for v in tpch_bytes.values()) for i in (0, 1)])
    assert ours <= 1.15 * theirs, (table, ours, theirs)


# --- options and faults ------------------------------------------------------

def _orders(tpch, n=5000):
    tc = tpch[1].tables["orders"].table
    return THostTable(tc.schema, {k: v[:n] for k, v in tc.arrays.items()},
                      {k: v[:n] for k, v in tc.valids.items()})


def test_plain_uncompressed_row_groups(tmp_path, tpch):
    """codec="UNCOMPRESSED", dictionary=False and row_group_rows give
    PLAIN, uncompressed row groups; annotate_decimals types DECIMAL(p <=
    18) as pyarrow's decimal; the rows are the default file's."""
    t = _orders(tpch)
    plain, default = str(tmp_path / "plain"), str(tmp_path / "default")
    write_table(t, plain, codec="UNCOMPRESSED", dictionary=False,
                row_group_rows=1200, annotate_decimals=True)
    write_table(t, default)
    meta = pq.ParquetFile(plain).metadata
    assert meta.num_row_groups == 5
    assert [meta.row_group(g).num_rows for g in range(5)] == [1200] * 4 + [200]
    for g in range(5):
        for i in range(meta.num_columns):
            c = meta.row_group(g).column(i)
            assert c.compression == "UNCOMPRESSED"
            assert not c.has_dictionary_page
            assert set(c.encodings) == {"PLAIN", "RLE"}
    a, b = pq.read_table(plain), pq.read_table(default)
    assert str(a.schema.field("o_totalprice").type) == "decimal128(15, 2)"
    assert str(b.schema.field("o_totalprice").type) == "int64"
    assert a.drop_columns(["o_totalprice"]).equals(
        b.drop_columns(["o_totalprice"]))
    got = ParquetFile(plain).read()
    assert np.array_equal(got["o_totalprice"].data,
                          t.arrays["o_totalprice"])
    with pytest.raises(ValueError, match="codec"):
        write_table(t, plain, codec="GZIP")


def test_a_failing_compressor_raises_and_leaves_no_file(tmp_path, tpch,
                                                        monkeypatch):
    def broken(data):
        raise RuntimeError("snappy_compress: broken")

    monkeypatch.setattr(native, "snappy_compress", broken)
    path = str(tmp_path / "f.parquet")
    with pytest.raises(RuntimeError, match="broken"):
        write_table(_orders(tpch, 100), path)
    assert os.listdir(tmp_path) == []


def test_a_failing_build_raises(tmp_path, tpch, monkeypatch):
    """No compiler: the host library does not build and the write raises;
    nothing falls back to UNCOMPRESSED."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    (tmp_path / "out").mkdir()
    with pytest.raises(RuntimeError, match="build failed"):
        write_table(_orders(tpch, 100), str(tmp_path / "out" / "f.parquet"))
    assert os.listdir(tmp_path / "out") == []


def test_a_store_write_reports_compress_seconds(tmp_path, tpch):
    s = TSession(device="cpu", data_dir=str(tmp_path / "d"))
    t = _orders(tpch)
    cols = ", ".join(f"{f.name} {f.type!r}" for f in t.schema)
    s.sql(f"create table o ({cols}) distributed by hash(o_orderkey) "
          "buckets 4")
    s.catalog.register("stage", t)
    assert s.sql("insert into o select * from stage") == t.num_rows
    st = s.store.last_write_stats
    assert 0 < st["compress_s"]
    h = TSession(device="cpu", data_dir=str(tmp_path / "d")).catalog \
        .get_table("o")
    assert h.table.num_rows == t.num_rows
    split = h.load_stats
    assert split["files"] == 4 and split["decompress_s"] > 0
    assert min(split[k] for k in ("read_s", "decode_s", "concat_s")) >= 0
