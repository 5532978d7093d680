"""The lake files the reference reads through pyarrow, read by the port's
own decoders (no pyarrow in the port).

The ZSTD frame decoder and the LZ4 block decoder
(csrc/host/zstd_decode.cpp, lz4_decode.cpp) against pyarrow's codecs; each
parquet encoding (DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY,
DELTA_BYTE_ARRAY, BYTE_STREAM_SPLIT), type (INT96, binary, fixed-length
binary) and LIST variant, and each ORC one (RLE v1 of file version 0.11,
the ZSTD, LZ4 and LZO codecs, TIMESTAMP, BINARY, LIST), against pyarrow's
read and the reference's `HostTable.from_arrow` of the same file (schema,
values, validity, and the same kind of error where the reference raises);
the same directories through both packages' Sessions; and files that
differ in their columns, merged as the reference's `pa.concat_tables(...,
promote_options="default")` merges them, in both orders. Tests may import
pyarrow; the port never does.
"""

from __future__ import annotations

import datetime
import decimal
import os
import struct
import sys

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from starrocks_tpu.column.host_table import HostTable as JHostTable
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu_torch import native
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.storage.external import _read_files
from starrocks_tpu_torch.storage.formats.parquet import lz4_hadoop

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "torch_formats"))
from make_lzo import orc_to_lzo  # noqa: E402


def Session(*args, **kwargs):
    kwargs.setdefault("device", "cpu")
    return _Session(*args, **kwargs)


# --- the codecs on their own -------------------------------------------------

def _inputs() -> dict:
    rng = np.random.default_rng(7)
    text = (b"the quick brown fox jumps over the lazy dog; " * 3000
            + bytes(rng.integers(97, 123, 20000).astype(np.uint8)))
    return {
        "empty": b"",
        "one_byte": b"x",
        "random": rng.integers(0, 256, 50_000).astype(np.uint8).tobytes(),
        "runs": b"a" * 70_000 + b"b" * 90_000 + b"a" * 5,
        "over_128k": (text * 3)[:400_000],
        "skewed": rng.geometric(0.3, 300_000).clip(0, 255).astype(
            np.uint8).tobytes(),
    }


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", list(_inputs()))
def test_zstd_equals_pyarrow(level, name):
    data = _inputs()[name]
    z = pa.Codec("zstd", compression_level=level).compress(data,
                                                           asbytes=True)
    want = pa.decompress(z, len(data), codec="zstd", asbytes=True)
    assert native.zstd_decompress(z, len(data)).tobytes() == want == data


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_concatenated_and_skippable_frames(level):
    """Frames back to back, a skippable frame between them, frames without
    a content size and with the XXH64 checksum (written through the
    streaming API, which sets both), and a checksum that does not match."""
    import zstandard

    ins = _inputs()
    a, b = ins["over_128k"], ins["skewed"]
    codec = pa.Codec("zstd", compression_level=level)
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    z = codec.compress(a, asbytes=True) + skip + codec.compress(b,
                                                                asbytes=True)
    assert native.zstd_decompress(z, len(a) + len(b)).tobytes() == a + b
    c = zstandard.ZstdCompressor(level=level, write_checksum=True,
                                 write_content_size=False).compressobj()
    framed = c.compress(a) + c.flush()
    assert native.zstd_decompress(framed, len(a)).tobytes() == a
    bad = bytearray(framed)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        native.zstd_decompress(bytes(bad), len(a))
    with pytest.raises(ValueError):
        native.zstd_decompress(z[:len(z) // 2], len(a) + len(b))


@pytest.mark.parametrize("name", list(_inputs()))
def test_lz4_equals_pyarrow(name):
    data = _inputs()[name]
    z = pa.compress(data, codec="lz4_raw", asbytes=True)
    want = pa.decompress(z, len(data), codec="lz4_raw", asbytes=True)
    assert native.lz4_decompress(z, len(data)).tobytes() == want == data
    # parquet's LZ4 (codec 5): Hadoop's framing, several blocks, or a
    # raw block as older writers left it
    half = len(data) // 2
    framed = b""
    for part in (data[:half], data[half:]):
        blk = pa.compress(part, codec="lz4_raw", asbytes=True)
        framed += struct.pack(">II", len(part), len(blk)) + blk
    assert lz4_hadoop(framed, len(data)).tobytes() == data
    assert lz4_hadoop(z, len(data)).tobytes() == data
    if len(data) > 1:
        with pytest.raises(ValueError):
            native.lz4_decompress(z[:-1], len(data))


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=3000), st.integers(1, 9),
       st.sampled_from([1, 3, 19]))
def test_codecs_round_trip_hypothesis(data, repeat, level):
    data = data * repeat
    z = pa.Codec("zstd", compression_level=level).compress(data,
                                                           asbytes=True)
    assert native.zstd_decompress(z, len(data)).tobytes() == data
    l4 = pa.compress(data, codec="lz4_raw", asbytes=True)
    assert native.lz4_decompress(l4, len(data)).tobytes() == data


# --- the files against pyarrow and the reference -----------------------------

N = 2000
_DAY0 = datetime.date(1995, 1, 1)


def _nulls(vals, every):
    return [None if i % every == 0 else v for i, v in enumerate(vals)]


def _flat() -> pa.Table:
    """Columns every encoding applies to, with NULLs in most."""
    rng = np.random.default_rng(5)
    words = ["lake", "lakehouse", "lakes", "laker", "", "ocean", "oceans"]
    return pa.table({
        "key": pa.array(np.arange(N) * 3 - 1000, pa.int64()),
        "i32": pa.array(_nulls(rng.integers(-2**31, 2**31 - 1, N).tolist(),
                               7), pa.int32()),
        "i64": pa.array(_nulls((rng.integers(-2**62, 2**62, N)).tolist(), 5),
                        pa.int64()),
        "wide": pa.array([(-2**63 if i % 2 else 2**63 - 1) for i in range(N)],
                         pa.int64()),
        "f32": pa.array(_nulls(rng.normal(size=N).astype(np.float32).tolist(),
                               3), pa.float32()),
        "f64": pa.array(rng.normal(size=N), pa.float64()),
        "s": pa.array(_nulls([words[v] + str(v % 3) for v in
                              rng.integers(0, 7, N)], 11)),
        "fixed": pa.array(_nulls([bytes([i % 256, (i * 7) % 256, 1, 2])
                                  for i in range(N)], 9),
                          pa.binary(4)),
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
        gd = got.schema.field(f.name).dict
        if f.dict is not None:
            assert list(gd.values) == list(f.dict.values), f.name
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        va, vb = got.valids.get(f.name), want.valids.get(f.name)
        assert (va is None) == (vb is None), f.name
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=f.name)


def _same_error(path: str, table_fn):
    """The port raises where the reference's from_arrow of pyarrow's read
    raises, with the same kind of error."""
    with pytest.raises(Exception) as want:
        JHostTable.from_arrow(table_fn())
    # Arrow's errors subclass the builtin one the port raises
    kind = next(c for c in type(want.value).__mro__
                if c.__module__ == "builtins")
    with pytest.raises(kind):
        _read_files([path])


_ENCODED = {
    "DELTA_BINARY_PACKED": ["key", "i32", "i64", "wide"],
    "DELTA_LENGTH_BYTE_ARRAY": ["s"],
    "DELTA_BYTE_ARRAY": ["s", "fixed"],
    "BYTE_STREAM_SPLIT": ["f32", "f64", "i32", "i64", "fixed"],
}


@pytest.mark.parametrize("encoding", list(_ENCODED))
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("codec", ["none", "zstd"])
def test_parquet_encodings(tmp_path, encoding, page_version, codec):
    table = _flat()
    path = str(tmp_path / "e.parquet")
    pq.write_table(table, path, use_dictionary=False,
                   column_encoding={c: encoding for c in _ENCODED[encoding]},
                   data_page_version=page_version, compression=codec,
                   row_group_size=700, data_page_size=2048)
    md = pq.ParquetFile(path).metadata
    encs = {md.row_group(0).column(i).path_in_schema:
            md.row_group(0).column(i).encodings
            for i in range(md.num_columns)}
    for c in _ENCODED[encoding]:
        assert encoding in encs[c], (c, encs[c])
    _assert_like_the_reference(path, pq.read_table(path))


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
@pytest.mark.parametrize("dictionary", [True, False])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
def test_parquet_codecs(tmp_path, codec, dictionary, page_version):
    """ZSTD and LZ4_RAW (what pyarrow writes for compression='lz4': codec
    id 7 in the footer) over several row groups and pages."""
    from starrocks_tpu_torch.storage.formats.parquet import ParquetFile

    table = _flat()
    path = str(tmp_path / "c.parquet")
    pq.write_table(table, path, compression=codec, use_dictionary=dictionary,
                   data_page_version=page_version, row_group_size=700,
                   data_page_size=2048)
    ids = {cc[3][4] for rg in ParquetFile(path).meta[4] for cc in rg[1]}
    assert ids == {6 if codec == "zstd" else 7}
    _assert_like_the_reference(path, pq.read_table(path))


def test_parquet_int96(tmp_path):
    """INT96 timestamps (pyarrow reads them as timestamp[ns]) as DATETIME
    microseconds, NULLs and dates before 1970 included; a sub-microsecond
    fraction raises as the reference's cast does."""
    base = datetime.datetime(1969, 12, 31, 23, 59, 58, 500001)
    vals = _nulls([base + datetime.timedelta(days=i * 37, microseconds=i)
                   for i in range(N)], 6)
    table = pa.table({"ts": pa.array(vals, pa.timestamp("us")),
                      "k": pa.array(range(N), pa.int32())})
    path = str(tmp_path / "i96.parquet")
    pq.write_table(table, path, use_deprecated_int96_timestamps=True)
    assert pq.ParquetFile(path).schema[0].physical_type == "INT96"
    _assert_like_the_reference(path, pq.read_table(path))
    frac = str(tmp_path / "frac.parquet")
    pq.write_table(pa.table({"ts": pa.array([0, 1_000_000_001],
                                            pa.timestamp("ns"))}), frac,
                   use_deprecated_int96_timestamps=True)
    _same_error(frac, lambda: pq.read_table(frac))
    ns = str(tmp_path / "ns.parquet")
    pq.write_table(pa.table({"ts": pa.array([7, 2_000], pa.timestamp("ns"))}),
                   ns)
    _same_error(ns, lambda: pq.read_table(ns))


@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
def test_parquet_binary(tmp_path, page_version):
    """BYTE_ARRAY without a string annotation and FLBA that is not a
    decimal become BITMAP of 8 x the longest value, NULLs invalid; a value
    of one byte fills its row; values of other lengths raise as the
    reference's row assignment does."""
    blobs = _nulls([bytes([i % 251, 3, 5]) if i % 17 else b"\x07"
                    for i in range(N)], 8)
    table = pa.table({"b": pa.array(blobs, pa.binary()),
                      "f": pa.array(_nulls([bytes(range(i % 9, i % 9 + 16))
                                            for i in range(N)], 4),
                                    pa.binary(16)),
                      "none": pa.array([None] * N, pa.binary())})
    path = str(tmp_path / "b.parquet")
    pq.write_table(table, path, data_page_version=page_version)
    _assert_like_the_reference(path, pq.read_table(path))
    mixed = str(tmp_path / "m.parquet")
    pq.write_table(pa.table({"b": [b"ab", b"abc", None]}), mixed)
    _same_error(mixed, lambda: pq.read_table(mixed))


def _lists(rng, n, make):
    out = []
    for i in range(n):
        r = rng.integers(0, 9)
        if r == 0:
            out.append(None)
        elif r == 1:
            out.append([])
        else:
            out.append([make(rng) for _ in range(int(rng.integers(1, 7)))])
    return out


def _list_table(n=N) -> pa.Table:
    rng = np.random.default_rng(9)
    return pa.table({
        "k": pa.array(range(n), pa.int64()),
        "li": pa.array(_lists(rng, n, lambda r: int(r.integers(-9, 9))),
                       pa.list_(pa.int32())),
        "ll": pa.array(_lists(rng, n, lambda r: int(r.integers(-2**40,
                                                               2**40))),
                       pa.list_(pa.int64())),
        "lf": pa.array(_lists(rng, n, lambda r: float(r.normal())),
                       pa.list_(pa.float64())),
        "ls": pa.array(_lists(rng, n, lambda r: f"w{int(r.integers(0, 40))}"),
                       pa.list_(pa.string())),
        "ld": pa.array(_lists(rng, n, lambda r: _DAY0 + datetime.timedelta(
            days=int(r.integers(0, 900)))), pa.list_(pa.date32())),
    })


@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("dictionary", [True, False])
@pytest.mark.parametrize("codec", ["snappy", "zstd"])
def test_parquet_lists(tmp_path, page_version, dictionary, codec):
    """3-level LIST columns with NULL lists and empty lists, over several
    row groups and small pages (a list's slots span pages)."""
    table = _list_table()
    path = str(tmp_path / "l.parquet")
    pq.write_table(table, path, data_page_version=page_version,
                   use_dictionary=dictionary, compression=codec,
                   row_group_size=800, data_page_size=512)
    assert pq.ParquetFile(path).metadata.num_row_groups == 3
    _assert_like_the_reference(path, pq.read_table(path))


def test_parquet_list_edge_cases(tmp_path):
    """Lists of no element at all (ARRAY<BIGINT>, as the reference infers
    it), a required element type, a file of no rows, and the errors the
    reference raises: a NULL element, ARRAY<BOOLEAN>."""
    cases = {
        "empty_only": pa.table({"a": pa.array([[], None, []],
                                              pa.list_(pa.float64()))}),
        "required": pa.table({"a": pa.array(
            [[1, 2], [3]], pa.list_(pa.field("x", pa.int64(),
                                              nullable=False)))}),
        "no_rows": pa.table({"a": pa.array([], pa.list_(pa.string()))}),
        # elements pyarrow gives as other Python objects: their str()
        "objects": pa.table({
            "dec": pa.array([[decimal.Decimal("1.50"), decimal.Decimal("-2")],
                             None, [decimal.Decimal("0.01")]],
                            pa.list_(pa.decimal128(9, 2))),
            "ts": pa.array([[datetime.datetime(1969, 7, 20, 20, 17, 40)],
                            [datetime.datetime(2020, 1, 1, 0, 0, 0, 5)], []],
                           pa.list_(pa.timestamp("us"))),
            "tsz": pa.array([[0, 1_500_000], None, [86_400_000_000]],
                            pa.list_(pa.timestamp("us", tz="UTC"))),
            "bin": pa.array([[b"ab", b"\x00"], [], None],
                            pa.list_(pa.binary()))}),
    }
    for name, table in cases.items():
        path = str(tmp_path / f"{name}.parquet")
        pq.write_table(table, path)
        _assert_like_the_reference(path, pq.read_table(path))
    for name, table in {
            "null_elem": pa.table({"a": pa.array([[1, None]],
                                                 pa.list_(pa.int64()))}),
            "bools": pa.table({"a": pa.array([[True, False]],
                                             pa.list_(pa.bool_()))})}.items():
        path = str(tmp_path / f"{name}.parquet")
        pq.write_table(table, path)
        _same_error(path, lambda p=path: pq.read_table(p))


def _orc_table(n=N) -> pa.Table:
    """Every ORC kind this slice adds, beside the flat ones."""
    rng = np.random.default_rng(11)
    t0 = datetime.datetime(1968, 5, 1, 3, 4, 5, 6)
    flat = _flat().slice(0, n)
    lists = _list_table(n)
    return pa.table({
        "key": flat.column("key"), "i32": flat.column("i32"),
        "i64": flat.column("i64"), "f64": flat.column("f64"),
        "s": flat.column("s"),
        "ts": pa.array(_nulls([t0 + datetime.timedelta(
            seconds=int(v), microseconds=int(v) % 1000 * 997)
            for v in rng.integers(0, 2 * 10**9, n)], 5), pa.timestamp("us")),
        "b": pa.array(_nulls([bytes([i % 256, 9]) for i in range(n)], 4),
                      pa.binary()),
        "d": pa.array(_nulls([_DAY0 - datetime.timedelta(days=int(v))
                              for v in rng.integers(0, 9000, n)], 7)),
        "li": lists.column("ll"), "ls": lists.column("ls"),
        "lf": lists.column("lf"),
    })


@pytest.mark.parametrize("version", ["0.11", "0.12"])
@pytest.mark.parametrize("codec", ["uncompressed", "zstd", "lz4", "zlib",
                                   "lzo"])
@pytest.mark.parametrize("dictionary", [0.0, 1.0])
def test_orc_variants(tmp_path, version, codec, dictionary):
    """File version 0.11 (integer RLE v1, strings DIRECT / DICTIONARY), the
    ZSTD, LZ4 and LZO codecs, TIMESTAMP (before 1970 too), BINARY and LIST
    columns with NULLs, several stripes. LZO files are ZLIB ones
    recompressed by tests/data/torch_formats/make_lzo.py (no writer on
    hand writes LZO), with one row group per stripe."""
    table = _orc_table()
    path = str(tmp_path / "t.orc")
    kw = {"row_index_stride": 1 << 20} if codec == "lzo" else {}
    po.write_table(table, path, file_version=version,
                   compression="zlib" if codec == "lzo" else codec,
                   dictionary_key_size_threshold=dictionary,
                   stripe_size=8192, batch_size=500, **kw)
    if codec == "lzo":
        orc_to_lzo(path, str(tmp_path / "lzo.orc"))
        path = str(tmp_path / "lzo.orc")
    assert po.ORCFile(path).file_version == version
    _assert_like_the_reference(path, po.ORCFile(path).read())


def test_orc_timestamp_fraction_and_unported_kinds(tmp_path):
    """A sub-microsecond TIMESTAMP fraction raises as the reference's cast
    does; MAP and STRUCT columns raise a named NotImplementedError."""
    frac = str(tmp_path / "f.orc")
    po.write_table(pa.table({"ts": pa.array([5_000, -1_000_000_001],
                                            pa.timestamp("ns"))}), frac)
    _same_error(frac, lambda: po.ORCFile(frac).read())
    m = str(tmp_path / "m.orc")
    po.write_table(pa.table({"m": pa.array([[("a", 1)]],
                                           pa.map_(pa.string(),
                                                   pa.int64()))}), m)
    with pytest.raises(NotImplementedError, match="MAP.*m.orc|m.orc.*MAP"):
        _read_files([m])


def test_parquet_unported_kinds_raise_named_errors(tmp_path):
    cases = {
        "STRUCT": pa.table({"s": [{"x": 1}]}),
        "MAP": pa.table({"m": pa.array([[("a", 1)]],
                                       pa.map_(pa.string(), pa.int64()))}),
        "TIME": pa.table({"t": pa.array([1], pa.time64("us"))}),
    }
    for what, table in cases.items():
        path = str(tmp_path / f"{what.lower()}.parquet")
        pq.write_table(table, path)
        with pytest.raises(NotImplementedError, match=f"{what}"):
            _read_files([path])
        with pytest.raises(NotImplementedError, match=os.path.basename(path)):
            _read_files([path])


# --- through SQL: the same directory in both packages ------------------------

def _rows_both(stmts, query):
    out = []
    for mk in (Session, JSession):
        s = mk()
        for stmt in stmts:
            s.sql(stmt)
        r = s.sql(query)
        out.append(r.rows() if hasattr(r, "rows") else r)
    return out


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_sessions_agree_on_a_lake(tmp_path, fmt):
    """ZSTD files of lists, binaries and timestamps (INT96 in parquet),
    two of them, through both packages' Sessions: the same rows."""
    table = _orc_table(600)
    d = tmp_path / "lake"
    d.mkdir()
    for i, part in enumerate((table.slice(0, 350), table.slice(350))):
        if fmt == "parquet":
            pq.write_table(part, str(d / f"p{i}.parquet"), compression="zstd",
                           use_deprecated_int96_timestamps=True,
                           data_page_version="2.0")
        else:
            po.write_table(part, str(d / f"p{i}.orc"), compression="zstd")
    create = f"create external table lake from '{d}'"
    for q in ("select * from lake order by key",
              "select count(*), sum(i64), min(ts), max(ts) from lake",
              "select s, count(*) from lake group by s order by s"):
        got, want = _rows_both([create], q)
        assert got == want, q
    assert len(got) > 1


# --- files that differ in their columns --------------------------------------

def _evolved(tmp_path, old_first: bool) -> str:
    """p0 (k BIGINT, x DOUBLE) written before an ADD COLUMN, p1 (k, x, y)
    after; `old_first` picks which file sorts first."""
    d = tmp_path / ("old_first" if old_first else "new_first")
    d.mkdir()
    old = pa.table({"k": pa.array([1, 2], pa.int64()), "x": [1.0, 2.0]})
    new = pa.table({"k": pa.array([3, 4], pa.int64()), "x": [3.0, 4.0],
                    "y": pa.array([7, 8], pa.int64())})
    a, b = ("a", "b") if old_first else ("b", "a")
    pq.write_table(old, str(d / f"{a}.parquet"))
    pq.write_table(new, str(d / f"{b}.parquet"))
    return str(d)


@pytest.mark.parametrize("old_first", [True, False])
def test_schema_evolved_lake(tmp_path, old_first):
    """A column missing from a file reads as NULL; the schema comes from
    the first file's footer until the table loads: SELECT *, DESCRIBE,
    count(*) and a select of the added column give the reference's rows,
    or the same kind of error."""
    d = _evolved(tmp_path, old_first)
    create = f"create external table lake from '{d}'"
    for q in ("select * from lake order by k", "select count(*) from lake",
              "describe lake"):
        got, want = _rows_both([create], q)
        assert got == want, q
    got, want = _rows_both([create], "select * from lake order by k")
    assert got == ([(1, 1.0, None), (2, 2.0, None), (3, 3.0, 7),
                    (4, 4.0, 8)] if not old_first
                   else [(1, 1.0), (2, 2.0), (3, 3.0), (4, 4.0)])
    # the added column: known once the merged table is loaded
    script = [create, "select count(*) from lake"]
    try:
        want = ("rows", _rows_both(script, "select k, y from lake order by k")
                [1])
    except Exception as e:  # noqa: BLE001  (the reference's outcome)
        want = ("error", type(e))
    for mk in (Session, JSession):
        s = mk()
        for stmt in script:
            s.sql(stmt)
        if want[0] == "rows":
            assert s.sql("select k, y from lake order by k").rows() == want[1]
        else:
            with pytest.raises(want[1]):
                s.sql("select k, y from lake order by k")
    assert not old_first or want[0] == "error" or want[1] == [
        (1, None), (2, None), (3, 7), (4, 8)]


def test_schema_evolved_types_must_agree(tmp_path):
    """A column whose type differs from file to file raises TypeError, as
    Arrow's concat does; so does an ORC and a parquet file that pyarrow
    reads as different types."""
    d = tmp_path / "clash"
    d.mkdir()
    pq.write_table(pa.table({"k": pa.array([1], pa.int64())}),
                   str(d / "a.parquet"))
    pq.write_table(pa.table({"k": pa.array([2], pa.int32())}),
                   str(d / "b.parquet"))
    files = sorted(str(p) for p in d.iterdir())
    with pytest.raises(TypeError):
        pa.concat_tables([pq.read_table(f) for f in files],
                         promote_options="default")
    with pytest.raises(TypeError, match="incompatible"):
        _read_files(files)


# --- the committed fixtures of the `lake` path -------------------------------

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_formats")


def _manifest() -> dict:
    import json

    with open(os.path.join(FIXTURES, "MANIFEST.json")) as fh:
        return json.load(fh)["fixtures"]


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_fixtures_match_their_manifest(name):
    """Each fixture (tests/data/torch_formats/make_fixtures.py) read by the
    port as an external table: its rows, and for each column its type,
    NULL count and digest as the manifest holds them (made with the
    reference's from_arrow)."""
    from starrocks_tpu_torch.storage.external import ExternalTableHandle
    from starrocks_tpu_torch.storage.formats import column_digest

    entry = _manifest()[name]
    h = ExternalTableHandle("lake", os.path.join(FIXTURES, name))
    assert h.row_count == entry["rows"]
    t = h.table
    assert t.num_rows == entry["rows"]
    got = []
    for f in t.schema:
        v = t.valids.get(f.name)
        got.append({"name": f.name, "type": str(f.type),
                    "nulls": 0 if v is None else int((~v).sum()),
                    "digest": column_digest(f, t.arrays[f.name], v)})
    assert got == entry["columns"]
    assert set(h.read_stats) == {"files", "decompress_s", "values_s",
                                 "decompressed_bytes", "dict_s", "wall_s"}
    assert h.read_stats["decompressed_bytes"] > 0  # all are compressed


# --- files pyarrow does not write: hand-made ---------------------------------

def _bitpacked(values, width: int) -> bytes:
    """The RLE/bit-packed hybrid as one bit-packed run (groups of 8)."""
    groups = (len(values) + 7) // 8
    bits = 0
    for i, v in enumerate(values):
        bits |= v << (i * width)
    head = (groups << 1) | 1
    return bytes([head]) + bits.to_bytes(groups * width, "little")


def test_parquet_legacy_lists(tmp_path):
    """The legacy forms of a LIST column, as older writers left them and
    as pyarrow reads them: a LIST group whose repeated field is the
    element (2-level), and a bare repeated primitive (a list of required
    elements); NULL lists and empty ones; one v1 page each."""
    from starrocks_tpu_torch.storage.formats.parquet_write import ThriftOut

    rows = 4
    # (schema elements, rep levels, def levels, max def, values)
    cols = {
        "a": ([(None, 1, b"a", 1, 3), (1, 2, b"array", None, None)],
              [0, 1, 0, 0, 0], [2, 2, 0, 1, 2], 2, [1, 2, 3]),
        "b": ([(1, 2, b"b", None, None)],
              [0, 1, 0, 0, 0], [1, 1, 0, 1, 0], 1, [4, 5, 6]),
    }
    path = str(tmp_path / "legacy.parquet")
    with open(path, "wb") as fh:
        fh.write(b"PAR1")
        pos, chunks = 4, []
        for name, (_, rep, dfn, maxd, vals) in cols.items():
            rl = _bitpacked(rep, 1)
            dl = _bitpacked(dfn, maxd.bit_length())
            body = (struct.pack("<I", len(rl)) + rl
                    + struct.pack("<I", len(dl)) + dl
                    + struct.pack(f"<{len(vals)}i", *vals))
            ph = ThriftOut()
            ph.int(1, 0)
            ph.int(2, len(body))
            ph.int(3, len(body))
            ph.begin(5)
            ph.int(1, len(rep))
            ph.int(2, 0)
            ph.int(3, 3)
            ph.int(4, 3)
            ph.end()
            ph.b.append(0)
            page = bytes(ph.b) + body
            fh.write(page)
            chunks.append((name, pos, len(page), len(rep)))
            pos += len(page)
        fm = ThriftOut()
        fm.int(1, 1)
        elems = [el for els, *_ in cols.values() for el in els]
        fm.list(2, 12, len(elems) + 1)
        fm.elem_begin()
        fm.binary(4, b"schema")
        fm.int(5, len(cols))
        fm.end()
        for phys, rep_t, nm, kids, conv in elems:
            fm.elem_begin()
            if phys is not None:
                fm.int(1, phys)
            fm.int(3, rep_t)
            fm.binary(4, nm)
            if kids is not None:
                fm.int(5, kids)
            if conv is not None:
                fm.int(6, conv)
            fm.end()
        fm.int(3, rows, 6)
        fm.list(4, 12, 1)
        fm.elem_begin()
        fm.list(1, 12, len(chunks))
        for name, off, size, nv in chunks:
            fm.elem_begin()
            fm.int(2, off, 6)
            fm.begin(3)
            fm.int(1, 1)
            fm.list(2, 5, 2)
            fm._varint(0)
            fm._varint(6)
            leaf = b"array" if name == "a" else b"b"
            path_in = [name.encode(), leaf] if name == "a" else [leaf]
            fm.list(3, 8, len(path_in))
            for p in path_in:
                fm._varint(len(p))
                fm.b += p
            fm.int(4, 0)
            fm.int(5, nv, 6)
            fm.int(6, size, 6)
            fm.int(7, size, 6)
            fm.int(9, off, 6)
            fm.end()
            fm.end()
        fm.int(2, pos - 4, 6)
        fm.int(3, rows, 6)
        fm.end()
        fm.b.append(0)
        footer = bytes(fm.b)
        fh.write(footer + struct.pack("<I", len(footer)) + b"PAR1")
    table = pq.read_table(path)
    assert table.column("a").to_pylist() == [[1, 2], None, [], [3]]
    assert table.column("b").to_pylist() == [[4, 5], [], [6], []]
    _assert_like_the_reference(path, table)


def _orc_fields(buf: bytes) -> list:
    """A protobuf message as [field, wire type, value] triples."""
    out, pos = [], 0

    def varint():
        nonlocal pos
        r = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            r |= (b & 0x7F) << shift
            if not b & 0x80:
                return r
            shift += 7

    while pos < len(buf):
        key = varint()
        f, wt = key >> 3, key & 7
        if wt == 0:
            v = varint()
        elif wt == 2:
            n = varint()
            v, pos = bytes(buf[pos:pos + n]), pos + n
        else:
            w = 8 if wt == 1 else 4
            v, pos = bytes(buf[pos:pos + w]), pos + w
        out.append([f, wt, v])
    return out


def _orc_encode(fields: list) -> bytes:
    def varint(v):
        out = bytearray()
        while True:
            out.append((v & 0x7F) | (0x80 if v >> 7 else 0))
            v >>= 7
            if not v:
                return bytes(out)

    out = b""
    for f, wt, v in fields:
        out += varint(f << 3 | wt)
        out += (varint(v) if wt == 0 else
                varint(len(v)) + v if wt == 2 else v)
    return out


def _retimezone(src: str, dst: str, tz: str):
    """An uncompressed one-stripe ORC file with its stripe's writer
    timezone set to `tz` (pyarrow always writes GMT)."""
    data = open(src, "rb").read()
    ps_len = data[-1]
    ps = _orc_fields(data[-1 - ps_len:-1])
    flen = next(v for f, _, v in ps if f == 1)
    fstart = len(data) - 1 - ps_len - flen
    footer = _orc_fields(data[fstart:fstart + flen])
    (stripe,) = [x for x in footer if x[0] == 3]
    st = _orc_fields(stripe[2])
    sd = {f: v for f, _, v in st}
    at = sd[1] + sd.get(2, 0) + sd.get(3, 0)
    sf = [x for x in _orc_fields(data[at:at + sd[4]]) if x[0] != 3]
    new_sf = _orc_encode(sf + [[3, 2, tz.encode()]])
    delta = len(new_sf) - sd[4]
    stripe[2] = _orc_encode([[f, wt, len(new_sf) if f == 4 else v]
                             for f, wt, v in st])
    footer = [[f, wt, v + delta if f == 2 else v] for f, wt, v in footer]
    new_footer = _orc_encode(footer)
    new_ps = _orc_encode([[f, wt, len(new_footer) if f == 1 else v]
                          for f, wt, v in ps])
    with open(dst, "wb") as fh:
        fh.write(data[:at] + new_sf + data[at + sd[4]:fstart] + new_footer
                 + new_ps + bytes([len(new_ps)]))


@pytest.mark.parametrize("tz", ["America/Los_Angeles", "Asia/Kolkata",
                                "Australia/Lord_Howe", "UTC"])
def test_orc_timestamps_of_a_writer_in_another_timezone(tmp_path, tz):
    """TIMESTAMP seconds count from 2015-01-01 in the stripe's writer
    timezone; pyarrow (the ORC library, a GMT reader) gives the writer's
    wall-clock time, across daylight-saving changes and before 1970."""
    rng = np.random.default_rng(2)
    base = datetime.datetime(1955, 1, 1)
    vals = [base + datetime.timedelta(seconds=int(s), microseconds=int(u))
            for s, u in zip(rng.integers(0, 80 * 365 * 86400, 3000),
                            rng.integers(0, 10**6, 3000))]
    vals += [datetime.datetime(2015, 3, 8, 2, 30),
             datetime.datetime(2015, 11, 1, 1, 59, 59, 999999),
             datetime.datetime(1969, 12, 31, 23, 59, 59, 500000), None]
    gmt = str(tmp_path / "gmt.orc")
    po.write_table(pa.table({"ts": pa.array(vals, pa.timestamp("us"))}),
                   gmt, compression="uncompressed")
    path = str(tmp_path / "tz.orc")
    _retimezone(gmt, path, tz)
    table = po.ORCFile(path).read()
    if tz == "America/Los_Angeles":  # summer times move by an hour
        assert table.column("ts").to_pylist() != \
            po.ORCFile(gmt).read().column("ts").to_pylist()
    _assert_like_the_reference(path, table)
