"""Session.load_csv in the port against the JAX package.

The reference parses a plain file with its C++ lane (native/sr_native.cpp)
and hands quoted files and reader options to pyarrow. The port keeps the
first lane as a copy (csrc/host/csv_parse.cpp) and replaces the second
with its own RFC 4180 lane; the same files through both packages' load_csv
give the same rows. The port's string dictionaries are built in bulk
(native.dict_encode) and must equal StringDict.from_strings value for
value.
"""

from __future__ import annotations

import numpy as np
import pytest

from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu_torch import native
from starrocks_tpu_torch.column import StringDict
from starrocks_tpu_torch.runtime.session import Session as _Session


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


def _both(tmp_path, ddl: str, text: str, query: str, stored=True,
          **csv_opts):
    """(port rows, reference rows, port count, reference count) of one
    file loaded into the same table by both packages."""
    csv = tmp_path / "in.csv"
    csv.write_bytes(text.encode() if isinstance(text, str) else text)
    out = []
    for mk, sub in ((Session, "port"), (JSession, "ref")):
        s = mk(data_dir=str(tmp_path / sub)) if stored else mk()
        s.sql(ddl)
        n = s.load_csv("c", str(csv), **csv_opts)
        out.append((s.sql(query).rows(), n))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def test_csv_load(tmp_path):
    """tests/test_storage.py::test_csv_load, through both packages."""
    got, want, n, m = _both(
        tmp_path, "create table c (id int, name varchar, amt double)",
        "1,foo,2.5\n2,bar,3.5\n3,foo,4.5\n",
        "select name, sum(amt) t from c group by name order by name")
    assert n == m == 3
    assert got == want == [("bar", 3.5), ("foo", 7.0)]


def test_csv_load_native_path(tmp_path):
    """tests/test_storage.py::test_csv_load_native_path: the plain lane's
    empty field is NULL."""
    got, want, n, m = _both(
        tmp_path, "create table c (id int, d date, amt double)",
        "1,2020-01-02,2.5\n2,2020-01-03,\n",
        "select id, d, amt from c order by id")
    assert n == m == 2
    assert got == want == [(1, "2020-01-02", 2.5), (2, "2020-01-03", None)]


def test_native_csv_parse_equals_the_reference():
    """tests/test_storage.py::test_native_csv_parse: the copied lane gives
    the reference's columns and masks."""
    from starrocks_tpu import native as jnative

    data = b"1,2.5,2020-01-02,hi\n2,,2021-03-04,yo\n-7,1e3,1999-12-31,\n"
    types = [native.CSV_INT64, native.CSV_FLOAT64, native.CSV_DATE,
             native.CSV_STRING]
    cols, masks, n = native.parse_csv(data, types)
    jcols, jmasks, jn = jnative.parse_csv(data, types)
    assert n == jn == 3
    for c, jc, t in zip(cols, jcols, types):
        if t == native.CSV_STRING:
            buf, offs = c
            c = [bytes(buf[s:e]).decode() for s, e in offs]
            assert c == list(jc)
        else:
            np.testing.assert_array_equal(c, jc)
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m, jm)


QUOTED = ('1,"Smith, John",12.50,2020-01-02\n'
          '2,"say ""hi""",3,2021-12-31\n'
          '3,"multi\nline",,2000-02-29\n'
          '4,plain,-0.25,\n'
          '\n'
          '5,"",1e2,1970-01-01\r\n')


@pytest.mark.parametrize("stored", [True, False])
def test_quoted_file_matches_the_reference(tmp_path, stored):
    """Quoting (embedded delimiters, doubled quotes, a line break inside a
    field), CRLF, an empty line, an empty quoted string and NULL numbers
    and dates: the port's RFC 4180 lane against the reference's pyarrow
    fallback."""
    got, want, n, m = _both(
        tmp_path,
        "create table c (id bigint, name varchar, amt decimal(10, 2), "
        "d date)", QUOTED, "select id, name, amt, d from c order by id",
        stored=stored)
    assert n == m == 5
    assert got == want
    assert got[1][1] == 'say "hi"' and got[2][1] == "multi\nline"
    assert got[4][1] == ""


ROWS = "7,café,1.5\n8,b,2.5\n"


@pytest.mark.parametrize("opts,head", [
    ({"skip_rows": 1}, "id,name,v\n"),
    ({"skip_rows": 2, "use_threads": False}, "id,name,v\n# comment\n"),
    ({"skip_rows_after_names": 1, "block_size": 1 << 20}, "id,name,v\n"),
    ({"encoding": "latin-1"}, ""),
])
def test_reader_options_match_the_reference(tmp_path, opts, head):
    """pyarrow ReadOptions names (the reference passes csv_opts to
    pyarrow's reader): skipped header rows, the encoding, and the options
    that change nothing here."""
    raw = (head + ROWS).encode(opts.get("encoding", "utf-8"))
    got, want, n, m = _both(
        tmp_path, "create table c (id int, name varchar, v double)", raw,
        "select id, name, v from c order by id", **opts)
    assert got == want == [(7, "café", 1.5), (8, "b", 2.5)]
    assert n == m == 2


def test_unknown_option_and_bad_file_raise(tmp_path):
    s = Session()
    s.sql("create table c (id int, v double)")
    p = tmp_path / "x.csv"
    p.write_text("1,2\n")
    with pytest.raises(TypeError):
        s.load_csv("c", str(p), delimiter=";")
    p.write_text('1,"2\n')  # an unterminated quote
    with pytest.raises(ValueError, match="does not parse"):
        s.load_csv("c", str(p))
    p.write_text("x,2\n")  # not an integer, in either lane
    with pytest.raises(ValueError, match="does not parse"):
        s.load_csv("c", str(p))


def test_dict_encode_equals_string_dict():
    """The bulk dictionary equals StringDict.from_strings over the same
    strings: values, order (UTF-8 byte order is code point order) and
    codes; ASCII and non-ASCII blocks, empty strings, duplicates."""
    rng = np.random.default_rng(7)
    pool = ["", "a", "b", "ab", "Z", "zeta", "été", "中文",
            "á", "x" * 60] + [f"w{i:04d}" for i in range(300)]
    strings = [pool[i] for i in rng.integers(0, len(pool), 5000)]
    enc = [s.encode() for s in strings]
    buf = np.frombuffer(b"".join(enc), dtype=np.uint8)
    ends = np.cumsum([len(e) for e in enc])
    offs = np.stack([ends - [len(e) for e in enc], ends], axis=1)
    vals, codes = native.dict_encode(buf, offs)
    d, want = StringDict.from_strings(strings)
    assert list(vals) == list(d.values)
    np.testing.assert_array_equal(codes, want)
    # a block of ASCII strings decodes in bulk, to the same str objects
    vals, codes = native.dict_encode(buf, offs[[i for i, s in enumerate(
        strings) if s.isascii()]])
    assert all(type(v) is str for v in vals)


def test_written_tpch_orders_load_back_exactly(tmp_path):
    """The writer of chip_smoke's ingest path: TPC-H orders (SF 0.01, seed
    42) written as CSV and loaded into an empty table of the same schema
    give the generated rows, every column of every row."""
    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.formats.csv import write_csv

    cat = tpch_catalog(sf=0.01)
    orders = cat.get_table("orders").table
    path = tmp_path / "orders.csv"
    write_csv(orders, str(path))
    s = Session(cat)
    cols = ", ".join(f"{f.name} {f.type}" for f in orders.schema)
    s.sql(f"create table o2 ({cols})")
    assert s.load_csv("o2", str(path)) == orders.num_rows
    q = "select * from {} order by o_orderkey"
    assert s.sql(q.format("o2")).rows() == s.sql(q.format("orders")).rows()
