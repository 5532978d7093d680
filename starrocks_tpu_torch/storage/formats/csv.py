"""CSV files in and out of HostTables.

`read_csv` is `Session.load_csv`'s reader. The reference parses a plain
file (no quote character, no reader options) with its C++ parser and
hands every other file to pyarrow's CSV reader (reference
runtime/session.py `load_csv`). The port keeps the first lane as a copy
(`native.parse_csv`) and replaces the second with its own RFC 4180 lane
(`native.parse_csv(quoted=True)`) that follows pyarrow's defaults where
the two lanes differ: a string field is never NULL, and a non-string field
is NULL when empty or spelled as one of pyarrow's null values. The port's
lanes parse into the table's declared types, where pyarrow infers types
and the reference converts them on append; reader options are pyarrow's
`ReadOptions` names (`skip_rows`, `skip_rows_after_names`, `encoding`,
and `block_size`/`use_threads`, which change nothing here).

Strings become dictionary codes in bulk (`native.dict_encode`), equal to
StringDict.from_strings over the same strings; decimals go through float64
as the reference's do.

`write_csv` is the writer of the tests and chip_smoke.py: a NULL is an
empty field and an empty string is `""`, so both survive the quoted lane.
"""

from __future__ import annotations

import numpy as np

from ... import native
from ... import types as T
from ...column import HostTable, StringDict

_READ_OPTIONS = frozenset({"skip_rows", "skip_rows_after_names", "encoding",
                           "block_size", "use_threads"})


def _lane_types(schema, quoted: bool):
    """The parser's type tag per column, or None when the reference's plain
    lane does not take the schema (its fallback then runs)."""
    tags = []
    for f in schema:
        t = f.type
        if t.is_string:
            tags.append(native.CSV_STRING)
        elif t.is_float or t.is_decimal:
            tags.append(native.CSV_FLOAT64)
        elif t.kind is T.TypeKind.DATE:
            tags.append(native.CSV_DATE)
        elif t.kind is T.TypeKind.BOOLEAN and quoted:
            tags.append(native.CSV_BOOL)
        elif t.is_integer or t.kind is T.TypeKind.BOOLEAN:
            tags.append(native.CSV_INT64)
        elif t.kind is T.TypeKind.DATETIME and quoted:
            tags.append(native.CSV_DATETIME)
        elif quoted:
            raise NotImplementedError(
                f"CSV load: column {f.name!r} of type {t} is not loadable "
                "from CSV")
        else:
            return None
    return tags


def _skip_lines(data: bytes, k: int) -> bytes:
    pos = 0
    for _ in range(k):
        nl = data.find(b"\n", pos)
        if nl < 0:
            return b""
        pos = nl + 1
    return data[pos:]


def read_csv(schema, path: str, **csv_opts) -> HostTable:
    """The rows of the CSV file at `path` as a HostTable of `schema`'s
    columns, in file order."""
    unknown = set(csv_opts) - _READ_OPTIONS
    if unknown:
        raise TypeError(f"unsupported CSV read options {sorted(unknown)}")
    with open(path, "rb") as fh:
        data = fh.read()
    enc = str(csv_opts.get("encoding", "utf8")).lower().replace("-", "")
    if enc != "utf8":
        data = data.decode(csv_opts["encoding"]).encode("utf-8")
    skip = int(csv_opts.get("skip_rows", 0)) + int(
        csv_opts.get("skip_rows_after_names", 0))
    if skip:
        data = _skip_lines(data, skip)
    res = None
    if not csv_opts and b'"' not in data:
        tags = _lane_types(schema, quoted=False)
        if tags is not None:
            res = native.parse_csv(data, tags)
    if res is None:
        tags = _lane_types(schema, quoted=True)
        res = native.parse_csv(data, tags, quoted=True)
        if res is None:
            raise ValueError(
                f"CSV load: {path!r} does not parse as {len(tags)} columns "
                "of the table's types")
    cols, masks, _n = res
    out, types, valids = {}, {}, {}
    for f, c, m in zip(schema, cols, masks):
        types[f.name] = f.type
        if f.type.is_string:
            vals, codes = native.dict_encode(*c)
            out[f.name] = (StringDict(vals), codes)
        else:
            out[f.name] = c
        if not m.all():
            if not f.nullable:
                raise ValueError(
                    f"CSV load: NULL value in NOT NULL column {f.name!r}")
            valids[f.name] = m
    ht = HostTable.from_pydict(out, types=types)
    ht.valids.update(valids)
    return ht


def write_csv(table: HostTable, path: str, delim: str = ",") -> int:
    """Write `table` as CSV (no header); returns the bytes written."""
    cols = []
    for f in table.schema:
        a = table.arrays[f.name]
        v = table.valids.get(f.name)
        t = f.type
        if t.is_string:
            vals = [s.encode() for s in f.dict.values]
            offs = np.zeros(len(vals) + 1, dtype=np.int64)
            np.cumsum([len(s) for s in vals], out=offs[1:])
            cols.append((native.CSV_FMT_STRING, a, v, (b"".join(vals), offs)))
        elif t.is_decimal and not t.is_decimal128:
            cols.append((native.CSV_FMT_DECIMAL, a, v, t.scale))
        elif t.is_float:
            cols.append((native.CSV_FMT_FLOAT64, a, v, None))
        elif t.kind is T.TypeKind.DATE:
            cols.append((native.CSV_FMT_DATE, a, v, None))
        elif t.is_integer or t.kind is T.TypeKind.BOOLEAN:
            cols.append((native.CSV_FMT_INT64, a, v, None))
        else:
            raise NotImplementedError(
                f"write_csv: column {f.name!r} of type {t}")
    text = native.format_csv(cols, table.num_rows, delim)
    with open(path, "wb") as fh:
        fh.write(text)
    return len(text)
