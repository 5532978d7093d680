"""File formats the port reads and writes without pyarrow: CSV
(`Session.load_csv`), parquet and ORC (the external tables of
storage/external.py), and parquet as the TabletStore's data files
(parquet_write.py writes them; parquet.py reads them and the reference's).
Footers and page headers parse in Python; the loops over values run in
host C++ (csrc/host/csv_parse.cpp, csrc/host/file_formats.cpp, through
native.py)."""

from __future__ import annotations

import hashlib

import numpy as np


class Column:
    """One column of one file as a reader decodes it: `data` is a numpy
    array with a row per value, for a string or binary column (buffer,
    offsets) with one (start, end) pair per row (or a Coded, where the
    reader was asked for codes), or for a LIST column a Lists; `valid` is
    a bool mask, or None when the column has no NULL. A NULL row holds 0
    (strings: "", lists: no element)."""

    __slots__ = ("data", "valid")

    def __init__(self, data, valid=None):
        self.data = data
        self.valid = valid


class Coded:
    """String values as indices into a dictionary (a parquet column chunk
    whose pages are all dictionary-encoded, read with `codes=True`):
    `strings` is the dictionary as (buffer, offsets), `codes` the int32
    index of each value (0 in a NULL row)."""

    __slots__ = ("strings", "codes")

    def __init__(self, strings, codes):
        self.strings = strings
        self.codes = codes

    def decoded(self) -> tuple:
        """The values as (buffer, offsets), one (start, end) per row."""
        buf, offs = self.strings
        if not len(offs):
            return buf, np.zeros((len(self.codes), 2), dtype=np.int64)
        return buf, offs[self.codes]


class Lists:
    """The rows of a LIST column: `lengths` (int64, one per row) and
    `elems`, the Column of every element in row order (no NULL: a NULL
    element raises when it is decoded, as the reference's ARRAY builder
    does)."""

    __slots__ = ("lengths", "elems")

    def __init__(self, lengths, elems):
        self.lengths = lengths
        self.elems = elems


class Spec:
    """One top-level column of a file as its footer describes it: `type`
    is what the reference's `from_arrow` makes of an empty table of the
    file's schema (a LIST column ARRAY<BIGINT>, a binary one BITMAP(8));
    `key` names the Arrow type pyarrow reads it as, which must agree from
    file to file; `build` is how the HostTable column is made of the
    decoded Column ("value", "string", "binary" -> BITMAP, "list" ->
    ARRAY); for a list, `elem` is ("value" | "string" | "binary" | "date" |
    "timestamp" | "timestamp_tz" | "decimal", the element's LogicalType as
    decoded)."""

    __slots__ = ("name", "type", "key", "build", "elem")

    def __init__(self, name, type, key, build="value", elem=None):
        self.name = name
        self.type = type
        self.key = key
        self.build = build
        self.elem = elem


def decimal_from_be(raw: np.ndarray, precision: int) -> np.ndarray:
    """Big-endian two's complement integers, one per row of the uint8
    matrix `raw`, as scaled int64 (precision <= 18) or as 4 x 32-bit limbs
    most significant first (host_table._int_to_dec128's layout)."""
    n, w = raw.shape
    width = 8 if precision <= 18 else 16
    if w > width:
        raw = raw[:, w - width:]
        w = width
    ext = np.zeros((n, width), dtype=np.uint8)
    if n:
        neg = (raw[:, 0] & 0x80) != 0 if w else np.zeros(n, dtype=bool)
        ext[neg, :width - w] = 0xFF
        ext[:, width - w:] = raw
    if width == 8:
        return ext.view(">i8").ravel().astype(np.int64)
    return ext.view(">u4").reshape(n, 4).astype(np.int64)


def decimal_from_ints(v: np.ndarray, precision: int) -> np.ndarray:
    """Unscaled integers (INT32/INT64 storage) in the in-memory layout of
    a DECIMAL of `precision`."""
    v = np.asarray(v, dtype=np.int64)
    if precision <= 18:
        return v
    be = v.astype(">i8").view(np.uint8).reshape(-1, 8)
    return decimal_from_be(be, precision)


def concat(parts: list) -> Column:
    """The Columns of one column in several files, as one Column."""
    if len(parts) == 1:
        return parts[0]
    coded = [isinstance(p.data, Coded) for p in parts]
    if all(coded):
        # one dictionary: the parts' dictionaries one after another, each
        # once (the pages of a column chunk share theirs)
        bufs, offs, codes, base, nd, seen = [], [], [], 0, 0, {}
        for p in parts:
            if id(p.data.strings) not in seen:
                b, o = p.data.strings
                seen[id(p.data.strings)] = nd
                bufs.append(b)
                offs.append(o + base)
                base += len(b)
                nd += len(o)
            codes.append(p.data.codes + seen[id(p.data.strings)])
        data = Coded((np.concatenate(bufs), np.concatenate(offs)),
                     np.concatenate(codes).astype(np.int32))
        return Column(data, _valid(parts))
    if any(coded):
        parts = [Column(p.data.decoded(), p.valid) if c else p
                 for p, c in zip(parts, coded)]
    if isinstance(parts[0].data, Lists):
        data = Lists(np.concatenate([p.data.lengths for p in parts]),
                     concat([p.data.elems for p in parts]))
    elif isinstance(parts[0].data, tuple):
        # pages decoded through one dictionary share its buffer: keep it once
        bufs, offs, base, seen = [], [], 0, {}
        for p in parts:
            b, o = p.data
            if id(b) not in seen:
                seen[id(b)] = base
                bufs.append(b)
                base += len(b)
            offs.append(o + seen[id(b)])
        data = (np.concatenate(bufs), np.concatenate(offs))
    else:
        data = np.concatenate([p.data for p in parts])
    return Column(data, _valid(parts))


def _valid(parts: list):
    if all(p.valid is None for p in parts):
        return None
    return np.concatenate([
        p.valid if p.valid is not None else np.ones(_rows(p), dtype=bool)
        for p in parts])


def _rows(c: Column) -> int:
    if isinstance(c.data, Lists):
        return len(c.data.lengths)
    if isinstance(c.data, Coded):
        return len(c.data.codes)
    return len(c.data[1]) if isinstance(c.data, tuple) else len(c.data)


def null_like(c: Column, n: int) -> Column:
    """`n` NULL rows in the layout of Column `c` (a column a file lacks)."""
    valid = np.zeros(n, dtype=bool)
    d = c.data
    if isinstance(d, Lists):
        return Column(Lists(np.zeros(n, dtype=np.int64),
                            null_like(d.elems, 0)), valid)
    if isinstance(d, tuple):
        return Column((d[0][:0], np.zeros((n, 2), dtype=np.int64)), valid)
    return Column(np.zeros((n,) + d.shape[1:], dtype=d.dtype), valid)


def empty_column(lt) -> Column:
    """A Column of no rows of LogicalType `lt`."""
    if lt.is_string:
        return Column((np.zeros(0, dtype=np.uint8),
                       np.zeros((0, 2), dtype=np.int64)))
    if lt.is_decimal128:
        return Column(np.zeros((0, 4), dtype=np.int64))
    return Column(np.zeros(0, dtype=lt.np_dtype))


def column_digest(field, array, valid) -> str:
    """sha256 of one HostTable column as the lake fixtures' manifests hold
    it (tests/data/torch_formats/): its type, its validity (all true when
    `valid` is None), its values with NULL rows zeroed, and the strings of
    its dictionary. Equal columns of the reference's `from_arrow` and of
    the port's readers give equal digests."""
    h = hashlib.sha256(str(field.type).encode())
    a = np.ascontiguousarray(array)
    v = (np.ones(len(a), dtype=bool) if valid is None
         else np.asarray(valid, dtype=bool))
    h.update(np.packbits(v).tobytes())
    if not v.all():
        a = a.copy()
        a[~v] = 0
    h.update(a.dtype.str.encode())
    h.update(a.tobytes())
    if field.dict is not None:
        h.update("\0".join(str(x) for x in field.dict.values).encode())
    return h.hexdigest()
