"""A parquet writer without pyarrow: the TabletStore's data files.

`write_table` writes one HostTable as one parquet file, atomically (a
temporary name, then os.replace), in the layout the JAX package's store
writes through pyarrow (`_to_arrow`), so either package reads the other's
data directory: one row group, data pages v1 of up to PAGE_VALUES values,
UNCOMPRESSED, every column OPTIONAL with its definition levels (written
even where the column has no NULL, as pyarrow does). The types:

  BIGINT, INT            INT64, INT32
  SMALLINT, TINYINT      INT32 with INT(16/8, signed)
  BOOLEAN                BOOLEAN, bit-packed PLAIN
  FLOAT, DOUBLE          FLOAT, DOUBLE
  DECIMAL(p <= 18)       plain INT64, no DECIMAL annotation (the scaled
                         integers, as the reference writes them)
  DECIMAL(p > 18)        FIXED_LEN_BYTE_ARRAY(16) with DECIMAL(p, s), big-
                         endian two's complement made of the [rows, 4] limbs
  DATE                   INT32 DATE
  DATETIME               INT64 TIMESTAMP(MICROS, not adjusted to UTC)
  VARCHAR                BYTE_ARRAY STRING, RLE_DICTIONARY pages over the
                         file's own dictionary (the values its rows use,
                         sorted), the dictionary page first; a dictionary
                         past DICT_BYTES falls back to PLAIN pages
  HLL, BITMAP            BYTE_ARRAY: each row's int8 registers as bytes
  ARRAY<T>               the three-level LIST (optional group, repeated
                         `list`, optional `element`); the elements as the
                         integers or floats of T's storage, with no DATE,
                         TIMESTAMP or DECIMAL annotation, VARCHAR ones as
                         VARCHAR above; a NULL row is a null list, not an
                         empty one

NULL rows carry no value (their definition level says so). The loops over
values run in numpy and host C++ (native.bit_pack,
native.plain_byte_arrays); nothing loops per row in Python. The Thrift
compact protocol of the footer and the page headers is `ThriftOut`.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ... import native
from ... import types as T

PAGE_VALUES = 1 << 20   # values (level entries) per data page, at most
PAGE_BYTES = 1 << 27    # and PLAIN bytes per page, at most
DICT_BYTES = 1 << 30    # a dictionary page past this: PLAIN pages instead
_MAGIC = b"PAR1"
# physical types, encodings, converted types
_BOOLEAN, _INT32, _INT64, _FLOAT, _DOUBLE, _BYTE_ARRAY, _FLBA = (
    0, 1, 2, 4, 5, 6, 7)
_PLAIN, _RLE, _RLE_DICTIONARY = 0, 3, 8
_UTF8, _LIST, _DECIMAL, _DATE = 0, 3, 5, 6
_INT_8, _INT_16 = 15, 16
_OPTIONAL, _REPEATED = 1, 2


class ThriftOut:
    """Writer of the Thrift compact protocol: fields in increasing id
    order inside `begin`/`end` (a nested struct) or `elem_begin`/`end` (a
    struct in a list); the caller appends the top-level struct's stop
    byte."""

    def __init__(self):
        self.b = bytearray()
        self.last = [0]

    def _varint(self, v: int):
        while True:
            if v < 0x80:
                self.b.append(v)
                return
            self.b.append((v & 0x7F) | 0x80)
            v >>= 7

    def _field(self, fid: int, t: int):
        d = fid - self.last[-1]
        if 0 < d <= 15:
            self.b.append((d << 4) | t)
        else:
            self.b.append(t)
            self._varint((fid << 1) ^ (fid >> 63))
        self.last[-1] = fid

    def int(self, fid: int, v: int, t: int = 5):  # t 5 = i32, 6 = i64
        self._field(fid, t)
        self._varint((v << 1) ^ (v >> 63))

    def byte(self, fid: int, v: int):
        self._field(fid, 3)
        self.b.append(v & 0xFF)

    def bool(self, fid: int, v: bool):
        self._field(fid, 1 if v else 2)

    def binary(self, fid: int, v: bytes):
        self._field(fid, 8)
        self._varint(len(v))
        self.b += v

    def begin(self, fid: int):
        self._field(fid, 12)
        self.last.append(0)

    def end(self):
        self.b.append(0)
        self.last.pop()

    def list(self, fid: int, etype: int, n: int):
        self._field(fid, 9)
        if n < 15:
            self.b.append((n << 4) | etype)
        else:
            self.b.append(0xF0 | etype)
            self._varint(n)

    def elem_begin(self):
        self.last.append(0)

    def empty(self, fid: int):
        """An empty struct (a LogicalType member such as STRING)."""
        self.begin(fid)
        self.end()


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _hybrid(vals: np.ndarray, width: int) -> bytes:
    """`vals` in the RLE/bit-packed hybrid at `width` bits: one RLE run
    when every value is equal, else one bit-packed run."""
    n = len(vals)
    if n and (vals == vals[0]).all():
        return (_uvarint(n << 1)
                + int(vals[0]).to_bytes((width + 7) // 8, "little"))
    return (_uvarint(((n + 7) // 8) << 1 | 1)
            + native.bit_pack(vals, width).tobytes())


def _utf8(strings) -> tuple:
    """(buffer, (start, end) offsets) of the UTF-8 bytes of `strings`; an
    ASCII array converts in bulk, another through numpy's encoder."""
    u = np.asarray(strings, dtype=str)
    n = len(u)
    w = u.dtype.itemsize // 4
    if not n or not w:
        return (np.zeros(0, dtype=np.uint8), np.zeros((n, 2), dtype=np.int64))
    cp = u.view(np.uint32).reshape(n, w)
    if int(cp.max()) < 0x80:
        lens = np.char.str_len(u).astype(np.int64)
        buf = cp[np.arange(w)[None, :] < lens[:, None]].astype(np.uint8)
    else:
        enc = np.char.encode(u, "utf-8")
        wb = enc.dtype.itemsize
        lens = np.char.str_len(enc).astype(np.int64)
        raw = enc.view(np.uint8).reshape(n, wb)
        buf = raw[np.arange(wb)[None, :] < lens[:, None]]
    ends = np.cumsum(lens)
    return buf, np.stack([ends - lens, ends], axis=1)


def _file_dict(codes: np.ndarray, valid, d):
    """A VARCHAR column's codes re-coded against the file's own dictionary
    (the values its non-NULL rows use, sorted), and that dictionary as a
    fixed-width unicode array. NULL rows get code 0."""
    nd = 0 if d is None else len(d)
    if nd == 0 or len(codes) == 0:
        return np.zeros(len(codes), dtype=np.int32), np.zeros(0, dtype="<U1")
    codes = np.clip(np.asarray(codes, dtype=np.int64), 0, nd - 1)
    live = codes if valid is None else codes[valid]
    used = np.flatnonzero(np.bincount(live, minlength=nd))
    lut = np.zeros(nd, dtype=np.int32)
    lut[used] = np.arange(len(used), dtype=np.int32)
    out = lut[codes]
    if valid is not None:
        out[~valid] = 0
    # only the used values become text: a file holds a slice of the rows
    fdict = (np.asarray(d.values[used], dtype=str) if len(used)
             else np.zeros(0, dtype="<U1"))
    return out, fdict


class _Leaf:
    """One column as it goes into the file: its schema elements (a
    function writing each), its path, physical type and levels, the
    non-NULL values (`plain(v0, v1)` gives the PLAIN bytes of values
    [v0, v1)), and for a dictionary-encoded column the dictionary
    (`dict_plain`, `dict_n`) and each value's index (`index`)."""

    def __init__(self, schema, path, physical, defs, reps, max_def,
                 plain, width):
        self.schema = schema
        self.path = path
        self.physical = physical
        self.defs = defs
        self.reps = reps
        self.max_def = max_def
        self.plain = plain
        self.width = width        # bytes per value, for the page size
        self.dict_plain = None
        self.dict_n = 0
        self.index = None


def _element(name, physical=None, rep=_OPTIONAL, children=None,
             converted=None, logical=None, type_length=None, scale=None,
             precision=None):
    """A function writing one SchemaElement into a ThriftOut list."""
    def write(o: ThriftOut):
        o.elem_begin()
        if physical is not None:
            o.int(1, physical)
        if type_length is not None:
            o.int(2, type_length)
        o.int(3, rep)
        o.binary(4, name.encode())
        if children is not None:
            o.int(5, children)
        if converted is not None:
            o.int(6, converted)
        if scale is not None:
            o.int(7, scale)
            o.int(8, precision)
        if logical is not None:
            o.begin(10)
            logical(o)
            o.end()
        o.end()
    return write


def _fixed(vals: np.ndarray):
    """plain(v0, v1) of fixed-width little-endian values (rows of a 2-D
    byte matrix for FIXED_LEN_BYTE_ARRAY)."""
    return lambda v0, v1: np.ascontiguousarray(vals[v0:v1]).tobytes()


def _type_of(t: T.LogicalType, name: str):
    """(schema element writer args, physical, values converter, bytes per
    value) of one non-list column of type `t`. The converter takes the
    column's array (rows of non-NULL values) and gives what `_fixed`
    writes, or for BOOLEAN the bools."""
    k = t.kind
    if k is T.TypeKind.BOOLEAN:
        return {}, _BOOLEAN, lambda a: np.asarray(a, dtype=bool), 1
    if k is T.TypeKind.TINYINT or k is T.TypeKind.SMALLINT:
        bits = 8 if k is T.TypeKind.TINYINT else 16

        def integer(o, bits=bits):
            o.begin(10)
            o.byte(1, bits)
            o.bool(2, True)
            o.end()
        return ({"converted": _INT_8 if bits == 8 else _INT_16,
                 "logical": integer}, _INT32,
                lambda a: np.asarray(a).astype("<i4"), 4)
    if k in (T.TypeKind.INT, T.TypeKind.DATE):
        extra = ({"converted": _DATE, "logical": lambda o: o.empty(6)}
                 if k is T.TypeKind.DATE else {})
        return extra, _INT32, lambda a: np.asarray(a).astype("<i4"), 4
    if k is T.TypeKind.DATETIME:
        def timestamp(o):
            o.begin(8)
            o.bool(1, False)        # not adjusted to UTC
            o.begin(2)
            o.empty(2)              # MICROS
            o.end()
            o.end()
        return ({"logical": timestamp}, _INT64,
                lambda a: np.asarray(a).astype("<i8"), 8)
    if k in (T.TypeKind.BIGINT, T.TypeKind.DECIMAL):
        return {}, _INT64, lambda a: np.asarray(a).astype("<i8"), 8
    if k is T.TypeKind.FLOAT:
        return {}, _FLOAT, lambda a: np.asarray(a).astype("<f4"), 4
    if k is T.TypeKind.DOUBLE:
        return {}, _DOUBLE, lambda a: np.asarray(a).astype("<f8"), 8
    if k is T.TypeKind.DECIMAL128:
        p, s = t.precision, t.scale

        def decimal(o):
            o.begin(5)
            o.int(1, s)
            o.int(2, p)
            o.end()
        return ({"converted": _DECIMAL, "logical": decimal, "scale": s,
                 "precision": p, "type_length": 16}, _FLBA,
                lambda a: (np.asarray(a, dtype=np.int64).astype(">u4")
                           .view(np.uint8).reshape(-1, 16)), 16)
    raise NotImplementedError(f"column {name!r}: {t!r} in a parquet file")


# an ARRAY's elements go in as their storage integers or floats, with no
# DATE, TIMESTAMP or DECIMAL annotation (the reference writes
# pa.list_(pa.from_numpy_dtype(elem.np_dtype)))
_STORAGE = {np.dtype(np.int8): T.TINYINT, np.dtype(np.int16): T.SMALLINT,
            np.dtype(np.int32): T.INT, np.dtype(np.int64): T.BIGINT,
            np.dtype(np.float32): T.FLOAT, np.dtype(np.float64): T.DOUBLE}


def _flat(f, a, v) -> _Leaf:
    """A non-list column: one OPTIONAL leaf."""
    t, name = f.type, f.name
    n = len(a)
    valid = np.ones(n, dtype=bool) if v is None else np.asarray(v, bool)
    defs = valid.view(np.uint8)
    if t.is_string:
        codes, fdict = _file_dict(a, v, f.dict)
        leaf = _Leaf([_element(name, _BYTE_ARRAY, converted=_UTF8,
                               logical=lambda o: o.empty(1))],
                     [name], _BYTE_ARRAY, defs, None, 1, None, 4)
        _dictionary(leaf, _utf8(fdict), codes[valid])
        return leaf
    if t.is_hll or t.is_bitmap:
        mat = np.asarray(a, dtype=np.int8)[valid].view(np.uint8)
        m, w = mat.shape
        lens = np.full((m, 1), w, dtype="<u4").view(np.uint8)
        rows = np.concatenate([lens, mat], axis=1)
        return _Leaf([_element(name, _BYTE_ARRAY)], [name], _BYTE_ARRAY,
                     defs, None, 1, _fixed(rows), 4 + w)
    extra, phys, conv, width = _type_of(t, name)
    vals = conv(np.asarray(a)[valid])
    if phys == _BOOLEAN:
        def plain(v0, v1, vals=vals):
            return np.packbits(vals[v0:v1], bitorder="little").tobytes()
    else:
        plain = _fixed(vals)
    return _Leaf([_element(name, phys, **extra)], [name], phys, defs, None,
                 1, plain, width)


def _list(f, a, v) -> _Leaf:
    """An ARRAY column ([rows, K+1] lanes: the length, then the elements)
    as the three-level LIST: definition level 0 a NULL row, 1 an empty
    list, 3 an element; repetition level 0 a row's first entry."""
    t, name = f.type, f.name
    lanes = np.asarray(a)
    n = len(lanes)
    valid = np.ones(n, dtype=bool) if v is None else np.asarray(v, bool)
    lens = np.where(valid, lanes[:, 0].astype(np.int64), 0)
    per = np.maximum(lens, 1)
    starts = np.cumsum(per) - per
    e = int(per.sum())
    reps = np.ones(e, dtype=np.uint8)
    reps[starts] = 0
    defs = np.full(e, 3, dtype=np.uint8)
    defs[starts[lens == 0]] = np.where(valid[lens == 0], 1, 0)
    live = np.arange(lanes.shape[1] - 1)[None, :] < lens[:, None]
    elems = lanes[:, 1:][live]
    et = t.elem
    group = [_element(name, children=1, converted=_LIST,
                      logical=lambda o: o.empty(3)),
             _element("list", rep=_REPEATED, children=1)]
    path = [name, "list", "element"]
    if et.is_string:
        codes, fdict = _file_dict(elems, None, f.dict)
        leaf = _Leaf(group + [_element("element", _BYTE_ARRAY,
                                       converted=_UTF8,
                                       logical=lambda o: o.empty(1))],
                     path, _BYTE_ARRAY, defs, reps, 3, None, 4)
        _dictionary(leaf, _utf8(fdict), codes)
        return leaf
    extra, phys, conv, width = _type_of(_STORAGE[np.dtype(et.np_dtype)],
                                        name)
    return _Leaf(group + [_element("element", phys, **extra)], path, phys,
                 defs, reps, 3, _fixed(conv(elems)), width)


def _dictionary(leaf: _Leaf, strings: tuple, index: np.ndarray):
    """Dictionary-encode a BYTE_ARRAY leaf: the dictionary page's PLAIN
    values and each value's index; past DICT_BYTES, PLAIN values
    instead."""
    buf, offs = strings
    nd = len(offs)
    rows = np.arange(nd, dtype=np.int64)
    if len(buf) + 4 * nd <= DICT_BYTES:
        leaf.dict_plain = native.plain_byte_arrays(buf, offs, rows)
        leaf.dict_n = nd
        leaf.index = np.asarray(index, dtype=np.uint32)
        return
    index = np.asarray(index, dtype=np.int64)
    lens = offs[:, 1] - offs[:, 0]
    leaf.width = 4 + int(lens.max(initial=0))
    leaf.plain = lambda v0, v1: native.plain_byte_arrays(
        buf, offs, index[v0:v1]).tobytes()


def _page_bounds(leaf: _Leaf) -> list:
    """[(first entry, end entry, first value, end value)] of each data
    page: at most PAGE_VALUES entries and PAGE_BYTES of values, a list
    column's pages starting at its rows' first entries."""
    e = len(leaf.defs)
    width = 4 if leaf.index is not None else leaf.width
    step = max(1, min(PAGE_VALUES, PAGE_BYTES // max(width, 1)))
    cand = np.arange(0, e, step, dtype=np.int64)
    if leaf.reps is not None:
        rs = np.flatnonzero(leaf.reps == 0)
        cand = np.unique(rs[np.minimum(np.searchsorted(rs, cand),
                                       len(rs) - 1)])
    bounds = np.append(cand, e).tolist()
    out, v0 = [], 0
    for e0, e1 in zip(bounds[:-1], bounds[1:]):
        v1 = v0 + int(np.count_nonzero(leaf.defs[e0:e1] == leaf.max_def))
        out.append((e0, e1, v0, v1))
        v0 = v1
    return out


def _levels(vals: np.ndarray, max_level: int) -> bytes:
    h = _hybrid(vals, max_level.bit_length())
    return struct.pack("<I", len(h)) + h


def _page_header(ptype: int, size: int, nvals: int, enc: int) -> bytes:
    ph = ThriftOut()
    ph.int(1, ptype)
    ph.int(2, size)
    ph.int(3, size)
    if ptype == 2:   # DICTIONARY_PAGE
        ph.begin(7)
        ph.int(1, nvals)
        ph.int(2, _PLAIN)
        ph.end()
    else:
        ph.begin(5)
        ph.int(1, nvals)
        ph.int(2, enc)
        ph.int(3, _RLE)
        ph.int(4, _RLE)
        ph.end()
    ph.b.append(0)
    return bytes(ph.b)


def _write_chunk(fh, pos: int, leaf: _Leaf) -> dict:
    """Write one column chunk's pages at file offset `pos`; its
    ColumnMetaData fields."""
    start = pos
    dict_off = None
    if leaf.index is not None:
        body = leaf.dict_plain.tobytes()
        page = _page_header(2, len(body), leaf.dict_n, _PLAIN) + body
        fh.write(page)
        dict_off = pos
        pos += len(page)
        width = max(1, (leaf.dict_n - 1).bit_length())
    data_off = pos
    for e0, e1, v0, v1 in _page_bounds(leaf):
        parts = []
        if leaf.reps is not None:
            parts.append(_levels(leaf.reps[e0:e1], 1))
        parts.append(_levels(leaf.defs[e0:e1], leaf.max_def))
        if leaf.index is not None:
            parts.append(bytes([width]))
            if v1 > v0:
                parts.append(_hybrid(leaf.index[v0:v1], width))
            enc = _RLE_DICTIONARY
        else:
            parts.append(leaf.plain(v0, v1))
            enc = _PLAIN
        body = b"".join(parts)
        page = _page_header(0, len(body), e1 - e0, enc) + body
        fh.write(page)
        pos += len(page)
    encodings = ([_PLAIN, _RLE, _RLE_DICTIONARY] if leaf.index is not None
                 else [_PLAIN, _RLE])
    return {"start": start, "size": pos - start, "data_off": data_off,
            "dict_off": dict_off, "encodings": encodings,
            "nvals": len(leaf.defs)}


def _footer(leaves: list, chunks: list, n: int) -> bytes:
    fm = ThriftOut()
    fm.int(1, 2)  # version
    elems = sum(len(lf.schema) for lf in leaves) + 1
    fm.list(2, 12, elems)
    fm.elem_begin()
    fm.binary(4, b"schema")
    fm.int(5, len(leaves))
    fm.end()
    for lf in leaves:
        for write in lf.schema:
            write(fm)
    fm.int(3, n, 6)
    fm.list(4, 12, 1 if chunks else 0)
    if chunks:
        fm.elem_begin()
        fm.list(1, 12, len(chunks))
        for lf, c in zip(leaves, chunks):
            fm.elem_begin()
            fm.int(2, c["start"], 6)
            fm.begin(3)  # ColumnMetaData
            fm.int(1, lf.physical)
            fm.list(2, 5, len(c["encodings"]))
            for enc in c["encodings"]:
                fm._varint(enc << 1)
            fm.list(3, 8, len(lf.path))
            for p in lf.path:
                fm._varint(len(p.encode()))
                fm.b += p.encode()
            fm.int(4, 0)  # UNCOMPRESSED
            fm.int(5, c["nvals"], 6)
            fm.int(6, c["size"], 6)
            fm.int(7, c["size"], 6)
            fm.int(9, c["data_off"], 6)
            if c["dict_off"] is not None:
                fm.int(11, c["dict_off"], 6)
            fm.end()
            fm.end()
        total = sum(c["size"] for c in chunks)
        fm.int(2, total, 6)
        fm.int(3, n, 6)
        fm.int(6, total, 6)  # total_compressed_size
        fm.end()
    fm.binary(6, b"starrocks_tpu_torch")
    fm.b.append(0)
    return bytes(fm.b)


def write_table(data, path: str) -> int:
    """Write HostTable `data` as one parquet file at `path`, atomically;
    returns the file's bytes."""
    leaves = []
    for f in data.schema:
        a = data.arrays[f.name]
        v = data.valids.get(f.name)
        if v is not None and np.asarray(v).all():
            v = None
        leaves.append(_list(f, a, v) if f.type.is_array else _flat(f, a, v))
    n = data.num_rows
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(_MAGIC)
        pos = len(_MAGIC)
        chunks = []
        if n:
            for lf in leaves:
                c = _write_chunk(fh, pos, lf)
                pos += c["size"]
                chunks.append(c)
        footer = _footer(leaves, chunks, n)
        fh.write(footer + struct.pack("<I", len(footer)) + _MAGIC)
        size = pos + len(footer) + 8
    os.replace(tmp, path)
    return size
