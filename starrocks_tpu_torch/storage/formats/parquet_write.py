"""A parquet writer without pyarrow: the TabletStore's data files.

`write_table` writes one HostTable as one parquet file, atomically (a
temporary name, then os.replace), in the layout the JAX package's store
writes through pyarrow's defaults (`pq.write_table` of `_to_arrow`), so
either package reads the other's data directory and the files are about as
large:

- row groups of at most ROW_GROUP_ROWS rows;
- in each column chunk but a BOOLEAN one, a dictionary page (PLAIN values
  in order of first appearance) and RLE_DICTIONARY data pages; once the
  dictionary's PLAIN bytes reach DICT_PAGE_BYTES at a check (every
  DICT_CHECK values, pyarrow's write batch), the page in hand ends and the
  chunk's remaining values go to PLAIN pages;
- data pages v1 of about PAGE_BYTES of encoded values (and at most
  PAGE_VALUES level entries), levels and dictionary indices in the
  RLE/bit-packed hybrid (repeated runs wherever a group of 8 starts 8 or
  more equal values);
- SNAPPY pages (the whole v1 body, levels included; native.snappy_compress);
- Statistics: the null count of every flat column, and the min and max of
  the integer, date, timestamp, floating and boolean ones (NaN left out,
  a zero minimum as -0.0 and a zero maximum as +0.0), as pyarrow writes
  them;
- every column OPTIONAL with its definition levels (written even where the
  column has no NULL, as pyarrow does).

One difference from pyarrow's layout, on purpose: a VARCHAR chunk's
dictionary is the values the chunk uses, sorted (pyarrow's: in order of
first appearance), and it stays a dictionary up to DICT_BYTES (pyarrow's:
1 MiB). The store's first load merges the files' sorted dictionaries
(store._concat_parts) instead of hashing strings.

The options mirror pyarrow's `write_table`: `codec` ("SNAPPY" or
"UNCOMPRESSED"), `dictionary` (False: PLAIN pages for every column,
VARCHAR too) and `row_group_rows`. `annotate_decimals` writes DECIMAL(p
<= 18) as INT64 annotated DECIMAL(p, s), as pyarrow writes a decimal
column stored as integers, for files whose readers take the types from the
files (external tables); the store's files carry the scaled integers
unannotated, as the reference's do. The types:

  BIGINT, INT            INT64, INT32
  SMALLINT, TINYINT      INT32 with INT(16/8, signed)
  BOOLEAN                BOOLEAN, bit-packed PLAIN
  FLOAT, DOUBLE          FLOAT, DOUBLE (dictionaries keyed by bit pattern:
                         -0.0, 0.0 and each NaN payload stay apart)
  DECIMAL(p <= 18)       plain INT64, no DECIMAL annotation (the scaled
                         integers, as the reference writes them)
  DECIMAL(p > 18)        FIXED_LEN_BYTE_ARRAY(16) with DECIMAL(p, s), big-
                         endian two's complement made of the [rows, 4] limbs
  DATE                   INT32 DATE
  DATETIME               INT64 TIMESTAMP(MICROS, not adjusted to UTC)
  VARCHAR                BYTE_ARRAY STRING over the chunk's sorted
                         dictionary; past DICT_BYTES, PLAIN pages
  HLL, BITMAP            BYTE_ARRAY: each row's int8 registers as bytes
  ARRAY<T>               the three-level LIST (optional group, repeated
                         `list`, optional `element`); the elements as the
                         integers or floats of T's storage, with no DATE,
                         TIMESTAMP or DECIMAL annotation, VARCHAR ones as
                         VARCHAR above; a NULL row is a null list, not an
                         empty one

NULL rows carry no value (their definition level says so). The loops over
values run in numpy and host C++ (native.dict_encode_fixed,
native.rle_hybrid_encode, native.plain_byte_arrays,
native.snappy_compress); nothing loops per row in Python. The Thrift
compact protocol of the footer and the page headers is `ThriftOut`.
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np

from ... import native
from ... import types as T

ROW_GROUP_ROWS = 1 << 20  # rows per row group, at most
PAGE_BYTES = 1 << 20      # encoded value bytes per data page, about
PAGE_VALUES = 1 << 20     # level entries per data page, at most
DICT_PAGE_BYTES = 1 << 20  # a dictionary this large at a check: PLAIN next
DICT_CHECK = 1024         # values between those checks
DICT_BYTES = 1 << 30      # a VARCHAR dictionary page past this: PLAIN pages
_CODECS = {"UNCOMPRESSED": 0, "SNAPPY": 1}
_MAGIC = b"PAR1"
# physical types, encodings, converted types
_BOOLEAN, _INT32, _INT64, _FLOAT, _DOUBLE, _BYTE_ARRAY, _FLBA = (
    0, 1, 2, 4, 5, 6, 7)
_PLAIN, _RLE, _RLE_DICTIONARY = 0, 3, 8
_UTF8, _LIST, _DECIMAL, _DATE = 0, 3, 5, 6
_INT_8, _INT_16 = 15, 16
_OPTIONAL, _REPEATED = 1, 2
_DATA_PAGE, _DICTIONARY_PAGE = 0, 2


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


def _levels(vals: np.ndarray, max_level: int):
    h = native.rle_hybrid_encode(vals, max_level.bit_length())
    return struct.pack("<I", len(h)) + h.tobytes()


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
    """A VARCHAR column's codes re-coded against the chunk's own dictionary
    (the values its non-NULL rows use, sorted), and that dictionary as a
    fixed-width unicode array. NULL rows get code 0."""
    nd = 0 if d is None else len(d)
    if nd == 0 or len(codes) == 0:
        return np.zeros(len(codes), dtype=np.int32), np.zeros(0, dtype="<U1")
    codes = np.asarray(codes)
    if codes.min() < 0 or codes.max() >= nd:
        codes = np.clip(codes, 0, nd - 1)
    live = codes if valid is None else codes[valid]
    used = np.flatnonzero(np.bincount(live, minlength=nd))
    lut = np.zeros(nd, dtype=np.int32)
    lut[used] = np.arange(len(used), dtype=np.int32)
    out = lut[codes]
    if valid is not None:
        out[~valid] = 0
    # only the used values become text: a chunk holds a slice of the rows
    fdict = (np.asarray(d.values[used], dtype=str) if len(used)
             else np.zeros(0, dtype="<U1"))
    return out, fdict


class _Leaf:
    """One column chunk as it goes into the file: its schema elements (a
    function writing each), its path, physical type and levels; the
    non-NULL values as PLAIN bytes (`plain(v0, v1)` gives values [v0,
    v1)), each value's PLAIN bytes for the page size (`vbytes`, or for
    strings `ends`, the PLAIN bytes through each value); for a dictionary-
    encoded chunk the dictionary page's values (`dict_plain`, `dict_n`) and
    the index of each of the first `n_enc` values (`index`); and its
    Statistics (`stats`: null count, min and max PLAIN bytes or None), or
    None for a LIST chunk."""

    def __init__(self, schema, path, physical, defs, reps, max_def,
                 plain, vbytes):
        self.schema = schema
        self.path = path
        self.physical = physical
        self.defs = defs
        self.reps = reps
        self.max_def = max_def
        self.plain = plain
        self.vbytes = vbytes
        self.ends = None
        self.dict_plain = None
        self.dict_n = 0
        self.index = None
        self.n_enc = 0
        self.stats = None


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
    return lambda v0, v1: np.ascontiguousarray(vals[v0:v1]).view(np.uint8)


def _decimal(p: int, s: int):
    def logical(o):
        o.begin(5)
        o.int(1, s)
        o.int(2, p)
        o.end()
    return {"converted": _DECIMAL, "logical": logical, "scale": s,
            "precision": p}


def _type_of(t: T.LogicalType, name: str, annotate_decimals: bool = False):
    """(schema element writer args, physical, values converter, bytes per
    value) of one non-list column of type `t`. The converter takes the
    column's array (rows of non-NULL values) and gives what `_fixed`
    writes, or for BOOLEAN the bools."""
    k = t.kind
    if k is T.TypeKind.BOOLEAN:
        return {}, _BOOLEAN, lambda a: np.asarray(a, dtype=bool), 1 / 8
    if k is T.TypeKind.TINYINT or k is T.TypeKind.SMALLINT:
        bits = 8 if k is T.TypeKind.TINYINT else 16

        def integer(o, bits=bits):
            o.begin(10)
            o.byte(1, bits)
            o.bool(2, True)
            o.end()
        return ({"converted": _INT_8 if bits == 8 else _INT_16,
                 "logical": integer}, _INT32,
                lambda a: np.asarray(a).astype("<i4", copy=False), 4)
    if k in (T.TypeKind.INT, T.TypeKind.DATE):
        extra = ({"converted": _DATE, "logical": lambda o: o.empty(6)}
                 if k is T.TypeKind.DATE else {})
        return (extra, _INT32,
                lambda a: np.asarray(a).astype("<i4", copy=False), 4)
    if k is T.TypeKind.DATETIME:
        def timestamp(o):
            o.begin(8)
            o.bool(1, False)        # not adjusted to UTC
            o.begin(2)
            o.empty(2)              # MICROS
            o.end()
            o.end()
        return ({"logical": timestamp}, _INT64,
                lambda a: np.asarray(a).astype("<i8", copy=False), 8)
    if k in (T.TypeKind.BIGINT, T.TypeKind.DECIMAL):
        extra = (_decimal(t.precision, t.scale)
                 if k is T.TypeKind.DECIMAL and annotate_decimals else {})
        return (extra, _INT64,
                lambda a: np.asarray(a).astype("<i8", copy=False), 8)
    if k is T.TypeKind.FLOAT:
        return ({}, _FLOAT,
                lambda a: np.asarray(a).astype("<f4", copy=False), 4)
    if k is T.TypeKind.DOUBLE:
        return ({}, _DOUBLE,
                lambda a: np.asarray(a).astype("<f8", copy=False), 8)
    if k is T.TypeKind.DECIMAL128:
        return ({**_decimal(t.precision, t.scale), "type_length": 16}, _FLBA,
                lambda a: (np.asarray(a, dtype=np.int64).astype(">u4")
                           .view(np.uint8).reshape(-1, 16)), 16)
    raise NotImplementedError(f"column {name!r}: {t!r} in a parquet file")


# an ARRAY's elements go in as their storage integers or floats, with no
# DATE, TIMESTAMP or DECIMAL annotation (the reference writes
# pa.list_(pa.from_numpy_dtype(elem.np_dtype)))
_STORAGE = {np.dtype(np.int8): T.TINYINT, np.dtype(np.int16): T.SMALLINT,
            np.dtype(np.int32): T.INT, np.dtype(np.int64): T.BIGINT,
            np.dtype(np.float32): T.FLOAT, np.dtype(np.float64): T.DOUBLE}


def _min_max(vals: np.ndarray):
    """(min, max) PLAIN bytes of non-NULL values as pyarrow's statistics
    hold them (NaN left out, a zero minimum -0.0 and a zero maximum +0.0),
    or None when no value counts."""
    if vals.dtype.kind == "f":
        vals = vals[~np.isnan(vals)]
    if not len(vals):
        return None
    lo, hi = vals.min(), vals.max()
    if vals.dtype.kind == "f":
        lo = -abs(lo) if lo == 0 else lo
        hi = abs(hi) if hi == 0 else hi
    return (np.asarray(lo, dtype=vals.dtype).tobytes(),
            np.asarray(hi, dtype=vals.dtype).tobytes())


def _flat(f, a, v, dictionary: bool, annotate_decimals: bool) -> _Leaf:
    """A non-list column: one OPTIONAL leaf."""
    t, name = f.type, f.name
    n = len(a)
    valid = np.ones(n, dtype=bool) if v is None else np.asarray(v, bool)
    defs = valid.view(np.uint8)
    nulls = n - int(np.count_nonzero(valid))
    if t.is_string:
        codes, fdict = _file_dict(a, v, f.dict)
        leaf = _Leaf([_element(name, _BYTE_ARRAY, converted=_UTF8,
                               logical=lambda o: o.empty(1))],
                     [name], _BYTE_ARRAY, defs, None, 1, None, 4)
        _strings(leaf, _utf8(fdict), codes[valid], dictionary)
        leaf.stats = (nulls, None)
        return leaf
    if t.is_hll or t.is_bitmap:
        mat = np.asarray(a, dtype=np.int8)[valid].view(np.uint8)
        m, w = mat.shape
        lens = np.full((m, 1), w, dtype="<u4").view(np.uint8)
        rows = np.concatenate([lens, mat], axis=1)
        leaf = _Leaf([_element(name, _BYTE_ARRAY)], [name], _BYTE_ARRAY,
                     defs, None, 1, _fixed(rows), 4 + w)
        if dictionary:
            _dict_fixed(leaf, mat, 4 + w, rows)
        leaf.stats = (nulls, None)
        return leaf
    extra, phys, conv, width = _type_of(t, name, annotate_decimals)
    vals = conv(np.asarray(a) if v is None else np.asarray(a)[valid])
    if phys == _BOOLEAN:
        def plain(v0, v1, vals=vals):
            return np.packbits(vals[v0:v1], bitorder="little")
    else:
        plain = _fixed(vals)
    leaf = _Leaf([_element(name, phys, **extra)], [name], phys, defs, None,
                 1, plain, width)
    if dictionary and phys != _BOOLEAN:
        _dict_fixed(leaf, vals, width, vals)
    leaf.stats = (nulls, None if phys == _FLBA else _min_max(vals))
    return leaf


def _list(f, a, v, dictionary: bool) -> _Leaf:
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
        _strings(leaf, _utf8(fdict), codes, dictionary)
        return leaf
    extra, phys, conv, width = _type_of(_STORAGE[np.dtype(et.np_dtype)],
                                        name)
    vals = conv(elems)
    leaf = _Leaf(group + [_element("element", phys, **extra)], path, phys,
                 defs, reps, 3, _fixed(vals), width)
    if dictionary:
        _dict_fixed(leaf, vals, width, vals)
    return leaf


def _strings(leaf: _Leaf, strings: tuple, index: np.ndarray,
             dictionary: bool):
    """A VARCHAR leaf's values: over its sorted dictionary `strings`, or
    PLAIN (without `dictionary`, or past DICT_BYTES)."""
    buf, offs = strings
    nd = len(offs)
    rows = np.arange(nd, dtype=np.int64)
    if dictionary and len(buf) + 4 * nd <= DICT_BYTES:
        leaf.dict_plain = native.plain_byte_arrays(buf, offs, rows)
        leaf.dict_n = nd
        leaf.index = np.asarray(index, dtype=np.uint32)
        leaf.n_enc = len(index)
        return
    index = np.asarray(index, dtype=np.int64)
    lens = offs[:, 1] - offs[:, 0]
    leaf.ends = np.cumsum(4 + lens[index]) if len(index) else index
    leaf.plain = lambda v0, v1: native.plain_byte_arrays(
        buf, offs, index[v0:v1])


def _dict_checks(leaf: _Leaf, m: int) -> np.ndarray:
    """The value counts at which the dictionary's size is checked: every
    DICT_CHECK values, or for a list column the first row start at or after
    each (a page of a list column starts at a row)."""
    at = np.arange(DICT_CHECK, m, DICT_CHECK, dtype=np.int64)
    if leaf.reps is None or not len(at):
        return at
    before = np.cumsum(leaf.defs == leaf.max_def) - (
        leaf.defs == leaf.max_def)
    rv = before[leaf.reps == 0]
    return np.unique(rv[np.minimum(np.searchsorted(rv, at), len(rv) - 1)])


def _dict_fixed(leaf: _Leaf, keys: np.ndarray, entry_bytes, rows):
    """Dictionary-encode a leaf of fixed-width values `keys` (compared by
    their bytes), the dictionary page's values the rows of `rows` (PLAIN
    bytes each, `entry_bytes` of them) of the entries' first appearances;
    the encoding stops where the dictionary reaches DICT_PAGE_BYTES at a
    check."""
    m = len(keys)
    limit = -(-DICT_PAGE_BYTES // int(entry_bytes))
    index, firsts, k = native.dict_encode_fixed(
        keys, _dict_checks(leaf, m), limit)
    leaf.dict_plain = np.ascontiguousarray(rows[firsts]).view(np.uint8)
    leaf.dict_n = len(firsts)
    leaf.index = index
    leaf.n_enc = k


def _page_bounds(leaf: _Leaf) -> list:
    """[(first entry, end entry, first value, end value)] of each data
    page: about PAGE_BYTES of encoded values and at most PAGE_VALUES
    entries; the dictionary-encoded values and the PLAIN ones in pages of
    their own; a list column's pages starting at its rows' first
    entries."""
    e = len(leaf.defs)
    live = leaf.defs == leaf.max_def
    m = int(np.count_nonzero(live))
    if m == e:  # every entry a value
        before = None
    else:
        before = np.zeros(e + 1, dtype=np.int64)
        np.cumsum(live, out=before[1:])
    k = leaf.n_enc if leaf.index is not None else 0
    cuts = [np.zeros(1, dtype=np.int64)]
    if k:
        bits = max(1, (leaf.dict_n - 1).bit_length())
        cuts.append(np.arange(0, k, max(1, PAGE_BYTES * 8 // bits)))
    if m > k:
        cuts.append(np.array([k], dtype=np.int64))
        if leaf.ends is not None:  # PLAIN strings: every value PLAIN
            at = np.arange(PAGE_BYTES, int(leaf.ends[-1]), PAGE_BYTES)
            cuts.append(np.searchsorted(leaf.ends, at) + 1)
        else:
            cuts.append(np.arange(k, m, max(1, int(PAGE_BYTES
                                                   // leaf.vbytes))))
    ecuts = np.concatenate(cuts)
    if before is not None:
        ecuts = np.searchsorted(before, ecuts)
    ecuts = np.concatenate([ecuts, np.arange(0, e, PAGE_VALUES)])
    if leaf.reps is not None:
        rs = np.flatnonzero(leaf.reps == 0)
        ecuts = rs[np.minimum(np.searchsorted(rs, ecuts), len(rs) - 1)]
    bounds = np.unique(np.append(ecuts[ecuts < e], e)).tolist()
    if bounds[0] != 0:
        bounds.insert(0, 0)
    if before is None:
        return [(e0, e1, e0, e1) for e0, e1 in zip(bounds[:-1], bounds[1:])]
    return [(e0, e1, int(before[e0]), int(before[e1]))
            for e0, e1 in zip(bounds[:-1], bounds[1:])]


def _page_header(ptype: int, usize: int, csize: int, nvals: int,
                 enc: int) -> bytes:
    ph = ThriftOut()
    ph.int(1, ptype)
    ph.int(2, usize)
    ph.int(3, csize)
    if ptype == _DICTIONARY_PAGE:
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


class _ChunkOut:
    """The pages of one column chunk as they are written: offsets, the
    sizes before and after the codec, the pages by type and encoding, and
    the compress seconds."""

    def __init__(self, fh, pos: int, codec: int):
        self.fh, self.pos, self.codec = fh, pos, codec
        self.start = pos
        self.usize = 0
        self.pages: dict = {}
        self.compress_s = 0.0

    def page(self, ptype: int, body: bytes, nvals: int, enc: int):
        data = body
        if self.codec:
            t = time.perf_counter()
            data = native.snappy_compress(body)
            self.compress_s += time.perf_counter() - t
        head = _page_header(ptype, len(body), len(data), nvals, enc)
        self.fh.write(head)
        self.fh.write(data)
        self.pos += len(head) + len(data)
        self.usize += len(head) + len(body)
        key = (ptype, enc)
        self.pages[key] = self.pages.get(key, 0) + 1


def _write_chunk(fh, pos: int, leaf: _Leaf, codec: int) -> dict:
    """Write one column chunk's pages at file offset `pos`; its
    ColumnMetaData fields."""
    out = _ChunkOut(fh, pos, codec)
    dict_off = None
    if leaf.index is not None:
        dict_off = pos
        out.page(_DICTIONARY_PAGE, leaf.dict_plain.tobytes(), leaf.dict_n,
                 _PLAIN)
    data_off = out.pos
    hi = 0  # the dictionary's entries so far, less one
    for e0, e1, v0, v1 in _page_bounds(leaf):
        parts = []
        if leaf.reps is not None:
            parts.append(_levels(leaf.reps[e0:e1], 1))
        parts.append(_levels(leaf.defs[e0:e1], leaf.max_def))
        if leaf.index is not None and v1 <= leaf.n_enc:
            idx = leaf.index[v0:v1]
            if len(idx):
                hi = max(hi, int(idx.max()))
            bits = max(1, hi.bit_length())
            parts.append(bytes([bits]))
            parts.append(native.rle_hybrid_encode(idx, bits))
            enc = _RLE_DICTIONARY
        else:
            parts.append(leaf.plain(v0, v1))
            enc = _PLAIN
        out.page(_DATA_PAGE, b"".join(parts), e1 - e0, enc)
    encodings = sorted({_RLE} | {enc for _, enc in out.pages})
    return {"start": out.start, "size": out.pos - out.start,
            "usize": out.usize, "data_off": data_off, "dict_off": dict_off,
            "encodings": encodings, "pages": out.pages,
            "nvals": len(leaf.defs), "compress_s": out.compress_s}


def _statistics(fm: ThriftOut, stats):
    nulls, mm = stats
    fm.begin(12)
    if mm is not None:
        fm.binary(1, mm[1])
        fm.binary(2, mm[0])
    fm.int(3, nulls, 6)
    if mm is not None:
        fm.binary(5, mm[1])
        fm.binary(6, mm[0])
        fm.bool(7, True)
        fm.bool(8, True)
    fm.end()


def _footer(schema: list, groups: list, n: int) -> bytes:
    """The FileMetaData of a file: its schema (the first group's leaves,
    or an empty table's), and each row group's (leaves, chunks, rows)."""
    fm = ThriftOut()
    fm.int(1, 2)  # version
    elems = sum(len(lf.schema) for lf in schema) + 1
    fm.list(2, 12, elems)
    fm.elem_begin()
    fm.binary(4, b"schema")
    fm.int(5, len(schema))
    fm.end()
    for lf in schema:
        for write in lf.schema:
            write(fm)
    fm.int(3, n, 6)
    fm.list(4, 12, len(groups))
    for leaves, chunks, rows in groups:
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
            fm.int(4, c["codec"])
            fm.int(5, c["nvals"], 6)
            fm.int(6, c["usize"], 6)
            fm.int(7, c["size"], 6)
            fm.int(9, c["data_off"], 6)
            if c["dict_off"] is not None:
                fm.int(11, c["dict_off"], 6)
            if lf.stats is not None:
                _statistics(fm, lf.stats)
            fm.list(13, 12, len(c["pages"]))  # encoding_stats
            for (ptype, enc), count in sorted(c["pages"].items()):
                fm.elem_begin()
                fm.int(1, ptype)
                fm.int(2, enc)
                fm.int(3, count)
                fm.end()
            fm.end()
            fm.end()
        fm.int(2, sum(c["usize"] for c in chunks), 6)
        fm.int(3, rows, 6)
        fm.int(5, chunks[0]["start"], 6)
        fm.int(6, sum(c["size"] for c in chunks), 6)
        fm.end()
    fm.binary(6, b"starrocks_tpu_torch")
    fm.list(7, 12, len(schema))  # column_orders: TYPE_DEFINED_ORDER
    for _ in schema:
        fm.elem_begin()
        fm.empty(1)
        fm.end()
    fm.b.append(0)
    return bytes(fm.b)


def _leaves(data, r0: int, r1: int, dictionary: bool,
            annotate_decimals: bool) -> list:
    """The leaves of rows [r0, r1) of HostTable `data`."""
    out = []
    for f in data.schema:
        a = data.arrays[f.name][r0:r1]
        v = data.valids.get(f.name)
        if v is not None:
            v = np.asarray(v)[r0:r1]
            if v.all():
                v = None
        out.append(_list(f, a, v, dictionary) if f.type.is_array
                   else _flat(f, a, v, dictionary, annotate_decimals))
    return out


def write_table(data, path: str, *, codec: str = "SNAPPY",
                dictionary: bool = True,
                row_group_rows: int = ROW_GROUP_ROWS,
                annotate_decimals: bool = False, times=None) -> int:
    """Write HostTable `data` as one parquet file at `path`, atomically;
    returns the file's bytes. The defaults are pyarrow's layout (the module
    docstring); a dict `times` gains the seconds this call spent in the
    codec under "compress"."""
    name = str(codec).upper()
    if name not in _CODECS:
        raise ValueError(f"parquet codec {codec!r}: the writer has "
                         f"{sorted(_CODECS)}")
    cid = _CODECS[name]
    n = data.num_rows
    step = max(1, int(row_group_rows))
    bounds = list(range(0, n, step)) + [n] if n else []
    groups, compress_s = [], 0.0
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(_MAGIC)
            pos = len(_MAGIC)
            for r0, r1 in zip(bounds[:-1], bounds[1:]):
                leaves = _leaves(data, r0, r1, dictionary, annotate_decimals)
                chunks = []
                for lf in leaves:
                    c = _write_chunk(fh, pos, lf, cid)
                    c["codec"] = cid
                    pos += c["size"]
                    compress_s += c["compress_s"]
                    chunks.append(c)
                groups.append((leaves, chunks, r1 - r0))
            schema = (groups[0][0] if groups else
                      _leaves(data, 0, 0, dictionary, annotate_decimals))
            footer = _footer(schema, groups, n)
            fh.write(footer + struct.pack("<I", len(footer)) + _MAGIC)
            size = pos + len(footer) + 8
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    if times is not None:
        times["compress"] = times.get("compress", 0.0) + compress_s
    return size
