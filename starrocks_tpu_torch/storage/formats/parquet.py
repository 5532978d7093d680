"""A parquet reader without pyarrow (the external tables' parquet files).

What it reads is what pyarrow writes by default and what the reference's
tests write: flat schemas; data pages v1 and v2 and dictionary pages; the
PLAIN, PLAIN_DICTIONARY and RLE_DICTIONARY encodings, with definition
levels in the RLE/bit-packed hybrid; the UNCOMPRESSED, SNAPPY and GZIP
codecs. Another codec (ZSTD, LZ4, BROTLI, ..) or encoding raises
NotImplementedError naming it and the file.

The footer (Thrift compact protocol) and the page headers parse here; the
loops over values (snappy, the hybrid, the split of byte arrays) run in
host C++ (csrc/host/file_formats.cpp). `schema` and `num_rows` read the
footer alone. Types follow what the reference's `HostTable.from_arrow`
makes of pyarrow's read of the same file: every column nullable, strings
as dictionary codes, decimals of precision <= 18 as scaled int64 and wider
ones as 128-bit limbs, DATE as days, timestamps as microseconds.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ... import native
from ... import types as T
from . import (Column, concat, decimal_from_be, decimal_from_ints,
               empty_column)

_MAGIC = b"PAR1"
_CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI",
           5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
_ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
              5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
              7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
              9: "BYTE_STREAM_SPLIT"}
# physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)
# page types
_DATA_PAGE, _DICTIONARY_PAGE, _DATA_PAGE_V2 = 0, 2, 3


# --- Thrift compact protocol ----------------------------------------------------

class _Thrift:
    """Decoder of the Thrift compact protocol: a struct becomes a dict of
    field id -> value (lists as lists, binaries as bytes)."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def _varint(self) -> int:
        r = shift = 0
        while True:
            b = self._byte()
            r |= (b & 0x7F) << shift
            if not b & 0x80:
                return r
            shift += 7

    def _zigzag(self) -> int:
        v = self._varint()
        return (v >> 1) ^ -(v & 1)

    def _value(self, t: int):
        if t in (1, 2):  # a bool field's value is its type
            return t == 1
        if t == 3:
            v = self._byte()
            return v - 256 if v > 127 else v
        if t in (4, 5, 6):
            return self._zigzag()
        if t == 7:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if t == 8:
            n = self._varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if t in (9, 10):
            h = self._byte()
            n, et = h >> 4, h & 0x0F
            if n == 15:
                n = self._varint()
            if et in (1, 2):
                return [self._byte() == 1 for _ in range(n)]
            return [self._value(et) for _ in range(n)]
        if t == 11:
            n = self._varint()
            if not n:
                return {}
            kv = self._byte()
            return {self._value(kv >> 4): self._value(kv & 0x0F)
                    for _ in range(n)}
        if t == 12:
            return self.struct()
        raise ValueError(f"thrift: unknown type {t}")

    def struct(self) -> dict:
        out, last = {}, 0
        while True:
            h = self._byte()
            if h == 0:
                return out
            t, delta = h & 0x0F, h >> 4
            fid = last + delta if delta else self._zigzag()
            out[fid] = self._value(t)
            last = fid


# --- schema -----------------------------------------------------------------------

class _Leaf:
    __slots__ = ("name", "physical", "type_length", "optional", "type",
                 "ts_div")

    def __init__(self, name, physical, type_length, optional, ltype, ts_div):
        self.name = name
        self.physical = physical
        self.type_length = type_length
        self.optional = optional
        self.type = ltype
        self.ts_div = ts_div  # timestamp units per microsecond (1 / -1000)


def _leaf_type(el: dict, path: str):
    """(LogicalType, timestamp divisor) of one schema element."""
    phys = el.get(1)
    conv = el.get(6)
    logical = el.get(10) or {}
    name = el.get(4, b"").decode()
    dec = logical.get(5)
    if dec is not None or conv == 5:
        prec = dec.get(2) if dec is not None else el.get(8)
        scale = dec.get(1) if dec is not None else el.get(7, 0)
        return T.LogicalType(T.TypeKind.DECIMAL, prec, scale), 1
    if phys == BOOLEAN:
        return T.BOOLEAN, 1
    if phys == INT32:
        if 6 in logical or conv == 6:
            return T.DATE, 1
        it = logical.get(10)
        if it is not None or conv in (15, 16, 11, 12, 13):
            bits, signed = ((it.get(1), it.get(2)) if it is not None else
                            {15: (8, True), 16: (16, True), 11: (8, False),
                             12: (16, False), 13: (32, False)}[conv])
            if signed:
                return {8: T.TINYINT, 16: T.SMALLINT}.get(bits, T.INT), 1
            return {8: T.SMALLINT, 16: T.INT}.get(bits, T.BIGINT), 1
        if 7 in logical or conv in (7, 8):
            raise NotImplementedError(f"{path}: TIME column {name!r}")
        return T.INT, 1
    if phys == INT64:
        ts = logical.get(8)
        if ts is not None or conv in (9, 10):
            unit = (ts or {}).get(2) or ({1: {}} if conv == 9 else {2: {}})
            div = 1000 if 3 in unit else (-1000 if 1 in unit else 1)
            return T.DATETIME, div
        if 7 in logical or conv == 8:
            raise NotImplementedError(f"{path}: TIME column {name!r}")
        return T.BIGINT, 1
    if phys == FLOAT:
        return T.FLOAT, 1
    if phys == DOUBLE:
        return T.DOUBLE, 1
    if phys == BYTE_ARRAY and (1 in logical or 4 in logical or 12 in logical
                               or conv in (0, 4, 19)):
        return T.VARCHAR, 1
    what = {BYTE_ARRAY: "binary", FLBA: "fixed-length binary",
            INT96: "INT96 timestamp"}.get(phys, f"physical type {phys}")
    raise NotImplementedError(f"{path}: {what} column {name!r}")


class ParquetFile:
    """One parquet file: `schema` and `num_rows` from its footer; `read()`
    decodes every column."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            if size < 12:
                raise ValueError(f"{path}: not a parquet file")
            fh.seek(size - 8)
            tail = fh.read(8)
            if tail[4:] != _MAGIC:
                raise ValueError(f"{path}: not a parquet file")
            flen = struct.unpack("<I", tail[:4])[0]
            fh.seek(size - 8 - flen)
            self.meta = _Thrift(fh.read(flen)).struct()
        self.num_rows = int(self.meta.get(3, 0))
        elems = self.meta.get(2, [])
        self.leaves = []
        for el in elems[1:]:
            name = el.get(4, b"").decode()
            if el.get(5):
                raise NotImplementedError(
                    f"{path}: nested column {name!r} (only flat schemas)")
            if el.get(3) == 2:
                raise NotImplementedError(
                    f"{path}: repeated column {name!r}")
            ltype, div = _leaf_type(el, path)
            self.leaves.append(_Leaf(name, el.get(1), el.get(2),
                                     el.get(3) == 1, ltype, div))

    @property
    def schema(self) -> list:
        """[(name, LogicalType)] in file order."""
        return [(lf.name, lf.type) for lf in self.leaves]

    def read(self) -> dict:
        """{name: Column} of every row of the file."""
        parts = {lf.name: [] for lf in self.leaves}
        with open(self.path, "rb") as fh:
            for rg in self.meta.get(4, []):
                for lf, cc in zip(self.leaves, rg[1]):
                    parts[lf.name].append(self._chunk(fh, lf, cc[3]))
        out = {}
        for lf in self.leaves:
            p = parts[lf.name]
            out[lf.name] = concat(p) if p else empty_column(lf.type)
        return out

    def _chunk(self, fh, lf: _Leaf, md: dict) -> Column:
        codec = md.get(4, 0)
        if codec not in (0, 1, 2):
            raise NotImplementedError(
                f"{self.path}: parquet codec {_CODECS.get(codec, codec)} "
                f"(column {lf.name!r}); the port reads UNCOMPRESSED, SNAPPY "
                "and GZIP")
        start = md.get(9)
        dpo = md.get(11)
        if dpo is not None and 0 < dpo < start:
            start = dpo
        fh.seek(start)
        raw = fh.read(md[7])
        nvals = md[5]
        dictionary = None
        values, valids = [], []
        pos = 0
        got = 0
        while got < nvals:
            th = _Thrift(raw, pos)
            ph = th.struct()
            pos = th.pos
            ptype, usize, csize = ph[1], ph[2], ph[3]
            body = raw[pos:pos + csize]
            pos += csize
            if ptype == _DICTIONARY_PAGE:
                page = self._decompress(codec, body, usize)
                dictionary = self._plain(lf, page, ph[7][1])[0]
                continue
            if ptype == _DATA_PAGE:
                hdr = ph[5]
                page = self._decompress(codec, body, usize)
                n, enc = hdr[1], hdr[2]
                valid, p = None, 0
                if lf.optional:
                    ln = struct.unpack_from("<I", page, 0)[0]
                    lv = np.frombuffer(page, dtype=np.uint8, count=ln,
                                       offset=4)
                    valid = native.rle_bp_decode(lv, 1, n)[0] == 1
                    p = 4 + ln
                data = page[p:]
            elif ptype == _DATA_PAGE_V2:
                hdr = ph[8]
                n, enc = hdr[1], hdr[4]
                dl, rl = hdr.get(5, 0), hdr.get(6, 0)
                valid = None
                if lf.optional:
                    lv = np.frombuffer(body, dtype=np.uint8, count=dl,
                                       offset=rl)
                    valid = (native.rle_bp_decode(lv, 1, n)[0] == 1
                             if dl else np.ones(n, dtype=bool))
                data = body[rl + dl:]
                if hdr.get(7, True):
                    data = self._decompress(codec, data, usize - rl - dl)
            else:
                continue  # index pages carry no rows
            nn = n if valid is None else int(valid.sum())
            vals = self._values(lf, data, enc, nn, dictionary)
            values.append(_spread(lf, vals, valid, n))
            valids.append(valid)
            got += n
        return concat([Column(v, m) for v, m in zip(values, valids)])

    def _decompress(self, codec: int, body, size: int):
        if codec == 0:
            return body
        if codec == 1:
            return native.snappy_decompress(body, size).tobytes()
        return zlib.decompress(body, 47)  # gzip or zlib header

    def _plain(self, lf: _Leaf, data, n: int):
        """(values, bytes used) of n PLAIN values."""
        ph = lf.physical
        if ph == BYTE_ARRAY:
            buf = np.frombuffer(data, dtype=np.uint8)
            offs, used = native.byte_array_offsets(buf, n)
            return (buf, offs), used
        if ph == BOOLEAN:
            bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8,
                                               count=(n + 7) // 8),
                                 bitorder="little")[:n]
            return bits.astype(bool), (n + 7) // 8
        if ph == FLBA:
            w = lf.type_length
            return (np.frombuffer(data, dtype=np.uint8, count=n * w)
                    .reshape(n, w)), n * w
        if ph == INT96:
            raise NotImplementedError(f"{self.path}: INT96 column")
        dt = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[ph]
        a = np.frombuffer(data, dtype=dt, count=n)
        return a, a.nbytes

    def _values(self, lf: _Leaf, data, enc: int, n: int, dictionary):
        if enc == 0:
            return self._plain(lf, data, n)[0]
        if enc == 3 and lf.physical == BOOLEAN:
            # booleans in RLE (v2 pages): a 4-byte length, then the hybrid
            ln = struct.unpack_from("<I", data, 0)[0]
            buf = np.frombuffer(data, dtype=np.uint8, count=ln, offset=4)
            return native.rle_bp_decode(buf, 1, n)[0].astype(bool)
        if enc in (2, 8):
            if dictionary is None:
                raise ValueError(f"{self.path}: dictionary page missing")
            buf = np.frombuffer(data, dtype=np.uint8)
            idx = native.rle_bp_decode(buf[1:], int(buf[0]), n)[0] \
                if n else np.zeros(0, dtype=np.int32)
            if isinstance(dictionary, tuple):
                return dictionary[0], dictionary[1][idx]
            return dictionary[idx]
        raise NotImplementedError(
            f"{self.path}: parquet encoding {_ENCODINGS.get(enc, enc)} "
            f"(column {lf.name!r})")


def _spread(lf: _Leaf, vals, valid, n: int):
    """Non-null values onto the page's n rows (NULL rows hold 0 or ""),
    converted to the column's in-memory layout."""
    t = lf.type
    if isinstance(vals, tuple):
        buf, offs = vals
        if t.is_decimal or t.is_decimal128:
            raw = [bytes(buf[s:e]) for s, e in offs]
            w = max((len(r) for r in raw), default=1)
            mat = np.array([list(r.rjust(w, b"\xff" if r and r[0] & 0x80
                                         else b"\0")) for r in raw],
                           dtype=np.uint8).reshape(len(raw), w)
            vals = decimal_from_be(mat, t.precision)
        elif valid is not None:
            full = np.zeros((n, 2), dtype=np.int64)
            full[valid] = offs
            return buf, full
        else:
            return buf, offs
    elif t.is_decimal or t.is_decimal128:
        vals = (decimal_from_be(vals, t.precision) if vals.ndim == 2
                else decimal_from_ints(vals, t.precision))
    elif t.kind is T.TypeKind.DATETIME:
        vals = vals.astype(np.int64)
        vals = (vals // lf.ts_div if lf.ts_div > 0
                else vals * -lf.ts_div)
    else:
        vals = vals.astype(t.np_dtype)
    if valid is None:
        return vals
    full = np.zeros((n,) + vals.shape[1:], dtype=vals.dtype)
    full[valid] = vals
    return full
