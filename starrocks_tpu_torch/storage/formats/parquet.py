"""A parquet reader without pyarrow (the external tables' parquet files).

What it reads is what pyarrow reads of the files the reference's users
declare: flat columns and LIST columns of primitives (the 3-level list and
the legacy 2-level one, repetition and definition levels in the
RLE/bit-packed hybrid); data pages v1 and v2 and dictionary pages; the
encodings PLAIN, PLAIN_DICTIONARY, RLE_DICTIONARY, RLE (booleans),
DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY and
BYTE_STREAM_SPLIT; the codecs UNCOMPRESSED, SNAPPY, GZIP, BROTLI, ZSTD,
LZ4_RAW and LZ4 (Hadoop's framing, or a raw block as older writers left
it). LZO, STRUCT, MAP and TIME columns raise NotImplementedError naming
the feature and the file; a corrupt page raises ValueError naming the
file.

The footer (Thrift compact protocol) and the page headers parse here; the
loops over values (the codecs, the hybrid, the DELTA encodings, the split
of byte arrays) run in host C++ (csrc/host/). `schema` and `num_rows` read
the footer alone. Types follow what the reference's `HostTable.from_arrow`
makes of pyarrow's read of the same file: every column nullable, strings
as dictionary codes, decimals of precision <= 18 as scaled int64 and wider
ones as 128-bit limbs, DATE as days, timestamps (INT96 included) as
microseconds (a sub-microsecond fraction raises, as the reference's cast
does), binary columns as byte ranges (external.py makes them BITMAP) and
LIST columns as Lists (external.py makes them ARRAY).
"""

from __future__ import annotations

import struct
import time
import zlib

import numpy as np

from ... import native
from ... import types as T
from . import (Coded, Column, Lists, Spec, concat, decimal_from_be,
               decimal_from_ints, empty_column)

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
# repetition types
_REQUIRED, _OPTIONAL, _REPEATED = range(3)
_JULIAN_EPOCH = 2440588  # the Julian day of 1970-01-01 (INT96)
_US_PER_DAY = 86_400_000_000


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
    """One leaf column: its physical type, its LogicalType as decoded
    (`type`; microseconds per unit in `ts_div`, 1 / 1000 / -1000, and
    `int96`), whether its values are opaque bytes (`binary`), and its
    levels: `max_def`, `max_rep`, and for a list leaf the definition level
    at which the list is defined (`d_list`; an element slot exists from
    d_list + 1, a value at max_def)."""

    __slots__ = ("name", "physical", "type_length", "type", "ts_div",
                 "binary", "max_def", "max_rep", "d_list")

    def __init__(self, name, physical, type_length, ltype, ts_div, binary,
                 max_def, max_rep=0, d_list=0):
        self.name = name
        self.physical = physical
        self.type_length = type_length
        self.type = ltype
        self.ts_div = ts_div
        self.binary = binary
        self.max_def = max_def
        self.max_rep = max_rep
        self.d_list = d_list


def _leaf_type(el: dict, path: str):
    """(LogicalType, microseconds per unit, Arrow type key, binary, list
    element kind) of one primitive schema element."""
    phys = el.get(1)
    conv = el.get(6)
    logical = el.get(10) or {}
    name = el.get(4, b"").decode()
    dec = logical.get(5)
    if dec is not None or conv == 5:
        prec = dec.get(2) if dec is not None else el.get(8)
        scale = dec.get(1) if dec is not None else el.get(7, 0)
        return (T.LogicalType(T.TypeKind.DECIMAL, prec, scale), 1,
                f"decimal128({prec}, {scale})", False, "decimal")
    if 11 in logical:
        raise TypeError(f"{path}: column {name!r}: unsupported arrow type "
                        "null")
    if phys == BOOLEAN:
        return T.BOOLEAN, 1, "bool", False, "value"
    if phys == INT32:
        if 6 in logical or conv == 6:
            return T.DATE, 1, "date32[day]", False, "date"
        if 7 in logical or conv in (7, 8):
            raise NotImplementedError(f"{path}: TIME column {name!r}")
        it = logical.get(10)
        if it is not None or conv in (15, 16, 11, 12, 13):
            bits, signed = ((it.get(1), it.get(2)) if it is not None else
                            {15: (8, True), 16: (16, True), 11: (8, False),
                             12: (16, False), 13: (32, False)}[conv])
            key = f"{'' if signed else 'u'}int{bits}"
            if signed:
                return ({8: T.TINYINT, 16: T.SMALLINT}.get(bits, T.INT), 1,
                        key, False, "value")
            return ({8: T.SMALLINT, 16: T.INT}.get(bits, T.BIGINT), 1, key,
                    False, "value")
        return T.INT, 1, "int32", False, "value"
    if phys == INT64:
        ts = logical.get(8)
        if ts is not None or conv in (9, 10):
            unit = (ts or {}).get(2) or ({1: {}} if conv == 9 else {2: {}})
            div = 1000 if 3 in unit else (-1000 if 1 in unit else 1)
            tz = (ts or {1: True}).get(1)
            u = "ns" if 3 in unit else ("ms" if 1 in unit else "us")
            key = f"timestamp[{u}{', tz=UTC' if tz else ''}]"
            return (T.DATETIME, div, key, False,
                    "timestamp_tz" if tz else "timestamp")
        if 7 in logical or conv == 8:
            raise NotImplementedError(f"{path}: TIME column {name!r}")
        it = logical.get(10)
        unsigned = (it is not None and not it.get(2)) or conv == 14
        return T.BIGINT, 1, "uint64" if unsigned else "int64", False, "value"
    if phys == INT96:
        return T.DATETIME, 1000, "timestamp[ns]", False, "int96"
    if phys == FLOAT:
        return T.FLOAT, 1, "float", False, "value"
    if phys == DOUBLE:
        return T.DOUBLE, 1, "double", False, "value"
    if phys == BYTE_ARRAY and (1 in logical or 4 in logical or 12 in logical
                               or conv in (0, 4, 19)):
        return T.VARCHAR, 1, "string", False, "string"
    if phys == FLBA and 15 in logical:
        raise TypeError(f"{path}: column {name!r}: unsupported arrow type "
                        "halffloat")
    if phys in (BYTE_ARRAY, FLBA):
        key = ("binary" if phys == BYTE_ARRAY
               else f"fixed_size_binary[{el.get(2)}]")
        return T.LogicalType(T.TypeKind.BITMAP, 8), 1, key, True, "binary"
    raise NotImplementedError(f"{path}: physical type {phys} column {name!r}")


def _tree(elems: list, i: int):
    """(node, next index) of the schema subtree at elems[i]: a node is
    (element, [children])."""
    el = elems[i]
    kids, j = [], i + 1
    for _ in range(el.get(5) or 0):
        kid, j = _tree(elems, j)
        kids.append(kid)
    return (el, kids), j


def _is_list(el: dict) -> bool:
    return el.get(6) == 3 or 3 in (el.get(10) or {})


def _is_map(el: dict) -> bool:
    return el.get(6) in (1, 2) or 2 in (el.get(10) or {})


def _column(node, path: str):
    """(Spec, _Leaf) of one top-level column, after the parquet spec's
    rules for lists (the 3-level list, and the legacy forms as Arrow reads
    them); STRUCT and MAP columns raise."""
    el, kids = node
    name = el.get(4, b"").decode()
    rep = el.get(3, _REQUIRED)
    if not kids:
        ltype, div, key, binary, kind = _leaf_type(el, path)
        if rep != _REPEATED:
            spec = Spec(name, ltype, key, "binary" if binary else
                        ("string" if kind == "string" else "value"))
            return spec, _Leaf(name, el.get(1), el.get(2), ltype, div,
                               binary, 1 if rep == _OPTIONAL else 0)
        # a bare repeated primitive: a list of required elements
        leaf = _Leaf(name, el.get(1), el.get(2), ltype, div, binary, 1, 1, 0)
        return _list_spec(name, key + " not null", kind, ltype), leaf
    if _is_map(el):
        raise NotImplementedError(f"{path}: MAP column {name!r}")
    if not _is_list(el) or rep == _REPEATED or len(kids) != 1:
        raise NotImplementedError(f"{path}: STRUCT column {name!r}")
    d_list = 1 if rep == _OPTIONAL else 0
    rel, rkids = kids[0]
    if rel.get(3) != _REPEATED:
        raise NotImplementedError(
            f"{path}: LIST column {name!r} without a repeated field")
    rname = rel.get(4, b"").decode()
    if not rkids:  # 2-level: the repeated field is the element
        ltype, div, key, binary, kind = _leaf_type(rel, path)
        leaf = _Leaf(name, rel.get(1), rel.get(2), ltype, div, binary,
                     d_list + 1, 1, d_list)
        return _list_spec(name, key + " not null", kind, ltype), leaf
    if len(rkids) > 1 or rname in ("array", f"{name}_tuple"):
        raise NotImplementedError(f"{path}: LIST of STRUCT column {name!r}")
    eel, ekids = rkids[0]
    if ekids:
        what = ("LIST" if _is_list(eel) else
                "MAP" if _is_map(eel) else "STRUCT")
        raise NotImplementedError(f"{path}: LIST of {what} column {name!r}")
    ltype, div, key, binary, kind = _leaf_type(eel, path)
    opt = eel.get(3, _REQUIRED) == _OPTIONAL
    leaf = _Leaf(name, eel.get(1), eel.get(2), ltype, div, binary,
                 d_list + 1 + opt, 1, d_list)
    return _list_spec(name, key + ("" if opt else " not null"), kind,
                      ltype), leaf


def _list_spec(name, key, kind, ltype) -> Spec:
    return Spec(name, T.ARRAY(T.BIGINT), f"list<{key}>", "list",
                (kind, ltype))


class ParquetFile:
    """One parquet file: `schema`, `specs` and `num_rows` from its footer;
    `read()` decodes every column, adding its seconds to `times`
    (decompress; values, the rest, which includes "read", the seconds
    reading the chunks' bytes) and the bytes its codecs gave to
    `times["decompressed_bytes"]`. A run of dictionary-encoded pages is
    looked up in its dictionary by one gather."""

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
        self.specs, self.leaves = [], []
        j = 1
        for _ in range((elems[0].get(5) or 0) if elems else 0):
            node, j = _tree(elems, j)
            spec, leaf = _column(node, path)
            self.specs.append(spec)
            self.leaves.append(leaf)
        self.times = {"decompress": 0.0, "values": 0.0, "read": 0.0,
                      "decompressed_bytes": 0}

    @property
    def schema(self) -> list:
        """[(name, LogicalType)] in file order, as the footer gives them."""
        return [(sp.name, sp.type) for sp in self.specs]

    def read(self, columns=None, codes: bool = False) -> dict:
        """{name: Column} of every row of the file: of every column, or of
        the names in `columns`. With `codes`, a string column (or a list
        of strings' elements) whose pages are all dictionary-encoded comes
        back as a Coded: the dictionary and each row's index."""
        leaves = [(i, lf) for i, lf in enumerate(self.leaves)
                  if columns is None or lf.name in columns]
        parts = {lf.name: [] for _, lf in leaves}
        t0 = time.perf_counter()
        d0 = self.times["decompress"]
        with open(self.path, "rb") as fh:
            for rg in self.meta.get(4, []):
                for i, lf in leaves:
                    parts[lf.name].append(
                        self._chunk(fh, lf, rg[1][i][3], codes))
        out = {}
        for _, lf in leaves:
            p = parts[lf.name]
            out[lf.name] = concat(p) if p else _empty(lf)
        self.times["values"] += (time.perf_counter() - t0
                                 - (self.times["decompress"] - d0))
        return out

    def _chunk(self, fh, lf: _Leaf, md: dict, codes: bool = False) -> Column:
        codec = md.get(4, 0)
        if codec not in (0, 1, 2, 4, 5, 6, 7):
            raise NotImplementedError(
                f"{self.path}: parquet codec {_CODECS.get(codec, codec)} "
                f"(column {lf.name!r}); the port reads UNCOMPRESSED, SNAPPY, "
                "GZIP, BROTLI, ZSTD, LZ4_RAW and LZ4")
        start = md.get(9)
        dpo = md.get(11)
        if dpo is not None and 0 < dpo < start:
            start = dpo
        t = time.perf_counter()
        fh.seek(start)
        raw = memoryview(fh.read(md[7]))  # pages sliced without a copy
        self.times["read"] += time.perf_counter() - t
        nvals = md[5]
        coded = (codes and lf.physical == BYTE_ARRAY and not lf.binary
                 and lf.type.is_string)
        dictionary = None
        values, defs, reps = [], [], []
        pending = []  # indices of dictionary pages not yet looked up

        def lookup():  # one gather for a run of dictionary-encoded pages
            if pending:
                idx = np.concatenate(pending) if len(pending) > 1 else (
                    pending[0])
                values.append(Column(
                    (dictionary[0], dictionary[1][idx])
                    if isinstance(dictionary, tuple) else dictionary[idx]))
                pending.clear()
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
                p = 0
                rl = dl = None
                if lf.max_rep:
                    ln = struct.unpack_from("<I", page, p)[0]
                    rl = np.frombuffer(page, dtype=np.uint8, count=ln,
                                       offset=p + 4)
                    p += 4 + ln
                if lf.max_def:
                    ln = struct.unpack_from("<I", page, p)[0]
                    dl = np.frombuffer(page, dtype=np.uint8, count=ln,
                                       offset=p + 4)
                    p += 4 + ln
                data = page[p:]
            elif ptype == _DATA_PAGE_V2:
                hdr = ph[8]
                n, enc = hdr[1], hdr[4]
                dlen, rlen = hdr.get(5, 0), hdr.get(6, 0)
                rl = np.frombuffer(body, dtype=np.uint8, count=rlen)
                dl = np.frombuffer(body, dtype=np.uint8, count=dlen,
                                   offset=rlen)
                data = body[rlen + dlen:]
                if hdr.get(7, True):
                    data = self._decompress(codec, data, usize - rlen - dlen)
            else:
                continue  # index pages carry no rows
            if lf.max_rep:
                reps.append(_levels(rl, lf.max_rep, n))
                dlv = _levels(dl, lf.max_def, n)
            else:  # a page without NULLs keeps its count, not its levels
                dlv = (n if _one_run(dl, lf.max_def, n)
                       else _levels(dl, lf.max_def, n))
            nn = n
            if dlv is not None:
                if not isinstance(dlv, int):
                    nn = int((dlv == lf.max_def).sum())
                defs.append(dlv)
            if coded and enc in (2, 8) and dictionary is not None:
                values.append(Column(Coded(dictionary,
                                           self._indices(data, nn))))
            elif enc in (2, 8) and dictionary is not None:
                pending.append(self._indices(data, nn))
            else:
                lookup()
                values.append(Column(self._values(lf, data, enc, nn,
                                                  dictionary)))
            got += n
        lookup()
        vals = concat(values).data if values else None
        if lf.max_rep:
            none = np.zeros(0, dtype=np.int32)
            return self._lists(lf, vals, np.concatenate(defs or [none]),
                               np.concatenate(reps or [none]))
        valid = None
        if not all(isinstance(d, int) for d in defs):
            # rows without a value: definition level below max_def
            valid = np.concatenate([
                np.full(d, lf.max_def, dtype=np.int32) if isinstance(d, int)
                else d for d in defs]) == lf.max_def
            if valid.all():
                valid = None
        return Column(_spread(lf, vals, valid, got, self.path), valid)

    def _lists(self, lf: _Leaf, vals, dlv, rlv) -> Column:
        """The rows of a list leaf from its levels: a row starts at
        repetition level 0; definition level d_list or more defines the
        list, d_list + 1 or more an element slot, max_def a value."""
        starts = rlv == 0
        rows = int(starts.sum())
        row = np.cumsum(starts) - 1
        slot = dlv > lf.d_list
        if ((dlv < lf.max_def) & slot).any():
            raise NotImplementedError("NULL array elements not supported")
        lengths = np.bincount(row[slot], minlength=rows).astype(np.int64)
        valid = None
        if lf.d_list:
            valid = (dlv >= lf.d_list)[starts]
            if valid.all():
                valid = None
        elems = _spread(lf, vals, None, int(slot.sum()), self.path)
        return Column(Lists(lengths, Column(elems)), valid)

    def _decompress(self, codec: int, body, size: int):
        if codec == 0:
            return body
        t = time.perf_counter()
        try:
            if codec == 1:
                out = native.snappy_decompress(body, size)
            elif codec == 6:
                out = native.zstd_decompress(body, size)
            elif codec == 7:
                out = native.lz4_decompress(body, size)
            elif codec == 5:
                out = lz4_hadoop(body, size)
            elif codec == 4:
                out = native.brotli_decompress(body, size)
            else:
                out = zlib.decompress(body, 47)  # gzip or zlib header
        except ValueError as e:
            raise ValueError(f"{self.path}: {e}") from e
        finally:
            self.times["decompress"] += time.perf_counter() - t
        self.times["decompressed_bytes"] += len(out)
        return out

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
        if ph in (FLBA, INT96):
            w = 12 if ph == INT96 else lf.type_length
            return (np.frombuffer(data, dtype=np.uint8, count=n * w)
                    .reshape(n, w)), n * w
        dt = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[ph]
        a = np.frombuffer(data, dtype=dt, count=n)
        return a, a.nbytes

    @staticmethod
    def _indices(data, n: int) -> np.ndarray:
        """n dictionary indices: their bit width, then the hybrid."""
        if not n:
            return np.zeros(0, dtype=np.int32)
        buf = np.frombuffer(data, dtype=np.uint8)
        return native.rle_bp_decode(buf[1:], int(buf[0]), n)[0]

    def _values(self, lf: _Leaf, data, enc: int, n: int, dictionary):
        ph = lf.physical
        if enc == 0:
            return self._plain(lf, data, n)[0]
        if enc == 3 and ph == BOOLEAN:
            # booleans in RLE (v2 pages): a 4-byte length, then the hybrid
            ln = struct.unpack_from("<I", data, 0)[0]
            buf = np.frombuffer(data, dtype=np.uint8, count=ln, offset=4)
            return native.rle_bp_decode(buf, 1, n)[0].astype(bool)
        if enc in (2, 8):  # with a dictionary, _chunk looks them up
            raise ValueError(f"{self.path}: dictionary page missing")
        buf = np.frombuffer(data, dtype=np.uint8)
        if enc == 5 and ph in (INT32, INT64):
            v = native.delta_binary_packed(buf, n)[0]
            return v.astype(np.int32) if ph == INT32 else v
        if enc == 6 and ph == BYTE_ARRAY:
            return _delta_lengths(buf, n)[0]
        if enc == 7 and ph in (BYTE_ARRAY, FLBA):
            prefix, used = native.delta_binary_packed(buf, n)
            (sbuf, soffs), _ = _delta_lengths(buf[used:], n)
            out = native.delta_byte_array(sbuf, prefix, soffs)
            if ph == FLBA:
                w = lf.type_length
                if not (out[1][:, 1] - out[1][:, 0] == w).all():
                    raise ValueError(f"{self.path}: column {lf.name!r}: "
                                     "DELTA_BYTE_ARRAY value of another width")
                return out[0].reshape(n, w)
            return out
        if enc == 9 and ph in (FLOAT, DOUBLE, INT32, INT64, FLBA):
            w = lf.type_length if ph == FLBA else (4 if ph in (FLOAT, INT32)
                                                   else 8)
            cols = buf[:n * w].reshape(w, n).T.copy()
            if ph == FLBA:
                return cols
            dt = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[ph]
            return cols.view(dt).ravel()
        raise NotImplementedError(
            f"{self.path}: parquet encoding {_ENCODINGS.get(enc, enc)} "
            f"(column {lf.name!r})")


def lz4_hadoop(body, size: int):
    """Parquet's LZ4 codec (5): blocks in Hadoop's framing, each after its
    big-endian decompressed and compressed lengths; input that is not so
    framed is one raw block, as older writers left it (Arrow's reader does
    the same)."""
    out, pos, left = [], 0, size
    try:
        while len(body) - pos >= 8:
            usize, csize = struct.unpack_from(">II", body, pos)
            pos += 8
            if csize > len(body) - pos or usize > left:
                raise ValueError("not Hadoop framing")
            out.append(native.lz4_decompress(body[pos:pos + csize], usize))
            pos += csize
            left -= usize
        if pos == len(body):
            return (np.concatenate(out) if out
                    else np.zeros(0, dtype=np.uint8))
    except ValueError:
        pass
    return native.lz4_decompress(body, size)


def _levels(buf, max_level: int, n: int):
    """n levels of the RLE/bit-packed hybrid at the bit width of
    max_level, or None when the column has no such levels."""
    if not max_level:
        return None
    if buf is None or not len(buf):
        return np.full(n, max_level, dtype=np.int32)
    return native.rle_bp_decode(buf, max_level.bit_length(), n)[0]


def _one_run(buf, max_level: int, n: int) -> bool:
    """Whether levels `buf` (or none: every entry defined) are one
    repeated run of n max_level values, so need no decoding."""
    if not max_level:
        return False
    if buf is None or not len(buf):
        return True
    head, shift, i = 0, 0, 0
    while i < len(buf) and i < 10:
        b = int(buf[i])
        head |= (b & 0x7F) << shift
        shift += 7
        i += 1
        if not b & 0x80:
            break
    width = (max_level.bit_length() + 7) // 8
    return (not head & 1 and head >> 1 == n and len(buf) == i + width
            and int.from_bytes(bytes(buf[i:]), "little") == max_level)


def _delta_lengths(buf: np.ndarray, n: int):
    """((buffer, offsets), bytes used) of n DELTA_LENGTH_BYTE_ARRAY
    values: their lengths, DELTA_BINARY_PACKED, then their bytes."""
    lens, used = native.delta_binary_packed(buf, n)
    ends = used + np.cumsum(lens)
    if n and (lens.min() < 0 or ends[-1] > len(buf)):
        raise ValueError("DELTA_LENGTH_BYTE_ARRAY: malformed lengths")
    offs = np.stack([ends - lens, ends], axis=1).astype(np.int64)
    return (buf, offs.reshape(-1, 2)), int(ends[-1]) if n else used


def _no_values(lf: _Leaf):
    """The decoded values of a leaf that has none."""
    if lf.binary:
        return np.zeros(0, dtype=np.uint8), np.zeros((0, 2), dtype=np.int64)
    return empty_column(lf.type).data


def _empty(lf: _Leaf) -> Column:
    """A column of no rows (a file without row groups)."""
    if lf.max_rep:
        return Column(Lists(np.zeros(0, dtype=np.int64),
                            Column(_no_values(lf))))
    return Column(_no_values(lf))


def _spread(lf: _Leaf, vals, valid, n: int, path: str):
    """Non-null values onto the n rows (NULL rows hold 0 or ""), converted
    to the column's in-memory layout."""
    t = lf.type
    if vals is None:
        vals = _no_values(lf)
    if isinstance(vals, Coded):
        if valid is None:
            return vals
        full = np.zeros(n, dtype=np.int32)
        full[valid] = vals.codes
        return Coded(vals.strings, full)
    if lf.binary and not isinstance(vals, tuple):  # FLBA: a byte matrix
        m, w = vals.shape
        ends = np.arange(1, m + 1, dtype=np.int64) * w
        vals = (np.ascontiguousarray(vals).ravel(),
                np.stack([ends - w, ends], axis=1))
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
    elif lf.physical == INT96:
        vals = _int96_us(vals, path, lf.name)
    elif t.kind is T.TypeKind.DATETIME:
        vals = vals.astype(np.int64)
        if lf.ts_div > 1:
            _exact_us(vals, lf.ts_div, path, lf.name)
        vals = (vals // lf.ts_div if lf.ts_div > 0
                else vals * -lf.ts_div)
    else:
        vals = vals.astype(t.np_dtype, copy=False)
    if valid is None:
        return vals
    full = np.zeros((n,) + vals.shape[1:], dtype=vals.dtype)
    full[valid] = vals
    return full


def _exact_us(ns: np.ndarray, div: int, path: str, name: str):
    """The reference casts timestamp[ns] to timestamp[us] with Arrow's safe
    cast, which raises on a sub-microsecond fraction."""
    bad = np.flatnonzero(ns % div)
    if len(bad):
        raise ValueError(
            f"{path}: column {name!r}: Casting from timestamp[ns] to "
            f"timestamp[us] would lose data: {int(ns[bad[0]])}")


def _int96_us(raw: np.ndarray, path: str, name: str) -> np.ndarray:
    """INT96 timestamps (8 bytes of nanoseconds in the day, then the
    Julian day, little-endian) as microseconds since 1970-01-01."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1, 12)
    nanos = raw[:, :8].copy().view("<i8").ravel()
    days = raw[:, 8:].copy().view("<i4").ravel().astype(np.int64)
    ns = (days - _JULIAN_EPOCH) * (_US_PER_DAY * 1000) + nanos
    _exact_us(ns, 1000, path, name)
    return ns // 1000
