"""An ORC reader without pyarrow (the external tables' ORC files).

What it reads is ORC file version 0.12 as pyarrow writes it (by default
uncompressed, strings DIRECT_V2; with a dictionary threshold above 0,
DICTIONARY_V2): a flat struct of BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT,
DOUBLE, STRING/VARCHAR/CHAR, DATE and DECIMAL columns; the PRESENT stream
(boolean RLE); byte RLE; integer RLE v2 with its four sub-encodings; the
NONE, ZLIB and SNAPPY codecs. Another codec (ZSTD, LZ4, LZO), RLE v1
(file version 0.11) or another type raises NotImplementedError naming it
and the file.

The postscript, footer and stripe footers (protobuf) parse here; the loops
over values (snappy, byte RLE, RLE v2) run in host C++
(csrc/host/file_formats.cpp). `schema` and `num_rows` read the footer
alone. Types follow what the reference's `HostTable.from_arrow` makes of
pyarrow's read of the same file (see parquet.py).
"""

from __future__ import annotations

import zlib

import numpy as np

from ... import native
from ... import types as T
from . import Column, concat, decimal_from_ints, empty_column

_CODECS = {0: "NONE", 1: "ZLIB", 2: "SNAPPY", 3: "LZO", 4: "LZ4", 5: "ZSTD"}
# type kinds
(BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, BINARY, TIMESTAMP,
 LIST, MAP, STRUCT, UNION, DECIMAL, DATE, VARCHAR, CHAR) = range(18)
_TYPES = {BOOLEAN: T.BOOLEAN, BYTE: T.TINYINT, SHORT: T.SMALLINT, INT: T.INT,
          LONG: T.BIGINT, FLOAT: T.FLOAT, DOUBLE: T.DOUBLE,
          STRING: T.VARCHAR, VARCHAR: T.VARCHAR, CHAR: T.VARCHAR,
          DATE: T.DATE}
# stream kinds
_PRESENT, _DATA, _LENGTH, _DICTIONARY_DATA, _SECONDARY = 0, 1, 2, 3, 5
# column encodings
_DIRECT, _DICTIONARY, _DIRECT_V2, _DICTIONARY_V2 = 0, 1, 2, 3


def _pb(buf) -> dict:
    """Protobuf message -> {field: [values]}: varints as ints, fixed64 and
    fixed32 as raw bytes, length-delimited fields as bytes."""
    out: dict = {}
    pos, n = 0, len(buf)

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

    while pos < n:
        key = varint()
        field, wt = key >> 3, key & 7
        if wt == 0:
            v = varint()
        elif wt == 1:
            v = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == 2:
            ln = varint()
            v = bytes(buf[pos:pos + ln])
            pos += ln
        elif wt == 5:
            v = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"protobuf: wire type {wt}")
        out.setdefault(field, []).append(v)
    return out


def _packed(values: list) -> list:
    """A repeated varint field, packed or not."""
    out = []
    for v in values:
        if isinstance(v, int):
            out.append(v)
            continue
        pos = 0
        while pos < len(v):
            r = shift = 0
            while True:
                b = v[pos]
                pos += 1
                r |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            out.append(r)
    return out


def _one(msg: dict, field: int, default=None):
    v = msg.get(field)
    return v[-1] if v else default


class OrcFile:
    """One ORC file: `schema` and `num_rows` from its footer; `read()`
    decodes every column."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            fh.seek(max(0, size - 256))
            tail = fh.read()
            if size < 4 or not tail:
                raise ValueError(f"{path}: not an ORC file")
            ps_len = tail[-1]
            ps = _pb(tail[-1 - ps_len:-1])
            if _one(ps, 8000) != b"ORC":
                raise ValueError(f"{path}: not an ORC file")
            self.codec = _one(ps, 2, 0)
            self.block = _one(ps, 3, 256 * 1024)
            version = _packed(ps.get(4, []))
            if version and version[:2] == [0, 11]:
                raise NotImplementedError(
                    f"{path}: ORC file version 0.11 (RLE v1); the port reads "
                    "version 0.12")
            if self.codec not in (0, 1, 2):
                raise NotImplementedError(
                    f"{path}: ORC codec {_CODECS.get(self.codec, self.codec)};"
                    " the port reads NONE, ZLIB and SNAPPY")
            flen = _one(ps, 1)
            fh.seek(size - 1 - ps_len - flen)
            footer = _pb(self._decompress(fh.read(flen)))
        self.num_rows = int(_one(footer, 6, 0))
        self.stripes = [_pb(s) for s in footer.get(3, [])]
        types = [_pb(t) for t in footer.get(4, [])]
        root = types[0] if types else {}
        if _one(root, 1, STRUCT) != STRUCT:
            raise NotImplementedError(f"{path}: root type is not a struct")
        names = [b.decode() for b in root.get(3, [])]
        self.columns = []  # (name, column id, orc kind, LogicalType)
        for name, cid in zip(names, _packed(root.get(2, []))):
            t = types[cid]
            kind = _one(t, 1, 0)
            if kind == DECIMAL:
                lt = T.LogicalType(T.TypeKind.DECIMAL, _one(t, 5, 38),
                                   _one(t, 6, 10))
            elif kind in _TYPES:
                lt = _TYPES[kind]
            else:
                raise NotImplementedError(
                    f"{path}: ORC column {name!r} of kind {kind}")
            self.columns.append((name, cid, kind, lt))

    @property
    def schema(self) -> list:
        """[(name, LogicalType)] in file order."""
        return [(n, lt) for n, _, _, lt in self.columns]

    def _decompress(self, data) -> bytes:
        if self.codec == 0:
            return bytes(data)
        out, pos = [], 0
        while pos < len(data):
            h = data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16
            pos += 3
            ln = h >> 1
            chunk = data[pos:pos + ln]
            pos += ln
            if h & 1:  # stored as is
                out.append(bytes(chunk))
            elif self.codec == 1:
                out.append(zlib.decompress(chunk, -15))
            else:
                out.append(native.snappy_decompress(
                    chunk, self.block).tobytes())
        return b"".join(out)

    def read(self) -> dict:
        """{name: Column} of every row of the file."""
        parts = {n: [] for n, *_ in self.columns}
        with open(self.path, "rb") as fh:
            for st in self.stripes:
                off = _one(st, 1)
                ilen, dlen, flen = _one(st, 2, 0), _one(st, 3, 0), _one(st, 4)
                rows = _one(st, 5)
                fh.seek(off)
                raw = fh.read(ilen + dlen + flen)
                sf = _pb(self._decompress(raw[ilen + dlen:]))
                streams, pos = {}, 0
                for s in sf.get(1, []):
                    m = _pb(s)
                    kind, col, ln = _one(m, 1, 0), _one(m, 2, 0), _one(m, 3, 0)
                    streams[(col, kind)] = (pos, ln)
                    pos += ln
                encs = [_pb(e) for e in sf.get(2, [])]

                def stream(col, kind):
                    at = streams.get((col, kind))
                    if at is None:
                        return None
                    return np.frombuffer(
                        self._decompress(raw[at[0]:at[0] + at[1]]),
                        dtype=np.uint8)

                for name, cid, kind, lt in self.columns:
                    parts[name].append(self._column(
                        name, kind, lt, rows, encs[cid], cid, stream))
        return {n: concat(p) if p else empty_column(lt)
                for (n, _, _, lt), p in zip(self.columns, parts.values())}

    def _column(self, name, kind, lt, rows, enc, cid, stream) -> Column:
        present = stream(cid, _PRESENT)
        valid = None
        if present is not None:
            valid = np.unpackbits(native.orc_byte_rle(
                present, (rows + 7) // 8))[:rows].astype(bool)
        n = rows if valid is None else int(valid.sum())
        ek = _one(enc, 1, _DIRECT)
        data = stream(cid, _DATA)
        if data is None:
            data = np.zeros(0, dtype=np.uint8)
        if kind in (STRING, VARCHAR, CHAR):
            return self._strings(name, ek, enc, n, rows, valid, cid, stream,
                                 data)
        if kind in (SHORT, INT, LONG, DATE) and ek != _DIRECT_V2:
            raise NotImplementedError(
                f"{self.path}: column {name!r}: integer RLE v1")
        if kind == BOOLEAN:
            vals = np.unpackbits(native.orc_byte_rle(
                data, (n + 7) // 8))[:n].astype(bool)
        elif kind == BYTE:
            vals = native.orc_byte_rle(data, n).view(np.int8)
        elif kind in (SHORT, INT, LONG, DATE):
            vals = native.orc_rle_v2(data, n, signed=True)
        elif kind == FLOAT:
            vals = np.frombuffer(data, dtype="<f4", count=n)
        elif kind == DOUBLE:
            vals = np.frombuffer(data, dtype="<f8", count=n)
        else:  # DECIMAL: zigzag varints, then the scale of each value
            scales = native.orc_rle_v2(stream(cid, _SECONDARY), n,
                                       signed=True)
            unscaled = _varints(data, n)
            vals = decimal_from_ints_wide(unscaled, scales, lt)
        vals = (vals if lt.is_decimal or lt.is_decimal128
                else vals.astype(lt.np_dtype))
        if valid is None:
            return Column(vals)
        full = np.zeros((rows,) + vals.shape[1:], dtype=vals.dtype)
        full[valid] = vals
        return Column(full, valid)

    def _strings(self, name, ek, enc, n, rows, valid, cid, stream, data):
        if ek == _DIRECT_V2:
            lens = native.orc_rle_v2(stream(cid, _LENGTH), n, signed=False)
            buf = data
            ends = np.cumsum(lens)
            offs = np.stack([ends - lens, ends], axis=1)
        elif ek == _DICTIONARY_V2:
            k = _one(enc, 2, 0)
            dlens = native.orc_rle_v2(stream(cid, _LENGTH), k, signed=False)
            buf = stream(cid, _DICTIONARY_DATA)
            if buf is None:
                buf = np.zeros(0, dtype=np.uint8)
            ends = np.cumsum(dlens)
            doffs = np.stack([ends - dlens, ends], axis=1)
            idx = native.orc_rle_v2(data, n, signed=False)
            offs = doffs[idx] if k else np.zeros((n, 2), dtype=np.int64)
        else:
            raise NotImplementedError(
                f"{self.path}: column {name!r}: string encoding {ek} (RLE v1)")
        offs = offs.astype(np.int64).reshape(-1, 2)
        if valid is not None:
            full = np.zeros((rows, 2), dtype=np.int64)
            full[valid] = offs
            offs = full
        return Column((buf, offs), valid)


def _varints(data: np.ndarray, n: int) -> list:
    """n zigzag base-128 varints of any width as Python ints (DECIMAL)."""
    out, pos = [], 0
    for _ in range(n):
        r = shift = 0
        while True:
            b = int(data[pos])
            pos += 1
            r |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        out.append((r >> 1) ^ -(r & 1))
    return out


def decimal_from_ints_wide(unscaled: list, scales, lt) -> np.ndarray:
    """ORC DECIMAL values (unscaled ints, each with its own scale) at the
    column's scale, in its in-memory layout."""
    from ...column.host_table import _int_to_dec128

    vals = []
    for v, s in zip(unscaled, np.asarray(scales).tolist()):
        d = lt.scale - int(s)
        vals.append(v * 10 ** d if d >= 0 else v // 10 ** -d)
    if lt.precision <= 18:
        return decimal_from_ints(np.array(vals, dtype=np.int64), 18)
    return np.array([_int_to_dec128(v) for v in vals],
                    dtype=np.int64).reshape(len(vals), 4)
