"""An ORC reader without pyarrow (the external tables' ORC files).

What it reads is what pyarrow reads of the ORC files the reference's users
declare: file versions 0.11 and 0.12; a struct of BOOLEAN, BYTE, SHORT,
INT, LONG, FLOAT, DOUBLE, STRING/VARCHAR/CHAR, BINARY, DATE, TIMESTAMP,
DECIMAL and LIST-of-primitive columns; the PRESENT stream (boolean RLE);
byte RLE; integer RLE v1 (the DIRECT and DICTIONARY encodings) and v2 with
its four sub-encodings (DIRECT_V2, DICTIONARY_V2); every codec the ORC
library reads: NONE, ZLIB, SNAPPY, LZO (LZO1X, as the ORC library decodes
it), LZ4 and ZSTD. STRUCT, MAP and UNION columns raise
NotImplementedError naming the feature and the file.

The postscript, footer and stripe footers (protobuf) parse here; the loops
over values (the codecs, byte RLE, RLE v1 and v2) run in host C++
(csrc/host/). `schema` and `num_rows` read the footer alone. Types follow
what the reference's `HostTable.from_arrow` makes of pyarrow's read of the
same file (see parquet.py): TIMESTAMP as microseconds of the writer's
wall-clock time, as the ORC library gives it to pyarrow (a stripe written
in another timezone than GMT/UTC goes through the standard library's
zoneinfo; pyarrow reads nanoseconds, and a sub-microsecond fraction
raises, as the reference's cast does), BINARY as byte ranges and LIST as
Lists.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

from ... import native
from ... import types as T
from . import Column, Lists, Spec, concat, decimal_from_ints, empty_column

_CODECS = {0: "NONE", 1: "ZLIB", 2: "SNAPPY", 3: "LZO", 4: "LZ4", 5: "ZSTD"}
# type kinds
(BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, BINARY, TIMESTAMP,
 LIST, MAP, STRUCT, UNION, DECIMAL, DATE, VARCHAR, CHAR) = range(18)
_KINDS = {MAP: "MAP", STRUCT: "STRUCT", UNION: "UNION"}
_TYPES = {BOOLEAN: T.BOOLEAN, BYTE: T.TINYINT, SHORT: T.SMALLINT, INT: T.INT,
          LONG: T.BIGINT, FLOAT: T.FLOAT, DOUBLE: T.DOUBLE,
          STRING: T.VARCHAR, VARCHAR: T.VARCHAR, CHAR: T.VARCHAR,
          DATE: T.DATE, TIMESTAMP: T.DATETIME,
          BINARY: T.LogicalType(T.TypeKind.BITMAP, 8)}
# the Arrow type pyarrow reads each kind as (files must agree on it)
_KEYS = {BOOLEAN: "bool", BYTE: "int8", SHORT: "int16", INT: "int32",
         LONG: "int64", FLOAT: "float", DOUBLE: "double", STRING: "string",
         VARCHAR: "string", CHAR: "string", DATE: "date32[day]",
         TIMESTAMP: "timestamp[ns]", BINARY: "binary"}
# the element kinds of a LIST's string rendering (external.py)
_ELEM = {STRING: "string", VARCHAR: "string", CHAR: "string",
         BINARY: "binary", DATE: "date", TIMESTAMP: "timestamp",
         DECIMAL: "decimal"}
# stream kinds
_PRESENT, _DATA, _LENGTH, _DICTIONARY_DATA, _SECONDARY = 0, 1, 2, 3, 5
# column encodings
_DIRECT, _DICTIONARY, _DIRECT_V2, _DICTIONARY_V2 = 0, 1, 2, 3
_ORC_EPOCH = 1_420_070_400  # 2015-01-01 00:00:00 UTC, TIMESTAMP's origin
_UTC_NAMES = ("", "GMT", "UTC", "Etc/UTC", "Etc/GMT", "Z", "Zulu",
              "Etc/Universal", "Universal", "Etc/Zulu", "GMT0", "Etc/GMT0")


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
    """One ORC file: `schema`, `specs` and `num_rows` from its footer;
    `read()` decodes every column, adding its seconds to `times`
    (decompress, values) and the bytes its codec gave to
    `times["decompressed_bytes"]`."""

    def __init__(self, path: str):
        self.path = path
        self.times = {"decompress": 0.0, "values": 0.0,
                      "decompressed_bytes": 0}
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
            if self.codec not in _CODECS:
                raise NotImplementedError(
                    f"{path}: ORC codec {self.codec}; the port reads "
                    f"{', '.join(_CODECS.values())}")
            flen = _one(ps, 1)
            fh.seek(size - 1 - ps_len - flen)
            footer = _pb(self._decompress(fh.read(flen)))
        self.num_rows = int(_one(footer, 6, 0))
        self.stripes = [_pb(s) for s in footer.get(3, [])]
        self.types = [_pb(t) for t in footer.get(4, [])]
        root = self.types[0] if self.types else {}
        if _one(root, 1, STRUCT) != STRUCT:
            raise NotImplementedError(f"{path}: root type is not a struct")
        names = [b.decode() for b in root.get(3, [])]
        self.columns = []  # (name, column id)
        self.specs = []
        for name, cid in zip(names, _packed(root.get(2, []))):
            self.specs.append(self._spec(name, cid))
            self.columns.append((name, cid))

    def _kind(self, name: str, cid: int) -> tuple:
        """(orc kind, LogicalType, Arrow key) of a primitive column."""
        t = self.types[cid]
        kind = _one(t, 1, 0)
        if kind == DECIMAL:
            p, s = _one(t, 5, 38), _one(t, 6, 10)
            return (kind, T.LogicalType(T.TypeKind.DECIMAL, p, s),
                    f"decimal128({p}, {s})")
        if kind in _TYPES:
            return kind, _TYPES[kind], _KEYS[kind]
        what = _KINDS.get(kind, f"kind {kind}")
        raise NotImplementedError(f"{self.path}: {what} column {name!r}")

    def _spec(self, name: str, cid: int) -> Spec:
        kind = _one(self.types[cid], 1, 0)
        if kind == LIST:
            child = _packed(self.types[cid].get(2, []))[0]
            ck = _one(self.types[child], 1, 0)
            if ck == LIST:
                raise NotImplementedError(
                    f"{self.path}: LIST of LIST column {name!r}")
            ek, elt, ekey = self._kind(name, child)
            return Spec(name, T.ARRAY(T.BIGINT), f"list<{ekey}>", "list",
                        (_ELEM.get(ek, "value"), elt))
        kind, lt, key = self._kind(name, cid)
        build = ("string" if lt.is_string else
                 "binary" if kind == BINARY else "value")
        return Spec(name, lt, key, build)

    @property
    def schema(self) -> list:
        """[(name, LogicalType)] in file order, as the footer gives them."""
        return [(sp.name, sp.type) for sp in self.specs]

    def _decompress(self, data) -> bytes:
        if self.codec == 0:
            return bytes(data)
        t = time.perf_counter()
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
            elif self.codec == 2:
                out.append(native.snappy_decompress(
                    chunk, self.block).tobytes())
            elif self.codec == 5:
                out.append(native.zstd_decompress(
                    chunk, self.block, exact=False).tobytes())
            elif self.codec == 3:  # LZO: LZO1X blocks, as the ORC library
                try:
                    out.append(native.lzo_decompress(
                        chunk, self.block, exact=False).tobytes())
                except ValueError as e:
                    raise ValueError(f"{self.path}: ORC LZO: {e}") from e
            else:  # LZ4: one raw block per chunk
                out.append(native.lz4_decompress(
                    chunk, self.block, exact=False).tobytes())
        raw = b"".join(out)
        self.times["decompress"] += time.perf_counter() - t
        self.times["decompressed_bytes"] += len(raw)
        return raw

    def read(self) -> dict:
        """{name: Column} of every row of the file."""
        t0 = time.perf_counter()
        d0 = self.times["decompress"]
        parts = {n: [] for n, _ in self.columns}
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
                tz = (_one(sf, 3) or b"").decode()

                def stream(col, kind):
                    at = streams.get((col, kind))
                    if at is None:
                        return None
                    return np.frombuffer(
                        self._decompress(raw[at[0]:at[0] + at[1]]),
                        dtype=np.uint8)

                for name, cid in self.columns:
                    parts[name].append(self._column(
                        name, cid, rows, encs, stream, tz))
        out = {}
        for (n, cid), sp in zip(self.columns, self.specs):
            p = parts[n]
            out[n] = concat(p) if p else _empty(sp)
        self.times["values"] += (time.perf_counter() - t0
                                 - (self.times["decompress"] - d0))
        return out

    def _column(self, name, cid, rows, encs, stream, tz) -> Column:
        present = stream(cid, _PRESENT)
        valid = None
        if present is not None:
            valid = np.unpackbits(native.orc_byte_rle(
                present, (rows + 7) // 8))[:rows].astype(bool)
        n = rows if valid is None else int(valid.sum())
        enc = encs[cid]
        ek = _one(enc, 1, _DIRECT)
        v2 = ek in (_DIRECT_V2, _DICTIONARY_V2)

        def ints(data, count, signed):
            if data is None:
                data = np.zeros(0, dtype=np.uint8)
            if v2:
                return native.orc_rle_v2(data, count, signed=signed)
            return native.orc_rle_v1(data, count, signed=signed)

        if _one(self.types[cid], 1, 0) == LIST:
            lengths = ints(stream(cid, _LENGTH), n, False)
            child = _packed(self.types[cid].get(2, []))[0]
            elems = self._column(name, child, int(lengths.sum()), encs,
                                 stream, tz)
            if elems.valid is not None and not elems.valid.all():
                raise NotImplementedError(
                    "NULL array elements not supported")
            if valid is not None:
                full = np.zeros(rows, dtype=np.int64)
                full[valid] = lengths
                lengths = full
            return Column(Lists(lengths.astype(np.int64),
                                Column(elems.data)), valid)
        kind, lt, _ = self._kind(name, cid)
        data = stream(cid, _DATA)
        if data is None:
            data = np.zeros(0, dtype=np.uint8)
        if kind in (STRING, VARCHAR, CHAR, BINARY):
            return self._strings(name, ek, enc, n, rows, valid, cid, stream,
                                 data, ints)
        if kind == BOOLEAN:
            vals = np.unpackbits(native.orc_byte_rle(
                data, (n + 7) // 8))[:n].astype(bool)
        elif kind == BYTE:
            vals = native.orc_byte_rle(data, n).view(np.int8)
        elif kind in (SHORT, INT, LONG, DATE):
            vals = ints(data, n, True)
        elif kind == FLOAT:
            vals = np.frombuffer(data, dtype="<f4", count=n)
        elif kind == DOUBLE:
            vals = np.frombuffer(data, dtype="<f8", count=n)
        elif kind == TIMESTAMP:
            vals = self._timestamps(name, ints(data, n, True),
                                    ints(stream(cid, _SECONDARY), n, False),
                                    tz)
        else:  # DECIMAL: zigzag varints, then the scale of each value
            scales = ints(stream(cid, _SECONDARY), n, True)
            vals = _decimals(data, scales, lt, n)
        vals = (vals if lt.is_decimal or lt.is_decimal128
                else vals.astype(lt.np_dtype))
        if valid is None:
            return Column(vals)
        full = np.zeros((rows,) + vals.shape[1:], dtype=vals.dtype)
        full[valid] = vals
        return Column(full, valid)

    def _timestamps(self, name, secs, nanos, tz) -> np.ndarray:
        """TIMESTAMP values as microseconds since 1970-01-01: seconds from
        2015-01-01 in the writer's timezone, read as the ORC library reads
        them for a GMT reader (the writer's wall-clock time), nanoseconds
        with their count of trailing zeros in the low 3 bits."""
        nanos = nanos.astype(np.int64)
        zeros = nanos & 7
        nanos = nanos >> 3
        scale = np.where(zeros > 0, 10 ** (zeros + 1), 1)
        nanos = nanos * scale
        secs = secs.astype(np.int64)
        if tz in _UTC_NAMES:
            secs = secs + _ORC_EPOCH
        else:
            secs = _wall_clock(secs, tz, self.path, name)
        secs = secs - ((secs < 0) & (nanos > 999_999))
        ns = secs * 1_000_000_000 + nanos
        bad = np.flatnonzero(ns % 1000)
        if len(bad):
            raise ValueError(
                f"{self.path}: column {name!r}: Casting from timestamp[ns] "
                f"to timestamp[us] would lose data: {int(ns[bad[0]])}")
        return ns // 1000

    def _strings(self, name, ek, enc, n, rows, valid, cid, stream, data,
                 ints):
        if ek in (_DIRECT, _DIRECT_V2):
            lens = ints(stream(cid, _LENGTH), n, False)
            buf = data
            ends = np.cumsum(lens)
            offs = np.stack([ends - lens, ends], axis=1)
        else:
            k = _one(enc, 2, 0)
            dlens = ints(stream(cid, _LENGTH), k, False)
            buf = stream(cid, _DICTIONARY_DATA)
            if buf is None:
                buf = np.zeros(0, dtype=np.uint8)
            ends = np.cumsum(dlens)
            doffs = np.stack([ends - dlens, ends], axis=1)
            idx = ints(data, n, False)
            offs = doffs[idx] if k else np.zeros((n, 2), dtype=np.int64)
        offs = offs.astype(np.int64).reshape(-1, 2)
        if valid is not None:
            full = np.zeros((rows, 2), dtype=np.int64)
            full[valid] = offs
            offs = full
        return Column((buf, offs), valid)


def _empty(spec: Spec) -> Column:
    """A column of no rows (a file without stripes)."""
    if spec.build == "list":
        kind, elt = spec.elem
        return Column(Lists(np.zeros(0, dtype=np.int64),
                            _empty(Spec("", elt, "", kind))))
    if spec.build == "binary":
        return Column((np.zeros(0, dtype=np.uint8),
                       np.zeros((0, 2), dtype=np.int64)))
    return empty_column(spec.type)


def _wall_clock(secs: np.ndarray, tz: str, path: str, name: str):
    """ORC TIMESTAMP seconds of a writer in timezone `tz` as the ORC
    library gives them to a GMT reader: the instant is the seconds after
    2015-01-01 00:00 in `tz`, and the result that instant's wall-clock
    time in `tz`, as seconds since 1970-01-01. Offsets are looked up once
    per hour of the data (per value in an hour that holds a change)."""
    import datetime
    import zoneinfo

    try:
        zone = zoneinfo.ZoneInfo(tz)
    except (zoneinfo.ZoneInfoNotFoundError, ValueError) as e:
        raise NotImplementedError(
            f"{path}: column {name!r}: TIMESTAMP written in timezone "
            f"{tz!r}, which this machine's timezone database lacks") from e

    def offset(t: int) -> int:
        when = datetime.datetime.fromtimestamp(t, datetime.timezone.utc)
        return int(when.astimezone(zone).utcoffset().total_seconds())

    instants = secs + (_ORC_EPOCH - offset(_ORC_EPOCH))
    hours, inv = np.unique(instants // 3600, return_inverse=True)
    first = np.array([offset(int(h) * 3600) for h in hours], dtype=np.int64)
    last = np.array([offset(int(h) * 3600 + 3599) for h in hours],
                    dtype=np.int64)
    offs = first[inv]
    for b in np.flatnonzero(first != last):
        rows = np.flatnonzero(inv == b)
        offs[rows] = [offset(int(t)) for t in instants[rows]]
    return instants + offs


def _decimals(data: np.ndarray, scales, lt, n: int) -> np.ndarray:
    """ORC DECIMAL values (zigzag varints of up to 128 bits, each with its
    own scale) at the column's scale, in its in-memory layout."""
    hi, lo = native.orc_varints(data, n)
    d = lt.scale - np.asarray(scales, dtype=np.int64)
    fits = (hi == (lo >> 63)).all()  # every value within int64
    if lt.precision <= 18 and fits and (np.abs(d) <= 18).all():
        if not d.any():
            return lo
        up = np.where(d > 0, 10 ** np.clip(d, 0, 18), 1)
        down = np.where(d < 0, 10 ** np.clip(-d, 0, 18), 1)
        return lo * up // down
    from ...column.host_table import _int_to_dec128

    vals = []
    for h, v, s in zip(*(np.asarray(a).tolist() for a in (hi, lo, d))):
        x = (h << 64) | (v & ((1 << 64) - 1))
        x = x * 10 ** s if s >= 0 else x // 10 ** -s
        vals.append(x)
    if lt.precision <= 18:
        return decimal_from_ints(np.array(vals, dtype=np.int64), 18)
    return np.array([_int_to_dec128(v) for v in vals],
                    dtype=np.int64).reshape(len(vals), 4)
