"""Read-only external tables: parquet and ORC files (the connector
framework's file axis).

Reference behavior: the connector SPI + file external tables
(be/src/connector/, fe/fe-core/.../connector/, the ORC reader
be/src/formats/orc/ — federation over files the engine does not own).
Re-designed to the engine's host-table model: an external table is a
parquet/ORC directory/glob whose schema is read from file footers; data
loads lazily through the same HostTable path as native tables, so every
operator (joins, aggregates, MV definitions, sketches) works unchanged.
Formats detect per file by extension. Writes are rejected — the files
belong to someone else.

A copy of the JAX package's storage/external.py. The reference reads the
files through pyarrow; the port reads them with its own readers
(storage/formats/parquet.py, orc.py), which give the columns, validity
masks and types the reference's `HostTable.from_arrow` makes of the same
files. Files are merged as the reference's `pa.concat_tables(...,
promote_options="default")` merges them: columns by name, in the order the
files first show them; a column a file lacks reads as NULL there; a column
whose type differs from file to file raises TypeError, as Arrow does.
Binary columns become BITMAP and LIST columns ARRAY, as `from_arrow` makes
them. The files decode on up to 8 threads (the decoders release the
interpreter lock); `read_stats` of a handle keeps the seconds and the
decompressed bytes of its last load.
"""

from __future__ import annotations

import concurrent.futures as cf
import datetime
import decimal
import glob as _glob
import os
import time

import numpy as np

from .. import native
from .. import types as T
from ..column import Field, HostTable, Schema, StringDict
from ..column.host_table import _dec128_to_int
from .catalog import TableHandle
from .formats import Column, Lists, concat, null_like
from .formats.orc import OrcFile
from .formats.parquet import ParquetFile

_EXTS = (".parquet", ".orc")
_THREADS = min(os.cpu_count() or 1, 8)


def _resolve(path: str) -> list:
    if any(ch in path for ch in "*?["):
        files = sorted(_glob.glob(path))
    elif os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(_EXTS))
    else:
        files = [path]
    return [f for f in files if os.path.isfile(f)]


def _open(path: str):
    return OrcFile(path) if path.endswith(".orc") else ParquetFile(path)


def _file_schema(path: str) -> Schema:
    """Schema from the footer only (no data IO)."""
    return Schema(tuple(
        Field(n, t, True, StringDict.from_values([]) if t.is_string else None)
        for n, t in _open(path).schema))


def _file_rows(path: str) -> int:
    return _open(path).num_rows


def _merged_specs(readers: list) -> list:
    """The columns of every file: the first file's order, then each column
    another file adds, in the order it shows them; a column's Arrow type
    must agree from file to file (pa.concat_tables with promote_options
    "default")."""
    specs: dict = {}
    for r in readers:
        for sp in r.specs:
            have = specs.get(sp.name)
            if have is None:
                specs[sp.name] = sp
            elif have.key != sp.key:
                raise TypeError(
                    f"Unable to merge: Field {sp.name} has incompatible "
                    f"types: {have.key} vs {sp.key} ({r.path!r})")
    return list(specs.values())


def _read_files(files: list, stats: dict | None = None) -> HostTable:
    """Every row of `files`, in file order, as one HostTable. `stats`, when
    given, gets the seconds spent: decompress and values summed over the
    files (thread-seconds), dictionaries (the string dictionaries and the
    ARRAY/BITMAP matrices) and wall; and the bytes the codecs gave
    (footers included)."""
    t0 = time.perf_counter()
    readers = [_open(f) for f in files]
    specs = _merged_specs(readers)
    if len(readers) > 1:
        with cf.ThreadPoolExecutor(min(_THREADS, len(readers))) as ex:
            parts = list(ex.map(lambda r: r.read(), readers))
    else:
        parts = [r.read() for r in readers]
    t1 = time.perf_counter()
    fields, arrays, valids = [], {}, {}
    for sp in specs:
        like = next(p[sp.name] for p in parts if sp.name in p)
        c = concat([p[sp.name] if sp.name in p
                    else null_like(like, r.num_rows)
                    for p, r in zip(parts, readers)])
        f, a, v = _build(sp, c)
        fields.append(f)
        arrays[sp.name] = a
        if v is not None and not v.all():
            valids[sp.name] = v
    if stats is not None:
        stats.update(
            files=len(files),
            decompress_s=sum(r.times["decompress"] for r in readers),
            values_s=sum(r.times["values"] for r in readers),
            decompressed_bytes=sum(r.times["decompressed_bytes"]
                                   for r in readers),
            dict_s=time.perf_counter() - t1,
            wall_s=time.perf_counter() - t0)
    return HostTable(Schema(tuple(fields)), arrays, valids)


def _build(sp, c: Column) -> tuple:
    """(Field, array, valid) of one merged column, as from_arrow makes
    it."""
    name, t = sp.name, sp.type
    if sp.build == "string":
        vals, codes = native.dict_encode(*c.data)
        return Field(name, t, True, StringDict(vals)), codes, c.valid
    if sp.build == "binary":
        return _bitmap(name, c)
    if sp.build == "list":
        return _array(name, sp.elem, c)
    return Field(name, t, True), c.data, c.valid


def _bitmap(name: str, c: Column) -> tuple:
    """A binary column as from_arrow makes it: BITMAP of 8 x the longest
    value's bytes, an int8 row per value; a value of one byte fills its
    row and one of another length raises (numpy's broadcast of the
    reference's row assignment)."""
    buf, offs = c.data
    n = len(offs)
    lens = offs[:, 1] - offs[:, 0]
    live = np.ones(n, dtype=bool) if c.valid is None else c.valid
    w = int(lens[live].max()) if live.any() else 1
    odd = live & (lens != w) & (lens != 1)
    if odd.any():
        raise ValueError(
            f"could not broadcast input array from shape "
            f"({int(lens[odd][0])},) into shape ({w},)")
    mat = np.zeros((n, w), dtype=np.int8)
    full = np.flatnonzero(live & (lens == w))
    if len(full) and w:
        idx = offs[full, 0][:, None] + np.arange(w)
        mat[full] = np.asarray(buf, dtype=np.uint8)[idx].view(np.int8)
    one = np.flatnonzero(live & (lens == 1) & (lens != w))
    if len(one):
        mat[one] = np.asarray(buf, dtype=np.uint8)[offs[one, 0]].view(
            np.int8)[:, None]
    f = Field(name, T.LogicalType(T.TypeKind.BITMAP, w * 8), True)
    return f, mat, c.valid


def _array(name: str, elem: tuple, c: Column) -> tuple:
    """A LIST column as from_arrow makes it (`_build_array_column`): a
    [n, K+1] matrix of the element type, the length in column 0 and the
    elements from column 1 (K the longest list, at least 1); the element
    type is what numpy infers of the Python values (integers BIGINT,
    floats DOUBLE, booleans BOOLEAN, strings VARCHAR with a dictionary,
    and the values pyarrow gives as other Python objects their str() as
    VARCHAR); no element at all gives BIGINT."""
    kind, lt = elem
    lists: Lists = c.data
    lengths = lists.lengths
    n = len(lengths)
    total = int(lengths.sum())
    d = None
    if total == 0:
        et, vals = T.BIGINT, np.zeros(0, dtype=np.int64)
    elif kind == "string":
        uniq, vals = native.dict_encode(*lists.elems.data)
        et, d = T.VARCHAR, StringDict(uniq)
    elif kind == "value":
        vals = lists.elems.data
        et = (T.DOUBLE if lt.is_float else T.BOOLEAN
              if lt.kind is T.TypeKind.BOOLEAN else T.BIGINT)
    else:
        d, vals = StringDict.from_strings(_as_text(kind, lt, lists.elems))
        et = T.VARCHAR
    k = max(int(lengths.max()) if n else 0, 1)
    at = T.ARRAY(et)
    out = np.zeros((n, k + 1), dtype=et.np_dtype)
    out[:, 0] = lengths
    if total:
        row = np.repeat(np.arange(n), lengths)
        col = 1 + np.arange(total) - np.repeat(np.cumsum(lengths) - lengths,
                                               lengths)
        out[row, col] = vals
    return Field(name, at, True, d), out, c.valid


def _as_text(kind: str, lt, elems: Column) -> list:
    """str() of each element as pyarrow's to_pylist gives it."""
    data = elems.data
    if kind == "binary":
        if not isinstance(data, tuple):  # a fixed-width byte matrix
            return [str(bytes(r)) for r in np.asarray(data, dtype=np.uint8)]
        buf, offs = data
        return [str(bytes(buf[s:e])) for s, e in offs]
    if kind == "date":
        day0 = datetime.date(1970, 1, 1)
        return [str(day0 + datetime.timedelta(days=int(v))) for v in data]
    if kind in ("timestamp", "timestamp_tz"):
        tz = datetime.timezone.utc if kind == "timestamp_tz" else None
        base = datetime.datetime(1970, 1, 1, tzinfo=tz)
        return [str(base + datetime.timedelta(microseconds=int(v)))
                for v in data]
    if kind == "decimal":
        ctx = decimal.Context(prec=60)
        ints = ([_dec128_to_int(r) for r in data] if lt.is_decimal128
                else [int(v) for v in data])
        return [str(decimal.Decimal(v).scaleb(-lt.scale, ctx)) for v in ints]
    raise NotImplementedError(f"LIST of {kind} elements")


class ExternalTableHandle(TableHandle):
    """Catalog handle over foreign parquet files: schema from footers,
    row counts from metadata (no data IO), lazy full load on first scan."""

    def __init__(self, name: str, location: str):
        if not _resolve(location):
            raise ValueError(f"no parquet/ORC files match {location!r}")
        super().__init__(name, None)
        self.location = location
        self._schema: Schema | None = None
        self._meta_rows: int | None = None
        self._loaded_version = None  # data_version() the table was read at
        self.read_stats: dict = {}  # the last load's split (_read_files)

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            # footers only: DESCRIBE/information_schema must not read data
            files = _resolve(self.location)
            if not files:
                raise ValueError(
                    f"no parquet/ORC files match {self.location!r}")
            self._schema = _file_schema(files[0])
        return self._schema

    @property
    def table(self) -> HostTable:
        if self._table is None:
            self._load()
        return self._table

    @property
    def row_count(self) -> int:
        if self._table is not None:
            return self._table.num_rows
        if self._meta_rows is None:  # cached: footer IO is per-file
            self._meta_rows = sum(
                _file_rows(f) for f in _resolve(self.location))
        return self._meta_rows

    def _load(self):
        files = _resolve(self.location)  # fresh: the dir may have changed
        if not files:
            raise ValueError(f"no parquet/ORC files match {self.location!r}")
        version = self.data_version()
        self.read_stats = {}
        self._table = _read_files(files, self.read_stats)
        self._schema = self._table.schema
        self._loaded_version = version

    def data_version(self) -> tuple:
        """Content token from the file set's stat signatures (mtime+size
        per file): the engine does not own these files, so cache validity
        must come from the filesystem, not the catalog's DML clock. The
        image checkpoint records external defs with the same tokens so a
        restore and a live catalog agree on data versions."""
        sig = []
        for f in _resolve(self.location):
            try:
                st = os.stat(f)
                sig.append((f, st.st_mtime_ns, st.st_size))
            except OSError:
                sig.append((f, None, None))
        return ("ext", tuple(sig))

    def stale(self) -> bool:
        """Whether the files changed (stat signatures) since the loaded
        data was read: the executor then drops it and every cache entry
        derived from it before the next query plans."""
        return (self._table is not None
                and self._loaded_version != self.data_version())

    def invalidate(self):
        # external data may change underneath; a refresh re-resolves the
        # file set and re-reads footers/data
        self._table = None
        self._schema = None
        self._meta_rows = None
        self._stats = {}
