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
files. Where the reference merges the files with pyarrow's
`concat_tables` (which also promotes types), the port requires every file
to have the first file's columns and types.
"""

from __future__ import annotations

import glob as _glob
import os

from .. import native
from ..column import Field, HostTable, Schema, StringDict
from .catalog import TableHandle
from .formats import concat
from .formats.orc import OrcFile
from .formats.parquet import ParquetFile

_EXTS = (".parquet", ".orc")


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


def _read_files(files: list) -> HostTable:
    """Every row of `files`, in file order, as one HostTable."""
    readers = [_open(f) for f in files]
    cols = readers[0].schema
    for r in readers[1:]:
        if r.schema != cols:
            raise ValueError(
                f"external files disagree on their columns: {r.path!r} has "
                f"{r.schema}, {readers[0].path!r} has {cols}")
    parts = [r.read() for r in readers]
    fields, arrays, valids = [], {}, {}
    for name, t in cols:
        c = concat([p[name] for p in parts])
        if t.is_string:
            vals, codes = native.dict_encode(*c.data)
            fields.append(Field(name, t, True, StringDict(vals)))
            arrays[name] = codes
        else:
            fields.append(Field(name, t, True))
            arrays[name] = c.data
        if c.valid is not None and not c.valid.all():
            valids[name] = c.valid
    return HostTable(Schema(tuple(fields)), arrays, valids)


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
        self._table = _read_files(files)
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
