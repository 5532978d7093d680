"""File formats the port reads (and, for its tests and chip_smoke.py,
writes) without pyarrow: CSV (`Session.load_csv`), parquet and ORC (the
external tables of storage/external.py). Footers and page headers parse in
Python; the loops over values run in host C++ (csrc/host/csv_parse.cpp,
csrc/host/file_formats.cpp, through native.py)."""

from __future__ import annotations

import numpy as np


class Column:
    """One column of one file as a reader decodes it: `data` is a numpy
    array with a row per value, or for a string column (buffer, offsets)
    with one (start, end) pair per row; `valid` is a bool mask, or None
    when the column has no NULL. A NULL row holds 0 (strings: "")."""

    __slots__ = ("data", "valid")

    def __init__(self, data, valid=None):
        self.data = data
        self.valid = valid


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
    if isinstance(parts[0].data, tuple):
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
    valid = None
    if any(p.valid is not None for p in parts):
        valid = np.concatenate([
            p.valid if p.valid is not None else np.ones(_rows(p), dtype=bool)
            for p in parts])
    return Column(data, valid)


def _rows(c: Column) -> int:
    return len(c.data[1]) if isinstance(c.data, tuple) else len(c.data)


def empty_column(lt) -> Column:
    """A Column of no rows of LogicalType `lt`."""
    if lt.is_string:
        return Column((np.zeros(0, dtype=np.uint8),
                       np.zeros((0, 2), dtype=np.int64)))
    if lt.is_decimal128:
        return Column(np.zeros((0, 4), dtype=np.int64))
    return Column(np.zeros(0, dtype=lt.np_dtype))
