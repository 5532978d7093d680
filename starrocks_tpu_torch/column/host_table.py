"""Host-side columnar tables and host<->device conversion.

The host table is the ingest/result-side twin of the device Chunk: numpy
struct-of-arrays with the same schema, unpadded, with VARCHAR kept as dict
codes + a StringDict. Reference analog: result materialization
(be/src/data_sink/result/mysql_result_writer.h:48).

A copy of the JAX package's ``column/host_table.py``: the scalar (rank-1)
types and the wide ones, whose values are rank-2 — DECIMAL(>18) a
[rows, 4] limb matrix (``ops/dec128.py``), ARRAY a [rows, K+1] matrix
(length, then the zero-padded elements; NULL elements are rejected), HLL
and BITMAP fixed-width int8 planes (``ops/sketch.py``). ``to_pylist``
returns the same Python values as the reference's.
"""

from __future__ import annotations

import decimal

import numpy as np
import torch

from ..types import ARRAY, LogicalType, TypeKind, VARCHAR
from .column import Chunk, Field, Schema, chunk_from_arrays
from .dict_encoding import StringDict


class HostTable:
    """Unpadded columnar data on host. arrays[name] is numpy, codes for VARCHAR."""

    def __init__(self, schema: Schema, arrays: dict, valids: dict | None = None):
        self.schema = schema
        self.arrays = {f.name: np.asarray(arrays[f.name]) for f in schema.fields}
        self.valids = {
            k: np.asarray(v, dtype=np.bool_)
            for k, v in (valids or {}).items()
            if v is not None
        }
        lens = {len(a) for a in self.arrays.values()}
        if len(lens) > 1:
            raise ValueError("ragged columns: "
                             f"{ {k: len(v) for k, v in self.arrays.items()} }")

    @property
    def num_rows(self) -> int:
        if not self.arrays:
            return 0
        return len(next(iter(self.arrays.values())))

    # --- construction -------------------------------------------------------
    @classmethod
    def from_pydict(cls, data: dict, types: dict | None = None, nullable=True):
        """Build from {name: list/array}; strings are dict-encoded; None = NULL.

        Fast path: a value may be (StringDict, int32_codes) to skip the
        expensive unique/encode pass (used by data generators).
        """
        types = types or {}
        fields, arrays, valids = [], {}, {}
        # lint: checkpoint-exempt — host columns only (a string column's codes.tolist() is numpy's); column/ sits below the lifecycle layer
        for name, values in data.items():
            if (
                isinstance(values, tuple)
                and len(values) == 2
                and isinstance(values[0], StringDict)
            ):
                d, codes = values
                fields.append(Field(name, VARCHAR, nullable, d))
                arrays[name] = np.asarray(codes, dtype=np.int32)
                continue
            vals = list(values) if not isinstance(values, np.ndarray) else values
            t = types.get(name)
            if (t is not None and t.is_array) or (
                t is None and isinstance(vals, list) and any(
                    isinstance(v, (list, tuple)) for v in vals
                    if v is not None)
            ):
                f, arr, vl = _build_array_column(name, vals, t, nullable)
                fields.append(f)
                arrays[name] = arr
                if vl is not None:
                    valids[name] = vl
                continue
            if t is not None and (t.is_hll or t.is_bitmap):
                arr, vl = _build_plane_column(vals, t)
                fields.append(Field(name, t, nullable))
                arrays[name] = arr
                if vl is not None:
                    valids[name] = vl
                continue
            if t is not None and t.is_decimal128:
                arr, vl = _build_dec128_column(vals, t)
                fields.append(Field(name, t, nullable))
                arrays[name] = arr
                if vl is not None:
                    valids[name] = vl
                continue
            nulls = None
            if isinstance(vals, list) and any(v is None for v in vals):
                nulls = np.array([v is None for v in vals])
                fill = "" if (t is None and any(isinstance(v, str) for v in vals if v is not None)) or (t is not None and t.is_string) else 0
                vals = [fill if v is None else v for v in vals]
            if t is None:
                t = _infer_type(vals)
            if t.is_string:
                d, codes = StringDict.from_strings([str(v) for v in vals])
                fields.append(Field(name, VARCHAR, nullable, d))
                arrays[name] = codes
            else:
                a = np.asarray(vals)
                if t.is_decimal and a.dtype.kind in "iu":
                    # inputs are unscaled logical values; store scaled ints
                    a = a.astype(np.int64) * 10 ** t.scale
                elif t.is_decimal and a.dtype.kind == "f":
                    a = np.round(a * 10 ** t.scale).astype(np.int64)
                elif t.is_decimal and a.dtype.kind == "O":
                    # decimal.Decimal objects: scale EXACTLY (an int64
                    # astype would truncate the fraction away)
                    ctx = decimal.Context(prec=60)
                    a = np.array(
                        [int(decimal.Decimal(str(v)).scaleb(t.scale, ctx)
                             .to_integral_value(decimal.ROUND_HALF_EVEN, ctx))
                         for v in vals], dtype=np.int64)
                elif t.kind is TypeKind.DATE and a.dtype.kind in "UO":
                    a = np.asarray(a, dtype="datetime64[D]").astype(np.int32)
                elif t.kind is TypeKind.DATETIME and a.dtype.kind in "UO":
                    a = np.asarray(a, dtype="datetime64[us]").astype(np.int64)
                arrays[name] = a.astype(t.np_dtype)
                fields.append(Field(name, t, nullable))
            if nulls is not None:
                valids[name] = ~nulls
        return cls(Schema(tuple(fields)), arrays, valids)

    # --- device -------------------------------------------------------------
    def to_chunk(self, capacity: int | None = None, device="cpu") -> Chunk:
        return chunk_from_arrays(
            self.schema, self.arrays, self.valids, self.num_rows, capacity,
            device=device,
        )

    @classmethod
    def from_chunk(cls, chunk: Chunk) -> "HostTable":
        """Pull a device chunk back to host, dropping dead rows. The live
        rows are gathered on the device first, so only they cross to the
        host."""
        sel = chunk.sel_mask()
        idx = torch.nonzero(sel, as_tuple=True)[0]
        arrays, valids = {}, {}
        # lint: checkpoint-exempt — one copy per column of a finished result; the executor polls at executor::fetch_results just before, and column/ sits below the lifecycle layer
        for i, f in enumerate(chunk.schema.fields):
            arrays[f.name] = chunk.data[i][idx].cpu().numpy()
            if chunk.valid[i] is not None:
                valids[f.name] = chunk.valid[i][idx].cpu().numpy()
        return cls(chunk.schema, arrays, valids)

    # --- result materialization --------------------------------------------
    def to_pylist(self) -> list:
        """Rows as python tuples with dicts decoded and NULLs as None."""
        out = []
        cols = []
        for f in self.schema.fields:
            a = self.arrays[f.name]
            v = self.valids.get(f.name)
            if f.type.is_string and f.dict is not None:
                decoded = f.dict.decode(a)
                cols.append((decoded, v, f))
            else:
                cols.append((a, v, f))
        for r in range(self.num_rows):
            row = []
            for a, v, f in cols:
                if v is not None and not v[r]:
                    row.append(None)
                elif f.type.is_array:
                    ln = int(a[r, 0])
                    ev = a[r, 1:1 + ln]
                    et = f.type.elem
                    if et.is_string and f.dict is not None:
                        row.append([str(f.dict.values[int(c)]) for c in ev])
                    elif et.is_float:
                        row.append([float(x) for x in ev])
                    else:
                        row.append([int(x) for x in ev])
                elif f.type.is_hll or f.type.is_bitmap:
                    # opaque binary render, as the reference's (apply
                    # hll_cardinality / bitmap_count for readable output)
                    row.append(np.asarray(a[r], dtype=np.int8).tobytes())
                elif f.type.is_decimal128:
                    # default context rounds to 28 digits; DECIMAL(38) needs
                    # the full width
                    row.append(decimal.Decimal(_dec128_to_int(a[r])).scaleb(
                        -f.type.scale, decimal.Context(prec=60)))
                elif f.type.is_decimal:
                    row.append(int(a[r]) / (10 ** f.type.scale))
                elif f.type.kind is TypeKind.DATE:
                    row.append(
                        np.datetime64(int(a[r]), "D").astype("datetime64[D]").astype(str)
                    )
                elif f.type.kind is TypeKind.DATETIME:
                    row.append(str(np.datetime64(int(a[r]), "us")))
                elif f.type.is_float:
                    row.append(float(a[r]))
                elif f.type.kind is TypeKind.BOOLEAN:
                    row.append(bool(a[r]))
                elif f.type.is_string:
                    row.append(str(a[r]))
                else:
                    row.append(int(a[r]))
            out.append(tuple(row))
        return out


def _infer_type(vals) -> LogicalType:
    a = np.asarray(vals)
    if a.dtype.kind in ("U", "S", "O"):
        return VARCHAR
    return _numpy_to_logical(a.dtype)


def _numpy_to_logical(dt) -> LogicalType:
    dt = np.dtype(dt)
    m = {
        np.dtype(np.bool_): TypeKind.BOOLEAN,
        np.dtype(np.int8): TypeKind.TINYINT,
        np.dtype(np.int16): TypeKind.SMALLINT,
        np.dtype(np.int32): TypeKind.INT,
        np.dtype(np.int64): TypeKind.BIGINT,
        np.dtype(np.uint8): TypeKind.SMALLINT,
        np.dtype(np.uint16): TypeKind.INT,
        np.dtype(np.uint32): TypeKind.BIGINT,
        np.dtype(np.uint64): TypeKind.BIGINT,
        np.dtype(np.float32): TypeKind.FLOAT,
        np.dtype(np.float64): TypeKind.DOUBLE,
    }
    if dt in m:
        return LogicalType(m[dt])
    raise TypeError(f"unsupported numpy dtype {dt}")


# --- DECIMAL128 columns ([n, 4] limb matrices) ------------------------------

_D128_LIMBS = 4


def _int_to_dec128(v: int) -> list:
    """Signed 128-bit int -> 4x32-bit limbs, most significant first, stored
    in int64 lanes (two's complement across the 128-bit value)."""
    u = v & ((1 << 128) - 1)
    return [(u >> (96 - 32 * i)) & 0xFFFFFFFF for i in range(_D128_LIMBS)]


def _dec128_to_int(limbs) -> int:
    u = 0
    for x in np.asarray(limbs).tolist():
        u = (u << 32) | (int(x) & 0xFFFFFFFF)
    if u >= 1 << 127:
        u -= 1 << 128
    return u


def _build_dec128_column(vals, t):
    """DECIMAL(p>18): values (ints = unscaled logical, floats/str/Decimal =
    logical) -> [n, 4] limb matrix."""
    n = len(vals)
    out = np.zeros((n, _D128_LIMBS), dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    scale = 10 ** t.scale
    for i, v in enumerate(vals):
        if v is None:
            valid[i] = False
            continue
        if isinstance(v, (decimal.Decimal, str)):
            # wide context everywhere: the default one rounds EVERY operation
            # (including *) to 28 significant digits
            ctx = decimal.Context(prec=60, rounding=decimal.ROUND_HALF_EVEN)
            scaled = int(decimal.Decimal(str(v)).scaleb(t.scale, ctx)
                         .to_integral_value(decimal.ROUND_HALF_EVEN, ctx))
        elif isinstance(v, float):
            scaled = int(round(v * scale))
        else:
            scaled = int(v) * scale
        out[i] = _int_to_dec128(scaled)
    return out, (None if valid.all() else valid)


# --- ARRAY / HLL / BITMAP columns -------------------------------------------


def _build_array_column(name, vals, t, nullable):
    """list-of-list values -> Field(ARRAY<elem>) + [n, K+1] matrix whose
    column 0 is the LENGTH and 1..K the zero-padded elements."""
    n = len(vals)
    valid = np.ones(n, dtype=bool)
    lists = []
    for i, v in enumerate(vals):
        if v is None:
            valid[i] = False
            lists.append([])
        else:
            lists.append(list(v))
    flat = [x for sub in lists for x in sub if x is not None]
    if any(x is None for sub in lists for x in sub):
        raise NotImplementedError("NULL array elements not supported")
    elem = t.elem if t is not None else _infer_type(flat if flat else [0])
    k = max(max((len(sub) for sub in lists), default=0), 1)
    d = None
    if elem.is_string:
        d, codes = StringDict.from_strings([str(x) for x in flat])
        it = iter(codes.tolist())
        lists = [[next(it) for _ in sub] for sub in lists]
    out = np.zeros((n, k + 1), dtype=elem.np_dtype)
    for i, sub in enumerate(lists):
        out[i, 0] = len(sub)
        if sub:
            out[i, 1:1 + len(sub)] = np.asarray(sub, dtype=elem.np_dtype)
    f = Field(name, ARRAY(elem), nullable, d)
    return f, out, (None if valid.all() else valid)


def _build_plane_column(vals, t):
    """HLL / BITMAP values (bytes or int lists of the type's width) ->
    [n, width] int8 planes."""
    w = t.wide_width
    arr = np.zeros((len(vals), w), dtype=np.int8)
    nulls = np.zeros((len(vals),), dtype=bool)
    for i, v in enumerate(vals):
        if v is None:
            nulls[i] = True
            continue
        b = np.frombuffer(bytes(v), dtype=np.int8) \
            if isinstance(v, (bytes, bytearray)) \
            else np.asarray(v, dtype=np.int8)
        if len(b) != w:
            raise ValueError(f"{t!r} value width {len(b)} != {w}")
        arr[i] = b
    return arr, (~nulls if nulls.any() else None)
