"""Set operations: UNION ALL chunk concatenation.

Reference behavior: be/src/exec/union_node.h + pipeline union operators —
concatenate child outputs positionally. The JAX package's design: padded
chunks concatenate whole (their selection masks with them), string
dictionaries merge through constant remap gathers, and mismatched numeric
children coerce to their common supertype (_widen — the implicit set-op
cast lattice; a DECIMAL(38) child widens the other side to 128-bit limbs
at the larger scale, _widen128). UNION (distinct), INTERSECT and EXCEPT reach this operator
through the planner's rewrites onto UNION ALL.
"""

from __future__ import annotations

import torch

from ..column.column import Chunk, Field, Schema
from ..exprs.compile import div_scalar
from ..types import DECIMAL, DOUBLE, TypeKind, common_numeric_type
from . import dec128 as d128


def _widen(d, t, out):
    """Re-represent column data of logical type `t` as logical type `out`
    (the implicit set-op cast: int widening, decimal rescale, de-scale to
    DOUBLE). Mirrors the reference's implicit cast on set operations
    (fe sql/analyzer/SetOperationAnalyzer: children coerce to a common
    type)."""
    if t == out:
        return d
    if out.is_decimal:
        scale = (out.scale or 0) - ((t.scale or 0) if t.is_decimal else 0)
        return d.to(torch.int64) * (10 ** scale)
    if out.is_float and t.is_decimal:
        return div_scalar(d.to(out.dtype), 10 ** (t.scale or 0))
    return d.to(out.dtype)


def _common128(a, b):
    """The set-op type of two numerics one of which is DECIMAL(38): DOUBLE
    against a float, else DECIMAL(38, the larger scale)."""
    for t in (a, b):
        if not (t.is_decimal128 or t.is_numeric or t.kind is TypeKind.NULL):
            raise TypeError(f"UNION type mismatch: {a} and {b}")
    if a.is_float or b.is_float:
        return DOUBLE
    return DECIMAL(38, max(t.scale or 0 for t in (a, b)
                           if t.is_decimal or t.is_decimal128))


def _widen128(d, t, out):
    """Column data of type `t` as `out` from `_common128`: 4x32-bit limbs
    rescaled to `out`'s scale, or a DECIMAL(38)'s value as DOUBLE."""
    if out.is_float:
        if t.is_decimal128:
            return div_scalar(d128.to_f64(d), 10 ** (t.scale or 0))
        return _widen(d, t, out)
    if not t.is_decimal128:
        d = d128.from_i64(d.to(torch.int64))
    scale = (t.scale or 0) if (t.is_decimal or t.is_decimal128) else 0
    return d128.rescale(d, (out.scale or 0) - scale)


def _remap(d, remap, n: int):
    """Dictionary codes `d` re-coded through `remap` (codes clamp into the
    old dictionary, as the reference's gather does)."""
    if not n:
        return d
    lut = torch.from_numpy(remap).to(d.device)
    return lut[d.to(torch.int64).clamp(0, n - 1)].to(d.dtype)


def union_all(a: Chunk, b: Chunk) -> Chunk:
    """Concatenate two chunks positionally; output names follow `a`."""
    if len(a.schema) != len(b.schema):
        raise ValueError("UNION arity mismatch")
    fields, data, valid = [], [], []
    for i, (fa, fb) in enumerate(zip(a.schema.fields, b.schema.fields)):
        da, db = a.data[i], b.data[i]
        va, vb = a.valid[i], b.valid[i]
        dict_ = fa.dict
        out_t = fa.type
        if fa.type.is_string or fb.type.is_string:
            if not (fa.type.is_string and fb.type.is_string):
                raise TypeError("UNION type mismatch")
            if (fa.dict is not None and fb.dict is not None
                    and fa.dict is not fb.dict):
                merged, ra, rb = fa.dict.merge(fb.dict)
                da = _remap(da, ra, len(fa.dict))
                db = _remap(db, rb, len(fb.dict))
                dict_ = merged
        elif fa.type.is_decimal128 or fb.type.is_decimal128:
            if fa.type != fb.type:
                out_t = _common128(fa.type, fb.type)
                da = _widen128(da, fa.type, out_t)
                db = _widen128(db, fb.type, out_t)
        elif fa.type != fb.type or da.dtype != db.dtype:
            out_t = common_numeric_type(fa.type, fb.type)
            da = _widen(da, fa.type, out_t)
            db = _widen(db, fb.type, out_t)
        data.append(torch.cat([da, db]))
        if va is None and vb is None:
            valid.append(None)
        else:
            valid.append(torch.cat([
                torch.ones((a.capacity,), dtype=torch.bool, device=a.device)
                if va is None else va,
                torch.ones((b.capacity,), dtype=torch.bool, device=b.device)
                if vb is None else vb]))
        fields.append(Field(fa.name, out_t, True, dict_))
    sel = torch.cat([a.sel_mask(), b.sel_mask()])
    return Chunk(Schema(tuple(fields)), tuple(data), tuple(valid), sel,
                 a.device)


def concat_many(chunks) -> Chunk:
    """Concatenate k same-schema chunks with ONE concatenation per column
    (the O(k) merge for batched/spill partial states)."""
    chunks = list(chunks)
    if len(chunks) == 1:
        return chunks[0]
    first = chunks[0]
    for c in chunks[1:]:
        if len(c.schema) != len(first.schema):
            raise ValueError("concat arity mismatch")
    fields, data, valid = [], [], []
    for i, f in enumerate(first.schema.fields):
        dicts = {id(c.schema.fields[i].dict) for c in chunks}
        if f.type.is_string and len(dicts) > 1:
            # differing dictionaries: merge pairwise
            out = chunks[0]
            for c in chunks[1:]:
                out = union_all(out, c)
            return out
        data.append(torch.cat([c.data[i] for c in chunks]))
        if all(c.valid[i] is None for c in chunks):
            valid.append(None)
        else:
            valid.append(torch.cat([
                c.valid[i] if c.valid[i] is not None
                else torch.ones((c.capacity,), dtype=torch.bool,
                                device=c.device)
                for c in chunks
            ]))
        fields.append(f)
    sel = torch.cat([c.sel_mask() for c in chunks])
    return Chunk(Schema(tuple(fields)), tuple(data), tuple(valid), sel,
                 first.device)
