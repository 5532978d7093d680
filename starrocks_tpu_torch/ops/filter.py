"""Filter & project operators.

Reference behavior: SelectOperator (be/src/exec/pipeline/select_operator.h)
and ProjectOperator (be/src/exec/pipeline/project_operator.h). A filter is
an AND into the chunk's selection mask — no row movement — and projection
evaluates expressions into a fresh chunk, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

from ..column.column import Chunk, Field, Schema
from ..column.dict_encoding import StringDict
from ..exprs.compile import ExprCompiler, as_tensor


def filter_chunk(chunk: Chunk, predicate) -> Chunk:
    mask = ExprCompiler(chunk).eval_predicate(predicate)
    return chunk.and_sel(mask)


def project(chunk: Chunk, exprs, names) -> Chunk:
    """Evaluate `exprs`, producing a chunk with columns `names` (in order)."""
    cc = ExprCompiler(chunk)
    cap = chunk.capacity
    fields, data, valid = [], [], []
    for name, e in zip(names, exprs):
        v = cc.eval(e)
        if v.type.is_string and isinstance(v.data, str):
            # string literal output: one-entry dictionary column
            d, codes = StringDict.from_strings([v.data])
            v = dataclasses.replace(v, data=int(codes[0]), dict=d)
        d = as_tensor(v.data, v.type.dtype, chunk.device)
        # a DECIMAL128 value is rank 2 ([capacity, 4] limbs): already per row
        d = d if d.ndim == 2 else d.expand(cap)
        fields.append(Field(name, v.type, v.valid is not None, v.dict,
                            bounds=v.bounds))
        data.append(d)
        valid.append(None if v.valid is None else v.valid.expand(cap))
    return Chunk(Schema(tuple(fields)), tuple(data), tuple(valid), chunk.sel,
                 chunk.device)
