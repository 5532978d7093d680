"""Shared operator utilities: key normalization, lexicographic sort,
compaction and the engine's hash.

Reference behavior being re-designed: the hash-table machinery in
be/src/exec/aggregate/agg_hash_map.h and be/src/exec/join/join_hash_map.h.
Grouping/joining is sort-based, exactly as in the JAX package: a stable
lexicographic multi-key sort, segment boundaries, and segment reductions.

Sort semantics are the reference's: `argsort_stable` is jnp.argsort
(stable), `lexsort` is jnp.lexsort (last key primary, ties by index).
"""

from __future__ import annotations

import contextlib

import torch

from ..column.column import Chunk
from ..exprs.compile import EVal, ExprCompiler, as_tensor
from . import dec128 as d128


def eval_keys(chunk: Chunk, key_exprs) -> list:
    cc = ExprCompiler(chunk)
    out = []
    for e in key_exprs:
        v = cc.eval(e)
        if isinstance(v.data, str):
            raise NotImplementedError("string literal keys are not in the port")
        d = as_tensor(v.data, v.type.dtype, chunk.device)
        # a DECIMAL128 key is rank 2: [capacity, 4] limbs
        data = d.expand((chunk.capacity,) + tuple(d.shape[1:]))
        # valid can come back scalar too (nullness from a literal operand):
        # lexsort/boundaries need full rank
        valid = None if v.valid is None else v.valid.expand(chunk.capacity)
        out.append(EVal(data, valid, v.type, v.dict, bounds=v.bounds))
    return out


def argsort_stable(x: torch.Tensor) -> torch.Tensor:
    """jnp.argsort(x, stable=True): ascending, ties keep index order."""
    if x.dtype == torch.bool:
        x = x.to(torch.int8)
    return torch.sort(x, stable=True).indices


def lexsort(keys) -> torch.Tensor:
    """jnp.lexsort(keys): the LAST array is the primary key; rows tied on
    every key keep index order. Chains stable sorts from the least
    significant key to the most significant one."""
    order = None
    for k in keys:
        if order is None:
            order = argsort_stable(k)
        else:
            order = order[argsort_stable(k[order])]
    return order


def key_sort_arrays(keys, live):
    """Build the lexsort operand list for (live-first, then key order).

    Returns list ordered least-significant-first (jnp.lexsort convention:
    the LAST array is the primary key). Dead rows sort last. NULL key values
    sort together (before non-null values of the same column).
    """
    ops = []
    for k in reversed(keys):
        if k.type.is_decimal128:
            ops.extend(d128.sort_ops(k.data, k.valid))
            continue
        ops.append(k.data)
        if k.valid is not None:
            # sort by (is_null, value): nulls form their own cluster
            ops.append((~k.valid).to(torch.int8))
    ops.append((~live).to(torch.int8))  # primary: live rows first
    return ops


def boundaries(keys, live, order):
    """Given sort order (indices), mark rows starting a new group.

    Row 0 of the sorted sequence is new iff live; row i is new iff live and
    any key (value or nullness) differs from row i-1.
    """
    cap = order.shape[0]
    dev = order.device
    live_s = live[order]
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    diff = torch.zeros((cap,), dtype=torch.bool, device=dev)
    for k in keys:
        ks = k.data[order]
        neq = ks[1:] != ks[:-1]
        if neq.ndim > 1:  # rank-2 keys: any limb differs
            neq = neq.any(dim=-1)
        d = torch.cat([one, neq])
        if k.valid is not None:
            vs = k.valid[order]
            dv = torch.cat([one, vs[1:] != vs[:-1]])
            # both NULL -> equal regardless of payload
            both_null = torch.cat([~one, (~vs[1:]) & (~vs[:-1])])
            d = (d & ~both_null) | dv
        diff = diff | d
    return diff & live_s


def scatter_set(size: int, idx: torch.Tensor, values, fill, dtype):
    """`jnp.full((size,), fill).at[idx].set(values, mode="drop")`: indices
    outside [0, size) are dropped. Callers pass unique in-range indices (or
    a value that is equal for every duplicate), as the reference requires.
    Rank-2 values (DECIMAL128 limbs) scatter whole rows."""
    row = tuple(values.shape[1:]) if isinstance(values, torch.Tensor) else ()
    out = torch.full((size + 1,) + row, fill, dtype=dtype, device=idx.device)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    if isinstance(values, torch.Tensor):
        out[idx] = values.to(dtype)
    else:
        out[idx] = torch.tensor(values, dtype=dtype, device=idx.device)
    return out[:size]


def compact(chunk: Chunk, capacity: int | None = None):
    """Gather live rows to the front (stable). Output capacity may shrink.

    Returns (chunk, true_live_count): when true_live_count > out capacity,
    rows were dropped — the host must retry with a larger capacity (same
    overflow contract as hash_aggregate / hash_join_expand).
    """
    out_cap = capacity or chunk.capacity
    live = chunk.sel_mask()
    n = live.sum(dtype=torch.int64)
    # live row i lands at slot rank(i); dead/overflow rows drop
    pos = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int64) - 1
    idx = torch.where(live, pos, out_cap)
    data = tuple(scatter_set(out_cap, idx, d, 0, d.dtype) for d in chunk.data)
    valid = tuple(
        None if v is None else scatter_set(out_cap, idx, v, False, torch.bool)
        for v in chunk.valid
    )
    sel = torch.arange(out_cap, device=chunk.device) < n
    return Chunk(chunk.schema, data, valid, sel, chunk.device), n


# --- the engine's hash --------------------------------------------------------
# uint64 lanes are held as int64 bit patterns: torch has no logical right
# shift (and on the CPU no >> at all) for uint64, and int64 >> is arithmetic,
# so a logical shift masks off the sign-extended high bits. Multiplication,
# xor and addition give the same bits in int64 as in uint64 (wrap-around).


def _wrap64(u: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


MIX_MUL1 = _wrap64(0xBF58476D1CE4E5B9)
MIX_MUL2 = _wrap64(0x94D049BB133111EB)
GOLDEN = _wrap64(0x9E3779B97F4A7C15)


def shr64(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64-held uint64 lanes by 0 < s < 64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over uint64 lanes held as int64 bit patterns;
    bit-identical to the reference's ops/common.mix64 (THE hash of the
    engine: join fingerprints and bloom runtime filters)."""
    z = x.to(torch.int64)
    z = (z ^ shr64(z, 30)) * MIX_MUL1
    z = (z ^ shr64(z, 27)) * MIX_MUL2
    return z ^ shr64(z, 31)


@contextlib.contextmanager
def exact_f32_matmul():
    """Full-f32 matrix products: TF32 keeps 10 mantissa bits and would round
    the segment sums' block partials silently. Pins both torch switches for
    the duration and restores them after."""
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def onehot_blocked(gid, num_groups: int, block: int):
    """[nb, block, G+1] f32 one-hot of gid clipped to [0, G]; id G is the
    spill column that callers discard."""
    g = gid.to(torch.int32).clamp(0, num_groups).reshape(-1, block, 1)
    cols = torch.arange(num_groups + 1, dtype=torch.int32, device=g.device)
    return (g == cols).to(torch.float32)
