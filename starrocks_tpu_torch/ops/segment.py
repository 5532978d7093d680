"""Segment reductions (the aggregation substrate).

The JAX package's strategies, picked in its order per dtype, group count
and sortedness (ops/segment.py there):

1. **One-hot limb matmul** — integer sums over at most 1024 groups. Values
   split into 8-bit limbs; each limb is summed per group and per row block
   with an f32 one-hot product whose block partials stay below 2^24 (exact
   in f32), then the partials add up as int64 and the limbs recombine with
   wrap-around — exact mod 2^64, like an int64 accumulator.
2. **Broadcast-reduce** — float sums and min/max over at most 64 groups:
   out[g] = reduce(where(gid == g, vals, identity)).
3. **Sorted tricks** — group-sorted rows: integer sums as prefix-sum
   differences at the group bounds; float sums and min/max as a segmented
   scan that restarts at each group, read at the group ends.
4. **The segment-sum kernel** — float sums over at most 1024 groups under
   `segment_strategy = 'pallas'` (ops/kernels.segment_sum, CUDA on the
   card): f32 block partials added in block order.
5. Plain scatters (`index_add_`, `scatter_reduce_`) for the rest.

`segment_strategy`: `auto` and `scatter` take the scatters on every device
(the reference's CPU choice, kept on the card); `mxu` takes 1-3 and
`pallas` 1-4 where their shapes allow; `native` (the reference's C++ host
kernel) raises.

XLA never materialises the reference's one-hot and broadcast operands;
eager torch would (a [60M, 1025] f32 one-hot is 246 GB), so strategies 1
and 2 walk the rows in slabs whose operand stays within SLAB_BYTES.

Semantics are jax.ops.segment_*'s: group ids outside [0, num_groups) are
dropped, and empty groups hold the reduction identity (0 for sums; for
min/max the dtype's extreme under the scatters, `identity` under the
scatter-free strategies — callers mask empty groups either way).
"""

from __future__ import annotations

import torch

from .common import exact_f32_matmul, onehot_blocked

_LIMB_BITS = 8
_LIMB_MASK = (1 << _LIMB_BITS) - 1
# per-block partial sums must stay exactly representable in f32:
# block * limb_max <= 2^24  ->  block <= 2^24 / 255  ->  32768 is safe.
_MAX_BLOCK = 32768
# the reference's `matmul_segsum_groups_max` / `bcast_segreduce_groups_max`
# at their defaults
_MATMUL_GROUPS_MAX = 1024
_BCAST_GROUPS_MAX = 64
# largest one-hot / broadcast operand a strategy materialises at once
SLAB_BYTES = 1 << 30


def _strategy() -> str:
    """The segment strategy in force. `native` selects the executor's host
    filter-sum lane for the queries it fits; every other reduction runs as
    under `scatter`, as in the reference (its `_use_mxu` is False there)."""
    from ..runtime.config import config

    s = config.get("segment_strategy")
    if s == "native":
        return "scatter"
    if s not in ("auto", "scatter", "mxu", "pallas"):
        raise ValueError(
            f"unknown segment_strategy {s!r} "
            "(auto | scatter | mxu | pallas | native)")
    return s


def _use_mxu() -> bool:
    """True for the scatter-free strategies (`mxu`, `pallas`)."""
    return _strategy() in ("mxu", "pallas")


def _block_of(n: int) -> int:
    """Largest power-of-two divisor of n, capped at _MAX_BLOCK."""
    return min(n & -n, _MAX_BLOCK)


def _group_index(gid, num_groups: int):
    """gid as int64 with out-of-range ids parked in the spill slot G."""
    g = gid.to(torch.int64)
    return torch.where((g >= 0) & (g < num_groups), g, num_groups)


def _slab_rows(n: int, row_bytes: int, block: int = 1) -> int:
    """Rows per slab: whole blocks, the operand within SLAB_BYTES."""
    blocks = max(1, SLAB_BYTES // max(row_bytes * block, 1))
    return min(n, blocks * block)


def _seg_sum_int_matmul(vals, gid, num_groups: int, nbits: int):
    """Exact (mod 2^64) integer segment sums through f32 one-hot products,
    one slab of whole blocks at a time."""
    n = vals.shape[0]
    block = _block_of(n)
    nlimbs = max(1, (nbits + _LIMB_BITS - 1) // _LIMB_BITS)
    step = _slab_rows(n, (num_groups + 1) * 4, block)
    tot = torch.zeros((num_groups + 1, nlimbs), dtype=torch.int64,
                      device=vals.device)
    with exact_f32_matmul():
        for r0 in range(0, n, step):
            v = vals[r0:r0 + step]
            # int64 >> is arithmetic; the mask makes each limb the
            # reference's logical-shift limb
            limbs = torch.stack(
                [((v >> (_LIMB_BITS * j)) & _LIMB_MASK).to(torch.float32)
                 for j in range(nlimbs)], dim=-1).reshape(-1, block, nlimbs)
            oh = onehot_blocked(gid[r0:r0 + step], num_groups, block)
            # [nb, G+1, L] — each element an integer < 2^24, exact in f32
            part = torch.bmm(oh.transpose(1, 2), limbs)
            tot += part.to(torch.int64).sum(dim=0)
    out = torch.zeros((num_groups + 1,), dtype=torch.int64, device=vals.device)
    for j in range(nlimbs):
        out = out + (tot[:, j] << (_LIMB_BITS * j))  # wraps mod 2^64
    return out[:num_groups]


def _seg_bcast(vals, gid, num_groups: int, fill, reduce, combine):
    """reduce(where(gid == g, vals, fill)) over rows, per group, in slabs."""
    n = vals.shape[0]
    step = _slab_rows(n, num_groups * vals.element_size())
    cols = torch.arange(num_groups, dtype=torch.int32, device=vals.device)
    fill = torch.full((), fill, dtype=vals.dtype, device=vals.device)
    out = None
    for r0 in range(0, n, step):
        g = gid[r0:r0 + step].to(torch.int32)
        masked = torch.where(g[:, None] == cols, vals[r0:r0 + step, None], fill)
        part = reduce(masked)
        out = part if out is None else combine(out, part)
    if out is None:
        out = fill.expand(num_groups).clone()
    return out


def _seg_sum_float_bcast(vals, gid, num_groups: int):
    return _seg_bcast(vals, gid, num_groups, 0, lambda m: m.sum(dim=0),
                      torch.add)


def _seg_minmax_bcast(vals, gid, num_groups: int, is_min: bool, identity):
    if is_min:
        return _seg_bcast(vals, gid, num_groups, identity,
                          lambda m: m.amin(dim=0), torch.minimum)
    return _seg_bcast(vals, gid, num_groups, identity,
                      lambda m: m.amax(dim=0), torch.maximum)


def group_bounds_sorted(gid, num_groups: int):
    """(left, right) row index ranges per group for group-sorted gid."""
    g = gid.to(torch.int64).contiguous()
    slots = torch.arange(num_groups, dtype=torch.int64, device=g.device)
    left = torch.searchsorted(g, slots, side="left")
    right = torch.searchsorted(g, slots, side="right")
    return left, right


def _seg_sum_sorted(vals, gid, num_groups: int):
    """Prefix-sum differences at the group bounds. Exact for ints
    (wrap-around makes the difference exact). NOT for floats: a global
    float prefix makes each group's error scale with the whole array."""
    c = torch.cumsum(vals, dim=0)
    left, right = group_bounds_sorted(gid, num_groups)
    n = vals.shape[0]
    p = torch.cat([torch.zeros((1,), dtype=c.dtype, device=c.device), c])
    return p[right.clamp(0, n)] - p[left.clamp(0, n)]


def _segmented_scan(vals, gid, op):
    """Inclusive scan of `op` that restarts wherever gid changes: log2(n)
    doubling steps, each combining a row with the row d places back when
    both lie in one run (torch has no associative_scan)."""
    g = gid.to(torch.int64)
    run = torch.cumsum(torch.cat([
        torch.ones((1,), dtype=torch.int64, device=g.device),
        (g[1:] != g[:-1]).to(torch.int64)]), dim=0)
    out = vals.clone()
    n = out.shape[0]
    d = 1
    while d < n:
        same = run[d:] == run[:-d]
        out[d:] = torch.where(same, op(out[:-d], out[d:]), out[d:])
        d *= 2
    return out


def _read_group_ends(scanned, gid, num_groups: int, identity):
    n = scanned.shape[0]
    left, right = group_bounds_sorted(gid, num_groups)
    at_end = scanned[(right - 1).clamp(0, n - 1)]
    fill = torch.full((), identity, dtype=scanned.dtype, device=scanned.device)
    return torch.where(right > left, at_end, fill)


def _seg_sum_sorted_float(vals, gid, num_groups: int):
    """Float sums of group-sorted rows: a scan that RESTARTS at each group
    bound (no cross-group cancellation), read at the group ends."""
    if vals.shape[0] == 0:
        return torch.zeros((num_groups,), dtype=vals.dtype, device=vals.device)
    return _read_group_ends(_segmented_scan(vals, gid, torch.add), gid,
                            num_groups, 0)


def _seg_minmax_sorted(vals, gid, num_groups: int, is_min: bool, identity):
    if vals.shape[0] == 0:
        return torch.full((num_groups,), identity, dtype=vals.dtype,
                          device=vals.device)
    op = torch.minimum if is_min else torch.maximum
    return _read_group_ends(_segmented_scan(vals, gid, op), gid,
                            num_groups, identity)


def _seg_sum_pallas(vals, gid, num_groups: int):
    """Float sums through the segment-sum kernel (f32 block partials, added
    in block order; callers keep exact sums away from it). None when the
    rows do not split into blocks of at least 8 (the caller falls through
    to the other strategies)."""
    from . import kernels

    n = vals.shape[0]
    block = min(n & -n, 2048)
    if block < 8:
        return None
    g = gid.to(torch.int32).clamp(0, num_groups).contiguous()
    v = vals.to(torch.float32).reshape(n, 1).contiguous()
    out = kernels.segment_sum(g, v, num_groups, block)
    return out[:, 0].to(vals.dtype)


def _scatter_sum(vals, gid, num_groups: int):
    out = torch.zeros((num_groups + 1,), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, _group_index(gid, num_groups), vals.contiguous())
    return out[:num_groups]


def seg_sum(vals, gid, num_groups: int, *, sorted_gid: bool = False,
            nbits: int = 64):
    """Per-group sums; exact (wrap-around) for integers. `nbits` bounds the
    values' bit width for the limb matmul (1 for 0/1 counts)."""
    strategy = _strategy()
    if vals.dtype == torch.bool:
        vals = vals.to(torch.int64)
    if num_groups == 1:
        # global aggregate: one fused masked reduction
        m = gid.to(torch.int32) == 0
        return torch.where(m, vals, torch.zeros((), dtype=vals.dtype,
                                                 device=vals.device)
                           ).sum(dtype=vals.dtype).reshape(1)
    is_int = not vals.is_floating_point()
    if (strategy == "pallas" and not is_int
            and num_groups <= _MATMUL_GROUPS_MAX):
        out = _seg_sum_pallas(vals, gid, num_groups)
        if out is not None:
            return out
    if strategy in ("mxu", "pallas"):
        if is_int:
            v64 = vals.to(torch.int64)
            if (num_groups <= _MATMUL_GROUPS_MAX
                    and _block_of(v64.shape[0]) >= 512):
                return _seg_sum_int_matmul(v64, gid, num_groups, nbits)
            if sorted_gid:
                return _seg_sum_sorted(v64, gid, num_groups)
        else:
            if num_groups <= _BCAST_GROUPS_MAX:
                return _seg_sum_float_bcast(vals, gid, num_groups)
            if sorted_gid:
                return _seg_sum_sorted_float(vals, gid, num_groups)
    return _scatter_sum(vals, gid, num_groups)


def seg_count(live, gid, num_groups: int, *, sorted_gid: bool = False):
    """Per-group count of live rows."""
    return seg_sum(live.to(torch.int64), gid, num_groups,
                   sorted_gid=sorted_gid, nbits=1)


def _dtype_extreme(dtype, is_min: bool):
    """jax.ops.segment_min/max's fill for empty segments."""
    if dtype == torch.bool:
        return is_min
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _seg_minmax(vals, gid, num_groups: int, is_min: bool, identity,
                sorted_gid: bool):
    use_mxu = _use_mxu()
    if num_groups == 1:
        m = gid.to(torch.int32) == 0
        fill = torch.full((), identity, dtype=vals.dtype, device=vals.device)
        masked = torch.where(m, vals, fill)
        return (masked.min() if is_min else masked.max()).reshape(1)
    if use_mxu:
        if num_groups <= _BCAST_GROUPS_MAX:
            return _seg_minmax_bcast(vals, gid, num_groups, is_min, identity)
        if sorted_gid:
            return _seg_minmax_sorted(vals, gid, num_groups, is_min, identity)
    out = torch.full((num_groups + 1,), _dtype_extreme(vals.dtype, is_min),
                     dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, _group_index(gid, num_groups), vals.contiguous(),
                        reduce="amin" if is_min else "amax",
                        include_self=True)
    return out[:num_groups]


def seg_min(vals, gid, num_groups: int, *, identity, sorted_gid: bool = False):
    """Segment min; empty groups get the dtype's max or `identity` (callers
    mask them)."""
    return _seg_minmax(vals, gid, num_groups, True, identity, sorted_gid)


def seg_max(vals, gid, num_groups: int, *, identity, sorted_gid: bool = False):
    return _seg_minmax(vals, gid, num_groups, False, identity, sorted_gid)


def seg_first_index(gid, num_groups: int, n: int):
    """First row index of each group for group-sorted gid (empty -> n)."""
    left, right = group_bounds_sorted(gid, num_groups)
    return torch.where(right > left, left, n)
