"""Sort-based grouped aggregation.

Reference behavior: be/src/exec/aggregator.h:255 + agg hash maps
(be/src/exec/aggregate/agg_hash_variant.h). The JAX package's design,
unchanged: a static group capacity, and a true group count returned so the
executor can retry at a larger capacity. Two paths:

- low-cardinality (`_try_lowcard`): every group key has a bounded domain
  (dictionary codes, booleans, stats-bounded ints), so the group id is the
  mixed-radix packed key and aggregates are direct segment reductions — no
  sort (TPC-H Q1's 6 groups, Q9's nation x year);
- sort path: a stable sort on one packed key (or a lexsort when a key is
  unbounded), segment boundaries, segment reductions.

The port covers COMPLETE mode with count / sum / min / max / avg and the
variance and covariance families (var_pop/var_samp/stddev_pop/stddev_samp,
covar_pop/covar_samp/corr, summed as float64 moments), which is what the
single-device plans emit; DECIMAL(38) values (`dec128.py` limbs) take sum,
min, max and count, as in the reference. PARTIAL/FINAL two-phase
aggregation and the percentile, sketch and array aggregates raise;
group_concat runs in the executor (`runtime/executor.py`), never here.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import types as T
from ..column.column import Chunk, Field, Schema
from ..exprs.compile import EVal, ExprCompiler, as_tensor, div_scalar
from . import dec128 as d128
from .common import argsort_stable, boundaries, eval_keys, key_sort_arrays, lexsort
from .segment import seg_count, seg_first_index, seg_max, seg_min, seg_sum

COMPLETE = "complete"
PARTIAL = "partial"
FINAL = "final"

# moment families: sums of powers / products of the float64 values
_VAR_FNS = {"var_pop", "var_samp", "stddev_pop", "stddev_samp"}
_COVAR_FNS = {"covar_pop", "covar_samp", "corr"}
_SUPPORTED = {"count", "count_star", "sum", "min", "max", "avg"} | _VAR_FNS \
    | _COVAR_FNS


def _as_f64(a: EVal, device):
    """Arg data as float64 (decimals unscale)."""
    d = as_tensor(a.data, torch.float64, device)
    if a.type.is_decimal:
        return div_scalar(d, 10 ** a.type.scale)
    return d


def _sum_out_type(t: T.LogicalType) -> T.LogicalType:
    if t.is_decimal128:
        return t
    if t.is_decimal:
        return T.DECIMAL(18, t.scale)
    if t.is_float:
        return T.DOUBLE
    return T.BIGINT


def _minmax_identity(t: T.LogicalType, is_min: bool):
    if t.is_float:
        return float("inf") if is_min else float("-inf")
    if t.kind is T.TypeKind.BOOLEAN:
        return True if is_min else False
    info = torch.iinfo(t.dtype)
    return info.max if is_min else info.min


def _is_int_tensor(d) -> bool:
    return (isinstance(d, torch.Tensor) and d.ndim == 1
            and not d.is_floating_point() and d.dtype != torch.bool)


def _key_domain(k) -> Optional[tuple]:
    """(base, lo) static value domain of one group key, or None when
    unbounded. Shared by the planner's capacity seeding (bounded_domain) and
    the runtime packed-gid path (_try_lowcard) so the two can never disagree
    about which keys are coverable."""
    if k.dict is not None:
        return max(len(k.dict), 1), 0
    if k.type.kind is T.TypeKind.BOOLEAN:
        return 2, 0
    if k.bounds is not None and _is_int_tensor(k.data):
        # stats-bounded integer/date domain (bounds propagate through the
        # expr compiler, e.g. extract(year FROM ...)): codes are value - lo
        lo, hi = int(k.bounds[0]), int(k.bounds[1])
        return hi - lo + 1, lo
    return None


def bounded_domain(chunk: Chunk, group_by) -> Optional[int]:
    """Static size of the group-key domain when every key is bounded
    (dict codes, booleans, stats-bounded ints) — planner uses it to seed the
    aggregation capacity so the sort-free packed-gid path covers dense
    high-cardinality keys (e.g. GROUP BY l_orderkey) too."""
    from ..runtime.config import config as _cfg

    if not group_by or not _cfg.get("enable_lowcard_agg"):
        return None
    keys = eval_keys(chunk, tuple(e for _, e in group_by))
    total = 1
    for k in keys:
        dom = _key_domain(k)
        if dom is None:
            return None
        total *= dom[0] + (1 if k.valid is not None else 0)
        if total > (1 << 26):  # give up early on huge domains
            return None
    return total


def _mixed_radix_pack(keys, live, total_limit: int, out_dtype):
    """THE single mixed-radix key packer (null -> extra code past the
    domain, dead rows -> `total`, which sorts/indexes past every live
    code). Shared by the dense packed-gid path (int32, capacity-limited)
    and the packed sort-key path (int64, 2^62-limited). Returns (packed,
    infos, total) or None when a key is unbounded or the product exceeds
    the limit."""
    infos = []
    total = 1
    for k in keys:
        dom = _key_domain(k)
        if dom is None:
            return None
        base, lo = dom
        has_null = k.valid is not None
        size = base + (1 if has_null else 0)
        infos.append((k, base, has_null, size, lo))
        total *= size
        if total > total_limit:
            return None
    packed = torch.zeros((live.shape[0],), dtype=out_dtype, device=live.device)
    for k, base, has_null, size, lo in infos:
        code = (k.data.to(torch.int64) - lo).clamp(0, base - 1).to(out_dtype)
        if has_null:
            code = torch.where(k.valid, code, base)
        packed = packed * size + code
    return torch.where(live, packed, total), infos, total


def _packed_sort_codes(keys, live):
    """One int64 mixed-radix code per row packing ALL bounded group keys
    (dead rows -> a sentinel that sorts last), or None."""
    out = _mixed_radix_pack(keys, live, 1 << 62, torch.int64)
    return None if out is None else out[0]


def _try_lowcard(group_by, keys, live, num_groups: int, mode: str):
    """Sort-free fast path when every group key has a bounded domain: group
    id = mixed-radix packed codes. Returns (gid[cap] int32 with dead rows
    parked at `total`, infos, total) or None when a key is unbounded or the
    domain exceeds num_groups."""
    from ..runtime.config import config as _cfg

    if mode == FINAL or not group_by or not _cfg.get("enable_lowcard_agg"):
        return None
    return _mixed_radix_pack(keys, live, num_groups, torch.int32)


def _lowcard_key_columns(infos, total: int, num_groups: int, device):
    """Decode slot ids back into per-key code columns (+ NULL validity)."""
    slots = torch.arange(num_groups, dtype=torch.int32, device=device)
    cols = []
    strides = []
    s = 1
    for k, base, has_null, size, lo in reversed(infos):
        strides.append(s)
        s *= size
    strides = list(reversed(strides))
    for (k, base, has_null, size, lo), stride in zip(infos, strides):
        code = (slots // stride) % size
        valid = None
        if has_null:
            valid = code != base
            code = torch.where(valid, code, 0)
        cols.append((k, (code + lo).to(k.type.dtype), valid))
    return cols


def _no_wide(a: EVal, fn: str):
    if a.type.is_wide:
        raise NotImplementedError(
            f"{fn} over {a.type!r} is not supported (sum/min/max/count are; "
            "cast to DOUBLE for the rest)")


def _to_rep(a: EVal, out_t: T.LogicalType, device):
    """Cast an arg EVal's data to the aggregation accumulator representation."""
    if a.type.is_decimal and out_t.is_decimal:
        d = as_tensor(a.data, torch.int64, device)
        if a.type.scale < out_t.scale:
            d = d * (10 ** (out_t.scale - a.type.scale))
        return d
    if out_t.is_decimal and not a.type.is_decimal:
        return as_tensor(a.data, torch.int64, device) * (10 ** out_t.scale)
    return as_tensor(a.data, out_t.dtype, device)


def _emit_agg_columns(cc, aggs, mode, cap, live_rows, reorder, gid,
                      num_groups, indices_sorted):
    """Emit aggregate output columns — shared by the sort path (reorder
    permutes rows into group order) and the low-cardinality packed-gid path
    (reorder is identity). live_rows is the row-liveness mask AFTER reorder."""
    dev = cc.device

    def _seg_sum(vals, nbits=64):
        return seg_sum(vals, gid, num_groups, sorted_gid=indices_sorted,
                       nbits=nbits)

    def _full(x):
        return x.expand(cap) if x.ndim == 0 else x

    out_fields, out_data, out_valid = [], [], []
    for name, agg in aggs:
        if agg.fn not in _SUPPORTED or mode != COMPLETE:
            raise NotImplementedError(
                f"aggregate {agg.fn} ({mode}) is not in the port yet")
        if agg.fn == "count_star" or (agg.fn == "count" and agg.arg is None):
            out_fields.append(Field(name, T.BIGINT, False))
            out_data.append(_seg_sum(live_rows, nbits=1))
            out_valid.append(None)
            continue

        if agg.fn in _VAR_FNS:
            a = cc.eval(agg.arg)
            _no_wide(a, agg.fn)
            d = reorder(_full(_as_f64(a, dev)))
            m = live_rows if a.valid is None else (
                live_rows & reorder(_full(a.valid)))
            gs1 = _seg_sum(torch.where(m, d, 0.0))
            gs2 = _seg_sum(torch.where(m, d * d, 0.0))
            gn = _seg_sum(m.to(torch.int64), nbits=1)
            samp = agg.fn.endswith("_samp")
            denom = torch.clamp(gn - (1 if samp else 0), min=1)
            var = torch.clamp(
                (gs2 - gs1 * gs1 / torch.clamp(gn, min=1)) / denom, min=0.0)
            res = torch.sqrt(var) if agg.fn.startswith("stddev") else var
            out_fields.append(Field(name, T.DOUBLE, True))
            out_data.append(res)
            out_valid.append(gn > (1 if samp else 0))
            continue

        if agg.fn in _COVAR_FNS:
            ax = cc.eval(agg.arg)
            ay = cc.eval(agg.extra[0])
            _no_wide(ax, agg.fn)
            _no_wide(ay, agg.fn)
            dx = reorder(_full(_as_f64(ax, dev)))
            dy = reorder(_full(_as_f64(ay, dev)))
            m = live_rows
            for v in (ax.valid, ay.valid):
                if v is not None:
                    m = m & reorder(_full(v))
            gx = _seg_sum(torch.where(m, dx, 0.0))
            gy = _seg_sum(torch.where(m, dy, 0.0))
            gxy = _seg_sum(torch.where(m, dx * dy, 0.0))
            gxx = _seg_sum(torch.where(m, dx * dx, 0.0))
            gyy = _seg_sum(torch.where(m, dy * dy, 0.0))
            gn = _seg_sum(m.to(torch.int64), nbits=1)
            nf = torch.clamp(gn, min=1)
            if agg.fn == "corr":
                num = gn * gxy - gx * gy
                den2 = (gn * gxx - gx * gx) * (gn * gyy - gy * gy)
                den = torch.sqrt(torch.clamp(den2, min=0.0))
                res = num / torch.where(den > 0, den, 1.0)
                ok = (gn > 0) & (den > 0)
            else:
                cov = gxy - gx * gy / nf
                if agg.fn == "covar_samp":
                    res = cov / torch.clamp(gn - 1, min=1)
                    ok = gn > 1
                else:
                    res = cov / nf
                    ok = gn > 0
            out_fields.append(Field(name, T.DOUBLE, True))
            out_data.append(res)
            out_valid.append(ok)
            continue

        a = cc.eval(agg.arg)
        if agg.fn == "avg":
            _no_wide(a, agg.fn)
        m = live_rows if a.valid is None else (
            live_rows & reorder(_full(a.valid)))

        if a.type.is_decimal128 and agg.fn in ("min", "max"):
            # lexicographic limb refinement: per limb (ms->ls), keep only
            # rows still tied on all more-significant limbs and take the
            # segment extreme — 4 scatter-free passes
            is_min = agg.fn == "min"
            adj = d128.cmp_limbs(reorder(a.data))
            ident = (1 << 32) if is_min else -1
            gidc = gid.to(torch.int64).clamp(0, num_groups - 1)
            segfn = seg_min if is_min else seg_max
            tied = m
            best_limbs = []
            for limb in adj:
                lv = torch.where(tied, limb, ident)
                best = segfn(lv, gid, num_groups, identity=ident,
                             sorted_gid=indices_sorted)
                best_limbs.append(best)
                tied = tied & (limb == best[gidc])
            best_limbs[0] = best_limbs[0] ^ 0x80000000  # undo sign adjust
            res = torch.stack([x.to(torch.int64) & 0xFFFFFFFF
                               for x in best_limbs], dim=1)
            out_fields.append(Field(name, a.type, True))
            out_data.append(res)
            out_valid.append(_seg_sum(m, nbits=1) > 0)
        elif agg.fn == "sum" and a.type.is_decimal128:
            # 128-bit exact sum: per-32-bit-limb segment sums (limb sums of
            # up to 2^31 rows fit int64), then one carry-propagation pass;
            # wraps mod 2^128 like the reference's int128 accumulator
            d = reorder(a.data)  # [cap, 4] limbs, ms first
            limb_sums = [_seg_sum(torch.where(m, d[:, i] & 0xFFFFFFFF, 0))
                         for i in range(4)]
            out_limbs = [None] * 4
            carry = torch.zeros_like(limb_sums[0])
            for i in (3, 2, 1, 0):  # least significant first
                tot = limb_sums[i] + carry
                out_limbs[i] = tot & 0xFFFFFFFF
                carry = tot >> 32
            out_fields.append(Field(name, a.type, True))
            out_data.append(torch.stack(out_limbs, dim=1))
            out_valid.append(_seg_sum(m, nbits=1) > 0)
        elif agg.fn == "avg":
            sum_t = _sum_out_type(a.type)
            d = reorder(_full(_to_rep(a, sum_t, dev)))
            gsum = _seg_sum(torch.where(m, d, 0))
            gcnt = _seg_sum(m.to(torch.int64), nbits=1)
            denom = torch.clamp(gcnt, min=1)
            if sum_t.is_decimal:
                res = div_scalar(gsum.to(torch.float64),
                                 10 ** sum_t.scale) / denom
            else:
                res = gsum.to(torch.float64) / denom
            out_fields.append(Field(name, T.DOUBLE, True))
            out_data.append(res)
            out_valid.append(gcnt > 0)
        elif agg.fn == "count":
            out_fields.append(Field(name, T.BIGINT, False))
            out_data.append(_seg_sum(m, nbits=1))
            out_valid.append(None)
        elif agg.fn == "sum":
            out_t = _sum_out_type(a.type)
            d = reorder(_full(_to_rep(a, out_t, dev)))
            res = _seg_sum(torch.where(m, d, 0))
            nonempty = _seg_sum(m, nbits=1) > 0
            out_fields.append(Field(name, out_t, True))
            out_data.append(res)
            out_valid.append(nonempty)
        else:  # min / max
            is_min = agg.fn == "min"
            ident = _minmax_identity(a.type, is_min)
            d = reorder(_full(as_tensor(a.data, a.type.dtype, dev)))
            fill = torch.full((), ident, dtype=a.type.dtype, device=dev)
            dd = torch.where(m, d, fill)
            segfn = seg_min if is_min else seg_max
            res = segfn(dd, gid, num_groups, identity=ident,
                        sorted_gid=indices_sorted)
            nonempty = _seg_sum(m, nbits=1) > 0
            out_fields.append(Field(name, a.type, True, a.dict))
            out_data.append(res)
            out_valid.append(nonempty)
    return out_fields, out_data, out_valid


def hash_aggregate(
    chunk: Chunk,
    group_by: tuple,  # tuple[(name, Expr)]
    aggs: tuple,  # tuple[(name, AggExpr)]
    num_groups: int,
    mode: str = COMPLETE,
):
    """Returns (output_chunk, true_group_count). Output capacity=num_groups."""
    cc = ExprCompiler(chunk)
    cap = chunk.capacity
    dev = chunk.device
    live = chunk.sel_mask()
    keys = eval_keys(chunk, tuple(e for _, e in group_by))

    lowcard = _try_lowcard(group_by, keys, live, num_groups, mode)
    if lowcard is not None:
        return _aggregate_with_gid(
            chunk, cc, group_by, aggs, num_groups, mode, *lowcard, live=live
        )

    out_fields, out_data, out_valid = [], [], []

    if keys:
        packed = _packed_sort_codes(keys, live)
        if packed is not None:
            # stable single-key sort: within-group row order matches the
            # lexsort path's
            order = argsort_stable(packed)
            pk_s = packed[order]
            live_s = live[order]
            prev = torch.cat([torch.full((1,), -1, dtype=torch.int64,
                                         device=dev), pk_s[:-1]])
            is_new = live_s & (pk_s != prev)
        else:
            order = lexsort(key_sort_arrays(keys, live))
            is_new = boundaries(keys, live, order)
            live_s = live[order]
        gid = (torch.cumsum(is_new, 0) - 1).clamp(0, num_groups - 1)
        ngroups = is_new.sum(dtype=torch.int64)

        def reorder(x):
            return x[order]

        # --- group key columns ------------------------------------------------
        first_pos = seg_first_index(gid, num_groups, cap)
        safe_first = first_pos.clamp(0, cap - 1)
        for (kname, _), k in zip(group_by, keys):
            ks = k.data[order][safe_first]
            kv = None if k.valid is None else k.valid[order][safe_first]
            out_fields.append(Field(kname, k.type, k.valid is not None, k.dict,
                                    bounds=k.bounds))
            out_data.append(ks)
            out_valid.append(kv)
    else:
        # global aggregation: one group holding all live rows, one fused
        # masked reduction per aggregate
        gid = torch.zeros((cap,), dtype=torch.int32, device=dev)
        live_s = live
        # a global agg always yields one row (COUNT over empty set = 0)
        ngroups = torch.tensor(1, dtype=torch.int64, device=dev)

        def reorder(x):
            return x

    agg_fields, agg_data, agg_valid = _emit_agg_columns(
        cc, aggs, mode, cap, live_s, reorder, gid, num_groups,
        indices_sorted=True)
    out_fields += agg_fields
    out_data += agg_data
    out_valid += agg_valid

    sel = torch.arange(num_groups, device=dev) < ngroups
    out = Chunk(Schema(tuple(out_fields)), tuple(out_data), tuple(out_valid),
                sel, dev)
    return out, ngroups


def _aggregate_with_gid(chunk, cc, group_by, aggs, num_groups, mode,
                        gid, infos, total, live):
    """Aggregate via direct (unsorted) segment reductions over packed gids."""
    cap = chunk.capacity
    dev = chunk.device

    out_fields, out_data, out_valid = [], [], []
    for (name, _), (k, code, kvalid) in zip(
        group_by, _lowcard_key_columns(infos, total, num_groups, dev)
    ):
        out_fields.append(Field(name, k.type, kvalid is not None, k.dict,
                                bounds=k.bounds))
        out_data.append(code)
        out_valid.append(kvalid)

    group_count = seg_count(live, gid, num_groups)
    agg_fields, agg_data, agg_valid = _emit_agg_columns(
        cc, aggs, mode, cap, live, lambda x: x, gid, num_groups,
        indices_sorted=False)
    out_fields += agg_fields
    out_data += agg_data
    out_valid += agg_valid

    in_domain = torch.arange(num_groups, device=dev) < total
    sel = in_domain & (group_count > 0)
    ngroups = sel.sum(dtype=torch.int64)
    out = Chunk(Schema(tuple(out_fields)), tuple(out_data), tuple(out_valid),
                sel, dev)
    return out, ngroups
