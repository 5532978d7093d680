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

The port covers COMPLETE mode with count / sum / min / max / avg, the
variance and covariance families (var_pop/var_samp/stddev_pop/stddev_samp,
covar_pop/covar_samp/corr, summed as float64 moments), the holistic
aggregates (percentile_cont / percentile_disc, which `median` lowers to,
and array_agg on the sort path with its capacity check) and the sketch
aggregates over ops/sketch.py (approx_count_distinct, hll_sketch,
hll_union[_agg], bitmap_agg, bitmap_union[_count], intersect_count), which
is what the single-device plans emit; DECIMAL(38) values (`dec128.py`
limbs) take sum, min, max and count, as in the reference; group_concat
runs in the executor (`runtime/executor.py`), never here.

Modes, as in the reference (the spill executors of runtime/batched.py and
the query cache's partial tier split an aggregation in two):
- COMPLETE: raw rows in, final values out.
- PARTIAL:  raw rows in, merge-able state columns out (avg -> sum + count,
            the moment families -> their power/product sums + count).
- FINAL:    state columns in (PARTIAL outputs concatenated), final values
            out.
The percentiles, array_agg and the sketch aggregates are holistic here, as
in the reference (`_HOLISTIC_FNS`): they run COMPLETE only, and
`decomposable` says no to them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..column.column import Chunk, Field, Schema
from ..exprs.compile import EVal, ExprCompiler, as_tensor, div_scalar
from ..exprs.ir import AggExpr, Col
from . import dec128 as d128
from .common import argsort_stable, boundaries, eval_keys, key_sort_arrays, lexsort
from .segment import (
    group_bounds_sorted, seg_count, seg_first_index, seg_max, seg_min,
    seg_sum,
)

COMPLETE = "complete"
PARTIAL = "partial"
FINAL = "final"

# moment families: sums of powers / products of the float64 values
_VAR_FNS = {"var_pop", "var_samp", "stddev_pop", "stddev_samp"}
_COVAR_FNS = {"covar_pop", "covar_samp", "corr"}
# need the full value multiset -> cannot be split into partial/final
_HOLISTIC_FNS = {"percentile_cont", "percentile_disc", "array_agg",
                 # sketch aggregates run COMPLETE (the distributed planner
                 # gathers rows), as in the reference
                 "approx_count_distinct", "hll_sketch", "hll_union",
                 "hll_union_agg", "bitmap_agg", "bitmap_union",
                 "bitmap_union_count", "intersect_count"}
_SKETCH_FNS = {"approx_count_distinct", "hll_sketch", "hll_union",
               "hll_union_agg", "bitmap_agg", "bitmap_union",
               "bitmap_union_count", "intersect_count"}
_PERCENTILE_FNS = {"percentile_cont", "percentile_disc"}
_SUPPORTED = {"count", "count_star", "sum", "min", "max", "avg",
              "array_agg"} | _VAR_FNS | _COVAR_FNS | _SKETCH_FNS \
    | _PERCENTILE_FNS


def decomposable(aggs: tuple) -> bool:
    """True when every aggregate supports the PARTIAL/FINAL two-phase split
    (the spill executors and the query cache's partial tier decline the
    rest)."""
    return all(a.fn not in _HOLISTIC_FNS for _, a in aggs)


def _state_fields(name: str, agg, arg_t: Optional[T.LogicalType]):
    """State columns a PARTIAL aggregation emits for `agg` (name -> type)."""
    if agg.fn == "count" or agg.fn == "count_star":
        return [(f"{name}", T.BIGINT)]
    if agg.fn == "sum":
        return [(f"{name}", _sum_out_type(arg_t))]
    if agg.fn in ("min", "max"):
        return [(f"{name}", arg_t)]
    if agg.fn == "avg":
        return [(f"{name}__sum", _sum_out_type(arg_t)),
                (f"{name}__cnt", T.BIGINT)]
    if agg.fn in _VAR_FNS:
        return [(f"{name}__sum", T.DOUBLE), (f"{name}__ssq", T.DOUBLE),
                (f"{name}__cnt", T.BIGINT)]
    if agg.fn in _COVAR_FNS:
        return [(f"{name}__sx", T.DOUBLE), (f"{name}__sy", T.DOUBLE),
                (f"{name}__sxy", T.DOUBLE), (f"{name}__sxx", T.DOUBLE),
                (f"{name}__syy", T.DOUBLE), (f"{name}__cnt", T.BIGINT)]
    raise NotImplementedError(f"aggregate {agg.fn}")


def _read_state(cc, col_name, live_rows, reorder):
    """A PARTIAL state column, permuted into group order, 0 on dead rows."""
    st = cc.eval(Col(col_name))
    return torch.where(live_rows, reorder(st.data), 0)


def final_agg_exprs(aggs: tuple) -> tuple:
    """Rewrite agg specs for the FINAL stage over PARTIAL state columns."""
    out = []
    for name, agg in aggs:
        if agg.fn in ("count", "count_star"):
            out.append((name, AggExpr("count", Col(name))))
        elif agg.fn == "sum":
            out.append((name, AggExpr("sum", Col(name))))
        elif agg.fn == "min":
            out.append((name, AggExpr("min", Col(name))))
        elif agg.fn == "max":
            out.append((name, AggExpr("max", Col(name))))
        elif agg.fn == "avg":
            out.append((name, AggExpr("avg", None)))
        elif agg.fn in _VAR_FNS or agg.fn in _COVAR_FNS:
            out.append((name, AggExpr(agg.fn, None)))
        else:
            raise NotImplementedError(agg.fn)
    return tuple(out)


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


def _try_lowcard(group_by, keys, live, num_groups: int, mode: str,
                 aggs=()):
    """Sort-free fast path when every group key has a bounded domain: group
    id = mixed-radix packed codes. Returns (gid[cap] int32 with dead rows
    parked at `total`, infos, total) or None when a key is unbounded or the
    domain exceeds num_groups."""
    from ..runtime.config import config as _cfg

    if mode == FINAL or not group_by or not _cfg.get("enable_lowcard_agg"):
        return None
    if any(a.fn == "array_agg" for _, a in aggs):
        # array_agg needs group-contiguous positions (the sort path)
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


def _string_hash_lut(d) -> np.ndarray:
    """Stable per-code 64-bit hashes of a StringDict's VALUES (FNV-1a over
    utf-8), as uint64. Sketches built from different dictionaries must agree
    on equal strings — hashing raw codes would make them non-mergeable.
    Cached per dictionary."""
    cached = _HASH_LUTS.get(id(d))
    if cached is not None and cached[0] is d:
        return cached[1]
    n = max(len(d), 1)
    encoded = [str(v).encode() for v in d.values[:len(d)]]
    out = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    if encoded and not any(b"\x00" in s for s in encoded):
        # vectorized FNV: fixed-width byte matrix (NUL-padded), folded
        # column-wise; the first zero byte ends the value, which is only
        # sound when no value embeds a NUL (checked above)
        m = np.array(encoded, dtype=bytes).view(np.uint8)
        m = m.reshape(len(encoded), -1) if m.size else np.zeros(
            (len(encoded), 1), np.uint8)
        alive = np.ones(n, dtype=bool)
        with np.errstate(over="ignore"):  # FNV-1a wraps mod 2^64 by design
            for j in range(m.shape[1]):
                b = m[:, j]
                alive = alive & (b != 0)
                folded = (out ^ b) * np.uint64(0x100000001B3)
                out = np.where(alive, folded, out)
    elif encoded:  # embedded NULs: exact scalar fold for those dicts
        with np.errstate(over="ignore"):
            for i, s in enumerate(encoded):
                h = np.uint64(0xCBF29CE484222325)
                for byte in s:
                    h = (h ^ np.uint64(byte)) * np.uint64(0x100000001B3)
                out[i] = h
    if len(_HASH_LUTS) > 64:
        _HASH_LUTS.clear()
    _HASH_LUTS[id(d)] = (d, out)  # the strong ref keeps the id stable
    return out


_HASH_LUTS: dict = {}


def _hash_input_i64(a: EVal, device) -> torch.Tensor:
    """Distinct-preserving int64 view of a column for sketch hashing
    (strings hash their VALUE bytes via a dict LUT; floats hash their bit
    patterns)."""
    if a.type.is_wide:
        raise NotImplementedError(f"cannot sketch {a.type!r} values")
    if a.type.is_string and a.dict is not None:
        lut = torch.from_numpy(_string_hash_lut(a.dict).view(np.int64))
        lut = lut.to(device)
        return lut[as_tensor(a.data, torch.int64, device).clamp(
            0, lut.shape[0] - 1)]
    if a.type.is_float:
        return as_tensor(a.data, torch.float64, device).view(torch.int64)
    return as_tensor(a.data, torch.int64, device)


def _bitmap_nbits(a: EVal) -> int:
    from ..runtime.config import config as _cfg

    if a.bounds is not None and a.bounds[1] is not None \
            and 0 <= a.bounds[1] < (1 << 24):
        return int(a.bounds[1]) + 1
    return _cfg.get("bitmap_default_domain")


def _emit_sketch_agg(cc, name, agg, cap, live_rows, reorder, gid,
                     num_groups):
    """HLL / BITMAP aggregate column (ops/sketch.py)."""
    from . import sketch
    from ..exprs.ir import Call
    from ..runtime.config import config as _cfg

    fn = agg.fn
    arg = agg.arg
    dev = cc.device
    if (fn in ("bitmap_agg", "bitmap_union", "bitmap_union_count")
            and isinstance(arg, Call) and arg.fn == "to_bitmap"):
        # bitmap_union(to_bitmap(x)): skip the per-row planes and scatter
        # x's values directly (the fused presence path)
        arg = arg.args[0]
    a = cc.eval(arg)
    m = live_rows if a.valid is None else (
        live_rows & reorder(a.valid.expand(cap)))

    def planes_of(d):
        return torch.where(m[:, None], reorder(d), 0)

    if fn in ("approx_count_distinct", "hll_sketch"):
        p = _cfg.get("hll_precision")
        vals = reorder(_hash_input_i64(a, dev).expand(cap))
        regs = sketch.hll_registers_from_values(vals, m, gid, num_groups, p)
        if fn == "approx_count_distinct":
            return (Field(name, T.BIGINT, False), sketch.hll_estimate(regs),
                    None)
        return Field(name, T.HLL(p), False), regs, None

    if fn in ("hll_union", "hll_union_agg"):
        if not a.type.is_hll:
            raise TypeError(f"{fn} expects an HLL column, got {a.type!r}")
        regs = sketch.hll_union_registers(planes_of(a.data), gid, num_groups)
        if fn == "hll_union_agg":
            return (Field(name, T.BIGINT, False), sketch.hll_estimate(regs),
                    None)
        return Field(name, a.type, False), regs, None

    if fn in ("bitmap_agg", "bitmap_union", "bitmap_union_count"):
        if a.type.is_bitmap:  # union of stored bitmaps: plane merge
            if fn == "bitmap_agg":
                raise TypeError("bitmap_agg expects integer values")
            planes = sketch.bitmap_union_planes(planes_of(a.data), gid,
                                                num_groups)
            nb = a.type
        else:  # integer values: one fused presence scatter
            if not a.type.is_integer:
                raise TypeError(
                    f"{fn} expects BITMAP or integer values, got {a.type!r}")
            nbits = _bitmap_nbits(a)
            vals = reorder(as_tensor(a.data, torch.int64, dev).expand(cap))
            planes = sketch.bitmap_union_from_values(vals, m, gid,
                                                     num_groups, nbits)
            nb = T.BITMAP(nbits)
        if fn == "bitmap_union_count":
            return (Field(name, T.BIGINT, False), sketch.bitmap_count(planes),
                    None)
        return Field(name, nb, False), planes, None

    if fn == "intersect_count":
        if not a.type.is_bitmap:
            raise TypeError(
                f"intersect_count expects a BITMAP column, got {a.type!r}")
        dim_e, *lits = agg.extra
        d = planes_of(a.data)
        acc = None
        for lit in lits:
            eqv = cc.call("eq", cc.eval(dim_e), cc.eval(lit))
            sel = as_tensor(eqv.data, torch.bool, dev).expand(cap)
            if eqv.valid is not None:
                sel = sel & eqv.valid.expand(cap)
            mi = m & reorder(sel)
            planes = sketch.bitmap_union_planes(
                torch.where(mi[:, None], d, 0), gid, num_groups)
            acc = planes if acc is None else sketch.bitmap_binary(
                acc, planes, "and")
        return Field(name, T.BIGINT, False), sketch.bitmap_count(acc), None

    raise NotImplementedError(fn)


def _emit_percentile(cc, name, agg, cap, live_rows, reorder, gid,
                     num_groups):
    """percentile_cont / percentile_disc: sort the live values by (group,
    value), then read each group's rank(s) from its bounds."""
    a = cc.eval(agg.arg)
    if a.type.is_string or a.type.is_wide:
        raise NotImplementedError(f"{agg.fn} over {a.type!r}")
    dev = cc.device
    frac = float(agg.extra[0].value)
    d = reorder(as_tensor(a.data, a.type.dtype, dev).expand(cap))
    m = live_rows if a.valid is None else (
        live_rows & reorder(a.valid.expand(cap)))
    gidm = torch.where(m, gid.to(torch.int64), num_groups)
    order2 = lexsort([d, gidm])
    g2 = gidm[order2]
    v2 = d[order2]
    left, right = group_bounds_sorted(g2, num_groups)
    cnt = right - left
    if agg.fn == "percentile_cont":
        vf = v2.to(torch.float64)
        if a.type.is_decimal:
            vf = div_scalar(vf, 10 ** a.type.scale)
        fpos = frac * (cnt - 1).to(torch.float64)
        lo = torch.floor(fpos).to(torch.int64).clamp(min=0)
        hi = torch.ceil(fpos).to(torch.int64).clamp(min=0)
        t = fpos - lo
        vlo = vf[(left + lo).clamp(0, cap - 1)]
        vhi = vf[(left + hi).clamp(0, cap - 1)]
        return (Field(name, T.DOUBLE, True), vlo * (1 - t) + vhi * t,
                cnt > 0)
    # percentile_disc: the smallest value with cum_dist >= frac
    k = torch.ceil(frac * cnt.to(torch.float64)).to(torch.int64) - 1
    k = torch.minimum(k.clamp(min=0), (cnt - 1).clamp(min=0))
    return (Field(name, a.type, True, a.dict),
            v2[(left + k).clamp(0, cap - 1)], cnt > 0)


def _emit_array_agg(cc, name, agg, cap, live_rows, reorder, gid, num_groups,
                    arr_cap, aux_checks):
    """array_agg over group-contiguous rows (the sort path): position in
    group = row index - group start; scatter (gid, pos) -> [G, K+1]; K
    adapts through the `array_agg_max` capacity check."""
    a = cc.eval(agg.arg)
    dev = cc.device
    m = live_rows if a.valid is None else (
        live_rows & reorder(a.valid.expand(cap)))
    d = reorder(as_tensor(a.data, a.type.dtype, dev).expand(cap))
    gid64 = gid.to(torch.int64)
    left = seg_first_index(gid64, num_groups, cap)
    pos = torch.arange(cap, device=dev) - left[gid64.clamp(0, num_groups - 1)]
    ok = m & (pos >= 0) & (pos < arr_cap)
    gi = torch.where(ok, gid64, num_groups)
    pi = torch.where(ok, pos, 0)
    mat = torch.zeros((num_groups + 1, arr_cap + 1), dtype=d.dtype,
                      device=dev)
    mat[gi, 1 + pi] = d
    counts = seg_count(m, gid, num_groups, sorted_gid=True)
    if aux_checks is not None:
        aux_checks["array_agg_max"] = (counts.max() if counts.numel()
                                       else torch.zeros((), device=dev))
    mat[:num_groups, 0] = torch.clamp(counts, max=arr_cap).to(d.dtype)
    return (Field(name, T.ARRAY(a.type), True, a.dict), mat[:num_groups],
            counts > 0)


def _emit_agg_columns(cc, aggs, mode, cap, live_rows, reorder, gid,
                      num_groups, indices_sorted, arr_cap=256,
                      aux_checks=None):
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
    final = mode == FINAL
    for name, agg in aggs:
        if agg.fn not in _SUPPORTED:
            raise NotImplementedError(f"aggregate {agg.fn}")
        if agg.fn in _SKETCH_FNS or agg.fn in _PERCENTILE_FNS \
                or agg.fn == "array_agg":
            if mode != COMPLETE:
                raise NotImplementedError(
                    f"{agg.fn} cannot be split into partial/final")
            if agg.fn in _SKETCH_FNS:
                f, d, v = _emit_sketch_agg(cc, name, agg, cap, live_rows,
                                           reorder, gid, num_groups)
            elif agg.fn in _PERCENTILE_FNS:
                f, d, v = _emit_percentile(cc, name, agg, cap, live_rows,
                                           reorder, gid, num_groups)
            else:
                if not indices_sorted:
                    raise NotImplementedError(
                        "array_agg requires the sorted aggregation path")
                f, d, v = _emit_array_agg(cc, name, agg, cap, live_rows,
                                          reorder, gid, num_groups, arr_cap,
                                          aux_checks)
            out_fields.append(f)
            out_data.append(d)
            out_valid.append(v)
            continue
        if agg.fn == "count_star" or (agg.fn == "count" and agg.arg is None):
            if final:
                cnt = _seg_sum(_read_state(cc, name, live_rows, reorder).to(
                    torch.int64))
            else:
                cnt = _seg_sum(live_rows, nbits=1)
            out_fields.append(Field(name, T.BIGINT, False))
            out_data.append(cnt)
            out_valid.append(None)
            continue

        if agg.fn in _VAR_FNS:
            if final:
                s1 = _read_state(cc, f"{name}__sum", live_rows, reorder)
                s2 = _read_state(cc, f"{name}__ssq", live_rows, reorder)
                cnts = _read_state(cc, f"{name}__cnt", live_rows, reorder)
            else:
                a = cc.eval(agg.arg)
                _no_wide(a, agg.fn)
                d = reorder(_full(_as_f64(a, dev)))
                m = live_rows if a.valid is None else (
                    live_rows & reorder(_full(a.valid)))
                s1 = torch.where(m, d, 0.0)
                s2 = torch.where(m, d * d, 0.0)
                cnts = m.to(torch.int64)
            gs1 = _seg_sum(s1)
            gs2 = _seg_sum(s2)
            gn = _seg_sum(cnts, nbits=64 if final else 1)
            if mode == PARTIAL:
                out_fields += [Field(f"{name}__sum", T.DOUBLE, False),
                               Field(f"{name}__ssq", T.DOUBLE, False),
                               Field(f"{name}__cnt", T.BIGINT, False)]
                out_data += [gs1, gs2, gn]
                out_valid += [None, None, None]
                continue
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
            if final:
                sx, sy, sxy, sxx, syy, cnts = (
                    _read_state(cc, f"{name}__{sfx}", live_rows, reorder)
                    for sfx in ("sx", "sy", "sxy", "sxx", "syy", "cnt"))
            else:
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
                sx = torch.where(m, dx, 0.0)
                sy = torch.where(m, dy, 0.0)
                sxy = torch.where(m, dx * dy, 0.0)
                sxx = torch.where(m, dx * dx, 0.0)
                syy = torch.where(m, dy * dy, 0.0)
                cnts = m.to(torch.int64)
            gx, gy, gxy = _seg_sum(sx), _seg_sum(sy), _seg_sum(sxy)
            gxx, gyy = _seg_sum(sxx), _seg_sum(syy)
            gn = _seg_sum(cnts, nbits=64 if final else 1)
            if mode == PARTIAL:
                for suffix, dat in [("sx", gx), ("sy", gy), ("sxy", gxy),
                                    ("sxx", gxx), ("syy", gyy)]:
                    out_fields.append(
                        Field(f"{name}__{suffix}", T.DOUBLE, False))
                    out_data.append(dat)
                    out_valid.append(None)
                out_fields.append(Field(f"{name}__cnt", T.BIGINT, False))
                out_data.append(gn)
                out_valid.append(None)
                continue
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

        if agg.fn == "avg":
            if final:
                sv = cc.eval(Col(f"{name}__sum"))
                sum_t = sv.type
                vals = _read_state(cc, f"{name}__sum", live_rows, reorder)
                cnts = _read_state(cc, f"{name}__cnt", live_rows, reorder)
            else:
                a = cc.eval(agg.arg)
                _no_wide(a, agg.fn)
                sum_t = _sum_out_type(a.type)
                d = reorder(_full(_to_rep(a, sum_t, dev)))
                m = live_rows if a.valid is None else (
                    live_rows & reorder(_full(a.valid)))
                vals = torch.where(m, d, 0)
                cnts = m.to(torch.int64)
            gsum = _seg_sum(vals)
            gcnt = _seg_sum(cnts, nbits=64 if final else 1)
            if mode == PARTIAL:
                out_fields += [Field(f"{name}__sum", sum_t, False),
                               Field(f"{name}__cnt", T.BIGINT, False)]
                out_data += [gsum, gcnt]
                out_valid += [None, None]
                continue
            denom = torch.clamp(gcnt, min=1)
            if sum_t.is_decimal:
                res = div_scalar(gsum.to(torch.float64),
                                 10 ** sum_t.scale) / denom
            else:
                res = gsum.to(torch.float64) / denom
            out_fields.append(Field(name, T.DOUBLE, True))
            out_data.append(res)
            out_valid.append(gcnt > 0)
            continue

        # sum / min / max / count(x); FINAL reads the state column by name
        a = cc.eval(Col(name)) if final else cc.eval(agg.arg)
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
        elif agg.fn == "count":
            if final:
                res = _seg_sum(torch.where(
                    m, reorder(_full(as_tensor(a.data, torch.int64, dev))),
                    0))
            else:
                res = _seg_sum(m, nbits=1)
            out_fields.append(Field(name, T.BIGINT, False))
            out_data.append(res)
            out_valid.append(None)
        elif agg.fn == "sum":
            out_t = a.type if final else _sum_out_type(a.type)
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
    arr_cap: int = 256,
    aux_checks: dict | None = None,
):
    """Returns (output_chunk, true_group_count). Output capacity=num_groups.
    `arr_cap` is array_agg's element capacity; the largest group's count
    lands in aux_checks["array_agg_max"]."""
    cc = ExprCompiler(chunk)
    cap = chunk.capacity
    dev = chunk.device
    live = chunk.sel_mask()
    keys = eval_keys(chunk, tuple(e for _, e in group_by))

    lowcard = _try_lowcard(group_by, keys, live, num_groups, mode, aggs)
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
        indices_sorted=True, arr_cap=arr_cap, aux_checks=aux_checks)
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
