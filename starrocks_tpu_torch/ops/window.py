"""Window (analytic) functions.

Reference behavior: be/src/exec/analytor.h:54 + analytic_node — partitioned,
frame-based analytic evaluation. The JAX package's design (ops/window.py
there), unchanged: one stable sort by (partition keys, order keys),
segment starts from partition boundaries, then
- whole-partition aggregates  = segmented scans read at the partition end,
- running aggregates (default RANGE UNBOUNDED PRECEDING..CURRENT ROW frame
  with peers) = segmented scans read at the end of the peer group,
- explicit ROWS/RANGE frames = prefix-sum differences (sum/count/avg),
  scans or a doubling sparse table (min/max),
- row_number / rank / dense_rank = positional arithmetic on the sorted order.
The output chunk is in sorted order (SQL leaves intermediate order
unspecified); new columns align with it.

torch has no associative_scan. Its three uses here become:
- the carry scan ("the value at the last flagged row") = torch.cummax over
  where(flag, position, 0), then a gather — exact, one pass;
- an integer segmented sum = a global cumsum minus its value before the
  segment start (exact: int64 wraps);
- a float segmented sum and every min/max = the doubling scan of
  ops/segment.py, restarting at the flags (never a global float prefix:
  its cancellation across partitions would cost the reference's digits).

Profiler spans split the operator's device time: `window::prefilter`
(the top-N runtime filter before the sort), `window::sort` (the sort and
the gather of the sorted chunk), `window::scan` (boundaries, carry and
segmented scans) and `window::frame` (explicit frames' bounds and
reductions).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

from .. import types as T
from ..column.column import Chunk, Field
from ..exprs.compile import ExprCompiler, _infer_lit, as_tensor, div_scalar
from .common import argsort_stable, boundaries, eval_keys, lexsort

_I64MIN = -(1 << 63)
_I64MAX = (1 << 63) - 1


_OPEN: list = []  # the window span open now, if any


@contextlib.contextmanager
def _range(name: str):
    """The profiler range `name`, unless a window span is open already:
    spans never nest, so each device op is counted under one span."""
    if _OPEN:
        yield
        return
    _OPEN.append(name)
    try:
        with record_function(name):
            yield
    finally:
        _OPEN.pop()


def _span(name: str):
    """Run the decorated function inside `_range(name)`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with _range(name):
                return fn(*a, **k)
        return wrapped
    return deco


def _full(x, cap: int, dtype, device) -> torch.Tensor:
    """`jnp.broadcast_to(jnp.asarray(x), (cap,))` for a column or a scalar."""
    t = as_tensor(x, dtype, device)
    if t.ndim > 1:
        raise NotImplementedError(
            "window functions over DECIMAL(38) (rank-2) values are not "
            "supported (as in the JAX package)")
    return t.expand(cap)


def _no_wide_keys(keys):
    """The reference's window sort takes rank-1 keys only (its lexsort
    operands must share one shape): a DECIMAL(38) key fails there."""
    if any(k.data.ndim > 1 for k in keys):
        raise NotImplementedError(
            "window PARTITION BY / ORDER BY over DECIMAL(38) (rank-2) keys "
            "is not supported (as in the JAX package)")


def window_topn_prefilter_safe(funcs, limit_spec) -> bool:
    """Whether dropping rows BEFORE the window's sort is sound for this
    function set. The threshold is the per-partition k-th ROW's score, so

    - the limited function must count rows: rank()/row_number(). dense_rank
      counts DISTINCT order keys, so its k-th rank can sit past the k-th
      row (scores [10,10,9]: dense_rank 2 is the 9-row, but the 2nd row's
      score is 10 — the threshold would drop it);
    - every co-resident function (the analyzer merges all funcs sharing a
      (partition, order) spec into one LWindow) must read only the sorted
      prefix up to the current row's peer group. rank-like functions do;
      lead/last_value/nth_value and frames reaching FOLLOWING would be
      computed over the pruned subset and go wrong on surviving rows.

    The in-window limit_rank mask is exact for every function, so unsafe
    shapes simply skip the prefilter, not the rewrite."""
    limited = next((f[1] for f in funcs if f[0] == limit_spec[0]), None)
    if limited not in ("rank", "row_number"):
        return False
    return all(f[1] in ("rank", "row_number", "dense_rank") for f in funcs)


@_span("window::prefilter")
def window_topn_prefilter(chunk: Chunk, partition_by, order_by, k: int,
                          max_domain: int = 1024,
                          max_cells: int = 1 << 25):
    """Branch-free TopN runtime filter applied BEFORE the window's sort
    (the reference feeds the heap TopN's current threshold back into
    upstream operators; here the k-th key per partition becomes a mask).

    Requirements: a single order key and a bounded partition-key domain D
    (dict codes / bools / stats-bounded ints). Keeps rows scoring >= their
    partition's k-th best score — a superset of the rank() <= k row set
    (ties at the threshold stay, so the in-window rank mask still applies;
    callers gate on window_topn_prefilter_safe). NULL keys score the
    ceiling (NULLS FIRST) or the floor (NULLS LAST). Returns (keep_mask,
    seed_rows) — seed_rows is a capacity seed for compacting the kept set
    (k * threshold-resolution per partition, with slack) — or None.

    Under the scatter-free strategies (`mxu`, `pallas`) the threshold is
    exact: torch.topk over a [D, cap] masked score matrix, used as a value
    only (never an order). Otherwise a k-round selection ladder (scatter
    max + first-occurrence removal) over a strided subset of ~128k rows:
    a subset's k-th largest is at most the population's, so the threshold
    stays conservative and over-kept rows fall to the exact in-window
    mask. Both give the same final rows."""
    if k < 1 or len(order_by) != 1:
        return None
    expr, asc, nulls_first = order_by[0]
    live = chunk.sel_mask()
    cap = chunk.capacity
    dev = chunk.device
    (okey,) = eval_keys(chunk, (expr,))
    d = okey.data
    if d.ndim != 1:
        return None  # wide (DECIMAL128) order keys
    if d.dtype == torch.bool:
        d = d.to(torch.int8)
    # score: bigger = earlier rank
    score = d if not asc else -d
    if score.is_floating_point():
        floor, ceil = float("-inf"), float("inf")
    else:
        score = score.to(torch.int64)
        floor, ceil = _I64MIN, _I64MAX
    if okey.valid is not None:
        score = torch.where(okey.valid, score,
                            ceil if nulls_first else floor)
    score = torch.where(live, score, floor)
    if score.is_floating_point():
        # NaN order keys sort last in either direction, so they rank worst:
        # score them the floor (raw NaN would fail `>= kth` always, and k
        # NaNs in one partition would make kth itself NaN)
        score = torch.where(torch.isnan(score), floor, score)

    if partition_by:
        from .aggregate import _mixed_radix_pack

        pkeys = eval_keys(chunk, tuple(partition_by))
        packed = _mixed_radix_pack(pkeys, live, max_domain, torch.int64)
        if packed is None:
            return None
        gid, _, total = packed
        D = int(total)
    else:
        gid = torch.zeros((cap,), dtype=torch.int64, device=dev)
        D = 1
    if D * cap > max_cells:
        return None
    kk = min(k, cap)
    gidc = gid.clamp(0, D - 1)
    from .segment import _use_mxu

    if _use_mxu():
        groups = torch.arange(D, dtype=gid.dtype, device=dev)
        mat = torch.where(groups[:, None] == gid[None, :], score[None, :],
                          torch.tensor(floor, dtype=score.dtype, device=dev))
        kth = torch.topk(mat, kk, dim=1).values[:, -1]  # [D] k-th per part
        stride = 1  # exact threshold
    else:
        stride = max(1, cap // (1 << 17))
        sub = score[::stride]
        gsub = gidc[::stride]
        n_sub = sub.shape[0]
        rowidx = torch.arange(n_sub, device=dev)
        cur = sub
        kth = torch.full((D,), floor, dtype=score.dtype, device=dev)
        for _ in range(kk):
            kth = torch.full((D,), floor, dtype=score.dtype,
                             device=dev).scatter_reduce(0, gsub, cur, "amax")
            is_max = cur == kth[gsub]
            first = torch.full((D,), n_sub, dtype=torch.int64,
                               device=dev).scatter_reduce(
                0, gsub, torch.where(is_max, rowidx, n_sub), "amin")
            cur = torch.where(first[gsub] == rowidx, floor, cur)
    keep = live & (score >= kth[gidc])
    # a stride-s threshold keeps ~s rows per true top-k slot in
    # expectation; the overflow check covers adversarial layouts
    return keep, (kk * stride + 8) * (D + 1)


@_span("window::scan")
def _seg_cummax_from_flags(vals, is_new):
    """Segmented 'value at segment start' propagation: for each row, the
    value at the most recent row where is_new was True (inclusive; row 0
    when there is none)."""
    pos = torch.arange(vals.shape[0], device=vals.device)
    start_idx = torch.cummax(torch.where(is_new, pos, 0), dim=0).values
    return vals[start_idx], start_idx


def _window_order(pkeys, okeys, order_by, live):
    """The window's row order: dead last, then partition keys (ascending,
    NULLS LAST), then order keys. Packing tries the FULL key tuple first
    (one stable sort), then just the partition keys (partition prefix and
    liveness fold into one operand, order keys stay lexsort operands),
    then the all-operand lexsort."""
    from .sort import packed_order_key

    pspecs = [(None, True, False)] * len(pkeys)
    packed = packed_order_key(pkeys + okeys, pspecs + list(order_by), live)
    if packed is not None:
        return argsort_stable(packed)
    ops = []
    for k, (_, asc, nulls_first) in zip(reversed(okeys),
                                        reversed(list(order_by))):
        d = k.data
        if d.dtype == torch.bool:
            d = d.to(torch.int8)
        ops.append(d if asc else -d)
        if k.valid is not None:
            ops.append((k.valid if nulls_first else ~k.valid).to(torch.int8))
    ppacked = packed_order_key(pkeys, pspecs, live) if pkeys else None
    if ppacked is not None:
        ops.append(ppacked)  # partition prefix + live fold into one
    else:
        for k in reversed(pkeys):
            ops.append(k.data)
            if k.valid is not None:
                ops.append((~k.valid).to(torch.int8))
        ops.append((~live).to(torch.int8))
    return lexsort(ops)


def window_op(
    chunk: Chunk,
    partition_by: tuple,  # tuple[Expr]
    order_by: tuple,  # tuple[(Expr, asc, nulls_first)]
    funcs: tuple,  # tuple[(out_name, fn, arg|None, offset, default[, frame])]
    limit_spec: tuple | None = None,  # (rank-func out_name, k): see below
    counters: dict | None = None,
) -> Chunk:
    """limit_spec marks a per-partition segmented top-N: only rows whose
    named rank()/row_number()/dense_rank() value is <= k stay selected in
    the output (the optimizer plants it from a `rk <= k` filter — the TopN
    runtime-filter analog; downstream operators then see ~k*partitions
    live rows instead of the whole window input). `counters` (when given)
    receives 'window_topn_pruned', the live rows that mask dropped."""
    cap = chunk.capacity
    dev = chunk.device
    live = chunk.sel_mask()
    pkeys = eval_keys(chunk, partition_by)
    okeys = eval_keys(chunk, tuple(e for e, _, _ in order_by))
    _no_wide_keys(pkeys + okeys)

    with _range("window::sort"):
        order = _window_order(pkeys, okeys, order_by, live)
        sorted_chunk = chunk.take(order)
        live_s = live[order]
    pos = torch.arange(cap, device=dev)

    with _range("window::scan"):
        if pkeys:
            part_new = boundaries(pkeys, live, order)
        else:
            part_new = torch.zeros((cap,), dtype=torch.bool, device=dev)
            part_new[0] = live.any()
        # peer groups: rows equal on partition+order keys
        peer_new = (boundaries(pkeys + okeys, live, order) if okeys
                    else part_new)
        part_start, _ = _seg_cummax_from_flags(pos, part_new)
        row_in_part = pos - part_start
        # "end" searches must stop at the live/dead boundary: treat the
        # first dead row as a segment start so indices never land on padding
        dead_start = ~live_s
        end_peer_flags = peer_new | part_new | dead_start
        end_part_flags = part_new | dead_start
        peer_start, _ = _seg_cummax_from_flags(pos, peer_new | part_new)
        peer_end = _segment_end(end_peer_flags, pos)
        part_end = _segment_end(end_part_flags, pos)

    @_span("window::frame")
    def frame_bounds(frame):
        """Per-row inclusive [start, end] positions of an explicit frame in
        the sorted order, clamped to the row's partition. start > end means
        an empty frame. Reference frame semantics: be/src/exec/analytor.h:54."""
        mode, st, so, et, eo = frame
        if mode == "rows":
            start = {"up": part_start, "p": pos - int(so or 0), "cr": pos,
                     "f": pos + int(so or 0)}[st]
            end = {"p": pos - int(eo or 0), "cr": pos,
                   "f": pos + int(eo or 0), "uf": part_end}[et]
        else:  # RANGE: CURRENT ROW = the whole peer group
            start = {"up": part_start, "cr": peer_start}.get(st)
            end = {"cr": peer_end, "uf": part_end}.get(et)
            if start is None or end is None:
                k = okeys[0]
                if k.dict is not None:
                    raise NotImplementedError(
                        "RANGE frame offsets require a numeric ORDER BY key")
                # offsets are user-unit; decimal keys are scaled-int reps
                unit = 10 ** k.type.scale if k.type.is_decimal else 1
                so = None if so is None else so * unit
                eo = None if eo is None else eo * unit
                asc = order_by[0][1]
                nf = order_by[0][2]
                ks = k.data[order].to(torch.float64)
                if k.valid is not None:
                    kv = k.valid[order]
                    # nulls sort as a block at one end; pin them to the
                    # matching sentinel so the partition stays monotone
                    at_min = nf if asc else not nf
                    ks = torch.where(kv, ks, float("-inf") if at_min
                                     else float("inf"))
                else:
                    kv = torch.ones((cap,), dtype=torch.bool, device=dev)
                iters = cap.bit_length() + 1
                hi0 = part_end + 1
                if start is None:
                    sgn = -1.0 if st == "p" else 1.0
                    t = ks + (sgn * float(so) if asc else -sgn * float(so))
                    cmp = torch.ge if asc else torch.le
                    start = _bsearch_first(ks, part_start, hi0, t, cmp, iters)
                    start = torch.where(kv, start, peer_start)
                if end is None:
                    sgn = -1.0 if et == "p" else 1.0
                    t = ks + (sgn * float(eo) if asc else -sgn * float(eo))
                    cmp = torch.gt if asc else torch.lt
                    end = _bsearch_first(ks, part_start, hi0, t, cmp,
                                         iters) - 1
                    end = torch.where(kv, end, peer_end)
        start = torch.maximum(start, part_start)
        end = torch.minimum(end, part_end)
        # detect emptiness BEFORE clamping into gather range (a frame wholly
        # outside its partition must stay empty); encode empty as (1, 0)
        empty = (start > end) | ~live_s
        start = start.clamp(0, cap - 1)
        end = end.clamp(0, cap - 1)
        return torch.where(empty, 1, start), torch.where(empty, 0, end)

    cc = ExprCompiler(sorted_chunk)
    new_fields, new_data, new_valid = [], [], []
    limit_rank = None  # the named rank column when limit_spec applies
    ones = torch.ones((cap,), dtype=torch.bool, device=dev)
    for spec in funcs:
        out_name, fn, arg, f_offset, f_default, *_rest = spec
        f_frame = _rest[0] if _rest else None
        if fn == "row_number":
            r = row_in_part + 1
            if limit_spec is not None and out_name == limit_spec[0]:
                limit_rank = r
            new_fields.append(Field(out_name, T.BIGINT, False))
            new_data.append(r)
            new_valid.append(None)
            continue
        if fn in ("rank", "dense_rank"):
            if fn == "rank":
                r = peer_start - part_start + 1
            else:
                in_part_newpeer = (peer_new | part_new) & ~part_new
                dr = torch.cumsum(in_part_newpeer.to(torch.int64), 0)
                dr_at_start, _ = _seg_cummax_from_flags(dr, part_new)
                r = dr - dr_at_start + 1
            if limit_spec is not None and out_name == limit_spec[0]:
                limit_rank = r
            new_fields.append(Field(out_name, T.BIGINT, False))
            new_data.append(r)
            new_valid.append(None)
            continue

        if fn in ("lead", "lag"):
            v = cc.eval(arg)
            shift = -f_offset if fn == "lead" else f_offset
            d = _full(v.data, cap, v.type.dtype, dev)
            val = torch.roll(d, shift)
            vv = ones if v.valid is None else v.valid.expand(cap)
            vv = torch.roll(vv, shift)
            # rows whose source falls outside the partition -> NULL
            src = pos - shift
            in_bounds = (src >= 0) & (src < cap)
            src_c = src.clamp(0, cap - 1)
            same_part = part_start == torch.where(in_bounds,
                                                  part_start[src_c], -1)
            src_live = in_bounds & live_s[src_c]
            ok = in_bounds & same_part & live_s & src_live
            if f_default is not None:
                # out-of-partition slots take the declared default
                hv, _ = _infer_lit(f_default, v.type)
                val = torch.where(ok, val, torch.tensor(hv, dtype=val.dtype,
                                                        device=dev))
                new_valid.append(torch.where(ok, vv, True))
            else:
                new_valid.append(vv & ok)
            new_fields.append(Field(out_name, v.type, True, v.dict))
            new_data.append(val)
            continue
        if fn in ("first_value", "last_value"):
            v = cc.eval(arg)
            d = _full(v.data, cap, v.type.dtype, dev)
            if f_frame is not None:
                starts, ends = frame_bounds(f_frame)
                idx = starts if fn == "first_value" else ends
                empty = starts > ends
                vv = ones if v.valid is None else v.valid.expand(cap)[idx]
                new_fields.append(Field(out_name, v.type, True, v.dict))
                new_data.append(d[idx])
                new_valid.append(vv & ~empty)
                continue
            # default frame: the partition's first row, or the end of the
            # current peer group (stops at the live/dead boundary)
            idx = part_start if fn == "first_value" else peer_end
            new_fields.append(Field(out_name, v.type, v.valid is not None,
                                    v.dict))
            new_data.append(d[idx])
            new_valid.append(None if v.valid is None
                             else v.valid.expand(cap)[idx])
            continue
        if fn == "ntile":
            n_tiles = int(f_offset)
            # partition size = end - start + 1 (end stops at live/dead edge)
            psize = part_end - part_start + 1
            tile = (row_in_part * n_tiles) // psize.clamp(min=1) + 1
            new_fields.append(Field(out_name, T.BIGINT, False))
            new_data.append(tile.to(torch.int64))
            new_valid.append(None)
            continue

        # aggregates over the partition
        running = bool(okeys)  # default frame when ORDER BY present
        if fn == "count" and arg is None:
            vals = live_s.to(torch.int64)
            m = live_s
            out_t = T.BIGINT
            dict_ = None
        else:
            v = cc.eval(arg)
            out_t = _agg_out_type(fn, v.type)
            d = _full(v.data, cap, v.type.dtype, dev)
            m = live_s if v.valid is None else (live_s & v.valid.expand(cap))
            dict_ = v.dict
            if fn == "count":
                vals = m.to(torch.int64)
            elif fn in ("sum", "avg"):
                vals = torch.where(m, _cast_rep(d, v.type, out_t), 0)
            else:  # min/max
                ident = _mm_ident(v.type, fn == "min")
                vals = torch.where(m, d, torch.tensor(ident, dtype=d.dtype,
                                                      device=dev))

        if f_frame is not None:
            # explicit ROWS/RANGE frame: prefix-sum differences for
            # sum/count/avg; scans or a doubling sparse table for min/max
            starts, ends = frame_bounds(f_frame)
            empty = starts > ends
            sm = starts - 1

            @_span("window::frame")
            def pref_diff(P, empty=empty, ends=ends, sm=sm):
                a = P[ends]
                b = torch.where(sm >= 0, P[sm.clamp(0, cap - 1)], 0)
                return torch.where(empty, 0, a - b)

            cntf = pref_diff(torch.cumsum(m.to(torch.int64), 0))
            if fn in ("min", "max"):
                op = torch.minimum if fn == "min" else torch.maximum
                ident = torch.tensor(_mm_ident(v.type, fn == "min"),
                                     dtype=vals.dtype, device=dev)
                st_kind, et_kind = f_frame[1], f_frame[3]
                if st_kind == "up":
                    res = _segmented_scan(vals, part_new, op)[ends]
                elif et_kind == "uf":
                    is_end = pos == part_end
                    res = _segmented_scan(
                        vals.flip(0), is_end.flip(0), op).flip(0)[starts]
                else:
                    res = _range_reduce(vals, op, ident, starts, ends, cap)
                new_fields.append(Field(out_name, out_t, True, dict_))
                new_data.append(torch.where(empty, ident, res))
                new_valid.append(cntf > 0)
                continue
            if fn == "count":
                new_fields.append(Field(out_name, T.BIGINT, False))
                new_data.append(cntf)
                new_valid.append(None)
                continue
            total = pref_diff(torch.cumsum(vals, 0))
            if fn == "sum":
                new_fields.append(Field(out_name, out_t, True))
                new_data.append(total)
                new_valid.append(cntf > 0)
                continue
            if fn != "avg":
                raise NotImplementedError(f"window frame for {fn}")
            new_fields.append(Field(out_name, T.DOUBLE, True))
            new_data.append(_avg(total, cntf, out_t))
            new_valid.append(cntf > 0)
            continue

        # frame end: current peer group (running) or whole partition
        end_flags = end_peer_flags if running else end_part_flags
        if fn in ("min", "max"):
            op = torch.minimum if fn == "min" else torch.maximum
            run = _segmented_scan(vals, part_new, op)
            res = _peer_extend(run, end_flags, pos)
            cnt = _part_count(m, part_new, end_flags, pos)
            new_fields.append(Field(out_name, out_t, True, dict_))
            new_data.append(res)
            new_valid.append(cnt > 0)
            continue

        # sum / count / avg — segmented running scan read at the frame end
        # (whole partition when there is no ORDER BY): never a scatter
        total = _peer_extend(_segmented_scan(vals, part_new, torch.add),
                             end_flags, pos)
        ccnt = _part_count(m, part_new, end_flags, pos)
        if fn == "count":
            new_fields.append(Field(out_name, T.BIGINT, False))
            new_data.append(ccnt)
            new_valid.append(None)
        elif fn == "sum":
            new_fields.append(Field(out_name, out_t, True))
            new_data.append(total)
            new_valid.append(ccnt > 0)
        elif fn == "avg":
            new_fields.append(Field(out_name, T.DOUBLE, True))
            new_data.append(_avg(total, ccnt, out_t))
            new_valid.append(ccnt > 0)
        else:
            raise NotImplementedError(f"window function {fn}")

    out = sorted_chunk.with_columns(new_fields, new_data, new_valid)
    if limit_rank is not None:
        # segmented per-partition top-N: drop rows ranked past k right here
        # so downstream sorts/joins see ~k*partitions live rows (the filter
        # that planted limit_spec still runs above — this mask only prunes,
        # it never widens)
        keep = live_s & (limit_rank <= limit_spec[1])
        if counters is not None:
            counters["window_topn_pruned"] = (
                live_s.sum(dtype=torch.int64) - keep.sum(dtype=torch.int64))
        out = out.and_sel(keep)
    return out


def _avg(total, count, out_t):
    denom = count.clamp(min=1)
    if out_t.is_decimal:
        return div_scalar(total.to(torch.float64), 10 ** out_t.scale) / denom
    return total.to(torch.float64) / denom


def _bsearch_first(ks, lo0, hi0, thresh, cmp, iters):
    """Vectorized binary search: for each row, the first index j in
    [lo0, hi0) with cmp(ks[j], thresh) true (ks monotone over that span);
    hi0 when none. All arguments may be per-row tensors."""
    lo, hi = lo0, hi0
    n = ks.shape[0]
    for _ in range(iters):
        mid = torch.div(lo + hi, 2, rounding_mode="floor").clamp(0, n - 1)
        p = cmp(ks[mid], thresh)
        cont = lo < hi
        lo = torch.where(cont & ~p, mid + 1, lo)
        hi = torch.where(cont & p, mid, hi)
    return lo


@_span("window::frame")
def _range_reduce(vals, op, ident, starts, ends, cap):
    """min/max over arbitrary inclusive [starts, ends] spans: the doubling
    sparse table (two lookups per row at level floor(log2(length))). The
    reference stacks all levels+1 tables ((levels+1) x cap: ~7 GB of int64
    at cap 2^25); here each level is built from the one before, read by
    the rows whose level it is, and dropped — two tables live at a time,
    the same answers (min/max are exact)."""
    levels = max(1, (cap - 1).bit_length())
    ln = (ends - starts + 1).clamp(min=1)
    k = torch.floor(torch.log2(ln.to(torch.float64))).to(torch.int64)
    k = k.clamp(0, levels)
    s = starts.clamp(0, cap - 1)
    e = (ends - torch.bitwise_left_shift(torch.ones_like(k), k)
         + 1).clamp(0, cap - 1)
    res = op(vals[s], vals[e])  # level 0
    prev = vals
    for lvl in range(1, levels + 1):
        h = 1 << (lvl - 1)
        pad = ident.expand(h).to(prev.dtype)
        prev = op(prev, torch.cat([prev[h:], pad]))
        res = torch.where(k == lvl, op(prev[s], prev[e]), res)
    return res


@_span("window::scan")
def _segmented_scan(vals, seg_start_flags, op):
    """Inclusive scan of `op` restarting at flagged rows (rows before the
    first flag form one segment from row 0). Integer sums: a global cumsum
    minus its value just before the segment start (int64 wraps, so the
    difference is exact). Float sums and min/max: the doubling scan."""
    if op is torch.add and not vals.is_floating_point():
        pref = torch.cumsum(vals, 0)
        _, start = _seg_cummax_from_flags(pref, seg_start_flags)
        return pref - (pref[start] - vals[start])
    from .segment import _segmented_scan as doubling_scan

    return doubling_scan(vals, torch.cumsum(seg_start_flags.to(torch.int64),
                                            0), op)


@_span("window::scan")
def _carry_scan(vals, flags):
    """out[i] = vals at the most recent flagged position <= i (vals[0]
    when none is): torch.cummax over the flagged positions, then a gather."""
    pos = torch.arange(vals.shape[0], device=vals.device)
    return vals[torch.cummax(torch.where(flags, pos, 0), dim=0).values]


def _segment_end(start_flags, pos):
    """Each row's segment end: the position just before the next flagged
    row (the last row for the final segment)."""
    nxt = torch.cat([start_flags[1:],
                     torch.ones((1,), dtype=torch.bool, device=pos.device)])
    return _carry_scan(pos.flip(0), nxt.flip(0)).flip(0)


def _peer_extend(run, peer_start_flags, pos):
    """RANGE frames include the whole peer group: every row takes the running
    value at the LAST row of its peer group (= position just before the next
    peer start)."""
    return run[_segment_end(peer_start_flags, pos)]


def _part_count(m, part_new, end_flags, pos):
    c = _segmented_scan(m.to(torch.int64), part_new, torch.add)
    return _peer_extend(c, end_flags, pos)


def _agg_out_type(fn, t):
    if fn in ("min", "max"):
        return t
    if fn == "count":
        return T.BIGINT
    if t.is_decimal:
        return T.DECIMAL(18, t.scale)
    if t.is_float:
        return T.DOUBLE
    return T.BIGINT


def _cast_rep(d, t, out_t):
    if t.is_decimal and out_t.is_decimal:
        x = d.to(torch.int64)
        if t.scale < out_t.scale:
            x = x * (10 ** (out_t.scale - t.scale))
        return x
    return d.to(out_t.dtype)


def _mm_ident(t, is_min):
    if t.is_float:
        return float("inf") if is_min else float("-inf")
    if t.kind is T.TypeKind.BOOLEAN:
        return is_min
    info = torch.iinfo(t.dtype)
    return info.max if is_min else info.min
