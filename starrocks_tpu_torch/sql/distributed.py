"""Distributed physical planning: logical plan -> one program in lockstep
over the shards of a mesh.

Reference behavior: the fragment/exchange machinery (SURVEY §2.4) — the FE
cuts plans into fragments at exchange boundaries and schedules N instances
across BEs (qe/CoordinatorPreprocessor.java:70); BEs shuffle via bRPC
transmit_chunk. A port of the JAX package's sql/distributed.py, which
compiles the whole distributed plan into one shard_map. Here the program
runs eagerly over parallel/mesh.py's shard tuple:

- big tables are row-sharded over the mesh (the tablet->BE assignment
  analog); small tables are replicated (colocate-by-copy);
- join strategies: probe-sharded x build-replicated = local broadcast join
  (no collective); sharded x sharded = hash-shuffle both sides (all_to_all)
  then local join — HASH_PARTITIONED exchange;
- aggregation over sharded input: colocate COMPLETE when the input is
  hash-placed on a subset of the group keys; else two-phase — local
  PARTIAL, then all_gather + FINAL (low-cardinality) or an all_to_all
  SHUFFLE of the partial states with per-shard FINAL (high-cardinality, by
  NDV estimate);
- ORDER BY+LIMIT = per-shard TopN, compact, gather top-k only; full ORDER
  BY = range exchange by sampled splitters + local sort (shards end
  globally ordered); PARTITION BY windows shuffle by partition key and run
  locally; unpartitioned windows and bare LIMIT still gather.

Every node returns (value, mode): mode one of REPLICATED, SHARDED,
RANGE_SHARDED (sharded + globally ordered across the shards), or
("hash", col) (sharded by the standard splitmix64 recipe on col — the
colocate-placement token). A REPLICATED value is one Chunk, computed once;
any other value is a tuple of this process's per-shard Chunks, and a local
op whose input is sharded runs once per shard. Overflow checks of a sharded
stage are the max over its shards (one device scalar); profile counters of
a sharded stage are summed over the shards.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..column.column import Field, pad_capacity
from ..exprs.ir import Col, Lit
from ..ops import (
    INNER, LEFT_ANTI, LEFT_OUTER, LEFT_SEMI,
    filter_chunk, hash_aggregate, hash_join_expand, hash_join_unique,
    limit_chunk, project, sort_chunk,
)
from ..ops.aggregate import FINAL, PARTIAL, decomposable, final_agg_exprs
from ..ops.common import compact, eval_keys
from ..ops.window import window_op
from ..parallel.exchange import (
    all_gather_chunk, range_partition_chunk, shuffle_chunk,
)
from .analyzer import _conjuncts
from .logical import (
    LAggregate, LFilter, LJoin, LLimit, LProject, LScan, LSort, LUnion,
    LUnnest, LWindow, LogicalPlan, walk_plan,
)
from .optimizer import and_all
from .physical import Caps, PlanError, _equi_pair

SHARDED = "sharded"
REPLICATED = "replicated"
# sharded AND globally ordered across the shards (range exchange + local
# sort): the gather concatenates the shards into sorted order
RANGE_SHARDED = "range_sharded"

# tables smaller than this are replicated rather than sharded
SHARD_THRESHOLD_ROWS = 100_000
# estimated group count above which two-phase aggregation shuffles partial
# states by group key (each shard finalizes its own key range) instead of
# all_gathering them — the reference's HASH_PARTITIONED vs GATHER enforcer
# choice (fe sql/optimizer/ChildOutputPropertyGuarantor.java)
SHUFFLE_AGG_MIN_GROUPS = 32_768


def _default_bucket_cap(capacity: int, n_shards: int) -> int:
    """Default per-destination exchange bucket capacity: even split of the
    input capacity with ~2x skew headroom (n//2 destinations' worth)."""
    return pad_capacity(capacity // max(n_shards // 2, 1))


def estimated_group_ndv(p: LAggregate, catalog):
    """Upper bound on GROUP BY cardinality: product over group keys of the
    per-column distinct counts, capped by the child's estimated row count.
    None when any key is a non-Col expression or unresolvable (then the
    planner stays BROADCAST)."""
    if not p.group_by:
        return 0
    from .optimizer import col_origin, estimate_rows

    total = 1
    for _, e in p.group_by:
        if not isinstance(e, Col):
            return None
        origin = col_origin(p.child, e.name)
        if origin is None:
            return None
        t = catalog.get_table(origin[0])
        if t is None:
            return None
        ndv = t.column_ndv(origin[1])
        if ndv is None:
            return None
        total *= max(int(ndv), 1)
        if total > (1 << 40):
            break
    return min(total, int(max(estimate_rows(p.child, catalog), 1.0)))


def _single_sort_rank(chunk, sort_keys):
    """One totally-ordered per-row tensor encoding a single-key ORDER BY
    (asc/desc + NULLS FIRST/LAST), for the range-partition exchange; None
    when the sort is multi-key (ties at a splitter boundary could split a
    secondary-order run across shards). NULLs share a rank with the dtype's
    extreme value (the reference's caveat)."""
    if len(sort_keys) != 1:
        return None
    expr, asc, nulls_first = sort_keys[0]
    (k,) = eval_keys(chunk, (expr,))
    d = k.data
    if d.ndim != 1:
        return None
    if d.dtype == torch.bool:
        d = d.to(torch.int8)
    # INT_MIN negates to itself: the reference's caveat
    rank = d if asc else -d
    if k.valid is not None:
        if rank.is_floating_point():
            sentinel = float("-inf") if nulls_first else float("inf")
        else:
            info = torch.iinfo(rank.dtype)
            sentinel = info.min if nulls_first else info.max
        rank = torch.where(k.valid, rank,
                           torch.tensor(sentinel, dtype=rank.dtype,
                                        device=rank.device))
    return rank


class DistCompiled:
    def __init__(self, fn, scans, scan_modes, out_names, n_shards):
        self.fn = fn
        self.scans = scans  # list[(table, alias, columns)]
        self.scan_modes = scan_modes  # list[mode]
        self.out_names = out_names
        self.n_shards = n_shards


def plan_scan_modes(plan: LogicalPlan, catalog) -> dict:
    """Placement per scan: replicate small tables; big tables shard — by
    HASH of a single integer distribution column when declared (enabling
    colocate joins: the host placement uses the same splitmix64 bucketing
    as the device shuffle), else by row range."""
    modes = {}

    def rec(p):
        if isinstance(p, LScan):
            t = catalog.get_table(p.table)
            rows = t.row_count if t is not None else 0
            if rows < SHARD_THRESHOLD_ROWS:
                modes[id(p)] = REPLICATED
            else:
                mode = SHARDED
                dist = getattr(t, "distribution", ())
                if len(dist) == 1 and dist[0] in p.columns:
                    f = t.schema.field(dist[0])
                    if f.type.is_integer:
                        mode = ("hash", f"{p.alias}.{dist[0]}")
                modes[id(p)] = mode
        for c in p.children:
            rec(c)

    rec(plan)
    return modes


def _is_dist(mode) -> bool:
    return mode != REPLICATED


def _hash_col(mode):
    return mode[1] if isinstance(mode, tuple) and mode[0] == "hash" else None


# --- values over the shards ----------------------------------------------


def first(v):
    """A shard's chunk, for what every shard shares (schema, dictionaries,
    capacity)."""
    return v[0] if isinstance(v, tuple) else v


def compile_distributed(
    plan: LogicalPlan, catalog, caps: Caps, mesh,
    scan_modes: dict | None = None,
    recorder=None, fragment=None,
) -> DistCompiled:
    """recorder: optional fragments.ExchangeRecorder — `note`d immediately
    before every collective with the plan edge it implements (the
    fragment-IR annotation source; no drift from the lowering by
    construction). fragment: optional fragments.Fragment — run only the
    subtree rooted at fragment.root, resolving fragment.boundary nodes from
    the extra `bnd` argument of step instead of emitting them."""
    n_shards = mesh.n
    scan_modes = scan_modes or plan_scan_modes(plan, catalog)

    def smap(fn, *vals):
        """fn over the shards: once per shard when any input is a shard
        tuple (a REPLICATED input joins every shard's call, as its copy on
        that shard's device: one copy per device inside
        `mesh.replicas`), else once."""
        n = next((len(v) for v in vals if isinstance(v, tuple)), None)
        if n is None:
            return fn(*vals)
        devs = mesh.local_devices
        return tuple(fn(*(v[i] if isinstance(v, tuple)
                          else mesh.to(v, devs[i]) for v in vals))
                     for i in range(n))

    def smap2(fn, *vals):
        """smap for an fn returning a pair: (firsts, seconds) in the
        inputs' placement."""
        if not any(isinstance(v, tuple) for v in vals):
            return fn(*vals)
        outs = smap(fn, *vals)
        return tuple(o[0] for o in outs), tuple(o[1] for o in outs)

    def smax(v):
        """An overflow check over the shards: the max (one device scalar
        on the home device)."""
        if not isinstance(v, tuple):
            return v
        return torch.stack([x.reshape(()).to(torch.int64).to(mesh.device)
                            for x in v]).max()

    scans: list = []
    node_ord: dict = {}
    # deterministic pre-order ordinals: capacity/check keys (shufL_3,
    # agg_5, ...) are identical whether the plan runs as one program or one
    # fragment at a time — fragments share the adaptive capacity state
    for _n in walk_plan(plan):
        node_ord.setdefault(_n, len(node_ord))

    def ordinal(p) -> int:
        return node_ord.setdefault(p, len(node_ord))

    if recorder is not None:
        def note(parent, side, child, kind, keys, out_mode, payload,
                 child_mode, chunk):
            recorder.note(parent, side, child, kind, keys, out_mode,
                          payload, child_mode, first(chunk))
    else:
        def note(*a, **k):
            return None

    root_node = plan if fragment is None else fragment.root

    scan_index: dict = {}
    scan_mode_list: list = []

    def collect(p):
        if isinstance(p, LScan):
            if id(p) not in scan_index:
                scan_index[id(p)] = len(scans)
                scans.append((p.table, p.alias, p.columns))
                scan_mode_list.append(scan_modes.get(id(p), REPLICATED))
        for c in p.children:
            collect(c)

    collect(plan)

    def gather(chunk, mode):
        if mode == REPLICATED:
            return chunk
        return all_gather_chunk(chunk, mesh)  # range- and hash-sharded alike

    def step(inputs, bnd=()):
        """The program: inputs are the scans' values (a shard tuple or one
        REPLICATED Chunk each), `bnd` the fragment-boundary values
        (upstream fragment outputs), empty for a monolithic run. Returns
        (value, {check key: device scalar})."""
        emit_memo: dict = {}
        checks: dict = {}
        bnd_vals = list(bnd)

        def emit(p):
            if p in emit_memo:
                return emit_memo[p]
            out = _emit(p)
            emit_memo[p] = out
            return out

        def _emit(p):
            if fragment is not None and p in fragment.boundary:
                # fragment edge: the subtree below p ran upstream; resume
                # from its output in the recorded mode (checked FIRST so
                # the sink fragment — root == plan in boundary — resolves
                # to the boundary, not a re-emission)
                slot, bmode = fragment.boundary[p]
                return bnd_vals[slot], bmode
            if isinstance(p, LScan):
                i = scan_index[id(p)]
                return inputs[i], scan_mode_list[i]
            if isinstance(p, LFilter):
                c, m = emit(p.child)
                return smap(lambda x: filter_chunk(x, p.predicate), c), m
            if isinstance(p, LProject):
                c, m = emit(p.child)
                hc = _hash_col(m)
                if hc is not None:
                    # keep colocate info only if the hash column passes through
                    m = SHARDED
                    for n, e in p.exprs:
                        if isinstance(e, Col) and e.name == hc:
                            m = ("hash", n)
                            break
                exprs = [e for _, e in p.exprs]
                names = [n for n, _ in p.exprs]
                return smap(lambda x: project(x, exprs, names), c), m
            if isinstance(p, LWindow):
                return emit_window(p)
            if isinstance(p, LUnnest):
                return emit_unnest(p)
            if isinstance(p, LSort):
                return emit_sort(p)
            if isinstance(p, LLimit):
                c, m = emit(p.child)
                if _is_dist(m) and p.limit is not None:
                    # push the LIMIT through the exchange: any row in the
                    # global first limit+offset is within its shard's first
                    # limit+offset, so pre-limit + compact and gather only
                    # ~k*shards rows
                    k = p.limit + p.offset
                    c = smap(lambda x: limit_chunk(x, k, 0), c)
                    kcap = pad_capacity(k)
                    if kcap < first(c).capacity:
                        c = smap(lambda x: compact(x, kcap)[0], c)
                if _is_dist(m):
                    note(p, 0, p.child, "gather", (), REPLICATED, "limit",
                         m, c)
                return (limit_chunk(gather(c, m), p.limit, p.offset),
                        REPLICATED)
            if isinstance(p, LUnion):
                from ..ops.setops import union_all

                out, m = emit(p.inputs[0])
                if _is_dist(m):
                    note(p, 0, p.inputs[0], "gather", (), REPLICATED,
                         "rows", m, out)
                out = gather(out, m)
                for i, child in enumerate(p.inputs[1:], start=1):
                    c2, m2 = emit(child)
                    if _is_dist(m2):
                        note(p, i, child, "gather", (), REPLICATED,
                             "rows", m2, c2)
                    out = union_all(out, gather(c2, m2))
                return out, REPLICATED
            if isinstance(p, LAggregate):
                return emit_agg(p)
            if isinstance(p, LJoin):
                return emit_join(p)
            raise PlanError(f"cannot compile {type(p).__name__} distributed")

        def _emit_ctrs(p, ctrs, dist: bool):
            """'~ctr_' profile counters ride the checks channel, whose host
            merge takes the MAX. A sharded stage's per-shard counts SUM
            instead (the psum of the JAX program); a replicated stage's
            value is the value."""
            for nm in (ctrs[0] if dist else ctrs):
                if dist:
                    v = mesh.psum([torch.as_tensor(c[nm]).reshape(()).to(
                        torch.int64) for c in ctrs])
                else:
                    v = ctrs[nm]
                checks[f"~ctr_{nm}@{ordinal(p)}"] = v

        def emit_window(p: LWindow):
            """PARTITION BY windows are independent per partition, so a
            sharded input shuffles by partition key and each shard computes
            its own partitions locally. Unpartitioned windows (global
            ranks/running totals) still need the gather."""
            c, m = emit(p.child)

            def win(chunk, dist: bool):
                def one(x):
                    ctrs: dict = {}
                    return window_op(x, p.partition_by, p.order_by, p.funcs,
                                     limit_spec=p.limit, counters=ctrs), ctrs

                out, ctrs = smap2(one, chunk)
                _emit_ctrs(p, ctrs, dist)
                return out

            if not p.partition_by or not _is_dist(m):
                if _is_dist(m):
                    note(p, 0, p.child, "gather", (), REPLICATED,
                         "rows", m, c)
                c = gather(c, m)
                return win(c, False), REPLICATED
            hc = _hash_col(m)
            # hash column among the partition keys => every partition is
            # wholly on one shard already (subset colocation rule)
            aligned = hc is not None and any(
                isinstance(e, Col) and e.name == hc for e in p.partition_by
            )
            out_mode = m if aligned else SHARDED
            if not aligned:
                if (len(p.partition_by) == 1
                        and isinstance(p.partition_by[0], Col)):
                    out_mode = ("hash", p.partition_by[0].name)
                key = f"win_{ordinal(p)}"
                bcap = caps.get(key, _default_bucket_cap(first(c).capacity,
                                                          n_shards))
                note(p, 0, p.child, "hash", tuple(p.partition_by), out_mode,
                     "rows", m, c)
                c, mxb = shuffle_chunk(c, tuple(p.partition_by), mesh, bcap)
                checks[key] = smax(mxb)
            return win(c, True), out_mode

        def emit_sort(p: LSort):
            c, m = emit(p.child)

            def srt(chunk, limit, dist: bool):
                def one(x):
                    ctrs: dict = {}
                    return sort_chunk(x, p.keys, limit, counters=ctrs), ctrs

                out, ctrs = smap2(one, chunk)
                _emit_ctrs(p, ctrs, dist)
                return out

            if not _is_dist(m):
                return srt(c, p.limit, False), REPLICATED
            if p.limit is not None:
                # distributed TopN: per-shard TopN, compact to ~limit rows,
                # gather only k*shards rows, final TopN — the LIMIT+ORDER
                # pushed through the exchange (chunks_sorter_topn.h analog)
                local = srt(c, p.limit, True)
                kcap = pad_capacity(p.limit)
                if kcap < first(local).capacity:
                    local = smap(lambda x: compact(x, kcap)[0], local)
                note(p, 0, p.child, "gather", (), REPLICATED, "topn",
                     m, local)
                gathered = all_gather_chunk(local, mesh)
                return sort_chunk(gathered, p.keys, p.limit), REPLICATED
            rank = smap(lambda x: _single_sort_rank(x, p.keys), c)
            if first(rank) is None:
                note(p, 0, p.child, "gather", (), REPLICATED, "rows", m, c)
                return sort_chunk(gather(c, m), p.keys, None), REPLICATED
            # full distributed sort: range exchange by sampled splitters,
            # then local sort — shards end range-ordered, so the final
            # gather concatenates into global order
            key = f"sort_{ordinal(p)}"
            bcap = caps.get(key, _default_bucket_cap(first(c).capacity,
                                                      n_shards))
            note(p, 0, p.child, "range", (p.keys[0][0],), RANGE_SHARDED,
                 "rows", m, c)
            part, mxb = range_partition_chunk(c, rank, mesh, bcap)
            checks[key] = smax(mxb)
            return smap(lambda x: sort_chunk(x, p.keys, None), part), \
                RANGE_SHARDED

        def complete_agg(c, p, key, agg_default):
            """COMPLETE aggregation of a REPLICATED chunk (array_agg's
            element capacity rides its own check)."""
            kwargs = {}
            if any(a.fn == "array_agg" for _, a in p.aggs):
                akey = f"aggarr_{ordinal(p)}"
                aux: dict = {}
                kwargs = {"arr_cap": caps.get(akey, 256), "aux_checks": aux}
            out, ng = hash_aggregate(c, p.group_by, p.aggs,
                                     caps.get(key, agg_default), **kwargs)
            checks[key] = ng
            if kwargs:
                checks[akey] = aux["array_agg_max"]
            return out, REPLICATED

        def emit_agg(p: LAggregate):
            c, m = emit(p.child)
            key = f"agg_{ordinal(p)}"
            agg_default = 1024 if p.group_by else 1
            if m == REPLICATED:
                return complete_agg(c, p, key, agg_default)
            final_group_by = tuple((n, Col(n)) for n, _ in p.group_by)
            est = estimated_group_ndv(p, catalog)
            hc = _hash_col(m)
            hash_out = next(
                (n for n, e in p.group_by
                 if isinstance(e, Col) and e.name == hc),
                None,
            ) if hc is not None else None
            cap_in = first(c).capacity
            if hash_out is not None:
                # input hash-placed on a SUBSET of the group keys: every
                # group lives entirely on one shard, so one COMPLETE local
                # agg is exact with no collective (colocate agg). Capacity
                # seeded from the NDV estimate (per-shard share, 2x skew)
                default = 1024 if est is None else pad_capacity(
                    int(min(est * 2 // n_shards + 1024, cap_in))
                )
                gcap = caps.get(key, default)
                out, ng = smap2(lambda x: hash_aggregate(
                    x, p.group_by, p.aggs, gcap), c)
                checks[key] = smax(ng)
                return out, ("hash", hash_out)
            if not decomposable(p.aggs):
                # holistic aggregates (percentile family) need every group
                # value in one place: gather rows, aggregate COMPLETE
                note(p, 0, p.child, "gather", (), REPLICATED, "rows", m, c)
                return complete_agg(all_gather_chunk(c, mesh), p, key,
                                    agg_default)
            if est is not None and est > SHUFFLE_AGG_MIN_GROUPS:
                # high cardinality: shuffle partial states by group key so
                # each shard finalizes only its own key range. Partial
                # capacity seeded from the estimate (bounded by the input)
                cap = caps.get(key, pad_capacity(int(min(est, cap_in))))
                part, png = smap2(lambda x: hash_aggregate(
                    x, p.group_by, p.aggs, cap, mode=PARTIAL), c)
                checks[key] = smax(png)
                bkey = f"aggbkt_{ordinal(p)}"
                bcap = caps.get(
                    bkey, pad_capacity(max(cap // max(n_shards // 2, 1), 16))
                )
                key_cols = tuple(Col(n) for n, _ in p.group_by)
                # output is hash-placed on the (single) group column's
                # values with the standard shuffle recipe -> colocate-able
                out_mode = (
                    ("hash", p.group_by[0][0]) if len(p.group_by) == 1
                    else SHARDED
                )
                note(p, 0, p.child, "hash", key_cols, out_mode, "partial",
                     m, part)
                merged, mxb = shuffle_chunk(part, key_cols, mesh, bcap)
                checks[bkey] = smax(mxb)
                # final capacity = received capacity: the group count there
                # is bounded by the received rows, so it cannot overflow
                finals = final_agg_exprs(p.aggs)
                out, _ng = smap2(lambda x: hash_aggregate(
                    x, final_group_by, finals, n_shards * bcap, mode=FINAL),
                    merged)
                return out, out_mode
            # two-phase: local partial -> all_gather -> final
            cap = caps.get(key, agg_default)
            part, png = smap2(lambda x: hash_aggregate(
                x, p.group_by, p.aggs, cap, mode=PARTIAL), c)
            note(p, 0, p.child, "gather", (), REPLICATED, "partial", m, part)
            merged = all_gather_chunk(part, mesh)
            out, ng = hash_aggregate(
                merged, final_group_by, final_agg_exprs(p.aggs), cap,
                mode=FINAL)
            # both partial and final counts must fit the capacity
            checks[key] = torch.maximum(smax(png), ng)
            return out, REPLICATED

        def emit_unnest(p: LUnnest):
            from ..ops.unnest import unnest_op

            c, m = emit(p.child)
            key = f"unnest_{ordinal(p)}"
            cap = caps.get(key, pad_capacity(first(c).capacity * 4))
            out, total = smap2(lambda x: unnest_op(x, p.expr, p.out_name,
                                                   cap), c)
            checks[key] = smax(total)
            return out, m

        def emit_join(p: LJoin):
            lc, lm = emit(p.left)
            rc, rm = emit(p.right)
            # pre-degrade modes: what emit(child) returned — the fragment-
            # boundary mode a consumer fragment resumes with
            lm0, rm0 = lm, rm
            # joins reorder rows: a range-ordered input degrades to plain
            # sharded (placement survives, global ordering does not)
            lm = SHARDED if lm == RANGE_SHARDED else lm
            rm = SHARDED if rm == RANGE_SHARDED else rm
            lcols = frozenset(p.left.output_names())
            rcols = frozenset(p.right.output_names())

            probe_keys, build_keys, residual = [], [], []
            for conj in (_conjuncts(p.condition)
                         if p.condition is not None else []):
                pair = _equi_pair(conj, lcols, rcols)
                if pair is not None:
                    probe_keys.append(pair[0])
                    build_keys.append(pair[1])
                else:
                    residual.append(conj)

            kind = {
                "inner": INNER, "left": LEFT_OUTER, "semi": LEFT_SEMI,
                "anti": LEFT_ANTI, "cross": INNER,
            }[p.kind]

            if not probe_keys:
                probe_keys, build_keys = [Lit(0)], [Lit(0)]
                bit_widths = (2,)
                unique = False
                if _is_dist(lm) and _is_dist(rm):
                    # shuffling a constant key would funnel everything onto
                    # one shard; gather the build side, cross-join locally
                    note(p, 1, p.right, "broadcast", (), REPLICATED,
                         "rows", rm0, rc)
                    rc = all_gather_chunk(rc, mesh)
                    rm = REPLICATED
            else:
                from ..ops.join import align_chunk_dicts
                from .physical import choose_key_packing

                bit_widths, residual, unique = choose_key_packing(
                    p, probe_keys, build_keys, residual, catalog
                )
                # equal strings must carry equal codes before any per-side
                # routing (shuffle/colocate placement)
                lc2, rc2 = _align_pair(lc, rc, probe_keys, build_keys,
                                       align_chunk_dicts)
                if first(lc2) is not first(lc) or first(rc2) is not first(rc):
                    # remapped codes no longer match the host hash placement
                    # of a colocate scan: drop placement claims, force the
                    # generic shuffle on the merged codes
                    lc, rc = lc2, rc2
                    lm = SHARDED if _is_dist(lm) else lm
                    rm = SHARDED if _is_dist(rm) else rm
                if _is_dist(lm) and _is_dist(rm):
                    # dict-typed EXPRESSION keys (upper(k) etc.) build fresh
                    # per-side dicts whose codes cannot be aligned at the
                    # column level above — per-side routing would send
                    # equal strings to different shards. Gather the build
                    # side instead: the local join aligns evaluated keys
                    pks_e = eval_keys(first(lc), tuple(probe_keys))
                    bks_e = eval_keys(first(rc), tuple(build_keys))
                    for pe, be, pk_x, bk_x in zip(
                            pks_e, bks_e, probe_keys, build_keys):
                        if ((pe.dict is not None or be.dict is not None)
                                and not (isinstance(pk_x, Col)
                                         and isinstance(bk_x, Col))):
                            note(p, 1, p.right, "broadcast", (), REPLICATED,
                                 "rows", rm0, rc)
                            rc = all_gather_chunk(rc, mesh)
                            rm = REPLICATED
                            break

            # build-side runtime filter on the probe; with a sharded build
            # the local summaries merge across the shards — pmin/pmax for
            # the range filter, bitwise OR for the dense bitmap AND the
            # bloom bitset (the global-RF collective). Strategy ladder as
            # in the single-device compiler: dense > bloom > min/max
            from ..ops.join import bloom_filter_mask, runtime_filter_mask
            from ..runtime.config import config as _cfg
            from .optimizer import estimate_rows
            from .physical import (
                bloom_rf_bits, bloom_rf_useful, dense_rf_range,
                rf_strategy_of,
            )

            strategy = rf_strategy_of(_cfg)
            if p.kind in ("inner", "semi", "cross") and probe_keys and not (
                len(probe_keys) == 1 and isinstance(probe_keys[0], Lit)
            ) and strategy != "off":
                rf_mesh = mesh if _is_dist(rm) else None
                dr = (dense_rf_range(p.left, p.right, probe_keys, build_keys,
                                     catalog)
                      if strategy == "auto" else None)
                bloom = None
                if dr is None and (strategy == "bloom" or (
                        strategy == "auto"
                        and bloom_rf_useful(p, probe_keys, build_keys,
                                            catalog))):
                    bloom = bloom_rf_bits(estimate_rows(p.right, catalog),
                                          _cfg.get("rf_bloom_max_bits"))
                n0 = smap(lambda x: x.num_rows(), lc)
                pk_t, bk_t = tuple(probe_keys), tuple(build_keys)
                if dr is None and bloom is not None:
                    bits, _exactish = bloom

                    def rf(a, b):
                        return bloom_filter_mask(a, b, pk_t, bk_t, bit_widths,
                                                 rf_mesh, bits=bits)
                    # replicated: the host max-merge gives the value
                    checks[f"~ctr_rf_bloom_bits@{ordinal(p)}"] = bits
                else:
                    def rf(a, b):
                        return runtime_filter_mask(a, b, pk_t, bk_t,
                                                   bit_widths, rf_mesh,
                                                   dense_range=dr)
                if rf_mesh is not None:
                    mask = rf(lc, rc)
                else:
                    mask = smap(rf, lc, rc)
                lc = smap(lambda x, mk: x.and_sel(mk), lc, mask)
                pruned = smap(lambda a, x: a - x.num_rows(), n0, lc)
                if _is_dist(lm):
                    # per-shard prune counts SUM to the global total
                    pruned = mesh.psum(list(pruned))
                checks[f"~ctr_rf_rows_pruned@{ordinal(p)}"] = pruned

            # --- distribution strategy ---
            def align_pos(mode, keys):
                """Index of the equi-key pair this side is hash-placed on
                (subset colocation: matching rows agree on ALL equi keys,
                so placement by any ONE equated column keeps them
                together)."""
                hc = _hash_col(mode)
                if hc is None:
                    return None
                for i, k in enumerate(keys):
                    if isinstance(k, Col) and k.name == hc:
                        return i
                return None

            if _is_dist(lm) and _is_dist(rm):
                li = align_pos(lm, probe_keys)
                ri = align_pos(rm, build_keys)

                def shuffle_side(chunk, keys_, key_name):
                    cap_k = caps.get(
                        key_name, _default_bucket_cap(first(chunk).capacity,
                                                      n_shards)
                    )
                    out, mx = shuffle_chunk(chunk, tuple(keys_), mesh, cap_k,
                                            bit_widths)
                    checks[key_name] = smax(mx)
                    return out

                def shuf_mode(keys_):
                    # post-shuffle placement: hash-placed on the single Col
                    # key (colocate token) or plain sharded otherwise
                    if len(keys_) == 1 and isinstance(keys_[0], Col):
                        return ("hash", keys_[0].name)
                    return SHARDED

                # colocate when both sides sit on the same equated pair; a
                # single aligned side pulls the other to ITS placement
                # (shuffle by just the equated column); else shuffle both
                # sides by the full key tuple
                if li is not None and ri == li:
                    anchor = li
                elif li is not None:
                    ks = [build_keys[li]]
                    note(p, 1, p.right, "hash", tuple(ks), shuf_mode(ks),
                         "rows", rm0, rc)
                    rc = shuffle_side(rc, ks, f"shufR_{ordinal(p)}")
                    anchor = li
                elif ri is not None:
                    ks = [probe_keys[ri]]
                    note(p, 0, p.left, "hash", tuple(ks), shuf_mode(ks),
                         "rows", lm0, lc)
                    lc = shuffle_side(lc, ks, f"shufL_{ordinal(p)}")
                    anchor = ri
                else:
                    note(p, 0, p.left, "hash", tuple(probe_keys),
                         shuf_mode(probe_keys), "rows", lm0, lc)
                    lc = shuffle_side(lc, probe_keys, f"shufL_{ordinal(p)}")
                    note(p, 1, p.right, "hash", tuple(build_keys),
                         shuf_mode(build_keys), "rows", rm0, rc)
                    rc = shuffle_side(rc, build_keys, f"shufR_{ordinal(p)}")
                    anchor = 0 if len(probe_keys) == 1 else None
                if anchor is not None and isinstance(probe_keys[anchor], Col):
                    out_mode = ("hash", probe_keys[anchor].name)
                else:
                    out_mode = SHARDED
            elif _is_dist(rm):  # probe replicated, build sharded: gather build
                note(p, 1, p.right, "broadcast", (), REPLICATED,
                     "rows", rm0, rc)
                rc = all_gather_chunk(rc, mesh)
                out_mode = REPLICATED if lm == REPLICATED else lm
            else:
                # build replicated: local (broadcast) join, placed as the
                # probe
                out_mode = lm

            payload = (
                [] if p.kind in ("semi", "anti")
                else list(p.right.output_names())
            )
            pk_t, bk_t = tuple(probe_keys), tuple(build_keys)

            if residual and p.kind in ("semi", "anti"):
                rid = f"__rowid_{ordinal(p)}"
                key = f"join_{ordinal(p)}"
                cap = caps.get(key, pad_capacity(first(lc).capacity))
                rpay = list(p.right.output_names())
                pred = and_all(residual)
                jt = LEFT_SEMI if p.kind == "semi" else LEFT_ANTI

                def semi_residual(a, b):
                    rowid = torch.arange(a.capacity, dtype=torch.int64,
                                         device=a.device)
                    a2 = a.with_columns([Field(rid, T.BIGINT, False)],
                                        [rowid], [None])
                    expanded, total = hash_join_expand(
                        a2, b, pk_t, bk_t, cap, INNER, payload=rpay,
                        bit_widths=bit_widths)
                    matched = filter_chunk(expanded, pred)
                    ids, _ = hash_aggregate(matched, ((rid, Col(rid)),), (),
                                            a.capacity)
                    return hash_join_unique(a2, ids, (Col(rid),), (Col(rid),),
                                            jt, payload=[]), total

                out, total = smap2(semi_residual, lc, rc)
                checks[key] = smax(total)
                return out, out_mode

            if unique and p.kind in ("inner", "left", "semi", "anti"):
                if residual and p.kind != "inner":
                    raise PlanError(f"residual on {p.kind} join unsupported")
                out = smap(lambda a, b: hash_join_unique(
                    a, b, pk_t, bk_t, kind, payload=payload,
                    bit_widths=bit_widths), lc, rc)
                if residual:
                    pred = and_all(residual)
                    out = smap(lambda x: filter_chunk(x, pred), out)
                return out, out_mode

            if residual and p.kind not in ("inner", "cross"):
                raise PlanError(f"residual on {p.kind} join unsupported")
            key = f"join_{ordinal(p)}"
            cap = caps.get(key, pad_capacity(first(lc).capacity))
            out, total = smap2(lambda a, b: hash_join_expand(
                a, b, pk_t, bk_t, cap, kind, payload=payload,
                bit_widths=bit_widths), lc, rc)
            if p.kind not in ("semi", "anti"):
                checks[key] = smax(total)
            if residual:
                pred = and_all(residual)
                out = smap(lambda x: filter_chunk(x, pred), out)
            return out, out_mode

        # REPLICATED inputs of per-shard calls: one copy per device
        with mesh.replicas():
            chunk, mode = emit(root_node)
        # the emit closures form a reference cycle through the memo and
        # the boundary values: drop them now, not when the cyclic
        # collector runs
        emit_memo.clear()
        bnd_vals.clear()
        if mode != REPLICATED and (fragment is None or fragment.sink):
            # result delivery: the coordinator gather (sink fragments only
            # — interior fragments hand their sharded output on)
            note(None, 0, root_node, "gather", (), REPLICATED, "rows",
                 mode, chunk)
            chunk = all_gather_chunk(chunk, mesh)
        # the closures hold `checks` too: the caller gets its own dict
        out_checks = dict(checks)
        checks.clear()
        return chunk, out_checks

    return DistCompiled(
        step, scans, scan_mode_list, root_node.output_names(), n_shards
    )


def _align_pair(lc, rc, probe_keys, build_keys, align):
    """align_chunk_dicts over the shards, each side kept in its placement
    (the merged dictionaries depend on the dictionaries alone, so a
    REPLICATED side aligns once, against the first shard)."""
    n = len(lc) if isinstance(lc, tuple) else (
        len(rc) if isinstance(rc, tuple) else 1)
    ls = lc if isinstance(lc, tuple) else (lc,) * n
    rs = rc if isinstance(rc, tuple) else (rc,) * n
    pairs = [align(a, b, probe_keys, build_keys) for a, b in zip(ls, rs)]
    lc2 = tuple(a for a, _ in pairs) if isinstance(lc, tuple) else pairs[0][0]
    rc2 = tuple(b for _, b in pairs) if isinstance(rc, tuple) else pairs[0][1]
    return lc2, rc2
