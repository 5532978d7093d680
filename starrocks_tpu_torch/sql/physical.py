"""Physical planning + compilation to one eager chunk program.

Reference behavior: fe sql/plan/PlanFragmentBuilder.java:268 (physical plan ->
fragments) + BE pipeline building (exec/runtime/pipeline_builder_context.h:106).
A copy of the JAX package's planner: the whole (single-device) physical plan
becomes ONE callable Chunk inputs -> result Chunk, here run eagerly over
torch tensors instead of traced by jax.jit. Operator capacities (group
counts, join expansion sizes) stay static knobs with true-count "checks"
returned so the executor can retry on overflow — the same contract, so the
two packages pick the same operators and capacities for the same plan.

The planning helpers (choose_key_packing, dense_rf_range, the runtime-filter
ladder, maybe_compact, the 24x expand rule, the multiway LUT probe) are the
reference's, unchanged. LUnion concatenates its inputs (ops/setops.py);
LWindow runs ops/window.py, behind the window top-N prefilter where the
function set allows it; LUnnest explodes an ARRAY (ops/unnest.py) into a
capacity checked like any join expansion.

Planning decisions made here:
- join implementation: unique-build gather join when the build side is
  provably unique on the join keys (catalog unique_keys + plan derivation),
  else run-length expansion join;
- multi-key packing bit widths from catalog column stats via provenance;
- residual (non-equi) join predicates applied as post-join filters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..exprs.ir import AggExpr, Call, Col, Expr, Lit
from ..ops import (
    INNER, LEFT_ANTI, LEFT_OUTER, LEFT_SEMI,
    filter_chunk, hash_aggregate, hash_join_expand, hash_join_unique,
    limit_chunk, project, sort_chunk,
)
from ..ops.setops import union_all
from ..ops.window import (
    window_op, window_topn_prefilter, window_topn_prefilter_safe,
)
from ..column.column import pad_capacity
from .analyzer import _conjuncts
from .logical import (
    LAggregate, LFilter, LJoin, LLimit, LProject, LScan, LSort, LUnion,
    LUnnest, LWindow, LogicalPlan,
)
from .optimizer import and_all, col_origin, estimate_rows, expr_cols


class PlanError(ValueError):
    pass


def _dense_agg_domain_max(cfg) -> int:
    """Largest group-key domain the planner will cover with a dense packed-gid
    capacity. 0 (default) = auto: the reference's CPU value on every device
    (the port runs plain scatter reductions everywhere, like the reference
    on the CPU — see ops/segment.py), so both packages plan alike."""
    v = cfg.get("dense_agg_domain_max")
    if v:
        return v
    return 1 << 24


# --- plan properties ---------------------------------------------------------


def unique_sets(plan: LogicalPlan, catalog) -> set:
    """Column-name sets that are unique per output row."""
    if isinstance(plan, LScan):
        t = catalog.get_table(plan.table)
        out = set()
        if t is not None:
            for keys in t.unique_keys:
                qk = tuple(f"{plan.alias}.{k}" for k in keys)
                if all(k in plan.output_names() for k in qk):
                    out.add(frozenset(qk))
        return out
    if isinstance(plan, LFilter):
        return unique_sets(plan.child, catalog)
    if isinstance(plan, (LSort, LLimit, LWindow)):
        return unique_sets(plan.child, catalog)
    if isinstance(plan, LProject):
        child = unique_sets(plan.child, catalog)
        passthrough = {
            e.name: n for n, e in plan.exprs if isinstance(e, Col)
        }
        out = set()
        for s in child:
            if all(c in passthrough for c in s):
                out.add(frozenset(passthrough[c] for c in s))
        return out
    if isinstance(plan, LAggregate):
        if plan.group_by:
            return {frozenset(n for n, _ in plan.group_by)}
        return set()
    if isinstance(plan, LJoin):
        if plan.kind in ("semi", "anti"):
            return unique_sets(plan.left, catalog)
        if plan.kind in ("inner", "left") and plan.condition is not None:
            # joining AGAINST a side that is unique on its join keys never
            # duplicates the other side's rows (FK -> PK lookup), so the
            # other side's unique sets survive — e.g. orders stays unique
            # on o_orderkey through the customer join, letting the next
            # join upstream keep the 1:1 gather path (TPC-H Q18).
            # Residual conjuncts only remove rows, which preserves
            # uniqueness.
            probe_keys, build_keys, _ = join_equi_keys(plan)
            lsets = unique_sets(plan.left, catalog)
            rsets = unique_sets(plan.right, catalog)
            out = set()
            if probe_keys and all(isinstance(k, Col) for k in build_keys):
                ks = frozenset(k.name for k in build_keys)
                if any(u <= ks for u in rsets):
                    out |= lsets
            if probe_keys and all(isinstance(k, Col) for k in probe_keys):
                ks = frozenset(k.name for k in probe_keys)
                if any(u <= ks for u in lsets):
                    out |= rsets
            return out
        return set()
    return set()


def rf_strategy_of(cfg) -> str:
    """Effective probe runtime-filter strategy: `runtime_filter_strategy`
    gated by the master `enable_runtime_filters` toggle. Shared by the
    single-chip and distributed compilers (plans must never diverge)."""
    if not cfg.get("enable_runtime_filters"):
        return "off"
    s = cfg.get("runtime_filter_strategy")
    return s if s in ("auto", "minmax", "bloom", "off") else "auto"


def _floor_pow2(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def bloom_rf_useful(p, probe_keys, build_keys, catalog) -> bool:
    """False for membership filters that cannot prune: a build whose key
    set covers the probe's (a pure FK dimension, e.g. TPC-H Q9's lineitem
    x partsupp) keeps every probe row, so the bloom would pay its build
    scatter + probe gathers for zero pruned rows. Decided on cardinality
    evidence, not plan shape (selective builds may be semi-join rewrites
    with no literal LFilter below): a build estimated well under its key
    column's origin-table rows is filtered -> useful; otherwise compare
    the build size against the probe's key-TUPLE cardinality, estimated
    with full correlation WITHIN one origin table (TPC-H Q9's
    (l_partkey, l_suppkey) tuple set IS partsupp's key set — the naive
    NDV product over-counts it 2500x) and independence ACROSS tables
    (Q7's (l_suppkey, c_nationkey) pair really does take the cross
    product, so a supplier-sized build prunes ~(1 - 1/|nation|))."""
    est_b = estimate_rows(p.right, catalog)
    for bk in build_keys:
        if isinstance(bk, Col):
            origin = col_origin(p.right, bk.name)
            if origin is not None:
                t = catalog.get_table(origin[0])
                if t is not None and est_b < 0.8 * max(t.row_count, 1):
                    return True
    from .optimizer import _key_ndv

    l_est = estimate_rows(p.left, catalog)
    per_table: dict = {}
    for pk in probe_keys:
        if isinstance(pk, Col):
            origin = col_origin(p.left, pk.name)
            tbl = origin[0] if origin is not None else pk.name
            nv = _key_ndv(p.left, pk.name, l_est, catalog)
            per_table[tbl] = max(per_table.get(tbl, 1.0), nv)
    ndv = 1.0
    for nv in per_table.values():
        ndv *= nv
    ndv = min(ndv, max(l_est, 1.0))
    return est_b < 0.5 * ndv


def bloom_rf_bits(build_rows_est: float, max_bits: int):
    """(bits, exactish) sizing a bloom RF at ~8 bits per estimated build row
    (2 probes -> ~5% false positives), power-of-2, capped by
    `rf_bloom_max_bits`. None when even the capped array would hold under
    1 bit/key (fp ~75%+ — the probes cost more than they prune). exactish
    marks an uncapped sizing: fp is low enough that the planner may compact
    the filtered probe to the join estimate, like the dense bitmap path."""
    want_n = int(8 * max(build_rows_est, 1.0))
    want = max(1 << (want_n - 1).bit_length(), 1 << 12)
    cap = max(_floor_pow2(max_bits), 1 << 12)
    bits = min(want, cap)
    if bits < build_rows_est:
        return None
    return bits, bits >= want


DENSE_RF_MAX_RANGE = 1 << 23  # dense presence bitmaps up to 8M slots
# (covers l_orderkey's 6M domain at SF1: TPC-H Q18's orders-semi-subquery
# presence test rides one scatter + one gather instead of a 1.5M-row sort)
LUT_JOIN_MAX_RANGE = 1 << 24  # dense row-lookup tables up to 16M slots


def dense_rf_range(plan_l, plan_r, probe_keys, build_keys, catalog,
                   max_range: int = DENSE_RF_MAX_RANGE):
    """(lo, hi) for an exact IN-set runtime filter: the BUILD side's key
    range only (probe keys outside it fail in_range and are correctly
    dropped — they can't match anything); None when unbounded/too wide."""
    if len(probe_keys) != 1 or len(build_keys) != 1:
        return None
    pk, bk = probe_keys[0], build_keys[0]
    if not (isinstance(pk, Col) and isinstance(bk, Col)):
        return None
    origin = col_origin(plan_r, bk.name)
    if origin is None:
        return None
    t = catalog.get_table(origin[0])
    if t is None:
        return None
    f = t.schema.field(origin[1]) if t.schema is not None else None
    if f is None or f.type.is_string:
        # dict-string stats bound RAW per-table codes; the join compares
        # dictionary-ALIGNED codes, so a code-range membership test would
        # silently drop rows whose merged code falls outside the raw range
        return None
    st = t.column_stats(origin[1])
    if st.min is None or st.max is None:
        return None
    if st.max - st.min + 1 > max_range:
        return None
    return (st.min, st.max)


def _key_bit_width(plan, key: Expr, catalog) -> Optional[int]:
    if not isinstance(key, Col):
        return None
    origin = col_origin(plan, key.name)
    if origin is None:
        return None
    t = catalog.get_table(origin[0])
    if t is None:
        return None
    st = t.column_stats(origin[1])
    if st.max is None or (st.min is not None and st.min < 0):
        return None
    return max(int(st.max).bit_length() + 1, 2)


def choose_key_packing(p, probe_keys, build_keys, residual, catalog):
    """Decide how a join's key tuple packs into one int64 — shared by the
    single-chip and distributed compilers so their plans can never diverge.

    Returns (bit_widths, residual, unique):
    - bit_widths: None (single key as-is) | tuple of per-key bit widths from
      catalog stats | "hash" when the tuple doesn't fit 63 bits (wide ranges,
      strings, missing stats) — then the join runs on a 64-bit splitmix64
      fingerprint and equality is RE-VERIFIED by eq residuals appended here
      (collisions force the expansion join; the reference joins arbitrary
      key tuples via its hash table, this is the compiled-world equivalent);
    - unique: build side provably unique on the keys (never trusted in hash
      mode — fingerprint collisions would break the 1:1 gather join).
    """
    def _wide_key(plan, key) -> bool:
        if not isinstance(key, Col):
            return False
        origin = col_origin(plan, key.name)
        if origin is None:
            return False
        t = catalog.get_table(origin[0])
        f = (t.schema.field(origin[1])
             if t is not None and t.schema is not None else None)
        return f is not None and f.type.is_wide

    if any(_wide_key(p.left, pk) or _wide_key(p.right, bk)
           for pk, bk in zip(probe_keys, build_keys)):
        # rank-2 keys (DECIMAL128 limbs) can't pack into an int64 directly:
        # fingerprint them and re-verify with eq residuals
        return ("hash", residual + [
            Call("eq", pk, bk) for pk, bk in zip(probe_keys, build_keys)
        ], False)

    bit_widths = None
    if len(probe_keys) > 1:
        widths = []
        for pk, bk in zip(probe_keys, build_keys):
            w1 = _key_bit_width(p.left, pk, catalog)
            w2 = _key_bit_width(p.right, bk, catalog)
            if w1 is None or w2 is None:
                widths = None
                break
            widths.append(max(w1, w2))
        if widths is None or sum(widths) > 63:
            bit_widths = "hash"
            residual = residual + [
                Call("eq", pk, bk)
                for pk, bk in zip(probe_keys, build_keys)
            ]
        else:
            bit_widths = tuple(widths)
    if bit_widths == "hash":
        unique = False
    else:
        build_key_names = frozenset(
            k.name for k in build_keys if isinstance(k, Col)
        )
        unique = len(build_key_names) == len(build_keys) and any(
            s <= build_key_names for s in unique_sets(p.right, catalog)
        )
    return bit_widths, residual, unique


def join_equi_keys(p):
    """(probe_keys, build_keys, residual) split of a join's condition —
    THE single source for both the emit path and build_order_desc (they
    must agree or a cached argsort would permute differently-packed
    keys)."""
    lcols = frozenset(p.left.output_names())
    rcols = frozenset(p.right.output_names())
    probe_keys, build_keys, residual = [], [], []
    for conj in (_conjuncts(p.condition) if p.condition is not None else []):
        pair = _equi_pair(conj, lcols, rcols)
        if pair is not None:
            probe_keys.append(pair[0])
            build_keys.append(pair[1])
        else:
            residual.append(conj)
    return probe_keys, build_keys, residual


def build_order_desc(p, catalog):
    """Aux-input descriptor (table, alias, key_cols, bit_widths) for a
    cachable build-side sort permutation of join `p`, or None. Eligible when
    the build side is a PURE scan with integer/temporal Col keys — then the
    packed keys are a per-(table, keys) constant and the host caches their
    argsort like it caches device columns (the reference caches join hash
    tables per tablet the same way)."""
    from ..runtime.config import config as _cfg

    if not _cfg.get("enable_cached_build_sort"):
        return None
    if not isinstance(p.right, LScan) or p.condition is None:
        return None
    probe_keys, build_keys, residual = join_equi_keys(p)
    if not probe_keys:
        return None
    bit_widths, residual, unique = choose_key_packing(
        p, probe_keys, build_keys, residual, catalog)
    # 3 paths never argsort the build: the LUT join (unique bounded single
    # key), and the residual semi/anti bitmap path
    if residual and p.kind in ("semi", "anti"):
        return None
    if (unique and len(probe_keys) == 1
            and p.kind in ("inner", "left", "semi", "anti")
            and not (residual and p.kind != "inner")
            and dense_rf_range(p.left, p.right, probe_keys, build_keys,
                               catalog, max_range=LUT_JOIN_MAX_RANGE)
            is not None):
        return None
    if bit_widths == "hash" or not all(
        isinstance(k, Col) for k in build_keys
    ):
        return None
    key_cols = []
    for k in build_keys:
        origin = col_origin(p.right, k.name)
        if origin is None or origin[0] != p.right.table:
            return None
        t = catalog.get_table(origin[0])
        f = t.schema.field(origin[1]) if t is not None else None
        if f is None or not (f.type.is_integer or f.type.is_temporal):
            return None
        key_cols.append(origin[1])
    return (p.right.table, p.right.alias, tuple(key_cols), bit_widths)


def multiway_level(p, catalog):
    """Eligibility of ONE join as a level of the fused multiway probe: the
    hash_join_lut conditions — INNER, exactly one Col=Col equi key, no
    residual conjuncts, build side provably unique on the key with a
    stats-bounded dense range. Returns (probe_key, build_key, lo, hi) or
    None. Shared by the compiler (fusion decision) and the plan checker
    (analysis/plan_check.check_multiway re-verifies every fused level)."""
    if not isinstance(p, LJoin) or p.kind != "inner" or p.condition is None:
        return None
    probe_keys, build_keys, residual = join_equi_keys(p)
    if len(probe_keys) != 1 or residual:
        return None
    pk, bk = probe_keys[0], build_keys[0]
    if not (isinstance(pk, Col) and isinstance(bk, Col)):
        return None
    bit_widths, residual, unique = choose_key_packing(
        p, probe_keys, build_keys, [], catalog)
    if residual or bit_widths is not None or not unique:
        return None
    rng = dense_rf_range(p.left, p.right, probe_keys, build_keys, catalog,
                         max_range=LUT_JOIN_MAX_RANGE)
    if rng is None:
        return None
    return pk, bk, rng[0], rng[1]


def multiway_join_chain(p, catalog):
    """Free-Join-style multiway fusion target (arXiv 2301.10841): an
    inner-join REGION of 3+ relations where one fact/probe relation
    reaches every other through single-column equi keys and every other
    relation is a LUT-eligible unique build — the SSB/TPC-DS star shape,
    including snowflake arms (a level keyed by a lower level's payload,
    e.g. lineitem -> orders -> customer). The region is decomposed
    independently of the optimizer's binary join ORDER (DP may have built
    a bushy dim x dim plan — for inner joins any re-association that
    consumes the same conjunct set is equivalent), which is exactly Free
    Join's freedom to pick a variable order over the hypergraph.

    Returns (base_plan, levels) with levels = [(synthesized_join_node,
    (probe_key, build_key, lo, hi)), ...] in probe order, or None when the
    shape doesn't qualify — any region conjunct that is not consumed as a
    level key (residuals, composite keys, non-Col operands) falls the
    whole region back to the binary plan, so no predicate is ever lost.
    Gated behind `SET join_multiway_strategy = auto|off` (trace=True: the
    decision is baked into the compiled program and keys its cache)."""
    from ..runtime.config import config as _cfg

    if _cfg.get("join_multiway_strategy") != "auto":
        return None
    if not isinstance(p, LJoin) or p.kind not in ("inner", "cross"):
        return None
    from .optimizer import _flatten_join_region

    rels: list = []
    conjuncts: list = []
    _flatten_join_region(p, rels, conjuncts)
    if len(rels) < 3:
        return None
    for c in conjuncts:
        if not (isinstance(c, Call) and c.fn == "eq" and len(c.args) == 2
                and isinstance(c.args[0], Col)
                and isinstance(c.args[1], Col)):
            return None
    base_i = max(range(len(rels)),
                 key=lambda i: estimate_rows(rels[i], catalog))
    base = rels[base_i]
    remaining = [r for i, r in enumerate(rels) if i != base_i]
    out_sets = {id(r): frozenset(r.output_names()) for r in rels}
    avail = set(base.output_names())
    unused = list(conjuncts)
    cur = base
    levels = []
    progress = True
    while remaining and progress:
        progress = False
        for r in list(remaining):
            rcols = out_sets[id(r)]
            if rcols & avail:
                return None  # ambiguous duplicate output names
            for c in list(unused):
                a, b = c.args
                if a.name in avail and b.name in rcols:
                    pk_c, bk_c = a, b
                elif b.name in avail and a.name in rcols:
                    pk_c, bk_c = b, a
                else:
                    continue
                jn = LJoin(cur, r, "inner", Call("eq", pk_c, bk_c))
                lev = multiway_level(jn, catalog)
                if lev is None:
                    continue
                levels.append((jn, lev))
                unused.remove(c)
                avail |= rcols
                remaining.remove(r)
                cur = jn
                progress = True
                break
            if progress:
                break
    if remaining or unused or len(levels) < 2:
        return None
    return base, levels


# --- compilation -------------------------------------------------------------


@dataclasses.dataclass
class Caps:
    """Mutable capacity knobs, filled with defaults during compile; the
    executor bumps entries after overflow checks and recompiles."""

    values: dict

    def get(self, key: str, default: int) -> int:
        return self.values.setdefault(key, default)


class Compiled:
    def __init__(self, fn, scans, out_names, aux=(), node_ord=None):
        self.fn = fn  # (inputs tuple) -> (chunk, checks dict)
        self.scans = scans  # list[(table, alias, columns)]
        self.out_names = out_names
        # aux inputs appended after the scan chunks: precomputed build-side
        # sort permutations, (table, alias, key_cols, bit_widths) each
        self.aux = aux
        # plan node (by value) -> check-key ordinal, filled while fn runs
        self.node_ord = {} if node_ord is None else node_ord


def compile_plan(plan: LogicalPlan, catalog, caps: Caps,
                 cached_build_sort: bool = True) -> Compiled:
    scans: list = []
    aux: list = []  # build-order descriptors (see Compiled.aux)
    aux_index: dict = {}
    node_ord: dict = {}  # plan node (by value) -> deterministic ordinal

    def ordinal(p) -> int:
        return node_ord.setdefault(p, len(node_ord))

    scan_index: dict = {}

    def collect_scans(p):
        if isinstance(p, LScan):
            # keyed by node identity: the same table+alias may be scanned by
            # independent plan nodes (outer query vs subquery) with different
            # column sets
            if id(p) not in scan_index:
                scan_index[id(p)] = len(scans)
                scans.append((p.table, p.alias, p.columns))
        for c in p.children:
            collect_scans(c)

    collect_scans(plan)

    def collect_build_orders(p):
        if isinstance(p, LJoin) and cached_build_sort:
            desc = build_order_desc(p, catalog)
            if desc is not None and desc not in aux_index:
                aux_index[desc] = len(aux)
                aux.append(desc)
        for c in p.children:
            collect_build_orders(c)

    collect_build_orders(plan)

    def run(inputs):
        """The program. ALL mutable state lives inside this function, so one
        Compiled runs any number of times. Overflow checks return as a dict
        with static keys; values are 0-d device tensors or host ints, read
        by the executor in one host copy."""
        emit_memo: dict = {}  # keyed by node VALUE so equal-but-copied
        checks: dict = {}     # subtrees (ROLLUP levels) emit once

        def emit(p: LogicalPlan):
            if p in emit_memo:
                return emit_memo[p]
            out = _emit(p)
            emit_memo[p] = out
            return out

        def build_order_input(p, rc, rc0):
            """Index of the precomputed build argsort among aux inputs
            (registered by the eager pre-pass), or None. The rc-is-rc0 guard
            drops the cached order if the build was compacted after scan
            emit (row positions changed)."""
            if rc is not rc0:
                return None
            desc = build_order_desc(p, catalog)
            if desc is None:
                return None
            idx = aux_index.get(desc)
            return idx

        def maybe_compact(child_plan, c, tag: str, est: float | None = None):
            """Shrink a sparse chunk before a sort-heavy op: selective
            filters/joins leave most capacity dead, and sort/agg/window cost
            scales with CAPACITY, not live rows. Seeded from the cardinality
            estimate (callers override `est` when they know better, e.g. a
            probe side just masked by an exact runtime filter); the overflow
            check recompiles on underestimates (same contract as every other
            capacity)."""
            if c.capacity < 8192:
                return c
            from ..ops.common import compact

            if est is None:
                est = estimate_rows(child_plan, catalog)
            default = pad_capacity(int(est * 1.5) + 1024)
            if default >= c.capacity:
                return c
            key = f"shrink_{tag}"
            cap = caps.get(key, default)
            if cap >= c.capacity:
                return c
            out, n = compact(c, cap)
            checks[key] = n
            return out

        def _emit(p: LogicalPlan):
            if isinstance(p, LScan):
                return inputs[scan_index[id(p)]]
            if isinstance(p, LFilter):
                return filter_chunk(emit(p.child), p.predicate)
            if isinstance(p, LProject):
                c = emit(p.child)
                return project(c, [e for _, e in p.exprs], [n for n, _ in p.exprs])
            if isinstance(p, LSort):
                c = maybe_compact(p.child, emit(p.child), str(ordinal(p)))
                ctrs: dict = {}
                out = sort_chunk(c, p.keys, p.limit, counters=ctrs)
                for nm, v in ctrs.items():
                    checks[f"~ctr_{nm}@{ordinal(p)}"] = v
                return out
            if isinstance(p, LLimit):
                return limit_chunk(emit(p.child), p.limit, p.offset)
            if isinstance(p, LWindow):
                c = emit(p.child)
                ctrs = {}
                pre = None
                if p.limit is not None:
                    # TopN runtime filter: mask rows past the per-partition
                    # k-th key BEFORE the window's sort, then compact —
                    # the expensive lexsort runs over ~k*partitions rows
                    # instead of the whole window input (threshold ties
                    # can exceed the seed; the overflow check recompiles).
                    # Only when the function set tolerates pre-sort drops
                    # (row-counting limit func, prefix-only co-residents);
                    # otherwise window_op's exact in-window mask does all
                    # the work
                    from ..ops.common import compact

                    if window_topn_prefilter_safe(p.funcs, p.limit):
                        pre = window_topn_prefilter(
                            c, p.partition_by, p.order_by, p.limit[1])
                    if pre is not None:
                        keep, seed_rows = pre
                        n_live = c.num_rows()
                        c = c.and_sel(keep)
                        ctrs["window_topn_prefiltered"] = (
                            n_live - c.num_rows())
                        key = f"wtop_{ordinal(p)}"
                        cap = caps.get(key, pad_capacity(
                            seed_rows * 2 + 1024))
                        if cap < c.capacity:
                            c, nk = compact(c, cap)
                            checks[key] = nk
                if pre is None:
                    # no threshold path: the estimate-seeded shrink is the
                    # only capacity reduction before the window sort
                    c = maybe_compact(p.child, c, str(ordinal(p)))
                out = window_op(c, p.partition_by, p.order_by, p.funcs,
                                limit_spec=p.limit, counters=ctrs)
                for nm, v in ctrs.items():
                    checks[f"~ctr_{nm}@{ordinal(p)}"] = v
                return out
            if isinstance(p, LUnnest):
                from ..ops.unnest import unnest_op

                c = emit(p.child)
                key = f"unnest_{ordinal(p)}"
                cap = caps.get(key, pad_capacity(c.capacity * 4))
                out, total = unnest_op(c, p.expr, p.out_name, cap)
                checks[key] = total
                return out
            if isinstance(p, LUnion):
                out = emit(p.inputs[0])
                for child in p.inputs[1:]:
                    out = union_all(out, emit(child))
                return out
            if isinstance(p, LAggregate):
                c0 = emit(p.child)
                key = f"agg_{ordinal(p)}"
                # a global (no-group-key) aggregation always yields one row;
                # a 1024-slot capacity would pay a 1024-wide segment reduce
                default = 1024 if p.group_by else 1
                if p.group_by and isinstance(p.child, LAggregate):
                    # chained re-aggregation (ROLLUP level merges): group
                    # count is bounded by the child agg's output rows, so
                    # its capacity is a no-overflow seed — a deep chain
                    # then converges without one recompile per level, and
                    # the post-success tightening pass shrinks each level
                    # to its true count for subsequent runs
                    default = max(default, c0.capacity)
                from ..ops.aggregate import bounded_domain
                from ..runtime.config import config as _acfg

                dom = bounded_domain(c0, p.group_by)
                if dom is not None and p.group_by:
                    # the dense path's accumulators (and the agg's OUTPUT
                    # capacity, which downstream sorts/joins inherit) are
                    # domain-sized — a pessimization when the input shrank
                    # far below the domain (e.g. a magic-set-reduced
                    # correlated subquery aggregating ~1k surviving rows
                    # against a 200k key domain). Generous 32x slack: only
                    # clearly-pathological dense choices fall back to the
                    # compacted lexsort path.
                    est = estimate_rows(p.child, catalog)
                    if dom > 32 * max(est, 1024.0):
                        dom = None
                if dom is not None and dom <= _dense_agg_domain_max(_acfg):
                    # dense bounded domain: capacity covers it outright, the
                    # sort-free packed-gid path applies at any cardinality
                    default = max(default, dom)
                cap = caps.get(key, default)
                # Compaction only pays when the aggregate must SORT its
                # input (cost scales with capacity). The no-group-key path
                # and the packed-gid dense path are single fused passes over
                # the chunk — compacting first would ADD a cumsum + one
                # scatter per column for nothing. array_agg reads PHYSICAL
                # slot positions (contiguity matters), so it always takes
                # the compacted sort path.
                has_array_agg = any(a.fn == "array_agg" for _, a in p.aggs)
                sort_free = (
                    (not p.group_by) or (dom is not None and dom <= cap)
                ) and not has_array_agg
                c = c0 if sort_free else maybe_compact(
                    p.child, c0, str(ordinal(p)))
                kwargs = {}
                if has_array_agg:
                    akey = f"aggarr_{ordinal(p)}"
                    agg_aux: dict = {}
                    kwargs = {"arr_cap": caps.get(akey, 256),
                              "aux_checks": agg_aux}
                out, ng = hash_aggregate(c, p.group_by, p.aggs, cap, **kwargs)
                checks[key] = ng
                if kwargs:
                    checks[akey] = agg_aux["array_agg_max"]
                # dense floor metadata for the adaptive loop: a cap equal
                # to a dense domain seed must never tighten below it (that
                # would knock the plan onto the lexsort path); floor 0
                # means the lexsort path is in use and the cap may tighten
                # to the true group count like any other capacity
                checks["~floor_" + key] = (
                    dom if (dom is not None and dom <= cap) else 0)
                return out
            if isinstance(p, LJoin):
                return emit_join(p)
            raise PlanError(f"cannot compile {type(p).__name__}")

        def emit_multiway(p: LJoin, base, levels):
            """Free-Join fused multiway probe: every level's unique build
            scatters into a dense row LUT (a one-level trie over its key
            column), the fact probes all LUTs column-at-a-time in ONE
            program, the AND-ed match mask compacts ONCE, and payloads
            gather at the compacted capacity — the vectorized analog of
            Free Join's COLT (column-at-a-time lazy trie): no binary-join
            intermediate is ever materialized. Snowflake keys (a level
            keyed by a lower level's payload, e.g. o_custkey) gather just
            that ONE key column pre-compaction."""
            from .. import types as T
            from ..column.column import Field, Schema
            from ..column import Chunk
            from ..ops.common import scatter_set
            from ..ops.join import _I64MAX, pack_keys

            lc = emit(base)
            lc = maybe_compact(base, lc, f"{ordinal(p)}mwb")
            sel = lc.sel_mask()
            builds = []   # (build chunk, payload names, matched row ids)
            src = {}      # payload column name -> index into builds
            match_all = None
            for jn, (pk_e, bk_e, lo, hi) in levels:
                rc = emit(jn.right)
                size = int(hi - lo + 1)
                bk, b_ok = pack_keys(rc, (bk_e,))
                idxb = torch.where(b_ok, bk - lo, size)
                lut = scatter_set(
                    size, idxb, torch.arange(rc.capacity, dtype=torch.int32,
                                             device=rc.device),
                    -1, torch.int32)
                j = src.get(pk_e.name)
                if j is None:
                    # key from the base fact chunk
                    pkd, ok = pack_keys(lc, (pk_e,))
                else:
                    # snowflake: key gathered from a lower level's payload
                    prc, _, prow = builds[j]
                    i = prc.schema.index(pk_e.name)
                    kd = prc.data[i].to(torch.int64)[prow]
                    kv = prc.valid[i]
                    ok = sel if kv is None else (sel & kv[prow])
                    pkd = torch.where(ok, kd, _I64MAX)
                idxp = pkd - lo
                m = ok & (idxp >= 0) & (idxp < size)
                row = lut[idxp.clamp(0, size - 1)]
                m = m & (row >= 0)
                row = row.clamp(0, rc.capacity - 1)
                match_all = m if match_all is None else (match_all & m)
                builds.append((rc, list(jn.right.output_names()), row))
                for nm in jn.right.output_names():
                    src[nm] = len(builds) - 1
            checks[f"~ctr_join_multiway_hits@{ordinal(p)}"] = len(levels)
            # one compaction carries the probe AND every level's row ids
            nbase = len(lc.schema.fields)
            wide = lc.with_columns(
                [Field(f"__mw_{i}", T.INT, False)
                 for i in range(len(builds))],
                [b[2] for b in builds], [None] * len(builds))
            wide = wide.and_sel(match_all)
            wide = maybe_compact(p, wide, f"{ordinal(p)}mw",
                                 est=estimate_rows(p, catalog))
            data = list(wide.data[:nbase])
            valid = list(wide.valid[:nbase])
            out_fields = list(wide.schema.fields[:nbase])
            for (rc, names, _), rowc in zip(builds, wide.data[nbase:]):
                for nm in names:
                    i = rc.schema.index(nm)
                    d = rc.data[i][rowc]
                    v = rc.valid[i]
                    out_fields.append(rc.schema.fields[i])
                    data.append(d)
                    valid.append(None if v is None else v[rowc])
            return Chunk(Schema(tuple(out_fields)), tuple(data),
                         tuple(valid), wide.sel, wide.device)

        def emit_join(p: LJoin):
            chain = multiway_join_chain(p, catalog)
            if chain is not None:
                return emit_multiway(p, chain[0], chain[1])
            lc = emit(p.left)
            rc = emit(p.right)
            rc0 = rc  # pristine build (cached sort orders key off it)
            probe_keys, build_keys, residual = join_equi_keys(p)

            kind = {
                "inner": INNER, "left": LEFT_OUTER, "semi": LEFT_SEMI,
                "anti": LEFT_ANTI, "cross": INNER,
            }[p.kind]

            if not probe_keys:
                # cross join: constant key matches everything
                probe_keys = [Lit(0)]
                build_keys = [Lit(0)]
                bit_widths = (2,)
                unique = False
            else:
                bit_widths, residual, unique = choose_key_packing(
                    p, probe_keys, build_keys, residual, catalog
                )

            payload = (
                [] if p.kind in ("semi", "anti") else list(p.right.output_names())
            )

            # direct-addressing LUT join: unique single-key build with a
            # stats-bounded key range skips sort+searchsorted AND the
            # runtime filter (the LUT is already an exact membership test)
            from ..ops.join import hash_join_lut

            if unique and p.kind == "inner" and lc.capacity >= (1 << 20):
                # selective inner join over a BIG probe: the 1:1 gather/LUT
                # joins materialize every payload column at probe capacity,
                # while the expansion join emits a compacted output sized by
                # the estimate (TPC-H Q10: 6M lineitem probe against a
                # 57k-row build — expansion's 146k output beats 6M-wide
                # gathers). 24x bar: only clearly-selective joins downgrade
                # (borderline ratios like TPC-H Q5's 1.2M-of-6M keep the
                # gather — expansion's cumsum + ladder loses there).
                if estimate_rows(p, catalog) * 24 < lc.capacity:
                    unique = False

            lut_range = None
            if (unique and len(probe_keys) == 1
                    and p.kind in ("inner", "left", "semi", "anti")
                    and not (residual and p.kind != "inner")):
                lut_range = dense_rf_range(
                    p.left, p.right, probe_keys, build_keys, catalog,
                    max_range=LUT_JOIN_MAX_RANGE,
                )
            if lut_range is not None:
                lo, hi = lut_range
                # a selective probe-side filter (e.g. Q14's one-month
                # lineitem window) leaves most probe capacity dead — the
                # LUT gathers cost per SLOT, so compact first
                lc = maybe_compact(p.left, lc, f"{ordinal(p)}l")
                out = hash_join_lut(
                    lc, rc, tuple(probe_keys), tuple(build_keys),
                    lo, int(hi - lo + 1), kind, payload=payload,
                )
                if residual:
                    out = filter_chunk(out, and_all(residual))
                return out

            # SEMI/ANTI against a stats-bounded single key: the exact dense
            # presence bitmap IS the join (no build sort / probe search)
            from ..runtime.config import config as _cfg

            if (p.kind in ("semi", "anti") and not residual
                    and _cfg.get("enable_runtime_filters")):
                dsr = dense_rf_range(p.left, p.right, probe_keys,
                                     build_keys, catalog)
                if dsr is not None:
                    from ..ops.join import dense_semi_anti_mask

                    return lc.and_sel(dense_semi_anti_mask(
                        lc, rc, tuple(probe_keys), tuple(build_keys), dsr,
                        p.kind == "anti"))

            # build-side runtime filter on the probe (INNER/SEMI only — LEFT
            # OUTER/ANTI must keep non-matching probe rows). Strength ladder
            # per `runtime_filter_strategy`: exact dense bitmap (stats-
            # bounded key range) > bloom bitset (ANY key range, near-exact)
            # > min/max range. When the probe input is a pure filter/project
            # chain over a scan, the mask applies at the BOTTOM of that
            # chain and compacts THERE — capacity shrinks before the chain's
            # expression work instead of after it (RF pushdown).
            from ..ops.join import bloom_filter_mask, runtime_filter_mask
            from .optimizer import (
                _key_ndv, keys_through_chain, probe_scan_chain,
            )

            strategy = rf_strategy_of(_cfg)
            exact_rf = False
            if p.kind in ("inner", "semi", "cross") and probe_keys and not (
                len(probe_keys) == 1 and isinstance(probe_keys[0], Lit)
            ) and strategy != "off":
                dr = (dense_rf_range(p.left, p.right, probe_keys,
                                     build_keys, catalog)
                      if strategy == "auto" else None)
                bloom = None
                if dr is None and (strategy == "bloom" or (
                        strategy == "auto"
                        and bloom_rf_useful(p, probe_keys, build_keys,
                                            catalog))):
                    bloom = bloom_rf_bits(estimate_rows(p.right, catalog),
                                          _cfg.get("rf_bloom_max_bits"))

                def rf_mask(pc, keys):
                    """(mask, exactish) for probe chunk `pc` keyed by
                    `keys`; only the dense bitmap / uncapped bloom justify
                    compacting the survivors to the join estimate — the
                    min/max fallback may keep every probe row, so
                    compacting after it would guarantee an overflow
                    recompile on wide build key ranges."""
                    if dr is not None:
                        return runtime_filter_mask(
                            pc, rc, tuple(keys), tuple(build_keys),
                            bit_widths, dense_range=dr), True
                    if bloom is not None:
                        bits, exactish = bloom
                        checks[f"~ctr_rf_bloom_bits@{ordinal(p)}"] = bits
                        return bloom_filter_mask(
                            pc, rc, tuple(keys), tuple(build_keys),
                            bit_widths, bits=bits), exactish
                    return runtime_filter_mask(
                        pc, rc, tuple(keys), tuple(build_keys),
                        bit_widths), False

                pushed = False
                scan_node, chain = probe_scan_chain(p.left)
                if ((dr is not None or bloom is not None)
                        and scan_node is not None and chain):
                    skeys = keys_through_chain(probe_keys, chain, scan_node)
                    if skeys is not None:
                        sc = emit(scan_node)
                        n0 = sc.num_rows()
                        m, exact_rf = rf_mask(sc, skeys)
                        sc = sc.and_sel(m)
                        checks[f"~ctr_rf_rows_pruned@{ordinal(p)}"] = (
                            n0 - sc.num_rows())
                        if exact_rf:
                            # RF-survivor estimate at the scan: containment
                            # (build rows / probe-key NDV) — the semi-join
                            # cardinality formula
                            est_sc = estimate_rows(scan_node, catalog)
                            frac = 0.5
                            if isinstance(skeys[0], Col):
                                ndv = _key_ndv(scan_node, skeys[0].name,
                                               est_sc, catalog)
                                frac = min(estimate_rows(p.right, catalog)
                                           / max(ndv, 1.0), 1.0)
                            sc = maybe_compact(scan_node, sc,
                                               f"{ordinal(p)}rf",
                                               est=est_sc * frac)
                        c2 = sc
                        for node in reversed(chain):
                            if isinstance(node, LFilter):
                                c2 = filter_chunk(c2, node.predicate)
                            else:
                                c2 = project(c2,
                                             [e for _, e in node.exprs],
                                             [n for n, _ in node.exprs])
                        lc = c2
                        pushed = True
                if not pushed:
                    n0 = lc.num_rows()
                    m, exact_rf = rf_mask(lc, probe_keys)
                    lc = lc.and_sel(m)
                    checks[f"~ctr_rf_rows_pruned@{ordinal(p)}"] = (
                        n0 - lc.num_rows())

            # a runtime-filtered probe holds ~join-output-many live rows,
            # not plan-estimate-many: compact it to the JOIN estimate so the
            # expansion machinery (search ladder, cumsum) runs at matched
            # size instead of raw probe capacity (TPC-H Q18: 6M lineitem
            # probe vs a 57-order build). Overflow checks recover if the
            # estimate lied.
            est_l = None
            if exact_rf and p.kind == "inner":
                est_l = min(estimate_rows(p.left, catalog),
                            estimate_rows(p, catalog))
            lc = maybe_compact(p.left, lc, f"{ordinal(p)}l", est=est_l)
            # the sorted join paths argsort the BUILD side at full capacity —
            # compact it first when it is sparse (filtered dimension chains)
            rc = maybe_compact(p.right, rc, f"{ordinal(p)}r")
            bo_idx = build_order_input(p, rc, rc0)
            build_order = (
                inputs[len(scans) + bo_idx] if bo_idx is not None else None
            )

            if residual and p.kind in ("semi", "anti"):
                # Residual-capable (anti)semi join: tag probe rows with a rowid,
                # inner-expand on the equi keys, filter by the residual, and
                # reduce matched rowids (duplicates: one per surviving match)
                # to a per-probe-row presence mask.
                # (TPC-H Q21's correlated <> predicates take this path.)
                from ..column.column import Field
                from ..ops.common import scatter_set
                from .. import types as T

                rid = f"__rowid_{ordinal(p)}"
                rowid = torch.arange(lc.capacity, dtype=torch.int64,
                                     device=lc.device)
                lc2 = lc.with_columns(
                    [Field(rid, T.BIGINT, False)], [rowid], [None]
                )
                key = f"join_{ordinal(p)}"
                cap = caps.get(key, pad_capacity(lc.capacity))
                expanded, total = hash_join_expand(
                    lc2, rc, tuple(probe_keys), tuple(build_keys), cap, INNER,
                    payload=list(p.right.output_names()), bit_widths=bit_widths,
                )
                checks[key] = total
                matched = filter_chunk(expanded, and_all(residual))
                mdata, _ = matched.col(rid)
                midx = torch.where(matched.sel_mask(), mdata.to(torch.int64),
                                   lc.capacity)
                # the duplicate-index bitmap scatter (the reference's CPU
                # strategy; every duplicate writes the same 1)
                present = scatter_set(lc.capacity, midx, True, False,
                                      torch.bool)
                return lc.and_sel(present if p.kind == "semi" else ~present)

            if unique and p.kind in ("inner", "left", "semi", "anti"):
                if residual and p.kind != "inner":
                    raise PlanError(f"residual predicate on {p.kind} join unsupported")
                out = hash_join_unique(
                    lc, rc, tuple(probe_keys), tuple(build_keys), kind,
                    payload=payload, bit_widths=bit_widths,
                    build_order=build_order,
                )
                if residual:
                    out = filter_chunk(out, and_all(residual))
                return out
            # expansion join
            if residual and p.kind not in ("inner", "cross"):
                raise PlanError(f"residual predicate on {p.kind} join unsupported")
            key = f"join_{ordinal(p)}"
            default = pad_capacity(lc.capacity)
            cap = caps.get(key, default)
            out, total = hash_join_expand(
                lc, rc, tuple(probe_keys), tuple(build_keys), cap, kind,
                payload=payload, bit_widths=bit_widths,
                build_order=build_order,
            )
            if p.kind not in ("semi", "anti"):
                checks[key] = total
            if residual:
                out = filter_chunk(out, and_all(residual))
            return out

        chunk = emit(plan)
        # emit and _emit reference each other, so the closures and
        # emit_memo form a reference cycle that only Python's cyclic
        # collector frees: clear the memo here, or every intermediate
        # chunk of the query stays on the device after it returns. The
        # closures hold `checks` too: the caller gets its own dict, and
        # the 0-d check tensors die with it
        emit_memo.clear()
        out_checks = dict(checks)
        checks.clear()
        return chunk, out_checks

    return Compiled(run, scans, plan.output_names(), tuple(aux),
                    node_ord=node_ord)


def _equi_pair(conj: Expr, lcols: frozenset, rcols: frozenset):
    """conj == 'eq(a, b)' with a from left and b from right (or swapped)."""
    if not (isinstance(conj, Call) and conj.fn == "eq" and len(conj.args) == 2):
        return None
    a, b = conj.args
    ca, cb = expr_cols(a), expr_cols(b)
    if not ca or not cb:
        return None
    if ca <= lcols and cb <= rcols:
        return a, b
    if ca <= rcols and cb <= lcols:
        return b, a
    return None
