"""Execution beyond device memory: the spill executors.

Reference behavior: the spill framework (be/src/compute_env/spill/
spiller.h:161 — partitioned mem-tables spilled when operator state exceeds
memory). A port of the JAX package's runtime/batched.py: the device holds
one batch (or one partition) at a time and the rest stays in host memory.

- Batched aggregation (`match_batchable`, `execute_batched`): an
  aggregation over Filter/Project over ONE big scan streams the table in
  host batches through a PARTIAL aggregation, concatenates the states
  (`ops/setops.concat_many`) and finishes with a FINAL aggregation and the
  nodes above it.
- Partitioned joins (`match_grace_join`): both inputs of a single-integer-
  key equi join are routed on the host by the key's splitmix64 bucket
  (`native.hash_partition_i64`). `execute_grace_join` streams every
  partition pair; `execute_hybrid_join` (the default) broadcasts heavy-
  hitter build keys, keeps the largest build partitions resident together
  within one batch budget, spills only the overflow partitions and splits
  an oversized one again by a salted hash (`_salted_split`).
- Spilled ORDER BY (`execute_spill_sort`): per batch the device evaluates
  the sort operands; the host concatenates every row and orders them with
  numpy's lexsort (the same comparator as the device sort).
- Spilled windows (`execute_spill_window`): rows hash-split by the
  PARTITION BY keys into groups that each fit a batch; a skewed partition
  takes the streaming evaluator (`execute_streaming_window`: one host sort,
  chunks cut at peer boundaries, running state carried across chunks).

Where the port's idiom differs from the reference's:
- the reference wraps each per-batch program in `audited_jit` (jax.jit
  plus a one-time jaxpr audit). The port runs eagerly: a program is the
  plain callable, wrapped in `audited`, whose first call is verified the
  way Executor._verify_compile verifies a fresh program (the knob reads of
  the call, and the dispatch audit of analysis/trace_check.py);
- `slice_scan_chunk` copies one batch of host columns to the device; its
  seconds and bytes land in the profile node (`h2d_s`, `h2d_bytes`): that
  copy is the cost this path exists to pay;
- device results come back through explicit `.cpu()` copies. The batched
  aggregation and the partition loops read every batch's overflow checks
  together in ONE device-to-host copy after the loop (`d2h_syncs` counts
  the copies a run made).

The program caches are the executor's program buckets (`_BucketProgs`):
a cached entry holds the callables and the scan layout a plan compiled to,
keyed by the capacities, so a repeated query skips `compile_plan`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..column import Chunk, HostTable
from ..column.column import Schema, pad_capacity
from ..exprs.ir import Col
from ..ops import filter_chunk, hash_aggregate, limit_chunk, project, sort_chunk
from ..ops.aggregate import FINAL, PARTIAL, decomposable, final_agg_exprs
from ..ops.setops import concat_many
from ..sql.logical import (
    LAggregate, LFilter, LLimit, LProject, LScan, LSort, LogicalPlan,
)
from . import lifecycle
from .failpoint import fail_point
from .metrics import metrics as _metrics

GROUP_CAP_KEY = "batched_agg"
GRACE_GROUP_KEY = "grace_agg"

# live spilled-partition gauge: incremented when a hybrid execution takes
# ownership of its spilled partitions, decremented as each is consumed and
# on every unwind path
SPILL_PARTS_LIVE = _metrics.gauge(
    "sr_tpu_join_spill_partitions_live",
    "hybrid-join spilled partitions materialized but not yet consumed")


def profile_node(profile, name: str):
    """The spill executor's child of the query's RuntimeProfile (made on
    first use): its infos, counters and accumulated seconds (`<name>_s`)."""
    return profile.find(name) or profile.child(name)


def read_max(check_dicts, node=None) -> dict:
    """{key: max int over the dicts} of several attempts' or passes' checks,
    read in ONE device-to-host copy."""
    from .executor import read_checks

    flat = {(i, k): v for i, d in enumerate(check_dicts)
            for k, v in d.items()}
    if not flat:
        return {}
    keys = list(flat)
    vals = read_checks({j: flat[k] for j, k in enumerate(keys)})
    if node is not None:
        node.add_counter("d2h_syncs", 1)
    out: dict = {}
    for j, (_, k) in enumerate(keys):
        out[k] = max(out.get(k, 0), int(vals[j]))
    return out


def _to_device(a: np.ndarray, sel, dtype, cap: int, device):
    """`a[sel]` as `dtype`, copied into the first rows of a zeroed
    [cap, ...] tensor on `device` (no padded host copy)."""
    import torch

    part = np.ascontiguousarray(np.asarray(a)[sel], dtype=dtype)
    n = part.shape[0]
    if n > cap:
        raise ValueError(f"{n} rows > capacity {cap}")
    src = torch.from_numpy(part)
    out = torch.zeros((cap,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=device)
    out[:n].copy_(src)
    return out


def audited(raw_fn, where: str):
    """A spill executor's program with a one-time static audit: its first
    call records the knob reads it makes and, under `plan_verify_trace`,
    runs through the dispatch audit (analysis/trace_check.py); later calls
    run bare. The counterpart of the reference's `audited_jit` and of
    Executor._verify_compile for the program caches that live outside the
    executor's attempts."""
    return _AuditedProgram(raw_fn, where)


class _AuditedProgram:
    def __init__(self, raw_fn, where: str):
        self._raw = raw_fn
        self._where = where
        self._audited = False

    def __call__(self, *args):
        if self._audited:
            return self._raw(*args)
        self._audited = True
        from ..analysis import report, verify_level
        from ..analysis.key_check import check_trace_reads
        from .config import config

        if verify_level() == "off":
            return self._raw(*args)
        findings = []
        with config.record_reads() as reads:
            if config.get("plan_verify_trace"):
                from ..analysis import trace_check

                out, found = trace_check.audit_program(
                    lambda: self._raw(*args))
                findings += found
            else:
                out = self._raw(*args)
        report(check_trace_reads(reads) + findings, None,
               where=f"compile({self._where})")
        return out


def slice_scan_chunk(ht, alias: str, cols, sel, cap: int, device,
                     node=None) -> Chunk:
    """Device chunk of `ht[sel]` with alias-qualified names (shared by the
    batched-agg, spill-sort, spill-window and partition loops): each
    column gathered on the host and copied into its padded device tensor,
    the columns on a few threads (numpy's gathers and the copies release
    the GIL). The whole step is timed into `node` (`h2d_s`, `h2d_bytes`,
    `h2d_batches`)."""
    import torch

    from ..storage.store import _pmap

    t0 = time.perf_counter()
    fields = tuple(
        dataclasses.replace(ht.schema.field(c), name=f"{alias}.{c}")
        for c in cols)
    if isinstance(sel, slice):
        n = len(range(*sel.indices(ht.num_rows)))
    else:
        n = len(sel)

    def column(c):
        d = _to_device(ht.arrays[c], sel, ht.schema.field(c).type.np_dtype,
                       cap, device)
        v = ht.valids.get(c)
        return d, (None if v is None else
                   _to_device(v, sel, np.bool_, cap, device))

    out = _pmap(column, cols)
    sel_mask = None if n == cap else (
        torch.arange(cap, device=device) < n)
    chunk = Chunk(Schema(fields), [d for d, _ in out], [v for _, v in out],
                  sel_mask, device)
    if node is not None:
        node.add_counter("h2d_s", time.perf_counter() - t0, "s")
        node.add_counter("h2d_bytes", lifecycle._nbytes(chunk))
        node.add_counter("h2d_batches", 1)
    return chunk


def host_concat_tables(tables):
    """Concatenate same-schema HostTables (valids default to all-true);
    asserts shared source dictionaries — the spill contract."""
    first = tables[0]
    arrays, valids = {}, {}
    for f in first.schema:
        for t in tables[1:]:
            if t.schema.field(f.name).dict is not f.dict:
                raise AssertionError(
                    "spill groups must share source dictionaries")
        arrays[f.name] = np.concatenate([t.arrays[f.name] for t in tables])
        if any(f.name in t.valids for t in tables):
            valids[f.name] = np.concatenate([
                t.valids.get(f.name, np.ones(t.num_rows, dtype=np.bool_))
                for t in tables])
    return first.schema, arrays, valids


def _run_scan_chain(c, chain):
    """Interpret the (Filter/Project)* nodes between an operator and its
    scan (innermost first)."""
    for node in reversed(chain):
        if isinstance(node, LFilter):
            c = filter_chunk(c, node.predicate)
        else:
            c = project(c, [e for _, e in node.exprs],
                        [n for n, _ in node.exprs])
    return c


def _apply_top_chain(c, chain):
    """Interpret the (Project/Sort/Limit/Filter)* nodes above the merge."""
    for node in reversed(chain):
        if isinstance(node, LFilter):
            c = filter_chunk(c, node.predicate)
        elif isinstance(node, LProject):
            c = project(c, [e for _, e in node.exprs],
                        [n for n, _ in node.exprs])
        elif isinstance(node, LSort):
            c = sort_chunk(c, node.keys, node.limit)
        else:
            c = limit_chunk(c, node.limit, node.offset)
    return c


# --- batched (host-streamed) aggregation -------------------------------------


@dataclasses.dataclass
class BatchablePlan:
    top_chain: list  # nodes above the aggregate, outermost first
    agg: LAggregate
    scan_chain: list  # nodes between agg and scan, topmost first
    scan: LScan


def match_batchable(plan: LogicalPlan) -> BatchablePlan | None:
    """Top chain (Project/Sort/Limit/Filter)* -> LAggregate ->
    (Filter/Project)* -> LScan."""
    top = []
    node = plan
    while isinstance(node, (LProject, LSort, LLimit, LFilter)):
        top.append(node)
        node = node.child
    if not isinstance(node, LAggregate):
        return None
    agg = node
    if not decomposable(agg.aggs):
        return None  # holistic aggs (percentile) need all rows in one batch
    chain = []
    node = agg.child
    while isinstance(node, (LFilter, LProject)):
        chain.append(node)
        node = node.child
    if not isinstance(node, LScan):
        return None
    return BatchablePlan(top, agg, chain, node)


def make_programs(bp: BatchablePlan, group_cap: int):
    """The (partial, final) programs of one capacity setting."""

    def partial_program(chunk: Chunk):
        c = _run_scan_chain(chunk, bp.scan_chain)
        return hash_aggregate(
            c, bp.agg.group_by, bp.agg.aggs, group_cap, mode=PARTIAL)

    final_group_by = tuple((n, Col(n)) for n, _ in bp.agg.group_by)

    def final_program(m: Chunk):
        out, ng = hash_aggregate(
            m, final_group_by, final_agg_exprs(bp.agg.aggs), group_cap,
            mode=FINAL)
        return _apply_top_chain(out, bp.top_chain), ng

    return (audited(partial_program, "batched_partial"),
            audited(final_program, "batched_final"))


def execute_batched(
    bp: BatchablePlan, catalog, caps, node, batch_rows: int,
    programs_cache, device,
):
    """One attempt: stream batches, merge, finalize. Returns (chunk,
    {cap_key: true group count}) for the executor's adaptive loop."""
    handle = catalog.get_table(bp.scan.table)
    ht = handle.table
    total = ht.num_rows
    cap = pad_capacity(min(batch_rows, total))

    group_cap = caps.get(GROUP_CAP_KEY, 4096)
    prog_key = (bp.agg, tuple(bp.scan_chain), tuple(bp.top_chain), group_cap,
                cap)
    if prog_key not in programs_cache:
        programs_cache[prog_key] = make_programs(bp, group_cap)
    jpartial, jfinal = programs_cache[prog_key]

    alias = bp.scan.alias
    cols = bp.scan.columns
    node.set_info("batch_rows", batch_rows)

    partials, counts = [], []
    # dynamic slicing: soft-mem degradation may shrink the remaining
    # batches' row count mid-stream (same capacity, fewer rows)
    b_rows = batch_rows
    lo = 0
    n_batches = 0
    while lo < total or n_batches == 0:
        fail_point("spill::batch_loop")
        lifecycle.checkpoint("spill::batch_loop")
        hi = min(lo + b_rows, total)
        chunk = slice_scan_chunk(ht, alias, cols, slice(lo, hi), cap,
                                 device, node)
        out, ng = jpartial(chunk)
        lifecycle.account(out, "spill::batch_loop")
        partials.append(out)
        counts.append({GROUP_CAP_KEY: ng})
        lo = hi
        n_batches += 1
        if lifecycle.degraded() and b_rows > 1024:
            b_rows = max(b_rows // 2, 1024)
    node.set_info("batches", n_batches)

    fail_point("spill::merge_partials")
    lifecycle.checkpoint("spill::merge_partials")
    merged = concat_many(partials)
    fail_point("spill::final_agg")
    out, ng = jfinal(merged)
    lifecycle.account(out, "spill::final_agg")
    counts.append({GROUP_CAP_KEY: ng})
    return out, read_max(counts, node)


# --- partitioned joins: host co-partitioning by the join key -----------------


@dataclasses.dataclass
class GraceJoinPlan:
    top_chain: list  # nodes above agg (or above join when agg is None)
    agg: LAggregate | None
    mid_chain: list  # Filter/Project between agg and join
    join: object  # LJoin
    left_chain: list  # Filter/Project between join and left scan
    left_scan: LScan
    right_chain: list
    right_scan: LScan
    probe_key: str  # base column on the left table
    build_key: str  # base column on the right table


def match_grace_join(plan: LogicalPlan, catalog):
    """Top (Project/Sort/Limit/Filter)* -> [decomposable LAggregate] ->
    (Filter/Project)* -> LJoin(inner/left/semi/anti, single INT equi key) ->
    (Filter/Project)* -> LScan on both sides. The single integer key is what
    lets the host co-partition both inputs with the splitmix64 bucketing."""
    from ..sql.analyzer import _conjuncts
    from ..sql.logical import LJoin
    from ..sql.optimizer import col_origin
    from ..sql.physical import _equi_pair

    top = []
    node = plan
    while isinstance(node, (LProject, LSort, LLimit, LFilter)):
        top.append(node)
        node = node.child
    agg = None
    if isinstance(node, LAggregate):
        if not decomposable(node.aggs):
            return None
        agg = node
        node = node.child
    mid = []
    while isinstance(node, (LFilter, LProject)):
        mid.append(node)
        node = node.child
    if not isinstance(node, LJoin) or node.kind not in (
        "inner", "left", "semi", "anti"
    ):
        return None
    join = node
    if agg is None and top:
        # without a decomposable agg the per-partition outputs concat at
        # full join width; only allow trivial tops then
        if any(isinstance(t, LFilter) for t in top):
            return None

    def scan_of(n):
        chain = []
        while isinstance(n, (LFilter, LProject)):
            chain.append(n)
            n = n.child
        return (chain, n) if isinstance(n, LScan) else (None, None)

    lchain, lscan = scan_of(join.left)
    rchain, rscan = scan_of(join.right)
    if lscan is None or rscan is None:
        return None
    lcols = frozenset(join.left.output_names())
    rcols = frozenset(join.right.output_names())
    pairs = []
    for c in (_conjuncts(join.condition) if join.condition is not None else []):
        pair = _equi_pair(c, lcols, rcols)
        if pair is not None:
            pairs.append(pair)
    if len(pairs) != 1:
        return None
    pk, bk = pairs[0]
    if not (isinstance(pk, Col) and isinstance(bk, Col)):
        return None
    po = col_origin(join.left, pk.name)
    bo = col_origin(join.right, bk.name)
    if po is None or bo is None:
        return None
    for origin in (po, bo):
        t = catalog.get_table(origin[0])
        if t is None:
            return None
        f = t.schema.field(origin[1])
        if not (f.type.is_integer or f.type.is_temporal):
            return None  # host partitioner needs int64-able keys
    return GraceJoinPlan(top, agg, mid, join, lchain, lscan, rchain, rscan,
                         po[1], bo[1])


def _grace_part_plan(gp: GraceJoinPlan):
    """The per-partition JOIN plan (no aggregate: groups span partitions, so
    aggregation runs PARTIAL per partition and FINAL over the merge)."""
    node = gp.join
    for n in reversed(gp.mid_chain):
        node = dataclasses.replace(n, child=node)
    return node


def grace_partitions(gp: GraceJoinPlan, catalog, batch_rows: int,
                     node=None):
    """Host co-partitioning of both inputs by the join key (independent of
    capacities — computed ONCE per query, not per adaptive attempt)."""
    from ..native import bucket_order, hash_partition_i64

    t0 = time.perf_counter()
    lht = catalog.get_table(gp.left_scan.table).table
    rht = catalog.get_table(gp.right_scan.table).table
    n_parts = max(1, -(-max(lht.num_rows, rht.num_rows) // batch_rows))

    def split(ht, key):
        return bucket_order(hash_partition_i64(
            np.asarray(ht.arrays[key], dtype=np.int64), n_parts), n_parts)

    lorder, loffs = split(lht, gp.probe_key)
    rorder, roffs = split(rht, gp.build_key)
    lcap = pad_capacity(max(int(np.diff(loffs).max()), 1))
    rcap = pad_capacity(max(int(np.diff(roffs).max()), 1))
    if node is not None:
        node.add_counter("partition_s", time.perf_counter() - t0, "s")
    return (lht, rht, n_parts, lorder, loffs, rorder, roffs, lcap, rcap)


def _partition_program(gp: GraceJoinPlan, part_plan, catalog, caps,
                       pgkey: str, pgcap: int):
    """(run_part, scans): the partition plan compiled without cached build
    sorts (partition chunks differ per partition), plus the PARTIAL
    aggregation when the plan aggregates. The program reads its own
    snapshot of the capacities it was cached under; the defaults it fills
    while running are copied into the attempt's capacities (as a fresh
    trace fills them in the reference)."""
    from ..sql.physical import Caps, compile_plan

    pcaps = Caps(dict(caps.values))
    compiled = compile_plan(part_plan, catalog, pcaps,
                            cached_build_sort=False)

    def run_part(inputs, live_caps, _fn=compiled.fn):
        c, checks = _fn(tuple(inputs))
        for k, v in pcaps.values.items():
            live_caps.values.setdefault(k, v)
        if gp.agg is not None:
            out, ng = hash_aggregate(
                c, gp.agg.group_by, gp.agg.aggs, pgcap, mode=PARTIAL)
            checks = dict(checks)
            checks[pgkey] = ng
            return out, checks
        return c, checks

    return audited(run_part, "grace_part"), compiled.scans


def execute_grace_join(
    gp: GraceJoinPlan, catalog, caps, node, parts,
    programs_cache, executor,
):
    """One adaptive attempt: stream each host partition pair through one
    partition program (join [+ PARTIAL agg]), then merge (FINAL agg) and run
    the top chain."""
    lht, rht, n_parts, lorder, loffs, rorder, roffs, lcap, rcap = parts
    dev = executor.cache.device
    node.set_info("grace_partitions", n_parts)

    part_plan = _grace_part_plan(gp)
    pgkey = GRACE_GROUP_KEY + "_partial"
    pgcap = caps.get(pgkey, 4096) if gp.agg is not None else 0
    prog_key = (part_plan, tuple(sorted(caps.values.items())), lcap, rcap)
    if prog_key not in programs_cache:
        programs_cache[prog_key] = _partition_program(
            gp, part_plan, catalog, caps, pgkey, pgcap)
    jpart, scans = programs_cache[prog_key]

    def part_chunk(ht, scan, order, offs, p, cap):
        idx = order[offs[p]:offs[p + 1]]
        return slice_scan_chunk(ht, scan.alias, scan.columns, idx, cap, dev,
                                node)

    outs, pass_checks = [], []
    for p in range(n_parts):
        fail_point("grace::partition_loop")
        lifecycle.checkpoint("grace::partition_loop")
        inputs = []
        for table, alias, cols in scans:
            if alias == gp.left_scan.alias:
                inputs.append(part_chunk(lht, gp.left_scan, lorder, loffs,
                                         p, lcap))
            elif alias == gp.right_scan.alias:
                inputs.append(part_chunk(rht, gp.right_scan, rorder, roffs,
                                         p, rcap))
            else:  # replicated small side inside chains (not expected)
                inputs.append(executor.cache.chunk_for(
                    catalog.get_table(table), alias, cols))
        out, checks = jpart(inputs, caps)
        lifecycle.account(out, "grace::partition_loop")
        outs.append(out)
        pass_checks.append(checks)

    fail_point("grace::final")
    lifecycle.checkpoint("grace::final")
    out, final_checks = _finalize_partition_outputs(gp, outs, caps,
                                                    programs_cache)
    return out, read_max(pass_checks + [final_checks], node)


def _finalize_partition_outputs(gp: GraceJoinPlan, outs, caps,
                                programs_cache):
    """Shared tail of the partitioned join executors (grace + hybrid):
    merge the per-pass outputs and run FINAL aggregation + the top chain
    (or just the top chain when the plan has no aggregate). Returns (chunk,
    checks)."""
    if gp.agg is not None:
        merged = concat_many(outs)
        final_group_by = tuple((n, Col(n)) for n, _ in gp.agg.group_by)
        gkey = GRACE_GROUP_KEY
        gcap = caps.get(gkey, 4096)

        def final_fn(m):
            out, ng = hash_aggregate(
                m, final_group_by, final_agg_exprs(gp.agg.aggs), gcap,
                mode=FINAL)
            return _apply_top_chain(out, gp.top_chain), ng

        fkey = ("grace_final", tuple(gp.top_chain), gp.agg, gcap,
                merged.capacity)
        if fkey not in programs_cache:
            programs_cache[fkey] = audited(final_fn, "grace_final")
        out, ng = programs_cache[fkey](merged)
        return out, {gkey: ng}
    return _apply_top_chain(concat_many(outs), gp.top_chain), {}


# --- hybrid skew-aware hash join: dynamic build-side partitioning -------------
#
# The grace path above is all-or-nothing: every row of BOTH inputs is
# partitioned and every partition pair streams through the device. The
# hybrid executor (Design Trade-offs for a Robust Dynamic Hybrid Hash Join,
# arXiv 2112.02480) decides per partition of the BUILD side:
#
# - heavy-hitter keys (exact partition-time top-k counts, gated by
#   plan-time NDV/unique-key stats) route to a broadcast lane: their build
#   rows stay device-resident while the matching probe rows stream;
# - the remaining build hash-partitions; the LARGEST partitions stay
#   resident together while their builds fit one batch budget;
# - only the overflow partitions spill, each consumed as its own
#   build-resident/probe-streamed loop.
#
# Probe sides always stream in batch-sized slices. Routing is a pure
# function of the key value, so each probe row meets exactly the build rows
# with an equal key — INNER/LEFT/SEMI/ANTI semantics hold per lane.


@dataclasses.dataclass
class HybridParts:
    """Host routing decision of one hybrid join execution (computed once
    per query, reused across adaptive attempts)."""

    skew_keys: object   # np.ndarray of heavy-hitter key values
    hot: tuple | None   # (probe_idx, build_idx) of the broadcast lane
    resident: tuple | None  # (probe_idx, build_idx), builds merged on device
    spilled: list       # [(probe_idx, build_idx), ...] overflow partitions
    n_parts: int
    resident_parts: int
    lcap: int           # probe-slice capacity (shared by every lane)
    rcap_hot: int       # broadcast-lane build capacity (0 = no hot lane)
    rcap_cold: int      # resident/spilled build capacity, separate from the
    # hot lane's: cold passes must not pay a program sized for the
    # heavy-hitter build
    batch_rows: int
    sub_parts: int = 0        # salted sub-partitions the recursion created
    oversized_passes: int = 0  # cold passes whose build STILL exceeds budget
    max_pass_build: int = 0   # largest cold build pass in rows (pre-pad)
    probe_hot: tuple = ()     # ((key, count), ...) probe-side heavy hitters
    build_hot: tuple = ()     # ((key, count), ...) unsplittable build keys


def hybrid_partitions(gp: GraceJoinPlan, catalog, batch_rows: int,
                      known_hot=None,
                      node=None) -> HybridParts:
    """Partition-time half of the hybrid join: heavy-hitter detection plus
    build-side hash partitioning with a greedy residency budget.

    `known_hot` is plan feedback's learned build-side heavy-hitter key list
    (keys a previous run proved unsplittable): they join the broadcast-lane
    candidates after re-verification against today's build rows."""
    from ..native import bucket_order, hash_partition_i64
    from .config import config

    fail_point("hybrid::partition")
    lifecycle.checkpoint("hybrid::partition")
    t0 = time.perf_counter()
    lht = catalog.get_table(gp.left_scan.table).table
    rht = catalog.get_table(gp.right_scan.table).table
    lk = np.asarray(lht.arrays[gp.probe_key], dtype=np.int64)
    rk = np.asarray(rht.arrays[gp.build_key], dtype=np.int64)
    kind = gp.join.kind

    # heavy hitters: plan-time stats gate the exact counting scan (a build
    # key covered by a declared unique key, or with NDV ~ row count,
    # cannot repeat past the threshold), exact top-k counts decide
    skew_keys = np.empty(0, np.int64)
    handle = catalog.get_table(gp.right_scan.table)
    ndv = handle.column_ndv(gp.build_key)
    # only a unique key consisting of EXACTLY the join column proves the
    # key can't repeat (a wider unique key still allows duplicates on it)
    unique_build = any(tuple(k) == (gp.build_key,)
                       for k in handle.unique_keys) \
        or (ndv is not None and ndv >= 0.99 * max(len(rk), 1))
    thresh = max(batch_rows // max(config.get("join_skew_factor"), 1), 1)
    if not unique_build and len(rk):
        uniq, counts = _key_counts(rk)
        hot_mask = counts > thresh
        if hot_mask.any():
            cand, ccnt = uniq[hot_mask], counts[hot_mask]
            top = np.argsort(ccnt, kind="stable")[::-1]
            top = top[:max(config.get("join_skew_keys_max"), 0)]
            skew_keys = np.sort(cand[top])
    if known_hot is not None and len(known_hot) and len(rk):
        # re-verify learned keys against the live build before routing
        # them to the broadcast lane (the thresh gate stays authoritative)
        kh = np.asarray(sorted({int(k) for k in known_hot}), np.int64)
        km = np.isin(rk, kh)
        if km.any():
            ku, kc = np.unique(rk[km], return_counts=True)
            keep = ku[kc > thresh]
            if keep.size:
                skew_keys = np.union1d(skew_keys, keep)

    if len(skew_keys):
        r_hot = np.isin(rk, skew_keys)
        l_hot = np.isin(lk, skew_keys)
    else:
        r_hot = np.zeros(len(rk), bool)
        l_hot = np.zeros(len(lk), bool)

    # hash-partition the cold build; the probe co-partitions by the same
    # function so routing is a pure function of the key value
    ncold = int((~r_hot).sum())
    n_parts = max(1, -(-ncold // batch_rows))
    rb = hash_partition_i64(rk, n_parts)
    lb = hash_partition_i64(lk, n_parts)
    cold_counts = np.bincount(rb[~r_hot], minlength=n_parts)

    # residency: biggest build partitions first, while they fit ONE batch
    # budget together; partitions larger than the budget spill alone
    resident_mask = np.zeros(n_parts, bool)
    acc = 0
    for p in np.argsort(cold_counts, kind="stable")[::-1]:
        c = int(cold_counts[p])
        if c and acc + c <= batch_rows:
            resident_mask[p] = True
            acc += c

    hot = None
    if len(skew_keys) and l_hot.any():
        hot = (np.flatnonzero(l_hot), np.flatnonzero(r_hot))

    res_p = np.flatnonzero(resident_mask[lb] & ~l_hot)
    res_b = np.flatnonzero(resident_mask[rb] & ~r_hot)
    resident = None
    if res_p.size and (res_b.size or kind in ("left", "anti")):
        resident = (res_p, res_b)

    # each side's cold rows grouped by partition (hot rows in an extra
    # group) by one stable radix pass: a partition's rows keep their order
    def by_part(bucket, hot):
        return bucket_order(np.where(hot, n_parts, bucket), n_parts + 1)

    spilled = []
    if not resident_mask.all():
        lorder, loffs = by_part(lb, l_hot)
        rorder, roffs = by_part(rb, r_hot)
    for part in range(n_parts):
        if resident_mask[part]:
            continue
        pi = lorder[loffs[part]:loffs[part + 1]]
        if pi.size == 0:
            continue  # no probe rows -> no output rows, any join kind
        bi = rorder[roffs[part]:roffs[part + 1]]
        if bi.size == 0 and kind not in ("left", "anti"):
            continue  # INNER/SEMI against an empty build matches nothing
        spilled.append((pi, bi))

    # recursive salted repartitioning: an overflow partition whose BUILD
    # alone exceeds the batch budget re-hashes with a salt into
    # sub-partitions instead of running one oversized build pass
    stats = {"sub": 0, "oversized": 0, "hot": []}
    if config.get("join_recursive_repartition"):
        split: list = []
        for pi, bi in spilled:
            _salted_split(lk, rk, pi, bi, batch_rows, kind, thresh,
                          np.uint64(1), 0, split, stats)
        spilled = split
    else:
        stats["oversized"] = sum(
            1 for _, bi in spilled if bi.size > batch_rows)

    # probe-side heavy hitters, recorded into plan feedback for the DP
    # join-order cost (a hot probe key floors the join's output)
    probe_hot: list = []
    if config.get("plan_feedback") and len(lk):
        pu, pc = _key_counts(lk)
        pm = pc > thresh
        if pm.any():
            cu, cc = pu[pm], pc[pm]
            top = np.argsort(cc, kind="stable")[::-1]
            top = top[:max(config.get("join_skew_keys_max"), 0)]
            probe_hot = [(int(cu[i]), int(cc[i])) for i in top]

    rcap_hot = pad_capacity(int(hot[1].size)) if hot is not None else 0
    cold_builds = [res_b.size if resident is not None else 0]
    cold_builds.extend(bi.size for _, bi in spilled)
    max_pass_build = int(max(cold_builds, default=0))
    rcap_cold = pad_capacity(max(max_pass_build, 1))
    lcap = pad_capacity(max(min(batch_rows, max(len(lk), 1)), 1))
    if node is not None:
        node.add_counter("partition_s", time.perf_counter() - t0, "s")
    return HybridParts(
        skew_keys=skew_keys, hot=hot, resident=resident, spilled=spilled,
        n_parts=n_parts, resident_parts=int(resident_mask.sum()),
        lcap=lcap, rcap_hot=rcap_hot, rcap_cold=rcap_cold,
        batch_rows=batch_rows, sub_parts=stats["sub"],
        oversized_passes=stats["oversized"],
        max_pass_build=max_pass_build, probe_hot=tuple(probe_hot),
        build_hot=tuple(stats["hot"]))


MAX_SALT_DEPTH = 4


def _key_counts(keys: np.ndarray):
    """np.unique(keys, return_counts=True), by a bincount when the keys span
    a range not much wider than their number (join keys of a fact table:
    one pass instead of a sort of every key)."""
    if keys.size == 0:
        return np.unique(keys, return_counts=True)
    lo, hi = int(keys.min()), int(keys.max())
    if hi - lo > 4 * keys.size + 1024:
        return np.unique(keys, return_counts=True)
    counts = np.bincount(keys - lo, minlength=hi - lo + 1)
    uniq = np.flatnonzero(counts)
    return (uniq + lo).astype(keys.dtype), counts[uniq]


def _salted_split(lk, rk, pi, bi, batch_rows, kind, thresh, salt, depth,
                  out, stats):
    """Split one oversized spilled partition by a salted re-hash of the
    join key, recursing while a sub-partition's build still exceeds the
    budget. A single-key partition cannot be split by any hash of the key
    (its key is recorded as a learned heavy hitter so the next run
    broadcasts it), and MAX_SALT_DEPTH stops pathological collision
    chains."""
    batch_rows = max(1, int(batch_rows))
    if bi.size <= batch_rows:
        out.append((pi, bi))
        return
    uniq = np.unique(rk[bi])
    if uniq.size <= 1 or depth >= MAX_SALT_DEPTH:
        stats["oversized"] += 1
        cnt = np.unique(rk[bi], return_counts=True)
        for k, c in zip(cnt[0][cnt[1] > thresh], cnt[1][cnt[1] > thresh]):
            stats["hot"].append((int(k), int(c)))
        out.append((pi, bi))
        return
    n_sub = max(2, -(-int(bi.size) // batch_rows))
    hb = (_np_mix64(rk[bi].astype(np.uint64) ^ salt)
          % np.uint64(n_sub)).astype(np.int64)
    hp = (_np_mix64(lk[pi].astype(np.uint64) ^ salt)
          % np.uint64(n_sub)).astype(np.int64)
    for s in range(n_sub):
        sub_pi = pi[hp == s]
        if sub_pi.size == 0:
            continue  # no probe rows -> no output rows, any join kind
        sub_bi = bi[hb == s]
        if sub_bi.size == 0 and kind not in ("left", "anti"):
            continue  # INNER/SEMI against an empty build matches nothing
        stats["sub"] += 1
        next_salt = np.uint64(
            (int(salt) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
        _salted_split(lk, rk, sub_pi, sub_bi, batch_rows, kind, thresh,
                      next_salt, depth + 1, out, stats)


def execute_hybrid_join(
    gp: GraceJoinPlan, catalog, caps, node, parts: HybridParts,
    programs_cache, executor,
):
    """One adaptive attempt of the hybrid join: broadcast lane, resident
    lane, then each spilled partition — every lane streams its probe rows
    in batch slices against a device-resident build through one partition
    program; the merge runs FINAL aggregation + the top chain."""
    lht = catalog.get_table(gp.left_scan.table).table
    rht = catalog.get_table(gp.right_scan.table).table
    dev = executor.cache.device
    node.set_info("hybrid_partitions", parts.n_parts)
    node.set_info("hybrid_resident", parts.resident_parts)
    node.set_info("hybrid_spilled", len(parts.spilled))
    node.set_info("hybrid_skew_keys", len(parts.skew_keys))
    node.set_info("hybrid_subpartitions", parts.sub_parts)
    node.set_info("hybrid_max_pass_build", parts.max_pass_build)

    part_plan = _grace_part_plan(gp)
    pgkey = GRACE_GROUP_KEY + "_partial"
    pgcap = caps.get(pgkey, 4096) if gp.agg is not None else 0

    def get_prog(rcap: int):
        """One partition program per BUILD capacity: the hot lane's is
        sized for the heavy-hitter build, the cold lanes share a smaller
        one."""
        prog_key = ("hybrid", part_plan, tuple(sorted(caps.values.items())),
                    parts.lcap, rcap)
        if prog_key not in programs_cache:
            programs_cache[prog_key] = _partition_program(
                gp, part_plan, catalog, caps, pgkey, pgcap)
        return programs_cache[prog_key]

    outs, pass_checks = [], []

    def run_lane(probe_idx, build_idx, rcap: int, site: str):
        with node.timer((site.partition("::")[2] or site) + "_s"):
            _run_lane(probe_idx, build_idx, rcap, site)

    def _run_lane(probe_idx, build_idx, rcap: int, site: str):
        jpart, scans = get_prog(rcap)
        bchunk = slice_scan_chunk(rht, gp.right_scan.alias,
                                  gp.right_scan.columns, build_idx, rcap,
                                  dev, node)
        lifecycle.account(bchunk, site)
        total = len(probe_idx)
        b_rows = parts.batch_rows
        lo = 0
        ran = False
        while lo < total or not ran:
            fail_point(site)
            lifecycle.checkpoint(site)
            hi = min(lo + b_rows, total)
            pslice = slice_scan_chunk(lht, gp.left_scan.alias,
                                      gp.left_scan.columns,
                                      probe_idx[lo:hi], parts.lcap, dev,
                                      node)
            inputs = []
            for table, alias, cols in scans:
                if alias == gp.left_scan.alias:
                    inputs.append(pslice)
                elif alias == gp.right_scan.alias:
                    inputs.append(bchunk)
                else:  # replicated small side inside chains (not expected)
                    inputs.append(executor.cache.chunk_for(
                        catalog.get_table(table), alias, cols))
            out, checks = jpart(inputs, caps)
            lifecycle.account(out, site)
            outs.append(out)
            pass_checks.append(checks)
            lo = hi
            ran = True
            # soft-mem degradation: halve the remaining probe slices
            if lifecycle.degraded() and b_rows > 1024:
                b_rows = max(b_rows // 2, 1024)

    empty = np.empty(0, np.int64)
    remaining_spill = len(parts.spilled)
    SPILL_PARTS_LIVE.inc(remaining_spill)
    try:
        if parts.hot is not None:
            run_lane(parts.hot[0], parts.hot[1], parts.rcap_hot,
                     "hybrid::broadcast_lane")
        if parts.resident is not None:
            run_lane(parts.resident[0], parts.resident[1], parts.rcap_cold,
                     "hybrid::resident_lane")
        for pi, bi in parts.spilled:
            run_lane(pi, bi, parts.rcap_cold, "hybrid::spill_partition")
            remaining_spill -= 1
            SPILL_PARTS_LIVE.inc(-1)
        if not outs:
            # degenerate (empty inputs / all lanes skipped): one empty pass
            # keeps the output schema + FINAL agg shape intact
            run_lane(empty, empty, parts.rcap_cold,
                     "hybrid::resident_lane")
    finally:
        # unwind (KILL/deadline/failpoint): unconsumed spilled partitions
        # are released with the execution — never leaked
        if remaining_spill:
            SPILL_PARTS_LIVE.inc(-remaining_spill)

    fail_point("hybrid::merge")
    lifecycle.checkpoint("hybrid::merge")
    out, final_checks = _finalize_partition_outputs(gp, outs, caps,
                                                    programs_cache)
    checks = read_max(pass_checks + [final_checks], node)
    checks["~ctr_join_skew_keys"] = len(parts.skew_keys)
    checks["~ctr_join_spilled_partitions"] = len(parts.spilled)
    checks["~ctr_join_resident_partitions"] = parts.resident_parts
    checks["~ctr_join_subpartitions"] = parts.sub_parts
    checks["~ctr_join_oversized_passes"] = parts.oversized_passes
    checks["~ctr_join_max_pass_build"] = parts.max_pass_build
    if parts.hot is not None:
        checks["~ctr_join_skew_probe_rows"] = len(parts.hot[0])
    return out, checks


# --- spilled ORDER BY: device-evaluated keys, host global order ---------------


@dataclasses.dataclass
class SpillSortPlan:
    limit_node: object  # LLimit above the sort | None
    sort: LSort
    scan_chain: list  # (Filter/Project)* topmost first
    scan: LScan


def match_spill_sort(plan: LogicalPlan) -> SpillSortPlan | None:
    """[LLimit]? -> LSort -> (Filter/Project)* -> LScan."""
    limit_node = None
    node = plan
    if isinstance(node, LLimit):
        limit_node = node
        node = node.child
    if not isinstance(node, LSort):
        return None
    sort = node
    chain = []
    node = sort.child
    while isinstance(node, (LFilter, LProject)):
        chain.append(node)
        node = node.child
    if not isinstance(node, LScan):
        return None
    return SpillSortPlan(limit_node, sort, chain, node)


def make_sort_spill_program(sp: SpillSortPlan):
    """Per-batch device program: scan chain + sort-key OPERAND columns. The
    host concatenates the operands across batches and orders globally with
    numpy's lexsort — the same comparator as the device sort
    (ops/sort.py sort_operands), so spilled and in-memory ORDER BY agree
    row for row."""
    from ..ops.common import eval_keys
    from ..ops.sort import sort_operands

    def prog(chunk: Chunk):
        c = _run_scan_chain(chunk, sp.scan_chain)
        keys = eval_keys(c, tuple(e for e, _, _ in sp.sort.keys))
        ops = sort_operands(keys, sp.sort.keys)
        return c, tuple(ops), c.sel_mask()

    return audited(prog, "spill_sort")


def execute_spill_sort(sp: SpillSortPlan, catalog, batch_rows: int,
                       programs_cache, node, device):
    """Stream batches; return the globally ordered result as a HostTable
    (the spilled result lives in host memory — it exceeds the device by
    assumption)."""
    import torch

    handle = catalog.get_table(sp.scan.table)
    ht = handle.table
    total = ht.num_rows
    n_batches = max(1, -(-total // batch_rows))
    cap = pad_capacity(min(batch_rows, total))
    prog_key = ("spill_sort", sp.sort, tuple(sp.scan_chain), cap)
    if prog_key not in programs_cache:
        programs_cache[prog_key] = make_sort_spill_program(sp)
    jprog = programs_cache[prog_key]

    alias, cols = sp.scan.alias, sp.scan.columns
    node.set_info("batches", n_batches)
    out_tables, out_ops = [], None
    for b in range(n_batches):
        fail_point("spill_sort::batch")
        lifecycle.checkpoint("spill_sort::batch")
        lo, hi = b * batch_rows, min((b + 1) * batch_rows, total)
        chunk = slice_scan_chunk(ht, alias, cols, slice(lo, hi), cap,
                                 device, node)
        c, ops, live = jprog(chunk)
        with node.timer("d2h_s"):
            idx = torch.nonzero(live, as_tuple=True)[0]
            out_tables.append(HostTable.from_chunk(c))  # drops dead rows
            batch_ops = [(o[idx] if o.ndim else o.expand(cap)[idx]).cpu()
                         .numpy() for o in ops]
        node.add_counter("d2h_syncs", 2 + len(c.schema) + len(ops))
        lifecycle.account(out_tables[-1], "spill_sort::batch")
        if out_ops is None:
            out_ops = [[o] for o in batch_ops]
        else:
            for acc, o in zip(out_ops, batch_ops):
                acc.append(o)

    fail_point("spill_sort::merge")
    lifecycle.checkpoint("spill_sort::merge")
    schema, merged_arrays, merged_valids = host_concat_tables(out_tables)
    with node.timer("lexsort_s"):
        order = np.lexsort(tuple(np.concatenate(a) for a in out_ops))
    lo = 0
    hi = len(order)
    if sp.sort.limit is not None:
        hi = min(hi, sp.sort.limit)
    if sp.limit_node is not None:
        lo = sp.limit_node.offset
        hi = min(hi, lo + sp.limit_node.limit)
    order = order[lo:hi]
    node.set_info("host_rows", int(sum(t.num_rows for t in out_tables)))
    return HostTable(
        schema,
        {k: v[order] for k, v in merged_arrays.items()},
        {k: v[order] for k, v in merged_valids.items()},
    )


# --- spilled WINDOW: host hash-partitioned groups, device window per group ----


@dataclasses.dataclass
class SpillWindowPlan:
    top_chain: list  # Project/Filter above the windows (per-row operators)
    windows: list  # LWindow stack, outermost first
    hash_cols: list  # scan columns common to every window's PARTITION BY
    scan_chain: list  # Filter/identity-Project* between windows and scan
    scan: LScan


def match_spill_window(plan: LogicalPlan):
    """(Project/Filter)* -> LWindow(partitioned) -> Filter* -> LScan.
    Window partitions are disjoint under PARTITION BY, so hash-splitting
    ROWS by the partition keys preserves exact window semantics per group.
    Partition keys must be plain scan columns so the host can route without
    re-implementing expression semantics."""
    from ..sql.logical import LWindow

    top = []
    node = plan
    while isinstance(node, (LProject, LFilter)):
        top.append(node)
        node = node.child
    windows = []
    while isinstance(node, LWindow):
        if not node.partition_by:
            return None
        windows.append(node)
        node = node.child
    if not windows:
        return None
    chain = []
    while isinstance(node, (LFilter, LProject)):
        if isinstance(node, LProject) and not all(
                isinstance(e, Col) and n == e.name for n, e in node.exprs):
            return None  # computed/renaming projections between window and
            # scan would detach partition-key names from scan columns
        chain.append(node)
        node = node.child
    if not isinstance(node, LScan):
        return None
    # hash-splitting by K preserves every window iff K is a subset of each
    # window's partition keys: use the intersection of their key sets
    key_sets = []
    for w in windows:
        cols = set()
        for e in w.partition_by:
            if not isinstance(e, Col):
                return None
            base = e.name.split(".", 1)[-1]
            if base not in node.columns:
                return None
            cols.add(base)
        key_sets.append(cols)
    common = sorted(set.intersection(*key_sets))
    if not common:
        return None
    return SpillWindowPlan(top, windows, common, chain, node)


def _np_mix64(x):
    z = np.asarray(x, np.uint64).copy()
    with np.errstate(over="ignore"):
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
    return z


_STREAM_FNS = frozenset(
    {"row_number", "rank", "dense_rank", "sum", "count", "min", "max",
     "first_value"})


def _stream_window_eligible(sp: SpillWindowPlan):
    """The carried-running-state streaming path covers ONE window whose
    functions all have default frames in the running family and whose
    ORDER BY keys are plain scan columns."""
    if len(sp.windows) != 1:
        return None
    w = sp.windows[0]
    if not w.order_by:
        return None
    okeys = []
    for e, _asc, _nf in w.order_by:
        if not isinstance(e, Col):
            return None
        okeys.append(e.name.split(".", 1)[-1])
    for spec in w.funcs:
        fn = spec[1]
        frame = spec[5] if len(spec) > 5 else None
        if fn not in _STREAM_FNS or frame is not None:
            return None
    if any(c not in sp.scan.columns for c in okeys):
        return None
    return okeys


def _host_key_cols(ht, cols):
    """(value, validity) pairs for host sorting/equality where NULLs form
    their own group (matching the device window's NULL-equal rule)."""
    out = []
    for c in cols:
        d = np.asarray(ht.arrays[c])
        v = ht.valids.get(c)
        if v is not None:
            d = np.where(v, d, d.dtype.type(0))
            out.append(np.asarray(v, np.int8))
        out.append(d)
    return out


def _np_descending(d):
    """Host analog of the device sort key negation."""
    if d.dtype.kind == "f":
        return -d
    return -np.asarray(d, np.int64)


def _window_program(sp: SpillWindowPlan, windows, top_chain):
    from ..ops.window import window_op

    def prog(chunk: Chunk):
        c = _run_scan_chain(chunk, sp.scan_chain)
        for w in reversed(windows):  # innermost window first
            c = window_op(c, w.partition_by, w.order_by, w.funcs)
        return _apply_top_chain(c, top_chain)

    return audited(prog, "spill_window")


def execute_streaming_window(sp: SpillWindowPlan, catalog, batch_rows: int,
                             programs_cache, node, okeys,
                             device):
    """Windows whose PARTITIONS don't fit the batch budget (the skewed-
    partition spill case): ONE global host sort by (partition keys, order
    keys), then sequential device chunks CUT AT PEER BOUNDARIES, with each
    function's running state carried across chunks. The carry for every
    supported function is its own output at the last surviving row of the
    partition that continues into the next chunk (peers never straddle a
    cut, so running aggregates are complete at the boundary). A single PEER
    group must still fit one chunk."""
    w = sp.windows[0]
    handle = catalog.get_table(sp.scan.table)
    ht = handle.table
    total = ht.num_rows
    pkeys = sp.hash_cols

    t0 = time.perf_counter()
    # global sort: (partition keys, order keys asc/desc + nulls)
    ops = []
    for (e, asc, nf), name in zip(reversed(list(w.order_by)),
                                  reversed(okeys)):
        d = np.asarray(ht.arrays[name])
        if d.dtype == np.bool_:
            d = d.astype(np.int8)
        v = ht.valids.get(name)
        ops.append(d if asc else _np_descending(d))
        if v is not None:
            ops.append(np.asarray(v if nf else ~v, np.int8))
    for c in reversed(pkeys):
        for a in reversed(_host_key_cols(ht, [c])):
            ops.append(a)
    order = np.lexsort(tuple(ops))

    # peer boundaries in sorted order (same partition AND order keys)
    peer_cols = [a[order] for a in _host_key_cols(ht, pkeys + okeys)]
    is_new_peer = np.ones(total, np.bool_)
    if total > 1:
        same = np.ones(total - 1, np.bool_)
        for a in peer_cols:
            same &= a[1:] == a[:-1]
        is_new_peer[1:] = ~same

    peer_starts = np.flatnonzero(is_new_peer)
    # chunk cuts: greedy fill up to batch_rows, backing up to a peer start
    cuts = [0]
    while cuts[-1] < total:
        want = cuts[-1] + batch_rows
        if want >= total:
            cuts.append(total)
            break
        j = np.searchsorted(peer_starts, want, side="right") - 1
        nxt = int(peer_starts[j])
        if nxt <= cuts[-1]:  # one peer group larger than the batch
            j2 = np.searchsorted(peer_starts, cuts[-1], side="right")
            nxt = int(peer_starts[j2]) if j2 < len(peer_starts) else total
        cuts.append(nxt)
    cap = pad_capacity(max(b - a for a, b in zip(cuts, cuts[1:])))
    node.add_counter("partition_s", time.perf_counter() - t0, "s")

    prog_key = ("stream_window", tuple(sp.windows), tuple(sp.scan_chain),
                cap)
    if prog_key not in programs_cache:
        programs_cache[prog_key] = _window_program(sp, [w], [])
    jprog = programs_cache[prog_key]

    node.set_info("stream_chunks", len(cuts) - 1)
    alias, cols = sp.scan.alias, sp.scan.columns
    fnames = [spec[0] for spec in w.funcs]
    fkinds = [spec[1] for spec in w.funcs]
    carry_key = None   # tuple of host part-key values of the open partition
    carries = None     # per-fn carried output value (peer-complete at cut)
    cont_rows = 0      # emitted rows of the open partition so far
    outs = []
    for a, b in zip(cuts, cuts[1:]):
        fail_point("stream_window::chunk")
        lifecycle.checkpoint("stream_window::chunk")
        idx = order[a:b]
        out = HostTable.from_chunk(jprog(
            slice_scan_chunk(ht, alias, cols, idx, cap, device, node)))
        lifecycle.account(out, "stream_window::chunk")
        if out.num_rows:
            # output rows of the partition continuing from the previous
            # chunk; chunk-local part keys read from the OUTPUT (filters
            # may have dropped rows)
            opart = _host_key_cols(out, pkeys_out(out, alias, pkeys))
            cont = np.zeros(out.num_rows, np.bool_)
            if carry_key is not None:
                cont[:] = True
                for arr, kv in zip(opart, carry_key):
                    cont &= arr == kv
                for name, kind, (cv, cval) in zip(fnames, fkinds, carries):
                    if not cont.any():
                        continue
                    colv = np.array(out.arrays[name])
                    lval = out.valids.get(name)
                    lval = (np.array(lval) if lval is not None
                            else np.ones(out.num_rows, np.bool_))
                    if kind in ("row_number", "rank"):
                        # positional: offset by the ROWS the partition
                        # already emitted
                        colv[cont] = colv[cont] + cont_rows
                    elif kind in ("dense_rank", "sum", "count"):
                        if cval:
                            # locally-NULL running values become the
                            # carried state
                            both = cont & lval
                            colv[both] = colv[both] + cv
                            only_carry = cont & ~lval
                            colv[only_carry] = cv
                            lval[cont] = True
                    elif kind in ("min", "max"):
                        if cval:
                            both = cont & lval
                            colv[both] = (np.minimum if kind == "min"
                                          else np.maximum)(colv[both], cv)
                            only_carry = cont & ~lval
                            colv[only_carry] = cv
                            lval[cont] = True
                    elif kind == "first_value":
                        # the partition's REAL first value came from an
                        # earlier chunk — including a NULL one
                        colv[cont] = cv
                        lval[cont] = bool(cval)
                    out.arrays[name] = colv
                    if name in out.valids or not lval.all():
                        out.valids[name] = lval
            last = out.num_rows - 1
            last_key = tuple(arr[last] for arr in opart)
            in_last = np.ones(out.num_rows, np.bool_)
            for arr, kv in zip(opart, last_key):
                in_last &= arr == kv
            if carry_key is not None and last_key == carry_key:
                cont_rows += int(in_last.sum())
            else:
                cont_rows = int(in_last.sum())
            carry_key = last_key
            carries = [
                (out.arrays[n][last],
                 bool(out.valids[n][last]) if n in out.valids else True)
                for n in fnames
            ]
        outs.append(_top_chain_host(out, sp.top_chain, cap, device))

    schema, arrays, valids = host_concat_tables(outs)
    return HostTable(schema, arrays, valids)


def pkeys_out(out, alias, pkeys):
    """Partition-key column names as they appear in the window OUTPUT."""
    names = set(out.arrays)
    return [f"{alias}.{c}" if f"{alias}.{c}" in names else c for c in pkeys]


def _top_chain_host(out, top_chain, cap: int, device):
    """Apply the Project/Filter chain above the window to an ADJUSTED host
    chunk (the carries are patched on the host, so the top chain must run
    after them)."""
    if not top_chain:
        return out
    c = out.to_chunk(capacity=cap, device=device)
    return HostTable.from_chunk(_apply_top_chain(c, top_chain))


def _window_buckets(ht, key_cols, total: int, n_groups: int):
    """The group of each row: a splitmix64 chain over the PARTITION BY key
    columns, mod the group count."""
    h = np.zeros(total, np.uint64)
    with np.errstate(over="ignore"):
        for c in key_cols:
            kd = np.asarray(ht.arrays[c]).astype(np.int64)
            v = ht.valids.get(c)
            if v is not None:
                # NULL keys must land in ONE group like the device window's
                # both-NULL-equal rule; payload under invalid lanes is
                # arbitrary, so zero it and mix the validity bit instead
                kd = np.where(v, kd, np.int64(0))
                kd = kd * 2 + np.asarray(v, np.int64)
            kd = kd.view(np.uint64)
            h = _np_mix64(h ^ (kd * np.uint64(0x9E3779B97F4A7C15)))
    return (h % np.uint64(n_groups)).astype(np.int64)


def execute_spill_window(sp: SpillWindowPlan, catalog, batch_rows: int,
                         programs_cache, node, device):
    """Host-partition rows by the window's PARTITION BY keys, run the full
    window program per group on the device, concatenate on the host."""
    handle = catalog.get_table(sp.scan.table)
    ht = handle.table
    total = ht.num_rows
    n_groups = max(1, -(-total // batch_rows))

    t0 = time.perf_counter()
    from ..native import bucket_order, hash_partition_i64

    key_cols = sp.hash_cols
    if len(key_cols) == 1 and key_cols[0] not in ht.valids:
        # one key without NULLs: mix64(key * golden) mod n, which is the
        # host bucket function (C++, on several threads)

        bucket = hash_partition_i64(
            np.asarray(ht.arrays[key_cols[0]]).astype(np.int64), n_groups)
    else:
        bucket = _window_buckets(ht, key_cols, total, n_groups)
    order, offs = bucket_order(bucket, n_groups)
    counts = np.diff(offs)
    cap = pad_capacity(int(counts.max()) if total else 1)
    node.add_counter("partition_s", time.perf_counter() - t0, "s")

    # a SKEWED partition can exceed the hash-split budget (every row of
    # one PARTITION BY group lands in one bucket): switch to the streaming
    # evaluator with carried running state when the window family allows
    if cap > pad_capacity(batch_rows * 4):
        okeys = _stream_window_eligible(sp)
        if okeys is not None:
            return execute_streaming_window(
                sp, catalog, batch_rows, programs_cache, node, okeys,
                device)

    prog_key = ("spill_window", tuple(sp.windows), tuple(sp.scan_chain),
                tuple(sp.top_chain), cap)
    if prog_key not in programs_cache:
        programs_cache[prog_key] = _window_program(sp, sp.windows,
                                                   sp.top_chain)
    jprog = programs_cache[prog_key]

    alias, cols = sp.scan.alias, sp.scan.columns
    node.set_info("partition_groups", n_groups)
    outs = []
    off = 0
    for g in range(n_groups):
        cnt = int(counts[g])
        idx = order[off:off + cnt]
        off += cnt
        if cnt == 0:
            continue
        fail_point("spill_window::group")
        lifecycle.checkpoint("spill_window::group")
        chunk = slice_scan_chunk(ht, alias, cols, idx, cap, device, node)
        with node.timer("d2h_s"):
            outs.append(HostTable.from_chunk(jprog(chunk)))
        lifecycle.account(outs[-1], "spill_window::group")

    schema, arrays, valids = host_concat_tables(outs)
    return HostTable(schema, arrays, valids)
