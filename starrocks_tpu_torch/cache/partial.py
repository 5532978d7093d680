"""Per-segment partial-aggregation cache (tier 2): multi-version delta reuse.

Reference behavior: be/src/exec/query_cache/ — the BE caches each tablet's
partial-aggregation state keyed by tablet version; after an ingest only the
delta rowsets re-scan and the cached states merge with the fresh partials.

Engine mapping: a "segment" is one manifest data file of a stored table
(immutable rowset file; its identity token is keys.segment_version).
For a cacheable fragment

    (Project/Sort/Limit/Filter)* -> LAggregate -> (Filter/Project)* -> LScan

over a StoredTableHandle, each segment streams through the SAME
PARTIAL-mode program the spill path uses (runtime/batched.make_programs,
ops/aggregate.hash_aggregate) and its state chunk is pulled to host and
cached. Execution then merges every segment's state — cached or fresh —
with the session-level concat (dict-code remapping across per-segment
dictionaries) and finishes through the FINAL-mode re-aggregation plus the
fragment's top chain. Appends therefore cost O(new segments); the
`qcache_rows_saved` counter reports the rows the cache kept off the scan.

Rides the executor's shared adaptive-capacity loop (`_adaptive`): group
capacity overflows retry exactly like every other aggregation, and a state
is only cached when its true group count fit its capacity (truncated
states are discarded, never stored). Cacheability is the optimizer's
judgement (sql/optimizer.plan_uncacheable_reason over the fragment): no
nondeterministic exprs, no UDFs, no DISTINCT/holistic aggregates — and the
fragment has no join, so no runtime filter can mutate its probe side.

A port of the JAX package's cache/partial.py. A segment is one data file
of the port's TabletStore. Each fresh segment's state count is read
back before the state is cached (one device-to-host copy per segment, as
in the reference); the states live on the host.
"""

from __future__ import annotations

from ..column import HostTable
from ..column.column import pad_capacity
from ..runtime.config import config
from . import keys as cache_keys

CAP_KEY = "qcache_agg"


def match_cacheable_fragment(plan, catalog):
    """(BatchablePlan, StoredTableHandle) when the plan is a cacheable
    scan-agg fragment over a stored table, else None."""
    from ..ops.aggregate import decomposable
    from ..runtime.batched import match_batchable
    from ..sql.optimizer import plan_uncacheable_reason
    from ..storage.catalog import StoredTableHandle

    bp = match_batchable(plan)
    if bp is None or not decomposable(bp.agg.aggs):
        return None
    for _, a in bp.agg.aggs:
        if a.distinct or a.fn == "group_concat":
            return None
    handle = catalog.get_table(bp.scan.table)
    if not isinstance(handle, StoredTableHandle) or handle.store is None:
        return None
    # bp.agg.child chains down to the scan, so one walk covers the whole
    # fragment's expressions (the top chain may be nondeterministic — it
    # re-runs every execution and never enters the cached state)
    if plan_uncacheable_reason(bp.agg) is not None:
        return None
    return bp, handle


def try_partial_cached(executor, plan, profile):
    """Execute `plan` through the per-segment partial-aggregation cache.
    Returns the result chunk, or None when the plan is not a cacheable
    fragment (caller falls through to the normal paths)."""
    if not config.get("enable_query_cache"):
        return None
    m = match_cacheable_fragment(plan, executor.catalog)
    if m is None:
        return None
    bp, handle = m
    store = handle.store
    manifest = store.read_manifest(handle.name)
    seg_metas = [f for rs in manifest["rowsets"] for f in rs["files"]]
    if not seg_metas:
        return None  # empty table: nothing to cache against
    from ..runtime.batched import profile_node

    fkey = cache_keys.fragment_key(bp.agg, bp.scan_chain, bp.scan)
    qc = executor.cache.qcache
    bucket = executor.cache.program_bucket(("qcache_partial", plan))
    node = profile_node(profile, "qcache_partial")
    node.set_info("segments", len(seg_metas))
    # one device: the executor's home (a mesh's shard 0 card)
    dev = executor.home_device
    stats = {}

    def attempt(caps, p):
        from ..runtime import lifecycle
        from ..runtime.batched import make_programs, slice_scan_chunk
        from ..runtime.failpoint import fail_point
        from ..runtime.session import concat_tables

        executor.cache.bucket_adopt_last(bucket, caps)
        group_cap = caps.get(CAP_KEY, config.get("default_agg_groups"))
        pair = executor.cache.bucket_prog_get(bucket, group_cap)
        if pair is None:
            pair = executor.cache.bucket_prog_put(
                bucket, group_cap, make_programs(bp, group_cap))
        jpartial, jfinal = pair

        states, max_ng = [], 0
        hits = saved = fresh_rows = 0
        # LRU admission is DEFERRED until the whole fragment completes: a
        # failure mid-loop must not leave a half-populated set of partial
        # entries behind
        pending_puts = []
        with node.timer("segments_s"):
            for fmeta in seg_metas:
                fail_point("qcache::partial_segment")
                lifecycle.checkpoint("qcache::partial_segment")
                ver = cache_keys.segment_version(store, handle.name, fmeta)
                live = fmeta["rows"] - len(fmeta.get("delvec") or ())
                ent = qc.get_partial(fkey, ver) if ver is not None else None
                if ent is not None:
                    states.append(ent.table)
                    hits += 1
                    saved += ent.rows
                    continue
                ht = store.load_table(
                    handle.name, columns=list(bp.scan.columns),
                    files={fmeta["file"]})
                chunk = slice_scan_chunk(
                    ht, bp.scan.alias, bp.scan.columns, slice(None),
                    pad_capacity(max(ht.num_rows, 1)), dev, node)
                out, ng = jpartial(chunk)
                ng = int(ng)
                max_ng = max(max_ng, ng)
                fresh_rows += live
                if ng > group_cap:
                    # truncated state: report the overflow so _adaptive
                    # grows the capacity; segments already cached stay
                    executor.cache.bucket_last_set(bucket, caps.values)
                    return None, {CAP_KEY: max_ng}
                st = HostTable.from_chunk(out)
                lifecycle.account(st, "qcache::partial_segment")
                states.append(st)
                if ver is not None:
                    pending_puts.append((ver, st, live))

        lifecycle.checkpoint("qcache::partial_merge")
        with node.timer("merge_final_s"):
            merged = states[0]
            for st in states[1:]:
                merged = concat_tables(merged, st,
                                       target_schema=merged.schema)
            out, ng = jfinal(merged.to_chunk(device=dev))
            ng = int(ng)
        executor.cache.bucket_last_set(bucket, caps.values)
        if lifecycle.degraded():
            node.set_info("qcache_declined", "mem-soft-degraded")
        else:
            for ver, st, live in pending_puts:
                fail_point("qcache::partial_store")
                qc.put_partial(fkey, ver, st, live)
        stats.update(hits=hits, saved=saved, fresh=fresh_rows)
        return out, {CAP_KEY: max(max_ng, ng)}

    out = executor._adaptive(profile, attempt)
    node.set_info("qcache_partial_hits", stats.get("hits", 0))
    node.set_info("qcache_rows_saved", stats.get("saved", 0))
    node.set_info("qcache_fresh_rows", stats.get("fresh", 0))
    profile.add_counter("qcache_partial_hits", stats.get("hits", 0))
    profile.add_counter("qcache_rows_saved", stats.get("saved", 0))
    profile.add_counter("qcache_partial_recomputed",
                        len(seg_metas) - stats.get("hits", 0))
    return out
