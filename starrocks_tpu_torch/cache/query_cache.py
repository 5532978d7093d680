"""Memory-budgeted host LRU shared by both query-cache tiers.

Reference behavior: be/src/exec/query_cache/cache_manager.h — one
process-level LRU holding per-tablet aggregation states with byte-sized
accounting and capacity eviction. Here both tiers live in one ordered map:

- ("r", structural_key)            -> full-result entry (HostTable +
                                      executed plan + {table: version})
- ("p", fragment_key, segment_ver) -> per-segment partial-aggregation
                                      state (HostTable of PARTIAL columns)

Full-result entries validate their version map on every hit (a stale entry
is dropped on the spot — the INSERT-then-repeat path); partial entries are
self-validating by key (the segment version token pins file content), so
table invalidation only needs to drop the full-result tier.

Byte accounting is estimate-based (array nbytes + valid masks + dictionary
payloads); eviction pops least-recently-used entries of EITHER tier past
`query_cache_capacity_mb`. Hit/miss/evict totals feed both the process
metric registry (information_schema.metrics) and per-query RuntimeProfile
counters.

A port of the JAX package's cache/query_cache.py: the same tiers, keys,
accounting, lock names and eviction events.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

from .. import lockdep
from ..runtime.config import config
from ..runtime.failpoint import fail_point
from ..runtime.metrics import metrics

QCACHE_HITS = metrics.counter(
    "sr_tpu_qcache_hits_total", "full-result query cache hits")
QCACHE_MISSES = metrics.counter(
    "sr_tpu_qcache_misses_total", "full-result query cache misses")
QCACHE_PARTIAL_HITS = metrics.counter(
    "sr_tpu_qcache_partial_hits_total",
    "per-segment partial-aggregation state reuses")
QCACHE_EVICTIONS = metrics.counter(
    "sr_tpu_qcache_evictions_total", "query cache LRU evictions")
QCACHE_BYTES = metrics.gauge(
    "sr_tpu_qcache_bytes", "query cache resident bytes (all sessions)")


def table_bytes(ht) -> int:
    """Estimated host bytes of a HostTable (arrays + valid masks + string
    dictionary payloads; shared dictionaries count per entry — the estimate
    errs toward earlier eviction, never toward blowing the budget)."""
    n = 0
    for a in ht.arrays.values():
        n += getattr(a, "nbytes", 0)
    for v in ht.valids.values():
        n += getattr(v, "nbytes", 0)
    for f in ht.schema:
        d = getattr(f, "dict", None)
        if d is not None:
            try:
                n += sum(len(s) for s in d.values) + 8 * len(d)
            except TypeError:
                pass
    return n


@dataclasses.dataclass
class ResultEntry:
    table: object        # HostTable — the materialized, prettified result
    plan: object         # the executed (optimized, resolved) plan
    versions: dict       # {table: data version token} observed at store
    nbytes: int


@dataclasses.dataclass
class PartialEntry:
    table: object        # HostTable of PARTIAL aggregation state rows
    rows: int            # live source rows the state summarizes
    nbytes: int


class QueryCache:
    """One instance per DeviceCache (= per Session): invalidation piggy-
    backs on the same DeviceCache.invalidate(table) every DML path already
    calls, and version validation covers cross-session mutations through
    the shared catalog's data epochs."""

    def __init__(self):
        self._lock = lockdep.rlock("QueryCache._lock")
        self._entries: OrderedDict = OrderedDict()  # guarded_by: _lock
        self._bytes = 0                             # guarded_by: _lock
        self.evictions = 0                          # guarded_by: _lock

    # --- full-result tier ----------------------------------------------------
    def lookup_result(self, skey, catalog):
        """Validated hit or None. Stale entries (any table's current data
        version differs from the one observed at store time) are dropped
        immediately — the append-invalidates-repeat contract."""
        fail_point("qcache::lookup")
        with self._lock:
            k = ("r", skey)
            e = self._entries.get(k)
            if e is None:
                QCACHE_MISSES.inc()
                return None
            for t, v in e.versions.items():
                if catalog.data_version(t) != v:
                    self._drop(k)
                    QCACHE_MISSES.inc()
                    return None
            self._entries.move_to_end(k)
            QCACHE_HITS.inc()
            return e

    def has_result(self, skey, catalog) -> bool:
        """Counter-free validity probe (the serving tier's fast-path
        sniff): True when a lookup_result RIGHT NOW would hit. Stale
        entries are left for the real lookup to drop."""
        with self._lock:
            e = self._entries.get(("r", skey))
            if e is None:
                return False
            return all(catalog.data_version(t) == v
                       for t, v in e.versions.items())

    def store_result(self, skey, table, plan, versions):
        fail_point("qcache::store_result")
        with self._lock:
            e = ResultEntry(table, plan, versions, table_bytes(table))
            self._put(("r", skey), e)

    # --- partial-aggregation tier --------------------------------------------
    def get_partial(self, fkey, segver):
        with self._lock:
            k = ("p", fkey, segver)
            e = self._entries.get(k)
            if e is not None:
                self._entries.move_to_end(k)
                QCACHE_PARTIAL_HITS.inc()
            return e

    def put_partial(self, fkey, segver, table, rows: int):
        with self._lock:
            e = PartialEntry(table, rows, table_bytes(table))
            self._put(("p", fkey, segver), e)

    # --- invalidation ---------------------------------------------------------
    def invalidate_table(self, table: str):
        """Drop full-result entries that observed `table` (DML hook, rides
        DeviceCache.invalidate). Partial entries stay: their segment-version
        keys already pin exact file content, so after an append the old
        segments' states remain valid — that IS the delta-reuse tier."""
        fail_point("qcache::invalidate")
        t = table.lower()
        with self._lock:
            stale = [k for k, e in self._entries.items()
                     if k[0] == "r" and t in e.versions]
            for k in stale:
                self._drop(k)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            QCACHE_BYTES.set(0)

    # --- accounting -----------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def _put(self, k, e):  # lint: holds _lock
        old = self._entries.pop(k, None)
        if old is not None:
            self._bytes -= old.nbytes
        self._entries[k] = e
        self._bytes += e.nbytes
        budget = config.get("query_cache_capacity_mb") << 20
        evicted = 0
        while self._bytes > budget and self._entries:
            _, victim = self._entries.popitem(last=False)
            self._bytes -= victim.nbytes
            self.evictions += 1
            evicted += 1
            QCACHE_EVICTIONS.inc()
        QCACHE_BYTES.set(self._bytes)
        if evicted:
            from ..runtime import events

            # the journal lock is a leaf, safe under the cache lock
            events.emit("cache_evict_pressure", evicted=evicted,
                        resident_bytes=self._bytes)

    def _drop(self, k):  # lint: holds _lock
        e = self._entries.pop(k, None)
        if e is not None:
            self._bytes -= e.nbytes
            QCACHE_BYTES.set(self._bytes)
