"""Prepared-statement / parameterized plan cache: the warm fast path.

Reference behavior: the FE's prepared-statement plan cache
(qe/PrepareStmtContext + the cachable-plan path in StmtExecutor) — a
dashboard re-issuing the same statement text must not pay
parse/analyze/optimize again. Here the cache sits in FRONT of the
analyzer: statement text -> analyzed logical plan. Combined with the
full-result tier (cache/query_cache.py, keyed by that same analyzed
plan), a warm hit answers without touching parse, analyze, optimize,
or the device.

Validity: an analyzed plan depends on catalog SHAPE (table schemas, view
definitions, UDF signatures), not on table data — so entries are
validated per hit against the catalog's `schema_epoch` (bumped by every
register/drop/ALTER/view DDL) and the UDF registry epoch, and the whole
cache drops on any mismatch-shaped event. DML never invalidates plans
(stats-driven re-planning happens a layer down, in the optimized-plan
cache that DML DOES evict).

A port of the JAX package's cache/plan_cache.py (one lock, O(1)
critical sections), shared by every session of a serving tier. `peek` is
the tier's counter-free fast-path probe (runtime/serving.py); MySQL
COM_STMT_EXECUTE splices its parameters into the text first, so each
parameter vector is its own entry.
"""

from __future__ import annotations

from collections import OrderedDict

from .. import lockdep
from ..runtime.config import config
from ..runtime.metrics import metrics

config.define("enable_plan_cache", True, True,
              "cache analyzed plans by statement text (the prepared-"
              "statement fast path in front of the optimizer)")

PLAN_CACHE_HITS = metrics.counter(
    "sr_tpu_plan_cache_hits_total",
    "statements answered from the text->analyzed-plan cache")
PLAN_CACHE_MISSES = metrics.counter(
    "sr_tpu_plan_cache_misses_total",
    "statement texts that had to be parsed+analyzed")


class PlanCache:
    """Text -> analyzed-plan LRU with schema/UDF-epoch validation."""

    MAX_ENTRIES = 512

    def __init__(self):
        self._lock = lockdep.lock("PlanCache._lock")
        # text -> (plan, schema_epoch, udf_epoch)
        self._entries: OrderedDict = OrderedDict()  # guarded_by: _lock
        self.hits = 0                               # guarded_by: _lock
        self.misses = 0                             # guarded_by: _lock

    def lookup(self, text: str, catalog):
        """The analyzed plan for `text`, or None (miss / stale). Plans are
        frozen value trees — safe to share across threads and reuse as
        dict keys downstream (opt-plan + result-cache keys)."""
        from ..runtime.udf import registry_epoch

        sep = getattr(catalog, "schema_epoch", 0)
        uep = registry_epoch()
        with self._lock:
            e = self._entries.get(text)
            if e is not None and e[1] == sep and e[2] == uep:
                self._entries.move_to_end(text)
                self.hits += 1
                PLAN_CACHE_HITS.inc()
                return e[0]
            if e is not None:
                del self._entries[text]  # stale shape: drop eagerly
            self.misses += 1
            PLAN_CACHE_MISSES.inc()
            return None

    def peek(self, text: str, catalog):
        """Counter-free validity probe (the serving tier decides whether a
        statement can take the inline fast path without skewing hit/miss
        accounting). Returns the plan or None; never evicts."""
        from ..runtime.udf import registry_epoch

        sep = getattr(catalog, "schema_epoch", 0)
        uep = registry_epoch()
        with self._lock:
            e = self._entries.get(text)
            if e is not None and e[1] == sep and e[2] == uep:
                return e[0]
            return None

    def store(self, text: str, plan, catalog):
        from ..runtime.udf import registry_epoch

        sep = getattr(catalog, "schema_epoch", 0)
        uep = registry_epoch()
        with self._lock:
            self._entries[text] = (plan, sep, uep)
            self._entries.move_to_end(text)
            while len(self._entries) > self.MAX_ENTRIES:
                self._entries.popitem(last=False)

    def clear(self):
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses}
