"""Two-tier query cache: full-result reuse + per-segment partial aggregation.

Reference behavior: the BE's dedicated query-cache subsystem
(be/src/exec/query_cache/ — cache_manager.h, multilane_operator.h,
ticket_checker.h) behind the FE session variables enable_query_cache /
query_cache_entry_max_bytes: OLAP dashboards re-issue the same
aggregations over slowly-appending tables, so the per-tablet cache keeps
partial-aggregation states keyed by tablet version and re-aggregates only
the delta after an ingest (multi-version cache reuse).

Re-designed for the compiled engine as TWO reuse tiers sharing one
memory-budgeted host LRU (`SET enable_query_cache = on`,
`query_cache_capacity_mb`):

- **Full-result tier** (query_cache.py + keys.py): keyed by the analyzed
  logical plan (a frozen hashable tree), `config.trace_key()` (the same
  declared-knob set that keys compiled programs), the optimizer-knob
  values, and the UDF registry epoch; validated on hit against per-table
  data versions (catalog data epochs + storage content tokens). A warm hit
  returns the materialized HostTable without touching optimizer, compiler,
  or device.

- **Partial-aggregation tier** (partial.py): for deterministic
  scan->filter/project->aggregate fragments over stored tables, each
  manifest data file (segment) is aggregated INDEPENDENTLY through the
  engine's existing PARTIAL/FINAL split (ops/aggregate.py, shared with the
  spill and distributed planners), and the per-segment partial states are
  cached keyed by (fragment fingerprint, segment identity). After an
  append, only NEW segments scan + aggregate; cached states merge with
  fresh partials through the FINAL re-aggregation path.

Invalidation is hook-driven (storage/store.py mutation listeners +
storage/catalog.py data epochs) and key-verified: analysis/key_check.py's
`check_cache_reads` audits the knob reads of every execution whose result
enters the cache (Executor._verify_cache_reads). A port of the JAX
package's cache/.
"""

from .query_cache import QueryCache  # noqa: F401
