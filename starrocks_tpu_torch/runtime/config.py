"""Typed config registry.

Reference behavior: be/src/common/configbase.h:104 (macro-declared typed
fields, file-loadable, runtime-mutable subset, introspectable — 823 options
in common/config.h) and the FE's ~700 session variables serialized per-query
(qe/SessionVariable.java). Here: one process-wide registry of declared,
typed, default-valued options; mutable flags enforced; env/file overrides.

A copy of the JAX package's registry holding only the knobs the port reads.
Each keeps the reference's name, values and default, so a `SET` selects the
same plan in both packages; where a value names a Pallas kernel, the port
runs its hand-written CUDA counterpart (ops/kernels.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Callable, Optional


@dataclasses.dataclass
class ConfigField:
    name: str
    default: Any
    type: type
    mutable: bool
    description: str
    value: Any = None
    # trace=True declares that the knob's value shapes the physical plan
    # (the executor keys its per-plan capacity memory by config.trace_key())
    trace: bool = False
    # kept for parity with the reference registry's field layout
    cache_key: bool = False


class ConfigRegistry:
    def __init__(self):
        self._fields: dict = {}
        self._hooks: dict = {}
        self._reads = threading.local()  # per-thread stack of read-sets
        self._scoped = threading.local()  # per-thread values read instead

    def define(self, name, default, mutable=True, description="",
               trace=False, cache_key=False):
        f = ConfigField(name, default, type(default), mutable, description,
                        default, trace, cache_key)
        self._fields[name] = f
        return f

    def get(self, name: str):
        for s in getattr(self._reads, "stack", ()):
            s.add(name)
        over = getattr(self._scoped, "values", None)
        if over and name in over:
            return over[name]
        return self._fields[name].value

    @contextlib.contextmanager
    def scoped(self, values: dict):
        """Read `values` in place of those knobs' settings on THIS thread
        while the context is open. The settings, and what other threads
        read, stay as they are."""
        for name in values:
            if name not in self._fields:
                raise KeyError(f"unknown config {name!r}")
        prev = getattr(self._scoped, "values", None)
        self._scoped.values = {**(prev or {}), **values}
        try:
            yield
        finally:
            self._scoped.values = prev

    @contextlib.contextmanager
    def record_reads(self):
        """Collect the set of knob names read (via get) on this thread while
        the context is open — the key-completeness checker's probe. Nested
        windows record independently (inner executions audit themselves)."""
        stack = getattr(self._reads, "stack", None)
        if stack is None:
            stack = self._reads.stack = []
        reads: set = set()
        stack.append(reads)
        try:
            yield reads
        finally:
            # remove by IDENTITY: list.remove compares by equality, and a
            # nested window whose set momentarily EQUALS this one (common —
            # get() adds to every open set) would pop the wrong entry,
            # leaving this one behind to raise on its own exit
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is reads:
                    del stack[i]
                    break

    def trace_knobs(self) -> frozenset:
        """Names of all knobs declared trace-affecting."""
        return frozenset(f.name for f in self._fields.values() if f.trace)

    def trace_key(self) -> tuple:
        """(name, value) of every trace-affecting knob, sorted by name —
        the config portion of the compiled-program cache key. Declaring a
        knob trace=True is sufficient to key it; there is no second list
        to keep in sync."""
        return tuple(sorted(
            (f.name, f.value) for f in self._fields.values() if f.trace))

    def cache_key_knobs(self) -> frozenset:
        """Names of knobs declared cache_key=True (the query-result cache's
        own machinery; see ConfigField.cache_key)."""
        return frozenset(
            f.name for f in self._fields.values() if f.cache_key)

    def set(self, name: str, value, force: bool = False):
        f = self._fields.get(name)
        if f is None:
            raise KeyError(f"unknown config {name!r}")
        if not f.mutable and not force:
            raise PermissionError(f"config {name!r} is not runtime-mutable")
        if f.type is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "on", "yes")
        f.value = f.type(value)
        hook = self._hooks.get(name)
        if hook is not None:
            hook(f.value)

    def on_set(self, name: str, hook):
        """Apply-side hook run on every successful set (and immediately with
        the current value if non-default) — wiring lives with the field, not
        in import-time module code."""
        self._hooks[name] = hook
        f = self._fields[name]
        if f.value != f.default:
            hook(f.value)

    def load_env(self, prefix: str = "SR_TPU_"):
        for name, f in self._fields.items():
            env = prefix + name.upper()
            if env in os.environ:
                self.set(name, os.environ[env], force=True)

    def load_file(self, path: str):
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                k, _, v = line.partition("=")
                self.set(k.strip(), v.strip(), force=True)

    def items(self):
        return [
            (f.name, f.value, f.default, f.mutable, f.description)
            for f in self._fields.values()
        ]


config = ConfigRegistry()

# --- engine options (the session-variable / config.h analog subset) ----------
config.define("max_recompiles", 10, True, "adaptive capacity recompile limit per query")
config.define("join_expand_headroom", 1.2, True, "growth factor applied on capacity overflow")
config.define("enable_zonemap_pruning", True, True, "prune parquet rowsets by zonemap stats")
config.define("compaction_trigger_rowsets", 8, True,
              "compact a stored table when its rowset count reaches this "
              "(0 disables auto-compaction)")
config.define("enable_runtime_filters", True, True, "build-side min/max filters applied to join probes",
              trace=True)
config.define("runtime_filter_strategy", "auto", True,
              "auto | minmax | bloom | off: probe-side join runtime filter. "
              "auto = exact dense bitmap when catalog stats bound the key "
              "range, else a bloom bitset (2-probe multiply-shift hash into "
              "a power-of-2 bit array — near-exact membership for ANY key "
              "range), else min/max; minmax = range filter only (legacy "
              "weak half); bloom = force the bloom bitset; off = no probe "
              "filter (A/B anchor). Also gates two-phase scan-level "
              "pruning (host build-key bounds -> probe zonemap pruning)",
              trace=True)
config.define("rf_bloom_max_bits", 1 << 23, True,
              "bit-array size cap for bloom runtime filters (rounded down "
              "to a power of 2; ~8 bits/build-row are allocated up to this "
              "cap — past it the filter degrades gracefully and the "
              "planner stops treating it as near-exact)",
              trace=True)
config.define("hll_precision", 12, True,
              "HLL register-count exponent for approx_count_distinct / "
              "hll_sketch (2^p int8 registers; relative error ~1.04/2^(p/2))",
              trace=True)
config.define("bitmap_default_domain", 65536, True,
              "bitmap_agg value-domain size when catalog bounds are absent "
              "(values outside [0, domain) are dropped like the reference's "
              "non-uint32 to_bitmap inputs)",
              trace=True)
config.define("rand_seed", 42, True,
              "seed for rand()/random() (deterministic per compile)",
              trace=True)
config.define("enable_mv_rewrite", True, True,
              "transparently rewrite queries onto FRESH matching "
              "materialized views (SPJG containment; sql/mv_rewrite.py)")
config.define("enable_lowcard_agg", True, True,
              "sort-free packed-code aggregation for dictionary-bounded group keys",
              trace=True)
config.define("enable_cached_build_sort", True, True,
              "pass cached per-(table, key) build-side sort permutations "
              "into compiled joins (skips the per-query build argsort)",
              trace=True)
config.define("dense_agg_domain_max", 0, True,
              "max bounded group-key domain covered by a dense packed-gid "
              "aggregation capacity (0 = auto: 2^24 on every device, the "
              "reference's CPU value, so both packages plan alike)",
              trace=True)
config.define("segment_strategy", "auto", True,
              "auto | mxu | scatter | pallas | native: auto and scatter "
              "run plain scatter reductions on every device (the "
              "reference's CPU choice); mxu runs the scatter-free "
              "strategies (one-hot limb matmul for integer sums, "
              "broadcast-reduce and segmented scans for float sums and "
              "min/max); pallas is mxu with float sums over <= 1024 "
              "groups routed through the segment-sum kernel "
              "(csrc/segment_sum.cu; its plain torch version on CPU "
              "tensors); native runs an ungrouped filter + integer sum "
              "over one table as one pass of a host C++ function "
              "(csrc/host/fused_filter_sum.cpp) and every other "
              "reduction as scatter",
              trace=True)
config.define("enable_packed_sort_keys", True, True,
              "pack bounded ORDER BY / window sort keys (dict codes, "
              "bools, stats-bounded ints) into ONE order-preserving int64 "
              "so multi-operand lexsorts become a single-key argsort "
              "(descending via complement, NULLS FIRST/LAST via a "
              "sentinel bit per nullable key)",
              trace=True)
config.define("topn_strategy", "auto", True,
              "auto | lexsort | pallas: ORDER BY .. LIMIT k strategy for "
              "packable keys. auto = threshold top-N (a stable partial "
              "select, prunes rows past the k-th key before any gather); "
              "pallas routes the partial select through the hand-written "
              "per-block selection kernel (csrc/topn_select.cu; its plain "
              "torch version on CPU tensors); lexsort forces the full "
              "multi-operand sort",
              trace=True)
config.define("enable_window_topn", True, True,
              "rewrite rank()/row_number()/dense_rank() <= k filters over "
              "a window into per-partition segmented top-N pruning (the "
              "TopN runtime-filter analog: downstream sorts run over "
              "~k*partitions rows instead of the full window input)")
config.define("join_probe_strategy", "auto", True,
              "auto | pallas | pallas_sorted: unique-join probe strategy. "
              "pallas = open-addressing hash-table build+probe kernels "
              "(csrc/hash_table.cu; their plain torch versions on CPU "
              "tensors — replaces sort+searchsorted entirely); "
              "pallas_sorted = the sorted build probed by the "
              "lower-bound kernel (csrc/probe_searchsorted.cu; its "
              "plain torch ladder on CPU tensors); auto = "
              "torch.searchsorted over the sorted build",
              trace=True)
config.define("join_multiway_strategy", "auto", True,
              "auto | off: fuse a left-deep chain of 2+ unique-build "
              "single-key LUT-eligible INNER joins (3+ tables — the "
              "SSB/TPC-DS star shape) into ONE compiled multiway probe, "
              "a Free-Join-style flattened trie over the shared key "
              "columns (arXiv 2301.10841): every build side's dense LUT "
              "probes the fact column-at-a-time, the AND-ed match mask "
              "compacts ONCE, and payloads gather at the compacted "
              "capacity — no per-binary-join intermediate "
              "rematerialization. off = chained binary joins (A/B anchor)",
              trace=True)

# --- spill execution, plan feedback and the query cache (slice 6) -----------
config.define("default_agg_groups", 1024, True, "initial group capacity before adaptive recompile")
config.define("batch_rows_threshold", 0, True,
              "stream scan-aggregations in host batches when a table exceeds "
              "this many rows (0 = off); the spill/host-offload path")
config.define("spill_batch_rows", 0, True,
              "rows per streamed batch for the spill path (0 = use the "
              "activation threshold as the batch size)")
config.define("join_hybrid_strategy", "auto", True,
              "auto | grace: executor for equi joins past the spill "
              "threshold. auto = skew-aware hybrid hash join (dynamic "
              "build-side partitioning per arXiv 2112.02480: heavy-hitter "
              "keys route to a replicated-broadcast lane, in-budget "
              "partitions stay device-resident, only overflow partitions "
              "spill; per-partition decisions feed the memory accountant "
              "and join_* profile counters); grace = the legacy "
              "all-or-nothing Grace partition loop (A/B anchor)",
              trace=True)
config.define("join_skew_factor", 8, True,
              "hybrid-join heavy-hitter gate: a build key whose exact "
              "partition-time row count exceeds spill-batch-rows / this "
              "factor is routed to the broadcast lane (plan-time NDV "
              "stats only decide whether the detection scan runs at "
              "all). Smaller = more aggressive skew routing",
              trace=True)
config.define("join_skew_keys_max", 64, True,
              "max heavy-hitter keys the hybrid join routes to its "
              "replicated-broadcast lane (top-k by build row count; "
              "the rest stay in hash partitions)",
              trace=True)
config.define("plan_feedback", True, True,
              "plan-feedback loop (runtime/feedback.py): record observed "
              "join cardinalities, final adaptive capacities, and "
              "heavy-hitter keys per plan fingerprint after each "
              "execution, and consume them on repeats — observed "
              "cardinalities into the DP join-order cost, pre-tightened "
              "capacities seeding the program bucket, learned hot keys "
              "into hybrid-join lane routing. off = byte-identity A/B "
              "anchor (estimates only, cold capacities). Declared in "
              "OPT_KEY_KNOBS: both the optimized-plan cache and the "
              "full-result cache key on it")
config.define("join_recursive_repartition", True, True,
              "hybrid join: re-hash an overflow partition whose build "
              "side alone exceeds the spill batch budget into salted "
              "sub-partitions (recursive destaging per arXiv 2112.02480) "
              "instead of streaming one oversized pass. Host-side "
              "partitioning decision only — compiled partition programs "
              "key on the resulting capacities, so this needs no trace "
              "channel (HOST_LOOP_KNOBS)")
config.define("enable_query_cache", False, True,
              "two-tier query result cache (starrocks_tpu/cache/): a "
              "full-result tier serving byte-identical repeats without "
              "touching the executor, keyed by (plan, per-table data "
              "version, config.trace_key()), plus a per-segment partial-"
              "aggregation tier for scan->filter->agg fragments over "
              "stored tables — after an append only NEW segments are "
              "scanned/aggregated (the reference's be/src/exec/query_cache "
              "multi-version delta reuse). off = bit-identical to the "
              "uncached engine",
              cache_key=True)
config.define("query_cache_capacity_mb", 256, True,
              "host memory budget for the query cache's LRU (full results "
              "+ per-segment partial-aggregation states share it; least-"
              "recently-used entries evict past the budget)",
              cache_key=True)
config.define("dist_fragments", True, True,
              "execute distributed plans as fragment-IR programs (one "
              "program per fragment over the shard tuple, explicit exchange "
              "edges) instead of one monolithic program (the A/B anchor)",
              trace=True)
config.define("cluster_fragment_retries", 2, True,
              "fragment re-placement budget when a cluster worker is lost "
              "mid-query (runtime/cluster_exec.py): each lost attempt "
              "re-schedules the SAME fragment on another ALIVE worker; "
              "exhaustion fails the query with WorkerLostError")
config.define("cluster_exec_timeout_s", 30.0, True,
              "per-fragment coordinator deadline on the cluster exchange "
              "plane: a worker that neither answers nor dies (network "
              "partition / blackholed socket) is declared lost for THIS "
              "fragment after this many seconds and the fragment re-places")
config.define("cluster_route_min_fragments", 2, True,
              "route a query to the cluster runtime only when its fragment "
              "IR has at least this many fragments; smaller plans run "
              "locally — the exchange plane's IPC cost only pays for "
              "itself on real exchanges")

# --- the query lifecycle and the point lane (slice 8) -------------------------
config.define("enable_short_circuit", True, True,
              "planner-free point-query lane: SELECT/UPDATE/DELETE "
              "statements whose WHERE pins every PRIMARY KEY column to "
              "literals (= / small IN lists) on stored PK tables run as a "
              "host-side pk-index probe -> delvec check -> direct row "
              "gather (runtime/point.py) — no optimizer, no device program. "
              "Admission-exempt but registered/killable/accounted via "
              "lifecycle.query_scope; records under its own 'point' "
              "statement class. off = every statement takes the full "
              "analytic path, identical results")
config.define("query_timeout_s", 0.0, True,
              "per-query deadline in seconds, enforced cooperatively at "
              "host-side stage boundaries (program attempts, batched/grace/"
              "spill iterations, segment-cache merges, scan loads) with "
              "QueryTimeoutError (runtime/lifecycle.py). 0 = off")
config.define("query_mem_limit_bytes", 0, True,
              "hard per-query cap on cumulative materialized-buffer bytes "
              "(device chunks, host partial states, spill tables) fed to "
              "the hierarchical memory accountant at stage boundaries; "
              "breach raises MemLimitExceeded naming the stage. 0 = off")
config.define("query_mem_soft_limit_bytes", 0, True,
              "soft per-query memory threshold: crossing it degrades "
              "gracefully (query-cache admission declined, spill batch "
              "capacity shrinks) instead of failing. 0 = off")
config.define("process_mem_limit_bytes", 0, True,
              "hard process-wide cap on accountant-tracked bytes across "
              "all running queries (the process-level MemTracker analog). "
              "0 = off")
config.define("plan_verify_level", "off", True,
              "off | warn | strict: static invariant verification of every "
              "optimized plan and freshly-built program "
              "(starrocks_tpu_torch/analysis/ — plan structure, the "
              "program's dispatch audit, cache-key completeness). warn logs "
              "findings and counts them in the query profile; strict fails "
              "the query on any error-severity finding")
config.define("plan_verify_trace", True, True,
              "audit the first run of every freshly-built program under a "
              "torch dispatch mode when plan_verify_level != off "
              "(analysis/trace_check.py: host callbacks, float32 widened "
              "to float64, oversized constants); the plan/key passes are "
              "always on at warn/strict")
config.load_env()

# The knob values that route the main path through the hand kernels: the
# segment-sum kernel for float sums, the sorted-build probe kernel for
# unique joins, the top-N kernel for packable ORDER BY .. LIMIT.
KERNEL_STRATEGIES = {"segment_strategy": "pallas",
                     "join_probe_strategy": "pallas_sorted",
                     "topn_strategy": "pallas"}
AUTO_STRATEGIES = {k: "auto" for k in KERNEL_STRATEGIES}
