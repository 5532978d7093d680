"""Query executor: optimized logical plan -> eager chunk program -> result.

Reference behavior: the coordinator + fragment execution pipeline
(fe qe/DefaultCoordinator.java:488 -> BE orchestration/fragment_executor.cpp).
A trimmed port of the JAX package's runtime/executor.py. The host loop
around the program implements

- device scan caching per (table, column) — scanned columns stay on the
  device across queries (the "storage page cache" analog);
- uncorrelated scalar-subquery evaluation;
- the adaptive capacity loop (`_adaptive`): a run whose overflow checks
  exceed their capacities is retried with larger ones, and the capacities
  that worked are kept per plan so a repeated query runs once;
- group_concat as a two-plan orchestration finished on the host
  (`_execute_group_concat`);
- the native filter-sum lane (`SET segment_strategy = 'native'`,
  `_try_native_scan_agg`): an ungrouped filter + integer sum over one
  table runs as one pass of a host C++ function (native.py);
- scan-level runtime filters on stored tables (`_scan_runtime_filters`):
  a probe scan whose join's build side bounds its keys loads only the
  files whose zonemaps may hold them (sql/scan_rf.py).

- the two-tier query cache (cache/): a full-result tier in front of the
  optimizer (`_execute_plain`) and a per-segment partial-aggregation tier
  over stored tables (`_try_partial_cache`);
- execution beyond device memory (`_try_batched`, runtime/batched.py):
  with `batch_rows_threshold` set, a scan-aggregation, a partitioned join,
  an ORDER BY or a window over a table past the threshold streams through
  the device in host batches;
- plan feedback (runtime/feedback.py): per-fingerprint observations feed
  the optimizer's join ordering, pre-seed cold program buckets
  (`_fb_seed`, `_fb_recorder`) and route the hybrid join's learned hot
  keys (`_fb_known_hot`).

`_run` tries the partial cache, then `_try_batched`, then the in-memory
program, in the reference's order. The program runs eagerly, so nothing is
compiled: a program bucket per (tag, plan) holds the capacities that last
worked (adopt-last) and, for the spill loops, their cached callables; every
overflow check of an attempt is read in ONE device-to-host copy.

Every query carries a RuntimeProfile (runtime/profile.py): phase timers
(optimize, fetch_results; per attempt compile_and_run, scan_to_device,
run), counters, one child per attempt and per spill executor, and the
per-operator records EXPLAIN ANALYZE renders — observed rows from the
capacity checks (`join_<ordinal>`, `agg_<ordinal>`, ...) and counter
groups from the `~ctr_<name>@<ordinal>` checks. Host stage boundaries call
`lifecycle.checkpoint`, so a KILL or a deadline lands between attempts,
and materialized buffers feed the memory accountant.
"""

from __future__ import annotations

import dataclasses
import decimal
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import lockdep
from .. import types as T
from ..column import Chunk, Field, HostTable, Schema, StringDict
from ..column.column import pad_capacity
from ..exprs.ir import AggExpr, Call, Case, Cast, Col, Expr, InList, Lit
from ..sql.analyzer import ScalarSubquery
from ..sql.logical import (
    LAggregate, LFilter, LJoin, LLimit, LProject, LScan, LSort, LWindow,
    LogicalPlan, walk_plan,
)
from ..sql.optimizer import _replace_children, expr_cols, optimize
from ..sql.physical import Caps, compile_plan
from . import lifecycle
from .config import config
from .failpoint import fail_point
from .metrics import (
    PROGRAM_COMPILES, QUERIES_TOTAL, QUERY_ERRORS, RECOMPILES, ROWS_RETURNED,
)
from .metrics import metrics
from .profile import RuntimeProfile
from .udf import registry_epoch, udf_seconds

COMPILE_MS = metrics.histogram(
    "sr_tpu_compile_ms",
    "milliseconds of building one attempt's eager program "
    "(sql/physical.compile_plan)")


class ExecError(RuntimeError):
    pass


def _device_profile(p: RuntimeProfile, devices, run):
    """`SET enable_device_profile`: run one attempt's program between two
    CUDA events and with the peak-memory gauges reset, and attach the
    attempt's device milliseconds and peak allocated bytes to its profile.
    `devices` are the cards the attempt runs on (a mesh's, home first):
    each is synchronised before the start and before the end event, so the
    time covers the work of every card, and each card's peak is reported
    (`device_memory` keeps the home card's, `device_memory_per_card`
    every card's). The reference attaches XLA's cost and memory analysis
    of the compiled program; an eager program has none, so the port
    records what the cards measured instead. On the CPU the facts do not
    apply and the profile says so."""
    cards = [d for d in devices if d.type == "cuda"]
    if not cards:
        p.set_info("device_profile", "not applicable: cpu tensors")
        return run()
    before = {}
    # lint: checkpoint-exempt — one synchronize per card of the mesh, around an attempt the lifecycle already checkpoints
    for d in cards:
        torch.cuda.synchronize(d)
        before[d] = torch.cuda.memory_allocated(d)
        torch.cuda.reset_peak_memory_stats(d)
    home = cards[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(home):
        start.record()
    out = run()
    # lint: checkpoint-exempt — one synchronize per card of the mesh, after the attempt's own checkpoints
    for d in cards[1:]:
        torch.cuda.synchronize(d)
    with torch.cuda.device(home):
        end.record()
    end.synchronize()
    p.set_info("device_time_ms", start.elapsed_time(end))
    per = {str(d): {
        "allocated_before_bytes": int(before[d]),
        "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(d)),
    } for d in cards}
    p.set_info("device_memory", per[str(home)])
    if len(cards) > 1:
        p.set_info("device_memory_per_card", per)
    return out


class DeviceCache:
    """Per-(table, column) device tensors + valid masks on one device (the
    page-cache analog), cached build-side sort orders, RF-pruned table
    snapshots, optimized plans, the program buckets (per (tag, plan): the
    last capacities that worked and the spill loops' cached callables), the
    two-tier query cache, the text -> analyzed-plan cache and the plan-
    feedback store. One per Session. Column entries key on their table's
    name first, so `invalidate(table)` drops exactly what a change to that
    table made stale."""

    MAX_CACHED_PLANS = 64

    def __init__(self, device):
        from ..cache.plan_cache import PlanCache
        from ..cache.query_cache import QueryCache
        from .feedback import FeedbackStore

        self.device = torch.device(device)
        # (table, column, tag) -> (data, valid|None)
        self._cols: dict = {}    # guarded_by: _lock
        # (table, tag) -> (capacity, sel|None)
        self._sel: dict = {}     # guarded_by: _lock
        # (table, key_cols, bit_widths) -> order
        self._border: dict = {}  # guarded_by: _lock
        # (table, tag, columns) -> (pruned handle, scan stats, tag)
        self._rfscan: dict = {}  # guarded_by: _lock
        # (table, tag) -> (row order, rows per shard) of a hash placement
        self._layouts: dict = {}  # guarded_by: _lock
        self._lock = lockdep.rlock("DeviceCache._lock")
        self.opt_plans: OrderedDict = OrderedDict()  # guarded_by: _lock
        # (key, udf epoch, knob values) -> {"last": caps, "progs": {}}
        self.programs: OrderedDict = OrderedDict()  # guarded_by: _lock
        self.qcache = QueryCache()
        self.plan_cache = PlanCache()
        self.feedback = FeedbackStore()

    # --- program buckets ----------------------------------------------------
    def program_bucket(self, key):
        """The bucket of one (tag, plan): a UDF create/replace/drop and
        every trace-declared knob (config.trace_key(): the knobs that shape
        the program) join the key, so such a SET never serves capacities
        or callables made under the old value."""
        key = (key, registry_epoch(), config.trace_key())
        with self._lock:
            b = self.programs.get(key)
            if b is None:
                b = self.programs[key] = {"last": None, "progs": {}}
                while len(self.programs) > self.MAX_CACHED_PLANS:
                    self.programs.popitem(last=False)
            else:
                self.programs.move_to_end(key)
            return b

    def bucket_adopt_last(self, bucket, caps):
        """Seed empty caps from the bucket's last successful capacities."""
        with self._lock:
            if not caps.values and bucket["last"]:
                caps.values.update(bucket["last"])

    def bucket_last_set(self, bucket, vals):
        with self._lock:
            bucket["last"] = dict(vals)

    def bucket_fresh(self, bucket) -> bool:
        """Whether no execution has published capacities into `bucket`."""
        with self._lock:
            return bucket["last"] is None

    def bucket_seed_last(self, bucket, vals) -> bool:
        """Pre-tighten a COLD bucket from plan-feedback capacities: set
        "last" only when no execution has published one yet (a live
        bucket's own observations always outrank the journal's). Returns
        whether the seed took."""
        with self._lock:
            if bucket["last"] is None and vals:
                bucket["last"] = dict(vals)
                return True
            return False

    def bucket_prog_get(self, bucket, key):
        with self._lock:
            return bucket["progs"].get(key)

    def bucket_prog_put(self, bucket, key, val):
        """Insert-if-absent; returns the entry that won (first writer)."""
        with self._lock:
            return bucket["progs"].setdefault(key, val)

    def opt_plan_lookup(self, key):
        with self._lock:
            opt = self.opt_plans.get(key)
            if opt is not None:
                self.opt_plans.move_to_end(key)
            return opt

    def opt_plan_store(self, key, opt):
        with self._lock:
            self.opt_plans[key] = opt
            while len(self.opt_plans) > self.MAX_CACHED_PLANS:
                self.opt_plans.popitem(last=False)

    def clear_plans(self):
        """Drop optimized plans and program buckets (an MV freshness flip, a
        UDF change: anything that re-shapes planning wholesale)."""
        with self._lock:
            self.opt_plans.clear()
            self.programs.clear()

    def invalidate(self, table: str):
        """Evict everything derived from `table`: its device columns,
        selection masks, build orders and RF-pruned snapshots, every
        optimized plan and program bucket whose plan scans it (plans bake
        stats-derived choices: dense-aggregation domains, LUT-join
        eligibility, packed bit widths, which new rows can outgrow), the
        full-result cache entries that observed it and the plan-feedback
        entries learned over it."""
        fail_point("devicecache::invalidate")

        def scans_table(key) -> bool:
            for part in key:
                if isinstance(part, tuple):  # nested keys
                    if scans_table(part):
                        return True
                elif isinstance(part, LogicalPlan):
                    if any(isinstance(node, LScan) and node.table == table
                           for node in walk_plan(part)):
                        return True
            return False

        with self._lock:
            for d in (self._cols, self._sel, self._border, self._rfscan,
                      self._layouts):
                for k in [k for k in d if k[0] == table]:
                    del d[k]
            for k in [k for k in self.opt_plans if scans_table((k[0],))]:
                del self.opt_plans[k]
            for k in [k for k in self.programs if scans_table(k)]:
                del self.programs[k]
        # per-segment partial states validate by file identity and survive
        # appends by design (cache/query_cache.py)
        self.qcache.invalidate_table(table)
        self.feedback.invalidate_table(table)

    def pruned_handle_for(self, handle, columns, bounds):
        """(handle, scan_stats, tag) for an RF-pruned snapshot of a stored
        table: loads only the files whose zonemaps may hold build keys
        (TabletStore.load_table's rf_predicate channel), wrapped in a fresh
        TableHandle so chunk_for and its column stats see the pruned
        subset. Cached per (table, bounds, columns); invalidation covers it
        (keys lead with the table name like every other cache entry)."""
        from ..sql.scan_rf import bounds_predicate
        from ..storage.catalog import TableHandle

        tag = "rf:" + ",".join(f"{c}[{lo},{hi}]" for c, lo, hi in bounds)
        key = (handle.name, tag, tuple(columns))
        with self._lock:
            e = self._rfscan.get(key)
        if e is None:
            # the file reads run outside the lock; the first writer wins
            ht, stats = handle.store.load_table(
                handle.name, columns=list(columns),
                rf_predicate=bounds_predicate(bounds), with_stats=True)
            ph = TableHandle(handle.name, ht, handle.unique_keys,
                             handle.distribution)
            with self._lock:
                e = self._rfscan.setdefault(key, (ph, dict(stats), tag))
        return e

    def chunk_for(self, handle, alias: str, columns, cache_tag=None,
                  placement=None):
        """Device chunk of the requested columns, renamed alias-qualified and
        padded to the 1024-aligned capacity; bounds from catalog stats ride
        on the fields (they drive the dense aggregation and packed sorts).
        `cache_tag` names the column-cache namespace (RF-pruned scans must
        not collide with the full table's entries); information_schema
        relations are rebuilt per read and never cached.

        `placement=(mesh, mode)` places the table on a mesh
        (parallel/mesh.py) and returns the shard tuple this process holds:
        "sharded" splits the rows in order into equal shards of
        pad_capacity(ceil(rows / n)); ("hash", col) puts the rows whose
        splitmix64 bucket of col is i on shard i (the device shuffle's
        recipe: colocate joins), each shard padded to the largest; the
        selection mask marks the real rows. Shard s lands on the mesh's
        `devices[s]`: each run of shards that share a device is copied
        there once and every shard is a view of its run (a one-device
        mesh: one copy of the full layout). "replicated" is one Chunk on
        the mesh's home device. The devices join the cache keys."""
        # scan-load stage boundary: cancellable, failpoint-injectable, and
        # the placed buffers feed the memory accountant below
        fail_point("scan::chunk_to_device")
        lifecycle.checkpoint("scan::chunk_to_device")
        ht = handle.table
        n = ht.num_rows
        dev = self.device
        cacheable = not handle.name.startswith("information_schema.")
        mesh, mode = placement if placement is not None else (None, None)
        reorder = per_shard = None
        n_shards = 1
        if mode is None:
            tag = cache_tag or "local"
            cap = pad_capacity(n)
        elif mode == "replicated":
            dev = mesh.device
            tag, cap = f"replicated@{dev}", pad_capacity(n)
        else:
            from ..parallel.mesh import hash_layout

            n_shards = mesh.n
            if isinstance(mode, tuple) and mode[0] == "hash":
                keycol = mode[1].split(".", 1)[-1]  # qualified -> base name
                tag = f"hash{n_shards}:{keycol}"
                lay = None
                if cacheable:
                    with self._lock:
                        lay = self._layouts.get((handle.name, tag))
                if lay is None:
                    lay = hash_layout(ht.arrays[keycol], n_shards)
                    if cacheable:
                        with self._lock:
                            lay = self._layouts.setdefault(
                                (handle.name, tag), lay)
                reorder, per_shard = lay
                cap = pad_capacity(int(per_shard.max()) if n else 1) * n_shards
            else:
                tag = f"sharded{n_shards}"
                cap = pad_capacity((n + n_shards - 1) // n_shards) * n_shards
        shard_cap = cap // n_shards
        # a multi-process mesh materializes only this process's shards
        local = tuple(mesh.local) if n_shards > 1 else (0,)
        lo_row, hi_row = local[0] * shard_cap, (local[-1] + 1) * shard_cap
        if n_shards > 1:
            from ..parallel.mesh import device_runs

            runs = device_runs(mesh.local_devices)
            tag += "@" + ",".join(f"{d}x{c}" for d, _, c in runs)
        else:
            runs = [(dev, 0, 1)]

        def layout(a, fill):
            """Host layout: padded (range mode) or bucket-slotted (hash
            mode), cut to this process's shards; rank-2 wide columns
            (ARRAY/DECIMAL128) row-wise."""
            tail = a.shape[1:]
            if reorder is not None:
                out = np.full((cap,) + tail, fill, dtype=a.dtype)
                srt = a[reorder]
                off = 0
                for b in range(n_shards):
                    cnt = int(per_shard[b])
                    out[b * shard_cap:b * shard_cap + cnt] = srt[off:off + cnt]
                    off += cnt
                a = out
            elif len(a) < cap:
                a = np.concatenate([a, np.full(
                    (cap - len(a),) + tail, fill, dtype=a.dtype)])
            return a[lo_row:hi_row]

        # one cache entry per run of shards on one device
        rtags = [tag] if len(runs) == 1 else [f"{tag}#{r}"
                                              for r in range(len(runs))]

        def put(h, r):
            """Run r's rows of the host layout `h`, on its device."""
            d, j0, c = runs[r]
            h = h[j0 * shard_cap:(j0 + c) * shard_cap]
            return torch.from_numpy(np.ascontiguousarray(h)).to(d)

        fields = []
        data = [[] for _ in runs]
        valid = [[] for _ in runs]
        for c in columns:
            hosts: list = []  # the column's host layouts, made at most once
            for r, rtag in enumerate(rtags):
                key = (handle.name, c, rtag)
                entry = None
                if cacheable:
                    with self._lock:
                        entry = self._cols.get(key)
                if entry is None:
                    # the copy to the device runs outside the lock; the
                    # first writer wins
                    if not hosts:
                        v = ht.valids.get(c)
                        hosts = [layout(ht.arrays[c], 0),
                                 None if v is None else layout(v, False)]
                    entry = (put(hosts[0], r),
                             None if hosts[1] is None else put(hosts[1], r))
                    if cacheable:
                        with self._lock:
                            entry = self._cols.setdefault(key, entry)
                data[r].append(entry[0])
                valid[r].append(entry[1])
            f = ht.schema.field(c)
            st = handle.column_stats(c)
            bounds = (
                (int(st.min), int(st.max))
                if st.min is not None and st.max is not None else None
            )
            fields.append(
                dataclasses.replace(f, name=f"{alias}.{c}", bounds=bounds))
        sels = []
        live = None
        for r, rtag in enumerate(rtags):
            skey = (handle.name, rtag)
            sentry = None
            if cacheable:
                with self._lock:
                    sentry = self._sel.get(skey)
            if sentry is None or sentry[0] != cap:
                if placement is None:
                    sel = None if n == cap else (
                        torch.arange(cap, device=dev) < n)
                else:
                    if live is None:
                        live = layout(np.ones(n, dtype=bool), False)
                    sel = put(live, r)
                sentry = (cap, sel)
                if cacheable:
                    with self._lock:
                        self._sel[skey] = sentry
            sels.append(sentry[1])
        schema = Schema(tuple(fields))
        if n_shards == 1:
            out = Chunk(schema, tuple(data[0]), tuple(valid[0]), sels[0], dev)
            lifecycle.account(out, "scan::chunk_to_device")
            return out

        shards = []
        for r, (d, _, cnt) in enumerate(runs):
            for j in range(cnt):
                a, b = j * shard_cap, (j + 1) * shard_cap
                shards.append(Chunk(
                    schema, tuple(x[a:b] for x in data[r]),
                    tuple(None if x is None else x[a:b] for x in valid[r]),
                    sels[r][a:b], d))
        out = tuple(shards)
        lifecycle.account(out, "scan::chunk_to_device")
        return out

    def build_order_for(self, handle, alias: str, key_cols, bit_widths):
        """Cached stable argsort of a scan's packed join keys: computed once
        per (table, keys, bit_widths) on the cached device columns; joins
        receive it as an extra input and skip the per-query build sort."""
        from ..ops.common import argsort_stable
        from ..ops.join import pack_keys

        key = (handle.name, tuple(key_cols), bit_widths)
        with self._lock:
            order = self._border.get(key)
        if order is None:
            chunk = self.chunk_for(handle, alias, tuple(key_cols))
            keys = tuple(Col(f"{alias}.{c}") for c in key_cols)
            bk, _ = pack_keys(chunk, keys, bit_widths)
            order = argsort_stable(bk)
            with self._lock:
                order = self._border.setdefault(key, order)
        return order


@dataclasses.dataclass
class QueryResult:
    table: HostTable
    plan: LogicalPlan
    profile: object = None

    def rows(self):
        return self.table.to_pylist()

    @property
    def column_names(self):
        return [f.name for f in self.table.schema]


class _BucketProgs:
    """Dict-like view over one program bucket's cached callables (the
    batched/grace/hybrid/spill loops get-or-create entries through it);
    every insert is one fresh program build."""

    def __init__(self, cache: DeviceCache, bucket):
        self._cache = cache
        self._bucket = bucket

    def __contains__(self, key):
        return self._cache.bucket_prog_get(self._bucket, key) is not None

    def __getitem__(self, key):
        val = self._cache.bucket_prog_get(self._bucket, key)
        if val is None:
            raise KeyError(key)
        return val

    def __setitem__(self, key, val):
        PROGRAM_COMPILES.inc()
        self._cache.bucket_prog_put(self._bucket, key, val)


def read_checks(checks: dict) -> dict:
    """{key: int} of an attempt's checks with ONE device-to-host copy: the
    0-d tensors are stacked on the device and copied together (checks from
    other cards first join the first check's device)."""
    out = {k: int(v) for k, v in checks.items()
           if not isinstance(v, torch.Tensor)}
    keys = [k for k, v in checks.items() if isinstance(v, torch.Tensor)]
    if keys:
        dev = checks[keys[0]].device
        stacked = torch.stack([checks[k].reshape(()).to(torch.int64).to(dev)
                               for k in keys])
        out.update(zip(keys, stacked.cpu().tolist()))
    return out


def _config_key() -> tuple:
    """Every knob's current value: optimized plans and capacities key on it
    (a SET must not serve a plan made under the old value)."""
    return tuple((name, value) for name, value, *_ in config.items())


class Executor:
    def __init__(self, catalog, device_cache: DeviceCache):
        self.catalog = catalog
        self.cache = device_cache
        # plan-feedback context of the query being executed ({fp, entry,
        # tables, seeded} or None) — set by _execute_plain_uncached after
        # subquery resolution, consumed by the _fb_* glue below
        self._fb_ctx = None

    def execute_logical(self, plan: LogicalPlan,
                        profile: RuntimeProfile | None = None) -> QueryResult:
        profile = profile or RuntimeProfile("query")
        self._refresh_external(plan)
        if config.get("segment_strategy") == "native":
            res = self._try_native_scan_agg(plan, profile)
            if res is not None:
                return res
        gc = _extract_group_concat(plan)
        if gc is not None:
            return self._execute_group_concat(plan, gc, profile)
        return self._execute_plain(plan, profile)

    def _refresh_external(self, plan: LogicalPlan):
        """An external table whose files changed since its data was read
        drops that data, and its data epoch moves: the device columns,
        plans and cached results derived from it go with it."""
        from ..sql.optimizer import plan_tables
        from ..storage.external import ExternalTableHandle

        for t in plan_tables(plan):
            h = self.catalog.get_table(t)
            if isinstance(h, ExternalTableHandle) and h.stale():
                h.invalidate()
                self.catalog.bump_data_epoch(t)

    def _try_native_scan_agg(self, plan: LogicalPlan,
                             profile: RuntimeProfile):
        """`SET segment_strategy='native'`: the scan-agg shape
        Project?(Agg(Filter(Scan))) with one ungrouped non-distinct
        sum(a*b | a) under a conjunctive compare of integer columns with
        integer literals runs as ONE pass of the host C++ function
        (native.fused_filter_sum_i64) over the catalog's host columns.
        Any other shape, non-integer types or NULLs return None and the
        regular path runs unchanged; a failed build of the library
        raises."""
        from .. import native

        node = plan
        renames = None
        if isinstance(node, LProject):
            renames = node.exprs
            node = node.child
        if (not isinstance(node, LAggregate) or node.group_by
                or len(node.aggs) != 1
                or not isinstance(node.child, LFilter)
                or not isinstance(node.child.child, LScan)):
            return None
        agg_name, agg = node.aggs[0]
        out_name = agg_name
        if renames is not None:
            if len(renames) != 1:
                return None
            out_name, e = renames[0]
            if not (isinstance(e, Col) and e.name == agg_name):
                return None
        if (not isinstance(agg, AggExpr) or agg.fn != "sum"
                or agg.distinct or agg.extra or agg.arg is None):
            return None
        scan = node.child.child
        handle = self.catalog.tables.get(scan.table)
        if handle is None:
            return None
        prefix = scan.alias + "."

        def base_col(e):
            if isinstance(e, Col) and e.name.startswith(prefix):
                return e.name[len(prefix):]
            return None

        if isinstance(agg.arg, Call) and agg.arg.fn == "multiply" \
                and len(agg.arg.args) == 2:
            a_col = base_col(agg.arg.args[0])
            b_col = base_col(agg.arg.args[1])
            if a_col is None or b_col is None:
                return None
        else:
            a_col, b_col = base_col(agg.arg), None
            if a_col is None:
                return None
        terms: list = []

        def flat(e) -> bool:
            if isinstance(e, Call) and e.fn == "and":
                return all(flat(x) for x in e.args)
            if (isinstance(e, Call) and e.fn in native.FS_OPS
                    and len(e.args) == 2):
                c = base_col(e.args[0])
                lit = e.args[1]
                if (c is not None and isinstance(lit, Lit)
                        and isinstance(lit.value, int)
                        and not isinstance(lit.value, bool)):
                    terms.append((c, e.fn, lit.value))
                    return True
            return False

        if not flat(node.child.predicate) or not terms:
            return None
        ht = handle.table
        need = {c for c, _, _ in terms} | {a_col} | (
            {b_col} if b_col else set())
        for c in need:
            try:
                f = ht.schema.field(c)
            except KeyError:
                return None
            if not f.type.is_integer:
                return None
            v = ht.valids.get(c)
            if v is not None and not v.all():
                return None  # NULL compare/sum semantics: regular path
        t0 = time.perf_counter()
        total, cnt = native.fused_filter_sum_i64(
            [ht.arrays[c] for c, _, _ in terms],
            [native.FS_OPS[op] for _, op, _ in terms],
            [v for _, _, v in terms],
            ht.arrays[a_col],
            ht.arrays[b_col] if b_col else None,
        )
        out = HostTable.from_pydict(
            {out_name: [total if cnt else None]}, types={out_name: T.BIGINT})
        profile.add_counter("native_fused_rows", int(ht.num_rows))
        profile.set_info("native_fused", "filter_sum")
        profile.add_counter("native", time.perf_counter() - t0, "s")
        lifecycle.account(out, "native::fused_agg")
        return QueryResult(out, plan, profile)

    def _execute_plain(self, plan: LogicalPlan,
                       profile: RuntimeProfile | None = None) -> QueryResult:
        """Full-result cache gate around the real execution path: a
        validated hit returns the materialized table without touching the
        optimizer or the device; a cacheable miss executes and stores the
        result keyed by (plan, trace knobs, opt knobs, udf epoch) with the
        per-table data versions it observed. With enable_query_cache off
        this is one boolean check."""
        profile = profile or RuntimeProfile("query")
        if not config.get("enable_query_cache"):
            return self._execute_plain_uncached(plan, profile)
        from ..cache import keys as cache_keys
        from ..sql.optimizer import plan_tables, plan_uncacheable_reason

        reason = plan_uncacheable_reason(plan)
        if reason is not None:
            profile.set_info("qcache_uncacheable", reason)
            return self._execute_plain_uncached(plan, profile)
        skey = cache_keys.full_result_key(plan)
        hit = self.cache.qcache.lookup_result(skey, self.catalog)
        if hit is not None:
            QUERIES_TOTAL.inc()
            profile.add_counter("qcache_hits", 1)
            return QueryResult(hit.table, hit.plan, profile)
        profile.add_counter("qcache_misses", 1)
        with config.record_reads() as reads:
            res = self._execute_plain_uncached(plan, profile)
        ctx = lifecycle.current()
        if ctx is not None and ctx.degraded:
            # soft-mem degradation: decline cache admission
            profile.set_info("qcache_declined", "mem-soft-degraded")
            return res
        if not self._verify_cache_reads(reads, profile):
            return res  # a knob outside every key channel: not cached
        tables = plan_tables(plan) | plan_tables(res.plan)
        versions = cache_keys.version_map(self.catalog, tables)
        self.cache.qcache.store_result(skey, res.table, res.plan, versions)
        return res

    def _execute_plain_uncached(self, plan: LogicalPlan,
                                profile: RuntimeProfile) -> QueryResult:
        QUERIES_TOTAL.inc()
        try:
            fail_point("optimizer::before_optimize")
            lifecycle.checkpoint("optimizer::before_optimize")
            with profile.timer("optimize"):
                fb_fp = fb_entry = None
                if config.get("plan_feedback"):
                    from .feedback import plan_fingerprint

                    with config.record_reads() as fb_reads:
                        fb_fp = plan_fingerprint(plan)
                        fb_entry = self.cache.feedback.consult(
                            fb_fp, self.catalog)
                    self._verify_feedback_reads(fb_reads, profile)
                # a UDF create/replace/drop must not serve a plan made
                # before it
                opt_key = (plan, _config_key(), registry_epoch())
                if fb_entry is not None:
                    # fresh observations must never serve the previously
                    # learned plan: the entry's consult token extends the
                    # key (a fixpoint once observations stop changing)
                    opt_key += (fb_entry["token"],)
                    profile.add_counter("feedback_hits", 1)
                opt = self.cache.opt_plan_lookup(opt_key)
                if opt is None:
                    with config.record_reads() as opt_reads:
                        opt = optimize(plan, self.catalog, fb_entry)
                    self._verify_opt_reads(opt_reads, profile)
                    self.cache.opt_plan_store(opt_key, opt)
                analyzed = plan
                # subquery resolution executes data-dependent sub-plans —
                # never cached
                plan = self._resolve_scalar_subqueries(opt)
            self._verify_plan(plan, profile)
            # record-side feedback context — set AFTER subquery resolution
            # (nested sub-plan executions run through this same executor
            # and must not leave their context on the outer query)
            if fb_fp is not None:
                from ..sql.optimizer import plan_tables

                self._fb_ctx = {
                    "fp": fb_fp, "entry": fb_entry, "seeded": set(),
                    "tables": plan_tables(analyzed) | plan_tables(plan),
                }
            else:
                self._fb_ctx = None
            # sentinel coordinates on the query context (same placement as
            # _fb_ctx: the OUTER query's assignment lands last) — the
            # terminal hook keys its latency baseline to the consult token
            # and reaches the store for quarantine/readmit
            ctx = lifecycle.current()
            if ctx is not None and fb_fp is not None:
                ctx.fb_fp = fb_fp
                ctx.fb_token = (None if fb_entry is None
                                else fb_entry["token"])
                ctx.fb_store = self.cache.feedback
            udf0 = udf_seconds()
            out_chunk = self._run(plan, profile)
            if udf_seconds() > udf0:
                profile.add_counter("udf", udf_seconds() - udf0, "s")
            fail_point("executor::fetch_results")
            lifecycle.checkpoint("executor::fetch_results")
            with profile.timer("fetch_results"):
                # spilled sorts and windows return host-materialized results
                ht = (out_chunk if isinstance(out_chunk, HostTable)
                      else HostTable.from_chunk(out_chunk))
                ht = _prettify_names(ht)
            lifecycle.account(ht, "executor::fetch_results")
            ROWS_RETURNED.inc(ht.num_rows)
            # deliberately AFTER the last checkpoint: a kill landing here
            # finds a completed query (the documented KILL-race no-op)
            fail_point("executor::result_ready")
            return QueryResult(ht, plan, profile)
        except Exception:
            QUERY_ERRORS.inc()
            raise

    # --- static verification hooks (analysis/) ------------------------------
    def _verify_plan(self, plan, profile):
        """Per-query structural verification of the optimized plan (behind
        SET plan_verify_level; see analysis/)."""
        from ..analysis import run_plan_checks, verify_level

        if verify_level() == "off":
            return
        run_plan_checks(plan, self.catalog, profile)

    def _verify_opt_reads(self, reads, profile):
        """Optimized-plan cache-key completeness: knobs read during
        optimize() must be part of the optimized-plan key."""
        from ..analysis import report, verify_level
        from ..analysis.key_check import check_opt_reads

        if verify_level() == "off":
            return
        report(check_opt_reads(reads), profile, where="optimize")

    def _verify_feedback_reads(self, reads, profile):
        """Feedback-consult cache-key completeness: a knob read while
        consulting must sit on a declared key channel, or two configs
        could share one learned plan."""
        from ..analysis import report, verify_level
        from ..analysis.key_check import check_feedback_reads

        if verify_level() == "off":
            return
        report(check_feedback_reads(reads), profile, where="feedback")

    def _verify_cache_reads(self, reads, profile) -> bool:
        """Result-key completeness of an execution whose result enters the
        query cache: False (decline to cache) on any finding."""
        from ..analysis import report, verify_level
        from ..analysis.key_check import check_cache_reads

        if verify_level() == "off":
            return True
        findings = check_cache_reads(reads)
        report(findings, profile, where="qcache")
        return not findings

    def _verify_compile(self, run, profile, mesh=None):
        """A freshly-built program's first run, verified: `run()` returns
        (out, checks) of the raw program; the knob reads of its build and
        run must be keyed (key_check), and under `plan_verify_trace` the
        run goes through the dispatch audit (analysis/trace_check.py:
        implicit float64 promotion, counters that are not the full-mesh
        sum). `run` is the window: call this with the build inside it."""
        from ..analysis import report, verify_level
        from ..analysis.key_check import check_trace_reads

        if verify_level() == "off":
            return run()
        findings = []
        with config.record_reads() as reads:
            if config.get("plan_verify_trace"):
                from ..analysis import trace_check

                out, found = trace_check.audit_program(
                    run, checks_of=lambda r: r[1], mesh=mesh)
                findings += found
            else:
                out = run()
        findings = check_trace_reads(reads) + findings
        report(findings, profile, where="compile")
        return out

    # --- group_concat orchestration -----------------------------------------
    def _execute_group_concat(self, plan, gc, profile):
        """Two-plan execution for group_concat (see _extract_group_concat):
        main plan with min() placeholders + a (keys, args) side plan, joined
        on the host by group-key values."""
        agg, gcs = gc
        plan_a, gc_vis = group_concat_main_plan(plan, gc)
        res = self._execute_plain(plan_a, profile)
        ht = res.table

        # side plan: (keys..., arg per gc, order-by exprs per gc) straight
        # off the agg input
        items = tuple(
            (f"__k{i}", e) for i, (_, e) in enumerate(agg.group_by)
        ) + tuple(
            (f"__a{j}", a.arg) for j, (_, a) in enumerate(gcs)
        )
        order_specs = []  # per gc: [(col_offset, asc), ...]
        for j, (_, a) in enumerate(gcs):
            spec = []
            for m, item in enumerate(a.extra[1:]):
                expr, asc = item[0], item[1]
                spec.append((len(items), asc))
                items = items + ((f"__o{j}_{m}", expr),)
            order_specs.append(spec)
        side = self._execute_plain(LProject(agg.child, items))
        srows = side.table.to_pylist()
        nk = len(agg.group_by)
        per_gc = [dict() for _ in gcs]
        for row in srows:
            key = tuple(row[:nk])
            for j in range(len(gcs)):
                v = row[nk + j]
                if v is None:
                    continue
                okey = tuple(row[pos] for pos, _ in order_specs[j])
                per_gc[j].setdefault(key, []).append((okey, v))

        def fmt(v):
            if isinstance(v, bool):
                return str(int(v))
            if isinstance(v, float):
                return repr(v)
            return str(v)

        concat = []
        for j, (_, a) in enumerate(gcs):
            sep = ","
            if a.extra and isinstance(a.extra[0], Lit) \
                    and a.extra[0].value is not None:
                sep = str(a.extra[0].value)
            spec = order_specs[j]
            m = {}
            for key, pairs in per_gc[j].items():
                if spec:
                    # explicit ORDER BY: stable multi-pass sort; NULL order
                    # keys always sort last (second stable pass per key)
                    for idx in range(len(spec) - 1, -1, -1):
                        _, asc = spec[idx]
                        pairs = sorted(
                            pairs,
                            key=lambda p, i=idx: (
                                (isinstance(p[0][i], str), p[0][i])
                                if p[0][i] is not None else (False, 0)),
                            reverse=not asc)
                        # NULL placement follows the engine's ORDER BY
                        # default: last on ASC, first on DESC
                        pairs = sorted(
                            pairs,
                            key=lambda p, i=idx, a=asc: (
                                (p[0][i] is None) == a))
                    vals = [v for _, v in pairs]
                else:
                    vals = sorted((v for _, v in pairs),
                                  key=lambda x: (isinstance(x, str), x))
                if a.distinct:
                    vals = list(dict.fromkeys(vals))
                m[key] = sep.join(fmt(v) for v in vals)
            concat.append(m)

        # patch the result: replace gc columns, drop hidden key columns
        cols = ht.to_pylist()
        names = [f.name for f in ht.schema]
        # positions: the hidden key columns where the root had a
        # projection; otherwise the agg output's keys come first
        if any(n.startswith("__gck_") for n in names):
            key_pos = [names.index(f"__gck_{i}") for i in range(nk)]
        else:
            key_pos = list(range(nk))
        keep = [i for i, n in enumerate(names) if not n.startswith("__gck_")]
        gc_by_final = {}
        for j, (n, _) in enumerate(gcs):
            vis = gc_vis.get(n)
            if vis is None:
                continue  # concat column dropped by a projection
            for i, on in enumerate(names):
                if on == vis or on.split(".")[-1] == vis.split(".")[-1]:
                    gc_by_final[i] = j
                    break
        fields, arrays, valids = [], {}, {}
        for i in keep:
            f = ht.schema.fields[i]
            if i in gc_by_final:
                m = concat[gc_by_final[i]]
                vals = [m.get(tuple(r[p] for p in key_pos)) for r in cols]
                nulls = np.array([v is None for v in vals], dtype=bool)
                d, codes = StringDict.from_strings(
                    ["" if v is None else str(v) for v in vals])
                fields.append(Field(f.name, T.VARCHAR, True, d))
                arrays[f.name] = codes
                if nulls.any():
                    valids[f.name] = ~nulls
            else:
                fields.append(f)
                arrays[f.name] = ht.arrays[f.name]
                if f.name in ht.valids:
                    valids[f.name] = ht.valids[f.name]
        table = HostTable(Schema(tuple(fields)), arrays, valids)
        return QueryResult(table, plan, res.profile)

    def _resolve_scalar_subqueries(self, plan: LogicalPlan) -> LogicalPlan:
        def fix_expr(e: Expr) -> Expr:
            if isinstance(e, ScalarSubquery):
                if e.correlated:
                    raise ExecError(
                        "correlated scalar subquery not rewritten by optimizer"
                    )
                fail_point("executor::subquery_resolve")
                lifecycle.checkpoint("executor::subquery_resolve")
                sub = self.execute_logical(e.plan)
                ht = sub.table
                rows = ht.to_pylist()
                if len(rows) > 1 or (rows and len(rows[0]) != 1):
                    raise ExecError("scalar subquery returned more than one value")
                val = rows[0][0] if rows else None
                f = ht.schema.fields[0]
                if val is not None and f.type.is_decimal:
                    # embed the EXACT scaled value with its decimal type
                    raw = int(np.asarray(ht.arrays[f.name])[0])
                    return Lit(decimal.Decimal(raw).scaleb(-f.type.scale),
                               f.type)
                return Lit(val)
            if isinstance(e, Call):
                return Call(e.fn, *[fix_expr(a) for a in e.args])
            if isinstance(e, Case):
                return Case(
                    tuple((fix_expr(c), fix_expr(v)) for c, v in e.whens),
                    fix_expr(e.orelse) if e.orelse is not None else None,
                )
            if isinstance(e, Cast):
                return Cast(fix_expr(e.arg), e.to)
            if isinstance(e, InList):
                return InList(fix_expr(e.arg), e.values, e.negated)
            if isinstance(e, AggExpr):
                return AggExpr(
                    e.fn, fix_expr(e.arg) if e.arg is not None else None,
                    e.distinct,
                    tuple(fix_expr(x) if isinstance(x, Expr) else x
                          for x in e.extra),
                )
            return e

        def rec(p: LogicalPlan) -> LogicalPlan:
            if isinstance(p, LFilter):
                return LFilter(rec(p.child), fix_expr(p.predicate))
            if isinstance(p, LProject):
                return LProject(rec(p.child),
                                tuple((n, fix_expr(e)) for n, e in p.exprs))
            if isinstance(p, LJoin):
                cond = fix_expr(p.condition) if p.condition is not None else None
                return LJoin(rec(p.left), rec(p.right), p.kind, cond)
            if isinstance(p, LAggregate):
                return LAggregate(
                    rec(p.child),
                    tuple((n, fix_expr(e)) for n, e in p.group_by),
                    tuple((n, fix_expr(a)) for n, a in p.aggs),
                )
            if isinstance(p, LSort):
                return LSort(
                    rec(p.child),
                    tuple((fix_expr(e), a, nf) for e, a, nf in p.keys),
                    p.limit,
                )
            if isinstance(p, LLimit):
                return LLimit(rec(p.child), p.limit, p.offset)
            if isinstance(p, LWindow):
                return LWindow(
                    rec(p.child),
                    tuple(fix_expr(x) for x in p.partition_by),
                    tuple((fix_expr(e), a, nf) for e, a, nf in p.order_by),
                    tuple(
                        (n, fn, fix_expr(a) if a is not None else None, *rest)
                        for n, fn, a, *rest in p.funcs
                    ),
                    p.limit,
                )
            return _replace_children(p, tuple(rec(c) for c in p.children))

        return rec(plan)

    # --- plan-feedback glue (runtime/feedback.py) -----------------------------
    def _fb_seed(self, tag: str, plan):
        """Pre-tighten a cold program bucket from learned capacities: the
        first execution of a repeat shape after a restart adopts the
        previous process's tightened caps and burns zero adaptive retries.
        A bucket that already published its own "last" outranks the
        journal."""
        ctx = self._fb_ctx
        if ctx is None or ctx["entry"] is None:
            return
        vals = ctx["entry"].get("caps", {}).get(tag)
        if vals and self.cache.bucket_seed_last(
                self.cache.program_bucket((tag, plan)), vals):
            ctx["seeded"].add(tag)

    def _fb_recorder(self, tag: str, profile, node_ord_box=None,
                     extra_fn=None):
        """on_success callback for _adaptive: records this execution's
        observations (tightened caps, retries burned, observed join
        cardinalities when the run exposed node ordinals, and whatever
        `extra_fn` contributes — the hybrid join's heavy hitters and
        partition outcomes) under the query's plan fingerprint."""
        ctx = self._fb_ctx
        if ctx is None:
            return None

        def record(caps_vals, keyed_checks, attempts):
            from .feedback import (
                FEEDBACK_RECOMPILES_AVOIDED, FEEDBACK_RETRIES_AVOIDED,
            )

            entry = ctx["entry"]
            if attempts == 0 and tag in ctx["seeded"] and entry is not None:
                saved = int(entry.get("attempts", {}).get(tag, 0))
                if saved:
                    FEEDBACK_RETRIES_AVOIDED.inc(saved)
                    FEEDBACK_RECOMPILES_AVOIDED.inc(saved)
                    profile.add_counter("feedback_retries_avoided", saved)
            cards = self._fb_cards(
                (node_ord_box or {}).get("node_ord"), dict(keyed_checks))
            kwargs = extra_fn() if extra_fn is not None else {}
            self.cache.feedback.record(
                ctx["fp"], self.catalog, ctx["tables"], tag, caps_vals,
                attempts, cards=cards, **kwargs)

        return record

    def _fb_known_hot(self, gp):
        """Learned build-side heavy-hitter keys for a hybrid join's build
        column (hybrid_partitions re-verifies their counts against the live
        build before broadcasting)."""
        ctx = self._fb_ctx
        if ctx is None or ctx["entry"] is None:
            return None
        col = f"{gp.right_scan.table}.{gp.build_key}"
        pairs = ctx["entry"].get("build_hot", {}).get(col)
        if not pairs:
            return None
        return [int(k) for k, _ in pairs]

    def _fb_cards(self, node_ord, checks) -> dict | None:
        """Observed join cardinalities keyed by the subtree's scanset
        (sql/optimizer.join_scanset_key): the `join_{ordinal}` overflow
        totals of the surviving attempt, mapped back through the program's
        node-ordinal table."""
        if not node_ord:
            return None
        from ..sql.optimizer import estimate_rows, join_scanset_key
        from .feedback import FEEDBACK_EST_ERRSUM, FEEDBACK_EST_JOINS

        # a join whose two inputs scan the same table:alias (copies of one
        # CTE, as TPC-DS q47's v1, v1_lag and v1_lead) makes the scanset
        # key ambiguous: one copy's observed rows would stand for the
        # copies joined together, and the next run's DP joins two copies
        # first (reference defect, ROADMAP). Such a query records no cards.
        for node in node_ord:
            if isinstance(node, LJoin) and set(
                    join_scanset_key(node.left).split("|")) & set(
                    join_scanset_key(node.right).split("|")) - {""}:
                return None
        cards: dict = {}
        for node, o in node_ord.items():
            if not (isinstance(node, LJoin)
                    and node.kind in ("inner", "cross", "left")):
                continue  # semi/anti totals count the inner EXPANSION
            total = checks.get(f"join_{o}")
            if total is None:
                continue
            key = join_scanset_key(node)
            if not key:
                continue
            cards[key] = float(int(total))
            try:
                est = float(estimate_rows(node, self.catalog))
            except Exception:  # noqa: BLE001 — stats must never fail a query
                continue
            FEEDBACK_EST_ERRSUM.inc(
                abs(est - float(total)) / max(float(total), 1.0))
            FEEDBACK_EST_JOINS.inc()
        return cards or None

    # --- execution with adaptive retries ------------------------------------
    def _adaptive(self, profile: RuntimeProfile, attempt_fn, publish=None,
                  on_success=None) -> Chunk:
        """The reference's overflow-retry loop. attempt_fn(caps, p) ->
        (chunk, {check key: int}), `p` the attempt's child profile
        (`attempt_<i>`); a check above its capacity raises that
        capacity (extrapolating the growth rate between attempts) and the
        plan runs again. After a success, grossly over-seeded capacities
        tighten; `publish(caps_values)` then stores them as the bucket's
        "last", and `on_success(caps_values, keyed_checks, attempts)` (the
        plan-feedback recorder) fires once."""
        caps = Caps({})
        max_recompiles = config.get("max_recompiles")
        headroom = config.get("join_expand_headroom")
        fail_point("executor::before_run")
        prev_counts: dict = {}
        for attempt in range(max_recompiles):
            lifecycle.checkpoint("executor::attempt")
            p = profile.child(f"attempt_{attempt}")
            with p.timer("compile_and_run"):
                out, checked = attempt_fn(caps, p)
            # post-attempt boundary: a deadline that expired during this
            # attempt fails the query HERE, before the next dispatch
            lifecycle.checkpoint("executor::after_attempt")
            lifecycle.account(out, "executor::attempt")
            p.set_info("capacities", dict(caps.values))
            floors = {k[len("~floor_"):]: v for k, v in checked.items()
                      if k.startswith("~floor_")}
            ctrs = {k: v for k, v in checked.items() if k.startswith("~ctr_")}
            keyed = {k: v for k, v in checked.items()
                     if not k.startswith(("~floor_", "~ctr_"))}
            overflow = False
            for key, v in keyed.items():
                if v > caps.values.get(key, -1):
                    pv = prev_counts.get(key)
                    rate = min(max(1.0, v / pv), 8.0) if pv else 1.0
                    base_cap = pad_capacity(int(v * headroom) + 1)
                    if base_cap >= (1 << 31):
                        raise ExecError(
                            f"operator {key} needs capacity {v} rows — the "
                            "plan is likely missing a join predicate "
                            "(cartesian blowup)"
                        )
                    caps.values[key] = min(
                        pad_capacity(int(v * headroom * rate) + 1), 1 << 30)
                    overflow = True
            prev_counts.update(keyed)
            if not overflow:
                profile.add_counter("recompiles", attempt)
                for k, v in ctrs.items():  # the surviving attempt's only
                    base, _, o = k[len("~ctr_"):].partition("@")
                    profile.add_counter(base, int(v))
                    if o.isdigit():
                        # ordinal-suffixed device counters feed the per-
                        # operator counter groups EXPLAIN ANALYZE renders
                        profile.op_counter(int(o), base, int(v))
                # the surviving attempt's capacity-check totals ARE the
                # per-operator observed rows (join_/agg_/wtop_/unnest_
                # keys carry the plan ordinal)
                for key, v in keyed.items():
                    fam, _, o = key.rpartition("_")
                    if fam and o.isdigit():
                        profile.op_rows(int(o), fam, int(v),
                                        caps.values.get(key))
                for key, v in keyed.items():
                    if key.startswith("agg_") and key not in floors:
                        continue
                    tight = max(pad_capacity(int(v * headroom) + 1),
                                floors.get(key, 0))
                    if tight * 2 <= caps.values.get(key, 0):
                        caps.values[key] = tight
                if publish is not None:
                    publish(caps.values)
                if on_success is not None:
                    on_success(dict(caps.values), list(keyed.items()),
                               attempt)
                return out
            RECOMPILES.inc()
            fail_point("executor::before_recompile")
        raise ExecError(
            f"capacity did not converge after {max_recompiles} recompiles")

    def _scan_runtime_filters(self, plan, profile) -> dict:
        """Two-phase scan pruning, phase 2 glue: resolve host-evaluated
        build key bounds (sql/scan_rf.py) into RF-pruned table snapshots
        and report `rf_segments_pruned`. {(table, alias): (handle, tag)}."""
        if not (config.get("enable_runtime_filters")
                and config.get("runtime_filter_strategy") != "off"
                and config.get("enable_zonemap_pruning")):
            return {}
        from ..sql.scan_rf import compute_scan_prune

        try:
            prune_map = compute_scan_prune(plan, self.catalog)
        except Exception:  # noqa: BLE001 — stats must never fail a query
            return {}
        scan_rf: dict = {}
        rf_segs = 0
        for (t, a), (cols, bounds) in prune_map.items():
            handle = self.catalog.get_table(t)
            if handle is None:
                continue
            ph, stats, tag = self.cache.pruned_handle_for(handle, cols, bounds)
            scan_rf[(t, a)] = (ph, tag)
            rf_segs += stats.get("rf_pruned", 0)
        if scan_rf:
            profile.add_counter("rf_segments_pruned", rf_segs)
        return scan_rf

    def _run(self, plan: LogicalPlan, profile: RuntimeProfile) -> Chunk:
        out = self._try_partial_cache(plan, profile)
        if out is not None:
            return out
        batch_threshold = config.get("batch_rows_threshold")
        if batch_threshold:
            out = self._try_batched(plan, profile, batch_threshold)
            if out is not None:
                return out

        scan_rf = self._scan_runtime_filters(plan, profile)
        self._fb_seed("local", plan)
        bucket = self.cache.program_bucket(("local", plan))
        trace_box: dict = {}

        def scan_input(t, a, cols):
            rf = scan_rf.get((t, a))
            if rf is not None:
                ph, tag = rf
                return self.cache.chunk_for(ph, a, cols, cache_tag=tag)
            return self.cache.chunk_for(self.catalog.get_table(t), a, cols)

        # a plan this bucket has never run builds a fresh program: its
        # first attempt is the one the static passes verify
        fresh = {"pending": self.cache.bucket_fresh(bucket)}

        def attempt(caps, p):
            # adopt-last: a repeated query starts at the capacities that
            # worked (and usually runs once)
            self.cache.bucket_adopt_last(bucket, caps)
            # the eager program is built here, where the reference compiles
            fail_point("executor::before_compile")
            lifecycle.checkpoint("executor::before_compile")

            def build_and_run():
                t0 = time.perf_counter()
                compiled = compile_plan(plan, self.catalog, caps)
                COMPILE_MS.observe((time.perf_counter() - t0) * 1000.0)
                trace_box["node_ord"] = compiled.node_ord
                with p.timer("scan_to_device"):
                    inputs = [scan_input(t, a, cols)
                              for t, a, cols in compiled.scans]
                    for table, a, key_cols, bw in compiled.aux:
                        inputs.append(self.cache.build_order_for(
                            self.catalog.get_table(table), a, key_cols, bw))
                fail_point("executor::before_dispatch")
                lifecycle.checkpoint("executor::before_dispatch")

                def run():
                    out, checks = compiled.fn(tuple(inputs))
                    # the attempt's only sync
                    return out, checks, read_checks(checks)

                with p.timer("run"):
                    return self._profiled(p, run)

            if fresh["pending"]:
                fresh["pending"] = False
                out, _, checked = self._verify_compile(build_and_run, p)
            else:
                out, _, checked = build_and_run()
            self.cache.bucket_last_set(bucket, caps.values)
            return out, checked

        def publish(vals):
            self.cache.bucket_last_set(bucket, vals)

        out = self._adaptive(profile, attempt, publish,
                             self._fb_recorder("local", profile, trace_box))
        self._bind_operators(profile, trace_box.get("node_ord"))
        return out

    def _profiled(self, p, run):
        """`run()` under `SET enable_device_profile` (the attempt's CUDA
        events and peak bytes on its profile), or plainly."""
        if config.get("enable_device_profile"):
            return _device_profile(p, self.profile_devices(), run)
        return run()

    @property
    def home_device(self):
        """Where this executor's results live (a mesh's home card)."""
        return self.cache.device

    def profile_devices(self) -> tuple:
        """The devices an attempt runs on, home first."""
        from ..parallel.mesh import indexed_device

        return (indexed_device(self.cache.device),)

    @staticmethod
    def _bind_operators(profile, node_ord):
        """Publish the executed program's node-ordinal table on the
        profile: EXPLAIN ANALYZE joins it against the per-ordinal operator
        records _adaptive collected (observed rows, counter groups)."""
        if node_ord:
            profile.node_ord = dict(node_ord)

    def _try_partial_cache(self, plan, profile: RuntimeProfile):
        """Per-segment partial-aggregation tier (cache/partial.py): for a
        cacheable scan->filter->agg fragment over a STORED table, aggregate
        each manifest segment on its own and reuse cached partial states —
        after an append only NEW segments scan. None = not a match."""
        if not config.get("enable_query_cache"):
            return None
        from ..cache.partial import try_partial_cached

        return try_partial_cached(self, plan, profile)

    def _try_batched(self, plan, profile, batch_threshold):
        """Streaming through the device in host batches (the spill analog)
        for scan-aggregations, partitioned joins, ORDER BY and windows over
        a table past `batch_rows_threshold`. Rides the shared _adaptive
        loop and caches each plan's callables in its program bucket."""
        from .batched import (
            execute_batched, execute_grace_join, execute_hybrid_join,
            execute_spill_sort, execute_spill_window, grace_partitions,
            hybrid_partitions, match_batchable, match_grace_join,
            match_spill_sort, match_spill_window, profile_node,
        )

        dev = self.cache.device
        bp = match_batchable(plan)
        batch_rows = config.get("spill_batch_rows") or batch_threshold
        if bp is None:
            # spilled ORDER BY: device keys, host global order (a beyond-
            # memory sort returns a HostTable)
            sp = match_spill_sort(plan)
            if sp is not None:
                h = self.catalog.get_table(sp.scan.table)
                if h is not None and h.row_count > batch_threshold:
                    bucket = self.cache.program_bucket(("spillsort", plan))
                    return execute_spill_sort(
                        sp, self.catalog, batch_rows,
                        _BucketProgs(self.cache, bucket),
                        profile_node(profile, "spill_sort"), dev)
            # spilled WINDOW: partitions hash-split to batch-sized groups
            wp = match_spill_window(plan)
            if wp is not None:
                h = self.catalog.get_table(wp.scan.table)
                if h is not None and any(
                        np.asarray(h.table.arrays[c]).ndim != 1
                        for c in wp.hash_cols):
                    wp = None  # wide keys (DECIMAL128/ARRAY): device path
            if wp is not None:
                h = self.catalog.get_table(wp.scan.table)
                if h is not None and h.row_count > batch_threshold:
                    bucket = self.cache.program_bucket(("spillwin", plan))
                    return execute_spill_window(
                        wp, self.catalog, batch_rows,
                        _BucketProgs(self.cache, bucket),
                        profile_node(profile, "spill_window"), dev)
            # partitioned join: both sides host-routed by the join key when
            # either exceeds the threshold. `join_hybrid_strategy` picks the
            # executor: auto = skew-aware hybrid, grace = the all-or-nothing
            # partition loop
            gp = match_grace_join(plan, self.catalog)
            if gp is None:
                return None
            lh = self.catalog.get_table(gp.left_scan.table)
            rh = self.catalog.get_table(gp.right_scan.table)
            if lh is None or rh is None or max(
                lh.row_count, rh.row_count
            ) <= batch_threshold:
                return None
            if config.get("join_hybrid_strategy") == "grace":
                tag = "grace"
                node = profile_node(profile, tag)
                self._fb_seed(tag, plan)
                bucket = self.cache.program_bucket((tag, plan))
                parts = grace_partitions(gp, self.catalog, batch_rows, node)
                runner = execute_grace_join
                extra_fn = None
            else:
                tag = "hybrid"
                node = profile_node(profile, tag)
                self._fb_seed(tag, plan)
                bucket = self.cache.program_bucket((tag, plan))
                parts = hybrid_partitions(
                    gp, self.catalog, batch_rows,
                    known_hot=self._fb_known_hot(gp), node=node)
                runner = execute_hybrid_join

                def extra_fn():
                    # heavy hitters + partition outcomes learned at
                    # partition time, keyed by base table.column
                    probe_col = f"{gp.left_scan.table}.{gp.probe_key}"
                    build_col = f"{gp.right_scan.table}.{gp.build_key}"
                    out = {"parts": {
                        "n_parts": parts.n_parts,
                        "resident": parts.resident_parts,
                        "spilled": len(parts.spilled),
                        "sub_parts": parts.sub_parts,
                        "oversized": parts.oversized_passes,
                    }}
                    if parts.probe_hot:
                        out["probe_hot"] = {
                            probe_col: [[int(k), int(c)]
                                        for k, c in parts.probe_hot]}
                    if parts.build_hot:
                        out["build_hot"] = {
                            build_col: [[int(k), int(c)]
                                        for k, c in parts.build_hot]}
                    return out

            def attempt(caps, p):
                # adopt-last: cached partition programs return checks for
                # capacity keys that only exist in the caps they ran with
                self.cache.bucket_adopt_last(bucket, caps)
                out, checks = runner(
                    gp, self.catalog, caps, node, parts,
                    _BucketProgs(self.cache, bucket), self)
                self.cache.bucket_last_set(bucket, caps.values)
                return out, checks

            def publish(vals):
                self.cache.bucket_last_set(bucket, vals)

            return self._adaptive(profile, attempt, publish,
                                  self._fb_recorder(tag, profile,
                                                    extra_fn=extra_fn))
        handle = self.catalog.get_table(bp.scan.table)
        if handle is None or handle.row_count <= batch_threshold:
            return None
        self._fb_seed("batched", plan)
        b_bucket = self.cache.program_bucket(("batched", plan))
        prog_cache = _BucketProgs(self.cache, b_bucket)
        node = profile_node(profile, "batched")

        def attempt(caps, p):
            # adopt-last: repeated (or feedback-seeded) spilled aggregations
            # start at the tightened group capacity
            self.cache.bucket_adopt_last(b_bucket, caps)
            return execute_batched(bp, self.catalog, caps, node, batch_rows,
                                   prog_cache, dev)

        def publish(vals):
            self.cache.bucket_last_set(b_bucket, vals)

        return self._adaptive(profile, attempt, publish,
                              self._fb_recorder("batched", profile))


def _extract_group_concat(plan: LogicalPlan):
    """Find a root-reachable LAggregate carrying group_concat aggregates.

    group_concat builds data-dependent strings, which the dictionary design
    cannot express on the device (output dictionaries would depend on
    values). The executor therefore runs it as a TWO-PLAN orchestration
    (same pattern as uncorrelated scalar subqueries): the main plan computes
    every other aggregate with a placeholder in the group_concat slot, a
    side plan fetches (group keys, arg) rows, and the host joins the
    per-group concatenations into the final result. Reference behavior:
    be/src/exprs/agg/group_concat.h (engine-side state strings).

    Returns (agg_node, [(name, AggExpr)]) or None. Only aggregates reachable
    through Project/Sort/Limit/Filter chains are eligible; group_concat
    anywhere else (subquery under a join, HAVING on the concat itself)
    raises ExecError."""
    hits = []
    for node in walk_plan(plan):
        if isinstance(node, LAggregate):
            gcs = [(n, a) for n, a in node.aggs if a.fn == "group_concat"]
            if gcs:
                hits.append((node, gcs))
    if not hits:
        return None
    if len(hits) > 1:
        raise ExecError("multiple group_concat aggregations in one query")
    agg, gcs = hits[0]
    # eligibility: the agg must sit under a pure chain from the root, and no
    # expression above it may CONSUME the concat column beyond Col
    # passthrough. Renames ARE passthroughs, so track the concat column's
    # visible names level by level (bottom-up).
    chain = []
    node = plan
    while node is not agg:
        if not isinstance(node, (LSort, LFilter, LProject, LLimit, LWindow)):
            raise ExecError(
                "group_concat is only supported in the query's top "
                "aggregation block")
        chain.append(node)
        node = node.child
    visible = {n for n, _ in gcs}
    for node in reversed(chain):  # agg side first
        if isinstance(node, (LSort, LFilter, LWindow)):
            if isinstance(node, LSort):
                exprs = [k for k, _, _ in node.keys]
            elif isinstance(node, LFilter):
                exprs = [node.predicate]
            else:
                exprs = list(node.partition_by) + [
                    k for k, _, _ in node.order_by
                ] + [a for _, _, a, *_ in node.funcs if a is not None]
            for e in exprs:
                if _expr_cols_safe(e) & visible:
                    raise ExecError(
                        "group_concat result cannot be referenced by "
                        "ORDER BY/HAVING/window expressions "
                        "(host-finalized aggregate)")
        elif isinstance(node, LProject):
            nxt = set()
            for n, e in node.exprs:
                if isinstance(e, Col) and e.name in visible:
                    nxt.add(n)
                elif _expr_cols_safe(e) & visible:
                    raise ExecError(
                        "group_concat result cannot be used inside "
                        "expressions (host-finalized aggregate)")
            visible = nxt
    return agg, gcs


def group_concat_main_plan(plan, gc):
    """The MAIN plan of the group_concat two-plan orchestration: the
    aggregate re-emitted with min() placeholders in each group_concat slot
    (min over the arg is well-typed and cheap; the host overwrites the
    column), and hidden group-key passthroughs appended to every projection
    above it so the final output still carries the join keys.

    Returns (plan_a, gc_vis) where gc_vis maps each group_concat output
    name to its visible column name at the root."""
    agg, gcs = gc
    new_aggs = tuple(
        (n, AggExpr("min", a.arg) if a.fn == "group_concat" else a)
        for n, a in agg.aggs
    )
    agg_a = LAggregate(agg.child, agg.group_by, new_aggs)
    key_names = [n for n, _ in agg.group_by]

    def rebuild(node):
        """Returns (new_node, key_map, gc_map): key_map tracks each
        group key's visible column name at this level (hidden
        passthroughs are appended to every projection); gc_map tracks
        each group_concat output's visible name through renames."""
        if node is agg:
            return agg_a, {k: k for k in key_names}, {n: n for n, _ in gcs}
        child, key_map, gc_map = rebuild(node.child)
        if isinstance(node, LProject):
            items = list(node.exprs)
            new_gc = {}
            for n, e in node.exprs:
                if isinstance(e, Col):
                    for g, vis in gc_map.items():
                        if e.name == vis:
                            new_gc[g] = n
            new_key = {}
            for i, k in enumerate(key_names):
                hid = f"__gck_{i}"
                items.append((hid, Col(key_map[k])))
                new_key[k] = hid
            return LProject(child, tuple(items)), new_key, new_gc
        return dataclasses.replace(node, child=child), key_map, gc_map

    plan_a, _key_map, gc_vis = rebuild(plan)
    return plan_a, gc_vis


def _expr_cols_safe(e):
    try:
        return expr_cols(e)
    except Exception:  # noqa: BLE001 — an unknown expression shape: no cols
        return set()


def _prettify_names(ht: HostTable) -> HostTable:
    """Strip alias qualifiers from output names where unambiguous."""
    base = [f.name.split(".", 1)[-1] for f in ht.schema]
    if len(set(base)) != len(base):
        return ht
    fields = tuple(
        dataclasses.replace(f, name=b) for f, b in zip(ht.schema.fields, base)
    )
    arrays = {b: ht.arrays[f.name] for f, b in zip(ht.schema.fields, base)}
    valids = {
        b: ht.valids[f.name]
        for f, b in zip(ht.schema.fields, base)
        if f.name in ht.valids
    }
    return HostTable(Schema(fields), arrays, valids)
