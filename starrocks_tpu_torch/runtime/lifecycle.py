"""Query lifecycle manager: cancellation, deadlines, memory accounting.

Reference behavior: the FE/BE query lifecycle plane —
- `KILL <query>` / `query_timeout` cancellation that unwinds fragments and
  releases admission slots (fe qe/ConnectContext.java kill handling,
  be exec_env fragment cancellation);
- per-query MemTrackers in a process -> resource-group -> query hierarchy
  with soft-limit spill triggers and hard-limit query failure
  (be/src/base/mem_tracker.h);
- SHOW PROCESSLIST / information_schema surfaces over the running set.

TPU-first re-design: a query here is a host loop around a handful of
compiled-program dispatches (attempt loop, batched/grace/spill iterations,
segment-cache merges, scan loads). A dispatched XLA program is not
interruptible, so cancellation is COOPERATIVE: every host-side stage
boundary calls `checkpoint(stage)`, which raises `QueryCancelledError` /
`QueryTimeoutError` when a kill landed or the deadline passed. That bounds
kill latency to one stage, which is exactly the granularity the engine
has. The same boundaries feed the `MemoryAccountant` with REAL
materialized-buffer sizes (device chunks, host partial states, spill
tables), replacing estimate-only admission as the enforcement point.

Unwind contract: `query_scope` is the single entry/exit gate. On ANY exit
path (success, kill, timeout, mem-limit, engine error) it runs the
context's cleanup stack (admission-slot release and anything else
registered via `on_exit`), releases every byte the accountant charged,
and deregisters the query — so a killed/failed query leaves the session
immediately reusable and the accountant snapshot identical to before.
tests/test_chaos.py asserts this for every failure class.

With defaults (`query_timeout_s=0`, mem limits 0, nothing armed) every
checkpoint is a few attribute reads and the engine's behavior is
byte-identical to a build without this module.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

from .. import lockdep
from .metrics import metrics

QUERIES_CANCELLED = metrics.counter(
    "sr_tpu_queries_cancelled_total", "queries killed via KILL/cancel")
QUERIES_TIMEOUT = metrics.counter(
    "sr_tpu_queries_timeout_total", "queries failed by query_timeout_s")
MEMLIMIT_TOTAL = metrics.counter(
    "sr_tpu_mem_limit_exceeded_total",
    "queries failed by a hard memory limit")
MEM_DEGRADED = metrics.counter(
    "sr_tpu_mem_soft_degraded_total",
    "queries that crossed the soft memory limit and degraded")

# Per-statement-class latency distributions (the audit-log latency view,
# scrape-side): classes are keyed off the leading keyword, matching the
# serving tier's read/exclusive split plus a DDL bucket.
LATENCY_READ_MS = metrics.histogram(
    "sr_tpu_query_latency_ms_read",
    "wall milliseconds of read statements (SELECT/SHOW/EXPLAIN/...)")
LATENCY_DML_MS = metrics.histogram(
    "sr_tpu_query_latency_ms_dml",
    "wall milliseconds of DML statements (INSERT/UPDATE/DELETE/LOAD)")
LATENCY_DDL_MS = metrics.histogram(
    "sr_tpu_query_latency_ms_ddl",
    "wall milliseconds of DDL statements (CREATE/DROP/ALTER/TRUNCATE)")
LATENCY_OTHER_MS = metrics.histogram(
    "sr_tpu_query_latency_ms_other",
    "wall milliseconds of statements outside the read/dml/ddl classes")
LATENCY_POINT_MS = metrics.histogram(
    "sr_tpu_point_latency_ms",
    "wall milliseconds of short-circuit point statements (the planner/"
    "compiler-free PK-lookup lane; its context sets stmt_class='point')")
LATENCY_LOAD_MS = metrics.histogram(
    "sr_tpu_query_latency_ms_load",
    "wall milliseconds of ingest-plane loads (stream/routine micro-batch "
    "loads, stage->commit-visible; their contexts set stmt_class='load')")

_DML_HEADS = frozenset(("insert", "update", "delete", "load"))
_DDL_HEADS = frozenset(("create", "drop", "alter", "truncate", "refresh"))
_READ_HEADS = frozenset(("select", "with", "values", "show", "explain",
                         "describe", "desc"))


def statement_class(sql: str) -> str:
    head = sql.lstrip().split(None, 1)
    kw = head[0].lower().rstrip("(") if head else ""
    if kw in _READ_HEADS:
        return "read"
    if kw in _DML_HEADS:
        return "dml"
    if kw in _DDL_HEADS:
        return "ddl"
    return "other"


def observe_query_latency(sql: str, ms: float, cls: str | None = None):
    """Record one finished top-level statement into its class histogram
    (Session.sql's unwind calls this on every exit path). `cls` overrides
    the text-keyword class — the point lane records under 'point' even
    though its text says SELECT/UPDATE/DELETE."""
    {"read": LATENCY_READ_MS, "dml": LATENCY_DML_MS,
     "ddl": LATENCY_DDL_MS, "other": LATENCY_OTHER_MS,
     "point": LATENCY_POINT_MS, "load": LATENCY_LOAD_MS}[
        cls or statement_class(sql)].observe(float(ms))


class QueryAbortError(RuntimeError):
    """Base of the lifecycle's typed query errors."""


class QueryCancelledError(QueryAbortError):
    """Raised at the first checkpoint after a KILL landed."""


class QueryTimeoutError(QueryAbortError):
    """Raised at the first checkpoint past the query's deadline."""


class MemLimitExceeded(QueryAbortError):
    """Raised by the accountant when a hard limit breaks; the message
    names the offending stage."""


class QueryContext:
    """One query's lifecycle state. Created by `query_scope`; reached from
    stage boundaries via the thread-local `current()`."""

    def __init__(self, sql: str, user: str = "root", group: str | None = None,
                 group_limit: int = 0):
        from .config import config

        self.qid: int = 0  # assigned by the registry
        self.sql = sql
        self.user = user
        self.group = group
        self.group_limit = int(group_limit or 0)
        self.state = "running"
        self.t0 = time.monotonic()
        self.timeout_s = float(config.get("query_timeout_s") or 0.0)
        self.deadline = self.t0 + self.timeout_s if self.timeout_s > 0 else None
        # limits are CAPTURED here (outside any knob-read-set recording
        # window) so checkpoints/accounting never read config mid-execution
        # — a config.get inside the executor's record_reads window would
        # register as a cache-key escapee (analysis/key_check.py)
        self.mem_limit = int(config.get("query_mem_limit_bytes") or 0)
        self.mem_soft_limit = int(
            config.get("query_mem_soft_limit_bytes") or 0)
        self.process_limit = int(config.get("process_mem_limit_bytes") or 0)
        self.mem_bytes = 0          # cumulative charged bytes (this query)
        # high-water mark of mem_bytes, maintained by the accountant's
        # charge (release_query zeroes mem_bytes BEFORE the unwind's
        # observability hook runs, so the audit row needs its own peak)
        self.mem_peak = 0
        # referenced base tables (sorted, unioned across nested
        # statements) — set by the session/point lanes for the audit row
        self.tables: tuple = ()
        self.degraded = False       # soft limit crossed: degrade gracefully
        self.degrade_reason = None
        self.last_stage = "start"
        self.queue_wait_ms = 0.0    # admission-lane wait (workgroup.py)
        # the query's RuntimeProfile, stashed by Session._query so the
        # ProfileManager can retain it on EVERY exit path — a killed or
        # failed query's profile reports the stage it died at
        self.profile = None
        self.rows = 0               # result rows (set by the session)
        # latency-histogram class override: the short-circuit point lane
        # sets "point" so its latencies never skew the read/dml classes
        self.stmt_class = None
        # terminal error text (set by the query_scope handlers); the
        # audit record carries it — exception objects don't survive the
        # unwind into the observability hook
        self.error = ""
        self._cancel_reason = None
        self._cleanups: list = []   # run LIFO on scope exit, every path

    # --- cooperative cancellation --------------------------------------------
    def cancel(self, reason: str = "killed") -> bool:
        """Request cancellation (any thread). Cooperative: the query dies at
        its NEXT checkpoint; a query already past its last checkpoint
        completes normally and the kill is a documented no-op."""
        if self.state != "running":
            return False
        self._cancel_reason = reason
        return True

    def cancelled(self) -> bool:
        """True once a kill has been requested (it lands at the next
        checkpoint; queued statements are reaped by their waiter)."""
        return self._cancel_reason is not None

    def cancel_reason(self):
        return self._cancel_reason

    def nudge(self, reason: str) -> bool:
        """Soft-degrade hint (any thread): same graceful-degradation path a
        crossed soft memory limit takes — cache admission declines, spill
        batches shrink — but triggered by admission back-pressure
        (workgroup.py preemption hints). Never kills. True when the hint
        was freshly delivered."""
        if self.state != "running" or self.degraded:
            return False
        self.degraded = True
        self.degrade_reason = reason
        return True

    def check(self, stage: str):
        """The stage-boundary checkpoint: raise if killed or past deadline."""
        self.last_stage = stage
        if self._cancel_reason is not None:
            raise QueryCancelledError(
                f"query {self.qid} cancelled at stage {stage!r}: "
                f"{self._cancel_reason}")
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryTimeoutError(
                f"query {self.qid} exceeded query_timeout_s="
                f"{self.timeout_s:g} at stage {stage!r}")

    # --- unwind registration --------------------------------------------------
    def on_exit(self, fn):
        """Register a cleanup to run on ANY exit path (LIFO). Cleanups must
        be idempotent — belt-and-braces callers may also release inline."""
        self._cleanups.append(fn)

    def run_cleanups(self):
        while self._cleanups:
            fn = self._cleanups.pop()
            try:
                fn()
            except Exception:  # noqa: BLE001  # lint: swallow-ok — unwind
                pass           # must finish; one failing cleanup must not
                               # leak the rest

    def elapsed_ms(self) -> int:
        return int((time.monotonic() - self.t0) * 1000)


class QueryRegistry:
    """Process-wide running-query registry (the SHOW PROCESSLIST surface;
    sessions of every front door share it, so a KILL from one connection
    reaches a query running on another)."""

    def __init__(self):
        self._lock = lockdep.lock("QueryRegistry._lock")
        self._ids = itertools.count(1)   # guarded_by: _lock
        self._running: dict = {}         # guarded_by: _lock
        # documented no-op visibility (tests): cross-thread shared state —
        # a KILL lands from any connection's thread — so it lives under
        # the registry lock like the running set it describes
        self.last_kill_result = None     # guarded_by: _lock

    def register(self, ctx: QueryContext) -> QueryContext:
        with self._lock:
            ctx.qid = next(self._ids)
            self._running[ctx.qid] = ctx
        return ctx

    def deregister(self, ctx: QueryContext):
        with self._lock:
            self._running.pop(ctx.qid, None)

    def get(self, qid: int):
        with self._lock:
            return self._running.get(qid)

    def cancel(self, qid: int, requester: str | None = None,
               admin: bool = True, reason: str | None = None) -> bool:
        """Deliver a kill. False = the query is not running (finished,
        never existed) — the documented no-op. Non-admin requesters may
        only kill their own queries."""
        ctx = self.get(int(qid))
        if ctx is None:
            with self._lock:
                self.last_kill_result = "not-running"
            return False
        if requester is not None and not admin and ctx.user != requester:
            raise PermissionError(
                f"user {requester!r} cannot kill query {qid} owned by "
                f"{ctx.user!r}")
        ok = ctx.cancel(reason or f"KILL QUERY {qid}"
                        + (f" by {requester!r}" if requester else ""))
        with self._lock:
            self.last_kill_result = "delivered" if ok else "not-running"
        return ok

    def kill_result(self):
        """Read `last_kill_result` under the lock (tests; SHOW surfaces)."""
        with self._lock:
            return self.last_kill_result

    def snapshot(self) -> list:
        """[(qid, user, state, elapsed_ms, group, mem_bytes, stage, sql)]"""
        with self._lock:
            ctxs = list(self._running.values())
        return [
            (c.qid, c.user, c.state, c.elapsed_ms(), c.group or "",
             c.mem_bytes, c.last_stage, c.sql[:512])
            for c in sorted(ctxs, key=lambda c: c.qid)
        ]


try:
    _PAGE_SIZE = int(os.sysconf("SC_PAGE_SIZE"))
except (ValueError, OSError, AttributeError):
    _PAGE_SIZE = 4096


def _read_statm_rss() -> int:
    """Resident-set bytes of this process from /proc/self/statm (field 2,
    in pages). 0 when the proc surface is unavailable (non-Linux)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return 0


class MemoryAccountant:
    """Hierarchical (process -> resource group -> query) memory accounting
    fed by real materialized-buffer sizes at stage boundaries. Charges are
    cumulative per query and released wholesale when the query's scope
    exits — so a before/after snapshot balancing to zero proves no leak.

    The PROCESS ceiling additionally consults a real RSS probe
    (/proc/self/statm, cached for RSS_PROBE_INTERVAL_S): boundary-fed
    estimates only see buffers the engine materializes, while the
    interpreter, jax runtime, and compile arenas also occupy the process —
    `process_mem_limit_bytes` enforces against whichever is larger. The
    reader is injectable for tests."""

    RSS_PROBE_INTERVAL_S = 0.25

    def __init__(self, rss_reader=None):
        self._lock = lockdep.lock("MemoryAccountant._lock")
        self.process_bytes = 0        # guarded_by: _lock
        self.group_bytes: dict = {}   # guarded_by: _lock
        self._rss_reader = rss_reader or _read_statm_rss
        self._rss_at = 0.0            # guarded_by: _lock
        self._rss_val = 0             # guarded_by: _lock

    def rss_bytes(self) -> int:
        """Probed process RSS, cached for RSS_PROBE_INTERVAL_S so charge()
        checkpoints stay a few attribute reads between probes."""
        now = time.monotonic()
        with self._lock:
            if now - self._rss_at >= self.RSS_PROBE_INTERVAL_S:
                self._rss_at = now
                self._rss_val = int(self._rss_reader() or 0)
            return self._rss_val

    def charge(self, ctx: QueryContext, nbytes: int, stage: str):
        if nbytes <= 0 or ctx.state != "running":
            return
        with self._lock:
            ctx.mem_bytes += nbytes
            if ctx.mem_bytes > ctx.mem_peak:
                ctx.mem_peak = ctx.mem_bytes
            self.process_bytes += nbytes
            if ctx.group:
                self.group_bytes[ctx.group] = (
                    self.group_bytes.get(ctx.group, 0) + nbytes)
            group_used = self.group_bytes.get(ctx.group, 0) if ctx.group else 0
            process_used = self.process_bytes
        # enforcement outside the lock: the charge is already recorded, so
        # the scope-exit release keeps the books balanced even on raise
        if ctx.mem_limit and ctx.mem_bytes > ctx.mem_limit:
            MEMLIMIT_TOTAL.inc()
            raise MemLimitExceeded(
                f"query {ctx.qid} exceeded query_mem_limit_bytes="
                f"{ctx.mem_limit} at stage {stage!r} "
                f"({ctx.mem_bytes} bytes materialized)")
        if ctx.group_limit and group_used > ctx.group_limit:
            MEMLIMIT_TOTAL.inc()
            raise MemLimitExceeded(
                f"query {ctx.qid} pushed resource group {ctx.group!r} over "
                f"mem_limit_bytes={ctx.group_limit} at stage {stage!r} "
                f"({group_used} bytes across the group)")
        if ctx.process_limit:
            # the ceiling enforces against max(accounted, probed RSS):
            # estimates alone miss interpreter/jax/compile-arena residency
            # (NEXT 7c — the real-RSS wiring)
            rss = self.rss_bytes()
            if max(process_used, rss) > ctx.process_limit:
                MEMLIMIT_TOTAL.inc()
                raise MemLimitExceeded(
                    f"query {ctx.qid} pushed the process over "
                    f"process_mem_limit_bytes={ctx.process_limit} at stage "
                    f"{stage!r} ({process_used} bytes accounted, "
                    f"{rss} bytes RSS)")
        if (ctx.mem_soft_limit and not ctx.degraded
                and ctx.mem_bytes > ctx.mem_soft_limit):
            ctx.degraded = True
            ctx.degrade_reason = (
                f"soft limit {ctx.mem_soft_limit} crossed at {stage!r}")
            MEM_DEGRADED.inc()
            from . import events

            events.emit("soft_mem_degrade", qid=ctx.qid, stage=stage,
                        soft_limit=ctx.mem_soft_limit)

    def release_query(self, ctx: QueryContext):
        with self._lock:
            n = ctx.mem_bytes
            ctx.mem_bytes = 0
            self.process_bytes -= n
            if ctx.group and ctx.group in self.group_bytes:
                self.group_bytes[ctx.group] -= n
                if self.group_bytes[ctx.group] <= 0:
                    del self.group_bytes[ctx.group]

    def snapshot(self) -> dict:
        with self._lock:
            return {"process_bytes": self.process_bytes,
                    "group_bytes": dict(self.group_bytes)}


REGISTRY = QueryRegistry()
ACCOUNTANT = MemoryAccountant()

_tls = threading.local()


def current() -> QueryContext | None:
    """The thread's active query context (None outside a query scope)."""
    return getattr(_tls, "ctx", None)


def checkpoint(stage: str):
    """Stage-boundary hook: no-op without an active context or with
    nothing armed; raises the typed lifecycle errors otherwise."""
    ctx = current()
    if ctx is not None:
        ctx.check(stage)


def _nbytes(obj) -> int:
    """Estimated bytes of a materialized buffer: a torch tensor or numpy
    array, a device Chunk (data and validity tensors), a HostTable (arrays
    and valid masks), or a tuple/list of those."""
    n = getattr(obj, "nbytes", None)
    if n is not None:
        return int(n)
    total = 0
    arrays = getattr(obj, "arrays", None)  # HostTable
    if isinstance(arrays, dict):
        for a in arrays.values():
            total += int(getattr(a, "nbytes", 0) or 0)
        valids = getattr(obj, "valids", None)
        if isinstance(valids, dict):
            for v in valids.values():
                total += int(getattr(v, "nbytes", 0) or 0)
        return total
    data = getattr(obj, "data", None)  # Chunk
    if isinstance(data, tuple):
        for a in data:
            total += int(getattr(a, "nbytes", 0) or 0)
        for v in getattr(obj, "valid", ()) or ():
            total += int(getattr(v, "nbytes", 0) or 0)
        sel = getattr(obj, "sel", None)
        total += int(getattr(sel, "nbytes", 0) or 0)
        return total
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(x) for x in obj)
    return 0


def account(obj, stage: str):
    """Charge the active query for a materialized buffer (no-op outside a
    scope). Raises MemLimitExceeded on hard-limit breach."""
    ctx = current()
    if ctx is None:
        return
    from .failpoint import fail_point

    fail_point("lifecycle::account")  # an injected fault here unwinds the
    #   statement exactly like a hard-limit breach would (scope exit
    #   releases every prior charge wholesale)
    n = _nbytes(obj)
    if n:
        ACCOUNTANT.charge(ctx, n, stage)


def _finalize_observability(ctx: QueryContext):
    """Terminal-state observability, run exactly once by the owning scope
    on every exit path: retain the profile (ProfileManager — killed and
    failed queries keep their last stage) and feed the per-class latency
    histogram. Must never mask the query's own outcome."""
    try:
        from .profile import PROFILE_MANAGER

        PROFILE_MANAGER.register(
            qid=ctx.qid, user=ctx.user, sql=ctx.sql, state=ctx.state,
            ms=ctx.elapsed_ms(), rows=ctx.rows,
            queue_wait_ms=ctx.queue_wait_ms, stage=ctx.last_stage,
            profile=ctx.profile)
        observe_query_latency(ctx.sql, ctx.elapsed_ms(),
                              getattr(ctx, "stmt_class", None))
        from .audit import AUDIT

        # same contract as the profile: EVERY terminal state (done,
        # error, cancelled, timeout, memlimit, reaped-while-queued)
        # leaves exactly one audit record
        AUDIT.record_query(ctx)
        from .workload import WORKLOAD

        # the derived layer rides the same hook: workload shapes fold
        # every terminal record, the sentinel weighs successful runs
        # against their fingerprint's latency baseline
        WORKLOAD.record_query(ctx)
        from .sentinel import SENTINEL

        SENTINEL.observe(ctx)
    except Exception:  # noqa: BLE001  # lint: swallow-ok — observability must never fail the unwind
        pass


def finalize_queued(ctx: QueryContext):
    """Unwind a pre-registered context whose statement was removed from
    the pool queue by a KILL before any worker adopted it: same terminal
    bookkeeping as a cancelled query_scope exit (state, counter, cleanup
    stack, accountant, registry), run by the waiting connection thread."""
    ctx.state = "cancelled"
    ctx.error = str(ctx.cancel_reason() or "killed while queued")
    QUERIES_CANCELLED.inc()
    ctx.run_cleanups()
    ACCOUNTANT.release_query(ctx)
    REGISTRY.deregister(ctx)
    _finalize_observability(ctx)


def degraded() -> bool:
    """True when the active query crossed its soft memory limit: callers
    degrade gracefully (decline cache admission, shrink batch capacity)."""
    ctx = current()
    return ctx is not None and ctx.degraded


@contextlib.contextmanager
def query_scope(sql: str, user: str = "root", group: str | None = None,
                group_limit: int = 0, ctx: QueryContext | None = None):
    """Enter a query lifecycle scope. Re-entrant: nested statements (MV
    refresh bodies, INSERT..SELECT subqueries) ride the outer query's
    context — its deadline and kill cover the whole statement tree.

    `ctx` adopts a context the serving tier pre-registered at pool
    ENQUEUE (stage serve::queued): the statement was already killable
    while waiting for a worker, and its queue wait counts against the
    deadline. A kill that landed while queued raises at entry, before
    any engine code runs."""
    outer = current()
    if outer is not None:
        yield outer
        return
    adopted = ctx is not None
    if not adopted:
        ctx = REGISTRY.register(QueryContext(sql, user, group, group_limit))
    _tls.ctx = ctx
    try:
        if adopted:
            ctx.check("serve::start")
        yield ctx
        if ctx.state == "running":
            ctx.state = "done"
    except QueryCancelledError as e:
        ctx.state = "cancelled"
        ctx.error = str(e)
        QUERIES_CANCELLED.inc()
        raise
    except QueryTimeoutError as e:
        ctx.state = "timeout"
        ctx.error = str(e)
        QUERIES_TIMEOUT.inc()
        raise
    except MemLimitExceeded as e:
        ctx.state = "memlimit"
        ctx.error = str(e)
        raise
    except BaseException as e:
        ctx.state = "error"
        ctx.error = f"{type(e).__name__}: {e}"
        raise
    finally:
        _tls.ctx = None
        # guaranteed unwind, every exit path: cleanup stack (admission
        # slots et al), then the accountant, then visibility
        ctx.run_cleanups()
        ACCOUNTANT.release_query(ctx)
        REGISTRY.deregister(ctx)
        _finalize_observability(ctx)
