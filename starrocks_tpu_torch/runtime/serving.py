"""High-concurrency serving tier: executor pool + statement gate + fast path.

Reference behavior: the FE's session/execution plane (qe/ — ConnectContext
pool, ConnectScheduler's executor threads, StmtExecutor) multiplexes
hundreds of client connections over a bounded pool of execution threads.
Before this tier, both front doors serialized every statement on one big
session lock — added cores bought zero QPS. Now:

- **ServingTier** owns the shared engine state (catalog, TabletStore, ONE
  DeviceCache — compiled programs / device columns / query cache / plan
  cache serve every connection) and mints a lightweight per-connection
  Session around it (`new_session`), so per-session mutable state
  (current_user, resource_group, last_profile) never races.

- **ExecutorPool** (`SET serve_pool_size`) dispatches admitted statements
  across worker threads. The run queue is PRIORITY-ordered with the same
  aging rule as admission lanes (workgroup.py): a statement's priority is
  its resource group's, boosted by queue wait / query_queue_aging_s, so
  low-priority dashboards never starve behind a stream of hot ones.
  Every worker body runs inside `lifecycle.query_scope` — the statement
  is registered (SHOW PROCESSLIST / KILL), deadline-armed, and memory-
  accounted BEFORE any engine code runs; tools/src_lint.py R5 pins this
  statically (no unregistered statement execution). Registration happens
  at ENQUEUE (stage `serve::queued`), so KILL QUERY reaches statements
  still waiting for a pool slot: the waiting connection thread reaps a
  killed queued work itself; once a worker claims it, the adopted
  context kills it at the first checkpoint.

- **StatementGate**: queries take the SHARED side and overlap freely
  (planning, host orchestration, XLA dispatch); catalog-mutating
  statements take the EXCLUSIVE side — writer-preferring, so a queued
  mutation is not starved by a read stream. This is the catalog's
  concurrency contract: its schema maps are mutated only under the
  exclusive side, read freely under the shared side. The gate is
  PER-TABLE-granular for the common shapes (NEXT 7g first cut):
  single-target DML excludes only readers of ITS table (it holds the
  global side shared, like a reader), so point reads of table Y never
  queue behind a stream of upserts into table X. Reads whose base-table
  set is statically known claim those tables shared; anything whose
  footprint is not provable from the text (view/MV references, SHOW/
  EXPLAIN, DDL, SET, multi-statement shapes) falls back to the original
  whole-engine semantics: strong readers exclude every table writer,
  and DDL/SET take the global exclusive side against everyone.

- **Point lane**: a statement the short-circuit detector (runtime/
  point.py) recognizes as a PK point SELECT on a stored PK table runs
  INLINE on the connection thread under a per-table shared claim — no
  pool hop, no planner, no compiler (the wire-speed lookup path). The
  probe is text+catalog-shape only; execution goes through session.sql,
  which re-validates and falls back to the full analytic path on any
  semantic mismatch — safe either way, because a matched text can only
  read the one claimed table. Point DML rides the pool exclusive on its
  target table. `SET enable_short_circuit = off` disables the probe
  outright.

- **Warm fast path**: when the statement text's analyzed plan AND its
  full result are both cached-valid, the statement runs INLINE on the
  connection thread (no pool hop, no parse/analyze/optimize/compile) —
  the sub-millisecond dashboard path. The probe is counter-free; the
  inline execution reuses the exact session.sql path, so a probe/execute
  race degrades to a normal pool-less execution, never a wrong answer.

KILL QUERY / cancel endpoints bypass the tier entirely (lifecycle
registry), exactly as they bypass the old session lock: the victim may be
HOLDING the gate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import re
import threading
import time

from .. import lockdep
from . import workgroup as _workgroup  # noqa: F401 — queue-knob definitions
from .config import config
from .failpoint import fail_point
from .metrics import metrics
from .session import Session

config.define("serve_pool_size", 4, True,
              "executor threads of the serving tier's statement pool "
              "(the qe/ ConnectScheduler executor-pool analog); sizing "
              "applies to tiers created after the SET")

SERVE_STATEMENTS = metrics.counter(
    "sr_tpu_serve_statements_total", "statements executed by the tier")
SERVE_FAST_PATH = metrics.counter(
    "sr_tpu_serve_fast_path_total",
    "statements answered inline by the warm plan+result fast path")
SERVE_QUEUE_WAIT_MS = metrics.counter(
    "sr_tpu_serve_queue_wait_ms_total",
    "total milliseconds statements waited in the executor-pool queue")
SERVE_EXCLUSIVE = metrics.counter(
    "sr_tpu_serve_exclusive_total",
    "statements that took the exclusive (mutation) side of the gate")
SERVE_QUEUE_WAIT_HIST = metrics.histogram(
    "sr_tpu_serve_queue_wait_hist_ms",
    "executor-pool queue wait distribution (milliseconds)")
SERVE_FAST_PATH_HIST = metrics.histogram(
    "sr_tpu_serve_fast_path_hist_ms",
    "warm fast-path hit latency distribution (milliseconds)")
SERVE_POINT_INLINE = metrics.counter(
    "sr_tpu_point_inline_total",
    "point statements served inline on the connection thread (no pool "
    "hop) by the short-circuit lane")

# a writer that waited this long on the gate is journaled as a
# `gate_writer_stall` event (runtime/events.py) — reads contend freely,
# so only the exclusive side can starve visibly
_GATE_STALL_EVENT_S = 0.25


def _note_writer_stall(table, waited_s: float):
    """Journal a stalled gate writer (called AFTER acquisition, outside
    the gate lock — the event journal lock stays a leaf)."""
    if waited_s < _GATE_STALL_EVENT_S:
        return
    from . import events

    events.emit("gate_writer_stall", table=table or "",
                waited_ms=round(waited_s * 1000.0, 1))


# leading keyword -> shared (read) side of the statement gate; anything
# else (DML/DDL/SET/ADMIN/...) is exclusive. KILL never reaches the tier.
_READ_KEYWORDS = frozenset(
    ("select", "with", "values", "show", "explain", "describe", "desc"))


def _is_read_statement(sql: str) -> bool:
    head = sql.lstrip().split(None, 1)
    return bool(head) and head[0].lower().rstrip("(") in _READ_KEYWORDS


_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_DML_TARGET_RE = re.compile(
    r"\s*(?:insert\s+into|update|delete\s+from)\s+"
    r"([A-Za-z_][A-Za-z0-9_]*)", re.IGNORECASE)


def _read_footprint(sql: str, catalog, cache=None):
    """Base tables of a read statement, or None when the footprint is not
    provable (SHOW/EXPLAIN/DESCRIBE read stats and catalog state).

    Preferred source: the statement's CACHED ANALYZED PLAN (counter-free
    `PlanCache.peek` + `plan_tables`) — exact base tables even through
    view/MV expansion and subqueries, so a warm dashboard query over a
    view never degrades to the strong reader and never stalls behind
    ingest commits on unrelated tables. Internal relations (__dual__,
    information_schema) claim nothing: their backing state is guarded by
    its own leaf locks, and DDL still bars them via the global side.

    Fallback (cold statements): the token scan, which OVER-approximates —
    a spurious table claim only costs concurrency, while a missed claim
    would race DML — so anything uncertain (view/MV tokens, no provable
    tables) degrades to the strong (every-table-writer-excluding)
    reader. Probe-then-execute races are benign either way: claims are
    granted atomically under the gate lock, and execution re-validates
    through the normal session.sql path."""
    head = sql.lstrip().split(None, 1)
    kw = head[0].lower().rstrip("(") if head else ""
    if kw not in ("select", "with", "values"):
        return None
    if cache is not None and config.get("enable_plan_cache"):
        plan = cache.plan_cache.peek(sql, catalog)
        if plan is not None:
            from ..sql.optimizer import plan_tables

            return frozenset(
                t for t in plan_tables(plan) if t in catalog.tables)
    toks = {t.lower() for t in _IDENT_RE.findall(sql)}
    if toks & (set(catalog.views) | set(catalog.mv_defs)):
        return None
    tabs = toks & set(catalog.tables)
    return frozenset(tabs) if tabs else None


def _dml_footprint(sql: str, catalog):
    """(target, read tables) of a single-target DML, or (None, ()) when
    the statement must take the global exclusive side (DDL/SET/unknown
    target/view-involved). Same over-approximation rule as reads: the
    read set is every OTHER catalog table named anywhere in the text."""
    m = _DML_TARGET_RE.match(sql)
    if m is None:
        return None, frozenset()
    target = m.group(1).lower()
    toks = {t.lower() for t in _IDENT_RE.findall(sql)}
    if target not in catalog.tables or toks & (
            set(catalog.views) | set(catalog.mv_defs)):
        return None, frozenset()
    return target, frozenset((toks & set(catalog.tables)) - {target})


class StatementGate:
    """Writer-preferring readers/writer gate over one witnessed condition.
    Readers = queries (overlap freely); writers = catalog mutations.

    Two granularities share the ONE condition (NEXT 7g):

    - the GLOBAL side: `shared(None)` strong readers and `exclusive()`
      (DDL/SET/multi-table shapes) — the original whole-engine contract;
    - the PER-TABLE side: `shared(tables)` readers claim their base
      tables, `exclusive(target, reads)` single-target DML claims its
      target exclusively + its source tables shared while holding the
      GLOBAL side shared, so only same-table traffic conflicts.

    Every acquisition is all-or-nothing under the single lock (no claim
    is held while waiting except the pure writer-preference counters, and
    those never gate another writer), so multi-claim entries cannot
    deadlock — concur_lint's single-condition witness stays trivially
    acyclic."""

    def __init__(self):
        self._lock = lockdep.condition("StatementGate._lock")
        self._readers = 0           # guarded_by: _lock — ALL global-shared
        #                             holders incl. table writers
        self._writer = False        # guarded_by: _lock
        self._writers_waiting = 0   # guarded_by: _lock
        self._strong_readers = 0    # guarded_by: _lock — footprint unknown
        self._table_readers: dict = {}          # guarded_by: _lock
        self._table_writers: set = set()        # guarded_by: _lock
        self._table_writers_waiting: dict = {}  # guarded_by: _lock

    # -- predicate helpers (call with _lock held) ---------------------------
    def _shared_blocked(self, tables) -> bool:  # lint: holds _lock
        if self._writer or self._writers_waiting:
            return True
        if tables is None:  # strong reader: any table writer conflicts
            return bool(self._table_writers
                        or any(self._table_writers_waiting.values()))
        # writer preference per table: a WAITING table writer bars new
        # readers of that table, exactly like the global counters
        return any(t in self._table_writers
                   or self._table_writers_waiting.get(t)
                   for t in tables)

    def _enter_shared(self, tables):  # lint: holds _lock
        self._readers += 1
        if tables is None:
            self._strong_readers += 1
        else:
            for t in tables:
                self._table_readers[t] = self._table_readers.get(t, 0) + 1

    def try_shared(self, tables=None) -> bool:
        """Non-blocking reader entry (the fast/point paths must never
        queue behind a writer — they fall back to the pool instead).
        `tables` is the read's base-table claim; None = strong reader.
        Pass the SAME value to release_shared."""
        with self._lock:
            if self._shared_blocked(tables):
                return False
            self._enter_shared(tables)
            return True

    def release_shared(self, tables=None):
        with self._lock:
            self._readers = max(self._readers - 1, 0)
            if tables is None:
                self._strong_readers = max(self._strong_readers - 1, 0)
            else:
                for t in tables:
                    n = self._table_readers.get(t, 0) - 1
                    if n > 0:
                        self._table_readers[t] = n
                    else:
                        self._table_readers.pop(t, None)
            self._lock.notify_all()

    @contextlib.contextmanager
    def shared(self, tables=None):
        from . import lifecycle

        with self._lock:
            # writer preference: queued mutations bar NEW readers
            while self._shared_blocked(tables):
                self._lock.wait(timeout=0.1)
                lifecycle.checkpoint("serve::gate_shared")
            self._enter_shared(tables)
        try:
            yield
        finally:
            self.release_shared(tables)

    @contextlib.contextmanager
    def exclusive(self, table=None, reads=frozenset()):
        """Global exclusive when `table` is None; otherwise single-target
        DML: global SHARED + `table` exclusive + `reads` shared — reads
        of other tables flow freely past it."""
        from . import lifecycle

        if table is not None:
            yield from self._table_exclusive(table, reads)
            return
        t0 = time.monotonic()
        with self._lock:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._lock.wait(timeout=0.1)
                    lifecycle.checkpoint("serve::gate_exclusive")
                self._writer = True
            finally:
                self._writers_waiting -= 1
        _note_writer_stall(None, time.monotonic() - t0)
        try:
            yield
        finally:
            with self._lock:
                self._writer = False
                self._lock.notify_all()

    def _table_exclusive(self, table, reads):
        from . import lifecycle

        reads = frozenset(reads) - {table}
        t0 = time.monotonic()
        with self._lock:
            self._table_writers_waiting[table] = \
                self._table_writers_waiting.get(table, 0) + 1
            try:
                # read-set claims check ACTIVE writers only (not waiting
                # ones): two waiting writers reading each other's targets
                # must not mutually block — all-or-nothing keeps it safe
                while (self._writer or self._writers_waiting
                       or table in self._table_writers
                       or self._table_readers.get(table)
                       or self._strong_readers
                       or any(r in self._table_writers for r in reads)):
                    self._lock.wait(timeout=0.1)
                    lifecycle.checkpoint("serve::gate_exclusive")
                self._table_writers.add(table)
                self._readers += 1  # holds the global side SHARED
                for r in reads:
                    self._table_readers[r] = \
                        self._table_readers.get(r, 0) + 1
            finally:
                n = self._table_writers_waiting.get(table, 0) - 1
                if n > 0:
                    self._table_writers_waiting[table] = n
                else:
                    self._table_writers_waiting.pop(table, None)
        _note_writer_stall(table, time.monotonic() - t0)
        try:
            yield
        finally:
            with self._lock:
                self._table_writers.discard(table)
                self._readers = max(self._readers - 1, 0)
                for r in reads:
                    n = self._table_readers.get(r, 0) - 1
                    if n > 0:
                        self._table_readers[r] = n
                    else:
                        self._table_readers.pop(r, None)
                self._lock.notify_all()


@dataclasses.dataclass
class _Work:
    """One dispatched statement: inputs, priority, and its reply slot."""
    session: Session
    sql: str
    exclusive: bool
    prio: float
    seq: int
    t0: float
    # witnessed handoff: under SR_TPU_LOCK_WITNESS the worker's set()
    # and the connection thread's wait() join the lock-order graph
    # (plain threading.Event otherwise)
    done: threading.Event = dataclasses.field(
        default_factory=lambda: lockdep.event("serving._Work.done"))
    result: object = None
    error: BaseException | None = None
    # lifecycle context registered at ENQUEUE (stage serve::queued) so
    # KILL QUERY reaches statements still waiting for a pool slot; the
    # worker adopts it via query_scope(ctx=...)
    ctx: object = None

    def eff(self, now: float, aging: float) -> float:
        if aging > 0:
            return self.prio + (now - self.t0) / aging
        return self.prio


class ExecutorPool:
    """Sized statement-executor pool with a priority+aging run queue."""

    def __init__(self, size: int, gate: StatementGate):
        self.size = max(int(size), 1)
        self.gate = gate
        self._lock = lockdep.condition("ExecutorPool._lock")
        self._queue: list = []     # guarded_by: _lock — pending _Work
        self._shutdown = False     # guarded_by: _lock
        self._seq = itertools.count(1)  # guarded_by: _lock
        # spawned once by the owning tier's thread; never mutated after
        self._threads = [           # lint: unguarded-ok — owner-thread only
            threading.Thread(target=self._worker, daemon=True,
                             name=f"sr-serve-{i}")
            for i in range(self.size)]
        for t in self._threads:
            t.start()

    def submit(self, session: Session, sql: str, exclusive: bool,
               prio: float) -> _Work:
        from . import lifecycle

        # register for KILL/PROCESSLIST at ENQUEUE, not worker start: a
        # statement stuck behind a saturated pool is already visible and
        # killable (its queue wait also counts against the deadline)
        group_limit = 0
        if session.resource_group:
            g = session.workgroups().get(session.resource_group)
            if g is not None:
                group_limit = g.mem_limit_bytes
        ctx = lifecycle.QueryContext(sql, user=session.current_user,
                                     group=session.resource_group,
                                     group_limit=group_limit)
        ctx.last_stage = "serve::queued"
        lifecycle.REGISTRY.register(ctx)
        with self._lock:
            if self._shutdown:
                lifecycle.REGISTRY.deregister(ctx)
                raise RuntimeError("serving tier is shut down")
            w = _Work(session, sql, exclusive, prio, next(self._seq),
                      time.monotonic(), ctx=ctx)
            self._queue.append(w)
            self._lock.notify()
            return w

    def abandon(self, w: _Work) -> bool:
        """Remove a still-queued work (KILL landed while it waited for a
        slot). False once a worker has claimed it — the kill then lands
        at the worker's first lifecycle checkpoint instead."""
        with self._lock:
            try:
                self._queue.remove(w)
            except ValueError:
                return False
            return True

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def shutdown(self):
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()

    def _next_work(self):
        """Blocking pop of the highest effective-priority statement (the
        pool-level priority lane; same aging knob as admission)."""
        with self._lock:
            # lint: checkpoint-exempt — worker idle loop, not query context; shutdown unblocks via notify_all and each adopted statement checkpoints inside its own query_scope
            while True:
                if self._shutdown:
                    return None
                if self._queue:
                    now = time.monotonic()
                    aging = float(config.get("query_queue_aging_s") or 0.0)
                    best = max(self._queue,
                               key=lambda w: (w.eff(now, aging), -w.seq))
                    self._queue.remove(best)
                    return best
                self._lock.wait(timeout=0.5)

    def _worker(self):
        while True:
            w = self._next_work()
            if w is None:
                return
            try:
                self._run_statement(w)
            except BaseException as e:  # noqa: BLE001  # lint: swallow-ok
                w.error = e  # delivered to the waiting connection thread;
                #              the worker itself must survive every failure
            finally:
                w.done.set()

    def _run_statement(self, w: _Work):
        """Worker body: EVERY statement runs inside a lifecycle
        query_scope (registered, killable, deadline-armed, accounted)
        before any engine code — src_lint R5 enforces this shape."""
        from . import lifecycle

        wait_ms = (time.monotonic() - w.t0) * 1000.0
        SERVE_QUEUE_WAIT_MS.inc(int(wait_ms))
        SERVE_QUEUE_WAIT_HIST.observe(wait_ms)
        # the context carries its pool wait so the profile's trace export
        # and the query_log audit row both see the admission delay
        w.ctx.queue_wait_ms += wait_ms
        SERVE_STATEMENTS.inc()
        sess = w.session
        group_limit = 0
        if sess.resource_group:
            g = sess.workgroups().get(sess.resource_group)
            if g is not None:
                group_limit = g.mem_limit_bytes
        if w.exclusive:
            SERVE_EXCLUSIVE.inc()
            target, reads = _dml_footprint(w.sql, sess.catalog)
            gate_side = self.gate.exclusive(target, reads)
        else:
            gate_side = self.gate.shared(
                _read_footprint(w.sql, sess.catalog, sess.cache))
        with lifecycle.query_scope(w.sql, user=sess.current_user,
                                   group=sess.resource_group,
                                   group_limit=group_limit, ctx=w.ctx):
            with gate_side:
                w.result = sess.sql(w.sql)


class ServingTier:
    """The shared serving plane both front doors (MySQL + HTTP) ride."""

    def __init__(self, template: Session, pool_size: int | None = None):
        self.template = template
        self.catalog = template.catalog
        self.cache = template.cache
        self.store = template.store
        self.gate = StatementGate()
        # publish the gate catalog-wide: the ingest plane's micro-batch
        # commits take its per-table exclusive side (Session.ingest_plane
        # reads serve_gate at plane wire-up; one tier per catalog)
        self.catalog.serve_gate = self.gate
        ip = getattr(self.catalog, "ingest_plane", None)
        if ip is not None:
            ip.gate = self.gate
        size = pool_size if pool_size is not None \
            else int(config.get("serve_pool_size"))
        self.pool = ExecutorPool(size, self.gate)
        from .metrics import HISTORY
        from .watchdog import WATCHDOG

        # a serving surface exists: keep the metrics-history ring warm
        # and the stuck-query watchdog scanning (both idempotent; gated
        # by their enable knobs)
        HISTORY.ensure_started()
        WATCHDOG.ensure_started()

    def new_session(self, user: str = "root") -> Session:
        """A per-connection session over the SHARED catalog/cache/store:
        session-scoped state (user, resource group, last profile) is
        private; everything cacheable is communal."""
        s = Session(catalog=self.catalog, cache=self.cache, store=self.store,
                    dist_shards=self.template.dist_shards)
        s.current_user = user
        return s

    def execute(self, session: Session, sql: str):
        """Execute one statement for a connection: warm fast path inline,
        everything else through the priority pool. Blocks the calling
        (connection) thread until the statement finishes — wire protocols
        are synchronous per connection."""
        sqln = sql.strip().rstrip(";")
        res = self._try_point_inline(session, sqln)
        if res is not _FAST_MISS:
            return res
        res = self._try_fast_path(session, sqln)
        if res is not _FAST_MISS:
            return res
        prio = 0.0
        if session.resource_group:
            g = session.workgroups().get(session.resource_group)
            if g is not None:
                prio = float(g.priority)
        w = self.pool.submit(session, sqln, not _is_read_statement(sqln),
                             prio)
        from . import lifecycle

        # the wait doubles as the queued-kill AND queued-deadline reaper:
        # if a KILL lands — or the statement's own deadline passes —
        # while the work still sits in the pool queue, pull it out and
        # unwind here. The victim must not wait for a worker to free up
        # just to die (NEXT 7f), and a deadline-expired statement must
        # not consume a worker slot just to time out at its first
        # checkpoint. This poll IS the cancellation enforcement for the
        # serve::queued stage, so the loop itself is checkpoint-free by
        # design. # lint: checkpoint-exempt — this wait IS the reaper: it polls kill+deadline every 50ms and unwinds via finalize_queued
        while not w.done.wait(0.05):
            ctx = w.ctx
            if ctx is None:
                continue
            timed_out = (not ctx.cancelled() and ctx.deadline is not None
                         and time.monotonic() > ctx.deadline)
            if (ctx.cancelled() or timed_out) and self.pool.abandon(w):
                if timed_out:
                    # abandon succeeded: no worker will ever adopt this
                    # work, so route the timeout through the normal kill
                    # machinery and finalize_queued records the reason.
                    # (If a worker had adopted it, its own checkpoint
                    # raises the natural QueryTimeoutError instead.)
                    ctx.cancel(f"query_timeout_s={ctx.timeout_s:g} "
                               f"exceeded while queued")
                lifecycle.finalize_queued(ctx)
                if timed_out:
                    raise lifecycle.QueryTimeoutError(
                        f"query {ctx.qid} exceeded query_timeout_s="
                        f"{ctx.timeout_s:g} at stage 'serve::queued'")
                raise lifecycle.QueryCancelledError(
                    f"query {ctx.qid} cancelled at stage 'serve::queued': "
                    f"{ctx.cancel_reason()}")
        # surface the tier's last profile for the /profile endpoint
        # (best-effort: concurrent statements race benignly)
        if session.last_profile is not None:
            self.template.last_profile = session.last_profile
        if w.error is not None:
            # the work item lets go of the error as it leaves: this frame
            # (in the error's traceback) holds `w`, and a cycle error ->
            # traceback -> frame -> w -> error would keep the failed
            # statement's frames, and the device tensors in them, alive
            # until the cyclic collector ran
            try:
                raise w.error
            finally:
                w.error = None
        return w.result

    def _try_point_inline(self, session: Session, sql: str):
        """Short-circuit point lane, served INLINE on the connection
        thread under a per-table shared claim: no pool hop, no planner,
        no compiler — the wire-speed PK lookup path. The probe checks
        only text shape + that the target is a stored PK base table;
        execution goes through session.sql, which re-detects and falls
        back to the full analytic path on any semantic mismatch — safe
        either way, because a matched text can only read the one claimed
        table. Contention on that table degrades to the pool path."""
        if not config.get("enable_short_circuit"):
            return _FAST_MISS
        from . import point

        shape = point.peek_select(sql)
        if shape is None:
            return _FAST_MISS
        h = self.catalog.tables.get(shape.table)
        if (h is None or not getattr(h, "unique_keys", ())
                or shape.table in self.catalog.views
                or shape.table in self.catalog.mv_defs):
            return _FAST_MISS
        tabs = frozenset((shape.table,))
        t0 = time.perf_counter()  # before the claim: nothing may raise
        #                           between acquire and the try-finally
        if not self.gate.try_shared(tabs):
            return _FAST_MISS  # DML active/queued on this table: pool path
        try:
            fail_point("serve::point_inline")  # inside the claim's
            #   try-finally: injected faults always release the gate
            SERVE_POINT_INLINE.inc()
            SERVE_STATEMENTS.inc()
            return session.sql(sql)
        finally:
            self.gate.release_shared(tabs)
            SERVE_FAST_PATH_HIST.observe(
                (time.perf_counter() - t0) * 1000.0)

    def _try_fast_path(self, session: Session, sql: str):
        """Inline execution when text -> plan -> result are ALL cached and
        valid: no pool hop, no parse/analyze/optimize/compile/device —
        the <1ms warm-dashboard path. Probes are counter-free; the actual
        execution below re-validates everything through the normal
        session.sql path, so races only cost speed."""
        if not (config.get("enable_plan_cache")
                and config.get("enable_query_cache")):
            return _FAST_MISS
        plan = self.cache.plan_cache.peek(sql, self.catalog)
        if plan is None:
            return _FAST_MISS
        from ..cache import keys as cache_keys

        try:
            skey = cache_keys.full_result_key(plan)
        except Exception:  # noqa: BLE001  # lint: swallow-ok — unkeyable
            return _FAST_MISS  # plan shapes simply take the pool path
        if not self.cache.qcache.has_result(skey, self.catalog):
            return _FAST_MISS
        from ..sql.optimizer import plan_tables

        # the analyzed plan is in hand: claim its exact base tables
        # instead of the strong reader, so warm dashboards over table Y
        # glide past ingest commits and DML on table X
        tabs = frozenset(t for t in plan_tables(plan)
                         if t in self.catalog.tables)
        t0 = time.perf_counter()  # before the claim: nothing may raise
        #                           between acquire and the try-finally
        if not self.gate.try_shared(tabs):
            return _FAST_MISS  # a mutation is active/queued: pool path
        try:
            fail_point("serve::fast_path")  # inside the claim's
            #   try-finally: injected faults always release the gate
            SERVE_FAST_PATH.inc()
            SERVE_STATEMENTS.inc()
            return session.sql(sql)
        finally:
            self.gate.release_shared(tabs)
            SERVE_FAST_PATH_HIST.observe(
                (time.perf_counter() - t0) * 1000.0)

    def attach_cluster(self, runtime):
        """Route this tier's eligible fragment queries through a
        multi-process cluster runtime (runtime/cluster_exec.py). The
        runtime is published on the SHARED catalog, so every pool/
        connection session — present and future — picks it up; the
        template session must be distributed (dist_shards set) for
        fragment plans to exist at all. Detach with `None`."""
        if runtime is None:
            if getattr(self.catalog, "cluster_runtime", None) is not None:
                self.catalog.cluster_runtime = None
            return self
        if not self.template.dist_shards:
            raise ValueError(
                "cluster routing needs a distributed template session "
                "(Session(dist_shards=N)) — fragment IR only exists on "
                "the distributed path")
        runtime.attach(self.template)
        return self

    def stats(self) -> dict:
        out = {
            "fast_path": SERVE_FAST_PATH.value,
            "point_inline": SERVE_POINT_INLINE.value,
            "statements": SERVE_STATEMENTS.value,
            "pool_pending": self.pool.pending(),
            "plan_cache": self.cache.plan_cache.stats(),
        }
        cluster = getattr(self.catalog, "cluster_runtime", None)
        if cluster is not None:
            out["cluster"] = cluster.stats()
        return out

    def shutdown(self):
        self.pool.shutdown()


_FAST_MISS = object()  # sentinel: fast path declined (None is a result)
