"""Resource groups + priority-aware admission control.

Reference behavior: BE workgroups (be/src/compute_env/workgroup/
work_group.h:145 — per-group CPU weight / memory limit / big-query limits)
and the FE's query-queue slot manager
(fe-core/.../qe/scheduler/slot/SlotManager.java: queries wait for a slot,
time out, or are rejected; the queue is priority-ordered per resource
group). Re-designed for the single-process TPU engine:

- a ResourceGroup carries declarative limits (concurrency slots, big-query
  scan-row cap, estimated-scan-memory cap, advisory cpu_weight) plus a
  scheduling `priority` (higher = more urgent);
- the WorkgroupManager is the admission gate every Session passes through
  before executing a query: big-query limits reject immediately
  (the reference's big_query_scan_rows_limit kill), slot exhaustion QUEUES
  the query (SlotManager's pending queue) in **priority lanes**: when a
  slot frees, the waiter with the highest *effective* priority wins, where
  effective priority = group priority + queue_wait / query_queue_aging_s —
  the aging term guarantees a low-priority query eventually outbids fresh
  high-priority arrivals, so no lane starves. Equal effective priority
  falls back to FIFO (ticket order);
- besides per-group slots there is one GLOBAL lane
  (`SET query_queue_concurrency = N`): every admitted statement holds a
  global slot too, arbitrated across groups by the same priority+aging
  rule — the FE query-queue global concurrency analog;
- when a lane's queue backs up (head waiter older than
  `query_queue_preempt_hint_s`), the lowest-priority RUNNING query in that
  lane receives a **preemption hint** — the same soft-degrade nudge a
  crossed soft memory limit delivers (query-cache admission declined,
  spill batches shrink), so it finishes sooner and frees its slot. Hints
  never kill: cooperative degradation only;
- groups live on the catalog (shared by every session of this process —
  the process is the BE) and persist through the metadata image/journal.

cpu_weight is recorded but advisory: one process, one device — there is no
second scheduler underneath to weight. The enforced isolation axes are
admission (slots, global slots, priority) and the big-query caps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Optional

from .. import lockdep
from .config import config
from .failpoint import fail_point
from .metrics import metrics

config.define("query_queue_timeout_s", 10.0, True,
              "seconds a query waits for a resource-group slot before "
              "failing admission (the FE slot-queue timeout analog)")
config.define("query_queue_aging_s", 5.0, True,
              "queue-wait seconds that promote a waiting query by one "
              "priority step (anti-starvation aging; 0 disables aging and "
              "lanes become strict-priority)")
config.define("query_queue_concurrency", 0, True,
              "global admission slots across ALL statements (grouped or "
              "not), arbitrated by priority lanes; 0 = unlimited (the FE "
              "query queue's global concurrency analog)")
config.define("query_queue_preempt_hint_s", 1.0, True,
              "queue wait beyond which the lowest-priority running query "
              "in the backed-up lane receives a soft-degrade preemption "
              "hint (0 disables hints)")

ADMISSION_REJECTED = metrics.counter(
    "sr_tpu_admission_rejected_total",
    "queries rejected by big-query scan/memory caps")
ADMISSION_TIMEOUT = metrics.counter(
    "sr_tpu_admission_timeout_total",
    "queries that timed out waiting for a resource-group slot")
ADMISSION_RUNNING = metrics.gauge(
    "sr_tpu_admission_running", "queries holding a resource-group slot")
ADMISSION_QUEUED = metrics.gauge(
    "sr_tpu_admission_queued", "queries queued for a resource-group slot")
ADMISSION_ADMITTED = metrics.counter(
    "sr_tpu_admission_admitted_total", "queries admitted through a lane")
ADMISSION_QUEUE_WAIT_MS = metrics.counter(
    "sr_tpu_admission_queue_wait_ms_total",
    "total milliseconds spent waiting in admission lanes")
ADMISSION_PREEMPT_HINTS = metrics.counter(
    "sr_tpu_admission_preempt_hints_total",
    "soft-degrade preemption hints delivered to running queries")

# the cross-group global slot lane ("__" prefix keeps it out of the
# resource-group namespace — session.py reserves it for internal names)
GLOBAL_LANE = "__global__"


class AdmissionError(RuntimeError):
    """Query rejected or timed out by resource-group admission control."""


@dataclasses.dataclass
class ResourceGroup:
    name: str
    concurrency_limit: int = 0      # 0 = unlimited slots
    max_scan_rows: int = 0          # 0 = no big-query row cap
    mem_limit_bytes: int = 0        # 0 = no estimated-scan-memory cap
    cpu_weight: int = 0             # advisory (recorded, surfaced in SHOW)
    priority: int = 0               # lane priority (higher = more urgent)

    def to_props(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_props(cls, props: dict) -> "ResourceGroup":
        return cls(**{k: props[k] for k in (
            "name", "concurrency_limit", "max_scan_rows", "mem_limit_bytes",
            "cpu_weight", "priority") if k in props})


_ALLOWED_PROPS = {"concurrency_limit", "max_scan_rows", "mem_limit_bytes",
                  "cpu_weight", "priority"}


@dataclasses.dataclass
class _Waiter:
    """One queued admission request in a lane."""
    prio: float
    seq: int      # FIFO ticket (tie-break within equal effective priority)
    t0: float

    def eff(self, now: float, aging: float) -> float:
        """Effective priority: base + aging boost. With aging=0 lanes are
        strict-priority (starvation possible — opt-in)."""
        if aging > 0:
            return self.prio + (now - self.t0) / aging
        return self.prio


class WorkgroupManager:
    """Process-wide admission gate (one per catalog = one per 'BE')."""

    def __init__(self):
        # a Condition (queued queries wait on it for a freed slot); its
        # underlying mutex guards every mutable field below
        self._lock = lockdep.condition("WorkgroupManager._lock")
        self.groups: dict[str, ResourceGroup] = {}  # guarded_by: _lock
        self.running: dict[str, int] = {}           # guarded_by: _lock
        self.queued: dict[str, int] = {}            # guarded_by: _lock
        self.rejected_total = 0                     # guarded_by: _lock
        self.timeout_total = 0                      # guarded_by: _lock
        self.admitted_total = 0                     # guarded_by: _lock
        self.queue_wait_ms_total = 0.0              # guarded_by: _lock
        self._waiters: dict = {}       # guarded_by: _lock — lane -> [_Waiter]
        self._running_ctxs: dict = {}  # guarded_by: _lock — lane ->
        #                                {seq: (prio, QueryContext)}
        self._last_hint: dict = {}     # guarded_by: _lock — lane -> ts
        self._tickets = itertools.count(1)  # guarded_by: _lock

    # --- DDL -----------------------------------------------------------------
    def create(self, name: str, props: dict, replace: bool = False):
        name = name.lower()
        bad = set(props) - _ALLOWED_PROPS
        if bad:
            raise ValueError(
                f"unknown resource group properties {sorted(bad)}; "
                f"allowed: {sorted(_ALLOWED_PROPS)}")
        with self._lock:
            if name in self.groups and not replace:
                raise ValueError(f"resource group {name!r} already exists")
            self.groups[name] = ResourceGroup(
                name=name, **{k: int(v) for k, v in props.items()})
            self._lock.notify_all()  # limits may have widened for waiters

    def drop(self, name: str, if_exists: bool = False):
        name = name.lower()
        with self._lock:
            if name not in self.groups:
                if if_exists:
                    return
                raise ValueError(f"unknown resource group {name!r}")
            del self.groups[name]
            self._lock.notify_all()

    def get(self, name: str) -> Optional[ResourceGroup]:
        with self._lock:  # Condition's mutex is reentrant: safe from admit
            return self.groups.get(name.lower())

    # --- priority lanes -------------------------------------------------------
    def _lane_limit(self, lane: str):  # lint: holds _lock
        """Current slot limit of a lane, or None when the lane no longer
        throttles (group dropped / limit cleared): the waiter runs free."""
        if lane == GLOBAL_LANE:
            return int(config.get("query_queue_concurrency") or 0) or None
        g = self.groups.get(lane)
        if g is None or not g.concurrency_limit:
            return None
        return g.concurrency_limit

    def _head_ok(self, lane, w, now, aging) -> bool:  # lint: holds _lock
        """True when `w` holds the lane's best (effective priority, FIFO)
        claim — the priority-lane replacement for the FIFO-by-condvar
        wakeup."""
        best_key = (w.eff(now, aging), -w.seq)
        for o in self._waiters.get(lane, ()):
            if o is w:
                continue
            if (o.eff(now, aging), -o.seq) > best_key:
                return False
        return True

    def _preempt_hint(self, lane, now, hint_s):  # lint: holds _lock
        """Queue backed up: nudge the lowest-priority running query in the
        lane with the soft-degrade hint (at most one hint per lane per
        hint interval; never kills)."""
        if now - self._last_hint.get(lane, 0.0) < hint_s:
            return
        entries = self._running_ctxs.get(lane)
        if not entries:
            return
        cands = [(p, seq, c) for seq, (p, c) in entries.items()
                 if c.state == "running" and not c.degraded]
        if not cands:
            return
        _, _, victim = min(cands, key=lambda t: (t[0], t[1]))
        if victim.nudge(
                f"preemption hint: admission lane {lane!r} backed up"):
            self._last_hint[lane] = now
            ADMISSION_PREEMPT_HINTS.inc()
            from . import events

            # the journal lock is a leaf, safe under the manager lock
            events.emit("preempt_hint", qid=victim.qid, lane=lane)

    def _acquire_lane(self, lane: str, prio: float, deadline: float,
                      aging: float, hint_s: float, ctx):
        """Queue on one lane until a slot frees AND this waiter is the
        lane's priority head. Returns the slot ticket (int) or None when
        the lane stopped throttling (no slot held). Raises AdmissionError
        on queue timeout; a KILL unblocks within ~100ms via the lifecycle
        checkpoint."""
        from . import lifecycle

        with self._lock:
            w = _Waiter(prio, next(self._tickets), time.monotonic())
            self._waiters.setdefault(lane, []).append(w)
            self.queued[lane] = self.queued.get(lane, 0) + 1
            ADMISSION_QUEUED.set(sum(self.queued.values()))
            try:
                while True:
                    limit = self._lane_limit(lane)
                    if limit is None:
                        return None  # lane dissolved: run unthrottled
                    now = time.monotonic()
                    if (self.running.get(lane, 0) < limit
                            and self._head_ok(lane, w, now, aging)):
                        break
                    remaining = deadline - now
                    if remaining <= 0:
                        self.timeout_total += 1
                        ADMISSION_TIMEOUT.inc()
                        raise AdmissionError(
                            f"admission queue timeout: lane {lane!r} held "
                            f"all {limit} slot(s) for "
                            f"{config.get('query_queue_timeout_s')}s")
                    if hint_s and now - w.t0 >= hint_s:
                        self._preempt_hint(lane, now, hint_s)
                    # a KILL must not wait out the queue timeout: wake
                    # periodically and let the checkpoint raise (the
                    # condition variable has no cross-thread cancel signal)
                    self._lock.wait(timeout=min(remaining, 0.1))
                    lifecycle.checkpoint("workgroup::queued")
            finally:
                self._waiters[lane].remove(w)
                if not self._waiters[lane]:
                    del self._waiters[lane]
                self.queued[lane] = self.queued.get(lane, 1) - 1
                ADMISSION_QUEUED.set(sum(self.queued.values()))
            self.running[lane] = self.running.get(lane, 0) + 1
            ADMISSION_RUNNING.set(sum(self.running.values()))
            wait_ms = (time.monotonic() - w.t0) * 1000.0
            self.queue_wait_ms_total += wait_ms
            self.admitted_total += 1
            ADMISSION_ADMITTED.inc()
            ADMISSION_QUEUE_WAIT_MS.inc(int(wait_ms))
            if ctx is not None:
                ctx.queue_wait_ms += wait_ms
                self._running_ctxs.setdefault(lane, {})[w.seq] = (prio, ctx)
            # several slots may be free (limit raised, batch release):
            # wake the rest so the next head can claim its slot too
            self._lock.notify_all()
            return w.seq

    def _release_lane(self, lane: str, seq):
        with self._lock:
            self.running[lane] = max(self.running.get(lane, 1) - 1, 0)
            ADMISSION_RUNNING.set(sum(self.running.values()))
            rc = self._running_ctxs.get(lane)
            if rc is not None:
                rc.pop(seq, None)
                if not rc:
                    del self._running_ctxs[lane]
            self._lock.notify_all()

    # --- admission -----------------------------------------------------------
    def admit(self, group_name: Optional[str], est_scan_rows: int = 0,
              est_scan_bytes: int = 0):
        """Admission check for one query. Returns an IDEMPOTENT zero-arg
        release callable — call it from a finally, and/or register it on
        the query context's cleanup stack (`admission()` below packages
        both). Raises AdmissionError on big-query rejection or slot-queue
        timeout; a query KILLed while queued unblocks within ~100ms via
        its lifecycle checkpoint."""
        fail_point("workgroup::admit")
        g = self.get(group_name) if group_name else None
        global_limit = int(config.get("query_queue_concurrency") or 0)
        if g is None and not global_limit:
            return lambda: None
        if g is not None and g.max_scan_rows \
                and est_scan_rows > g.max_scan_rows:
            with self._lock:
                self.rejected_total += 1
            ADMISSION_REJECTED.inc()
            raise AdmissionError(
                f"query scans ~{est_scan_rows} rows, over resource group "
                f"{g.name!r} big-query limit {g.max_scan_rows} "
                "(reference: big_query_scan_rows_limit)")
        if g is not None and g.mem_limit_bytes \
                and est_scan_bytes > g.mem_limit_bytes:
            with self._lock:
                self.rejected_total += 1
            ADMISSION_REJECTED.inc()
            raise AdmissionError(
                f"query reads ~{est_scan_bytes} bytes, over resource group "
                f"{g.name!r} memory limit {g.mem_limit_bytes}")
        throttled_group = g is not None and g.concurrency_limit > 0
        if not throttled_group and not global_limit:
            return lambda: None
        from . import lifecycle

        ctx = lifecycle.current()
        prio = float(g.priority) if g is not None else 0.0
        aging = float(config.get("query_queue_aging_s") or 0.0)
        hint_s = float(config.get("query_queue_preempt_hint_s") or 0.0)
        deadline = time.monotonic() + float(
            config.get("query_queue_timeout_s"))
        acquired: list = []
        released = [False]

        def release():
            if released[0]:
                return
            released[0] = True
            for lane, seq in reversed(acquired):
                self._release_lane(lane, seq)

        try:
            # consistent acquisition order (global, then group) keeps the
            # two lanes cycle-free — concur_check/lockdep watch the mutex,
            # this comment documents the slot order
            if global_limit:
                seq = self._acquire_lane(GLOBAL_LANE, prio, deadline, aging,
                                         hint_s, ctx)
                if seq is not None:
                    acquired.append((GLOBAL_LANE, seq))
            if throttled_group:
                seq = self._acquire_lane(g.name, prio, deadline, aging,
                                         hint_s, ctx)
                if seq is not None:
                    acquired.append((g.name, seq))
        except BaseException:
            release()
            raise
        return release

    @contextlib.contextmanager
    def admission(self, group_name: Optional[str], est_scan_rows: int = 0,
                  est_scan_bytes: int = 0):
        """Exception-safe admission: the slot releases on ANY exit path,
        including exits that never reach a caller's finally (the round-9
        slot-leak class). Also registers the release on the active query
        context so a KILL unwinding the scope releases it too — release is
        idempotent, so double-calling is safe."""
        release = self.admit(group_name, est_scan_rows, est_scan_bytes)
        try:
            # context registration sits INSIDE the try: a raise from the
            # lifecycle import or the cleanup-stack append must release
            # the slot too, not leak it (effects_check contract 1)
            from . import lifecycle

            ctx = lifecycle.current()
            if ctx is not None:
                ctx.on_exit(release)
            yield release
        finally:
            release()

    # --- introspection -------------------------------------------------------
    def snapshot(self):
        with self._lock:
            return [
                (g.name, g.concurrency_limit, g.max_scan_rows,
                 g.mem_limit_bytes, g.cpu_weight, g.priority,
                 self.running.get(g.name, 0), self.queued.get(g.name, 0))
                for g in sorted(self.groups.values(), key=lambda g: g.name)
            ]

    def queue_stats(self) -> dict:
        """Aggregate lane stats (serve_bench + stress tests): admitted /
        timed-out counts, cumulative queue wait, live running/queued."""
        with self._lock:
            return {
                "admitted": self.admitted_total,
                "timeout": self.timeout_total,
                "rejected": self.rejected_total,
                "queue_wait_ms": self.queue_wait_ms_total,
                "running": sum(self.running.values()),
                "queued": sum(self.queued.values()),
            }
