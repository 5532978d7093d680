"""Structured audit log: every top-level statement's terminal record
(reference behavior: FE `plugin/AuditEvent` / fe.audit.log — the audit
half of NEXT 7e, whose ProfileManager half landed in round 16).

Registered at the SAME query-scope unwind hook the ProfileManager uses
(`lifecycle._finalize_observability`), so every terminal state — done,
error, cancelled (KILL), timeout, memlimit, point-lane — produces
exactly ONE record, including statements reaped from the serving pool
queue before any worker adopted them (`lifecycle.finalize_queued`).

Two sinks, both bounded:

- an in-memory ring (`audit_log_ring` entries) surfaced as
  `information_schema.audit_log` and `GET /api/audit`;
- an optional size-rotated JSONL file (`audit_log_path`): when the
  active file crosses `audit_log_rotate_mb` it is renamed to
  `<path>.1` (replacing the previous generation), so total disk usage
  never exceeds ~2x the rotation threshold.

This module also builds the one-shot diagnostic bundle (`ADMIN
DIAGNOSE` / `GET /api/debug/bundle`): the flight-recorder JSON for
postmortems and chaos triage.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque

from .. import lockdep
from .config import config
from .metrics import metrics

config.define("enable_audit_log", True, True,
              "record every top-level statement's terminal state into "
              "the audit ring (information_schema.audit_log, /api/audit) "
              "and the optional JSONL sink")
config.define("audit_log_ring", 1024, True,
              "bounded capacity of the in-memory audit ring; oldest "
              "records drop first")
config.define("audit_log_path", "", True,
              "JSONL audit sink path ('' disables the file sink; the "
              "in-memory ring is always on while enable_audit_log is)")
config.define("audit_log_rotate_mb", 8, True,
              "rotate the JSONL audit sink once it crosses this size; "
              "one prior generation (<path>.1) is kept, bounding disk "
              "usage at ~2x this value")

AUDIT_RECORDS = metrics.counter(
    "sr_tpu_audit_records_total", "audit records registered")

# profile counter name -> audit hit-flag column: the executor already
# attributes cache/fast-path/feedback reuse per query; the audit row
# compresses each to a 0/1 flag
_HIT_COUNTERS = (
    ("plan_cache_hits", "plan_cache_hit"),
    ("qcache_hits", "result_cache_hit"),
    ("qcache_partial_hits", "partial_cache_hit"),
    ("feedback_hits", "feedback_hit"),
)

# ring entries are flat tuples in this order (a per-record dict build and
# a list-ring's O(n) head trim both showed up in the serve_bench --obs
# point-lane budget); snapshot() materializes dicts for every consumer
_FIELDS = ("seq", "query_id", "ts", "user", "stmt", "stmt_class",
           "tables", "state", "stage", "ms", "queue_wait_ms", "rows",
           "mem_peak_bytes", "degraded", "error") + tuple(
               col for _c, col in _HIT_COUNTERS)


class AuditLog:
    """Bounded audit ring + size-rotated JSONL sink. The lock is a leaf
    (only taken from the query-scope unwind and read surfaces); file I/O
    happens under it so rotation is atomic with respect to appends —
    acceptable because records are small and the unwind is off the
    statement's measured path."""

    def __init__(self):
        self._lock = lockdep.lock("AuditLog._lock")
        self._ring: deque = deque()  # guarded_by: _lock — _FIELDS tuples
        # terminal contexts awaiting materialization: (seq, ctx, ts, ms).
        # The unwind runs on the statement's critical path (the point
        # lane budgets ~100us per lookup), so record_query stashes the
        # four cheap values and every read surface drains the pending
        # side through _materialize_locked() — the ~4us record build
        # happens at read time, not per statement.
        self._pending: deque = deque()  # guarded_by: _lock
        self._seq = 0           # guarded_by: _lock
        self._dropped = 0       # guarded_by: _lock
        # knob cache, pushed via config.on_set (registered below): the
        # record path runs once per statement, and four config.get hops
        # per record measurably taxed the point lane (~2-3us of the <5%
        # serve_bench --obs budget). Plain attrs; a torn read during a
        # concurrent SET only mis-sizes one append. lint: unguarded-ok x4
        self._enabled = True            # lint: unguarded-ok
        self._cap = 1024                # lint: unguarded-ok
        self._path = ""                 # lint: unguarded-ok
        self._rotate_bytes = 8 << 20    # lint: unguarded-ok

    def record_query(self, ctx):
        """Register the terminal record for one query context. Called
        from `lifecycle._finalize_observability` on EVERY exit path;
        must never raise into the unwind (the caller shields it, but
        this path stays minimal regardless). Captures only what is
        time-sensitive (ts, elapsed) — everything else on a terminal
        ctx is stable and read at materialization time."""
        if not self._enabled:
            return
        ts = time.time()
        ms = int(ctx.elapsed_ms())
        with self._lock:
            self._seq += 1
            self._pending.append((self._seq, ctx, ts, ms))
            while len(self._ring) + len(self._pending) > self._cap:
                (self._ring or self._pending).popleft()
                self._dropped += 1
        AUDIT_RECORDS.inc()
        if self._path:
            # a configured durable sink wants records on disk promptly;
            # deferral only serves the default in-memory-ring mode
            with self._lock:
                self._materialize_locked()

    def _materialize_locked(self):  # lint: holds _lock
        """Drain pending terminal contexts into _FIELDS tuples (and the
        JSONL sink, when configured). Runs under the ring lock from the
        read surfaces, so writers stay O(1)."""
        path = self._path
        while self._pending:
            seq, ctx, ts, ms = self._pending.popleft()
            rec = (seq,) + self._build(ctx, ts, ms)
            self._ring.append(rec)
            if path:
                from .failpoint import FailPointError

                try:
                    self._sink_locked(path, self._rotate_bytes, rec)
                except (OSError, FailPointError):
                    pass  # disk hiccup (or injected audit::sink fault):
                    #   the ring still has the record
        while len(self._ring) > self._cap:
            self._ring.popleft()
            self._dropped += 1

    @staticmethod
    def _build(ctx, ts, ms) -> tuple:
        """_FIELDS tuple without the leading seq."""
        counters = {}
        if ctx.profile is not None:
            counters = ctx.profile.counters
        cls = ctx.stmt_class
        if not cls:  # queue-reaped statements die before classification
            from .lifecycle import statement_class

            cls = statement_class(ctx.sql)
        return (
            int(ctx.qid),
            ts,
            ctx.user,
            ctx.sql[:512],
            cls,
            ",".join(getattr(ctx, "tables", ()) or ()),
            ctx.state,
            ctx.last_stage,
            ms,
            int(ctx.queue_wait_ms),
            int(ctx.rows),
            int(getattr(ctx, "mem_peak", 0)),
            int(bool(ctx.degraded)),
            str(getattr(ctx, "error", "")
                or (ctx.cancel_reason() if ctx.state == "cancelled"
                    else "") or "")[:256],
        ) + tuple(int(bool(counters.get(c, (0, ""))[0]))
                  for c, _col in _HIT_COUNTERS)

    def _sink_locked(self, path, rotate_bytes, rec):  # lint: holds _lock  # lint: blocking-ok — the JSONL append is the audit durability contract: the sink must serialize with ring rotation, and writes are one bounded line
        from .failpoint import fail_point

        fail_point("audit::sink")  # injected sink faults degrade exactly
        #   like the disk hiccup below: ring keeps the record
        line = json.dumps(dict(zip(_FIELDS, rec)), default=str) + "\n"
        try:
            if os.path.getsize(path) + len(line) > rotate_bytes:
                os.replace(path, path + ".1")  # drops generation .1
        except OSError:
            pass  # no file yet: first append creates it
        with open(path, "a") as f:
            f.write(line)

    def snapshot(self, limit: int | None = None) -> list:
        """Newest-last audit records, materialized as dicts."""
        with self._lock:
            self._materialize_locked()
            rows = list(self._ring)
        if limit:
            rows = rows[-limit:]
        return [dict(zip(_FIELDS, r)) for r in rows]

    def stats(self) -> dict:
        with self._lock:
            self._materialize_locked()
            return {"retained": len(self._ring), "registered": self._seq,
                    "dropped": self._dropped}

    def flush(self):
        """Materialize pending records (and push them through the JSONL
        sink when configured) without taking a snapshot."""
        with self._lock:
            self._materialize_locked()

    def clear(self):
        """Tests only."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._seq = 0
            self._dropped = 0


AUDIT = AuditLog()

# apply-side hooks keep the knob cache current (and fire immediately when
# a knob was already set to a non-default before this module loaded)
config.on_set("enable_audit_log",
              lambda v: setattr(AUDIT, "_enabled", bool(v)))
config.on_set("audit_log_ring",
              lambda v: setattr(AUDIT, "_cap", max(int(v or 1), 1)))
config.on_set("audit_log_path",
              lambda v: (setattr(AUDIT, "_path", str(v or "")),
                         AUDIT.flush()))  # pending records reach the new sink
config.on_set("audit_log_rotate_mb",
              lambda v: setattr(AUDIT, "_rotate_bytes",
                                max(int(v or 1), 1) << 20))


def diagnostic_bundle(session) -> dict:
    """The one-shot flight-recorder document (`ADMIN DIAGNOSE` and
    `GET /api/debug/bundle`): running queries + stages, recent profiles,
    audit/event tails, metrics history, lock-witness state, cache stats,
    failpoints, and every non-default config knob. Read-only: built
    entirely from existing bounded snapshots, so it is safe to call on a
    live wedged server."""
    from .. import lockdep as _ld
    from . import events, failpoint
    from .alerts import ALERTS
    from .lifecycle import ACCOUNTANT, REGISTRY
    from .metrics import HISTORY
    from .profile import PROFILE_MANAGER
    from .sentinel import SENTINEL
    from .workload import WORKLOAD

    cycles = _ld.WITNESS.order_cycles()
    bundle = {
        "generated_ts": time.time(),
        "running": [
            {"query_id": q[0], "user": q[1], "state": q[2], "ms": q[3],
             "group": q[4], "mem_bytes": q[5], "stage": q[6], "stmt": q[7]}
            for q in REGISTRY.snapshot()],
        "memory": ACCOUNTANT.snapshot(),
        "profiles": [
            {k: e[k] for k in ("query_id", "user", "state", "ms", "stage")}
            for e in PROFILE_MANAGER.snapshot()[-50:]],
        "audit_tail": AUDIT.snapshot(limit=100),
        "audit_stats": AUDIT.stats(),
        # derived-observability plane (round 19): the heaviest workload
        # shapes, every alert rule (firing first), and the sentinel's
        # baseline state — what an operator reads FIRST in a postmortem
        "workload": WORKLOAD.snapshot(limit=20),
        "workload_stats": WORKLOAD.stats(),
        "alerts": ALERTS.snapshot(),
        "alerts_active": ALERTS.active(),
        "sentinel": SENTINEL.stats(),
        "events_tail": events.EVENTS.snapshot(limit=100),
        "event_counts": events.EVENTS.stats(),
        "metrics_history": HISTORY.snapshot(limit=50),
        "lock_witness": {
            "enabled": _ld.enabled(),
            "cycles": len(cycles),
            "render": _ld.WITNESS.render(cycles) if cycles else "",
        },
        "failpoints": failpoint.snapshot(),
        "config_non_default": {
            name: str(value)
            for name, value, default, _m, _d in config.items()
            if value != default},
    }
    cache = getattr(session, "cache", None)
    if cache is not None:
        bundle["cache"] = {
            "qcache_resident_bytes": cache.qcache.resident_bytes,
            "plan_cache": cache.plan_cache.stats(),
        }
        fb = getattr(cache, "feedback", None)
        if fb is not None:
            # fingerprints the plan-regression sentinel has pulled out
            # of planning, with the baselines re-admission must beat
            bundle["feedback_quarantine"] = fb.quarantined()
            bundle["feedback_stats"] = fb.stats()
    return bundle
