"""Process-wide system event journal: the fleet-level "what happened"
surface (reference behavior: FE SHOW PROC-style event/health views and
the BE's system-event logging — SURVEY §1's "what ran, what degraded").

A CLOSED taxonomy of typed events, emitted from the existing notable
sites in store/serving/workgroup/cluster/feedback/lifecycle/failpoint,
journaled into one bounded in-memory ring with per-type counters.
Surfaces: `information_schema.events`, `GET /api/events`, and the
`ADMIN DIAGNOSE` bundle (runtime/audit.py).

Design constraints (the hot-path contract):

- `emit()` never reads config (a failpoint can fire inside a cache-key
  read-audit window — a config.get here would register as a key
  escapee); the ring capacity is pushed in by an `on_set` hook instead.
- The journal lock is a LEAF: emit() takes only its own lock (plus the
  per-metric counter lock), so call sites may emit while holding their
  own locks without creating witness edges back into the engine.
- Unknown event names raise: the taxonomy is the contract, enforced
  dynamically here and statically by `tools/src_lint.py` R9 (event
  emission is pinned to `events.emit(<literal in TAXONOMY>)`).
"""

from __future__ import annotations

import time
from collections import deque

from .. import lockdep
from .config import config
from .metrics import metrics

# The closed event taxonomy. Adding an entry here is an API change:
# src_lint R9 statically re-parses this literal and pins every
# `events.emit(...)` call site to it.
TAXONOMY = frozenset((
    "compaction",            # storage/store.py — rowsets merged
    "checkpoint",            # storage/store.py — journal image + truncate
    "cache_evict_pressure",  # cache/query_cache.py — LRU evictions on put
    "preempt_hint",          # runtime/workgroup.py — soft-degrade nudge
    "soft_mem_degrade",      # runtime/lifecycle.py — soft limit crossed
    "failpoint_trigger",     # runtime/failpoint.py — armed site fired
    "heartbeat_loss",        # runtime/cluster.py — first failed beat
    "heartbeat_reconnect",   # runtime/cluster.py — beat after failures
    "gate_writer_stall",     # runtime/serving.py — writer waited on gate
    "feedback_band_move",    # runtime/feedback.py — band-tier transition
    "plan_regression",       # runtime/sentinel.py — feedback quarantined
    "query_stuck",           # runtime/watchdog.py — RUNNING query flagged
    "alert_fire",            # runtime/alerts.py — alert rule fired
    "alert_resolve",         # runtime/alerts.py — alert rule resolved
    "ingest_commit",         # ingest/plane.py — micro-batch made visible
    "ingest_backpressure",   # ingest/plane.py — staging over budget (429)
    "ingest_job_error",      # ingest/poller.py — routine-load poll failed
))

config.define("events_ring_size", 512, True,
              "bounded capacity of the in-memory system-event ring "
              "(information_schema.events / GET /api/events); oldest "
              "entries drop first")

EVENTS_TOTAL = metrics.counter(
    "sr_tpu_events_total", "system events journaled (all types)")


class EventJournal:
    """Bounded ring + per-type counters over the closed taxonomy."""

    def __init__(self, capacity: int = 512):
        self._lock = lockdep.lock("EventJournal._lock")
        self._cap = int(capacity)   # guarded_by: _lock
        self._ring: deque = deque()  # guarded_by: _lock
        self._counts: dict = {}      # guarded_by: _lock
        self._seq = 0                # guarded_by: _lock

    def set_capacity(self, n: int):
        with self._lock:
            self._cap = max(int(n), 1)
            while len(self._ring) > self._cap:
                self._ring.popleft()

    def emit(self, name: str, **fields):
        """Journal one event. `name` must be in TAXONOMY; `fields` are
        small JSON-able details (table, qid, waited_ms, ...)."""
        if name not in TAXONOMY:
            raise ValueError(f"unknown event type {name!r} "
                             f"(closed taxonomy: see runtime/events.py)")
        ts = time.time()
        with self._lock:
            self._seq += 1
            self._counts[name] = self._counts.get(name, 0) + 1
            self._ring.append(
                {"seq": self._seq, "ts": ts, "name": name,
                 "detail": dict(fields)})
            while len(self._ring) > self._cap:
                self._ring.popleft()
        EVENTS_TOTAL.inc()

    def snapshot(self, limit: int | None = None) -> list:
        """Newest-last list of journaled events (dict copies)."""
        with self._lock:
            rows = [dict(e) for e in self._ring]
        return rows[-limit:] if limit else rows

    def stats(self) -> dict:
        """Per-type lifetime counts (survive ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def clear(self):
        """Tests only: drop the ring AND the per-type counts."""
        with self._lock:
            self._ring.clear()
            self._counts.clear()
            self._seq = 0


# No config.get at import: the first emit can lazily import this module
# from inside a cache-key read-audit window, and a recorded read here
# would register as a key escapee. on_set re-applies a non-default value.
EVENTS = EventJournal(512)
config.on_set("events_ring_size", EVENTS.set_capacity)


def emit(name: str, **fields):
    """The one sanctioned emission entry point (src_lint R9 pins call
    sites to `events.emit(<taxonomy literal>)`)."""
    EVENTS.emit(name, **fields)
