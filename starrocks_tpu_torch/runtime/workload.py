"""Workload intelligence: derived per-(plan-fingerprint, statement-class)
rolling statistics over the audit stream (reference behavior: FE
big-query-log / workload analysis riding the audit plugin — SURVEY §1's
"what does this workload look like", PARITY "History-based optimization").

Round 16/18 left raw telemetry rings (audit, events, metrics history)
that nothing interprets: this module folds every terminal statement into
bounded rolling shapes — count, latency p50/p95/p99 via the existing
`metrics.Histogram`, mean rows, cache/fast-path/point-lane hit ratios,
memory peak, error/kill/timeout counts — the inputs the stuck-query
watchdog (runtime/watchdog.py) and an operator's capacity planning both
need. Surfaces: `SHOW WORKLOAD`, `information_schema.workload_summary`,
`GET /api/workload`, and the `ADMIN DIAGNOSE` bundle.

Hot-path contract (the audit.py discipline, verbatim): `record_query`
runs inside `lifecycle._finalize_observability` on the statement's
critical path, so it stashes `(ctx, ts, ms)` under a leaf lock and every
read surface drains the pending side through `_materialize_locked()` —
fingerprint hashing and histogram folds happen at read time, not per
statement. Knob values arrive through `config.on_set` pushes (a
config.get here could land inside a cache-key read-audit window).
"""

from __future__ import annotations

import hashlib
import re
import time
from collections import deque

from .. import lockdep
from .audit import _HIT_COUNTERS
from .config import config
from .metrics import Histogram

config.define("enable_workload_stats", True, True,
              "fold every terminal statement into the per-fingerprint "
              "workload aggregator (SHOW WORKLOAD, "
              "information_schema.workload_summary, /api/workload)")
config.define("workload_max_entries", 512, True,
              "bounded number of (fingerprint, class) workload entries; "
              "least-recently-updated entries evict first")

# literal scrub for statements that never reached the executor's plan
# fingerprint (DDL, errors before planning, point lane): quoted strings
# first, then standalone numbers — '?' placeholders make repeats of a
# parameterized statement collapse into one shape
_STR_RE = re.compile(r"'(?:[^']|'')*'|\"[^\"]*\"")
_NUM_RE = re.compile(r"\b\d+(?:\.\d+)?\b")
_WS_RE = re.compile(r"\s+")


def sql_shape(sql: str) -> str:
    """Literal-scrubbed, whitespace-collapsed statement text (the
    fallback fingerprint input when no plan fingerprint exists)."""
    s = _STR_RE.sub("?", sql)
    s = _NUM_RE.sub("?", s)
    return _WS_RE.sub(" ", s).strip().lower()


# workload classes are the lifecycle latency classes plus the point and
# ingest-load lanes (their contexts set stmt_class explicitly)
_CLASSES = ("read", "dml", "ddl", "other", "point", "load")


def _new_entry() -> dict:
    return {
        "count": 0, "hist": Histogram("workload_entry_ms"),
        "ms_sum": 0.0, "rows_sum": 0, "mem_peak_bytes": 0,
        "queue_wait_ms_sum": 0.0, "errors": 0, "cancelled": 0,
        "timeouts": 0, "memlimit": 0, "degraded": 0,
        "hits": {col: 0 for _c, col in _HIT_COUNTERS},
        "sample_sql": "", "last_ts": 0.0,
    }


class WorkloadAggregator:
    """Bounded rolling per-(fingerprint, class) statement shapes. The
    lock is a LEAF (taken from the query-scope unwind and the read
    surfaces only); per-entry histograms are unregistered Histogram
    instances, so the Prometheus surface never grows with the workload."""

    def __init__(self):
        self._lock = lockdep.lock("WorkloadAggregator._lock")
        # (fingerprint, stmt_class) -> entry dict; insertion order is the
        # LRU order (re-insert on update)
        self._entries: dict = {}     # guarded_by: _lock
        # per-class aggregate latency (the watchdog's N x p99 input);
        # closed class set, so this dict is hard-bounded
        # lint: unguarded-ok — built once; Histogram locks internally
        self._class_hist = {c: Histogram("workload_class_ms")
                            for c in _CLASSES}
        # terminal contexts awaiting materialization (audit.py pattern)
        self._pending: deque = deque()  # guarded_by: _lock
        self._seq = 0                # guarded_by: _lock
        self._evicted = 0            # guarded_by: _lock
        # knob cache, pushed via config.on_set below  lint: unguarded-ok x2
        self._enabled = True         # lint: unguarded-ok
        self._cap = 512              # lint: unguarded-ok

    def record_query(self, ctx):
        """Stash one terminal context (lifecycle._finalize_observability,
        every exit path). Must stay cheap: the fingerprint hash and the
        entry fold run at read time via _materialize_locked()."""
        if not self._enabled:
            return
        ts = time.time()
        ms = int(ctx.elapsed_ms())
        with self._lock:
            self._seq += 1
            self._pending.append((ctx, ts, ms))
            # a never-read aggregator must not grow without bound
            while len(self._pending) > max(self._cap, 1) * 4:
                self._pending.popleft()
                self._evicted += 1

    def _materialize_locked(self):  # lint: holds _lock
        while self._pending:
            ctx, ts, ms = self._pending.popleft()
            self._fold_locked(ctx, ts, ms)
        while len(self._entries) > max(self._cap, 1):
            del self._entries[next(iter(self._entries))]
            self._evicted += 1

    def _fold_locked(self, ctx, ts, ms):  # lint: holds _lock
        cls = getattr(ctx, "stmt_class", None)
        if not cls:
            from .lifecycle import statement_class

            cls = statement_class(ctx.sql)
        fp = getattr(ctx, "fb_fp", None)
        if not fp:
            fp = "sql:" + hashlib.sha256(
                sql_shape(ctx.sql).encode()).hexdigest()[:24]
        key = (fp, cls)
        e = self._entries.pop(key, None)
        if e is None:
            e = _new_entry()
        e["count"] += 1
        e["hist"].observe(float(ms))
        e["ms_sum"] += float(ms)
        e["rows_sum"] += int(ctx.rows)
        e["mem_peak_bytes"] = max(e["mem_peak_bytes"],
                                  int(getattr(ctx, "mem_peak", 0)))
        e["queue_wait_ms_sum"] += float(ctx.queue_wait_ms)
        state = ctx.state
        if state == "error":
            e["errors"] += 1
        elif state == "cancelled":
            e["cancelled"] += 1
        elif state == "timeout":
            e["timeouts"] += 1
        elif state == "memlimit":
            e["memlimit"] += 1
        if ctx.degraded:
            e["degraded"] += 1
        counters = {}
        if ctx.profile is not None:
            counters = ctx.profile.counters
        for c, col in _HIT_COUNTERS:
            e["hits"][col] += int(bool(counters.get(c, (0, ""))[0]))
        e["sample_sql"] = ctx.sql[:256]
        e["last_ts"] = ts
        self._entries[key] = e  # re-insert = LRU touch
        hist = self._class_hist.get(cls)
        if hist is not None:
            hist.observe(float(ms))

    def snapshot(self, limit: int | None = None) -> list:
        """Workload rows as dicts, heaviest (highest count) first."""
        with self._lock:
            self._materialize_locked()
            items = [(k, self._row_locked(k, e))
                     for k, e in self._entries.items()]
        rows = [r for _k, r in sorted(
            items, key=lambda kr: (-kr[1]["count"], kr[0]))]
        return rows[:limit] if limit else rows

    @staticmethod
    def _row_locked(key, e) -> dict:  # lint: holds _lock
        fp, cls = key
        n = e["count"]
        h = e["hist"]
        row = {
            "fingerprint": fp, "stmt_class": cls, "count": n,
            "p50_ms": round(h.percentile(0.5), 3),
            "p95_ms": round(h.percentile(0.95), 3),
            "p99_ms": round(h.percentile(0.99), 3),
            "avg_ms": round(e["ms_sum"] / n, 3),
            "avg_rows": round(e["rows_sum"] / n, 1),
            "mem_peak_bytes": e["mem_peak_bytes"],
            "avg_queue_wait_ms": round(e["queue_wait_ms_sum"] / n, 3),
            "errors": e["errors"], "cancelled": e["cancelled"],
            "timeouts": e["timeouts"], "memlimit": e["memlimit"],
            "degraded": e["degraded"],
            "last_ts": e["last_ts"], "sample_sql": e["sample_sql"],
        }
        for _c, col in _HIT_COUNTERS:
            row[col + "_ratio"] = round(e["hits"][col] / n, 3)
        return row

    def class_p99(self, cls: str) -> tuple:
        """(p99_ms, observation count) of one statement class — the
        watchdog's stuck threshold input. (0.0, 0) for unknown classes."""
        with self._lock:
            self._materialize_locked()
        h = self._class_hist.get(cls)
        if h is None:
            return 0.0, 0
        return h.percentile(0.99), h.value

    def stats(self) -> dict:
        with self._lock:
            self._materialize_locked()
            return {"entries": len(self._entries), "registered": self._seq,
                    "evicted": self._evicted}

    def clear(self):
        """Tests only."""
        with self._lock:
            self._entries.clear()
            self._pending.clear()
            self._seq = 0
            self._evicted = 0
            for c in _CLASSES:
                self._class_hist[c] = Histogram("workload_class_ms")


WORKLOAD = WorkloadAggregator()

config.on_set("enable_workload_stats",
              lambda v: setattr(WORKLOAD, "_enabled", bool(v)))
config.on_set("workload_max_entries",
              lambda v: setattr(WORKLOAD, "_cap", max(int(v or 1), 1)))
