"""Stuck-query watchdog: detection-only flagging of wedged statements.

Reference behavior: the FE's slow-query / hung-fragment reporting —
an operator should learn that a query is stuck BEFORE a user escalates,
without the engine guessing at kills (a long query is not a wrong
query; KILL stays a human/admin decision — this thread NEVER cancels).

A daemon thread (same idempotent `ensure_started` pattern as
`MetricsHistory`) scans `lifecycle.REGISTRY.snapshot()` every
`watchdog_interval_s` and emits ONE `query_stuck` event per
(query, stage) when either trigger trips:

- class-latency trigger: the query's elapsed wall time exceeds
  `watchdog_p99_factor` x its statement class's p99 from the workload
  aggregator (runtime/workload.py) — but only once that class has
  `watchdog_min_class_obs` observations, and never under
  `watchdog_min_ms` (cold aggregators and sub-second classes must not
  page anyone);
- stage-wedge trigger: the query has sat at ONE stage checkpoint for
  longer than `watchdog_stage_budget_s` — catches queries that are
  technically advancing their clock but not their work.

`scan()` is directly callable (tests drive it with a fake clock);
tracking state is pruned to the currently-running set every scan, so
the watchdog's memory is bounded by the registry's."""

from __future__ import annotations

import threading
import time

from .. import lockdep
from .config import config

config.define("enable_watchdog", True, True,
              "run the stuck-query watchdog thread when a serving "
              "surface starts (detection only: emits query_stuck "
              "events, never kills)")
config.define("watchdog_interval_s", 5.0, True,
              "seconds between stuck-query watchdog scans")
config.define("watchdog_p99_factor", 10.0, True,
              "flag a RUNNING query once its elapsed time exceeds this "
              "many multiples of its statement class's workload p99")
config.define("watchdog_min_ms", 10000, True,
              "never flag a query younger than this many milliseconds "
              "(guards cold workload stats and sub-second classes)")
config.define("watchdog_stage_budget_s", 30.0, True,
              "flag a RUNNING query wedged at one stage checkpoint for "
              "longer than this many seconds")
config.define("watchdog_min_class_obs", 20, True,
              "workload observations a statement class needs before its "
              "p99 participates in stuck detection")


class StuckQueryWatchdog:
    """Bounded scan state over the running-query registry. The scan
    consults the workload aggregator under its own lock (a one-way
    edge: nothing in workload/metrics ever calls back into the
    watchdog); event emission happens outside it."""

    def __init__(self):
        self._lock = lockdep.lock("StuckQueryWatchdog._lock")
        self._stage_seen: dict = {}  # guarded_by: _lock — qid -> (stage, ts)
        self._flagged: set = set()   # guarded_by: _lock — (qid, stage)
        self._thread = None          # guarded_by: _lock
        # internally synchronized; replaced only under _lock (restart)
        self._stop = threading.Event()  # lint: unguarded-ok

    def scan(self, now: float | None = None) -> list:
        """One watchdog pass; returns the events it emitted as
        [(qid, stage, reason)] (tests assert on the return value).
        Runs off the query path: config.get here is fine (no cache-key
        read window ever opens on this thread)."""
        from .lifecycle import REGISTRY, statement_class
        from .workload import WORKLOAD

        now = float(now if now is not None else time.monotonic())
        factor = float(config.get("watchdog_p99_factor") or 0.0)
        min_ms = float(config.get("watchdog_min_ms") or 0.0)
        stage_budget_s = float(
            config.get("watchdog_stage_budget_s") or 0.0)
        min_obs = int(config.get("watchdog_min_class_obs") or 1)
        running = REGISTRY.snapshot()
        stuck = []
        with self._lock:
            live = set()
            for qid, _user, state, elapsed_ms, _grp, _mem, stage, sql \
                    in running:
                if state != "running":
                    continue
                live.add(qid)
                reason = None
                if factor > 0 and elapsed_ms >= min_ms:
                    cls = statement_class(sql)
                    p99, n = WORKLOAD.class_p99(cls)
                    if n >= min_obs and p99 > 0 \
                            and elapsed_ms > factor * p99:
                        reason = "class_p99"
                seen = self._stage_seen.get(qid)
                if seen is None or seen[0] != stage:
                    self._stage_seen[qid] = (stage, now)
                elif (reason is None and stage_budget_s > 0
                        and now - seen[1] > stage_budget_s):
                    reason = "stage_wedged"
                if reason is not None \
                        and (qid, stage) not in self._flagged:
                    self._flagged.add((qid, stage))
                    stuck.append((qid, stage, reason, elapsed_ms))
            # prune to the running set: finished queries free their state
            for qid in list(self._stage_seen):
                if qid not in live:
                    del self._stage_seen[qid]
            self._flagged = {(q, s) for q, s in self._flagged
                             if q in live}
        from . import events

        for qid, stage, reason, elapsed_ms in stuck:
            events.emit("query_stuck", qid=int(qid), stage=stage,
                        reason=reason, elapsed_ms=int(elapsed_ms))
        return [(q, s, r) for q, s, r, _ in stuck]

    def ensure_started(self):
        """Idempotently start the scanner thread (no-op when disabled)."""
        if not config.get("enable_watchdog"):
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="sr-tpu-watchdog", daemon=True)
            self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            interval = float(config.get("watchdog_interval_s") or 5.0)
            self._stop.wait(max(interval, 0.05))
            if self._stop.is_set():
                return
            try:
                self.scan()
            except Exception:  # noqa: BLE001  # lint: swallow-ok — the watchdog must survive scan races
                pass

    def stop(self):
        """Tests only: stop the scanner and keep the state."""
        with self._lock:
            t = self._thread
            self._thread = None
        self._stop.set()
        if t is not None:
            t.join(timeout=2)

    def stats(self) -> dict:
        with self._lock:
            return {"tracked": len(self._stage_seen),
                    "flagged": len(self._flagged),
                    "running": self._thread is not None
                    and self._thread.is_alive()}

    def clear(self):
        """Tests only."""
        with self._lock:
            self._stage_seen.clear()
            self._flagged.clear()


WATCHDOG = StuckQueryWatchdog()
