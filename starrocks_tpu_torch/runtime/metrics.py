"""Metric registry with Prometheus text rendering.

Reference behavior: be/src/base/metrics.h:354 (MetricRegistry + typed
counters/gauges, Prometheus endpoint http/action/metrics_action.h) and FE
MetricRepo.java:120. Process-wide registry; the HTTP surface can serve
`render_prometheus()` verbatim.

Lock discipline (analysis/concur_check.py enforces the annotations): the
registry's get-or-create is the classic two-threads-mint-two-instances
race — both see the miss, both construct, and increments split across
divergent Counter objects (one of which the registry then forgets). All
`_metrics` access happens under `_lock`; per-metric `_v` is guarded by
the metric's own `_lock`, including reads via `value`, so a scrape never
sees a torn read ordering against `inc`.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

from .. import lockdep


class Counter:
    def __init__(self, name, help_=""):
        self.name = name
        self.help = help_
        self._lock = lockdep.lock("Counter._lock")
        self._v = 0  # guarded_by: _lock

    def inc(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        with self._lock:
            return self._v


class Gauge(Counter):
    def set(self, v):
        with self._lock:
            self._v = v


# Latency-style default buckets (milliseconds): sub-ms fast-path hits up
# through multi-second compile storms. Finite upper bounds only; +Inf is
# implicit (the _count series).
DEFAULT_BUCKETS_MS = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000)


class Histogram:
    """Fixed-bucket histogram with Prometheus exposition semantics:
    cumulative `_bucket{le=...}` series plus `_sum`/`_count`. Buckets are
    immutable after construction, so `observe` is one bisect + two adds
    under the metric's own lock."""

    def __init__(self, name, help_="", buckets=DEFAULT_BUCKETS_MS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = lockdep.lock("Histogram._lock")
        self._counts = [0] * (len(self.buckets) + 1)  # guarded_by: _lock
        self._sum = 0.0  # guarded_by: _lock
        self._n = 0      # guarded_by: _lock

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    def snapshot(self):
        """(per-bucket counts incl. +Inf, sum, count) — one consistent read."""
        with self._lock:
            return list(self._counts), self._sum, self._n

    @property
    def value(self):
        with self._lock:
            return self._n

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (0..1) by linear interpolation inside the
        owning bucket (the Prometheus histogram_quantile estimator). The
        open +Inf bucket clamps to the largest finite bound."""
        counts, _, n = self.snapshot()
        if n == 0:
            return 0.0
        rank = q * n
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo = self.buckets[i - 1] if i > 0 else 0.0
            hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
            if cum + c >= rank:
                return lo + (hi - lo) * max(rank - cum, 0.0) / c
            cum += c
        return self.buckets[-1]

    def render(self) -> list:
        counts, s, n = self.snapshot()
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} histogram")
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            le = f"{b:g}"
            out.append(f'{self.name}_bucket{{le="{le}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {n}')
        out.append(f"{self.name}_sum {s:g}")
        out.append(f"{self.name}_count {n}")
        return out


class MetricRegistry:
    def __init__(self):
        self._lock = lockdep.lock("MetricRegistry._lock")
        self._metrics: dict = {}  # guarded_by: _lock

    def _get_or_create(self, name: str, cls, help_: str):
        # one atomic get-or-create: two threads registering the same name
        # concurrently must receive the SAME instance (the unlocked
        # setdefault constructed a throwaway instance per caller, and a
        # plain get/insert pair could publish two)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_)
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, Counter, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets=DEFAULT_BUCKETS_MS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Histogram(name, help_, buckets)
            return m

    def snapshot_values(self) -> dict:
        """One consistent-enough pass over every registered metric:
        name -> ("counter"|"gauge", value) or ("histogram", (p50, p95,
        p99, count, sum)). The registry lock covers only the listing;
        each metric's own lock covers its read (same discipline as
        render_prometheus)."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = {}
        for name, m in items:
            if isinstance(m, Histogram):
                _, s, n = m.snapshot()
                out[name] = ("histogram",
                             (m.percentile(0.5), m.percentile(0.95),
                              m.percentile(0.99), n, s))
            elif isinstance(m, Gauge):
                out[name] = ("gauge", m.value)
            else:
                out[name] = ("counter", m.value)
        return out

    def render_prometheus(self) -> str:
        with self._lock:
            items = sorted(self._metrics.items())
        out = []
        for name, m in items:  # m.value takes the metric's own lock
            if isinstance(m, Histogram):
                out.extend(m.render())
                continue
            kind = "gauge" if isinstance(m, Gauge) else "counter"
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {kind}")
            out.append(f"{name} {m.value}")
        return "\n".join(out) + "\n"


metrics = MetricRegistry()

QUERIES_TOTAL = metrics.counter("sr_tpu_queries_total", "queries executed")
QUERY_ERRORS = metrics.counter("sr_tpu_query_errors_total", "queries failed")
ROWS_RETURNED = metrics.counter("sr_tpu_rows_returned_total", "result rows")
RECOMPILES = metrics.counter(
    "sr_tpu_capacity_recompiles_total", "adaptive capacity recompiles"
)
PROGRAM_COMPILES = metrics.counter(
    "sr_tpu_program_compiles_total",
    "fresh program traces (cache misses across local/batched/hybrid paths)"
)
ROWS_LOADED = metrics.counter("sr_tpu_rows_loaded_total", "rows ingested")


class MetricsHistory:
    """Fixed-capacity time-series ring over the registry: each sample
    holds counter DELTAS since the previous sample, gauge values, and
    histogram p50/p95/p99 estimates — the "what did the metrics look
    like five minutes ago" surface (`information_schema.metrics_history`,
    `GET /api/metrics/history`, serve_bench trajectory reporting).

    A daemon sampler thread fills the ring every
    `metrics_history_interval_s`; `ensure_started()` is idempotent and
    called from the HTTP/serving entry points, so pure-library use never
    pays for a thread. Bounded by `metrics_history_capacity` samples
    (defaults: 5s x 120 = ~10 minutes)."""

    def __init__(self, registry: MetricRegistry, capacity: int = 120):
        self._registry = registry
        self._lock = lockdep.lock("MetricsHistory._lock")
        self._cap = int(capacity)    # guarded_by: _lock
        self._ring: deque = deque()  # guarded_by: _lock
        self._prev: dict = {}        # guarded_by: _lock — counters at last sample
        self._thread = None          # guarded_by: _lock
        # internally synchronized; replaced only under _lock (restart)
        self._stop = threading.Event()  # lint: unguarded-ok

    def set_capacity(self, n: int):
        with self._lock:
            self._cap = max(int(n), 1)
            while len(self._ring) > self._cap:
                self._ring.popleft()

    def sample(self):
        """Take one sample now (the sampler thread's body; tests call it
        directly for determinism)."""
        vals = self._registry.snapshot_values()  # registry locks, not ours
        ts = time.time()
        with self._lock:
            counters, gauges, hists, nxt = {}, {}, {}, {}
            for name, (kind, v) in vals.items():
                if kind == "counter":
                    nxt[name] = v
                    d = v - self._prev.get(name, 0)
                    if d:
                        counters[name] = d
                elif kind == "gauge":
                    gauges[name] = v
                else:
                    p50, p95, p99, n, s = v
                    hists[name] = {"p50": round(p50, 3),
                                   "p95": round(p95, 3),
                                   "p99": round(p99, 3), "count": n}
            self._prev = nxt
            sample = {"ts": ts, "counters": counters,
                      "gauges": gauges, "histograms": hists}
            self._ring.append(sample)
            while len(self._ring) > self._cap:
                self._ring.popleft()
        # the alert engine rides the sampler tick but runs AFTER the ring
        # lock drops (it takes its own leaf lock and may emit events);
        # evaluate() never raises
        from .alerts import ALERTS

        ALERTS.evaluate(sample, ts)

    def snapshot(self, limit: int | None = None) -> list:
        """Newest-last samples (shallow copies)."""
        with self._lock:
            rows = [dict(e) for e in self._ring]
        return rows[-limit:] if limit else rows

    def ensure_started(self):
        """Idempotently start the sampler thread (no-op when disabled).
        The first sample is taken synchronously by the new thread, so a
        scrape right after server start already sees history."""
        from .config import config

        if not config.get("enable_metrics_history"):
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="sr-tpu-metrics-history", daemon=True)
            self._thread.start()

    def _run(self):
        from .config import config

        while not self._stop.is_set():
            try:
                self.sample()
            except Exception:  # noqa: BLE001  # lint: swallow-ok — the sampler must survive scrape races
                pass
            interval = float(
                config.get("metrics_history_interval_s") or 5.0)
            self._stop.wait(max(interval, 0.05))

    def stop(self):
        """Tests only: stop the sampler and keep the ring."""
        with self._lock:
            t = self._thread
            self._thread = None
        self._stop.set()
        if t is not None:
            t.join(timeout=2)

    def clear(self):
        """Tests only."""
        with self._lock:
            self._ring.clear()
            self._prev = {}


HISTORY = MetricsHistory(metrics)


def _define_history_knobs():
    # late import: config never imports metrics, but keeping the
    # dependency out of the module header keeps the core registry usable
    # from config-free contexts (unit tests, tools)
    from .config import config

    config.define("enable_metrics_history", True, True,
                  "run the metrics-history sampler thread when a serving "
                  "surface starts (HTTP/serving tier)")
    config.define("metrics_history_interval_s", 5.0, True,
                  "seconds between metrics-history samples")
    config.define("metrics_history_capacity", 120, True,
                  "bounded sample count of the metrics-history ring "
                  "(default ~10 minutes at the default interval)")
    config.on_set("metrics_history_capacity", HISTORY.set_capacity)


_define_history_knobs()
