"""Process-wide metric registry: counters, gauges and histograms.

Reference behavior: be/src/base/metrics.h:354 (MetricRegistry + typed
counters/gauges) and FE MetricRepo.java:120. A part of the JAX package's
runtime/metrics.py: `Counter`, `Gauge`, `Histogram` and `MetricRegistry`,
which the spill executors (`SPILL_PARTS_LIVE`), the query cache, the plan
feedback store and the executor's recompile counter use. The metrics
history sampler and the Prometheus text rendering belong to the
observability plane (slice 8). Locks are plain threading.Locks.
"""

from __future__ import annotations

import bisect
import threading


class Counter:
    def __init__(self, name, help_=""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
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
        self._lock = threading.Lock()
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


class MetricRegistry:
    def __init__(self):
        self._lock = threading.Lock()
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


metrics = MetricRegistry()
