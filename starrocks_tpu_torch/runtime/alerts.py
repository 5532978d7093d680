"""Declarative alert rules over the metrics-history sampler tick.

Reference behavior: the FE's metric-driven alerting hooks (MetricRepo +
external rule evaluation) — here evaluated IN-PROCESS so a single-binary
deployment still gets operator-grade "something is wrong" signals
without a Prometheus stack. `MetricsHistory.sample()` calls
`ALERTS.evaluate(sample, ts)` after releasing its ring lock; each rule
is a threshold or ratio condition over that sample:

- counters evaluate on their PER-SAMPLE DELTA (the sample already
  carries deltas; an absolute total is rarely what an operator means);
- gauges evaluate on their value;
- histograms evaluate on a percentile, spelled `name:p50|p95|p99`;
- ratio rules divide two counter deltas (`metric` / `denom`) and only
  evaluate once the denominator's delta reaches `min_denom` — an error
  RATE alert must not fire on 1 error out of 1 statement.

Fire/resolve hysteresis: the condition must hold for `for_s` continuous
seconds to fire (`alert_fire` event) and stay false for `resolve_s`
continuous seconds to resolve (`alert_resolve` event) — flapping
metrics produce one alert, not a stream. Rules are managed at runtime
via `ADMIN SET alert '<name>' = '<json spec>'` ('off' removes) and
surfaced as `information_schema.alerts`, `GET /api/alerts`, and the
`ADMIN DIAGNOSE` bundle.

`evaluate()` never raises (the sampler thread must survive anything)
and never reads config — the enable flag is pushed via `config.on_set`.
"""

from __future__ import annotations

import json
import time

from .. import lockdep
from .config import config

config.define("enable_alerts", True, True,
              "evaluate alert rules on every metrics-history sample "
              "(information_schema.alerts, /api/alerts)")

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_MAX_RULES = 64

# rules every deployment starts with: the four failure modes the round-18
# observability review called out as "visible only after the fact". All
# metric names are verified against the registry's declarations.
DEFAULT_RULES = {
    "memory_pressure": {
        "metric": "sr_tpu_mem_soft_degraded_total", "op": ">",
        "threshold": 0, "for_s": 0.0,
        "help": "queries crossed the soft memory limit this sample"},
    "admission_backlog": {
        "metric": "sr_tpu_admission_queued", "op": ">",
        "threshold": 8, "for_s": 10.0,
        "help": "sustained resource-group admission queue"},
    "heartbeat_loss": {
        "metric": "sr_tpu_cluster_workers_dead", "op": ">",
        "threshold": 0, "for_s": 0.0,
        "help": "a cluster worker stopped heartbeating"},
    "error_rate": {
        "metric": "sr_tpu_query_errors_total", "op": ">",
        "denom": "sr_tpu_queries_total", "min_denom": 5,
        "threshold": 0.5, "for_s": 10.0,
        "help": "over half the statements in a sample window failed"},
}


def _validate(spec: dict) -> dict:
    """Normalize + validate one rule spec (raises ValueError)."""
    if not isinstance(spec, dict):
        raise ValueError("alert spec must be a JSON object")
    out = {}
    metric = spec.get("metric")
    if not metric or not isinstance(metric, str):
        raise ValueError("alert spec needs a 'metric' name")
    out["metric"] = metric
    op = spec.get("op", ">")
    if op not in _OPS:
        raise ValueError(f"alert op {op!r}: expected one of {sorted(_OPS)}")
    out["op"] = op
    try:
        out["threshold"] = float(spec["threshold"])
    except (KeyError, TypeError, ValueError):
        raise ValueError("alert spec needs a numeric 'threshold'") from None
    out["for_s"] = max(float(spec.get("for_s", 0.0) or 0.0), 0.0)
    out["resolve_s"] = max(
        float(spec.get("resolve_s", out["for_s"]) or 0.0), 0.0)
    if spec.get("denom"):
        out["denom"] = str(spec["denom"])
        out["min_denom"] = max(float(spec.get("min_denom", 1) or 1), 1.0)
    if spec.get("help"):
        out["help"] = str(spec["help"])[:256]
    return out


def _metric_value(name: str, sample: dict):
    """Resolve one metric reference against a history sample. Histogram
    percentiles are `name:p99`; counters read their per-sample delta
    (absent = 0 — the sample only carries non-zero deltas)."""
    if ":" in name:
        base, q = name.rsplit(":", 1)
        h = sample.get("histograms", {}).get(base)
        if h is None or q not in ("p50", "p95", "p99"):
            return None
        return float(h[q])
    gauges = sample.get("gauges", {})
    if name in gauges:
        return float(gauges[name])
    hists = sample.get("histograms", {})
    if name in hists:
        return None  # histogram referenced without a percentile
    return float(sample.get("counters", {}).get(name, 0))


class AlertEngine:
    """Bounded rule set + per-rule fire/resolve state machine. The lock
    is a LEAF; event emission happens outside it."""

    def __init__(self):
        self._lock = lockdep.lock("AlertEngine._lock")
        # name -> {"spec", "firing", "cond_since", "clear_since",
        #          "value", "fired_ts", "fires"}
        self._rules: dict = {}  # guarded_by: _lock
        self._enabled = True    # lint: unguarded-ok — pushed via on_set
        for name, spec in DEFAULT_RULES.items():
            self._rules[name] = self._new_rule(_validate(spec))

    @staticmethod
    def _new_rule(spec: dict) -> dict:
        return {"spec": spec, "firing": False, "cond_since": None,
                "clear_since": None, "value": None, "fired_ts": None,
                "fires": 0}

    # --- management (ADMIN SET alert / tests) --------------------------------
    def set_rule(self, name: str, spec: dict):
        spec = _validate(spec)
        with self._lock:
            if name not in self._rules and len(self._rules) >= _MAX_RULES:
                raise ValueError(
                    f"alert rule cap reached ({_MAX_RULES}); remove one "
                    "first (ADMIN SET alert '<name>' = 'off')")
            self._rules[name] = self._new_rule(spec)

    def remove_rule(self, name: str) -> bool:
        with self._lock:
            return self._rules.pop(name, None) is not None

    def set_from_sql(self, name: str, value: str):
        """The `ADMIN SET alert '<name>' = '<value>'` surface. Values:
        'off'/'disable' removes the rule; anything else must be a JSON
        spec: {"metric": ..., "op": ">", "threshold": N, "for_s": S,
        "denom": ..., "min_denom": N, "resolve_s": S}."""
        v = str(value).strip()
        if v.lower() in ("off", "disable", "disabled"):
            self.remove_rule(name)
            return
        try:
            spec = json.loads(v)
        except ValueError:
            raise ValueError(
                f"bad alert spec for {name!r}: expected 'off' or a JSON "
                "object like {\"metric\": \"sr_tpu_admission_queued\", "
                "\"op\": \">\", \"threshold\": 8, \"for_s\": 10}") from None
        self.set_rule(name, spec)

    # --- evaluation (metrics-history sampler tick) ---------------------------
    def evaluate(self, sample: dict, now: float | None = None):
        """Evaluate every rule against one history sample. NEVER raises —
        this rides the sampler thread. Emits alert_fire/alert_resolve
        outside the engine lock."""
        try:
            if not self._enabled:
                return
            now = float(now if now is not None else time.time())
            fired, resolved = [], []
            with self._lock:
                for name, r in self._rules.items():
                    self._step_locked(name, r, sample, now, fired, resolved)
            from . import events

            for name, value, spec in fired:
                events.emit("alert_fire", alert=name, metric=spec["metric"],
                            value=round(value, 4),
                            threshold=spec["threshold"])
            for name, value, spec in resolved:
                events.emit("alert_resolve", alert=name,
                            metric=spec["metric"],
                            value=None if value is None
                            else round(value, 4))
        except Exception:  # noqa: BLE001  # lint: swallow-ok — the sampler must survive rule bugs
            pass

    def _step_locked(self, name, r, sample, now, fired,
                     resolved):  # lint: holds _lock
        spec = r["spec"]
        value = _metric_value(spec["metric"], sample)
        cond = None
        if value is not None and "denom" in spec:
            den = _metric_value(spec["denom"], sample)
            if den is None or den < spec["min_denom"]:
                value = None  # not enough signal: condition undecidable
            else:
                value = value / den
        r["value"] = value
        if value is not None:
            cond = _OPS[spec["op"]](value, spec["threshold"])
        if cond:
            r["clear_since"] = None
            if r["cond_since"] is None:
                r["cond_since"] = now
            if (not r["firing"]
                    and now - r["cond_since"] >= spec["for_s"]):
                r["firing"] = True
                r["fired_ts"] = now
                r["fires"] += 1
                fired.append((name, value, spec))
        else:
            # an undecidable sample (metric missing / denom too small)
            # counts toward neither side's duration for firing, but DOES
            # clear a pending fire — hysteresis needs continuous signal
            r["cond_since"] = None
            if r["firing"]:
                if cond is False:
                    if r["clear_since"] is None:
                        r["clear_since"] = now
                    if now - r["clear_since"] >= spec["resolve_s"]:
                        r["firing"] = False
                        r["clear_since"] = None
                        resolved.append((name, value, spec))
                else:
                    r["clear_since"] = None

    # --- read surfaces -------------------------------------------------------
    def snapshot(self) -> list:
        """One row per rule (info-schema / HTTP / bundle), firing first,
        then by name."""
        with self._lock:
            rows = [
                {"name": name, "state": "firing" if r["firing"] else "ok",
                 "metric": r["spec"]["metric"],
                 "condition": "{} {} {:g}".format(
                     r["spec"]["metric"], r["spec"]["op"],
                     r["spec"]["threshold"])
                 + (" (/ {})".format(r["spec"]["denom"])
                    if "denom" in r["spec"] else ""),
                 "for_s": r["spec"]["for_s"],
                 "value": r["value"], "fired_ts": r["fired_ts"],
                 "fires": r["fires"],
                 "help": r["spec"].get("help", "")}
                for name, r in self._rules.items()]
        return sorted(rows, key=lambda x: (x["state"] != "firing",
                                           x["name"]))

    def active(self) -> list:
        """Names of currently-firing alerts (diagnostic bundle)."""
        return [r["name"] for r in self.snapshot() if r["state"] == "firing"]

    def stats(self) -> dict:
        with self._lock:
            return {"rules": len(self._rules),
                    "firing": sum(1 for r in self._rules.values()
                                  if r["firing"]),
                    "fires": sum(r["fires"] for r in self._rules.values())}

    def reset(self):
        """Tests only: restore the default rule set and clear state."""
        with self._lock:
            self._rules = {name: self._new_rule(_validate(spec))
                           for name, spec in DEFAULT_RULES.items()}


ALERTS = AlertEngine()

config.on_set("enable_alerts",
              lambda v: setattr(ALERTS, "_enabled", bool(v)))
