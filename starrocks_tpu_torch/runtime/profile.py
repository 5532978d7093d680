"""RuntimeProfile + ProfileManager: the query-profile plane.

Reference behavior: be/src/common/runtime_profile.h:101 (tree of counters and
timers per operator instance, reported to the FE and rendered by
SHOW PROFILE / EXPLAIN ANALYZE) plus the FE's ProfileManager (bounded
in-memory store of recent query profiles behind SHOW PROFILE FOR QUERY and
the HTTP profile actions). In the compiled TPU world per-operator device
timing lives inside one fused XLA program, so the profile tracks the phases
that exist at host level — parse/analyze/optimize/compile (per recompile
attempt)/execute/fetch — plus operator-level attribution riding the
per-ordinal observation channel the plan-feedback loop proved out:
capacity-check totals (`join_{o}`/`agg_{o}`/...) become per-operator
observed rows, `~ctr_<name>@<ordinal>` device counters become per-operator
counter groups, and the trace's node-ordinal table maps them back onto plan
nodes for EXPLAIN ANALYZE.

Every timer also records a wall-clock span, so a retained profile exports
as Chrome `trace_event` JSON (GET /api/query/{id}/trace) and opens directly
in Perfetto.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

from .. import lockdep
from .config import config

config.define("slow_query_ms", 0, True,
              "queries at/above this wall-clock milliseconds land in the "
              "ProfileManager's slow-query ring (0 disables; the FE "
              "big-query audit analog)")
config.define("profile_history_size", 64, True,
              "query profiles retained by the ProfileManager (LRU beyond "
              "this; the FE ProfileManager retention analog)")
config.define("profile_history_bytes", 8 << 20, True,
              "memory budget for retained profiles (rendered text + "
              "structured tree, estimated per entry; LRU eviction)")
config.define("enable_device_profile", False, True,
              "attach each attempt's device milliseconds (CUDA events) and "
              "peak allocated device bytes to its profile (synchronizes "
              "the card around the attempt and resets its peak-memory "
              "gauge; not applicable on the CPU)")


class RuntimeProfile:
    def __init__(self, name: str):
        self.name = name
        self.counters: dict = {}
        self.infos: dict = {}
        self.children: list = []
        # wall-clock spans recorded by timer(): (name, epoch_s, dur_s) —
        # the Chrome trace_event export surface
        self.spans: list = []
        # per-plan-ordinal attribution records (operator view):
        # ordinal -> {"family","rows","capacity","counters",...}
        self.operators: dict = {}
        # plan-node -> ordinal table of the executed program (set by the
        # executor after a run; transient — not serialized)
        self.node_ord: dict | None = None

    def child(self, name: str) -> "RuntimeProfile":
        c = RuntimeProfile(name)
        self.children.append(c)
        return c

    def add_counter(self, name: str, value, unit: str = ""):
        self.counters[name] = (self.counters.get(name, (0, unit))[0] + value, unit)

    def set_info(self, name: str, value):
        self.infos[name] = value

    @contextmanager
    def timer(self, name: str):
        w0 = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self.add_counter(name, dur, "s")
            self.spans.append((name, w0, dur))

    # --- per-operator attribution (plan-ordinal keyed) ----------------------
    def op(self, ordinal: int) -> dict:
        return self.operators.setdefault(int(ordinal), {
            "family": None, "rows": None, "capacity": None, "counters": {}})

    def op_rows(self, ordinal: int, family: str, rows: int, capacity=None):
        rec = self.op(ordinal)
        rec["family"] = family
        rec["rows"] = int(rows)
        if capacity is not None:
            rec["capacity"] = int(capacity)

    def op_counter(self, ordinal: int, name: str, value: int):
        ctrs = self.op(ordinal)["counters"]
        ctrs[name] = ctrs.get(name, 0) + int(value)

    def render(self, indent: int = 0) -> str:
        pad = "  " * indent
        out = [f"{pad}{self.name}:"]
        for k, v in self.infos.items():
            out.append(f"{pad}  - {k}: {v}")
        for k, (v, unit) in sorted(self.counters.items()):
            if unit == "s":
                out.append(f"{pad}  - {k}: {v * 1000:.2f}ms")
            else:
                out.append(f"{pad}  - {k}: {v}{unit}")
        for o in sorted(self.operators):
            rec = self.operators[o]
            parts = [f"op#{o}"]
            if rec.get("family"):
                parts.append(str(rec["family"]))
            if rec.get("rows") is not None:
                parts.append(f"rows={rec['rows']}")
            if rec.get("capacity") is not None:
                parts.append(f"cap={rec['capacity']}")
            if rec.get("counters"):
                parts.append("ctrs{" + " ".join(
                    f"{k}={v}" for k, v in sorted(rec["counters"].items()))
                    + "}")
            out.append(f"{pad}  - " + " ".join(parts))
        for c in self.children:
            out.append(c.render(indent + 1))
        return "\n".join(out)

    def find(self, name: str):
        if self.name == name:
            return self
        for c in self.children:
            r = c.find(name)
            if r is not None:
                return r
        return None

    # --- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        def _j(v):
            if isinstance(v, (int, float, str, bool)) or v is None:
                return v
            if isinstance(v, dict):
                return {str(k): _j(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [_j(x) for x in v]
            return str(v)

        return {
            "name": self.name,
            "infos": {k: _j(v) for k, v in self.infos.items()},
            "counters": {k: [_j(v), u] for k, (v, u) in self.counters.items()},
            "spans": [[n, t, d] for n, t, d in self.spans],
            "operators": {str(o): _j(rec)
                          for o, rec in sorted(self.operators.items())},
            "children": [c.to_dict() for c in self.children],
        }


def trace_events(pdict: dict, pid: int = 1, _path: str = "") -> list:
    """Flatten a serialized profile tree's spans into Chrome trace_event
    'X' (complete) events — microsecond ts/dur, one thread; host phases
    nest naturally in time so a single track renders correctly."""
    path = (_path + "/" + pdict.get("name", "")) if _path \
        else pdict.get("name", "query")
    evts = [{
        "ph": "X", "name": n, "cat": path,
        "ts": int(t * 1e6), "dur": max(int(d * 1e6), 1),
        "pid": pid, "tid": 1,
    } for n, t, d in pdict.get("spans", ())]
    for c in pdict.get("children", ()):
        evts.extend(trace_events(c, pid, path))
    return evts


def trace_json(entry: dict) -> dict:
    """Perfetto-loadable trace for one retained ProfileManager entry:
    the profile tree's spans, plus a synthesized admission-wait span ahead
    of the first recorded phase (queue wait predates the profile's first
    timer by construction)."""
    evts = trace_events(entry.get("profile") or {"spans": []})
    evts.sort(key=lambda e: e["ts"])
    qw = float(entry.get("queue_wait_ms") or 0.0)
    if qw > 0 and evts:
        first = evts[0]["ts"]
        evts.insert(0, {
            "ph": "X", "name": "admission_wait", "cat": "lifecycle",
            "ts": int(first - qw * 1000), "dur": max(int(qw * 1000), 1),
            "pid": 1, "tid": 1,
        })
    meta = {k: entry.get(k) for k in
            ("query_id", "user", "state", "ms", "queue_wait_ms", "stage")}
    meta["sql"] = (entry.get("sql") or "")[:512]
    return {"traceEvents": evts, "displayTimeUnit": "ms",
            "otherData": meta}


def _otel_attr(key, value) -> dict:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def otel_json(entry: dict) -> dict:
    """One retained ProfileManager entry as an OpenTelemetry OTLP/JSON
    ResourceSpans document (`GET /api/query/{id}/otel`): a root SERVER
    span for the statement plus one INTERNAL child span per profile
    phase — POSTable verbatim to a collector's /v1/traces. IDs are
    deterministic functions of the query id (hex-encoded per the OTLP
    JSON mapping; nano timestamps are decimal strings), so the export
    is stable across calls and golden-fixture testable."""
    import hashlib

    qid = int(entry.get("query_id") or 0)
    trace_id = hashlib.sha256(f"sr_tpu_query:{qid}".encode()
                              ).hexdigest()[:32]
    root_id = hashlib.sha256(f"sr_tpu_span:{qid}:root".encode()
                             ).hexdigest()[:16]
    evts = trace_json(entry)["traceEvents"]  # admission_wait included
    if evts:
        t0 = min(e["ts"] for e in evts)
        t1 = max(e["ts"] + e["dur"] for e in evts)
    else:
        t0, t1 = 0, int(entry.get("ms") or 0) * 1000
    state = str(entry.get("state") or "")
    spans = [{
        "traceId": trace_id, "spanId": root_id, "parentSpanId": "",
        "name": "query", "kind": 2,  # SPAN_KIND_SERVER
        "startTimeUnixNano": str(t0 * 1000),
        "endTimeUnixNano": str(max(t1, t0 + 1) * 1000),
        "attributes": [
            _otel_attr("db.system", "starrocks_tpu"),
            _otel_attr("db.statement", (entry.get("sql") or "")[:512]),
            _otel_attr("db.user", entry.get("user") or ""),
            _otel_attr("sr_tpu.query_id", qid),
            _otel_attr("sr_tpu.state", state),
            _otel_attr("sr_tpu.rows", int(entry.get("rows") or 0)),
            _otel_attr("sr_tpu.queue_wait_ms",
                       int(entry.get("queue_wait_ms") or 0)),
            _otel_attr("sr_tpu.stage", entry.get("stage") or ""),
        ],
        "status": ({"code": 1} if state == "done"
                   else {"code": 2, "message": state}),
    }]
    for i, e in enumerate(evts):
        spans.append({
            "traceId": trace_id,
            "spanId": hashlib.sha256(
                f"sr_tpu_span:{qid}:{i}".encode()).hexdigest()[:16],
            "parentSpanId": root_id,
            "name": e["name"], "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(e["ts"] * 1000),
            "endTimeUnixNano": str((e["ts"] + e["dur"]) * 1000),
            "attributes": [_otel_attr("sr_tpu.phase_path", e["cat"])],
            "status": {"code": 0},  # UNSET: phases carry no verdict
        })
    return {"resourceSpans": [{
        "resource": {"attributes": [
            _otel_attr("service.name", "starrocks_tpu"),
            _otel_attr("telemetry.sdk.name", "starrocks_tpu.profile"),
        ]},
        "scopeSpans": [{
            "scope": {"name": "starrocks_tpu.profile", "version": "1"},
            "spans": spans,
        }],
    }]}


# capacity-key family -> logical node class it may annotate
_FAMILY_NODE = {"join": "LJoin", "agg": "LAggregate", "wtop": "LWindow",
                "unnest": "LUnnest"}


def render_explain_analyze(plan, profile: RuntimeProfile, catalog) -> str:
    """EXPLAIN ANALYZE rendering: the executed plan tree, each node
    annotated with its ordinal, estimated vs observed rows, and its
    per-operator counter group; the full profile tree follows. Observed
    rows ride the capacity-check channel, so nodes without a capacity
    (scans, projects) annotate with estimates only."""
    from ..sql.optimizer import estimate_rows

    node_ord = profile.node_ord or {}
    lines = []

    def walk(p, indent):
        ann = ""
        o = node_ord.get(p)
        if o is not None:
            parts = []
            try:
                parts.append(f"est={int(estimate_rows(p, catalog))}")
            except Exception:  # lint: swallow-ok — stats must never fail EXPLAIN
                pass
            rec = profile.operators.get(o)
            # observed-rows records carry the capacity-key family
            # (join/agg/wtop/unnest); only annotate when it matches the
            # node's type, so ordinals from partition sub-programs (the
            # batched spill paths compile a different plan shape) can
            # never mislabel an unrelated node
            fam_ok = rec is not None and (
                rec.get("family") is None
                or _FAMILY_NODE.get(rec["family"]) == type(p).__name__)
            if rec and fam_ok:
                if rec.get("rows") is not None:
                    parts.append(f"rows={rec['rows']}")
                if rec.get("capacity") is not None:
                    parts.append(f"cap={rec['capacity']}")
                if rec.get("counters"):
                    parts.append("ctrs{" + " ".join(
                        f"{k}={v}" for k, v in
                        sorted(rec["counters"].items())) + "}")
            ann = f"   [#{o}" + (" " + " ".join(parts) if parts else "") + "]"
        lines.append("  " * indent + repr(p) + ann)
        for c in p.children:
            walk(c, indent + 1)

    walk(plan, 0)
    return "\n".join(lines) + "\n" + profile.render()


class ProfileManager:
    """Bounded, memory-budgeted process-wide store of finished query
    profiles (the FE ProfileManager analog). Entries key by lifecycle qid
    and hold MATERIALIZED views only (rendered text + serialized tree) —
    never live RuntimeProfile/plan objects, so retention cannot pin plans
    or device buffers. A separate slow-query ring keeps queries at/above
    `slow_query_ms` visible after the LRU evicts them from the main
    history. Both structures are bounded on every insert, so a chaos run
    leaks nothing regardless of how queries die."""

    SLOW_RING = 32

    def __init__(self):
        self._lock = lockdep.lock("ProfileManager._lock")
        self._entries: dict = {}  # guarded_by: _lock — qid -> entry (LRU order)
        self._slow: list = []     # guarded_by: _lock — bounded slow-query ring
        self._bytes = 0           # guarded_by: _lock — estimated retained bytes

    def register(self, *, qid: int, user: str, sql: str, state: str,
                 ms: int, rows: int, queue_wait_ms: float, stage: str,
                 profile: RuntimeProfile | None):
        """Record one finished query (every terminal state, including
        killed/failed — the profile then reports the failed stage). Called
        once per top-level statement from Session.sql's unwind."""
        if not qid:
            return
        slow_ms = int(config.get("slow_query_ms") or 0)
        pdict = profile.to_dict() if profile is not None else None
        text = profile.render() if profile is not None else ""
        entry = {
            "query_id": int(qid), "user": user, "sql": sql, "state": state,
            "ms": int(ms), "rows": int(rows),
            "queue_wait_ms": int(queue_wait_ms), "stage": stage,
            "slow": bool(slow_ms and ms >= slow_ms),
            "text": text, "profile": pdict,
        }
        try:
            size = len(text) + len(json.dumps(pdict)) if pdict else len(text)
        except (TypeError, ValueError):
            size = len(text)
        entry["_bytes"] = size + len(sql)
        max_n = int(config.get("profile_history_size") or 0)
        max_b = int(config.get("profile_history_bytes") or 0)
        with self._lock:
            old = self._entries.pop(entry["query_id"], None)
            if old is not None:
                self._bytes -= old["_bytes"]
            self._entries[entry["query_id"]] = entry
            self._bytes += entry["_bytes"]
            while self._entries and (
                    (max_n and len(self._entries) > max_n)
                    or (max_b and self._bytes > max_b
                        and len(self._entries) > 1)):
                ev = self._entries.pop(next(iter(self._entries)))
                self._bytes -= ev["_bytes"]
            if entry["slow"]:
                self._slow.append(entry)
                if len(self._slow) > self.SLOW_RING:
                    del self._slow[:len(self._slow) - self.SLOW_RING]

    def get(self, qid: int) -> dict | None:
        with self._lock:
            e = self._entries.get(int(qid))
            if e is not None:
                self._entries.pop(int(qid))
                self._entries[int(qid)] = e  # re-insert = LRU touch
                return e
            for s in reversed(self._slow):
                if s["query_id"] == int(qid):
                    return s
        return None

    def snapshot(self) -> list:
        """All retained entries (history ∪ slow ring), qid-ascending —
        the information_schema.query_profiles surface."""
        with self._lock:
            seen = dict(self._entries)
            for s in self._slow:
                seen.setdefault(s["query_id"], s)
        return [seen[k] for k in sorted(seen)]

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "slow": len(self._slow)}

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._slow.clear()
            self._bytes = 0


PROFILE_MANAGER = ProfileManager()
