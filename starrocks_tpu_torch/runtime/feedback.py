"""Plan-feedback store: execution observations fed back into planning.

The engine measures everything — per-ordinal adaptive capacities, observed
join cardinalities (the overflow checks channel), partition-time heavy-
hitter counts, spilled/resident partition outcomes — and before this module
the optimizer forgot it all after every statement (NEXT 7e/11a/11d;
StarRocks analog: the SQL plan manager + history-based optimizer,
fe sql/plan/PlanManager.java). At millions-of-users scale the dominant
workload is REPEATED parameterized statements, so observations keyed by
plan fingerprint converge exactly the queries that matter:

- layer 1 (sql/optimizer.py `_dp_order`): observed per-subtree cardinalities
  override System-R estimates (outside a guard band — a well-estimated plan
  must stay byte-identical), and probe-side heavy-hitter counts raise the
  cost of orders that probe through a hot key;
- layer 2 (runtime/executor.py): adaptive capacities learned by a previous
  process pre-seed the program bucket, so the first execution after a
  restart compiles ONCE at tight capacities and burns zero adaptive
  retries;
- layer 3 (runtime/batched.py): heavy-hitter keys learned at partition time
  re-route to the hybrid join's broadcast lane on the next run, and
  feedback-confirmed oversized partitions fund recursive salted
  repartitioning.

Staleness discipline mirrors the query cache (cache/keys.py): entries are
keyed by a fingerprint of (analyzed plan, trace knobs, opt knobs, UDF
epoch) and store per-table data-version tokens that are re-validated on
every consult — DML/DDL through ANY path invalidates. A consult token
(monotonic per-entry update counter) joins the executor's optimized-plan
cache key so new observations can never serve a stale plan, and the token
reaches a fixpoint once observations stop changing (steady-state repeats
keep hitting the opt-plan cache). `SET plan_feedback=off` is the
byte-identity A/B anchor; the knob is declared in OPT_KEY_KNOBS
(cache/keys.py) so both the opt-plan cache and the full-result
cache key on it.

Persistence: a JSON file next to the TabletStore manifests
(`plan_feedback.json`; atomic tmp+rename write, torn-read tolerant replay),
attached by Session when a persistent store exists. In-memory stores learn
within the process only.

A port of the JAX package's runtime/feedback.py: the same store, lock
name, band-move event (runtime/events.py) and quarantine hooks, which the
plan-regression sentinel (runtime/sentinel.py) calls.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

from .. import lockdep
from .config import config
from .metrics import metrics

FEEDBACK_RECORDS = metrics.counter(
    "sr_tpu_feedback_records_total",
    "plan-feedback observations recorded after executions")
FEEDBACK_HITS = metrics.counter(
    "sr_tpu_feedback_hits_total",
    "plan-feedback consults that returned a validated entry")
FEEDBACK_INVALIDATED = metrics.counter(
    "sr_tpu_feedback_invalidated_total",
    "plan-feedback entries dropped by DML/DDL or version mismatch")
FEEDBACK_RETRIES_AVOIDED = metrics.counter(
    "sr_tpu_feedback_retries_avoided_total",
    "adaptive retry attempts a feedback-seeded run did not burn")
FEEDBACK_RECOMPILES_AVOIDED = metrics.counter(
    "sr_tpu_feedback_recompiles_avoided_total",
    "overflow recompiles a feedback-seeded run did not burn")
FEEDBACK_EST_ERRSUM = metrics.counter(
    "sr_tpu_feedback_est_errsum",
    "accumulated relative error |est-observed|/observed over recorded joins")
FEEDBACK_EST_JOINS = metrics.counter(
    "sr_tpu_feedback_est_joins_total",
    "join cardinality observations behind sr_tpu_feedback_est_errsum")
FEEDBACK_QUARANTINED = metrics.counter(
    "sr_tpu_feedback_quarantined_total",
    "plan-feedback consults refused because the fingerprint is "
    "quarantined by the plan-regression sentinel")


def _version_token(catalog, table: str) -> str:
    """Per-table validation token. catalog.data_version prefixes a process-
    local data-epoch counter; store-backed handles carry a manifest-derived
    content token that IS stable across restarts, so drop the epoch for
    those (in-process DML still invalidates eagerly through the catalog
    listener -> DeviceCache.invalidate -> invalidate_table). Every other
    shape (in-memory tables, torn manifests) keeps the full tuple: those
    can only miss cross-restart, never serve stale."""
    v = catalog.data_version(table)
    if len(v) >= 2 and v[1] == "store":
        return repr(v[1:])
    return repr(v)


def _canon(x):
    """A complete, process-stable value of a plan tree: every dataclass
    field by name, recursively (plan nodes and expressions print only a
    summary, e.g. `Sort[1 keys, limit=None]`, so their repr cannot tell
    two plans apart)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _canon(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((repr(k), _canon(v)) for k, v in x.items()))
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(repr(_canon(v)) for v in x))
    return x


def plan_fingerprint(plan) -> str:
    """Stable cross-process fingerprint of an analyzed plan under the
    current knob state: sha256 over the plan's full structure (`_canon`),
    the trace knobs, the plan-shaping opt knobs and the UDF registry epoch.
    Python `hash()` is salted per process, so the digest goes through repr.

    The reference hashes `repr(plan)`, which is the root node's one-line
    summary: distinct queries share a fingerprint (TPC-H Q1, Q9, Q13 and
    S2 one, Q4, Q5, Q8, Q11, Q12, Q15, Q20 and Q22 another), and one
    query's learned capacities then seed another's program (ROADMAP,
    reference defects). The port fingerprints the whole tree."""
    from ..cache.keys import OPT_KEY_KNOBS
    from .udf import registry_epoch

    opt_vals = tuple((k, config.get(k)) for k in OPT_KEY_KNOBS)
    raw = repr((_canon(plan), config.trace_key(), opt_vals,
                registry_epoch()))
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


class FeedbackStore:
    """Per-fingerprint execution observations with query-cache staleness
    discipline. One instance per DeviceCache (shared by every session of a
    serving tier); `attach()` adds sidecar persistence when the owning
    session has a TabletStore."""

    MAX_ENTRIES = 256
    MAX_QUARANTINE = 64

    def __init__(self, path: str | None = None):
        self._lock = lockdep.lock("FeedbackStore._lock")
        self._entries: dict = {}  # guarded_by: _lock — fp -> entry dict
        # fingerprints the plan-regression sentinel (runtime/sentinel.py)
        # has pulled out of planning: fp -> {"baseline_ms", "ts"}. While
        # quarantined, consult() answers None (estimate-driven planning)
        # and record() refuses new observations; readmit() drops BOTH the
        # quarantine mark and the poisoned entry so learning restarts.
        self._quarantine: dict = {}  # guarded_by: _lock
        self._path = None  # guarded_by: _lock — sidecar path, set by attach()
        if path is not None:
            self.attach(path)

    # --- persistence (round-9 external-defs sidecar pattern) ---------------
    def attach(self, path: str):
        """Wire sidecar persistence (idempotent): load any existing journal,
        then write behind every accepted mutation. A torn/corrupt file is
        an empty store, never an error — feedback is a performance layer."""
        with self._lock:
            if self._path == path:
                return
            self._path = path
            try:
                with open(path) as f:  # lint: blocking-ok — one-shot startup load; attach must see a consistent store vs concurrent record()
                    data = json.load(f)
                if isinstance(data, dict):
                    for fp, e in data.get("entries", {}).items():
                        if isinstance(e, dict) and "versions" in e:
                            self._entries[fp] = e
                    for fp, q in data.get("quarantine", {}).items():
                        if isinstance(q, dict) and "baseline_ms" in q:
                            self._quarantine[fp] = q
            except (OSError, ValueError):
                pass

    def _save_locked(self):  # lint: holds _lock  # lint: blocking-ok — sidecar persistence must serialize with entry mutation; the tmp+replace write is bounded by the entry cap and tolerates OSError
        if self._path is None:
            return
        from .failpoint import FailPointError, fail_point

        tmp = self._path + ".tmp"
        try:
            fail_point("feedback::save")  # injected faults degrade like a
            #   read-only root: the sidecar skips one write, memory wins
            with open(tmp, "w") as f:
                json.dump({"entries": self._entries,
                           "quarantine": self._quarantine}, f)
            os.replace(tmp, self._path)
        except (OSError, FailPointError):
            pass  # read-only root: keep learning in memory

    # --- consult ------------------------------------------------------------
    def consult(self, plan, catalog):
        """Validated entry for this plan under the current knobs, or None.
        `plan` may be a pre-computed fingerprint string (the executor hashes
        once and uses the same fp for consult and record). Validation
        re-checks every stored per-table data-version token against the
        live catalog (exactly QueryCache.lookup_result's discipline) — a
        mutated table drops the entry instead of serving observations about
        data that no longer exists."""
        fp = plan if isinstance(plan, str) else plan_fingerprint(plan)
        with self._lock:
            if fp in self._quarantine:
                e = None
                quarantined = True
            else:
                e = self._entries.get(fp)
                quarantined = False
        if quarantined:
            FEEDBACK_QUARANTINED.inc()
            return None
        if e is None:
            return None
        for t, v in e["versions"].items():
            try:
                live = _version_token(catalog, t)
            except (KeyError, ValueError):
                live = None
            if live != v:
                with self._lock:
                    if self._entries.pop(fp, None) is not None:
                        FEEDBACK_INVALIDATED.inc()
                        self._save_locked()
                return None
        FEEDBACK_HITS.inc()
        return {"fp": fp, **e}

    # --- record -------------------------------------------------------------
    def record(self, fp: str, catalog, tables, tag: str, caps: dict,
               attempts: int, cards: dict | None = None,
               probe_hot: dict | None = None, build_hot: dict | None = None,
               parts: dict | None = None):
        """Merge one execution's observations into the fingerprint's entry.
        The consult token bumps ONLY when the merged view changes: steady-
        state repeats reach a fixpoint, so the executor's token-extended
        opt-plan key keeps hitting instead of re-optimizing every run."""
        versions = {}
        for t in sorted(tables):
            try:
                versions[t] = _version_token(catalog, t)
            except (KeyError, ValueError):
                return  # table vanished mid-query; nothing durable to learn
        with self._lock:
            if fp in self._quarantine:
                # the sentinel pulled this fingerprint: refuse to keep
                # learning on top of the poisoned entry — readmit() drops
                # it and learning restarts from zero
                return
            e = self._entries.get(fp)
            if e is None or e["versions"] != versions:
                # first observation, or the data moved under the old entry:
                # decay everything learned against the previous versions
                e = {"token": (e or {}).get("token", 0), "versions": versions,
                     "caps": {}, "attempts": {}, "cards": {},
                     "probe_hot": {}, "build_hot": {}, "parts": {}}
            before = json.dumps(
                (e["caps"], e["cards"], e["probe_hot"], e["build_hot"],
                 e["parts"]), sort_keys=True)
            # observation count drives guard-band annealing (NEXT 11f);
            # it resets with the entry when the data versions move
            obs_before = int(e.get("obs", 0))
            e["obs"] = obs_before + 1
            obs_after = e["obs"]
            e["caps"][tag] = {k: int(v) for k, v in (caps or {}).items()}
            # attempts = the adaptive retries burned LEARNING this shape;
            # keep the max so a later seeded 0-retry run doesn't erase what
            # seeding is saving
            e["attempts"][tag] = max(int(attempts),
                                     int(e["attempts"].get(tag, 0)))
            if cards:
                e["cards"].update(
                    {k: float(v) for k, v in cards.items()})
            if probe_hot:
                e["probe_hot"].update(probe_hot)
            if build_hot:
                e["build_hot"].update(build_hot)
            if parts:
                e["parts"] = dict(parts)
            after = json.dumps(
                (e["caps"], e["cards"], e["probe_hot"], e["build_hot"],
                 e["parts"]), sort_keys=True)
            from ..sql.optimizer import feedback_band

            # a band-tier move can flip a banded() outcome with identical
            # observations, so it must invalidate token-extended opt-plan
            # keys exactly like a changed observation
            band_before = feedback_band(max(obs_before, 1))
            band_after = feedback_band(e["obs"])
            changed = before != after or band_before != band_after
            if changed:
                e["token"] = e.get("token", 0) + 1
            self._entries.pop(fp, None)  # re-insert = LRU touch
            self._entries[fp] = e
            while len(self._entries) > self.MAX_ENTRIES:
                del self._entries[next(iter(self._entries))]
            if changed:
                self._save_locked()
        FEEDBACK_RECORDS.inc()
        if band_before != band_after:
            from . import events

            # journaled outside the store lock (record holds it through
            # the sidecar save above)
            events.emit("feedback_band_move", fingerprint=fp[:16],
                        obs=obs_after, band=band_after)

    # --- invalidation ---------------------------------------------------------
    def invalidate_table(self, table: str):
        """Drop every entry that observed `table` (DeviceCache.invalidate
        fans in here, so session DML, storage-level writes, and DDL all
        cover feedback exactly like they cover compiled programs)."""
        with self._lock:
            dead = [fp for fp, e in self._entries.items()
                    if table in e["versions"]]
            for fp in dead:
                del self._entries[fp]
            if dead:
                FEEDBACK_INVALIDATED.inc(len(dead))
                self._save_locked()

    # --- quarantine (plan-regression sentinel, runtime/sentinel.py) ---------
    def quarantine(self, fp: str, baseline_ms: float):
        """Pull a fingerprint out of planning: consult() answers None (the
        executor falls back to estimate-driven optimization) and record()
        refuses observations until readmit(). baseline_ms is the pre-
        regression latency the sentinel demands fresh runs beat before
        re-admission."""
        with self._lock:
            self._quarantine.pop(fp, None)  # re-insert = LRU touch
            self._quarantine[fp] = {"baseline_ms": float(baseline_ms),
                                    "ts": time.time()}
            while len(self._quarantine) > self.MAX_QUARANTINE:
                del self._quarantine[next(iter(self._quarantine))]
            self._save_locked()

    def readmit(self, fp: str):
        """Lift a quarantine AND drop the poisoned entry: the next
        executions learn from scratch against the recovered baseline."""
        with self._lock:
            q = self._quarantine.pop(fp, None)
            dropped = self._entries.pop(fp, None)
            if q is not None or dropped is not None:
                self._save_locked()

    def is_quarantined(self, fp: str) -> bool:
        with self._lock:
            return fp in self._quarantine

    def quarantined(self) -> dict:
        """fp -> {"baseline_ms", "ts"} copies (diagnostic surfaces)."""
        with self._lock:
            return {fp: dict(q) for fp, q in self._quarantine.items()}

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._quarantine.clear()
            self._save_locked()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "tokens": sum(e.get("token", 0)
                              for e in self._entries.values()),
                "quarantined": len(self._quarantine),
                "persistent": self._path is not None,
            }
