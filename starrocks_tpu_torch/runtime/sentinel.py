"""Plan-regression sentinel: the feedback loop's safety valve.

Round 15's plan-feedback store (runtime/feedback.py) is write-only
trust: a learned cardinality that flips the optimizer into a WORSE join
order stays wrong until DML happens to invalidate it. The robustness
line the join engine already follows (Design Trade-offs for a Robust
Dynamic Hybrid Hash Join, arXiv 2112.02480) argues adaptive decisions
need a regression guard, not just a learning path; StarRocks' history-
based plan manager pairs its learned plans with exactly this kind of
demotion. This module watches per-fingerprint latency relative to an
EWMA baseline KEYED TO THE FEEDBACK CONSULT TOKEN — the executor's
opt-plan key already carries that token, so a token move is precisely
"the feedback-driven plan changed":

- same token: fold the observation into the baseline (EWMA + mean
  absolute deviation band);
- token moved with an established baseline: enter a WATCH phase — the
  next observations are judged against the pre-move baseline;
- `sentinel_confirm` CONSECUTIVE watch observations above
  baseline + max(3*dev, sentinel_band*baseline, 1ms) emit a
  `plan_regression` event and QUARANTINE the fingerprint in the
  FeedbackStore: consult() answers None, the executor plans estimate-
  driven, and record() refuses to keep learning on the poisoned entry;
- while quarantined, `sentinel_readmit` consecutive observations at or
  under the quarantined baseline lift the quarantine (the poisoned
  entry is dropped — learning restarts from zero);
- ANY good watch observation accepts the new token as the new baseline
  (feedback warm-up bumps the token every run until fixpoint, so watch
  phases are routine and must be cheap to leave).

`observe()` rides `lifecycle._finalize_observability` (off the measured
path, shielded by the caller) and only weighs successful runs — error/
kill/timeout latencies say nothing about plan quality. With no
regression, the sentinel never mutates the store, so every plan stays
byte-identical to sentinel-off (`plan_lint --corpus` anchors this).
"""

from __future__ import annotations

from .. import lockdep
from .config import config

config.define("enable_plan_sentinel", True, True,
              "watch per-fingerprint latency baselines across feedback "
              "token moves and quarantine regressing FeedbackStore "
              "entries (plan_regression events)")
config.define("sentinel_min_baseline", 3, True,
              "observations required before a baseline is established "
              "enough to judge a token move against")
config.define("sentinel_confirm", 3, True,
              "consecutive over-band observations after a token move "
              "that confirm a plan regression (quarantine trigger)")
config.define("sentinel_readmit", 3, True,
              "consecutive at-or-under-baseline observations that lift "
              "a quarantine (the poisoned entry is dropped)")
config.define("sentinel_band", 0.5, True,
              "relative guard band over the baseline EWMA: observations "
              "within baseline*(1+band) are never regressions")

_EWMA_ALPHA = 0.3
_MAX_ENTRIES = 512


class PlanSentinel:
    """Bounded per-fingerprint baseline tracker. The lock is a LEAF
    (query-scope unwind + read surfaces); FeedbackStore calls and event
    emission happen OUTSIDE it — the store lock writes a sidecar file
    and must never nest under ours."""

    def __init__(self):
        self._lock = lockdep.lock("PlanSentinel._lock")
        # fp -> {"token", "ewma", "dev", "n", "watch" (None | dict),
        #        "quarantined_ms" (None | float), "recov"}; insertion
        # order is the LRU order (re-insert on touch)
        self._entries: dict = {}  # guarded_by: _lock
        # knob cache, pushed via config.on_set below  lint: unguarded-ok x5
        self._enabled = True      # lint: unguarded-ok
        self._min_baseline = 3    # lint: unguarded-ok
        self._confirm = 3         # lint: unguarded-ok
        self._readmit = 3         # lint: unguarded-ok
        self._band = 0.5          # lint: unguarded-ok

    # --- the one entry point -------------------------------------------------
    def observe(self, ctx):
        """Weigh one terminal context. Needs the executor-stashed consult
        coordinates (ctx.fb_fp / fb_token / fb_store); anything else —
        point lane, cache hits, feedback off — is not sentinel input."""
        if not self._enabled:
            return
        fp = getattr(ctx, "fb_fp", None)
        store = getattr(ctx, "fb_store", None)
        if not fp or store is None or ctx.state != "done":
            return
        token = getattr(ctx, "fb_token", None)
        ms = float(ctx.elapsed_ms())
        q = store.quarantined().get(fp)
        q_base = float(q["baseline_ms"]) if q else None
        with self._lock:
            action = self._step_locked(fp, token, ms, q is not None, q_base)
        # store mutation + event emission OUTSIDE the sentinel lock
        if action is None:
            return
        kind, baseline = action
        from . import events

        if kind == "quarantine":
            store.quarantine(fp, baseline)
            events.emit("plan_regression", fingerprint=fp[:16],
                        qid=int(ctx.qid), baseline_ms=round(baseline, 3),
                        observed_ms=round(ms, 3))
        elif kind == "readmit":
            store.readmit(fp)

    def _step_locked(self, fp, token, ms, quar, q_base):  # lint: holds _lock
        e = self._entries.pop(fp, None)
        if e is not None:
            self._entries[fp] = e  # LRU touch
        if quar:
            if e is None or e.get("quarantined_ms") is None:
                # quarantine inherited from a prior process (sidecar) or
                # placed by a test directly on the store: rebuild the
                # recovery state around the store's persisted baseline
                e = {"token": None, "ewma": ms, "dev": 0.0, "n": 1,
                     "watch": None, "quarantined_ms": q_base, "recov": 0}
                self._insert_locked(fp, e)
                if q_base is None:
                    return None
            base = e["quarantined_ms"]
            if ms <= base * (1.0 + self._band) + 1.0:
                e["recov"] += 1
                if e["recov"] >= max(self._readmit, 1):
                    # fresh baseline starts from the recovered runs
                    self._insert_locked(fp, {
                        "token": token, "ewma": ms, "dev": 0.0, "n": 1,
                        "watch": None, "quarantined_ms": None, "recov": 0})
                    return ("readmit", base)
            else:
                e["recov"] = 0
            return None
        if e is None or e.get("quarantined_ms") is not None:
            # first sight (or externally readmitted): start a baseline
            self._insert_locked(fp, {
                "token": token, "ewma": ms, "dev": 0.0, "n": 1,
                "watch": None, "quarantined_ms": None, "recov": 0})
            return None
        if token == e["token"] and e["watch"] is None:
            self._fold_locked(e, ms)
            return None
        if e["watch"] is None:
            if e["n"] < max(self._min_baseline, 1):
                # baseline too thin to judge: adopt the new token and
                # keep building
                e["token"] = token
                self._fold_locked(e, ms)
                return None
            e["watch"] = {"token": token, "bad": 0}
        else:
            # token moved again mid-watch: keep judging against the same
            # pre-move baseline, reset the consecutive-bad count
            if token != e["watch"]["token"]:
                e["watch"] = {"token": token, "bad": 0}
        base, dev = e["ewma"], e["dev"]
        threshold = base + max(3.0 * dev, self._band * base, 1.0)
        if ms > threshold:
            e["watch"]["bad"] += 1
            if e["watch"]["bad"] >= max(self._confirm, 1):
                e["watch"] = None
                e["quarantined_ms"] = base
                e["recov"] = 0
                return ("quarantine", base)
            return None
        # a good observation under the new token: the move was benign —
        # accept it as the baseline's continuation
        e["token"] = e["watch"]["token"]
        e["watch"] = None
        self._fold_locked(e, ms)
        return None

    @staticmethod
    def _fold_locked(e, ms):  # lint: holds _lock
        err = ms - e["ewma"]
        e["ewma"] += _EWMA_ALPHA * err
        e["dev"] += _EWMA_ALPHA * (abs(err) - e["dev"])
        e["n"] += 1

    def _insert_locked(self, fp, e):  # lint: holds _lock
        self._entries.pop(fp, None)
        self._entries[fp] = e
        while len(self._entries) > _MAX_ENTRIES:
            del self._entries[next(iter(self._entries))]

    # --- read surfaces -------------------------------------------------------
    def snapshot(self) -> list:
        """[{fingerprint, token, baseline_ms, dev_ms, n, watching,
        quarantined, recov}] — diagnostics and tests."""
        with self._lock:
            return [
                {"fingerprint": fp, "token": e["token"],
                 "baseline_ms": round(e["ewma"], 3),
                 "dev_ms": round(e["dev"], 3), "n": e["n"],
                 "watching": e["watch"] is not None,
                 "quarantined": e["quarantined_ms"] is not None,
                 "recov": e["recov"]}
                for fp, e in self._entries.items()]

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "watching": sum(1 for e in self._entries.values()
                                if e["watch"] is not None),
                "quarantined": sum(1 for e in self._entries.values()
                                   if e["quarantined_ms"] is not None),
            }

    def clear(self):
        """Tests only."""
        with self._lock:
            self._entries.clear()


SENTINEL = PlanSentinel()

config.on_set("enable_plan_sentinel",
              lambda v: setattr(SENTINEL, "_enabled", bool(v)))
config.on_set("sentinel_min_baseline",
              lambda v: setattr(SENTINEL, "_min_baseline", int(v or 1)))
config.on_set("sentinel_confirm",
              lambda v: setattr(SENTINEL, "_confirm", int(v or 1)))
config.on_set("sentinel_readmit",
              lambda v: setattr(SENTINEL, "_readmit", int(v or 1)))
config.on_set("sentinel_band",
              lambda v: setattr(SENTINEL, "_band", float(v or 0.0)))
