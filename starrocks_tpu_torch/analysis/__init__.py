"""Static plan/trace/cache-key verification.

Reference behavior: StarRocks encodes its layering discipline as a
machine-readable contract checked OUTSIDE the hot path
(be/module_boundary_manifest.json — 52 modules with explicit allowed-
dependency edges, enforced by a build-time checker rather than reviewers).
This package is the engine-level analog: three passes that mechanically
check the invariants our last review rounds caught by hand —

- plan_check:  structural invariants of every optimized plan (schema and
  dtype agreement between operators, capacity-derivation monotonicity,
  partitioned-vs-replicated operand legality at joins/aggregates, null-
  semantics propagation through filters/joins);
- trace_check: jaxpr audit of every freshly-compiled program (foreign host
  callbacks inside traced code, implicit float64 promotion, profile
  counters on sharded stages that are not psum-shaped, oversized constants
  baked into the trace);
- key_check:   completeness of the compiled-program cache key (every knob
  read during tracing must be declared trace=True in runtime/config.py so
  a SET can never serve a stale trace — the exact bug class of the
  runtime-filter knobs that once missed the key).

Wired behind `SET plan_verify_level = off|warn|strict` (runtime/config.py),
the tools/plan_lint.py CLI, and the tier-1 conftest (warn mode).
"""

from __future__ import annotations

import dataclasses
import logging

logger = logging.getLogger("starrocks_tpu_torch.analysis")

# process-wide finding counter (bench.py reports it in the JSON summary)
_totals = {"findings": 0}


class VerifyError(RuntimeError):
    """Raised in strict mode when any error-severity finding survives."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant: which pass, which invariant, at which op."""

    pass_name: str   # plan_check | trace_check | key_check
    invariant: str   # short kebab-case invariant id
    node: str        # repr of the offending plan op / jaxpr eqn / knob
    message: str
    severity: str = "error"  # error (strict-fatal) | warn (report-only)

    def __str__(self):
        return (f"[{self.pass_name}/{self.invariant}] {self.severity} "
                f"at {self.node}: {self.message}")


def verify_level() -> str:
    from ..runtime.config import config

    lvl = config.get("plan_verify_level")
    return lvl if lvl in ("warn", "strict") else "off"


def findings_total() -> int:
    return _totals["findings"]


def report(findings, profile=None, level=None, where=""):
    """Route findings per the active level: count + log at warn, raise
    VerifyError on error-severity at strict. Safe to call with []."""
    if level is None:
        level = verify_level()
    if not findings or level == "off":
        return
    _totals["findings"] += len(findings)
    if profile is not None:
        profile.add_counter("verify_findings", len(findings))
    for f in findings:
        logger.warning("%s%s", f"{where}: " if where else "", f)
    errors = [f for f in findings if f.severity == "error"]
    if level == "strict" and errors:
        raise VerifyError(
            f"plan verification failed ({len(errors)} error finding(s)):\n"
            + "\n".join(f"  {f}" for f in errors))


def run_plan_checks(plan, catalog, profile=None, level=None, where=""):
    """Structural plan passes (the per-query hook; executor calls this on
    every optimized plan). Internal verifier errors must never take down a
    query: they are logged and swallowed — only FINDINGS escalate."""
    from . import plan_check

    try:
        findings = plan_check.check_plan(plan, catalog)
    except VerifyError:
        raise
    except Exception as e:  # noqa: BLE001 — verifier bug, not a query bug
        logger.warning("plan verifier crashed (%s: %s) — skipping",
                       type(e).__name__, e)
        return
    report(findings, profile, level, where)
