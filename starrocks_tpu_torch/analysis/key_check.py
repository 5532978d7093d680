"""Cache-key completeness checker.

The compiled-program cache serves a jitted trace keyed by (plan, knobs).
A knob that influences the trace but is missing from the key means a `SET`
can serve a STALE program — exactly the runtime-filter-knob bug a past
round shipped. The fix is structural: trace-affecting knobs are declared
`trace=True` at their `config.define` site and the key is BUILT from that
set (runtime/executor.py program_bucket <- config.trace_key()). This pass
closes the loop: ConfigRegistry.get() records every knob read while a
program is planned + traced, and any recorded knob that is neither
declared trace=True nor on the host-loop allowlist below is a finding.
"""

from __future__ import annotations

from . import Finding

# Knobs legitimately read inside the compile/trace window whose effect is
# keyed through OTHER channels (each entry documents its channel — an entry
# without a true channel is a bug, not an exemption):
HOST_LOOP_KNOBS = {
    "max_recompiles": "host adaptive loop only; never read inside a trace",
    "join_expand_headroom":
        "shapes the capacity DEFAULTS; the filled caps dict itself keys "
        "the per-bucket program entries",
    "batch_rows_threshold":
        "host path selection before any trace; spill paths use distinct "
        "cache buckets and jit retraces on batch-shape changes",
    "spill_batch_rows":
        "host batching only; batch shape changes force a retrace",
    "enable_zonemap_pruning":
        "changes which files LOAD (input data/shapes) — shape changes "
        "retrace; values never reach the trace",
    "compaction_trigger_rowsets": "storage write path, never traced",
    "profile_queries": "host-side profile collection toggle",
    "bench_sf": "bench harness input sizing",
    "chunk_align": "immutable; baked into every capacity everywhere",
    "compilation_cache_dir": "immutable process-level XLA cache wiring",
    "query_queue_timeout_s": "admission control, pre-planning",
    "default_agg_groups": "capacity default; caps dict keys the programs",
    "plan_verify_level": "the verifier's own knob (host-side)",
    "plan_verify_trace": "the verifier's own knob (host-side)",
    "query_timeout_s":
        "lifecycle deadline, captured at query-scope entry (outside every "
        "record window) and enforced at host stage boundaries only",
    "query_mem_limit_bytes":
        "lifecycle hard memory cap; host accountant only, never traced",
    "query_mem_soft_limit_bytes":
        "lifecycle soft memory threshold; host-side degradation only",
    "process_mem_limit_bytes":
        "process-level accountant cap; host-side only",
    "join_recursive_repartition":
        "host-side hybrid-join partitioning decision; the sub-partition "
        "capacities it produces key the compiled partition programs",
    "enable_device_profile":
        "host-side AOT cost/memory introspection attached to the "
        "RuntimeProfile after the traced call; never reaches the trace "
        "or result bytes",
}

# Knobs that shape the OPTIMIZED PLAN (read during optimize(), not during
# tracing). The optimized plan is itself part of the program cache key, and
# the optimized-plan cache must key on exactly this set
# (runtime/executor.py opt_key) — keep the two in sync via opt_key_knobs().
# plan_feedback is here because a consulted feedback entry changes the DP
# join order: the knob plus the entry's consult token (appended to opt_key
# by the executor) together key the learned plan.
OPT_KEY_KNOBS = ("enable_window_topn", "enable_mv_rewrite", "plan_feedback")


def check_trace_reads(reads, config=None) -> list:
    """Findings for knobs read during a compile/trace window but absent
    from the compiled-program cache key."""
    if config is None:
        from ..runtime.config import config as _c

        config = _c
    keyed = config.trace_knobs()
    findings = []
    for name in sorted(reads):
        if name in keyed or name in HOST_LOOP_KNOBS:
            continue
        if name in OPT_KEY_KNOBS:
            # plan-shape knobs are keyed via the plan ONLY when read at
            # optimize time; a read during TRACING bypasses that channel
            findings.append(Finding(
                "key_check", "knob-outside-key", name,
                f"plan-shaping knob {name!r} read during tracing: its "
                f"value is keyed via the optimized plan, but a trace-time "
                f"read lets two configs share one plan with different "
                f"traces"))
            continue
        findings.append(Finding(
            "key_check", "knob-outside-key", name,
            f"config knob {name!r} read while tracing a compiled program "
            f"but not declared trace=True (and not a documented host-loop "
            f"knob): a SET {name} could serve a stale trace"))
    return findings


def check_cache_reads(reads, config=None) -> list:
    """Findings for knobs read during an execution whose RESULT gets
    cached (the full-result query cache, starrocks_tpu_torch/cache/) but absent
    from every declared key channel. The result key is built from
    config.trace_key() + OPT_KEY_KNOBS, so a knob is covered when it is:

    - declared trace=True (keyed through trace_key()),
    - an OPT_KEY_KNOBS plan-shaping knob (keyed through the plan + the
      explicit opt-knob tuple in cache/keys.full_result_key),
    - declared cache_key=True (the cache's OWN machinery — lookup/budget
      knobs whose value cannot change cached bytes), or
    - a documented HOST_LOOP_KNOBS entry (perf-only host orchestration:
      batching, admission, profiling — never result bytes).

    Anything else is the round-7/8 stale-trace bug class aimed at result
    bytes: a SET could serve a stale table. The executor declines to cache
    on any finding (and strict mode fails the query)."""
    if config is None:
        from ..runtime.config import config as _c

        config = _c
    keyed = config.trace_knobs()
    own = config.cache_key_knobs()
    findings = []
    for name in sorted(reads):
        if (name in keyed or name in own or name in OPT_KEY_KNOBS
                or name in HOST_LOOP_KNOBS):
            continue
        findings.append(Finding(
            "key_check", "knob-outside-result-key", name,
            f"config knob {name!r} read while executing a query whose "
            f"result enters the query cache, but covered by no key channel "
            f"(trace=True / OPT_KEY_KNOBS / cache_key=True / documented "
            f"host-loop knob): a SET {name} could serve a stale result"))
    return findings


def check_feedback_reads(reads, config=None) -> list:
    """Findings for knobs read during a plan-feedback CONSULT
    (runtime/feedback.py → optimizer card/skew overrides) but absent from
    every declared cache-key channel. A consult happens before the
    optimized plan is cached, so an unkeyed knob read here is the round-7
    stale-trace class reborn through the feedback side door: two configs
    could share one learned plan. Covered channels are exactly
    check_cache_reads' set — trace=True, OPT_KEY_KNOBS, cache_key=True,
    or a documented HOST_LOOP_KNOBS entry."""
    if config is None:
        from ..runtime.config import config as _c

        config = _c
    keyed = config.trace_knobs()
    own = config.cache_key_knobs()
    findings = []
    for name in sorted(reads):
        if (name in keyed or name in own or name in OPT_KEY_KNOBS
                or name in HOST_LOOP_KNOBS):
            continue
        findings.append(Finding(
            "key_check", "knob-outside-feedback-key", name,
            f"config knob {name!r} read on the plan-feedback consult path "
            f"but covered by no cache-key channel (trace=True / "
            f"OPT_KEY_KNOBS / cache_key=True / documented host-loop knob): "
            f"a SET {name} could serve a stale learned plan"))
    return findings


def check_opt_reads(reads) -> list:
    """Findings for knobs read during optimize() but absent from the
    optimized-plan cache key (a SET would serve a stale PLAN). Knobs that
    are in the program key are still findings here: the opt-plan cache sits
    in front of the program cache and would short-circuit first."""
    findings = []
    for name in sorted(reads):
        if name in OPT_KEY_KNOBS or name in HOST_LOOP_KNOBS:
            continue
        findings.append(Finding(
            "key_check", "knob-outside-opt-key", name,
            f"config knob {name!r} read during plan optimization but not "
            f"part of the optimized-plan cache key (OPT_KEY_KNOBS): a SET "
            f"{name} could serve a stale optimized plan"))
    return findings
