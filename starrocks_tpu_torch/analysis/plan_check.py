"""Plan verifier: structural invariants of optimized plans.

Walks every physical plan post-optimization (in this engine the optimized
logical plan IS the physical program blueprint — sql/physical.py compiles it
1:1) and checks the invariant classes a reviewer would otherwise eyeball:

- schema agreement: every column an operator references must be produced by
  its child; operator outputs must be unambiguous;
- dtype agreement: join equi-keys and UNION branches must not silently
  compare dictionary codes against values (string vs non-string);
- capacity-derivation monotonicity: a non-growing operator's cardinality
  estimate may never exceed its input's structural upper bound — growth is
  only legal through explicit grow ops (join expansion, unnest, union);
- distribution properties: partitioned-vs-replicated operand legality at
  joins/aggregates and exchange placement before partition-sensitive ops
  (checked against the distributed compiler's own placement rules);
- null semantics: null-rejecting predicates sitting on an outer join's
  nullable side (the join should have been simplified), comparisons against
  a bare NULL literal (always-empty predicate).
"""

from __future__ import annotations

import math

from ..exprs.ir import AggExpr, Call, Case, Cast, Col, InList, Lit
from ..sql.logical import (
    LAggregate, LFilter, LJoin, LLimit, LProject, LScan, LSort, LUnion,
    LUnnest, LWindow, LogicalPlan,
)
from . import Finding

# absolute + relative slack on the monotonicity check: estimators floor at
# 1 row and seed small headrooms; only structural blowups should flag
_CAP_SLACK_REL = 1.5
_CAP_SLACK_ABS = 1024


def _cols(e):
    """expr_cols that never raises (fuzz plans can hold odd markers)."""
    from ..sql.optimizer import expr_cols

    try:
        return expr_cols(e)
    except Exception:  # noqa: BLE001
        return frozenset()


def _node_exprs(p: LogicalPlan):
    """The expressions an operator evaluates against its CHILD scope."""
    if isinstance(p, LFilter):
        return [p.predicate]
    if isinstance(p, LProject):
        return [e for _, e in p.exprs]
    if isinstance(p, LSort):
        return [k for k, _, _ in p.keys]
    if isinstance(p, LAggregate):
        out = [e for _, e in p.group_by]
        for _, a in p.aggs:
            if a.arg is not None:
                out.append(a.arg)
            for x in a.extra:
                if isinstance(x, tuple):
                    out.extend(y for y in x if hasattr(y, "__class__")
                               and _is_expr(y))
                elif _is_expr(x):
                    out.append(x)
        return out
    if isinstance(p, LWindow):
        out = list(p.partition_by)
        out += [k for k, _, _ in p.order_by]
        out += [a for _, _, a, *_ in p.funcs if a is not None and _is_expr(a)]
        return out
    if isinstance(p, LUnnest):
        return [p.expr]
    return []


def _is_expr(x):
    from ..exprs.ir import Expr

    return isinstance(x, Expr)


# --- pass 1+2: schema + dtype agreement --------------------------------------


def check_schema(plan: LogicalPlan, catalog) -> list:
    findings = []

    def rec(p):
        for c in p.children:
            rec(c)
        if isinstance(p, LJoin):
            scope = frozenset(p.left.output_names()) | frozenset(
                p.right.output_names())
            if p.condition is not None:
                missing = _cols(p.condition) - scope
                if missing:
                    findings.append(Finding(
                        "plan_check", "schema-agreement", repr(p),
                        f"join condition references columns not produced by "
                        f"either input: {sorted(missing)}"))
            overlap = frozenset(p.left.output_names()) & frozenset(
                p.right.output_names())
            if overlap and p.kind not in ("semi", "anti"):
                findings.append(Finding(
                    "plan_check", "schema-agreement", repr(p),
                    f"ambiguous output: both inputs produce {sorted(overlap)}"))
        elif isinstance(p, LUnion):
            arities = {len(c.output_names()) for c in p.inputs}
            if len(arities) > 1:
                findings.append(Finding(
                    "plan_check", "schema-agreement", repr(p),
                    f"UNION branches disagree on arity: {sorted(arities)}"))
        else:
            child = p.children[0] if p.children else None
            if child is not None:
                scope = frozenset(child.output_names())
                for e in _node_exprs(p):
                    missing = _cols(e) - scope
                    if missing:
                        findings.append(Finding(
                            "plan_check", "schema-agreement", repr(p),
                            f"expression {e!r} references columns not in "
                            f"child scope: {sorted(missing)}"))
        # output unambiguity (all node kinds)
        try:
            names = p.output_names()
        except Exception:  # noqa: BLE001
            names = ()
        dup = {n for n in names if list(names).count(n) > 1}
        if dup:
            findings.append(Finding(
                "plan_check", "schema-agreement", repr(p),
                f"duplicate output columns: {sorted(dup)}"))

    rec(plan)
    return findings


def _col_type(plan, name, catalog):
    from ..sql.optimizer import col_origin

    try:
        origin = col_origin(plan, name)
    except Exception:  # noqa: BLE001
        return None
    if origin is None:
        return None
    t = catalog.get_table(origin[0])
    if t is None or t.schema is None:
        return None
    f = t.schema.field(origin[1])
    return None if f is None else f.type


def check_dtypes(plan: LogicalPlan, catalog) -> list:
    """String columns travel as dictionary CODES: comparing them against a
    non-string operand compares codes to values — silently wrong, never a
    runtime error. Flag it at join keys and UNION branch positions."""
    from ..sql.physical import join_equi_keys

    findings = []

    def rec(p):
        for c in p.children:
            rec(c)
        if isinstance(p, LJoin) and p.condition is not None:
            try:
                probe_keys, build_keys, _ = join_equi_keys(p)
            except Exception:  # noqa: BLE001
                return
            for pk, bk in zip(probe_keys, build_keys):
                if not (isinstance(pk, Col) and isinstance(bk, Col)):
                    continue
                tl = _col_type(p.left, pk.name, catalog)
                tr = _col_type(p.right, bk.name, catalog)
                if tl is None or tr is None:
                    continue
                if tl.is_string != tr.is_string:
                    findings.append(Finding(
                        "plan_check", "dtype-agreement", repr(p),
                        f"equi-key dtype mismatch: {pk.name} is {tl!r} but "
                        f"{bk.name} is {tr!r} (dict codes vs values)"))
        if isinstance(p, LUnion):
            first = p.inputs[0]
            fnames = first.output_names()
            for branch in p.inputs[1:]:
                bnames = branch.output_names()
                for i, (fn, bn) in enumerate(zip(fnames, bnames)):
                    ta = _col_type(first, fn, catalog)
                    tb = _col_type(branch, bn, catalog)
                    if ta is None or tb is None:
                        continue
                    if ta.is_string != tb.is_string:
                        findings.append(Finding(
                            "plan_check", "dtype-agreement", repr(p),
                            f"UNION position {i}: {fn} is {ta!r} but {bn} "
                            f"is {tb!r}"))

    rec(plan)
    return findings


# --- pass 3: capacity-derivation monotonicity --------------------------------


def _row_bound(p: LogicalPlan, catalog) -> float:
    """Structural upper bound on an operator's output rows. Growth beyond
    the input bound is only possible through the explicit grow ops (join
    expansion, unnest, union concatenation)."""
    if isinstance(p, LScan):
        t = catalog.get_table(p.table)
        return float(t.row_count) if t is not None else math.inf
    if isinstance(p, (LFilter, LProject, LSort, LWindow, LAggregate)):
        b = _row_bound(p.children[0], catalog)
        if isinstance(p, LSort) and p.limit is not None:
            b = min(b, float(p.limit))
        return b
    if isinstance(p, LLimit):
        return min(_row_bound(p.child, catalog),
                   float(p.limit + p.offset))
    if isinstance(p, LJoin):
        l = _row_bound(p.left, catalog)
        r = _row_bound(p.right, catalog)
        if p.kind in ("semi", "anti"):
            return l
        if p.kind == "left":
            return max(l, l * r)  # every probe row survives
        return l * r  # inner/cross worst case
    if isinstance(p, LUnion):
        return sum(_row_bound(c, catalog) for c in p.inputs)
    if isinstance(p, LUnnest):
        return math.inf  # per-row array lengths are unbounded statically
    return math.inf


def check_capacities(plan: LogicalPlan, catalog) -> list:
    """The planner derives every device capacity (compaction seeds, join
    expansion sizes, agg group counts) from estimate_rows: an estimate that
    exceeds the structural row bound of a NON-growing operator means the
    derivation lost monotonicity and downstream capacities inflate without
    an explicit grow op justifying it."""
    from ..sql.optimizer import estimate_rows

    findings = []

    def rec(p):
        for c in p.children:
            rec(c)
        bound = _row_bound(p, catalog)
        if not math.isfinite(bound):
            return
        try:
            est = estimate_rows(p, catalog)
        except Exception:  # noqa: BLE001
            return
        if est > bound * _CAP_SLACK_REL + _CAP_SLACK_ABS:
            findings.append(Finding(
                "plan_check", "capacity-monotonicity", repr(p),
                f"cardinality estimate {est:.0f} exceeds the structural "
                f"row bound {bound:.0f} of a non-growing operator"))

    rec(plan)
    return findings


# --- pass 4: null-semantics propagation --------------------------------------


def derive_nullability(p: LogicalPlan, catalog) -> dict:
    """name -> may-be-NULL, propagated bottom-up: scans from the declared
    schema, outer joins make the non-preserved side nullable, aggregates
    keep count()-family non-null."""
    if isinstance(p, LScan):
        t = catalog.get_table(p.table)
        out = {}
        for c in p.columns:
            f = (t.schema.field(c)
                 if t is not None and t.schema is not None else None)
            out[f"{p.alias}.{c}"] = True if f is None else f.nullable
        return out
    if isinstance(p, LJoin):
        ln = derive_nullability(p.left, catalog)
        if p.kind in ("semi", "anti"):
            return ln
        rn = derive_nullability(p.right, catalog)
        if p.kind == "left":
            rn = {k: True for k in rn}  # non-matching probes pad with NULL
        return {**ln, **rn}
    if isinstance(p, LProject):
        cn = derive_nullability(p.child, catalog)
        out = {}
        for n, e in p.exprs:
            if isinstance(e, Col):
                out[n] = cn.get(e.name, True)
            elif isinstance(e, Lit):
                out[n] = e.value is None
            else:
                out[n] = True  # conservative
        return out
    if isinstance(p, LAggregate):
        cn = derive_nullability(p.child, catalog)
        out = {}
        for n, e in p.group_by:
            out[n] = cn.get(e.name, True) if isinstance(e, Col) else True
        for n, a in p.aggs:
            out[n] = a.fn not in ("count", "count_distinct", "ndv")
        return out
    if isinstance(p, LWindow):
        out = derive_nullability(p.child, catalog)
        for n, fn, *_ in p.funcs:
            out[n] = fn not in ("row_number", "rank", "dense_rank", "count",
                                "ntile")
        return out
    if p.children:
        merged = {}
        for c in p.children:
            merged.update(derive_nullability(c, catalog))
        return merged
    return {}


def _null_rejecting_cols(pred) -> frozenset:
    """Columns a top-level conjunct comparison forces non-NULL: eq/ne/lt/
    le/gt/ge over a column evaluates to NULL (filtered) when the column is
    NULL. coalesce/is-null style wrappers are NOT null-rejecting."""
    from ..sql.analyzer import _conjuncts

    out = set()
    try:
        conjs = _conjuncts(pred)
    except Exception:  # noqa: BLE001
        return frozenset()
    for c in conjs:
        if isinstance(c, Call) and c.fn in ("eq", "ne", "neq", "lt", "le",
                                            "gt", "ge", "like"):
            for a in c.args:
                if isinstance(a, Col):
                    out.add(a.name)
        elif isinstance(c, InList) and not c.negated and isinstance(
                c.arg, Col):
            out.add(c.arg.name)
    return frozenset(out)


def check_null_semantics(plan: LogicalPlan, catalog) -> list:
    findings = []

    def rec(p):
        for c in p.children:
            rec(c)
        if isinstance(p, LFilter):
            # comparison against a bare NULL literal is always NULL ->
            # the filter drops every row; almost certainly a planner slip
            from ..sql.analyzer import _conjuncts

            try:
                conjs = _conjuncts(p.predicate)
            except Exception:  # noqa: BLE001
                conjs = []
            for c in conjs:
                if (isinstance(c, Call)
                        and c.fn in ("eq", "ne", "neq", "lt", "le", "gt",
                                     "ge")
                        and any(isinstance(a, Lit) and a.value is None
                                for a in c.args)):
                    findings.append(Finding(
                        "plan_check", "null-semantics", repr(p),
                        f"comparison against NULL literal is always NULL "
                        f"(empty result): {c!r}", severity="warn"))
            # null-rejecting predicate directly over an outer join's
            # nullable side: the join is effectively INNER — the optimizer
            # missed a simplification and the executor pays outer-join
            # padding for rows the filter then drops
            if isinstance(p.child, LJoin) and p.child.kind == "left":
                right = frozenset(p.child.right.output_names())
                rej = _null_rejecting_cols(p.predicate) & right
                if rej:
                    findings.append(Finding(
                        "plan_check", "null-semantics", repr(p),
                        f"null-rejecting predicate on outer join's nullable "
                        f"side {sorted(rej)}: join could be INNER",
                        severity="warn"))

    rec(plan)
    return findings


# --- pass 5: distribution properties -----------------------------------------


def check_distribution(plan: LogicalPlan, catalog, scan_modes: dict | None
                       = None, managed_exchanges: bool = True) -> list:
    """Partitioned-vs-replicated operand legality, mirroring the distributed
    compiler's mode propagation (sql/distributed.py).

    managed_exchanges=True verifies that the plan ADMITS a legal lowering
    (the compiler inserts shuffles/gathers where needed — only structurally
    illegal combinations flag). managed_exchanges=False verifies a DECLARED
    physical plan with NO implicit exchanges: every repartition must appear
    as an explicit LExchange node (the fragment IR produced by
    sql/fragments.py), and any partition-sensitive op whose operands are not
    aligned by placement or by a declared exchange is a finding. The pass
    checks the DECLARATIONS — it never re-runs the compiler's placement
    simulation, so a compiler bug that emits a wrong exchange set surfaces
    here instead of being mirrored."""
    from ..sql.distributed import (
        RANGE_SHARDED, REPLICATED, SHARDED, plan_scan_modes,
    )
    from ..sql.logical import LExchange
    from ..sql.physical import join_equi_keys

    if scan_modes is None:
        scan_modes = plan_scan_modes(plan, catalog)
    findings = []

    def hash_col(mode):
        return mode[1] if isinstance(mode, tuple) and mode[0] == "hash" \
            else None

    def is_dist(mode):
        return mode != REPLICATED

    def rec(p):
        if isinstance(p, LExchange):
            m = rec(p.child)
            if not managed_exchanges:
                # declaration consistency: kind must support the declared
                # post-exchange placement
                if p.kind in ("broadcast", "gather") and p.mode != REPLICATED:
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        f"{p.kind} exchange declares non-replicated output "
                        f"mode {p.mode!r}"))
                if p.kind == "hash" and not (
                        p.mode == SHARDED or hash_col(p.mode) is not None):
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        f"hash exchange declares output mode {p.mode!r} "
                        f"(expected sharded or a hash-placement token)"))
                if p.kind == "hash" and not p.keys:
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        "hash exchange declares no partition keys"))
                if p.kind == "range" and p.mode != RANGE_SHARDED:
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        f"range exchange declares output mode {p.mode!r}"))
                if not is_dist(m):
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        "exchange over an already-replicated input (dead "
                        "data movement)", severity="warn"))
            return p.mode
        if isinstance(p, LScan):
            mode = scan_modes.get(id(p), REPLICATED)
            hc = hash_col(mode)
            if hc is not None and hc not in p.output_names():
                findings.append(Finding(
                    "plan_check", "distribution", repr(p),
                    f"hash-placement column {hc} is not among the scan's "
                    f"output columns"))
                mode = SHARDED
            return mode
        if isinstance(p, LProject):
            m = rec(p.child)
            hc = hash_col(m)
            if hc is not None:
                m = SHARDED
                for n, e in p.exprs:
                    if isinstance(e, Col) and e.name == hc:
                        m = ("hash", n)
                        break
            return m
        if isinstance(p, (LFilter, LUnnest)):
            return rec(p.child)  # mode passthrough (unnest appends a column)
        if isinstance(p, LJoin):
            lm = rec(p.left)
            rm = rec(p.right)
            # joins reorder rows: range order is lost, placement survives
            lm = SHARDED if lm == RANGE_SHARDED else lm
            rm = SHARDED if rm == RANGE_SHARDED else rm
            if not is_dist(lm) and not is_dist(rm):
                return REPLICATED
            try:
                probe_keys, build_keys, _ = join_equi_keys(p)
            except Exception:  # noqa: BLE001
                probe_keys = build_keys = []
            lhc, rhc = hash_col(lm), hash_col(rm)
            colocated = (
                lhc is not None and rhc is not None
                and any(isinstance(pk, Col) and isinstance(bk, Col)
                        and pk.name == lhc and bk.name == rhc
                        for pk, bk in zip(probe_keys, build_keys)))
            if not colocated and not managed_exchanges:
                # a declared hash exchange can align a side beyond what the
                # ("hash", col) placement token expresses: shuffling by the
                # full equated key tuple (or by the single key equated to
                # the other side's placement column) keeps matching rows
                # together even when keys are expressions or multi-column
                lex = p.left if isinstance(p.left, LExchange) else None
                rex = p.right if isinstance(p.right, LExchange) else None

                def pos_of(mode, keys_):
                    hc = hash_col(mode)
                    return {i for i, k in enumerate(keys_)
                            if isinstance(k, Col) and k.name == hc}

                lpos, rpos = pos_of(lm, probe_keys), pos_of(rm, build_keys)
                if lex is not None and lex.kind == "hash" and rpos:
                    colocated = any(tuple(lex.keys) == (probe_keys[i],)
                                    for i in rpos)
                if not colocated and rex is not None and rex.kind == "hash" \
                        and lpos:
                    colocated = any(tuple(rex.keys) == (build_keys[i],)
                                    for i in lpos)
                if not colocated and lex is not None and rex is not None \
                        and lex.kind == "hash" and rex.kind == "hash":
                    colocated = bool(probe_keys) and (
                        tuple(lex.keys) == tuple(probe_keys)
                        and tuple(rex.keys) == tuple(build_keys))
            if managed_exchanges:
                # the compiler can always legalize: broadcast the build,
                # or hash-shuffle both sides on the equi keys (needs at
                # least one equi pair)
                if is_dist(lm) and is_dist(rm) and not colocated \
                        and not probe_keys and p.kind != "cross":
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        "partitioned x partitioned join has no equi keys "
                        "to shuffle on (would force a full gather)",
                        severity="warn"))
                return SHARDED if (is_dist(lm) or is_dist(rm)) else REPLICATED
            # declared-exchange mode: operands must already be aligned
            if not is_dist(lm) and is_dist(rm):
                findings.append(Finding(
                    "plan_check", "distribution", repr(p),
                    "replicated probe joined against a partitioned build "
                    "without an exchange: each shard would pair the whole "
                    "probe with one build fragment (partial, non-replicated "
                    "result)"))
                return SHARDED
            if is_dist(lm) and is_dist(rm) and not colocated:
                findings.append(Finding(
                    "plan_check", "distribution", repr(p),
                    "partitioned operands are not colocated on the join "
                    "keys and no exchange precedes the join"))
            return lm
        if isinstance(p, LAggregate):
            m = rec(p.child)
            if not is_dist(m):
                return REPLICATED
            hc = hash_col(m)
            # placement tokens name CHILD-scope columns when they come from
            # a scan/join placement, but OUTPUT group names when a declared
            # exchange moves PARTIAL states (keyed by the agg's own output
            # columns) — accept either scope
            child_keys = {e.name for _, e in p.group_by
                          if isinstance(e, Col)}
            out_keys = {n for n, _ in p.group_by}
            aligned = hc is not None and hc in (child_keys | out_keys)
            ex = p.child if isinstance(p.child, LExchange) else None
            if not aligned and ex is not None and ex.kind == "hash":
                # multi-key shuffle of partial states: placed on the FULL
                # group key tuple => every group on exactly one shard
                knames = {k.name for k in ex.keys if isinstance(k, Col)}
                aligned = (len(knames) == len(ex.keys)
                           and bool(knames)
                           and knames <= (child_keys | out_keys))
            if managed_exchanges:
                return SHARDED if p.group_by else REPLICATED
            if not aligned:
                findings.append(Finding(
                    "plan_check", "distribution", repr(p),
                    "partition-sensitive aggregate consumes a sharded "
                    "input that is not hash-placed on its group keys and "
                    "no exchange precedes it"))
            from ..ops.aggregate import decomposable

            for n, a in p.aggs:
                if not aligned and not decomposable(a):
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        f"non-decomposable aggregate {n}={a.fn} over a "
                        f"sharded input requires an exchange"))
            if not p.group_by:
                return REPLICATED
            # propagate the colocate placement on the OUTPUT group name so
            # a parent join/agg can prove alignment without an exchange
            if hc is not None and hc in out_keys:
                return ("hash", hc)
            if hc is not None and hc in child_keys:
                out_n = next((n for n, e in p.group_by
                              if isinstance(e, Col) and e.name == hc), None)
                if out_n is not None:
                    return ("hash", out_n)
            return SHARDED
        if isinstance(p, LWindow):
            m = rec(p.child)
            if not is_dist(m):
                return REPLICATED
            hc = hash_col(m)
            aligned = hc is not None and any(
                isinstance(e, Col) and e.name == hc for e in p.partition_by)
            ex = p.child if isinstance(p.child, LExchange) else None
            if not aligned and ex is not None and ex.kind == "hash":
                aligned = tuple(ex.keys) == tuple(p.partition_by)
            if managed_exchanges:
                return SHARDED
            if not aligned:
                findings.append(Finding(
                    "plan_check", "distribution", repr(p),
                    "LWindow is partition-sensitive (partitions must be "
                    "shard-local) but its sharded input is not placed on "
                    "the partition keys and no exchange precedes it"))
            return m if aligned else SHARDED
        if isinstance(p, LSort):
            m = rec(p.child)
            if not is_dist(m):
                return REPLICATED
            if managed_exchanges:
                return SHARDED
            if m == RANGE_SHARDED:
                # range-exchanged input: local sorts concatenate into
                # global order; verify the exchange ranges on the leading
                # sort key
                ex = p.child if isinstance(p.child, LExchange) else None
                if ex is not None and tuple(ex.keys) != (p.keys[0][0],):
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        f"range exchange partitions by {ex.keys!r}, not "
                        f"the leading sort key {p.keys[0][0]!r}"))
                return RANGE_SHARDED
            findings.append(Finding(
                "plan_check", "distribution", repr(p),
                "LSort is partition-sensitive but consumes a sharded "
                "input with no declared exchange"))
            return SHARDED
        if isinstance(p, LLimit):
            m = rec(p.child)
            if not managed_exchanges and is_dist(m):
                findings.append(Finding(
                    "plan_check", "distribution", repr(p),
                    "LIMIT over a sharded input with no declared gather "
                    "exchange (per-shard limits are not the global limit)"))
            return REPLICATED  # the compiler always gathers at LIMIT
        if isinstance(p, LUnion):
            for c in p.inputs:
                m = rec(c)
                if not managed_exchanges and is_dist(m):
                    findings.append(Finding(
                        "plan_check", "distribution", repr(p),
                        "UNION branch stays sharded with no declared "
                        "gather exchange"))
            return REPLICATED
        if p.children:
            for c in p.children:
                rec(c)
            return REPLICATED
        return REPLICATED

    root_mode = rec(plan)
    if not managed_exchanges and is_dist(root_mode):
        findings.append(Finding(
            "plan_check", "distribution", repr(plan),
            "root operator ends partitioned: results must gather to "
            "replicated before fetch"))
    return findings


# --- pass 6: multiway-join fusion invariants ----------------------------------


def check_multiway(plan: LogicalPlan, catalog) -> list:
    """The compiler may fuse an inner-join region into ONE multiway probe
    (sql/physical.multiway_join_chain behind SET join_multiway_strategy).
    Re-verify every fused level's load-bearing invariants INDEPENDENTLY of
    the eligibility code, so a compiler-side relaxation cannot silently
    ship a wrong fusion: each build must be provably unique on its key
    (the dense LUT keeps ONE row per slot — duplicates would silently
    drop matches), neither key side may be a dictionary-coded string (code
    vs value comparison), the declared dense range must cover the build
    key's catalog bounds, and level payloads must stay disjoint."""
    from ..sql.optimizer import col_origin
    from ..sql.physical import (
        LUT_JOIN_MAX_RANGE, multiway_join_chain, unique_sets,
    )

    findings = []

    def rec(p):
        for c in p.children:
            rec(c)
        if not isinstance(p, LJoin):
            return
        try:
            chain = multiway_join_chain(p, catalog)
        except Exception:  # noqa: BLE001 — fuzz plans: no fusion, no finding
            return
        if chain is None:
            return
        base, levels = chain
        seen = set(base.output_names())
        for jn, (pk, bk, lo, hi) in levels:
            pay = set(jn.right.output_names())
            if seen & pay:
                findings.append(Finding(
                    "plan_check", "multiway-fusion", repr(p),
                    f"fused level payload collides with earlier outputs: "
                    f"{sorted(seen & pay)}"))
            seen |= pay
            if not any(u <= frozenset((bk.name,))
                       for u in unique_sets(jn.right, catalog)):
                findings.append(Finding(
                    "plan_check", "multiway-fusion", repr(p),
                    f"fused build side is not provably unique on "
                    f"{bk.name}: the one-row-per-slot LUT would drop "
                    f"duplicate matches"))
            tl = _col_type(jn.left, pk.name, catalog)
            tr = _col_type(jn.right, bk.name, catalog)
            if (tl is not None and tl.is_string) or (
                    tr is not None and tr.is_string):
                findings.append(Finding(
                    "plan_check", "multiway-fusion", repr(p),
                    f"fused level keys {pk.name}={bk.name} involve a "
                    f"dictionary-coded string column"))
            if hi - lo + 1 > LUT_JOIN_MAX_RANGE:
                findings.append(Finding(
                    "plan_check", "multiway-fusion", repr(p),
                    f"fused level LUT range {hi - lo + 1} exceeds the "
                    f"planner cap {LUT_JOIN_MAX_RANGE}"))
            origin = col_origin(jn.right, bk.name)
            t = catalog.get_table(origin[0]) if origin else None
            st = t.column_stats(origin[1]) if t is not None else None
            if st is not None and st.min is not None and (
                    st.min < lo or st.max > hi):
                findings.append(Finding(
                    "plan_check", "multiway-fusion", repr(p),
                    f"dense range [{lo}, {hi}] does not cover the build "
                    f"key's catalog bounds [{st.min}, {st.max}]: "
                    f"out-of-range build rows would silently drop"))

    rec(plan)
    return findings


def check_plan(plan: LogicalPlan, catalog) -> list:
    """All structural passes (distribution in managed mode — the per-query
    hook must hold for single-chip plans too, where exchanges are moot)."""
    findings = []
    findings += check_schema(plan, catalog)
    findings += check_dtypes(plan, catalog)
    findings += check_capacities(plan, catalog)
    findings += check_null_semantics(plan, catalog)
    findings += check_multiway(plan, catalog)
    return findings
