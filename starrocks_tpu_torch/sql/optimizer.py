"""Rule-based optimizer.

Reference behavior: the Cascades CBO (fe sql/optimizer/QueryOptimizer.java:163,
165 transformation rules, cost model). The TPU build uses a pragmatic rule
pipeline over the logical tree — the search-space problems the memo solves
(join order, distribution enforcement) are handled with a greedy size-ordered
join enumeration driven by catalog row counts, which is what the reference's
cost model effectively picks for PK-FK star/snowflake joins like TPC-H/SSB:

1. pushdown_filters     — split conjuncts, inline through projects, push into
                          join inputs (fe rule analog: PushDownPredicate*)
2. rewrite_subqueries   — EXISTS/IN -> semi/anti join; correlated scalar agg
                          -> grouped subplan + left join (rule analog:
                          sql/optimizer/rule/transformation/*Apply* rules)
3. reorder_joins        — flatten inner-join regions, greedy smallest-build
                          left-deep order (cost-model stand-in)
4. pushdown_filters     — again, now over the new shape
5. prune_columns        — scans read only referenced columns (analog:
                          PruneScanColumnRule)
"""

from __future__ import annotations

import dataclasses

from ..exprs.ir import AggExpr, Call, Case, Cast, Col, Expr, InList, Lambda, Lit
from .analyzer import ScalarSubquery, SemiJoinMark, _conjuncts
from .logical import (
    LAggregate, LExchange, LFilter, LJoin, LLimit, LProject, LScan, LSort,
    LUnion, LUnnest, LWindow, LogicalPlan, walk_plan,
)


def optimize(plan: LogicalPlan, catalog, feedback=None) -> LogicalPlan:
    """`feedback` is a validated plan-feedback entry (runtime/feedback.py
    FeedbackStore.consult) or None; only the DP join ordering consumes it.
    Callers that pass one must key the result by the entry's consult token
    (the executor's opt_key does) — the same logical plan legally optimizes
    differently as observations accumulate."""
    from .mv_rewrite import try_rewrite as _mv_try_rewrite

    plan = _mv_try_rewrite(plan, catalog)  # before any rule reshapes it
    plan = rewrite_full_joins(plan)
    plan = rewrite_distinct_aggs(plan)
    plan = pushdown_filters(plan)
    plan = rewrite_subqueries(plan, catalog)
    plan = pushdown_filters(plan)
    plan = pushdown_semi_joins(plan, catalog)
    plan = pushdown_aggregation(plan, catalog)
    plan = reorder_joins(plan, catalog, feedback)
    plan = pushdown_filters(plan)
    plan = rewrite_window_topn(plan)
    plan = prune_columns(plan)
    return plan


# --- 0b. window TopN rewrite -------------------------------------------------


def rewrite_window_topn(plan: LogicalPlan) -> LogicalPlan:
    """`rank()/row_number()/dense_rank() <= k` filters over a window become
    per-partition segmented top-N pruning (reference analog: the TopN
    runtime filter that feeds the current heap threshold back into
    upstream scans, be/src/exec/topn_node + runtime_filter/; JSPIM's
    skew-aware select pruning is the same threshold-mask idea). The filter
    stays in place — the window node additionally DROPS rows ranked past k
    from its selection, so every operator above (the q67 shape: a 10-key
    ORDER BY LIMIT over the filtered window) sees ~k*partitions live rows
    and the planner can compact capacities to match."""
    from ..runtime.config import config as _cfg

    new_children = tuple(rewrite_window_topn(c) for c in plan.children)
    plan = _replace_children(plan, new_children)
    if not isinstance(plan, LFilter) or not _cfg.get("enable_window_topn"):
        return plan
    # locate a window below, resolving rank-column renames through pure
    # Col-passthrough projections
    projs = []
    node = plan.child
    while isinstance(node, LProject):
        projs.append(node)
        node = node.child
    if (not isinstance(node, LWindow) or not node.order_by
            or node.limit is not None):
        return plan
    rank_funcs = {f[0] for f in node.funcs
                  if f[1] in ("rank", "row_number", "dense_rank")}

    def resolve(name):
        for pr in projs:  # top-down renames back to window-level names
            e = dict(pr.exprs).get(name)
            if not isinstance(e, Col):
                return None
            name = e.name
        return name

    best = None
    for c in _conjuncts(plan.predicate):
        if not (isinstance(c, Call) and c.fn in ("le", "lt")
                and len(c.args) == 2 and isinstance(c.args[0], Col)
                and isinstance(c.args[1], Lit)
                and isinstance(c.args[1].value, int)
                and not isinstance(c.args[1].value, bool)):
            continue
        wname = resolve(c.args[0].name)
        if wname not in rank_funcs:
            continue
        k = c.args[1].value - (1 if c.fn == "lt" else 0)
        if k >= 0 and (best is None or k < best[1]):
            best = (wname, k)
    if best is None:
        return plan
    rebuilt = dataclasses.replace(node, limit=best)
    for pr in reversed(projs):
        rebuilt = LProject(rebuilt, pr.exprs)
    return LFilter(rebuilt, plan.predicate)


# --- 0a. FULL OUTER JOIN rewrite ---------------------------------------------


def rewrite_full_joins(plan: LogicalPlan) -> LogicalPlan:
    """FULL OUTER JOIN -> LEFT OUTER(L,R) UNION ALL the R rows that found no
    match, taken from LEFT OUTER(R,L) filtered on a NULL left join key (join
    keys never match NULL, so a NULL key column after the join marks an
    unmatched row; the join machinery produces correctly-typed NULL columns
    for free)."""
    new_children = tuple(rewrite_full_joins(c) for c in plan.children)
    plan = _replace_children(plan, new_children)
    if not isinstance(plan, LJoin) or plan.kind != "full":
        return plan
    if plan.condition is None:
        raise NotImplementedError("FULL OUTER JOIN requires an ON condition")
    lcols = frozenset(plan.left.output_names())
    rcols = frozenset(plan.right.output_names())
    probe_key = None
    equis, l_extras, r_extras = [], [], []
    for conj in _conjuncts(plan.condition):
        if (
            isinstance(conj, Call) and conj.fn == "eq" and len(conj.args) == 2
            and isinstance(conj.args[0], Col) and isinstance(conj.args[1], Col)
            and (
                (conj.args[0].name in lcols and conj.args[1].name in rcols)
                or (conj.args[1].name in lcols and conj.args[0].name in rcols)
            )
        ):
            a, b = conj.args
            if probe_key is None:
                probe_key = a.name if a.name in lcols else b.name
            equis.append(conj)
        elif expr_cols(conj) <= lcols:
            l_extras.append(conj)
        elif expr_cols(conj) <= rcols:
            r_extras.append(conj)
        else:
            raise NotImplementedError(
                "FULL OUTER JOIN with mixed-side non-equi ON conjuncts"
            )
    if probe_key is None:
        raise NotImplementedError(
            "FULL OUTER JOIN requires a column equality condition"
        )

    def wrap_keys(conds, extras, side_cols):
        """Preserved-side extras can't filter rows out of an outer join;
        instead the preserved side's join keys become NULL when the extras
        fail, so those rows simply never match (NULL keys never match)."""
        if not extras:
            return conds
        pred = and_all(extras)
        out = []
        for c in conds:
            a, b = c.args
            if a.name in side_cols:
                a = Call("if", pred, a, Lit(None))
            else:
                b = Call("if", pred, b, Lit(None))
            out.append(Call("eq", a, b))
        return out

    # b1 preserves L: L-side extras wrap L keys; R-side extras stay in the
    # condition (pushdown filters the R child — valid for the build side)
    b1_cond = and_all(wrap_keys(equis, l_extras, lcols) + r_extras)
    b1 = LJoin(plan.left, plan.right, "left", b1_cond)
    # b2 preserves R: symmetric
    b2_cond = and_all(wrap_keys(equis, r_extras, rcols) + l_extras)
    b2raw = LJoin(plan.right, plan.left, "left", b2_cond)
    unmatched = LFilter(b2raw, Call("is_null", Col(probe_key)))
    ordered = tuple(
        (n, Col(n)) for n in plan.left.output_names() + plan.right.output_names()
    )
    b2 = LProject(unmatched, ordered)
    b1p = LProject(b1, ordered)
    return LUnion((b1p, b2))


# --- 0. DISTINCT aggregate rewrite -------------------------------------------


def rewrite_distinct_aggs(plan: LogicalPlan) -> LogicalPlan:
    """agg(DISTINCT x) -> two-level aggregation (reference analog:
    SplitAggregateRule / distinct multi-stage agg in fe sql/optimizer):

    level 1 groups by (keys + x) — deduplicating x per group — and computes
    partial states of the non-distinct aggregates; level 2 re-groups by keys,
    merges partials, and evaluates the distinct agg over the deduped x."""
    new_children = tuple(rewrite_distinct_aggs(c) for c in plan.children)
    plan = _replace_children(plan, new_children)
    if not isinstance(plan, LAggregate) or not any(
        a.distinct for _, a in plan.aggs
    ):
        return plan

    dargs = {a.arg for _, a in plan.aggs if a.distinct}
    if len(dargs) != 1:
        raise NotImplementedError(
            "multiple DISTINCT aggregates with different arguments"
        )
    d_expr = next(iter(dargs))
    if d_expr is None:
        raise NotImplementedError("COUNT(DISTINCT *) is not meaningful")

    l1_group = plan.group_by + (("__darg", d_expr),)
    l1_aggs, l2_aggs, post = [], [], {}
    for name, a in plan.aggs:
        if a.distinct:
            # tuple extras are group_concat (expr, asc) ORDER BY items —
            # the level-2 aggregate could not re-evaluate them over the
            # level-1 output, so the rewrite must not fire either
            if any(isinstance(x, tuple)
                   or (isinstance(x, Expr) and not isinstance(x, Lit))
                   for x in a.extra):
                raise NotImplementedError(
                    f"DISTINCT with expression arguments in {a.fn} cannot "
                    "be two-level rewritten")
            l2_aggs.append((name, AggExpr(a.fn, Col("__darg"), extra=a.extra)))
        elif a.fn in ("count", "count_star"):
            l1_aggs.append((name, a))
            l2_aggs.append((name, AggExpr("sum", Col(name))))
        elif a.fn == "sum":
            l1_aggs.append((name, a))
            l2_aggs.append((name, AggExpr("sum", Col(name))))
        elif a.fn in ("min", "max"):
            l1_aggs.append((name, a))
            l2_aggs.append((name, AggExpr(a.fn, Col(name))))
        elif a.fn == "avg":
            l1_aggs.append((f"{name}__ds", AggExpr("sum", a.arg)))
            l1_aggs.append((f"{name}__dc", AggExpr("count", a.arg)))
            l2_aggs.append((f"{name}__ds", AggExpr("sum", Col(f"{name}__ds"))))
            l2_aggs.append((f"{name}__dc", AggExpr("sum", Col(f"{name}__dc"))))
            post[name] = Call("divide", Col(f"{name}__ds"), Col(f"{name}__dc"))
        elif a.fn in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            # carry moment sums through level 1 like avg's sum/count pair
            from .. import types as _T

            dx = Cast(a.arg, _T.DOUBLE)
            l1_aggs.append((f"{name}__s", AggExpr("sum", dx)))
            l1_aggs.append((f"{name}__q",
                            AggExpr("sum", Call("multiply", dx, dx))))
            l1_aggs.append((f"{name}__c", AggExpr("count", a.arg)))
            for sfx in ("__s", "__q", "__c"):
                l2_aggs.append((f"{name}{sfx}",
                                AggExpr("sum", Col(f"{name}{sfx}"))))
            n = Col(f"{name}__c")
            s_ = Col(f"{name}__s")
            q = Col(f"{name}__q")
            samp = a.fn.endswith("_samp")
            denom = Call("subtract", n, Lit(1)) if samp else n
            var = Call("greatest", Call("divide", Call(
                "subtract", q, Call("divide", Call("multiply", s_, s_), n)),
                denom), Lit(0.0))
            e = Call("sqrt", var) if a.fn.startswith("stddev") else var
            post[name] = Case(
                ((Call("gt", n, Lit(1 if samp else 0)), e),), Lit(None))
        else:
            raise NotImplementedError(
                f"non-distinct aggregate {a.fn} cannot be combined with a "
                f"DISTINCT aggregate in the same query yet")

    l1 = LAggregate(plan.child, l1_group, tuple(l1_aggs))
    l2_group = tuple((n, Col(n)) for n, _ in plan.group_by)
    l2 = LAggregate(l1, l2_group, tuple(l2_aggs))
    # restore the original output name list (group cols then agg names)
    out_exprs = [(n, Col(n)) for n, _ in plan.group_by]
    for name, _ in plan.aggs:
        out_exprs.append((name, post.get(name, Col(name))))
    return LProject(l2, tuple(out_exprs))


# --- expression helpers ------------------------------------------------------


def expr_cols(e: Expr) -> frozenset:
    out = set()

    def rec(x):
        if isinstance(x, Col):
            if not x.name.startswith("@lam."):
                out.add(x.name)  # lambda params are not plan columns
        elif isinstance(x, Lambda):
            rec(x.body)  # captured outer columns ARE requirements
        elif isinstance(x, Call):
            for a in x.args:
                rec(a)
        elif isinstance(x, Case):
            for c, v in x.whens:
                rec(c)
                rec(v)
            if x.orelse is not None:
                rec(x.orelse)
        elif isinstance(x, Cast):
            rec(x.arg)
        elif isinstance(x, InList):
            rec(x.arg)
        elif isinstance(x, AggExpr) and x.arg is not None:
            rec(x.arg)
        elif isinstance(x, SemiJoinMark):
            if x.probe_expr is not None:
                rec(x.probe_expr)
            for outer_c, _ in x.correlated:
                out.add(outer_c)
        elif isinstance(x, ScalarSubquery):
            for outer_c, _ in x.correlated:
                out.add(outer_c)

    rec(e)
    return frozenset(out)


def substitute(e: Expr, mapping: dict) -> Expr:
    """Replace Col(name) by mapping[name] expressions."""
    if isinstance(e, Col):
        return mapping.get(e.name, e)
    if isinstance(e, Lambda):
        return Lambda(e.params, substitute(e.body, mapping))
    if isinstance(e, Call):
        return Call(e.fn, *[substitute(a, mapping) for a in e.args])
    if isinstance(e, Case):
        return Case(
            tuple((substitute(c, mapping), substitute(v, mapping)) for c, v in e.whens),
            substitute(e.orelse, mapping) if e.orelse is not None else None,
        )
    if isinstance(e, Cast):
        return Cast(substitute(e.arg, mapping), e.to)
    if isinstance(e, InList):
        return InList(substitute(e.arg, mapping), e.values, e.negated)
    if isinstance(e, AggExpr):
        return AggExpr(
            e.fn, substitute(e.arg, mapping) if e.arg is not None else None,
            e.distinct,
            tuple(substitute(x, mapping) if isinstance(x, Expr) else x
                  for x in e.extra),
        )
    if isinstance(e, SemiJoinMark):
        return SemiJoinMark(
            e.plan, e.correlated,
            substitute(e.probe_expr, mapping) if e.probe_expr is not None else None,
            e.inner_col, e.negated,
        )
    return e


def probe_scan_chain(plan: LogicalPlan):
    """(scan, chain) when `plan` is a pure LFilter/LProject chain over an
    LScan (chain listed top-down, possibly empty); (None, []) otherwise.

    The shape runtime-filter pushdown needs: filters/projects are row-wise,
    so a probe mask computed against the BOTTOM scan commutes with the whole
    chain — masking + compacting there shrinks capacity before any upstream
    expression work instead of after it."""
    chain = []
    node = plan
    while isinstance(node, (LFilter, LProject)):
        chain.append(node)
        node = node.child
    if isinstance(node, LScan):
        return node, chain
    return None, []


def keys_through_chain(keys, chain, scan: LScan):
    """Rewrite exprs phrased over the chain TOP's output names into exprs
    over the bottom scan's columns (substituting through each LProject's
    rename/computation). None when any key fails to resolve into pure scan
    columns — then the caller must apply its mask above the chain."""
    exprs = list(keys)
    for node in chain:  # top-down: undo each projection's renames
        if isinstance(node, LProject):
            mapping = dict(node.exprs)
            exprs = [substitute(e, mapping) for e in exprs]
    scan_cols = frozenset(scan.output_names())
    for e in exprs:
        try:
            cols = expr_cols(e)
        except Exception:  # noqa: BLE001 — unexpected expr shapes: no pushdown
            return None
        if not cols or not cols <= scan_cols:
            return None
    return exprs


def _disjuncts(e: Expr):
    if isinstance(e, Call) and e.fn == "or":
        for a in e.args:
            yield from _disjuncts(a)
    else:
        yield e


def or_all(disjuncts) -> Expr:
    disjuncts = list(disjuncts)
    e = disjuncts[0]
    for d in disjuncts[1:]:
        e = Call("or", e, d)
    return e


def factor_or(pred: Expr) -> list:
    """(A AND X AND ..) OR (B AND X AND ..) -> [X, (A AND ..) OR (B AND ..)].

    Pulls conjuncts common to every OR branch out of the disjunction — the
    classic rewrite that turns TPC-H Q19's 'three OR-ed bundles each
    repeating the join predicate' into an extractable equi-join key
    (reference analog: common-predicate extraction in the fe optimizer)."""
    if not (isinstance(pred, Call) and pred.fn == "or"):
        return [pred]
    branch_sets = [list(_conjuncts(b)) for b in _disjuncts(pred)]
    common = [c for c in branch_sets[0] if all(c in bs for bs in branch_sets[1:])]
    if not common:
        return [pred]
    residuals = []
    for bs in branch_sets:
        rest = [c for c in bs if c not in common]
        residuals.append(and_all(rest) if rest else Lit(True))
    if all(r == Lit(True) for r in residuals):
        return common  # some branch was exactly the common set: OR is vacuous
    return common + [or_all(residuals)]


def and_all(conjuncts) -> Expr:
    conjuncts = list(conjuncts)
    if not conjuncts:
        return Lit(True)
    e = conjuncts[0]
    for c in conjuncts[1:]:
        e = Call("and", e, c)
    return e


# --- 1. filter pushdown ------------------------------------------------------


def pushdown_filters(plan: LogicalPlan) -> LogicalPlan:
    return _push(plan, [])


def _push(plan: LogicalPlan, preds: list) -> LogicalPlan:
    """preds: conjuncts from above to place as deep as possible."""
    if isinstance(plan, LFilter):
        incoming = [
            f for c in _conjuncts(plan.predicate) for f in factor_or(c)
        ]
        return _push(plan.child, preds + incoming)

    if isinstance(plan, LProject):
        mapping = dict(plan.exprs)
        inlined, stay = [], []
        for p in preds:
            if _has_marker(p) or any(
                _contains_agg_expr(mapping.get(c, Lit(0))) for c in expr_cols(p)
            ):
                stay.append(p)
            else:
                inlined.append(substitute(p, mapping))
        child = _push(plan.child, inlined)
        out = LProject(child, plan.exprs)
        return _wrap(out, stay)

    if isinstance(plan, LJoin):
        lcols = frozenset(plan.left.output_names())
        rcols = frozenset(plan.right.output_names())
        lpreds, rpreds, stay, markers = [], [], [], []
        join_conjuncts = (
            [f for c in _conjuncts(plan.condition) for f in factor_or(c)]
            if plan.condition is not None else []
        )
        if plan.kind == "full":
            left = _push(plan.left, [])
            right = _push(plan.right, [])
            return _wrap(LJoin(left, right, plan.kind, plan.condition), preds)
        pool = preds + (join_conjuncts if plan.kind in ("inner", "cross") else [])
        for p in pool:
            cols = expr_cols(p)
            outer_free = {c for c in cols if c.startswith("@outer.")}
            cols = cols - outer_free
            if _has_marker(p):
                # subquery markers must stay in a Filter for the rewriter;
                # never fold them into a join condition
                markers.append(p)
            elif cols <= lcols and not outer_free:
                lpreds.append(p)
            elif cols <= rcols and not outer_free and plan.kind in (
                "inner", "cross", "semi", "anti"
            ):
                # NOT pushable for "left": right-side predicates from above a
                # left join would wrongly filter NULL-extended rows below it
                rpreds.append(p)
            else:
                stay.append(p)
        join_cond = plan.condition
        if plan.kind == "left" and join_cond is not None:
            # ON conjuncts referencing only the right side pre-filter the
            # build side (valid: they run before NULL-extension)
            keep = []
            for c in _conjuncts(join_cond):
                cc = expr_cols(c)
                if cc <= rcols and not _has_marker(c):
                    rpreds.append(c)
                else:
                    keep.append(c)
            join_cond = and_all(keep) if keep else None
        left = _push(plan.left, lpreds)
        right = _push(plan.right, rpreds)
        if plan.kind in ("inner", "cross"):
            if not stay:
                return _wrap(LJoin(left, right, plan.kind, None), markers)
            return _wrap(LJoin(left, right, "inner", and_all(stay)), markers)
        out = LJoin(left, right, plan.kind, join_cond)
        return _wrap(out, stay + markers)

    if isinstance(plan, LAggregate):
        group_names = {n for n, _ in plan.group_by}
        mapping = dict(plan.group_by)
        down, stay = [], []
        for p in preds:
            if not _has_marker(p) and expr_cols(p) <= group_names:
                down.append(substitute(p, mapping))
            else:
                stay.append(p)
        child = _push(plan.child, down)
        return _wrap(LAggregate(child, plan.group_by, plan.aggs), stay)

    if isinstance(plan, LWindow):
        # conservative: filters stay above the window (pushing below would be
        # valid only for partition-key-only predicates)
        child = _push(plan.child, [])
        return _wrap(dataclasses.replace(plan, child=child), preds)

    if isinstance(plan, LUnnest):
        ccols = frozenset(plan.child.output_names())
        down = [p for p in preds
                if not _has_marker(p) and expr_cols(p) <= ccols]
        stay = [p for p in preds if p not in down]
        child = _push(plan.child, down)
        return _wrap(LUnnest(child, plan.expr, plan.out_name), stay)

    if isinstance(plan, LUnion):
        # a filter over a union pushes into every input (same output names)
        pushable = [p for p in preds if not _has_marker(p)]
        stay = [p for p in preds if _has_marker(p)]
        kids = tuple(_push(c, list(pushable)) for c in plan.inputs)
        return _wrap(LUnion(kids), stay)

    if isinstance(plan, (LSort, LLimit)):
        # a pure sort is transparent to filters, but a fused TopN (or LIMIT)
        # is not: filtering before "pick k rows" changes which rows survive
        if isinstance(plan, LSort) and plan.limit is None:
            child = _push(plan.child, preds)
            return LSort(child, plan.keys, None)
        child = _push(plan.child, [])
        return _wrap(dataclasses.replace(plan, child=child), preds)

    # leaf (LScan)
    return _wrap(plan, preds)


def _wrap(plan: LogicalPlan, preds: list) -> LogicalPlan:
    if not preds:
        return plan
    return LFilter(plan, and_all(preds))


def _has_marker(e: Expr) -> bool:
    if isinstance(e, (ScalarSubquery, SemiJoinMark)):
        return True
    if isinstance(e, Call):
        return any(_has_marker(a) for a in e.args)
    if isinstance(e, Case):
        return any(_has_marker(c) or _has_marker(v) for c, v in e.whens) or (
            e.orelse is not None and _has_marker(e.orelse)
        )
    if isinstance(e, Cast):
        return _has_marker(e.arg)
    if isinstance(e, InList):
        return _has_marker(e.arg)
    return False


def _contains_agg_expr(e: Expr) -> bool:
    if isinstance(e, AggExpr):
        return True
    if isinstance(e, Call):
        return any(_contains_agg_expr(a) for a in e.args)
    return False


# --- 2. subquery rewrites ----------------------------------------------------


def rewrite_subqueries(plan: LogicalPlan, catalog) -> LogicalPlan:
    if isinstance(plan, LFilter):
        child = rewrite_subqueries(plan.child, catalog)
        conjuncts = list(_conjuncts(plan.predicate))
        plain, markers = [], []
        for c in conjuncts:
            (markers if _has_marker(c) else plain).append(c)
        out = _wrap(child, plain)
        for m in markers:
            out = _apply_marker(out, m, catalog)
        return out

    new_children = tuple(rewrite_subqueries(c, catalog) for c in plan.children)
    return _replace_children(plan, new_children)


def _replace_children(plan, new_children):
    if isinstance(plan, LFilter):
        return LFilter(new_children[0], plan.predicate)
    if isinstance(plan, LProject):
        return LProject(new_children[0], plan.exprs)
    if isinstance(plan, LJoin):
        return LJoin(new_children[0], new_children[1], plan.kind, plan.condition)
    if isinstance(plan, LAggregate):
        return LAggregate(new_children[0], plan.group_by, plan.aggs)
    if isinstance(plan, LWindow):
        return dataclasses.replace(plan, child=new_children[0])
    if isinstance(plan, LUnion):
        return LUnion(tuple(new_children))
    if isinstance(plan, LSort):
        return LSort(new_children[0], plan.keys, plan.limit)
    if isinstance(plan, LLimit):
        return LLimit(new_children[0], plan.limit, plan.offset)
    if isinstance(plan, LUnnest):
        return LUnnest(new_children[0], plan.expr, plan.out_name)
    if isinstance(plan, LScan):
        return plan
    raise TypeError(type(plan))


def _strip_correlation(plan: LogicalPlan, removed: list | None = None) -> LogicalPlan:
    """Remove filter conjuncts referencing @outer columns.

    When `removed` is given, the stripped conjuncts are appended to it so the
    caller can re-attach non-equi correlated predicates as join residuals."""
    if isinstance(plan, LFilter):
        child = _strip_correlation(plan.child, removed)
        keep = []
        for c in _conjuncts(plan.predicate):
            if any(x.startswith("@outer.") for x in expr_cols(c)):
                if removed is not None:
                    removed.append(c)
            else:
                keep.append(c)
        return _wrap(child, keep)
    return _replace_children(
        plan, tuple(_strip_correlation(c, removed) for c in plan.children)
    )


def _unouter(e: Expr) -> Expr:
    """Rewrite Col('@outer.x') -> Col('x') (used once the subquery joins the
    outer plan, so outer columns are in scope)."""
    if isinstance(e, Col) and e.name.startswith("@outer."):
        return Col(e.name[len("@outer."):])
    if isinstance(e, Call):
        return Call(e.fn, *[_unouter(a) for a in e.args])
    if isinstance(e, Cast):
        return Cast(_unouter(e.arg), e.to)
    if isinstance(e, Case):
        return Case(
            tuple((_unouter(c), _unouter(v)) for c, v in e.whens),
            _unouter(e.orelse) if e.orelse is not None else None,
        )
    if isinstance(e, InList):
        return InList(_unouter(e.arg), e.values, e.negated)
    return e


def _expose_columns(plan: LogicalPlan, cols) -> LogicalPlan:
    """Ensure `cols` appear in the plan's output (for semi-join keys that
    reference columns below the subquery's top projection)."""
    missing = [c for c in cols if c not in plan.output_names()]
    if not missing:
        return plan
    if isinstance(plan, (LSort, LLimit, LWindow)):
        return _replace_children(plan, (_expose_columns(plan.child, cols),))
    if isinstance(plan, LProject):
        child_out = plan.child.output_names()
        if all(c in child_out for c in missing):
            return LProject(
                plan.child, plan.exprs + tuple((c, Col(c)) for c in missing)
            )
    raise NotImplementedError(
        f"cannot expose correlated columns {missing} through {plan!r}"
    )


def _apply_marker(outer_plan: LogicalPlan, conjunct: Expr, catalog) -> LogicalPlan:
    """Turn a marker conjunct into a join against the subquery plan."""
    # Plain NOT around a marker flips it
    if (
        isinstance(conjunct, Call)
        and conjunct.fn == "not"
        and isinstance(conjunct.args[0], SemiJoinMark)
    ):
        m = conjunct.args[0]
        conjunct = SemiJoinMark(
            m.plan, m.correlated, m.probe_expr, m.inner_col, not m.negated
        )
    # Case A: bare SemiJoinMark (EXISTS / IN subquery)
    if isinstance(conjunct, SemiJoinMark):
        m = conjunct
        removed: list = []
        sub = _strip_correlation(m.plan, removed)
        sub = rewrite_full_joins(sub)
        sub = rewrite_distinct_aggs(sub)
        sub = rewrite_subqueries(sub, catalog)
        # equality pairs become join keys; other correlated conjuncts
        # (e.g. TPC-H Q21's l2.l_suppkey <> l1.l_suppkey) become residual
        # predicates on the semi/anti join
        corr_set = {
            (oc, ic) for oc, ic in m.correlated
        }
        residuals = []
        inner_names = [ic for _, ic in m.correlated]
        for c in removed:
            if (
                isinstance(c, Call) and c.fn == "eq" and len(c.args) == 2
                and isinstance(c.args[0], Col) and isinstance(c.args[1], Col)
                and (
                    (c.args[0].name[len("@outer."):], c.args[1].name) in corr_set
                    or (c.args[1].name[len("@outer."):], c.args[0].name) in corr_set
                )
            ):
                continue  # this is one of the extracted equi pairs
            resid = _unouter(c)
            residuals.append(resid)
            outer_out = frozenset(outer_plan.output_names())
            inner_names.extend(
                n for n in expr_cols(resid) if n not in outer_out
            )
        if m.inner_col is not None:
            inner_names.append(m.inner_col)
        sub = _expose_columns(sub, inner_names)
        outer_keys = [Col(oc) for oc, _ in m.correlated]
        inner_keys = [Col(ic) for _, ic in m.correlated]
        if m.probe_expr is not None:
            outer_keys.append(m.probe_expr)
            inner_keys.append(Col(m.inner_col))
        if not outer_keys:
            raise NotImplementedError("uncorrelated EXISTS not supported yet")
        cond = and_all(
            [Call("eq", ok, ik) for ok, ik in zip(outer_keys, inner_keys)]
            + residuals
        )
        return LJoin(outer_plan, sub, "anti" if m.negated else "semi", cond)

    # Case B: comparison containing a correlated ScalarSubquery:
    #   expr CMP (select agg(...) from ... where inner = @outer.col ...)
    marker = _find_scalar_marker(conjunct)
    if marker is None:
        marks = _find_semijoin_marks(conjunct)
        if marks:
            if _mark_under_not(conjunct):
                # not(x in (sub)) under OR would need true NOT IN NULL
                # semantics, which the is-not-null mark flag cannot express
                raise NotImplementedError(
                    "negated subquery inside a general predicate is not "
                    "supported yet")
            # Case C: mark join — EXISTS/IN embedded in a general predicate
            # (typically under OR, e.g. TPC-DS Q45). LEFT-join distinct
            # subquery keys and substitute the mark with IS NOT NULL on the
            # joined key, then restore the outer schema.
            plan = outer_plan
            repl = {}
            for idx, m in enumerate(marks):
                plan, flag = _apply_mark_join(plan, m, idx, catalog)
                repl[id(m)] = flag
            new_pred = _subst_marks(conjunct, repl)
            filtered = LFilter(plan, new_pred)
            keep = tuple((n, Col(n)) for n in outer_plan.output_names())
            return LProject(filtered, keep)
        raise NotImplementedError(f"unsupported subquery pattern: {conjunct!r}")
    if not marker.correlated:
        sub = rewrite_full_joins(marker.plan)
        sub = rewrite_subqueries(sub, catalog)
        # Single-program inline for guaranteed-one-row subqueries (a global
        # aggregate never returns 0 or 2+ rows): CROSS-join the one-row
        # result and substitute its column for the marker. One compiled
        # program instead of a separate host-resolved execution — and a CTE
        # shared between the subquery and the outer side (TPC-H Q15's
        # revenue0) emits ONCE via the emitter's by-value memo, which also
        # makes float equality against the re-computed aggregate exact.
        # Other shapes keep the host-resolved path (0-row -> NULL and
        # >1-row errors need runtime checks).
        if (isinstance(sub, LProject) and isinstance(sub.child, LAggregate)
                and not sub.child.group_by and len(sub.exprs) == 1):
            sub = rewrite_distinct_aggs(sub)
            val = LProject(sub, (("subq_val", Col(sub.output_names()[0])),))
            joined = LJoin(outer_plan, val, "cross", None)
            new_pred = _replace_scalar_marker(conjunct, marker,
                                              Col("subq_val"))
            filtered = LFilter(joined, new_pred)
            keep = tuple((n, Col(n)) for n in outer_plan.output_names())
            return LProject(filtered, keep)
        # uncorrelated non-aggregate scalar: leave in place; the executor
        # evaluates it first
        return LFilter(outer_plan, conjunct)

    # NOTE: no distinct-agg rewrite here — the pattern match below needs the
    # original single-LAggregate shape; the rewrite applies to `grouped`.
    sub = _strip_correlation(marker.plan)
    sub = rewrite_full_joins(sub)
    sub = rewrite_subqueries(sub, catalog)
    # locate the aggregate inside (LProject over LAggregate with no group keys)
    if not (
        isinstance(sub, LProject)
        and isinstance(sub.child, LAggregate)
        and not sub.child.group_by
        and len(sub.exprs) == 1
    ):
        raise NotImplementedError(
            "correlated scalar subquery must be a single aggregate"
        )
    agg = sub.child
    inner_cols = tuple(ic for _, ic in marker.correlated)
    outer_cols = tuple(oc for oc, _ in marker.correlated)
    agg_input = agg.child
    # Magic-set reduction (reference analog: the CBO's runtime-filter
    # pushdown across exchanges, be/src/exec/pipeline RF; here a
    # compile-time plan rewrite): the LEFT join below only consumes groups
    # whose correlation keys exist on the outer side, so when the outer
    # side is much smaller than the subquery input, SEMI-join the input
    # down to the outer key set BEFORE aggregating (TPC-H Q2/Q17/Q20: the
    # min/avg/sum runs over a few thousand surviving keys instead of the
    # whole fact table). The duplicated outer subtree costs ~nothing: the
    # physical emitter memoizes node emission by value. Safe because
    # semi-dropped groups could never join (their keys are absent on the
    # outer side) and NULL keys never satisfy the eq join condition.
    inner_aliases = {n.split(".", 1)[0] for n in agg_input.output_names()}
    outer_aliases = {oc.split(".", 1)[0] for oc in outer_cols}
    if not (outer_aliases & inner_aliases):
        outer_rows = estimate_rows(outer_plan, catalog)
        # the agg's cost scales with its input CAPACITY — under static
        # shapes that is the largest base table in the subtree, not the
        # (unreliable pre-join-ordering) join-size estimate
        inner_mass = max(
            (float(catalog.get_table(n.table).row_count)
             for n in walk_plan(agg_input)
             if isinstance(n, LScan) and catalog.get_table(n.table)),
            default=0.0,
        )
        if inner_mass > 50_000 and outer_rows < 0.1 * inner_mass:
            seen = set()
            uniq = tuple(oc for oc in outer_cols
                         if not (oc in seen or seen.add(oc)))
            keys = LProject(outer_plan, tuple((oc, Col(oc)) for oc in uniq))
            semi_cond = and_all(
                Call("eq", Col(ic), Col(oc))
                for ic, oc in zip(inner_cols, outer_cols)
            )
            agg_input = LJoin(agg_input, keys, "semi", semi_cond)
    group_by = tuple((f"corr_{i}", Col(ic)) for i, ic in enumerate(inner_cols))
    grouped = rewrite_distinct_aggs(LAggregate(agg_input, group_by, agg.aggs))
    val_name = "subq_val"
    proj = LProject(
        grouped,
        tuple((f"corr_{i}", Col(f"corr_{i}")) for i in range(len(inner_cols)))
        + ((val_name, sub.exprs[0][1]),),
    )
    cond = and_all(
        Call("eq", Col(oc), Col(f"corr_{i}")) for i, oc in enumerate(outer_cols)
    )
    joined = LJoin(outer_plan, proj, "left", cond)
    new_pred = _replace_scalar_marker(conjunct, marker, Col(val_name))
    filtered = LFilter(joined, new_pred)
    # drop the helper columns again
    keep = tuple((n, Col(n)) for n in outer_plan.output_names())
    return LProject(filtered, keep)


def _mark_under_not(e: Expr, under_not: bool = False) -> bool:
    """True when any SemiJoinMark sits beneath a NOT (any depth)."""
    if isinstance(e, SemiJoinMark):
        return under_not
    if isinstance(e, Call):
        inner = under_not or e.fn == "not"
        return any(_mark_under_not(a, inner) for a in e.args)
    if isinstance(e, Cast):
        return _mark_under_not(e.arg, under_not)
    if isinstance(e, Case):
        return any(
            _mark_under_not(c, under_not) or _mark_under_not(v, under_not)
            for c, v in e.whens
        ) or (e.orelse is not None and _mark_under_not(e.orelse, under_not))
    if isinstance(e, InList):
        return _mark_under_not(e.arg, under_not)
    return False


def _find_semijoin_marks(e: Expr, out=None):
    if out is None:
        out = []
    if isinstance(e, SemiJoinMark):
        out.append(e)
    elif isinstance(e, Call):
        for a in e.args:
            _find_semijoin_marks(a, out)
    elif isinstance(e, Cast):
        _find_semijoin_marks(e.arg, out)
    elif isinstance(e, Case):
        for c, v in e.whens:
            _find_semijoin_marks(c, out)
            _find_semijoin_marks(v, out)
        if e.orelse is not None:
            _find_semijoin_marks(e.orelse, out)
    elif isinstance(e, InList):
        _find_semijoin_marks(e.arg, out)
    return out


def _subst_marks(e: Expr, repl: dict) -> Expr:
    if isinstance(e, SemiJoinMark):
        flag = repl.get(id(e))
        if flag is not None:
            return Call("is_not_null", Col(flag))
        return e
    if isinstance(e, Call):
        return Call(e.fn, *[_subst_marks(a, repl) for a in e.args])
    if isinstance(e, Cast):
        return Cast(_subst_marks(e.arg, repl), e.to)
    if isinstance(e, Case):
        return Case(
            tuple((_subst_marks(c, repl), _subst_marks(v, repl))
                  for c, v in e.whens),
            _subst_marks(e.orelse, repl) if e.orelse is not None else None,
        )
    if isinstance(e, InList):
        return InList(_subst_marks(e.arg, repl), e.values, e.negated)
    return e


def _apply_mark_join(outer_plan: LogicalPlan, m: SemiJoinMark, idx: int,
                     catalog):
    """LEFT-join the subquery's distinct key columns onto the outer plan;
    the last joined key doubles as the match flag (non-NULL = matched).
    Returns (joined_plan, flag_column_name). Reference analog: the CBO's
    mark-join for disjunctive subqueries."""
    if m.negated:
        raise NotImplementedError(
            "NOT IN / NOT EXISTS inside OR is not supported yet")
    removed: list = []
    sub = _strip_correlation(m.plan, removed)
    sub = rewrite_full_joins(sub)
    sub = rewrite_distinct_aggs(sub)
    sub = rewrite_subqueries(sub, catalog)
    corr_set = set(m.correlated)
    for c in removed:
        ok = (
            isinstance(c, Call) and c.fn == "eq" and len(c.args) == 2
            and isinstance(c.args[0], Col) and isinstance(c.args[1], Col)
            and (
                (c.args[0].name[len("@outer."):], c.args[1].name) in corr_set
                or (c.args[1].name[len("@outer."):], c.args[0].name)
                in corr_set
            )
        )
        if not ok:
            raise NotImplementedError(
                "non-equi correlated predicate in a subquery inside OR")
    inner_names = [ic for _, ic in m.correlated]
    if m.inner_col is not None and m.inner_col not in inner_names:
        inner_names.append(m.inner_col)
    if not inner_names:
        raise NotImplementedError("uncorrelated EXISTS inside OR")
    sub = _expose_columns(sub, inner_names)
    renames = {ic: f"__mark{idx}_{j}" for j, ic in enumerate(inner_names)}
    # distinct keys (renamed to collision-proof mark columns) so the LEFT
    # join cannot duplicate outer rows
    sub = LAggregate(
        sub, tuple((renames[ic], Col(ic)) for ic in inner_names), ())
    outer_keys = [Col(oc) for oc, _ in m.correlated]
    inner_keys = [Col(renames[ic]) for _, ic in m.correlated]
    if m.probe_expr is not None:
        outer_keys.append(m.probe_expr)
        inner_keys.append(Col(renames[m.inner_col]))
    cond = and_all(
        [Call("eq", ok_, ik) for ok_, ik in zip(outer_keys, inner_keys)])
    joined = LJoin(outer_plan, sub, "left", cond)
    return joined, inner_keys[-1].name


def _find_scalar_marker(e: Expr):
    if isinstance(e, ScalarSubquery):
        return e
    if isinstance(e, Call):
        for a in e.args:
            m = _find_scalar_marker(a)
            if m is not None:
                return m
    if isinstance(e, Cast):
        return _find_scalar_marker(e.arg)
    return None


def _replace_scalar_marker(e: Expr, marker, replacement: Expr) -> Expr:
    if e is marker:
        return replacement
    if isinstance(e, Call):
        return Call(e.fn, *[_replace_scalar_marker(a, marker, replacement) for a in e.args])
    if isinstance(e, Cast):
        return Cast(_replace_scalar_marker(e.arg, marker, replacement), e.to)
    return e


# --- 3. join reordering ------------------------------------------------------


def _filter_selectivity(pred, child, catalog) -> float:
    """Stats-aware selectivity (reference: the CBO's PredicateStatisticsCalculator
    re-designed on exact NDV): eq-vs-literal = 1/NDV, IN-list = k/NDV,
    LIKE = 0.1, range conjunct = 0.3, anything else 0.25; conjuncts
    multiply with a floor so stacked guesses can't zero out."""
    def col_ndv(e) -> float | None:
        if not isinstance(e, Col):
            return None
        origin = col_origin(child, e.name)
        if origin is None:
            return None
        t = catalog.get_table(origin[0])
        if t is None:
            return None
        ndv = t.column_ndv(origin[1])
        return float(ndv) if ndv else None

    sel = 1.0
    for c in _conjuncts(pred):
        s = 0.25
        if isinstance(c, InList) and not c.negated:
            ndv = col_ndv(c.arg)
            if ndv:
                s = min(len(c.values) / ndv, 1.0)
        elif isinstance(c, Call) and len(c.args) == 2:
            a, b = c.args
            lit_side = isinstance(b, Lit) or isinstance(a, Lit)
            col = a if isinstance(a, Col) else (b if isinstance(b, Col)
                                                else None)
            if c.fn == "eq" and lit_side and col is not None:
                ndv = col_ndv(col)
                if ndv:
                    s = 1.0 / ndv
            elif c.fn in ("ge", "gt", "le", "lt") and lit_side:
                s = 0.3
            elif c.fn == "like":
                s = 0.1
        sel *= s
    return max(sel, 1e-4)


def estimate_rows(plan: LogicalPlan, catalog) -> float:
    if isinstance(plan, LExchange):
        # repartition moves rows, it doesn't create or drop them — stats
        # walkers see through annotated (fragment-IR) plans unchanged
        return estimate_rows(plan.child, catalog)
    if isinstance(plan, LScan):
        t = catalog.get_table(plan.table)
        return float(t.row_count if t is not None else 1000)
    if isinstance(plan, LFilter):
        return _filter_selectivity(
            plan.predicate, plan.child, catalog
        ) * estimate_rows(plan.child, catalog)
    if isinstance(plan, LProject):
        return estimate_rows(plan.child, catalog)
    if isinstance(plan, LAggregate):
        child_est = estimate_rows(plan.child, catalog)
        if plan.group_by:
            # NDV-product estimate capped by input rows (the standard
            # group-count formula; the old flat /10 systematically
            # undershot re-aggregations — a chained ROLLUP level would
            # seed a too-small compaction and pay one overflow recompile
            # per level)
            prod = 1.0
            resolvable = True
            for _, e in plan.group_by:
                if not isinstance(e, Col):
                    resolvable = False
                    break
                ndv = _col_ndv_deep(plan.child, e.name, catalog)
                if ndv is None:
                    resolvable = False
                    break
                prod *= max(ndv, 1)
                if prod >= child_est:
                    break
            if resolvable:
                return max(1.0, min(prod, child_est))
        return max(1.0, child_est / 10.0)
    if isinstance(plan, LJoin):
        l = estimate_rows(plan.left, catalog)
        r = estimate_rows(plan.right, catalog)
        if plan.kind in ("semi", "anti"):
            # containment: the probe keeps at most as many key groups as the
            # build has rows — l * |S| / NDV(probe key) (flat 0.5 otherwise)
            frac = 0.5
            if plan.condition is not None:
                eqs = [c for c in _conjuncts(plan.condition)
                       if isinstance(c, Call) and c.fn == "eq"
                       and len(c.args) == 2]
                if len(eqs) == 1:
                    a, b = eqs[0].args
                    lcol = (a if isinstance(a, Col)
                            and col_origin(plan.left, a.name) else
                            (b if isinstance(b, Col) else None))
                    if lcol is not None:
                        ndv = _key_ndv(plan.left, lcol.name, l, catalog)
                        frac = min(estimate_rows(plan.right, catalog)
                                   / max(ndv, 1.0), 1.0)
            if plan.kind == "anti":
                frac = 1.0 - 0.5 * frac  # anti keeps the complement-ish
            return max(l * frac, 1.0)
        if plan.kind in ("inner", "left") and plan.condition is not None:
            # composite-key System-R estimate (same formula as _dp_order):
            # |L ⋈ R| = |L||R| / max(side composite NDVs), each side's key-
            # tuple NDV capped by its row count. Drives maybe_compact: a
            # selective dimension join shrinks the probe for downstream ops.
            prod_l = prod_r = 1.0
            n_eq = n_res = 0
            l_cols, r_cols = [], []
            for c in _conjuncts(plan.condition):
                eq = None
                if isinstance(c, Call) and c.fn == "eq" and len(c.args) == 2:
                    a, b = c.args
                    if isinstance(a, Col) and isinstance(b, Col):
                        la = col_origin(plan.left, a.name)
                        rb = col_origin(plan.right, b.name)
                        if la is None or rb is None:  # maybe swapped
                            a, b = b, a
                            la = col_origin(plan.left, a.name)
                            rb = col_origin(plan.right, b.name)
                        if la is not None and rb is not None:
                            eq = (a.name, b.name)
                if eq is not None:
                    n_eq += 1
                    prod_l *= _key_ndv(plan.left, eq[0], l, catalog)
                    prod_r *= _key_ndv(plan.right, eq[1], r, catalog)
                    l_cols.append(eq[0])
                    r_cols.append(eq[1])
                else:
                    n_res += 1
            if n_eq:
                est = join_fan_rows(l, r, prod_l, prod_r, n_res)
                # PK-FK override (see _pk_table_rows)
                pk_cands = []
                for rel, cols, this_r, other_r in (
                        (plan.right, r_cols, r, l),
                        (plan.left, l_cols, l, r)):
                    tr = _pk_table_rows(rel, cols, catalog)
                    if tr:
                        pk_cands.append(
                            other_r * this_r / tr * (0.25 ** n_res))
                if pk_cands:
                    est = max(min(pk_cands), 1.0)
                if plan.kind == "left":
                    est = max(est, l)
                return est
        return max(l, r)
    if isinstance(plan, (LSort, LLimit, LWindow)):
        est = estimate_rows(plan.child, catalog)
        if isinstance(plan, (LSort, LLimit)) and plan.limit is not None:
            est = min(est, float(plan.limit + getattr(plan, "offset", 0)))
        if isinstance(plan, LWindow) and plan.limit is not None:
            # segmented top-N keeps <= ~k rows per partition (rank ties can
            # exceed k; maybe_compact's 1.5x headroom + overflow recompile
            # absorb that)
            _, k = plan.limit
            ndv = _partition_ndv(plan.child, plan.partition_by, catalog)
            if ndv is not None:
                est = min(est, float((k + 1) * (ndv + 1)))
            elif not plan.partition_by:
                est = min(est, float(k + 1))
        return est
    if isinstance(plan, LUnnest):
        return 4.0 * estimate_rows(plan.child, catalog)
    if isinstance(plan, LUnion):
        return sum(estimate_rows(c, catalog) for c in plan.inputs)
    return 1000.0


def _col_ndv_deep(plan: LogicalPlan, name: str, catalog):
    """Distinct-count estimate for a column that may pass through UNION
    branches (which col_origin deliberately refuses — per-branch value
    BOUNDS differ, so runtime-filter callers must not see through unions;
    an NDV estimate may). ROLLUP/CUBE branches project dropped keys as
    null_of(...) -> exactly one value. None = unresolvable."""
    if isinstance(plan, LUnion):
        total = 0
        for c in plan.inputs:
            n = _col_ndv_deep(c, name, catalog)
            if n is None:
                return None
            total += n
        return total
    if isinstance(plan, LProject):
        e = dict(plan.exprs).get(name)
        if isinstance(e, Col):
            return _col_ndv_deep(plan.child, e.name, catalog)
        if isinstance(e, Lit) or (isinstance(e, Call) and e.fn == "null_of"):
            return 1
        return None
    if isinstance(plan, (LFilter, LSort, LLimit, LWindow)):
        return _col_ndv_deep(plan.child, name, catalog)
    if isinstance(plan, LAggregate):
        for n, e in plan.group_by:
            if n == name and isinstance(e, Col):
                return _col_ndv_deep(plan.child, e.name, catalog)
        return None
    if isinstance(plan, LJoin):
        if name in plan.left.output_names():
            return _col_ndv_deep(plan.left, name, catalog)
        if plan.kind not in ("semi", "anti") and name in plan.right.output_names():
            return _col_ndv_deep(plan.right, name, catalog)
        return None
    if isinstance(plan, LScan):
        origin = col_origin(plan, name)
        if origin is None:
            return None
        t = catalog.get_table(origin[0])
        ndv = t.column_ndv(origin[1]) if t is not None else None
        return int(ndv) if ndv else None
    return None


def _partition_ndv(plan: LogicalPlan, partition_by, catalog):
    """Estimated distinct partition count of a window, or None: product of
    per-key NDVs (union-aware), Col keys only."""
    if not partition_by:
        return None
    total = 1
    for e in partition_by:
        if not isinstance(e, Col):
            return None
        ndv = _col_ndv_deep(plan, e.name, catalog)
        if ndv is None:
            return None
        total *= max(ndv, 1)
        if total > (1 << 40):
            break
    return total


def pushdown_semi_joins(plan: LogicalPlan, catalog) -> LogicalPlan:
    """Push SEMI/ANTI joins below inner joins toward the leaf their probe
    keys come from: semi(A ⋈inner B, S on a-cols) == semi(A, S) ⋈inner B.
    An IN/EXISTS filter then shrinks its source relation BEFORE the join
    tree replays, instead of re-filtering the widest intermediate (TPC-H
    Q18's o_orderkey IN (...) was probing a 6M-row 3-way join; pushed, it
    filters 1.5M orders to the ~hundreds that qualify first). COST-GATED:
    only fires when the semi's build side is estimated much smaller than
    the target leaf — pushing a big build (Q21's EXISTS over 6M lineitem)
    would move the expensive probe from a filtered intermediate to the full
    leaf and double the runtime (measured 3.3s -> 6.5s ungated). Reference
    analog: the CBO's semi-join reorder/pushdown transformations
    (fe sql/optimizer/rule/transformation/SemiReorderRule.java)."""
    new_children = tuple(pushdown_semi_joins(c, catalog)
                         for c in plan.children)
    plan = _replace_children(plan, new_children)
    if (not isinstance(plan, LJoin) or plan.kind not in ("semi", "anti")
            or plan.condition is None):
        return plan
    left = plan.left
    if not (isinstance(left, LJoin) and left.kind == "inner"):
        return plan
    build_rows = estimate_rows(plan.right, catalog)
    probe_cols = set()
    for c in _conjuncts(plan.condition):
        for col in expr_cols(c):
            if col not in frozenset(plan.right.output_names()):
                probe_cols.add(col)
    for side in ("left", "right"):
        child = getattr(left, side)
        if probe_cols <= set(child.output_names()):
            if build_rows * 4 > estimate_rows(child, catalog):
                return plan  # build too big: filtering early wouldn't pay
            pushed = pushdown_semi_joins(
                LJoin(child, plan.right, plan.kind, plan.condition), catalog)
            ll = pushed if side == "left" else left.left
            rr = pushed if side == "right" else left.right
            return LJoin(ll, rr, "inner", left.condition)
    return plan


def reorder_joins(plan: LogicalPlan, catalog, feedback=None) -> LogicalPlan:
    if isinstance(plan, LJoin) and plan.kind in ("inner", "cross"):
        rels, conjuncts = [], []
        _flatten_join_region(plan, rels, conjuncts)
        rels = [reorder_joins(r, catalog, feedback) for r in rels]
        if len(rels) > 1:
            if len(rels) <= DP_JOIN_MAX_RELS:
                return _dp_order(rels, conjuncts, catalog, feedback)
            return _greedy_order(rels, conjuncts, catalog)
    new_children = tuple(
        reorder_joins(c, catalog, feedback) for c in plan.children)
    return _replace_children(plan, new_children)


DP_JOIN_MAX_RELS = 10


def col_origin(plan, name: str):
    """Trace a column to its base (table, column) if it's a pure passthrough.
    Single resolver for planner stats (NDV, bounds, dense ranges): physical
    imports it from here."""
    if isinstance(plan, LScan):
        alias, _, base = name.partition(".")
        if alias == plan.alias and base in plan.columns:
            return plan.table, base
        return None
    if isinstance(plan, (LFilter, LSort, LLimit, LWindow, LExchange)):
        return col_origin(plan.child, name)
    if isinstance(plan, LProject):
        for n, e in plan.exprs:
            if n == name and isinstance(e, Col):
                return col_origin(plan.child, e.name)
        return None
    if isinstance(plan, LAggregate):
        for n, e in plan.group_by:
            if n == name and isinstance(e, Col):
                return col_origin(plan.child, e.name)
        return None
    if isinstance(plan, LJoin):
        if name in plan.left.output_names():
            return col_origin(plan.left, name)
        if plan.kind not in ("semi", "anti") and name in plan.right.output_names():
            return col_origin(plan.right, name)
        return None
    return None


def join_scanset_key(plan) -> str:
    """Order-independent identity of a join subtree's input set: the sorted
    table:alias leaves under it. An inner region's TRUE cardinality depends
    only on which inputs joined, not the order — so an observed total
    recorded under this key by one execution funds every DP split of the
    same subset on the next (runtime/feedback.py cards; LEO-style
    history-based correction)."""
    return "|".join(sorted({f"{p.table}:{p.alias}" for p in walk_plan(plan)
                            if isinstance(p, LScan)}))


# Observed-vs-estimate guard band for feedback overrides: inside the band
# the estimate stands, keeping well-estimated plans BYTE-IDENTICAL to the
# feedback-off path (the A/B anchor plan_lint verifies across the corpus);
# outside it the observation wins — misestimates that flip DP orders are
# multiplicative (7.5x composite-NDV class), not ±40%.
FEEDBACK_CARD_BAND = 4.0

# Guard-band annealing (NEXT 11f): 4x exists to keep ONE noisy observation
# from moving a well-estimated plan, but a fingerprint that has been
# re-observed across executions has earned trust — the band shrinks with
# the entry's observation count toward this floor (never below: zonemap
# pruning and delvec churn make small run-to-run wobble normal, and a band
# of 1.0 would thrash plans on it).
FEEDBACK_BAND_FLOOR = 1.5


def feedback_band(observations: int) -> float:
    """Annealed guard band for a feedback entry observed `observations`
    times: 4.0 on the first observation, shrinking hyperbolically to the
    FEEDBACK_BAND_FLOOR by the fifth. Single-observation behavior is
    BYTE-IDENTICAL to the fixed-band engine (the corpus anchor)."""
    extra = max(int(observations) - 1, 0)
    return max(FEEDBACK_CARD_BAND / (1.0 + 0.5 * extra), FEEDBACK_BAND_FLOOR)


def join_fan_rows(l_rows: float, r_rows: float, prod_l: float, prod_r: float,
                  n_res: int) -> float:
    """System-R join cardinality with composite-key correction, shared by
    estimate_rows and the DP join ordering: each side's key-TUPLE distinct
    count is the product of per-column NDVs capped by the side's row count
    (a composite FK is correlated — multiplying per-column NDVs blind
    estimated lineitem JOIN partsupp at 2400 rows and made a 6M-row
    intermediate look like a cheap build side); residual (non-eq) conjuncts
    get a 0.25 selectivity each."""
    fan = max(min(prod_l, max(l_rows, 1.0)),
              min(prod_r, max(r_rows, 1.0)), 1.0)
    return max(l_rows * r_rows / fan * (0.25 ** n_res), 1.0)


def _pk_table_rows(rel, key_cols, catalog):
    """If `key_cols` of `rel` cover a declared unique key of one base table,
    return that table's TOTAL row count — `rel` is then the PK side of a
    PK-FK join and each probe row matches at most |rel|/total rows. This is
    the estimate the composite-NDV formula cannot recover (capping the FK
    side's key-tuple NDV at its row count overstates it — lineitem's
    (partkey, suppkey) tuples repeat ~7.5x — which understated
    lineitem JOIN partsupp 7.5x and put the non-reducing partsupp join
    first in Q9's DP order). Reference analog: FK-PK join estimation in
    fe sql/optimizer/statistics/StatisticsCalculator.java."""
    origins = [col_origin(rel, c) for c in key_cols]
    if not origins or any(o is None for o in origins):
        return None
    tables = {t for t, _ in origins}
    if len(tables) != 1:
        return None
    t = catalog.get_table(next(iter(tables)))
    if t is None or not t.row_count:
        return None
    base_cols = {b for _, b in origins}
    for uk in t.unique_keys:
        if uk and set(uk) <= base_cols:
            return float(t.row_count)
    return None


def _key_ndv(rel, name: str, est_rows: float, catalog) -> float:
    """Distinct-value estimate for a join key column of `rel`, capped by the
    relation's estimated row count (a filter can only lose values)."""
    origin = col_origin(rel, name)
    if origin is not None:
        t = catalog.get_table(origin[0])
        if t is not None:
            ndv = t.column_ndv(origin[1])
            if ndv:
                return float(min(ndv, max(est_rows, 1.0)))
    return max(est_rows, 1.0)


def _dp_order(rels, conjuncts, catalog, feedback=None) -> LogicalPlan:
    """Selinger-style exhaustive DP over subsets (reference:
    fe sql/optimizer/Memo.java + cost/CostModel.java re-designed as direct
    DP — the plan space here is join order only, physical ops are chosen
    later). Cost = total estimated intermediate rows (System-R cardinality:
    |L JOIN R| = |L||R| / prod max(ndv)); avoids the greedy trap of joining
    on a low-NDV key first (e.g. TPC-H Q5's
    customer.c_nationkey = supplier.s_nationkey fanout blowup).

    With a plan-feedback entry, two corrections join the cost model, both
    gated by FEEDBACK_CARD_BAND so well-estimated plans never move:
    observed cardinalities (cards, keyed by join_scanset_key) replace
    estimates per subset, and probe-side heavy-hitter counts (NEXT 11d)
    floor a split's output at hot_rows x avg build matches — an order that
    probes through a hot key pays for the skew the NDV average hides."""
    n = len(rels)
    colsets = [frozenset(r.output_names()) for r in rels]
    base_rows = [estimate_rows(r, catalog) for r in rels]

    fb_cards = (feedback or {}).get("cards") or {}
    fb_hot = (feedback or {}).get("probe_hot") or {}
    # annealed per-entry band: entries without an observation count (old
    # sidecars) behave exactly like the fixed-band engine
    fb_band = feedback_band(int((feedback or {}).get("obs") or 1))
    leaf_keys = [
        frozenset(f"{p.table}:{p.alias}" for p in walk_plan(r)
                  if isinstance(p, LScan))
        for r in rels] if fb_cards else None
    card_cache: dict = {}

    def observed_rows(mask: int):
        if not fb_cards:
            return None
        if mask not in card_cache:
            names: set = set()
            for i in range(n):
                if mask & (1 << i):
                    names |= leaf_keys[i]
            card_cache[mask] = fb_cards.get("|".join(sorted(names)))
        return card_cache[mask]

    def banded(est: float, obs) -> float:
        """The observation wins only OUTSIDE the (annealed) guard band."""
        if obs is None or (est * fb_band >= obs and obs * fb_band >= est):
            return est
        return max(float(obs), 1.0)

    hot_cache: dict = {}

    def hot_count(i: int, col: str) -> float:
        key = (i, col)
        if key not in hot_cache:
            h = 0.0
            origin = col_origin(rels[i], col)
            if origin is not None:
                for _, cnt in fb_hot.get(f"{origin[0]}.{origin[1]}", ()):
                    h = max(h, float(cnt))
            hot_cache[key] = h
        return hot_cache[key]

    def rel_of(cols: frozenset) -> int:
        m = 0
        for i in range(n):
            if cols & colsets[i]:
                m |= 1 << i
        return m

    ndv_cache: dict = {}

    def leaf_ndv(i: int, col: str) -> float:
        key = (i, col)
        if key not in ndv_cache:
            ndv_cache[key] = _key_ndv(rels[i], col, base_rows[i], catalog)
        return ndv_cache[key]

    # conjunct prep: (conj, relmask, eq=(ia, acol, ib, bcol)|None)
    infos = []
    for c in conjuncts:
        relmask = rel_of(expr_cols(c))
        eq = None
        if isinstance(c, Call) and c.fn == "eq" and len(c.args) == 2:
            a, b = c.args
            if isinstance(a, Col) and isinstance(b, Col):
                ma, mb = rel_of(expr_cols(a)), rel_of(expr_cols(b))
                if (ma and mb and ma & (ma - 1) == 0 and mb & (mb - 1) == 0
                        and ma != mb):
                    eq = (ma.bit_length() - 1, a.name,
                          mb.bit_length() - 1, b.name)
        infos.append((c, relmask, eq))

    # best[mask] = (cost, rows, plan); eq-rootedness rides entry_has_eq below
    best: dict = {}
    for i in range(n):
        # a leaf rel that is itself a join subtree (e.g. an outer join
        # below this inner region) may have an observed total of its own
        best[1 << i] = (0.0, banded(base_rows[i], observed_rows(1 << i)),
                        rels[i])

    full = (1 << n) - 1
    for mask in range(3, full + 1):
        if mask & (mask - 1) == 0:  # singleton
            continue
        entry = None
        entry_has_eq = False
        sub = (mask - 1) & mask
        while sub:
            rest = mask ^ sub
            if sub in best and rest in best and sub > rest:
                for amask, bmask in ((sub, rest), (rest, sub)):
                    ca, ra, pa = best[amask]
                    cb, rb, pb = best[bmask]
                    prod_a = prod_b = 1.0
                    n_res = 0
                    n_eq = 0
                    ready = []
                    has_eq = False
                    a_ends, b_ends = [], []
                    for c, relmask, eq in infos:
                        if not (relmask and relmask & mask == relmask
                                and relmask & amask and relmask & bmask):
                            continue
                        ready.append(c)
                        if eq is not None:
                            has_eq = True
                            n_eq += 1
                            ia, acol, ib, bcol = eq
                            if (1 << ia) & bmask:
                                ia, acol, ib, bcol = ib, bcol, ia, acol
                            prod_a *= max(leaf_ndv(ia, acol), 1.0)
                            prod_b *= max(leaf_ndv(ib, bcol), 1.0)
                            a_ends.append((ia, acol))
                            b_ends.append((ib, bcol))
                        else:
                            n_res += 1
                    if entry_has_eq and not ready:
                        continue  # cross joins only as a last resort
                    rows = join_fan_rows(ra, rb, prod_a, prod_b, n_res)
                    # PK-FK override: when one side's eq cols cover a unique
                    # key of a single leaf table, the join keeps the other
                    # side's rows scaled by that side's retained fraction
                    pk_cands = []
                    for ends, this_r, other_r in ((b_ends, rb, ra),
                                                  (a_ends, ra, rb)):
                        if ends and len({lf for lf, _ in ends}) == 1:
                            tr = _pk_table_rows(
                                rels[ends[0][0]], [c for _, c in ends],
                                catalog)
                            if tr:
                                pk_cands.append(
                                    other_r * this_r / tr * (0.25 ** n_res))

                    if pk_cands:
                        rows = max(min(pk_cands), 1.0)
                    obs = observed_rows(mask)
                    if obs is not None:
                        rows = banded(rows, obs)
                    elif fb_hot:
                        # no observation for this subset: floor the output
                        # at the hot key's expected matches (probe-side
                        # heavy hitter x average build fan), band-gated
                        hot = 0.0
                        for hi, hcol in a_ends:
                            h = hot_count(hi, hcol)
                            if h:
                                hot = max(hot, h * rb / max(prod_b, 1.0))
                        if hot > rows * fb_band:
                            rows = hot
                    # build side (right) materializes a device-sorted table:
                    # a full-capacity argsort, single-threaded in XLA CPU and
                    # O(n log n) everywhere — bias hard toward small builds.
                    # Exception: a single-leaf unique-key build lowers to the
                    # direct-addressing LUT join (one scatter, no sort).
                    build_w = 0.3
                    if bmask & (bmask - 1) == 0:
                        bi = bmask.bit_length() - 1
                        if (n_eq == 1
                                and prod_b >= 0.99 * base_rows[bi]):
                            build_w = 0.02  # unique dense key: LUT join
                        elif isinstance(rels[bi], LScan):
                            # base-scan build: its sort permutation is
                            # cached across runs (DeviceCache
                            # build_order_for) — far cheaper than sorting
                            # a derived intermediate every execution
                            build_w = 0.08
                    cost = ca + cb + rows + build_w * rb
                    if (entry is None or (has_eq and not entry_has_eq)
                            or (has_eq == entry_has_eq and cost < entry[0])):
                        plan = LJoin(pa, pb, "inner" if ready else "cross",
                                     and_all(ready) if ready else None)
                        entry = (cost, rows, plan)
                        entry_has_eq = has_eq
            sub = (sub - 1) & mask
        if entry is not None:
            best[mask] = entry

    if full not in best:
        return _greedy_order(rels, conjuncts, catalog)
    plan = best[full][2]
    consumed = _applied_conjuncts(plan)
    pending = [c for c in conjuncts if id(c) not in consumed]
    if pending:
        plan = LFilter(plan, and_all(pending))
    return plan


def _applied_conjuncts(plan, out=None) -> set:
    """ids of conjuncts already attached to join conditions in the tree."""
    if out is None:
        out = set()
    if isinstance(plan, LJoin) and plan.condition is not None:
        for c in _conjuncts(plan.condition):
            out.add(id(c))
    for ch in plan.children:
        _applied_conjuncts(ch, out)
    return out


def _flatten_join_region(plan, rels, conjuncts):
    if isinstance(plan, LJoin) and plan.kind in ("inner", "cross"):
        _flatten_join_region(plan.left, rels, conjuncts)
        _flatten_join_region(plan.right, rels, conjuncts)
        if plan.condition is not None:
            conjuncts.extend(_conjuncts(plan.condition))
    else:
        rels.append(plan)


def _greedy_order(rels, conjuncts, catalog) -> LogicalPlan:
    sizes = [estimate_rows(r, catalog) for r in rels]
    colsets = [frozenset(r.output_names()) for r in rels]
    remaining = set(range(len(rels)))
    # seed: the largest relation (fact table) is the probe root
    cur = max(remaining, key=lambda i: sizes[i])
    remaining.discard(cur)
    plan = rels[cur]
    plan_cols = set(colsets[cur])
    pending = list(conjuncts)

    while remaining:
        # candidates connected by an equality conjunct
        def connects(i):
            for c in pending:
                if (
                    isinstance(c, Call)
                    and c.fn == "eq"
                    and expr_cols(c) <= (plan_cols | colsets[i])
                    and expr_cols(c) & plan_cols
                    and expr_cols(c) & colsets[i]
                ):
                    return True
            return False

        cands = [i for i in remaining if connects(i)]
        if cands:
            nxt = min(cands, key=lambda i: sizes[i])
        else:
            nxt = min(remaining, key=lambda i: sizes[i])
        remaining.discard(nxt)
        new_cols = plan_cols | colsets[nxt]
        ready = [c for c in pending if expr_cols(c) <= new_cols]
        pending = [c for c in pending if not (expr_cols(c) <= new_cols)]
        plan = LJoin(plan, rels[nxt], "inner" if ready else "cross",
                     and_all(ready) if ready else None)
        plan_cols = new_cols
    if pending:
        plan = LFilter(plan, and_all(pending))
    return plan


# --- 4b. eager aggregation (group-by pushdown below a join) ------------------


def pushdown_aggregation(plan: LogicalPlan, catalog) -> LogicalPlan:
    """Eager aggregation (reference analog: the CBO's
    PushDownAggregateRule family): an Agg over a LEFT/INNER join whose
    single group key IS the probe-side join key — provably unique there —
    with every aggregate reading only build-side columns, becomes
    agg-below-join: group the build side by its join key first, then join
    1:1 and patch NULL counts to 0. TPC-H Q13: count(o_orderkey) per
    customer stops joining 1.5M order rows and instead dense-counts orders
    by o_custkey, then gather-joins 150k groups."""
    new_children = tuple(
        pushdown_aggregation(c, catalog) for c in plan.children)
    plan = _replace_children(plan, new_children)
    if not isinstance(plan, LAggregate) or len(plan.group_by) != 1:
        return plan
    j = plan.child
    if (not isinstance(j, LJoin) or j.kind not in ("left", "inner")
            or j.condition is None):
        return plan
    lcols = frozenset(j.left.output_names())
    rcols = frozenset(j.right.output_names())
    equi = None
    right_extras = []
    for c in _conjuncts(j.condition):
        pair = None
        if (isinstance(c, Call) and c.fn == "eq" and len(c.args) == 2
                and isinstance(c.args[0], Col)
                and isinstance(c.args[1], Col)):
            a, b = c.args
            if a.name in lcols and b.name in rcols:
                pair = (a.name, b.name)
            elif b.name in lcols and a.name in rcols:
                pair = (b.name, a.name)
        if pair is not None and equi is None:
            equi = pair
        elif expr_cols(c) <= rcols:
            # right-only ON conjunct: for LEFT joins it only disqualifies
            # build rows from matching, so it pushes into the build input
            right_extras.append(c)
        else:
            return plan
    if equi is None:
        return plan
    lk, rk = equi
    gname, gexpr = plan.group_by[0]
    if not (isinstance(gexpr, Col) and gexpr.name == lk):
        return plan
    origin = col_origin(j.left, lk)
    if origin is None:
        return plan
    t = catalog.get_table(origin[0])
    if t is None or (origin[1],) not in {tuple(k) for k in t.unique_keys}:
        return plan
    n = j.left  # the probe must not duplicate rows (scan/filter chain)
    while isinstance(n, (LFilter, LProject)):
        n = n.child
    if not isinstance(n, LScan):
        return plan
    mapped, post = [], {}
    for name, a in plan.aggs:
        if a.distinct or a.fn not in ("count", "sum", "min", "max"):
            return plan
        if a.arg is None:
            # count(*) counts preserved unmatched left rows — not
            # expressible as a build-side aggregate
            return plan
        cols = expr_cols(a.arg)
        if not cols or not cols <= rcols:
            return plan
        mapped.append((name, AggExpr(a.fn, a.arg)))
        if a.fn == "count":
            post[name] = Call("coalesce", Col(name), Lit(0))
    rin = LFilter(j.right, and_all(right_extras)) if right_extras else j.right
    sub = LAggregate(rin, ((rk, Col(rk)),), tuple(mapped))
    joined = LJoin(j.left, sub, j.kind, Call("eq", Col(lk), Col(rk)))
    out = [(gname, Col(lk))] + [
        (name, post.get(name, Col(name))) for name, _ in plan.aggs]
    return LProject(joined, tuple(out))


# --- 5. column pruning -------------------------------------------------------


def prune_columns(plan: LogicalPlan, required: frozenset | None = None) -> LogicalPlan:
    """Column pruning. Duplicated subtrees (CTE expansions, magic-set /
    scalar-inline copies) must prune IDENTICALLY — the physical emitter
    memoizes emission by node value, so two occurrences pruned to different
    column sets would compute twice. Top-level entry therefore records the
    union of requirements per duplicated subtree first, then prunes every
    occurrence with that union (requirement propagation distributes over
    unions, so descendants stay consistent)."""
    if required is None:
        required = frozenset(plan.output_names())
        from collections import Counter

        counts = Counter(
            node for node in walk_plan(plan)
            if isinstance(node, (LJoin, LAggregate, LWindow, LUnnest))
        )
        dups = frozenset(p for p, c in counts.items() if c >= 2)
        if dups:
            reqs: dict = {}
            _prune(plan, required, dups, reqs, record=True)
            return _prune(plan, required, dups,
                          {k: frozenset(v) for k, v in reqs.items()},
                          record=False)
    return _prune(plan, required, frozenset(), {}, record=False)


def _prune(plan: LogicalPlan, required: frozenset, dups, reqs, record: bool
           ) -> LogicalPlan:
    def prune_columns(child, req):  # shadow: thread the shared-prune state
        return _prune(child, req, dups, reqs, record)

    if plan in dups:
        if record:
            reqs.setdefault(plan, set()).update(required)
        else:
            required = reqs[plan]

    if isinstance(plan, LScan):
        keep = tuple(
            c for c in plan.columns if f"{plan.alias}.{c}" in required
        )
        if not keep:
            keep = plan.columns[:1]  # keep at least one column for row count
        return LScan(plan.table, plan.alias, keep)

    if isinstance(plan, LFilter):
        need = required | expr_cols(plan.predicate)
        need = frozenset(n for n in need if not n.startswith("@outer."))
        return LFilter(prune_columns(plan.child, need), plan.predicate)

    if isinstance(plan, LProject):
        kept = tuple((n, e) for n, e in plan.exprs if n in required)
        if not kept:
            kept = plan.exprs[:1]
        need = frozenset().union(*[expr_cols(e) for _, e in kept]) if kept else frozenset()
        need = frozenset(n for n in need if not n.startswith("@outer."))
        return LProject(prune_columns(plan.child, need), kept)

    if isinstance(plan, LJoin):
        need = set(required)
        if plan.condition is not None:
            need |= expr_cols(plan.condition)
        need = {n for n in need if not n.startswith("@outer.")}
        lcols = frozenset(plan.left.output_names())
        rcols = frozenset(plan.right.output_names())
        left = prune_columns(plan.left, frozenset(need) & lcols)
        right = prune_columns(plan.right, frozenset(need) & rcols)
        return LJoin(left, right, plan.kind, plan.condition)

    if isinstance(plan, LAggregate):
        kept_groups = plan.group_by
        kept_aggs = tuple((n, a) for n, a in plan.aggs if n in required)
        if not kept_aggs and plan.aggs:
            kept_aggs = plan.aggs[:1]
        need = set()
        for _, g in kept_groups:
            need |= expr_cols(g)
        for _, a in kept_aggs:
            if a.arg is not None:
                need |= expr_cols(a.arg)
            for x in a.extra:
                if isinstance(x, Expr):
                    need |= expr_cols(x)
        if not need:
            # count(*) etc: keep one child column
            need = set(plan.child.output_names()[:1])
        return LAggregate(
            prune_columns(plan.child, frozenset(need)), kept_groups, kept_aggs
        )

    if isinstance(plan, LWindow):
        func_names = {n for n, *_ in plan.funcs}
        need = set(required) - func_names
        for p in plan.partition_by:
            need |= expr_cols(p)
        for o, _, _ in plan.order_by:
            need |= expr_cols(o)
        for _, _, a, *_ in plan.funcs:
            if a is not None:
                need |= expr_cols(a)
        if not need:
            need = set(plan.child.output_names()[:1])
        return dataclasses.replace(
            plan, child=prune_columns(plan.child, frozenset(need)))

    if isinstance(plan, LUnnest):
        need = (required - {plan.out_name}) | expr_cols(plan.expr)
        return LUnnest(prune_columns(plan.child, frozenset(need)),
                       plan.expr, plan.out_name)

    if isinstance(plan, LSort):
        need = set(required)
        for e, _, _ in plan.keys:
            need |= expr_cols(e)
        return LSort(prune_columns(plan.child, frozenset(need)), plan.keys, plan.limit)

    if isinstance(plan, LLimit):
        return LLimit(prune_columns(plan.child, required), plan.limit, plan.offset)

    if isinstance(plan, LUnion):
        # children expose identical names; prune each by the same set
        return LUnion(tuple(prune_columns(c, required) for c in plan.inputs))

    raise TypeError(type(plan))


# --- query-cache cacheability marking ----------------------------------------
# The optimizer owns the semantic judgement the query cache needs: whether a
# plan's result is a pure function of (plan, table contents, declared knobs).
# Reference analog: the FE's CachedStatement checks behind enable_query_cache
# (nondeterministic calls, system relations and session-dependent functions
# disqualify a fragment from the BE's query_cache).

NONDETERMINISTIC_FNS = frozenset({
    "rand", "random", "uuid",
    "now", "current_timestamp", "localtimestamp",
    "current_date", "curdate", "current_time", "curtime", "localtime",
    "utc_timestamp", "utc_time", "utc_date",
    "sleep", "current_user", "connection_id", "last_query_id", "database",
})


def _exprs_in(val):
    """Every Expr embedded in a plan node's field value (fields hold bare
    exprs, (name, expr) pairs, (expr, asc, nulls_first) triples, window
    func tuples — all nested tuple shapes)."""
    if isinstance(val, Expr):
        yield val
    elif isinstance(val, tuple):
        for x in val:
            yield from _exprs_in(x)


def iter_plan_exprs(plan: LogicalPlan):
    """Yield every expression of every node in the plan tree, recursing
    into subquery plans carried INSIDE expressions (ScalarSubquery /
    SemiJoinMark — a nondeterministic call or system-table scan hiding in
    `WHERE x IN (SELECT ...)` must disqualify the outer plan too)."""
    from ..exprs.ir import walk as walk_expr

    for node in walk_plan(plan):
        for attr in getattr(node, "__dataclass_fields__", {}):
            for e in _exprs_in(getattr(node, attr)):
                for sub in walk_expr(e):
                    yield sub
                    if isinstance(sub, (ScalarSubquery, SemiJoinMark)):
                        if isinstance(sub, SemiJoinMark) \
                                and sub.probe_expr is not None:
                            yield from (
                                x for x in walk_expr(sub.probe_expr))
                        yield from iter_plan_exprs(sub.plan)


def plan_tables(plan: LogicalPlan) -> set:
    """Every catalog table the plan (or any embedded subquery plan) reads —
    the table set whose data versions join the full-result cache key."""
    tables = set()
    for node in walk_plan(plan):
        if isinstance(node, LScan):
            tables.add(node.table.lower())
    for e in iter_plan_exprs(plan):
        if isinstance(e, (ScalarSubquery, SemiJoinMark)):
            tables |= plan_tables(e.plan)
    return tables


def plan_uncacheable_reason(plan: LogicalPlan) -> str | None:
    """None when the plan's result is cacheable; otherwise a short reason.

    Disqualifiers: nondeterministic/session-dependent functions, zero-arg
    unix_timestamp (= now), UDF calls (arbitrary host python — the registry
    epoch keys create/drop, not the body's purity), and scans of virtual
    information_schema relations (rebuilt per read, no version clock)."""
    for t in plan_tables(plan):
        if t.startswith("information_schema."):
            return f"scans virtual relation {t}"
    udfs = None
    for e in iter_plan_exprs(plan):
        if isinstance(e, Call):
            fn = e.fn.lower()
            if fn in NONDETERMINISTIC_FNS:
                return f"nondeterministic function {fn}()"
            if fn == "unix_timestamp" and not e.args:
                return "nondeterministic function unix_timestamp()"
            if udfs is None:
                udfs = set()  # user-defined functions: not in the port yet
            if fn in udfs:
                return f"UDF call {fn}() (host python body)"
    return None
