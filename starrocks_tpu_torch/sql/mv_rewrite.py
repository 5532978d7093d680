"""Transparent materialized-view rewrite (SPJG containment).

A query is rewritten to scan a materialized view instead of its base tables
when the MV provably contains the needed rows and columns:

- same scan-table set (self-joins / repeated tables bail),
- the MV's WHERE conjuncts are a SUBSET of the query's (the extra query
  conjuncts become a compensating filter over MV columns),
- every query group-by expression is an MV output column (MV groups then
  refine query groups, so re-aggregation is exact),
- every query aggregate rolls up from an MV column: sum->sum(sum),
  count->sum(count), min->min(min), max->max(max), avg->sum(sum)/sum(count);
  non-decomposable aggregates are served only when the query's group set
  EQUALS the MV's (every MV group is then exactly one query group and
  min() picks the single value through the shared machinery).

Matching is by normalized expression strings (aliases canonicalized to
table names; commutative args sorted), computed on the ANALYZED plan before
any optimizer rule reshapes it. Staleness is version-based: the catalog
bumps a per-table version on every mutation, and an MV whose recorded base
versions lag the current ones is skipped until REFRESH.

Reference analog: the SPJG-based MV rewrite in
fe/fe-core/.../sql/optimizer/rule/transformation/materialization/
MaterializedViewRewriter.java (this re-design trades its memo/Cascades
integration for a direct whole-plan match — the engine compiles one
program per plan, so there is no partial-subtree reuse to exploit).
"""

from __future__ import annotations

import dataclasses

from ..exprs.ir import AggExpr, Call, Case, Cast, Col, InList, Lit
from .logical import (
    LAggregate, LFilter, LJoin, LLimit, LProject, LScan, LSort, LogicalPlan,
)


class _Bail(Exception):
    pass


def _norm(e, amap) -> str:
    """Normalized matching string: aliases -> table names, commutative
    arguments sorted. Raises _Bail on expression kinds we do not match."""
    if isinstance(e, Col):
        if "." in e.name:
            a, b = e.name.split(".", 1)
            return f"{amap.get(a, a)}.{b}"
        return e.name
    if isinstance(e, Lit):
        return f"lit({e.value!r}:{e.type!r})"
    if isinstance(e, Call):
        args = [_norm(a, amap) for a in e.args]
        if e.fn in ("and", "or", "add", "mul", "eq", "ne"):
            args = sorted(args)
        return f"{e.fn}({','.join(args)})"
    if isinstance(e, Cast):
        return f"cast({_norm(e.arg, amap)} as {e.to!r})"
    if isinstance(e, Case):
        parts = [f"{_norm(c, amap)}:{_norm(v, amap)}" for c, v in e.whens]
        oe = _norm(e.orelse, amap) if e.orelse is not None else "null"
        return f"case({';'.join(parts)};{oe})"
    if isinstance(e, InList):
        return (f"in({_norm(e.arg, amap)},"
                f"{sorted(map(repr, e.values))},{e.negated})")
    raise _Bail(f"unsupported expr {type(e).__name__}")


def _flat_conjuncts(e):
    if isinstance(e, Call) and e.fn == "and":
        out = []
        for a in e.args:
            out.extend(_flat_conjuncts(a))
        return out
    return [e]


@dataclasses.dataclass
class Sig:
    tables: frozenset  # base table names
    amap: dict  # alias -> table
    conjs: dict  # normstr -> Expr (join + where conjuncts)
    agg: object  # LAggregate | None
    having: object  # Expr | None
    project: object  # LProject | None
    wrappers: list  # outermost-first [LSort/LLimit]
    group_norms: dict  # name -> normstr (only when agg)
    agg_norms: list  # [(name, fn, argnorm)] (only when agg)


def signature(plan: LogicalPlan) -> Sig:
    wrappers = []
    while isinstance(plan, (LSort, LLimit)):
        wrappers.append(plan)
        plan = plan.child
    project = None
    if isinstance(plan, LProject):
        project = plan
        plan = plan.child
    having = None
    if isinstance(plan, LFilter) and isinstance(plan.child, LAggregate):
        having = plan.predicate
        plan = plan.child
    agg = None
    if isinstance(plan, LAggregate):
        agg = plan
        plan = plan.child

    amap: dict = {}
    tables: set = set()
    conj_exprs: list = []

    def region(p):
        if isinstance(p, LScan):
            if p.table in tables:
                raise _Bail("repeated table in region")
            tables.add(p.table)
            amap[p.alias] = p.table
            return
        if isinstance(p, LJoin) and p.kind in ("inner", "cross"):
            region(p.left)
            region(p.right)
            if p.condition is not None:
                conj_exprs.extend(_flat_conjuncts(p.condition))
            return
        if isinstance(p, LFilter):
            conj_exprs.extend(_flat_conjuncts(p.predicate))
            region(p.child)
            return
        raise _Bail(f"unsupported region node {type(p).__name__}")

    region(plan)
    conjs = {_norm(c, amap): c for c in conj_exprs}

    group_norms: dict = {}
    agg_norms: list = []
    if agg is not None:
        for name, e in agg.group_by:
            group_norms[name] = _norm(e, amap)
        for name, a in agg.aggs:
            if not isinstance(a, AggExpr) or a.distinct or a.extra:
                raise _Bail("unsupported aggregate shape")
            argn = "*" if a.arg is None else _norm(a.arg, amap)
            agg_norms.append((name, a.fn, argn))
    return Sig(frozenset(tables), amap, conjs, agg, having, project,
               wrappers, group_norms, agg_norms)


def mv_metadata(plan: LogicalPlan):
    """Matching metadata for an MV definition plan, or None when the shape
    is not rewritable. Returns (sig, col_map, agg_map):
    col_map: normstr -> mv output column (group keys / SPJ outputs);
    agg_map: (fn, argnorm) -> mv output column."""
    try:
        sig = signature(plan)
    except _Bail:
        return None
    if sig.wrappers or sig.having is not None:
        return None  # ORDER BY/LIMIT/HAVING in an MV def truncate/thin rows
    col_map: dict = {}
    agg_map: dict = {}
    if sig.agg is None:
        if sig.project is None:
            return None
        try:
            for name, e in sig.project.exprs:
                col_map[_norm(e, sig.amap)] = _out_name(name)
        except _Bail:
            return None
        return sig, col_map, agg_map
    # aggregated MV: the projection may only rename Agg outputs (computed
    # post-agg exprs would need inversion to roll up through)
    agg_exprs = dict(sig.agg.group_by) | {n: a for n, a in sig.agg.aggs}
    names = {}  # agg output name -> mv column name
    if sig.project is not None:
        for name, e in sig.project.exprs:
            if not (isinstance(e, Col) and e.name in agg_exprs):
                return None
            names[e.name] = _out_name(name)
    else:
        names = {n: _out_name(n) for n in agg_exprs}
    for name, norm in sig.group_norms.items():
        if name in names:
            col_map[norm] = names[name]
    for name, fn, argn in sig.agg_norms:
        if name in names:
            agg_map[(fn, argn)] = names[name]
    return sig, col_map, agg_map


def _out_name(name: str) -> str:
    """Output column name as stored by the MV refresh (alias qualifiers are
    stripped by _prettify_names when unambiguous)."""
    return name.split(".", 1)[-1] if "." in name else name


_ROLLUP = {"sum": "sum", "count": "sum", "count_star": "sum",
           "min": "min", "max": "max"}


def _rewrite_over_mv(e, amap, col_map, mv: str):
    """Re-express `e` over MV output columns; _Bail when some base column
    is not covered."""
    try:
        ns = _norm(e, amap)
        if ns in col_map:
            return Col(f"{mv}.{col_map[ns]}")
    except _Bail:
        pass
    if isinstance(e, Lit):
        return e
    if isinstance(e, Call):
        return Call(e.fn, *[_rewrite_over_mv(a, amap, col_map, mv)
                            for a in e.args])
    if isinstance(e, Cast):
        return Cast(_rewrite_over_mv(e.arg, amap, col_map, mv), e.to)
    if isinstance(e, Case):
        return Case(
            tuple((_rewrite_over_mv(c, amap, col_map, mv),
                   _rewrite_over_mv(v, amap, col_map, mv))
                  for c, v in e.whens),
            _rewrite_over_mv(e.orelse, amap, col_map, mv)
            if e.orelse is not None else None)
    if isinstance(e, InList):
        return InList(_rewrite_over_mv(e.arg, amap, col_map, mv),
                      e.values, e.negated)
    raise _Bail("query expr not derivable from MV outputs")


def _match_one(qsig: Sig, mv: str, meta, mv_handle):
    msig, col_map, agg_map = meta
    if qsig.tables != msig.tables:
        return None
    if not set(msig.conjs) <= set(qsig.conjs):
        return None
    mv_cols = tuple(f.name for f in mv_handle.schema)
    scan: LogicalPlan = LScan(mv, mv, mv_cols)
    try:
        residual = [
            _rewrite_over_mv(e, qsig.amap, col_map, mv)
            for ns, e in qsig.conjs.items() if ns not in msig.conjs
        ]
        if residual:
            from .optimizer import and_all

            scan = LFilter(scan, and_all(residual))

        if qsig.agg is None:
            if msig.agg is not None:
                return None  # raw rows cannot be served from aggregated data
            if qsig.project is None:
                return None
            body = LProject(scan, tuple(
                (n, _rewrite_over_mv(e, qsig.amap, col_map, mv))
                for n, e in qsig.project.exprs))
        else:
            body = _rebuild_agg(qsig, scan, col_map, agg_map, msig, mv)
            if body is None:
                return None
    except _Bail:
        return None
    for w in reversed(qsig.wrappers):
        body = dataclasses.replace(w, child=body)
    return body


def _rebuild_agg(qsig, scan, col_map, agg_map, msig, mv: str):
    exact_groups = (msig.agg is not None
                    and set(qsig.group_norms.values())
                    == set(msig.group_norms.values()))
    group_by = []
    for name, _ in qsig.agg.group_by:
        ns = qsig.group_norms[name]
        if ns not in col_map:
            return None
        group_by.append((name, Col(f"{mv}.{col_map[ns]}")))

    aggs = []
    avg_fixups = {}  # agg output name -> (sum_name, cnt_name)
    for name, fn, argn in qsig.agg_norms:
        if msig.agg is None:
            # SPJ MV: row multiset preserved — apply the original aggregate
            # over re-expressed args
            orig = dict(qsig.agg.aggs)[name]
            arg = (None if orig.arg is None
                   else _rewrite_over_mv(orig.arg, qsig.amap, col_map, mv))
            aggs.append((name, AggExpr(orig.fn, arg, orig.distinct,
                                       orig.extra)))
            continue
        if fn == "avg":
            s, c = agg_map.get(("sum", argn)), agg_map.get(("count", argn))
            if s is not None and c is not None:
                aggs.append((f"{name}__mvs", AggExpr(
                    "sum", Col(f"{mv}.{s}"))))
                aggs.append((f"{name}__mvc", AggExpr(
                    "sum", Col(f"{mv}.{c}"))))
                avg_fixups[name] = (f"{name}__mvs", f"{name}__mvc")
                continue
        col = agg_map.get((fn, argn))
        if col is None:
            return None
        refn = _ROLLUP.get(fn)
        if refn is None:
            if not exact_groups:
                return None  # non-decomposable aggregate needs 1:1 groups
            refn = "min"  # singleton groups: min() reads the single value
        aggs.append((name, AggExpr(refn, Col(f"{mv}.{col}"))))

    body: LogicalPlan = LAggregate(scan, tuple(group_by), tuple(aggs))
    if avg_fixups:
        exprs = []
        for n in body.output_names():
            base = n[:-5] if n.endswith(("__mvs", "__mvc")) else n
            if base in avg_fixups:
                if n.endswith("__mvs"):
                    s, c = avg_fixups[base]
                    exprs.append((base, Call("divide", Col(s), Col(c))))
                continue
            exprs.append((n, Col(n)))
        body = LProject(body, tuple(exprs))
    if qsig.having is not None:
        body = LFilter(body, qsig.having)
    if qsig.project is not None:
        body = LProject(body, qsig.project.exprs)
    return body


def try_rewrite(plan: LogicalPlan, catalog) -> LogicalPlan:
    """Rewrite `plan` to scan a FRESH matching MV; returns the original plan
    untouched when no MV applies."""
    from ..runtime.config import config

    meta_by_mv = getattr(catalog, "mv_meta", None)
    if not meta_by_mv or not config.get("enable_mv_rewrite"):
        return plan
    try:
        qsig = signature(plan)
    except _Bail:
        return plan
    best = None  # (-(matched conjuncts), mv rows, plan): most specific wins
    for mv, entry in meta_by_mv.items():
        if any(catalog.versions.get(t, 0) != v
               for t, v in entry["bases"].items()):
            continue  # stale: base data moved since the last REFRESH
        handle = catalog.get_table(mv)
        if handle is None:
            continue
        out = _match_one(qsig, mv, entry["meta"], handle)
        if out is not None:
            key = (-len(entry["meta"][0].conjs), handle.row_count)
            if best is None or key < best[0]:
                best = (key, out)
    return best[1] if best is not None else plan
