"""Two-phase scan-level runtime filters (the host half of the global-RF
design).

Reference behavior: StarRocks delivers merged build-side runtime filters to
probe-side OLAP scan nodes, where they drive zonemap/bloom segment pruning
(exec_primitive/runtime_filter/ + the scan-node RF descriptors built by
orchestration/runtime_filter_worker.h). In the compiled TPU world the
device half is dataflow inside one program (ops/join.bloom_filter_mask /
runtime_filter_mask); this module is the half the device CANNOT do: decide
at PLAN time which parquet segments of a probe scan can possibly hold a
build key, so pruned segments are never loaded, never shipped to HBM, and
the probe capacity estimate tightens before compile.

Phase 1 (here, host numpy): when a join's build side is a pure
filter/project chain over a small stored/in-memory table (a filtered
dimension — q5's region chain shape), evaluate the build-side predicate on
the host table and take the surviving key column's [min, max].
Phase 2 (executor + TabletStore.load_table rf_predicate): those bounds
become an extra zonemap predicate on the probe scan — files whose zonemaps
miss the range are skipped and counted as `rf_segments_pruned`.

Pruning a probe row (or a whole segment) whose key falls outside the build
key range is correct for INNER/SEMI joins regardless of what sits above
them: such rows produce no join output, so the join's result — and
everything upstream of it — is unchanged.
"""

from __future__ import annotations

import numpy as np

from ..exprs.ir import Call, Col, Expr, InList, Lit
from .logical import LFilter, LJoin, LScan, LogicalPlan, walk_plan
from .optimizer import and_all, keys_through_chain, probe_scan_chain

# a "dimension" build worth host-evaluating; bigger tables would pay a real
# host filter pass for bounds the zonemaps rarely beat
MAX_BUILD_ROWS = 2_000_000

# sentinel bounds for an empty (or all-NULL-key) build side: lo > hi, so the
# probe predicate k >= lo AND k <= hi excludes EVERY segment — an empty
# build matches nothing under INNER/SEMI
EMPTY_BUILD_BOUNDS = (1 << 62, -(1 << 62))

_CMP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}


def _base(qualified: str) -> str:
    return qualified.split(".", 1)[-1]


def _lit_value(ht, base: str, lit: Lit):
    """Literal comparable against the host array of `base`, or None.
    Mirrors the zonemap prover's conversions: date/datetime ISO strings to
    epoch ints, decimal literals scaled to the stored raw ints."""
    v = lit.value
    if v is None:
        return None
    f = ht.schema.field(base)
    if isinstance(v, str) and lit.type is not None:
        import datetime

        from .. import types as T

        if lit.type.kind is T.TypeKind.DATE:
            return (datetime.date.fromisoformat(v)
                    - datetime.date(1970, 1, 1)).days
        if lit.type.kind is T.TypeKind.DATETIME:
            return (datetime.datetime.fromisoformat(v.replace(" ", "T"))
                    - datetime.datetime(1970, 1, 1)
                    ) // datetime.timedelta(microseconds=1)
    if f.type.is_string:
        return str(v) if isinstance(v, str) else None
    if isinstance(v, str):
        return None
    if f.type.is_decimal:
        return v * (10 ** f.type.scale)
    return v


def _col_values(ht, e: Expr):
    """(base_name, comparable ndarray) for a plain column ref, or None.
    Dict-encoded strings decode to their string values so literal compares
    see real lexicographic order, not code order."""
    if not isinstance(e, Col):
        return None
    base = _base(e.name)
    if base not in ht.arrays:
        return None
    f = ht.schema.field(base)
    a = np.asarray(ht.arrays[base])
    if a.ndim != 1:
        return None  # wide planes (ARRAY/DECIMAL128/sketch): no host compare
    if f.type.is_string:
        if f.dict is None or len(f.dict) == 0:
            return None
        vals = np.asarray([str(x) for x in f.dict.values])
        a = vals[np.clip(a, 0, len(vals) - 1)]
    return base, a


def host_eval_predicate(ht, e: Expr):
    """numpy bool mask of rows satisfying `e` over HostTable `ht`, or None
    when the shape is unsupported. Conservative by construction: inside an
    AND an unsupported conjunct is treated as all-true (keeps MORE rows ->
    wider bounds -> safe); inside an OR any unsupported branch poisons the
    whole disjunction. NULL operands compare not-true, per SQL."""
    if isinstance(e, Call) and e.fn == "and":
        mask = np.ones(ht.num_rows, dtype=bool)
        for a in e.args:
            m = host_eval_predicate(ht, a)
            if m is not None:
                mask &= m
        return mask
    if isinstance(e, Call) and e.fn == "or":
        mask = np.zeros(ht.num_rows, dtype=bool)
        for a in e.args:
            m = host_eval_predicate(ht, a)
            if m is None:
                return None
            mask |= m
        return mask
    if isinstance(e, InList) and not e.negated:
        cv = _col_values(ht, e.arg)
        if cv is None:
            return None
        base, a = cv
        mask = np.zeros(ht.num_rows, dtype=bool)
        for v in e.values:
            lv = _lit_value(ht, base, Lit(v))
            if lv is None:
                continue  # NULL never matches IN
            try:
                mask |= a == lv
            except TypeError:
                return None
        v = ht.valids.get(base)
        if v is not None:
            mask &= np.asarray(v)
        return mask
    if isinstance(e, Call) and e.fn in _CMP and len(e.args) == 2:
        a, b = e.args
        fn = e.fn
        if isinstance(a, Lit) and isinstance(b, Col):
            a, b = b, a
            fn = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                  "eq": "eq", "ne": "ne"}[fn]
        cv = _col_values(ht, a)
        if cv is None or not isinstance(b, Lit):
            return None
        base, arr = cv
        lv = _lit_value(ht, base, b)
        if lv is None:
            return None
        import operator

        ops = {"eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
               "le": operator.le, "gt": operator.gt, "ge": operator.ge}
        try:
            mask = ops[fn](arr, lv)
        except TypeError:
            return None
        mask = np.asarray(mask, dtype=bool)
        v = ht.valids.get(base)
        if v is not None:
            mask &= np.asarray(v)
        return mask
    return None


def host_build_key_bounds(build: LogicalPlan, key: Expr, catalog):
    """[min, max] of the build-side join key evaluated on HOST numpy, or
    None when the build isn't a pure chain over a small table / the key
    isn't a plain integer-or-temporal column. Unsupported filter conjuncts
    only WIDEN the bounds (they are skipped), never narrow them — the
    result is always a superset of the true build key set's range."""
    scan, chain = probe_scan_chain(build)
    if scan is None:
        return None
    ks = keys_through_chain([key], chain, scan)
    if ks is None or not isinstance(ks[0], Col):
        return None
    handle = catalog.get_table(scan.table)
    if handle is None or handle.row_count > MAX_BUILD_ROWS:
        return None
    base = _base(ks[0].name)
    try:
        f = handle.schema.field(base)
    except (KeyError, ValueError):
        return None
    if not (f.type.is_integer or f.type.is_temporal):
        return None
    ht = handle.table
    mask = np.ones(ht.num_rows, dtype=bool)
    for node in chain:
        if isinstance(node, LFilter):
            m = host_eval_predicate(ht, node.predicate)
            if m is not None:
                mask &= m
    a = np.asarray(ht.arrays[base])
    v = ht.valids.get(base)
    if v is not None:
        mask &= np.asarray(v)  # NULL build keys never match a probe
    sel = a[mask]
    if len(sel) == 0:
        return EMPTY_BUILD_BOUNDS
    return int(sel.min()), int(sel.max())


def bounds_predicate(bounds) -> Expr:
    """The probe-scan zonemap predicate for a list of (col, lo, hi)."""
    conj = []
    for c, lo, hi in bounds:
        conj.append(Call("ge", Col(c), Lit(int(lo))))
        conj.append(Call("le", Col(c), Lit(int(hi))))
    return and_all(conj)


def compute_scan_prune(plan: LogicalPlan, catalog) -> dict:
    """{(table, alias): (scan_columns, [(base_col, lo, hi), ...])} for every
    probe scan of a STORED table whose join's build side yields host key
    bounds that would actually prune at least one segment.

    Requirements mirror the device RF's: the join is INNER/SEMI, the probe
    side is a pure filter/project chain down to the scan, and the scan
    feeds nothing else in the plan (dropping its rows must only affect this
    join). The would-prune check reads only the manifest, so a query whose
    bounds can't skip anything never pays a separate pruned table load."""
    from ..storage.catalog import StoredTableHandle
    from ..storage.store import _zonemap_excludes
    from .physical import join_equi_keys

    usage: dict = {}
    for n in walk_plan(plan):
        if isinstance(n, LScan):
            usage[(n.table, n.alias)] = usage.get((n.table, n.alias), 0) + 1
    out: dict = {}
    for j in walk_plan(plan):
        if not isinstance(j, LJoin) or j.kind not in ("inner", "semi"):
            continue
        probe_keys, build_keys, _res = join_equi_keys(j)
        if not probe_keys:
            continue
        scan, chain = probe_scan_chain(j.left)
        if scan is None or usage.get((scan.table, scan.alias)) != 1:
            continue
        handle = catalog.get_table(scan.table)
        if not isinstance(handle, StoredTableHandle):
            continue
        skeys = keys_through_chain(probe_keys, chain, scan)
        if skeys is None:
            continue
        bounds = []
        for sk, bk in zip(skeys, build_keys):
            if not isinstance(sk, Col):
                continue
            base = _base(sk.name)
            try:
                f = handle.schema.field(base)
            except (KeyError, ValueError):
                continue
            if not (f.type.is_integer or f.type.is_temporal):
                continue
            b = host_build_key_bounds(j.right, bk, catalog)
            if b is None:
                continue
            bounds.append((base, b[0], b[1]))
        if not bounds:
            continue
        # manifest-only dry run: engage only when the bounds would skip at
        # least one segment (otherwise the pruned load is a pure cost)
        pred = bounds_predicate(bounds)
        m = handle.store.read_manifest(scan.table)
        would = sum(
            1 for rs in m["rowsets"] for fm in rs["files"]
            if _zonemap_excludes(fm["zonemap"], pred)
        )
        if would == 0:
            continue
        out[(scan.table, scan.alias)] = (scan.columns, bounds)
    return out
