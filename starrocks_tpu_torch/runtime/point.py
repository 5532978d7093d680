"""Short-circuit point-query lane: planner/compiler-free PK lookups.

Reference behavior: the short-circuit execution path for high-QPS point
queries on PRIMARY KEY tables (be/src/exec/pipeline/short_circuit, FE
qe/scheduler short-circuit planning): `SELECT ... WHERE pk = ?` skips the
planner and fragment machinery entirely and answers from the primary
index. TPU-first re-design: the analytic path here costs parse ->
analyze -> optimize -> XLA compile -> device dispatch — milliseconds of
fixed overhead per statement — while a PK lookup is a host-side hash
probe over an index the PK delta-write path (storage/store.py upsert)
already maintains. This module detects the narrow statement shape at
TEXT level (in front of the plan cache) and executes it as
pk-index probe -> delvec check -> direct segment row gather, with
`UPDATE ... WHERE pk = ?` / `DELETE FROM t WHERE pk = ?` riding the same
index into the existing delta-write path (upsert / delete vectors).

Contracts:
- DETECTION IS CONSERVATIVE: any shape the strict grammar or the
  semantic validation can't prove point-safe returns MISS and the full
  analytic path runs — `SET enable_short_circuit=off` is byte-identical
  because ON only ever substitutes an equivalent evaluation.
- The lane is admission-exempt (no resource-group gate — like KILL) but
  runs INSIDE `lifecycle.query_scope`: registered, killable at the
  `point::probe` checkpoint, memory-accounted, profiled under its own
  'point' statement class (tools/src_lint.py R8 pins the entrypoint).
- Only `Session._sql_inner` may call `try_execute` (R8): the serving
  tier dispatches point texts through `session.sql`, never into these
  internals, so every point statement crosses exactly one query scope.
"""

from __future__ import annotations

import dataclasses
import datetime
import re
import time

from .. import types as T
from .metrics import metrics

POINT_LOOKUPS = metrics.counter(
    "sr_tpu_point_lookups_total",
    "statements served by the short-circuit point lane")
POINT_HIT_ROWS = metrics.counter(
    "sr_tpu_point_hit_rows_total",
    "rows returned/affected by point-lane statements")
POINT_MISS_KEYS = metrics.counter(
    "sr_tpu_point_miss_keys_total",
    "probed primary keys with no live row")
POINT_DML = metrics.counter(
    "sr_tpu_point_dml_total",
    "UPDATE/DELETE statements short-circuited onto the PK delta path")
POINT_FALLBACKS = metrics.counter(
    "sr_tpu_point_fallbacks_total",
    "texts that MATCHED the point grammar but failed semantic "
    "validation (non-PK table, un-canonicalizable literal, ...) and "
    "fell back to the analytic path")

MISS = object()  # sentinel: not a point statement — run the full path

MAX_POINT_KEYS = 128  # IN-list cross-product cap ("small IN lists")

_ID = r"[A-Za-z_][A-Za-z0-9_]*"
_L = r"(?:-?\d+(?:\.\d+)?|'[^']*')"
_SEL_RE = re.compile(
    rf"^select\s+(?P<cols>\*|{_ID}(?:\s*,\s*{_ID})*)\s+from\s+"
    rf"(?P<table>{_ID})\s+where\s+(?P<where>.+)$", re.I | re.S)
_UPD_RE = re.compile(
    rf"^update\s+(?P<table>{_ID})\s+set\s+"
    rf"(?P<sets>{_ID}\s*=\s*(?:{_L}|null)"
    rf"(?:\s*,\s*{_ID}\s*=\s*(?:{_L}|null))*)"
    rf"\s+where\s+(?P<where>.+)$", re.I | re.S)
_DEL_RE = re.compile(
    rf"^delete\s+from\s+(?P<table>{_ID})\s+where\s+(?P<where>.+)$",
    re.I | re.S)
_TERM_RE = re.compile(
    rf"({_ID})\s*(?:=\s*({_L})|in\s*\(\s*({_L}(?:\s*,\s*{_L})*)\s*\))",
    re.I)
_AND_RE = re.compile(r"\s+and\s+", re.I)
_LIT_RE = re.compile(_L)
_SET_RE = re.compile(rf"({_ID})\s*=\s*({_L}|null)", re.I)


@dataclasses.dataclass(frozen=True)
class _PointShape:
    """Text-level parse of a point candidate (pure function of the text;
    semantic validation against the LIVE catalog happens per execution)."""
    kind: str          # "select" | "update" | "delete"
    table: str
    cols: tuple | None  # select projection; None = *
    terms: tuple       # ((col, (literal, ...)), ...) conjunctive WHERE
    sets: tuple = ()   # ((col, literal), ...) UPDATE assignments


_shape_cache: dict = {}  # text -> _PointShape | _NOT_POINT (GIL-atomic ops)
_NOT_POINT = object()
_SHAPE_CACHE_CAP = 4096


def _lit_val(tok: str):
    if tok.startswith("'"):
        return tok[1:-1]
    if tok.lower() == "null":
        return None
    return float(tok) if "." in tok else int(tok)


def _parse_where(s: str):
    """Strict conjunction of `col = lit` / `col IN (lit, ...)` terms.
    Returns ((col, (vals...)), ...) or None when anything else appears."""
    s = s.strip()
    terms = []
    pos = 0
    while True:
        m = _TERM_RE.match(s, pos)
        if m is None:
            return None
        col = m.group(1).lower()
        if m.group(2) is not None:
            vals = (_lit_val(m.group(2)),)
        else:
            vals = tuple(_lit_val(x) for x in _LIT_RE.findall(m.group(3)))
        terms.append((col, vals))
        pos = m.end()
        if not s[pos:].strip():
            return tuple(terms)
        m2 = _AND_RE.match(s, pos)
        if m2 is None:
            return None
        pos = m2.end()


def _parse_text(text: str):
    """text -> _PointShape | _NOT_POINT, memoized: the detector runs in
    front of EVERY statement when the lane is on, so repeated analytic
    texts must cost one dict hit, not a regex pass."""
    hit = _shape_cache.get(text)
    if hit is not None:
        return hit
    shape = _NOT_POINT
    head = text[:7].lower()
    m = None
    if head.startswith("select"):
        m = _SEL_RE.match(text)
        if m is not None:
            terms = _parse_where(m.group("where"))
            if terms is not None:
                cols = m.group("cols")
                proj = None if cols.strip() == "*" else tuple(
                    c.strip() for c in cols.split(","))
                shape = _PointShape("select", m.group("table").lower(),
                                    proj, terms)
    elif head.startswith("update"):
        m = _UPD_RE.match(text)
        if m is not None:
            terms = _parse_where(m.group("where"))
            if terms is not None:
                sets = tuple(
                    (sm.group(1).lower(), _lit_val(sm.group(2)))
                    for sm in _SET_RE.finditer(m.group("sets")))
                shape = _PointShape("update", m.group("table").lower(),
                                    None, terms, sets)
    elif head.startswith("delete"):
        m = _DEL_RE.match(text)
        if m is not None:
            terms = _parse_where(m.group("where"))
            if terms is not None:
                shape = _PointShape("delete", m.group("table").lower(),
                                    None, terms)
    if len(_shape_cache) >= _SHAPE_CACHE_CAP:
        _shape_cache.clear()
    _shape_cache[text] = shape
    return shape


def peek_select(text: str):
    """PUBLIC probe for the serving tier: the parsed shape when `text` is
    a point SELECT, else None. Pure text analysis — no catalog access, no
    execution. Serving uses it only to pick the inline per-table gate
    claim; the statement itself still goes through session.sql, which
    re-detects and can fall back (the R8 contract)."""
    shape = _parse_text(text)
    if shape is _NOT_POINT or shape.kind != "select":
        return None
    return shape


def _canon_lit(v, t: T.LogicalType):
    """(ok, canonical key value) for one pk literal under the DECLARED
    column type — must agree exactly with storage's `_canon_key` (str for
    VARCHAR, epoch days/us for DATE/DATETIME, int for integers). ok=False
    means the full path must decide (e.g. float literal on an int pk)."""
    if v is None:
        return False, None  # NULL pk never matches (and is unsinsertable)
    if t.is_string:
        return (True, str(v)) if isinstance(v, str) else (False, None)
    if t.kind is T.TypeKind.DATE:
        if not isinstance(v, str):
            return False, None
        try:
            d = datetime.date.fromisoformat(v)
        except ValueError:
            return False, None
        return True, (d - datetime.date(1970, 1, 1)).days
    if t.kind is T.TypeKind.DATETIME:
        if not isinstance(v, str):
            return False, None
        try:
            dt = datetime.datetime.fromisoformat(v.replace(" ", "T"))
        except ValueError:
            return False, None
        return True, int((dt - datetime.datetime(1970, 1, 1))
                         // datetime.timedelta(microseconds=1))
    if t.is_integer or t.kind is T.TypeKind.BOOLEAN:
        if isinstance(v, (bool, int)):
            return True, int(v)
        return False, None
    return False, None  # float/decimal/wide pk: full path decides


def _key_tuples(handle, terms):
    """Canonical pk tuples the WHERE pins, or None when the terms don't
    cover the primary key exactly (each pk column once, nothing else)."""
    keys = [k for ks in handle.unique_keys for k in ks]
    if not keys:
        return None
    by_col: dict = {}
    for col, vals in terms:
        if col in by_col:
            return None  # repeated column: let the full path fold it
        by_col[col] = vals
    if set(by_col) != set(keys):
        return None
    total = 1
    for vals in by_col.values():
        total *= len(vals)
    if not 0 < total <= MAX_POINT_KEYS:
        return None
    names = {f.name for f in handle.schema}
    canon: dict = {}
    for col, vals in by_col.items():
        if col not in names:
            return None
        t = handle.schema.field(col).type
        cv = []
        for v in vals:
            ok, k = _canon_lit(v, t)
            if not ok:
                return None
            cv.append(k)
        canon[col] = cv
    out = [()]
    for k in keys:
        out = [prev + (v,) for prev in out for v in canon[k]]
    return out


def _resolve(session, shape: _PointShape):
    """The live-catalog half of detection: the table must be a STORED
    PRIMARY KEY table (the pk index + delvec machinery only exists
    there). Returns (handle, key_tuples) or None -> fall back."""
    from ..storage.catalog import StoredTableHandle

    name = shape.table
    if name.startswith("__") or name in session.catalog.views \
            or name in session.catalog.mv_defs:
        return None
    handle = session.catalog.get_table(name)
    if not isinstance(handle, StoredTableHandle) or session.store is None:
        return None
    kts = _key_tuples(handle, shape.terms)
    if kts is None:
        return None
    return handle, kts


def _projection(handle, cols):
    """Validated projection column list (None = all), or False -> fall
    back (unknown/duplicate names; the full path owns the error)."""
    if cols is None:
        return None
    names = {f.name for f in handle.schema}
    out = []
    for c in cols:
        cc = c if c in names else c.lower()
        if cc not in names or cc in out:
            return False
        out.append(cc)
    return out


def try_execute(session, text: str):
    """Serve `text` from the point lane, or return MISS to fall through
    to the analytic path. Called ONLY from Session._sql_inner (src_lint
    R8), i.e. always inside `Session.sql`'s lifecycle.query_scope."""
    shape = _parse_text(text)
    if shape is _NOT_POINT:
        return MISS
    resolved = _resolve(session, shape)
    if resolved is None:
        POINT_FALLBACKS.inc()
        return MISS
    handle, kts = resolved
    if shape.kind == "select":
        proj = _projection(handle, shape.cols)
        if proj is False:
            POINT_FALLBACKS.inc()
            return MISS
    elif shape.kind == "update":
        proj = None
        if not _sets_applicable(handle, shape.sets):
            POINT_FALLBACKS.inc()
            return MISS
    else:
        proj = None
    # privileges: the same checks the analytic path applies
    # (_enforce_privileges / _check_select_privs), before any data access
    a = session.auth()
    user = session.current_user
    if not a.is_admin(user):
        a.require(user, handle.name,
                  "select" if shape.kind == "select" else shape.kind)
    from . import lifecycle
    from .profile import RuntimeProfile

    profile = RuntimeProfile("point")
    ctx = lifecycle.current()
    if ctx is not None:
        ctx.stmt_class = "point"  # own latency class (LATENCY_POINT_MS)
        ctx.profile = profile
        ctx.tables = tuple(sorted(set(ctx.tables) | {handle.name}))
    # the lane is admission-exempt but NOT lifecycle-exempt: a queued
    # KILL lands here, before the index probe
    lifecycle.checkpoint("point::probe")
    t0 = time.perf_counter()
    POINT_LOOKUPS.inc()
    if shape.kind == "select":
        res = _run_select(session, handle, kts, proj, profile)
    else:
        POINT_DML.inc()
        if shape.kind == "update":
            res = _run_update(session, handle, kts, shape.sets)
        else:
            res = _run_delete(session, handle, kts)
        if ctx is not None:
            ctx.rows = res
    profile.add_counter("point_total", time.perf_counter() - t0, "s")
    session.last_profile = profile
    return res


def _run_select(session, handle, kts, proj, profile):
    from . import lifecycle
    from .executor import QueryResult

    ht = session.store.point_lookup(handle.name, kts, columns=proj)
    # a KILL delivered while the probe ran lands here, before the rows
    # leave the lane; accounted like any materialized buffer
    lifecycle.checkpoint("point::gather")
    lifecycle.account(ht, "point::gather")
    POINT_HIT_ROWS.inc(ht.num_rows)
    POINT_MISS_KEYS.inc(max(len(set(kts)) - ht.num_rows, 0))
    ctx = lifecycle.current()
    if ctx is not None:
        ctx.rows = ht.num_rows
    return QueryResult(ht, None, profile)


def _sets_applicable(handle, sets):
    """UPDATE assignments the point path can materialize itself: known
    non-PK columns with literals that need no coercion beyond what
    HostTable.from_pydict does (int onto int/float, float onto float,
    str onto VARCHAR, NULL onto nullable). Anything else falls back."""
    if not sets:
        return False
    names = {f.name for f in handle.schema}
    pk = {k for ks in handle.unique_keys for k in ks}
    seen = set()
    for col, val in sets:
        if col not in names or col in pk or col in seen:
            return False
        seen.add(col)
        t = handle.schema.field(col).type
        if val is None:
            if not handle.schema.field(col).nullable:
                return False
        elif isinstance(val, str):
            if not t.is_string:
                return False
        elif isinstance(val, float):
            if not t.is_float:
                return False
        elif isinstance(val, (bool, int)):
            if not (t.is_integer or t.is_float
                    or t.kind is T.TypeKind.BOOLEAN):
                return False
        else:
            return False
    return True


def _run_update(session, handle, kts, sets) -> int:
    """Point UPDATE: probe the full current rows, splice the assigned
    literals in, and ride the existing PK delta-write path (upsert ->
    delvec supersede) — the affected count is the live-hit count, exactly
    what the analytic path's COUNT(WHERE) reports."""
    from ..column import HostTable, Schema

    ht = session.store.point_lookup(handle.name, kts)
    n = ht.num_rows
    POINT_HIT_ROWS.inc(n)
    if n == 0:
        return 0
    fields = []
    arrays = dict(ht.arrays)
    valids = dict(ht.valids)
    assigned = dict(sets)
    for f in ht.schema:
        if f.name in assigned:
            v = assigned[f.name]
            one = HostTable.from_pydict({f.name: [v] * n},
                                        types={f.name: f.type})
            fields.append(one.schema.field(f.name))
            arrays[f.name] = one.arrays[f.name]
            if f.name in one.valids:
                valids[f.name] = one.valids[f.name]
            else:
                valids.pop(f.name, None)
        else:
            fields.append(f)
    updated = HostTable(Schema(tuple(fields)), arrays, valids)
    from .session import _conform_to_schema

    session.store.upsert(handle.name, _conform_to_schema(handle.schema,
                                                         updated))
    _post_dml(session, handle)
    return n


def _run_delete(session, handle, kts) -> int:
    """Point DELETE: mark delete vectors via the store's O(keys) path —
    never the full-table keep-predicate rewrite."""
    n = session.store.delete_rows(handle.name, kts)
    POINT_HIT_ROWS.inc(n)
    _post_dml(session, handle)
    return n


def _post_dml(session, handle):
    """The same invalidation trio every session DML path runs."""
    handle.invalidate()
    session.cache.invalidate(handle.name)
    session.catalog.bump_version(handle.name)
