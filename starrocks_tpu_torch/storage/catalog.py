"""Catalog: table registry, basic statistics, views, materialized views and
the storage views of information_schema.

Reference behavior: fe catalog/ (Database/OlapTable/Column) + statistic/
(row counts, column stats used by the CBO). A copy of the JAX package's
``storage/catalog.py``: the optimizer and planner read only ``get_table``,
``row_count``, ``column_stats``, ``column_ndv``, ``unique_keys`` and
``schema``, and those behave exactly as in the reference, so both packages
make the same plans from the same data. The clocks (``versions``,
``data_epochs``, ``schema_epoch``) and the invalidation listeners are the
reference's: every register/drop bumps them, and a Session's DeviceCache
listens. ``StoredTableHandle`` reads a TabletStore table lazily.
information_schema serves the storage views and the views over the serving
and observability planes (query log, processlist, profiles, metrics,
resource groups, privileges, fail points, audit log, events, workload,
alerts) and of the ingest plane (external tables, routine-load jobs).
"""

from __future__ import annotations

import dataclasses
import re
import time
import weakref
from typing import Optional

import numpy as np

from .. import types as T
from ..column import Field, HostTable, Schema, StringDict


@dataclasses.dataclass
class ColumnStats:
    min: Optional[int] = None
    max: Optional[int] = None
    n_distinct: Optional[int] = None


# the widest value range whose distinct values are counted by a bincount
# (an int64 count per value: 1 GB) instead of a sort of every value
_NDV_BINCOUNT_RANGE = 1 << 27


def _distinct_count(a: np.ndarray) -> int:
    """len(np.unique(a)): by a bincount over the value range when the
    values are integers spanning at most _NDV_BINCOUNT_RANGE (dictionary
    codes, surrogate keys, dates), else by numpy's sort."""
    if a.ndim == 1 and a.dtype.kind in "iu" and len(a):
        lo, hi = int(a.min()), int(a.max())
        if hi - lo < _NDV_BINCOUNT_RANGE:
            return int(np.count_nonzero(np.bincount(
                (a.astype(np.int64) - lo), minlength=hi - lo + 1)))
    return int(len(np.unique(a)))


class TableHandle:
    def __init__(self, name: str, table: HostTable, unique_keys=(),
                 distribution=()):
        self.name = name
        self._table = table
        # tuple of key-column tuples each of which is unique per row
        self.unique_keys = tuple(tuple(k) for k in unique_keys)
        # hash-bucketing columns (colocate-join placement on a mesh)
        self.distribution = tuple(distribution)
        self._stats: dict = {}

    @property
    def table(self) -> HostTable:
        return self._table

    @property
    def schema(self) -> Schema:
        return self.table.schema

    @property
    def row_count(self) -> int:
        return self.table.num_rows

    def column_stats(self, col: str) -> ColumnStats:
        """Lazily computed min/max (used for multi-key packing bit widths)."""
        if col not in self._stats:
            a = self.table.arrays[col]
            st = ColumnStats()
            if a.dtype.kind in "iu" and len(a):
                st.min = int(a.min())
                st.max = int(a.max())
            self._stats[col] = st
        return self._stats[col]

    def column_ndv(self, col: str) -> Optional[int]:
        """Exact distinct count, computed once per column on the host (the
        ANALYZE analog). Drives join-cardinality estimates in the cost-based
        join ordering."""
        st = self.column_stats(col)
        if st.n_distinct is None:
            a = self.table.arrays[col]
            if len(a) == 0:
                st.n_distinct = 0
            else:
                v = self.table.valids.get(col)
                if v is not None:
                    a = a[np.asarray(v)]
                st.n_distinct = _distinct_count(a)
        return st.n_distinct

    def data_version(self) -> tuple:
        """Content token of this handle's CURRENT data. In-memory tables
        mutate only through catalog.register (which bumps the epoch), so
        the row count is belt-and-braces."""
        return ("mem", self.row_count)


class StoredTableHandle(TableHandle):
    """Lazy handle over a TabletStore table (loads + caches on first read).

    The declared schema is available without touching data files."""

    def __init__(self, name: str, store, schema: Schema, unique_keys=(),
                 distribution=()):
        super().__init__(name, None, unique_keys, distribution)
        self.store = store
        self._schema = schema
        self.load_s = None  # host seconds of the last load from the files
        self.load_stats = None  # and its split (TabletStore.load_table)

    @property
    def table(self) -> HostTable:
        if self._table is None:
            t0 = time.perf_counter()
            self._table, self.load_stats = self.store.load_table(
                self.name, with_stats=True)
            self.load_s = time.perf_counter() - t0
        return self._table

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def row_count(self) -> int:
        # cheap: manifests record rowset sizes; no data load needed
        if self._table is not None:
            return self._table.num_rows
        return _live_rows(self.store.read_manifest(self.name))

    def invalidate(self):
        self._table = None
        self._stats = {}

    def data_version(self) -> tuple:
        """Manifest-derived content token: rowset watermark + live rows +
        file count. Catches direct TabletStore mutations (compaction, out-
        of-session loads) that never pass through the session's DML path."""
        m = self.store.read_manifest(self.name)
        nfiles = sum(len(rs["files"]) for rs in m["rowsets"])
        return ("store", m["next_rowset"], _live_rows(m), nfiles)

    def file_metas(self):
        """Per-data-file metadata rows for the information_schema tablets/
        partitions views (manifest only — no data load)."""
        m = self.store.read_manifest(self.name)
        out = []
        for rs in m["rowsets"]:
            for f in rs["files"]:
                out.append({
                    "file": f.get("file", ""),
                    "rows": f["rows"] - len(f.get("delvec") or ()),
                    "part": f.get("part", rs.get("part", 0)) or 0,
                })
        return out


def _live_rows(m: dict) -> int:
    """Rows of a manifest's files less their delete vectors."""
    return sum(f["rows"] - len(f.get("delvec") or ())
               for rs in m["rowsets"] for f in rs["files"])


class Catalog:
    def __init__(self):
        self.tables: dict = {}
        # logical views: name -> SQL text (inlined at reference, like the
        # reference's view expansion); MVs live in `tables` + mv_defs
        self.views: dict = {}
        self.mv_defs: dict = {}  # mv name -> SQL text (for REFRESH)
        # mv name -> {"bases": {table: version}, "meta": (sig, col/agg maps)}
        # driving the transparent rewrite (sql/mv_rewrite.py)
        self.mv_meta: dict = {}
        # per-table mutation counters: the MV staleness clock
        self.versions: dict = {}
        # per-table DATA epochs: every bump_version bumps the data epoch
        # too, but the epoch ALSO moves on storage-level mutations that
        # preserve MV freshness (compaction rewrites files without changing
        # logical content)
        self.data_epochs: dict = {}
        # invalidation listeners: fn(table_name) called on every data-epoch
        # bump (device caches subscribe; failures are swallowed — cache
        # bookkeeping must never take down DML). Held weakly: a Session's
        # DeviceCache, with its device tensors, must not outlive the
        # Session because the catalog it read outlives it.
        self._listeners: list = []
        # users + table-level grants (runtime/auth.py); created on demand
        self.auth = None
        # resource groups / admission (runtime/workgroup.py); on demand
        self.workgroups = None
        # recent statements (sessions append; information_schema.query_log)
        self.query_log: list = []
        # catalog SHAPE clock: bumped by register/drop/ALTER/view DDL.
        # DML does NOT bump it: analysis depends on schemas, not data.
        self.schema_epoch = 0

    def bump_schema_epoch(self):
        self.schema_epoch += 1

    def bump_version(self, name: str):
        n = name.lower()
        self.versions[n] = self.versions.get(n, 0) + 1
        self.bump_data_epoch(n)

    def bump_data_epoch(self, name: str):
        """Advance the table's data epoch and notify cache listeners (MV
        freshness keeps its own `versions` clock)."""
        n = name.lower()
        self.data_epochs[n] = self.data_epochs.get(n, 0) + 1
        self._listeners = [r for r in self._listeners if r() is not None]
        for ref in list(self._listeners):
            fn = ref()
            if fn is None:
                continue
            try:
                fn(n)
            except Exception:  # noqa: BLE001 — listeners must never fail DML
                pass

    def add_invalidation_listener(self, fn):
        """Subscribe fn(table_name) to data-epoch bumps. A bound method is
        held through a weak reference (its object may go away first); a
        plain function is held as it is."""
        if any(r() == fn for r in self._listeners):
            return
        self._listeners.append(weakref.WeakMethod(fn)
                               if hasattr(fn, "__self__") else (lambda: fn))

    def data_version(self, name: str) -> tuple:
        """(epoch, handle content token) for one table."""
        n = name.lower()
        epoch = self.data_epochs.get(n, 0)
        h = self.tables.get(n)
        if h is None:
            return (epoch, None)
        try:
            return (epoch,) + tuple(h.data_version())
        except Exception:  # noqa: BLE001 — a torn manifest is a cache miss
            return (epoch, "unversioned", id(h))

    def register(self, name: str, table: HostTable, unique_keys=(),
                 distribution=()):
        self.tables[name.lower()] = TableHandle(
            name.lower(), table, unique_keys, distribution
        )
        self.bump_schema_epoch()
        self.bump_version(name)

    def register_handle(self, handle: TableHandle):
        self.tables[handle.name] = handle
        self.bump_schema_epoch()
        self.bump_version(handle.name)

    def drop(self, name: str, if_exists: bool = False):
        if name.lower() not in self.tables:
            if if_exists:
                return
            raise KeyError(f"unknown table {name}")
        del self.tables[name.lower()]
        self.bump_schema_epoch()
        self.bump_version(name)

    def get_table(self, name: str) -> Optional[TableHandle]:
        name = name.lower()
        if name.startswith("information_schema."):
            return self._info_schema(name.split(".", 1)[1])
        if name == "__dual__":
            # hidden one-row constant table backing FROM-less SELECT
            if not hasattr(self, "_dual"):
                self._dual = TableHandle(
                    "__dual__", HostTable.from_pydict({"__one__": [1]})
                )
            return self._dual
        return self.tables.get(name)

    def _info_schema(self, view: str) -> Optional[TableHandle]:
        """Virtual tables over catalog state (reference analog: BE
        schema_scanner/ + fe catalog/system/information/)."""
        def vtable(cols):
            # build even when empty (from_pydict can't infer types of [])
            fields, arrays = [], {}
            for cname, ctype, values in cols:
                if ctype.is_string:
                    d, codes = StringDict.from_strings([str(v) for v in values])
                    fields.append(Field(cname, T.VARCHAR, False, d))
                    arrays[cname] = codes
                else:
                    fields.append(Field(cname, ctype, False))
                    arrays[cname] = np.asarray(values, dtype=ctype.np_dtype)
            return TableHandle(f"information_schema.{view}",
                               HostTable(Schema(tuple(fields)), arrays, {}))

        def stored(h) -> bool:
            return getattr(h, "store", None) is not None

        def cold(h) -> bool:
            """Whether reading h's data means file IO: a stored or an
            external table not loaded yet."""
            from .external import ExternalTableHandle

            return getattr(h, "_table", None) is None and (
                stored(h) or isinstance(h, ExternalTableHandle))

        if view == "tables":
            rows = [(n, self.tables[n].row_count,
                     "MATERIALIZED VIEW" if n in self.mv_defs
                     else "BASE TABLE")
                    for n in sorted(self.tables)]
            rows += [(n, 0, "VIEW") for n in sorted(self.views)]
            rows.sort()
            return vtable([
                ("table_name", T.VARCHAR, [r[0] for r in rows]),
                ("table_rows", T.BIGINT, [r[1] for r in rows]),
                ("table_type", T.VARCHAR, [r[2] for r in rows]),
            ])
        if view == "schemata":
            return vtable([
                ("schema_name", T.VARCHAR, ["default", "information_schema"]),
            ])
        if view == "views":
            names = sorted(self.views) + sorted(self.mv_defs)
            defs = ([self.views[n] for n in sorted(self.views)]
                    + [self.mv_defs[n] for n in sorted(self.mv_defs)])
            kinds = (["VIEW"] * len(self.views)
                     + ["MATERIALIZED VIEW"] * len(self.mv_defs))
            return vtable([
                ("table_name", T.VARCHAR, names),
                ("view_definition", T.VARCHAR, [d.strip() for d in defs]),
                ("view_type", T.VARCHAR, kinds),
            ])
        if view == "statistics":
            def fmt(f, v):
                """SQL-value render of an internal stats value."""
                if v is None or f.type.is_string:
                    return ""  # string stats hold dictionary CODES
                if f.type.is_decimal:
                    return str(v / 10 ** f.type.scale)
                if f.type.kind is T.TypeKind.DATE:
                    return str(np.datetime64(int(v), "D"))
                if f.type.kind is T.TypeKind.DATETIME:
                    return str(np.datetime64(int(v), "us"))
                return str(v)

            tn, cn, ndv, mn, mx, fresh = [], [], [], [], [], []
            for n in sorted(self.tables):
                h = self.tables[n]
                # metadata-only contract: computing stats loads + scans the
                # data — only report tables already resident (ANALYZE-style
                # warmth); cold stored/external tables show analyzed=0
                loaded = not cold(h)
                for f in h.schema:
                    if f.type.is_wide:
                        continue
                    tn.append(n)
                    cn.append(f.name)
                    if loaded:
                        st = h.column_stats(f.name)
                        ndv.append(int(h.column_ndv(f.name) or 0))
                        mn.append(fmt(f, st.min))
                        mx.append(fmt(f, st.max))
                    else:
                        ndv.append(0)
                        mn.append("")
                        mx.append("")
                    fresh.append(1 if loaded else 0)
            return vtable([
                ("table_name", T.VARCHAR, tn),
                ("column_name", T.VARCHAR, cn),
                ("ndv", T.BIGINT, ndv),
                ("min", T.VARCHAR, mn),
                ("max", T.VARCHAR, mx),
                ("analyzed", T.INT, fresh),
            ])
        if view == "tablets":
            # storage-layout introspection (be_tablets analog): one row per
            # stored data file; in-memory tables report one resident blob
            tn, fn, rws, prt = [], [], [], []
            for n in sorted(self.tables):
                h = self.tables[n]
                metas = getattr(h, "file_metas", None)
                if callable(metas):
                    for m in metas():
                        tn.append(n)
                        fn.append(m.get("file", ""))
                        rws.append(int(m.get("rows", 0)))
                        prt.append(int(m.get("part", 0)))
                else:
                    tn.append(n)
                    fn.append("<memory>")
                    rws.append(h.row_count)
                    prt.append(0)
            return vtable([
                ("table_name", T.VARCHAR, tn),
                ("file", T.VARCHAR, fn),
                ("rows", T.BIGINT, rws),
                ("partition_id", T.BIGINT, prt),
            ])
        if view == "partitions":
            tn, pn, rws = [], [], []
            for n in sorted(self.tables):
                h = self.tables[n]
                metas = getattr(h, "file_metas", None)
                if callable(metas):
                    by_part: dict = {}
                    for m in metas():
                        by_part[int(m.get("part", 0))] = (
                            by_part.get(int(m.get("part", 0)), 0)
                            + int(m.get("rows", 0)))
                    for p in sorted(by_part) or [0]:
                        tn.append(n)
                        pn.append(f"p{p}")
                        rws.append(by_part.get(p, 0))
                else:
                    tn.append(n)
                    pn.append("p0")
                    rws.append(h.row_count)
            return vtable([
                ("table_name", T.VARCHAR, tn),
                ("partition_name", T.VARCHAR, pn),
                ("rows", T.BIGINT, rws),
            ])
        if view == "materialized_views":
            names = sorted(self.mv_defs)
            fresh = []
            for n in names:
                meta = self.mv_meta.get(n)
                if meta is None:
                    fresh.append(0)
                else:
                    fresh.append(1 if all(
                        self.versions.get(tb, 0) == v
                        for tb, v in meta["bases"].items()) else 0)
            return vtable([
                ("name", T.VARCHAR, names),
                ("definition", T.VARCHAR,
                 [self.mv_defs[n].strip()[:512] for n in names]),
                ("rows", T.BIGINT,
                 [self.tables[n].row_count if n in self.tables else 0
                  for n in names]),
                ("is_fresh", T.INT, fresh),
            ])
        if view in ("key_column_usage", "table_constraints"):
            tn, cn, ct = [], [], []
            for n in sorted(self.tables):
                for keys in self.tables[n].unique_keys:
                    for c in keys:
                        tn.append(n)
                        cn.append(c)
                        ct.append("UNIQUE")
            if view == "table_constraints":
                seen = sorted({(t, "UNIQUE") for t in tn})
                return vtable([
                    ("table_name", T.VARCHAR, [s[0] for s in seen]),
                    ("constraint_type", T.VARCHAR, [s[1] for s in seen]),
                ])
            return vtable([
                ("table_name", T.VARCHAR, tn),
                ("column_name", T.VARCHAR, cn),
                ("constraint_name", T.VARCHAR, ct),
            ])
        if view == "referential_constraints":
            # no FOREIGN KEY DDL surface: present, empty, typed
            return vtable([
                ("constraint_name", T.VARCHAR, []),
                ("table_name", T.VARCHAR, []),
                ("referenced_table_name", T.VARCHAR, []),
            ])
        if view == "external_tables":
            from .external import ExternalTableHandle

            rows = [(n, h.location) for n, h in sorted(self.tables.items())
                    if isinstance(h, ExternalTableHandle)]
            return vtable([
                ("table_name", T.VARCHAR, [r[0] for r in rows]),
                ("location", T.VARCHAR, [r[1] for r in rows]),
            ])
        if view == "rowsets":
            tn, rid, fn, rws, prt = [], [], [], [], []
            for n in sorted(self.tables):
                h = self.tables[n]
                if not stored(h):
                    continue
                m = h.store.read_manifest(n)
                for rs in m["rowsets"]:
                    for f in rs["files"]:
                        tn.append(n)
                        rid.append(int(rs["id"]))
                        fn.append(f.get("file", ""))
                        rws.append(int(f.get("rows", 0)))
                        prt.append(int(f.get("part", rs.get("part", 0))
                                       or 0))
            return vtable([
                ("table_name", T.VARCHAR, tn),
                ("rowset_id", T.BIGINT, rid),
                ("file", T.VARCHAR, fn),
                ("rows", T.BIGINT, rws),
                ("partition_id", T.BIGINT, prt),
            ])
        if view in ("loads", "compactions"):
            # the journal IS the history (op=insert/upsert vs op=compact)
            ops = ({"insert", "upsert"} if view == "loads"
                   else {"compact"})
            store = next((h.store for h in self.tables.values()
                          if stored(h)), None)
            sq, tn, rws, kind = [], [], [], []
            if store is not None:
                for op in store.replay():
                    if op.get("op") in ops:
                        sq.append(int(op.get("seq", 0)))
                        tn.append(op.get("table", ""))
                        rws.append(int(op.get("rows", 0)))
                        kind.append(op["op"].upper())
            return vtable([
                ("seq", T.BIGINT, sq),
                ("table_name", T.VARCHAR, tn),
                ("rows", T.BIGINT, rws),
                ("type", T.VARCHAR, kind),
            ])
        if view == "column_statistics":
            tn, cn, ndv = [], [], []
            for n in sorted(self.tables):
                h = self.tables[n]
                if cold(h):
                    continue  # metadata-only contract (see "statistics"):
                    # computing NDV would LOAD cold stored/external data
                for f in h.schema:
                    if f.type.is_wide:
                        continue
                    tn.append(n)
                    cn.append(f.name)
                    ndv.append(int(h.column_ndv(f.name) or 0))
            return vtable([
                ("table_name", T.VARCHAR, tn),
                ("column_name", T.VARCHAR, cn),
                ("ndv", T.BIGINT, ndv),
            ])
        if view == "resource_groups":
            wm = getattr(self, "workgroups", None)
            rows = wm.snapshot() if wm is not None else []
            return vtable([
                ("name", T.VARCHAR, [r[0] for r in rows]),
                ("concurrency_limit", T.BIGINT, [r[1] for r in rows]),
                ("max_scan_rows", T.BIGINT, [r[2] for r in rows]),
                ("mem_limit_bytes", T.BIGINT, [r[3] for r in rows]),
                ("cpu_weight", T.BIGINT, [r[4] for r in rows]),
                ("priority", T.BIGINT, [r[5] for r in rows]),
                ("running", T.BIGINT, [r[6] for r in rows]),
                ("queued", T.BIGINT, [r[7] for r in rows]),
            ])
        if view == "routines":
            from ..runtime.udf import get_udf, list_udfs

            names = list_udfs()
            defs = [get_udf(n) for n in names]
            return vtable([
                ("routine_name", T.VARCHAR, names),
                ("routine_type", T.VARCHAR, ["FUNCTION"] * len(names)),
                ("data_type", T.VARCHAR, [repr(d.ret) for d in defs]),
                ("routine_definition", T.VARCHAR,
                 [d.source[:512] for d in defs]),
            ])
        if view in ("session_variables", "global_variables"):
            from ..runtime.config import config as cfg

            items = cfg.items()
            return vtable([
                ("variable_name", T.VARCHAR, [i[0] for i in items]),
                ("variable_value", T.VARCHAR, [str(i[1]) for i in items]),
            ])
        if view in ("table_privileges", "user_privileges"):
            a = self.auth
            gr, te, pr = [], [], []
            if a is not None:
                for user in sorted(a.grants):
                    for table, privs in sorted(a.grants[user].items()):
                        want_global = view == "user_privileges"
                        if (table == "*") != want_global:
                            continue
                        for p in sorted(privs):
                            gr.append(f"'{user}'@'%'")
                            te.append(table)
                            pr.append(p.upper())
            cols = [("grantee", T.VARCHAR, gr)]
            if view == "table_privileges":
                cols.append(("table_name", T.VARCHAR, te))
            cols.append(("privilege_type", T.VARCHAR, pr))
            return vtable(cols)
        if view == "engines":
            return vtable([
                ("engine", T.VARCHAR, ["OLAP_TPU"]),
                ("support", T.VARCHAR, ["DEFAULT"]),
                ("comment", T.VARCHAR,
                 ["columnar chunks run as eager torch programs per query"]),
            ])
        if view == "character_sets":
            return vtable([
                ("character_set_name", T.VARCHAR, ["utf8mb4"]),
                ("default_collate_name", T.VARCHAR, ["utf8mb4_bin"]),
                ("maxlen", T.BIGINT, [4]),
            ])
        if view == "collations":
            return vtable([
                ("collation_name", T.VARCHAR, ["utf8mb4_bin"]),
                ("character_set_name", T.VARCHAR, ["utf8mb4"]),
                ("is_default", T.VARCHAR, ["Yes"]),
            ])
        if view in ("queries", "processlist"):
            # the running-query registry (runtime/lifecycle.py): the SHOW
            # PROCESSLIST / KILL QUERY id-discovery surface
            from ..runtime.lifecycle import REGISTRY

            rows = REGISTRY.snapshot()
            return vtable([
                ("query_id", T.BIGINT, [r[0] for r in rows]),
                ("user", T.VARCHAR, [r[1] for r in rows]),
                ("state", T.VARCHAR, [r[2] for r in rows]),
                ("elapsed_ms", T.BIGINT, [r[3] for r in rows]),
                ("resource_group", T.VARCHAR, [r[4] for r in rows]),
                ("mem_bytes", T.BIGINT, [r[5] for r in rows]),
                ("stage", T.VARCHAR, [r[6] for r in rows]),
                ("statement", T.VARCHAR, [r[7] for r in rows]),
            ])
        if view == "fail_points":
            # armed failpoints + lifetime hit counts (the chaos/ops
            # surface of ADMIN SET failpoint; runtime/failpoint.py)
            from ..runtime import failpoint as _fp

            rows = _fp.snapshot()
            return vtable([
                ("name", T.VARCHAR, [r[0] for r in rows]),
                ("armed", T.INT, [1 if r[1] else 0 for r in rows]),
                ("times_remaining", T.BIGINT, [r[2] for r in rows]),
                ("hits", T.BIGINT, [r[3] for r in rows]),
            ])
        if view == "query_log":
            log = self.query_log[-1000:]
            return vtable([
                ("query_id", T.BIGINT,
                 [e.get("query_id", 0) for e in log]),
                ("user", T.VARCHAR, [e["user"] for e in log]),
                ("statement", T.VARCHAR, [e["sql"][:512] for e in log]),
                ("state", T.VARCHAR, [e["state"] for e in log]),
                ("rows", T.BIGINT, [e["rows"] for e in log]),
                ("ms", T.BIGINT, [e["ms"] for e in log]),
                ("queue_wait_ms", T.BIGINT,
                 [e.get("queue_wait_ms", 0) for e in log]),
                ("slow", T.INT, [e.get("slow", 0) for e in log]),
            ])
        if view == "query_profiles":
            from ..runtime.profile import PROFILE_MANAGER

            rows = PROFILE_MANAGER.snapshot()
            return vtable([
                ("query_id", T.BIGINT, [e["query_id"] for e in rows]),
                ("user", T.VARCHAR, [e["user"] for e in rows]),
                ("statement", T.VARCHAR, [e["sql"][:512] for e in rows]),
                ("state", T.VARCHAR, [e["state"] for e in rows]),
                ("rows", T.BIGINT, [e["rows"] for e in rows]),
                ("ms", T.BIGINT, [e["ms"] for e in rows]),
                ("queue_wait_ms", T.BIGINT,
                 [e["queue_wait_ms"] for e in rows]),
                ("slow", T.INT, [1 if e["slow"] else 0 for e in rows]),
                ("stage", T.VARCHAR, [e["stage"] for e in rows]),
            ])
        if view == "be_configs":
            from ..runtime.config import config as cfg

            items = cfg.items()
            return vtable([
                ("name", T.VARCHAR, [i[0] for i in items]),
                ("value", T.VARCHAR, [str(i[1]) for i in items]),
                ("default", T.VARCHAR, [str(i[2]) for i in items]),
                ("mutable", T.INT, [1 if i[3] else 0 for i in items]),
                ("description", T.VARCHAR, [i[4] for i in items]),
            ])
        if view == "metrics":
            from ..runtime.metrics import metrics as mreg

            names = sorted(mreg._metrics)
            return vtable([
                ("name", T.VARCHAR, names),
                ("value", T.BIGINT, [mreg._metrics[n].value for n in names]),
            ])
        if view == "audit_log":
            from ..runtime.audit import AUDIT

            rows = AUDIT.snapshot()
            return vtable([
                ("seq", T.BIGINT, [e["seq"] for e in rows]),
                ("query_id", T.BIGINT, [e["query_id"] for e in rows]),
                ("ts", T.DOUBLE, [e["ts"] for e in rows]),
                ("user", T.VARCHAR, [e["user"] for e in rows]),
                ("statement", T.VARCHAR, [e["stmt"] for e in rows]),
                ("stmt_class", T.VARCHAR, [e["stmt_class"] for e in rows]),
                ("tables", T.VARCHAR, [e["tables"] for e in rows]),
                ("state", T.VARCHAR, [e["state"] for e in rows]),
                ("stage", T.VARCHAR, [e["stage"] for e in rows]),
                ("ms", T.BIGINT, [e["ms"] for e in rows]),
                ("queue_wait_ms", T.BIGINT,
                 [e["queue_wait_ms"] for e in rows]),
                ("rows", T.BIGINT, [e["rows"] for e in rows]),
                ("mem_peak_bytes", T.BIGINT,
                 [e["mem_peak_bytes"] for e in rows]),
                ("degraded", T.INT, [e["degraded"] for e in rows]),
                ("plan_cache_hit", T.INT,
                 [e["plan_cache_hit"] for e in rows]),
                ("result_cache_hit", T.INT,
                 [e["result_cache_hit"] for e in rows]),
                ("partial_cache_hit", T.INT,
                 [e["partial_cache_hit"] for e in rows]),
                ("feedback_hit", T.INT,
                 [e["feedback_hit"] for e in rows]),
                ("error", T.VARCHAR, [e["error"] for e in rows]),
            ])
        if view == "events":
            import json as _json

            from ..runtime.events import EVENTS

            rows = EVENTS.snapshot()
            return vtable([
                ("seq", T.BIGINT, [e["seq"] for e in rows]),
                ("ts", T.DOUBLE, [e["ts"] for e in rows]),
                ("name", T.VARCHAR, [e["name"] for e in rows]),
                ("detail", T.VARCHAR,
                 [_json.dumps(e["detail"], sort_keys=True, default=str)
                  for e in rows]),
            ])
        if view == "metrics_history":
            from ..runtime.metrics import HISTORY

            # flattened (sample_ts, metric, kind, value): histogram
            # samples expand to _p50/_p95/_p99 rows
            flat = []
            for s in HISTORY.snapshot():
                for name, v in sorted(s["counters"].items()):
                    flat.append((s["ts"], name, "counter_delta", float(v)))
                for name, v in sorted(s["gauges"].items()):
                    flat.append((s["ts"], name, "gauge", float(v)))
                for name, h in sorted(s["histograms"].items()):
                    for q in ("p50", "p95", "p99"):
                        flat.append((s["ts"], f"{name}_{q}", "histogram",
                                     float(h[q])))
            ts = [r[0] for r in flat]
            nm = [r[1] for r in flat]
            kd = [r[2] for r in flat]
            vals = [r[3] for r in flat]
            return vtable([
                ("ts", T.DOUBLE, ts),
                ("name", T.VARCHAR, nm),
                ("kind", T.VARCHAR, kd),
                ("value", T.DOUBLE, vals),
            ])
        if view == "workload_summary":
            from ..runtime.workload import WORKLOAD

            rows = WORKLOAD.snapshot()
            return vtable([
                ("fingerprint", T.VARCHAR,
                 [e["fingerprint"] for e in rows]),
                ("stmt_class", T.VARCHAR, [e["stmt_class"] for e in rows]),
                ("count", T.BIGINT, [e["count"] for e in rows]),
                ("p50_ms", T.DOUBLE, [e["p50_ms"] for e in rows]),
                ("p95_ms", T.DOUBLE, [e["p95_ms"] for e in rows]),
                ("p99_ms", T.DOUBLE, [e["p99_ms"] for e in rows]),
                ("avg_ms", T.DOUBLE, [e["avg_ms"] for e in rows]),
                ("avg_rows", T.DOUBLE, [e["avg_rows"] for e in rows]),
                ("mem_peak_bytes", T.BIGINT,
                 [e["mem_peak_bytes"] for e in rows]),
                ("avg_queue_wait_ms", T.DOUBLE,
                 [e["avg_queue_wait_ms"] for e in rows]),
                ("errors", T.BIGINT, [e["errors"] for e in rows]),
                ("cancelled", T.BIGINT, [e["cancelled"] for e in rows]),
                ("timeouts", T.BIGINT, [e["timeouts"] for e in rows]),
                ("memlimit", T.BIGINT, [e["memlimit"] for e in rows]),
                ("degraded", T.BIGINT, [e["degraded"] for e in rows]),
                ("last_ts", T.DOUBLE, [e["last_ts"] for e in rows]),
                ("sample_sql", T.VARCHAR, [e["sample_sql"] for e in rows]),
                ("plan_cache_hit_ratio", T.DOUBLE,
                 [e["plan_cache_hit_ratio"] for e in rows]),
                ("result_cache_hit_ratio", T.DOUBLE,
                 [e["result_cache_hit_ratio"] for e in rows]),
                ("partial_cache_hit_ratio", T.DOUBLE,
                 [e["partial_cache_hit_ratio"] for e in rows]),
                ("feedback_hit_ratio", T.DOUBLE,
                 [e["feedback_hit_ratio"] for e in rows]),
            ])
        if view == "ingest_jobs":
            # routine-load jobs + progress (the SHOW ROUTINE LOAD analog;
            # CRUD surface is ADMIN SET ingest_job, ingest/poller.py)
            import json as _json

            ip = getattr(self, "ingest_plane", None)
            rows = ip.poller.snapshot() if ip is not None else []
            return vtable([
                ("name", T.VARCHAR, [e["name"] for e in rows]),
                ("table_name", T.VARCHAR, [e["table"] for e in rows]),
                ("path", T.VARCHAR, [e["path"] for e in rows]),
                ("format", T.VARCHAR, [e["format"] for e in rows]),
                ("state", T.VARCHAR, [e["state"] for e in rows]),
                ("rows_loaded", T.BIGINT,
                 [e["rows_loaded"] for e in rows]),
                ("commits", T.BIGINT, [e["commits"] for e in rows]),
                ("errors", T.BIGINT, [e["errors"] for e in rows]),
                ("last_error", T.VARCHAR, [e["last_error"] for e in rows]),
                ("last_poll_ts", T.DOUBLE,
                 [e["last_poll_ts"] for e in rows]),
                ("offsets", T.VARCHAR,
                 [_json.dumps(e["offsets"], sort_keys=True)
                  for e in rows]),
            ])
        if view == "alerts":
            from ..runtime.alerts import ALERTS

            rows = ALERTS.snapshot()
            return vtable([
                ("name", T.VARCHAR, [e["name"] for e in rows]),
                ("state", T.VARCHAR, [e["state"] for e in rows]),
                ("metric", T.VARCHAR, [e["metric"] for e in rows]),
                ("condition", T.VARCHAR, [e["condition"] for e in rows]),
                ("for_s", T.DOUBLE, [e["for_s"] for e in rows]),
                ("value", T.DOUBLE,
                 [-1.0 if e["value"] is None else float(e["value"])
                  for e in rows]),
                ("fired_ts", T.DOUBLE,
                 [0.0 if e["fired_ts"] is None else e["fired_ts"]
                  for e in rows]),
                ("fires", T.BIGINT, [e["fires"] for e in rows]),
                ("help", T.VARCHAR, [e["help"] for e in rows]),
            ])
        if view == "columns":
            tn, cn, ty, nu = [], [], [], []
            for n in sorted(self.tables):
                for f in self.tables[n].schema:
                    tn.append(n)
                    cn.append(f.name)
                    ty.append(repr(f.type))
                    nu.append(1 if f.nullable else 0)
            return vtable([
                ("table_name", T.VARCHAR, tn),
                ("column_name", T.VARCHAR, cn),
                ("data_type", T.VARCHAR, ty),
                ("is_nullable", T.INT, nu),
            ])
        return None


TPCH_UNIQUE_KEYS = {
    "region": [("r_regionkey",)],
    "nation": [("n_nationkey",)],
    "supplier": [("s_suppkey",)],
    "customer": [("c_custkey",)],
    "part": [("p_partkey",)],
    "partsupp": [("ps_partkey", "ps_suppkey")],
    "orders": [("o_orderkey",)],
    "lineitem": [("l_orderkey", "l_linenumber")],
}


TPCH_DISTRIBUTION = {
    # natural bucketing keys: lineitem/orders colocate on orderkey
    "lineitem": ("l_orderkey",),
    "orders": ("o_orderkey",),
    "customer": ("c_custkey",),
    "part": ("p_partkey",),
    "partsupp": ("ps_partkey",),
    "supplier": ("s_suppkey",),
}


def tpch_catalog(sf: float = 0.01, seed: int = 42) -> Catalog:
    from .datagen.tpch import gen_tpch

    cat = Catalog()
    for name, ht in gen_tpch(sf=sf, seed=seed).items():
        cat.register(name, ht, TPCH_UNIQUE_KEYS.get(name, ()),
                     TPCH_DISTRIBUTION.get(name, ()))
    return cat


_TYPE_RE = re.compile(r"^\s*([A-Za-z]+)\s*(?:\(\s*(\d+)\s*(?:,\s*(\d+)\s*)?\))?\s*$")


def logical_type(spec) -> T.LogicalType:
    """A LogicalType from its name as the type's repr prints it: 'BIGINT',
    'DATE', 'VARCHAR', 'DECIMAL(15,2)', ... (LogicalTypes pass through)."""
    if isinstance(spec, T.LogicalType):
        return spec
    m = _TYPE_RE.match(str(spec))
    if m is None:
        raise ValueError(f"bad type name {spec!r}")
    kind = T.TypeKind[m.group(1).upper()]
    if kind is T.TypeKind.DECIMAL:
        return T.DECIMAL(int(m.group(2) or 18), int(m.group(3) or 0))
    return T.LogicalType(kind)


def catalog_from_numpy(tables: dict, unique_keys: dict | None = None,
                       distribution: dict | None = None) -> Catalog:
    """Build a Catalog from plain host data, with no generator involved.

    tables: {table_name: [(column, type, values, dict_values, valid), ...]}
      - type: a LogicalType or its name ('BIGINT', 'DECIMAL(15,2)', 'DATE');
      - values: numpy array in the device representation (scaled int64 for
        decimals, int32 days for dates, int32 codes for VARCHAR);
      - dict_values: the sorted dictionary of a VARCHAR column, else None;
      - valid: boolean validity mask, or None when the column has no NULLs.
    unique_keys / distribution: {table_name: ...} as in tpch_catalog.
    """
    unique_keys = unique_keys or {}
    distribution = distribution or {}
    cat = Catalog()
    for name, cols in tables.items():
        fields, arrays, valids = [], {}, {}
        for col, tspec, values, dict_values, valid in cols:
            t = logical_type(tspec)
            d = None
            if t.is_string:
                if dict_values is None:
                    raise ValueError(f"{name}.{col}: VARCHAR needs dict_values")
                d = StringDict.from_values(list(dict_values))
            fields.append(Field(col, t, True, d))
            arrays[col] = np.asarray(values, dtype=t.np_dtype)
            if valid is not None:
                valids[col] = np.asarray(valid, dtype=np.bool_)
        cat.register(name, HostTable(Schema(tuple(fields)), arrays, valids),
                     unique_keys.get(name, ()), distribution.get(name, ()))
    return cat
