"""Session: the SQL entry point of the port.

Reference behavior: fe qe/ConnectContext + StmtExecutor.execute
(qe/StmtExecutor.java:923) — parse, analyze, plan, execute, return rows.
DDL (CREATE/DROP) and DML (INSERT/DELETE/UPDATE) mutate the catalog the way
LocalMetastore does (server/LocalMetastore.java:301). A port of the JAX
package's runtime/session.py: SELECT and set operations, SET, EXPLAIN,
CREATE TABLE [AS SELECT] (PRIMARY KEY, DISTRIBUTED BY HASH .. BUCKETS,
PARTITION BY RANGE), DROP TABLE/VIEW/MATERIALIZED VIEW, INSERT VALUES and
INSERT .. SELECT, DELETE, UPDATE, CREATE VIEW, CREATE MATERIALIZED VIEW,
REFRESH, SHOW TABLES [FULL], SHOW PARTITIONS, SHOW CREATE, DESCRIBE and
ALTER TABLE ADD/DROP COLUMN; each returns what the reference's returns.
The statements of the serving, security and observability planes (users
and grants, UDFs, resource groups, external tables, KILL, PROCESSLIST,
WORKLOAD, PROFILE, ADMIN, EXPLAIN ANALYZE) and `load_csv` raise
NotImplementedError.

A Session runs on the card unless the caller asks for the CPU:
`Session(catalog)` and `Session(data_dir=...)` put their tensors on `cuda`
and raise where there is none; `device="cpu"` runs every operator (and
every kernel's plain torch version) on the CPU. With a `data_dir`, tables
persist in a TabletStore (storage/store.py) and a new Session over the same
directory rebuilds the catalog from the manifests and the journal.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import replace as dataclasses_replace

import numpy as np
import torch

from .. import types as T
from ..column import Field, HostTable, Schema, StringDict
from ..column.host_table import _dec128_to_int, _int_to_dec128
from ..exprs.ir import AggExpr, Call, Case, Lit
from ..sql import ast
from ..sql.analyzer import Analyzer
from ..sql.logical import plan_tree_str
from ..sql.optimizer import optimize
from ..sql.parser import parse
from ..storage.catalog import Catalog, StoredTableHandle
from ..storage.store import TabletStore, _empty_table, schema_from_json
from .config import config
from .udf import create_udf, drop_udf
from .executor import (
    DeviceCache, Executor, QueryResult, _extract_group_concat,
    group_concat_main_plan,
)

# statements of the serving, security and observability planes: slice 8
_PLANE_STATEMENTS = (
    ast.CreateUser, ast.DropUser, ast.Grant, ast.Revoke, ast.ShowGrants,
    ast.CreateExternalTable,
    ast.CreateResourceGroup, ast.DropResourceGroup, ast.ShowResourceGroups,
    ast.KillQuery, ast.ShowProcesslist, ast.ShowWorkload, ast.ShowProfile,
    ast.AdminSetFailpoint, ast.AdminSetAlert, ast.AdminSetIngestJob,
    ast.AdminDiagnose,
)


def _not_yet(what: str, slice_no: int):
    return NotImplementedError(
        f"{what} is not in the port yet (slice {slice_no})")


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Session needs a CUDA device and none is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _fold_lit(x):
    """Literal value of an INSERT VALUES cell (unary minus folds)."""
    if isinstance(x, Lit):
        return x.value
    if (isinstance(x, Call) and x.fn in ("negate", "negative")
            and len(x.args) == 1 and isinstance(x.args[0], Lit)):
        return -x.args[0].value
    raise ValueError("INSERT VALUES must be literals")


def _writable(name: str):
    """Reserve the hidden-table namespace from DML/DDL (e.g. __dual__, the
    constant table behind FROM-less SELECT)."""
    if name.lower().startswith("__"):
        raise ValueError(f"table name {name!r} is reserved")


class Session:
    """data_dir=None -> in-memory tables only; with a data_dir, DDL and loads
    persist through the TabletStore (bucketed numpy rowsets + edit log) and
    the catalog is rebuilt by replay on startup (the EditLog/loadImage
    analog, fe persist/EditLog.java:133)."""

    # journal ops before an image snapshot triggers (the FE
    # CheckpointController's checkpoint-interval analog)
    CHECKPOINT_OPS = 256

    def __init__(self, catalog: Catalog | None = None, device=None,
                 data_dir: str | None = None, dist_shards: int | None = None):
        self.device = _resolve_device(device)
        self.catalog = catalog or Catalog()
        self.cache = DeviceCache(self.device)
        self.last_profile = None  # most recent query's profile dict
        self.store = None
        # dist_shards=n: queries run over an n-shard mesh on this device
        # (runtime/dist_executor.py), sharing this Session's DeviceCache
        self.dist_shards = dist_shards
        self._dist_executor = None
        self._in_sql = False
        if data_dir is not None:
            self.store = TabletStore(data_dir)
            # replay: the manifest set is authoritative for current tables
            for name in self.store.table_names():
                m = self.store.read_manifest(name)
                self.catalog.register_handle(
                    StoredTableHandle(
                        name, self.store, schema_from_json(m["schema"]),
                        [tuple(k) for k in m.get("unique_keys", [])],
                        tuple(m.get("distribution", ())),
                    )
                )
            self._restore_catalog_meta()
            # storage-level mutations that bypass session DML (an explicit
            # compact_table) advance the catalog's data epoch too
            self.store.add_listener(
                lambda t, op: self.catalog.bump_data_epoch(t))
            # the plan-feedback journal lives beside the manifests, so
            # learned capacities and hot keys survive a restart
            self.cache.feedback.attach(
                os.path.join(self.store.root, "plan_feedback.json"))
        # data-epoch bumps invalidate this session's device cache (DML paths
        # also call cache.invalidate directly — idempotent; the listener
        # covers epochs advanced by other sessions on a shared catalog and
        # by the store listener above)
        self.catalog.add_invalidation_listener(self.cache.invalidate)

    def checkpoint_metadata(self) -> int | None:
        """Snapshot catalog-level metadata (views, MV definitions) into the
        store's image and truncate the edit log. Table state is NOT in the
        image: manifests are authoritative for it."""
        if self.store is None:
            return None
        img = {"views": dict(self.catalog.views),
               "mv_defs": dict(self.catalog.mv_defs)}
        return self.store.checkpoint(img)

    def _restore_catalog_meta(self):
        """Startup: load the catalog image, then replay the journal tail's
        catalog-level ops (image + tail = full metadata state). MVs
        re-materialize from their definitions at the end — base tables are
        already registered from manifests."""
        img = self.store.read_image()
        base = img["seq"] if img else 0
        cat = (img or {}).get("catalog", {})
        self.catalog.views.update(cat.get("views", {}))
        mv_defs = dict(cat.get("mv_defs", {}))
        for op in self.store.replay(after_seq=base):
            k = op["op"]
            if k == "create_view":
                self.catalog.views[op["name"]] = op["text"]
            elif k == "drop_view":
                self.catalog.views.pop(op["name"], None)
            elif k == "create_mv":
                mv_defs[op["name"]] = op["text"]
            elif k == "drop_mv":
                mv_defs.pop(op["name"], None)
        for n, text in mv_defs.items():
            self.catalog.mv_defs[n] = text
            try:
                self._refresh_mv(n)
            except Exception:  # noqa: BLE001
                # defining query no longer runs (e.g. base table dropped
                # without dropping the MV): keep the definition visible and
                # unmaterialized; queries against it fail with the real error
                pass
        self.store.ensure_seq()

    def _log_meta(self, op: dict):
        """Journal a catalog-level op (no-op without a persistent store)."""
        if self.store is not None:
            self.store.log(op)

    def load_csv(self, table: str, path: str, **csv_opts) -> int:
        raise _not_yet("load_csv", 8)

    def sql(self, text: str):
        """Execute one statement. After a top-level statement, once the
        journal tail outgrows CHECKPOINT_OPS, catalog metadata is
        snapshotted and the log truncated (the FE CheckpointController
        analog, leader/CheckpointController.java:85)."""
        if self._in_sql:
            return self._sql_inner(text)
        self._in_sql = True
        try:
            return self._sql_inner(text)
        finally:
            self._in_sql = False
            if (self.store is not None
                    and (self.store.tail_count or 0) >= self.CHECKPOINT_OPS):
                try:
                    self.checkpoint_metadata()
                except OSError:
                    pass  # disk hiccup: keep serving; next statement retries

    def _sql_inner(self, text: str):
        # prepared-statement fast path: statement text -> analyzed plan
        # (cache/plan_cache.py); only SELECT plans are stored, so other
        # statements always miss
        text_key = text.strip().rstrip(";")
        if config.get("enable_plan_cache"):
            hit = self.cache.plan_cache.lookup(text_key, self.catalog)
            if hit is not None:
                return self._query_planned(hit, from_plan_cache=True)
        stmt = parse(text)
        if isinstance(stmt, _PLANE_STATEMENTS):
            raise _not_yet(f"{type(stmt).__name__} statements", 8)
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt)
        if isinstance(stmt, (ast.Select, ast.SetOp)):
            return self._query(stmt, cache_text=text_key)
        if isinstance(stmt, ast.CreateTable):
            return self._create(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._drop(stmt)
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt)
        if isinstance(stmt, ast.Update):
            return self._update(stmt)
        if isinstance(stmt, ast.CreateFunction):
            create_udf(stmt.name, stmt.params, stmt.ret, stmt.source,
                       replace=stmt.replace)
            self.cache.clear_plans()  # plans may now resolve differently
            return None
        if isinstance(stmt, ast.DropFunction):
            drop_udf(stmt.name, stmt.if_exists)
            self.cache.clear_plans()
            return None
        if isinstance(stmt, ast.SetVar):
            if stmt.name.lower() == "resource_group":
                raise _not_yet("SET resource_group", 8)
            config.set(stmt.name, stmt.value)
            return None
        if isinstance(stmt, ast.CreateView):
            return self._create_view(stmt)
        if isinstance(stmt, ast.RefreshView):
            return self._refresh_mv(stmt.name.lower())
        if isinstance(stmt, ast.ShowTables):
            if stmt.full:  # SHOW FULL TABLES: (name, type) resultset
                return self._query(parse(
                    "select table_name, table_type "
                    "from information_schema.tables"))
            return sorted([*self.catalog.tables, *self.catalog.views])
        if isinstance(stmt, ast.ShowPartitions):
            return self._show_partitions(stmt.table.lower())
        if isinstance(stmt, ast.AlterTable):
            return self._alter(stmt)
        if isinstance(stmt, ast.ShowCreate):
            return self._show_create(stmt.table)
        if isinstance(stmt, ast.Describe):
            h = self.catalog.get_table(stmt.table)
            if h is None:
                raise ValueError(f"unknown table {stmt.table}")
            return [
                (f.name, repr(f.type), "YES" if f.nullable else "NO")
                for f in h.schema
            ]
        raise ValueError(f"unsupported statement {type(stmt).__name__}")

    # --- DDL -----------------------------------------------------------------
    def _drop(self, stmt: ast.DropTable):
        nm = stmt.name.lower()
        if nm in self.catalog.views:
            del self.catalog.views[nm]
            self.catalog.bump_schema_epoch()  # cached plans inlined it
            self._log_meta({"op": "drop_view", "name": nm})
            return None
        if nm in self.catalog.mv_defs:
            self._log_meta({"op": "drop_mv", "name": nm})
            self.catalog.mv_defs.pop(nm)
            if self.catalog.get_table(nm) is None:
                # definition restored but never materialized: there is no
                # backing table to drop
                return None
        existed = self.catalog.get_table(stmt.name) is not None
        self.catalog.drop(stmt.name, stmt.if_exists)
        self.cache.invalidate(nm)
        self.catalog.bump_version(nm)
        if self.store is not None and existed:
            self.store.drop_table(nm)
        return None

    def _create_view(self, stmt: ast.CreateView):
        name = stmt.name.lower()
        if (
            self.catalog.get_table(name) is not None
            or name in self.catalog.views
            or name in self.catalog.mv_defs
        ):
            raise ValueError(f"name {name!r} already exists")
        if stmt.materialized:
            # validate + materialize BEFORE committing the definition so a
            # failing query leaves no half-created MV behind
            self.catalog.mv_defs[name] = stmt.select_text
            try:
                self._refresh_mv(name)
            except Exception:
                self.catalog.mv_defs.pop(name, None)
                raise
            self._log_meta({"op": "create_mv", "name": name,
                            "text": stmt.select_text})
        else:
            self.catalog.views[name] = stmt.select_text
            self.catalog.bump_schema_epoch()
            self._log_meta({"op": "create_view", "name": name,
                            "text": stmt.select_text})
        return None

    def _alter(self, stmt: ast.AlterTable):
        """ALTER TABLE ADD/DROP COLUMN (linked schema change: stored data
        files are untouched; reads fill added columns with NULL)."""
        _writable(stmt.table)
        name = stmt.table.lower()
        handle = self.catalog.get_table(name)
        if handle is None:
            raise ValueError(f"unknown table {name}")
        if self.store is not None and isinstance(handle, StoredTableHandle):
            new_schema = self.store.alter_table(
                name, stmt.action, stmt.column, stmt.type, stmt.nullable)
            self.catalog.register_handle(StoredTableHandle(
                name, self.store, new_schema, handle.unique_keys,
                handle.distribution))
        else:
            ht = handle.table
            protected = set(handle.distribution) | {
                k for ks in handle.unique_keys for k in ks}
            TabletStore.validate_alter(
                ht.schema, stmt.action, stmt.column, stmt.nullable,
                ht.num_rows > 0, protected)
            if stmt.action == "add":
                t = stmt.type
                d = StringDict.from_values([]) if t.is_string else None
                fields = tuple(ht.schema.fields) + (
                    Field(stmt.column, t, stmt.nullable, d),)
                arrays = dict(ht.arrays)
                if t.is_array:
                    shape = (ht.num_rows, 2)
                elif t.is_decimal128:
                    shape = (ht.num_rows, 4)
                elif t.is_hll or t.is_bitmap:
                    shape = (ht.num_rows, t.wide_width)
                else:
                    shape = ht.num_rows
                arrays[stmt.column] = np.zeros(shape, dtype=t.np_dtype)
                valids = dict(ht.valids)
                if ht.num_rows:
                    valids[stmt.column] = np.zeros(ht.num_rows,
                                                   dtype=np.bool_)
                new = HostTable(Schema(fields), arrays, valids)
            else:
                fields = tuple(f for f in ht.schema.fields
                               if f.name != stmt.column)
                arrays = {k: v for k, v in ht.arrays.items()
                          if k != stmt.column}
                valids = {k: v for k, v in ht.valids.items()
                          if k != stmt.column}
                new = HostTable(Schema(fields), arrays, valids)
            self.catalog.register(name, new, handle.unique_keys,
                                  handle.distribution)
        self.cache.invalidate(name)
        self.catalog.bump_version(name)
        return None

    def _show_partitions(self, name: str):
        """SHOW PARTITIONS FROM t: per-partition bounds, rows, files (the
        fe ShowPartitionsStmt surface at this scale)."""
        if self.store is None:
            raise ValueError("SHOW PARTITIONS requires a persistent store")
        m = self.store.read_manifest(name)
        pb = m.get("partition_by")
        if not pb:
            raise ValueError(f"table {name!r} is not partitioned")
        rows_by_part: dict = {}
        files_by_part: dict = {}
        for rs in m["rowsets"]:
            for f in rs["files"]:
                p = f.get("part")
                rows_by_part[p] = rows_by_part.get(p, 0) + f["rows"] - len(
                    f.get("delvec") or ())
                files_by_part[p] = files_by_part.get(p, 0) + 1
        ptype = schema_from_json(m["schema"]).field(pb["column"]).type

        def fmt(v):
            if v is None:
                return None
            if ptype.kind is T.TypeKind.DATE:
                return str(datetime.date(1970, 1, 1)
                           + datetime.timedelta(days=int(v)))
            if ptype.kind is T.TypeKind.DATETIME:
                return str(datetime.datetime(1970, 1, 1)
                           + datetime.timedelta(microseconds=int(v)))
            return str(v)

        lo = None
        out = []
        for i, (pn, up) in enumerate(zip(pb["names"], pb["uppers"])):
            out.append((pn, pb["column"],
                        "MIN" if lo is None else fmt(lo),
                        "MAXVALUE" if up is None else fmt(up),
                        rows_by_part.get(i, 0), files_by_part.get(i, 0)))
            lo = up
        return out

    def _refresh_mv(self, name: str) -> int:
        """(Re)materialize an MV: run its defining query, replace the backing
        table (reference analog: the MV refresh TaskRun pipeline,
        fe scheduler/mv/ — here: full refresh on demand)."""
        from ..sql import mv_rewrite

        sql_text = self.catalog.mv_defs.get(name)
        if sql_text is None:
            raise ValueError(f"unknown materialized view {name!r}")
        # never serve the refresh from a previous materialization of itself
        self.catalog.mv_meta.pop(name, None)
        res = self.sql(sql_text)
        t = res.table
        if any("." in f.name for f in t.schema):
            raise ValueError("materialized view query has duplicate column names")
        self.catalog.register(name, t)
        self.cache.invalidate(name)
        self.catalog.bump_version(name)
        # record rewrite metadata + the base versions this refresh observed;
        # a later base mutation makes the versions diverge and disables the
        # transparent rewrite until the next REFRESH (sql/mv_rewrite.py)
        try:
            stmt = parse(sql_text)
            if isinstance(stmt, (ast.Select, ast.SetOp)):
                mv_plan = Analyzer(self.catalog).analyze(stmt)
                meta = mv_rewrite.mv_metadata(mv_plan)
                if meta is not None:
                    bases = {tb: self.catalog.versions.get(tb, 0)
                             for tb in meta[0].tables}
                    self.catalog.mv_meta[name] = {"bases": bases,
                                                  "meta": meta}
        except Exception:  # noqa: BLE001 — rewrite metadata is best-effort
            pass
        # cached optimized plans may have (not) rewritten against this MV
        # under the previous freshness state
        self.cache.clear_plans()
        return t.num_rows

    def _show_create(self, name: str) -> str:
        nm = name.lower()
        if nm in self.catalog.views:
            return f"CREATE VIEW {nm} AS {self.catalog.views[nm].strip()}"
        if nm in self.catalog.mv_defs:
            return (f"CREATE MATERIALIZED VIEW {nm} AS "
                    f"{self.catalog.mv_defs[nm].strip()}")
        h = self.catalog.get_table(name)
        if h is None:
            raise ValueError(f"unknown table {name}")
        cols = ",\n  ".join(
            f"{f.name} {repr(f.type)}{'' if f.nullable else ' NOT NULL'}"
            for f in h.schema
        )
        out = f"CREATE TABLE {nm} (\n  {cols}"
        if h.unique_keys:
            out += f",\n  PRIMARY KEY({', '.join(h.unique_keys[0])})"
        out += "\n)"
        if h.distribution:
            out += f" DISTRIBUTED BY HASH({', '.join(h.distribution)})"
        return out

    # --- SELECT / EXPLAIN ------------------------------------------------------
    def _query(self, sel, cache_text: str | None = None) -> QueryResult:
        plan = Analyzer(self.catalog).analyze(sel)
        if cache_text is not None and config.get("enable_plan_cache"):
            # only top-level statement texts store (internal plans — view
            # expansions, MV refresh bodies — have no client-visible text)
            self.cache.plan_cache.store(cache_text, plan, self.catalog)
        return self._query_planned(plan)

    def _query_planned(self, plan, from_plan_cache: bool = False):
        """Execute an already-analyzed plan (the plan cache's hits enter
        here, skipping parse and analysis)."""
        profile: dict = {}
        if from_plan_cache:
            profile["counters"] = {"plan_cache_hits": 1}
        res = self._executor().execute_logical(plan, profile)
        self.last_profile = res.profile
        return res

    def _executor(self):
        if not self.dist_shards:
            return Executor(self.catalog, self.cache)
        if self._dist_executor is None:
            from .dist_executor import DistExecutor

            self._dist_executor = DistExecutor(
                self.catalog, n_shards=self.dist_shards,
                device_cache=self.cache)
        return self._dist_executor

    def _explain(self, stmt: ast.Explain) -> str:
        assert isinstance(stmt.stmt, (ast.Select, ast.SetOp)), "EXPLAIN supports SELECT"
        if stmt.analyze:
            raise _not_yet("EXPLAIN ANALYZE", 8)
        plan = Analyzer(self.catalog).analyze(stmt.stmt)
        # mirror the executor's group_concat two-plan orchestration: EXPLAIN
        # must show the plan that would actually run
        header = ""
        gc = _extract_group_concat(plan)
        if gc is not None:
            plan, _ = group_concat_main_plan(plan, gc)
            header = ("-- group_concat: two-plan orchestration (main plan "
                      "below; per-group concatenation host-finalized from a "
                      "(keys, arg) side plan)\n")
        plan = optimize(plan, self.catalog)
        return header + plan_tree_str(plan)

    # --- DML -------------------------------------------------------------------
    def _target(self, table: str):
        _writable(table)
        handle = self.catalog.get_table(table)
        if handle is None:
            raise ValueError(f"unknown table {table}")
        return handle

    def _delete(self, stmt: ast.Delete):
        """DELETE FROM t [WHERE pred]: keep rows where pred is FALSE or NULL,
        rewrite the table (reference analog: delete predicates applied at
        read/compaction; here: immediate rewrite — object-store-first)."""
        handle = self._target(stmt.table)
        before = handle.row_count
        if stmt.where is None:
            kept = _empty_table(handle.schema)
        else:
            keep_pred = Call("not", Call("coalesce", stmt.where, Lit(False)))
            sel = ast.Select(
                items=(ast.SelectItem(ast.Star()),),
                from_=ast.TableRef(stmt.table, None),
                where=keep_pred,
            )
            kept = self._query(sel).table
        self._replace_table_data(handle, kept)
        return before - kept.num_rows

    def _update(self, stmt: ast.Update):
        """UPDATE t SET c = expr [WHERE pred]: evaluated as a full-table
        projection (CASE WHEN pred THEN expr ELSE c END) + rewrite."""
        handle = self._target(stmt.table)
        assigned = dict(stmt.assignments)
        pk_cols = {k for ks in handle.unique_keys for k in ks}
        for c in assigned:
            if c not in {f.name for f in handle.schema}:
                raise ValueError(f"unknown column {c!r} in UPDATE")
            if c in pk_cols:
                raise ValueError(
                    f"cannot UPDATE primary-key column {c!r} (delete+insert)"
                )
        items = []
        for f in handle.schema:
            if f.name in assigned:
                new = assigned[f.name]
                if stmt.where is not None:
                    cond = Call("coalesce", stmt.where, Lit(False))
                    new = Case(((cond, new),), ast.RawCol(None, f.name))
                items.append(ast.SelectItem(new, f.name))
            else:
                items.append(ast.SelectItem(ast.RawCol(None, f.name), f.name))
        sel = ast.Select(items=tuple(items),
                         from_=ast.TableRef(stmt.table, None))
        updated = self._query(sel).table
        if stmt.where is not None:
            cnt_sel = ast.Select(
                items=(ast.SelectItem(AggExpr("count", None), "n"),),
                from_=ast.TableRef(stmt.table, None),
                where=stmt.where,
            )
            affected = self._query(cnt_sel).rows()[0][0]
        else:
            affected = handle.row_count
        self._replace_table_data(handle, updated)
        return affected

    def _upsert_merge(self, handle, merged: HostTable) -> HostTable:
        """PRIMARY KEY model: keep the LAST row per key (merge-on-write;
        reference analog: primary-key tables' upsert apply,
        be/src/storage/tablet_updates.h:108 — re-designed as immediate
        dedupe since rowsets rewrite atomically anyway)."""
        keys = [k for ks in handle.unique_keys for k in ks]
        if not keys:
            return merged
        cols = [np.asarray(merged.arrays[k]) for k in keys]
        # np.lexsort: LAST tuple element is the primary key; stable sort
        # preserves insertion order within equal keys (last-write-wins)
        order = np.lexsort(tuple(reversed(cols)))
        sorted_keys = [c[order] for c in cols]
        is_last = np.ones(merged.num_rows, dtype=bool)
        if merged.num_rows > 1:
            same_as_next = np.ones(merged.num_rows - 1, dtype=bool)
            for c in sorted_keys:
                same_as_next &= c[:-1] == c[1:]
            is_last[:-1] = ~same_as_next
        keep_idx = np.sort(order[is_last])
        return HostTable(
            merged.schema,
            {n: a[keep_idx] for n, a in merged.arrays.items()},
            {n: v[keep_idx] for n, v in merged.valids.items()},
        )

    def _replace_table_data(self, handle, data: HostTable):
        conformed = _conform_to_schema(handle.schema, data)
        if self.store is not None and isinstance(handle, StoredTableHandle):
            self.store.rewrite_table(handle.name, conformed)
            handle.invalidate()
        else:
            self.catalog.register(handle.name, conformed, handle.unique_keys,
                                  handle.distribution)
        self.cache.invalidate(handle.name)
        self.catalog.bump_version(handle.name)

    def _create(self, stmt: ast.CreateTable):
        _writable(stmt.name)
        if stmt.select is not None:
            # CREATE TABLE .. AS SELECT: schema inferred from the result
            t = self._query(stmt.select).table
            if any("." in f.name for f in t.schema):
                raise ValueError(
                    "CTAS query has duplicate column names; alias them: "
                    f"{[f.name for f in t.schema if '.' in f.name]}"
                )
            if self.store is not None:
                name = stmt.name.lower()
                self.store.create_table(name, t.schema, (), 1)
                h = StoredTableHandle(name, self.store, t.schema)
                self.catalog.register_handle(h)
                if t.num_rows:
                    self.store.insert(name, t)
                    h.invalidate()
            else:
                self.catalog.register(stmt.name, t, unique_keys=())
            return t.num_rows
        fields, arrays = [], {}
        for c in stmt.columns:
            t = c.type
            d = StringDict.from_values([]) if t.is_string else None
            fields.append(Field(c.name, t, c.nullable, d))
            if t.is_decimal128:
                arrays[c.name] = np.zeros((0, 4), dtype=np.int64)
            elif t.is_array:
                arrays[c.name] = np.zeros((0, 2), dtype=t.np_dtype)
            elif t.is_wide:
                arrays[c.name] = np.zeros((0, t.wide_width), dtype=t.np_dtype)
            else:
                arrays[c.name] = np.zeros(0, dtype=t.np_dtype)
        schema = Schema(tuple(fields))
        # DISTRIBUTED BY HASH is bucketing, NOT a uniqueness guarantee; the
        # PRIMARY KEY clause is one (upsert model enforces it on write)
        pk = [stmt.primary_key] if stmt.primary_key else []
        for k in stmt.primary_key:
            if k not in {f.name for f in schema}:
                raise ValueError(f"PRIMARY KEY column {k!r} not in schema")
        if self.store is not None:
            name = stmt.name.lower()
            part = stmt.partition_by
            if part is not None:
                if part["column"] not in {f.name for f in schema}:
                    raise ValueError(
                        f"partition column {part['column']!r} not in schema")
                pf = schema.field(part["column"])
                if pf.type.is_temporal:
                    def _bound(u):
                        if u is None:
                            return None
                        if pf.type.kind is T.TypeKind.DATETIME:
                            dt = datetime.datetime.fromisoformat(
                                str(u).replace(" ", "T"))
                            return int((dt - datetime.datetime(1970, 1, 1))
                                       // datetime.timedelta(microseconds=1))
                        return (datetime.date.fromisoformat(str(u))
                                - datetime.date(1970, 1, 1)).days

                    part = dict(part)
                    part["uppers"] = [_bound(u) for u in part["uppers"]]
            self.store.create_table(
                name, schema, stmt.distributed_by, stmt.buckets or 1,
                unique_keys=pk, partition_by=part,
            )
            self.catalog.register_handle(
                StoredTableHandle(
                    name, self.store, schema, pk, tuple(stmt.distributed_by)
                )
            )
        else:
            ht = HostTable(schema, arrays, {})
            self.catalog.register(
                stmt.name, ht, unique_keys=pk,
                distribution=tuple(stmt.distributed_by),
            )
        return None

    def _insert(self, stmt: ast.Insert):
        handle = self._target(stmt.table)
        if stmt.select is not None:
            incoming = self._query(stmt.select).table
            # INSERT .. SELECT maps columns positionally
            target = stmt.columns or tuple(f.name for f in handle.schema)
            if len(incoming.schema) != len(target):
                raise ValueError(
                    f"INSERT arity mismatch: {len(incoming.schema)} select "
                    f"columns vs {len(target)} target columns"
                )
            incoming = HostTable(
                Schema(tuple(
                    dataclasses_replace(f, name=t)
                    for f, t in zip(incoming.schema.fields, target)
                )),
                {t: incoming.arrays[f.name]
                 for f, t in zip(incoming.schema.fields, target)},
                {t: incoming.valids[f.name]
                 for f, t in zip(incoming.schema.fields, target)
                 if f.name in incoming.valids},
            )
        else:
            incoming = self._values_to_table(handle, stmt)
        return self._append(handle, incoming)

    def _append(self, handle, incoming: HostTable) -> int:
        n = incoming.num_rows
        stored = self.store is not None and isinstance(handle,
                                                       StoredTableHandle)
        if handle.unique_keys:
            for ks in handle.unique_keys:
                for k in ks:
                    v = incoming.valids.get(k)
                    if v is not None and not v.all():
                        raise ValueError(
                            f"NULL value in PRIMARY KEY column {k!r}"
                        )
            if stored:
                # delta path: append rowset + delete vectors, O(delta) bytes
                # (be/src/storage/tablet_updates.h:108)
                self.store.upsert(handle.name,
                                  _conform_to_schema(handle.schema, incoming))
                handle.invalidate()
                self.cache.invalidate(handle.name)
                self.catalog.bump_version(handle.name)
                return n
            # in-memory tables: merge + dedupe (last write wins), rewrite
            merged = concat_tables(handle.table, incoming,
                                   target_schema=handle.schema)
            self._replace_table_data(handle, self._upsert_merge(handle, merged))
            return n
        if stored:
            # conform incoming data to the declared schema before persisting
            self.store.insert(handle.name,
                              _conform_to_schema(handle.schema, incoming))
            handle.invalidate()
        else:
            merged = concat_tables(handle.table, incoming,
                                   target_schema=handle.schema)
            self.catalog.register(handle.name, merged, handle.unique_keys,
                                  handle.distribution)
        self.cache.invalidate(handle.name)
        self.catalog.bump_version(handle.name)
        return n

    def _values_to_table(self, handle, stmt: ast.Insert) -> HostTable:
        cols = stmt.columns or tuple(f.name for f in handle.schema)
        rows = stmt.values
        data = {c: [] for c in cols}
        for row in rows:
            if len(row) != len(cols):
                raise ValueError("INSERT arity mismatch")
            for c, e in zip(cols, row):
                if isinstance(e, Call) and e.fn == "array":
                    data[c].append([_fold_lit(x) for x in e.args])
                    continue
                data[c].append(_fold_lit(e))
        types, out = {}, {}
        for f in handle.schema:
            out[f.name] = data[f.name] if f.name in data else [None] * len(rows)
            types[f.name] = f.type
        return HostTable.from_pydict(out, types=types)


def _rescale_dec128(ba: np.ndarray, src: T.LogicalType,
                    dst: T.LogicalType) -> np.ndarray:
    """Decimal or integer values of type `src` (scaled int64, or [n, 4]
    limbs) as DECIMAL(38) limbs at `dst`'s scale (exact, on Python ints)."""
    diff = dst.scale - (src.scale or 0)
    out = np.zeros((len(ba), 4), dtype=np.int64)
    for i in range(len(ba)):
        v = _dec128_to_int(ba[i]) if src.is_decimal128 else int(ba[i])
        v = v * 10 ** diff if diff >= 0 else v // 10 ** -diff
        out[i] = _int_to_dec128(v)
    return out


def concat_tables(a: HostTable, b: HostTable, target_schema: Schema) -> HostTable:
    """Append b's rows to a, merging string dictionaries per column."""
    fields, arrays, valids = [], {}, {}
    bn = {f.name.split(".", 1)[-1]: f.name for f in b.schema}
    for f in target_schema:
        name = f.name
        bname = bn.get(name, name)
        fb = b.schema.field(bname)
        aa = a.arrays[name]
        ba = b.arrays[bname]
        if f.type.is_array:
            aa, ba, dct = _align_arrays(a.schema.field(name), fb, aa, ba)
            fields.append(Field(name, f.type, f.nullable, dct))
        elif f.type.is_string:
            # remap through each side's ACTUAL dict (the target schema's dict
            # may be the declared empty one for stored tables)
            fa = a.schema.field(name)
            da = fa.dict or StringDict.from_values([])
            db = fb.dict or StringDict.from_values([])
            if not len(da) or not len(db):
                # one side's dictionary is empty (a declared schema, or a
                # column added by ALTER): the union is the other's, whose
                # codes stand; the empty side's rows are all NULL
                merged = db if len(db) else da
                aa = aa if len(da) else np.zeros_like(aa)
                ba = ba if len(db) else np.zeros_like(ba)
            else:
                merged, ra, rb = da.merge(db)
                aa = ra[aa] if len(aa) else aa
                ba = rb[ba] if len(ba) else ba
            fields.append(Field(name, f.type, f.nullable, merged))
        else:
            if fb.type != f.type:
                if f.type.is_decimal128 and (fb.type.is_decimal
                                             or fb.type.is_decimal128
                                             or fb.type.is_integer):
                    ba = _rescale_dec128(ba, fb.type, f.type)
                elif fb.type.is_decimal128:
                    raise ValueError(
                        f"column {name!r}: {fb.type!r} values do not fit "
                        f"{f.type!r}")
                elif f.type.is_decimal and fb.type.is_decimal:
                    diff = f.type.scale - fb.type.scale
                    ba = ba * (10 ** diff) if diff >= 0 else ba // (10 ** -diff)
                elif f.type.is_decimal and fb.type.is_float:
                    ba = np.round(ba * 10 ** f.type.scale).astype(np.int64)
                else:
                    ba = ba.astype(f.type.np_dtype)
            fields.append(Field(name, f.type, f.nullable, None))
        arrays[name] = np.concatenate([aa, ba]).astype(f.type.np_dtype)
        va = a.valids.get(name)
        vb = b.valids.get(bname)
        if va is not None or vb is not None:
            va = va if va is not None else np.ones(len(aa), dtype=np.bool_)
            vb = vb if vb is not None else np.ones(len(ba), dtype=np.bool_)
            valids[name] = np.concatenate([va, vb])
    return HostTable(Schema(tuple(fields)), arrays, valids)


def _align_arrays(fa: Field, fb: Field, aa: np.ndarray, ba: np.ndarray):
    """Two [n, K+1] array columns width-aligned, their string elements
    remapped through one merged dictionary: (aa, ba, dictionary)."""
    dct = None
    if fa.type.elem.is_string:
        da = fa.dict or StringDict.from_values([])
        db = fb.dict or StringDict.from_values([])
        dct, ra, rb = da.merge(db)

        def remap(m, lut, dlen):
            if not len(m) or not dlen:
                return m  # no rows / all-empty arrays: codes unused
            body = lut[np.clip(m[:, 1:], 0, dlen - 1)]
            body = np.where(np.arange(m.shape[1] - 1)[None, :] < m[:, :1],
                            body, 0)
            return np.concatenate([m[:, :1], body], axis=1)

        aa = remap(aa, ra, len(da))
        ba = remap(ba, rb, len(db))
    k = max(aa.shape[1], ba.shape[1])

    def widen(m):
        if m.shape[1] < k:
            pad = np.zeros((len(m), k - m.shape[1]), m.dtype)
            m = np.concatenate([m, pad], axis=1)
        return m

    return widen(aa), widen(ba), dct


def _conform_to_schema(schema: Schema, data: HostTable) -> HostTable:
    """Coerce `data` (positionally name-matched) onto the declared schema."""
    return concat_tables(_empty_table(schema), data, target_schema=schema)
