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
ALTER TABLE ADD/DROP COLUMN, EXPLAIN ANALYZE, and the statements of the
serving, security and observability planes: users and GRANT/REVOKE/SHOW
GRANTS (runtime/auth.py), resource groups and SET resource_group
(runtime/workgroup.py), KILL QUERY, SHOW PROCESSLIST/WORKLOAD/PROFILE,
ADMIN SET FAILPOINT/ALERT and ADMIN DIAGNOSE, and the ingest plane:
CREATE EXTERNAL TABLE over parquet/ORC files (storage/external.py, read
without pyarrow), `load_csv` (storage/formats/csv.py), the stream-load and
routine-load plane (`ingest_plane()`, ingest/) and ADMIN SET ingest_job;
each returns what the reference's returns.

Every top-level statement runs inside a query lifecycle scope
(runtime/lifecycle.py): it is registered for KILL QUERY and SHOW
PROCESSLIST, carries the `query_timeout_s` deadline, feeds the memory
accountant, passes resource-group admission, and leaves one query-log row
and one audit record on every exit path. Nested statements ride the outer
scope.

A Session runs on the card unless the caller asks for the CPU:
`Session(catalog)` and `Session(data_dir=...)` put their tensors on `cuda`
and raise where there is none; `device="cpu"` runs every operator (and
every kernel's plain torch version) on the CPU. With `dist_shards=n` on
`cuda`, the shards spread over every visible card; on `cuda:1` they stay
on that card. A Session built over a
shared DeviceCache (`cache=`, the serving tier's per-connection sessions)
runs on that cache's device. With a `data_dir`, tables
persist in a TabletStore (storage/store.py) and a new Session over the same
directory rebuilds the catalog from the manifests and the journal.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import replace as dataclasses_replace

import numpy as np
import torch

from .. import lockdep
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
from . import lifecycle
from .config import config
from .profile import RuntimeProfile
from .udf import create_udf, drop_udf
from .executor import (
    DeviceCache, Executor, QueryResult, _extract_group_concat,
    group_concat_main_plan,
)

# serializes query-log append/trim across connection sessions sharing one
# catalog (runtime/serving.py runs statements on many threads); the log is
# the only catalog field mutated by CONCURRENT read statements — schema
# maps mutate only under the serving tier's exclusive statement gate
_QLOG_LOCK = lockdep.lock("session._qlog_lock")


def _reject_external(handle):
    from ..storage.external import ExternalTableHandle

    if isinstance(handle, ExternalTableHandle):
        raise ValueError(
            f"table {handle.name!r} is EXTERNAL (read-only: the files "
            "belong to another system)")


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
                 data_dir: str | None = None, dist_shards: int | None = None,
                 cache: DeviceCache | None = None, store=None):
        if cache is not None and device is None:
            device = cache.device
        self.device = _resolve_device(device)
        self.catalog = catalog or Catalog()
        # `cache`/`store` let the serving tier (runtime/serving.py) hand
        # every connection session ONE shared DeviceCache + TabletStore:
        # device columns, program buckets and the query cache then serve
        # all connections, and the store's replay ran exactly once (in the
        # tier's template session)
        if cache is not None and cache.device != self.device:
            raise ValueError(f"cache on {cache.device}, session on "
                             f"{self.device}")
        self.cache = cache or DeviceCache(self.device)
        self.last_profile = None  # most recent query's RuntimeProfile
        self.store = store
        self.current_user = "root"  # front doors set this per connection
        self.resource_group = None  # SET resource_group = '...'
        # dist_shards=n: queries run over an n-shard mesh
        # (runtime/dist_executor.py), sharing this Session's DeviceCache:
        # on a bare `cuda` its shards spread over the visible cards
        # (parallel/mesh.shard_devices), on `cuda:<i>` or the CPU they
        # share that device
        self.dist_shards = dist_shards
        self._dist_executor = None
        self._in_sql = False
        self._last_parse = None
        if store is None and data_dir is not None:
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
            self._replay_external_defs()
            self._restore_catalog_meta()
            # storage-level mutations that bypass session DML (an explicit
            # compact_table) advance the catalog's data epoch too
            self.store.add_listener(
                lambda t, op: self.catalog.bump_data_epoch(t))
        if self.store is not None:
            # the plan-feedback journal lives beside the manifests, so
            # learned capacities and hot keys survive a restart; attach()
            # is idempotent for the serving tier's shared cache
            self.cache.feedback.attach(
                os.path.join(self.store.root, "plan_feedback.json"))
        # data-epoch bumps invalidate this session's device cache (DML paths
        # also call cache.invalidate directly — idempotent; the listener
        # covers epochs advanced by other sessions on a shared catalog and
        # by the store listener above)
        self.catalog.add_invalidation_listener(self.cache.invalidate)

    def checkpoint_metadata(self) -> int | None:
        """Snapshot catalog-level metadata (views, MV definitions, users +
        grants, resource groups) into the store's image and truncate the
        edit log. Table state is NOT in the image: manifests are
        authoritative for it."""
        if self.store is None:
            return None
        a = self.catalog.auth
        auth = None
        if a is not None:
            auth = {
                "users": {u: h.hex() for u, h in a.users.items()},
                "grants": {u: {t: sorted(p) for t, p in g.items()}
                           for u, g in a.grants.items()},
            }
        wm = self.catalog.workgroups
        from ..storage.external import ExternalTableHandle

        img = {"views": dict(self.catalog.views),
               "mv_defs": dict(self.catalog.mv_defs),
               "auth": auth,
               "resource_groups": (
                   {n: g.to_props() for n, g in wm.groups.items()}
                   if wm is not None else {}),
               # external-table defs live in the image too (the sidecar
               # external_tables.json stays as a redundant copy), so a
               # restored catalog holds the handles a live one holds
               "external_tables": {
                   n: h.location for n, h in self.catalog.tables.items()
                   if isinstance(h, ExternalTableHandle)}}
        ip = getattr(self.catalog, "ingest_plane", None)
        if ip is not None:
            # the txn-label ledger + routine-load jobs/offsets ride the
            # image, so exactly-once replay detection and job progress
            # survive restarts (ingest/labels.py, ingest/poller.py)
            img["ingest"] = ip.image()
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
        auth_img = cat.get("auth")
        if auth_img:
            a = self.auth()
            a.users = {u: bytes.fromhex(h)
                       for u, h in auth_img["users"].items()}
            a.grants = {u: {t: set(p) for t, p in g.items()}
                        for u, g in auth_img["grants"].items()}
        for name, props in cat.get("resource_groups", {}).items():
            from .workgroup import ResourceGroup

            self.workgroups().groups[name] = ResourceGroup.from_props(props)
        from ..storage.external import ExternalTableHandle

        for name, location in cat.get("external_tables", {}).items():
            if self.catalog.get_table(name) is not None:
                continue  # sidecar replay already registered it
            try:
                self.catalog.register_handle(
                    ExternalTableHandle(name, location))
            except ValueError:
                pass  # files vanished; the definition stays until DROP
        if cat.get("ingest"):
            self.ingest_plane().restore_image(cat["ingest"])
        for op in self.store.replay(after_seq=base):
            k = op["op"]
            if k == "create_rg":
                self.workgroups().create(op["name"], op["props"],
                                         replace=True)
            elif k == "drop_rg":
                self.workgroups().drop(op["name"], if_exists=True)
            elif k == "create_user":
                a = self.auth()
                a.users[op["user"]] = bytes.fromhex(op["hash"])
                a.grants.setdefault(op["user"], {})
            elif k == "drop_user":
                self.auth().drop_user(op["user"])
            elif k == "grant":
                self.auth().grant(op["user"], op["table"], op["privs"])
            elif k == "revoke":
                self.auth().revoke(op["user"], op["table"], op["privs"])
            elif k == "create_view":
                self.catalog.views[op["name"]] = op["text"]
            elif k == "drop_view":
                self.catalog.views.pop(op["name"], None)
            elif k == "create_mv":
                mv_defs[op["name"]] = op["text"]
            elif k == "drop_mv":
                mv_defs.pop(op["name"], None)
            elif k == "create_external":
                if self.catalog.get_table(op["name"]) is None:
                    try:
                        self.catalog.register_handle(
                            ExternalTableHandle(op["name"], op["location"]))
                    except ValueError:
                        pass
            elif k == "drop_external":
                self.catalog.drop(op["name"], if_exists=True)
            elif k == "ingest_label":
                # micro-batch commit receipts (exactly-once replay state)
                self.ingest_plane().labels.restore(op["labels"])
            elif k == "ingest_job":
                self.ingest_plane().poller.restore_job(op["name"],
                                                       op["spec"])
            elif k == "drop_ingest_job":
                self.ingest_plane().poller.drop_job(op["name"])
            elif k == "ingest_offset":
                self.ingest_plane().poller.restore_offset(
                    op["name"], op["file"], op["offset"])
        for n, text in mv_defs.items():
            self.catalog.mv_defs[n] = text
            try:
                self._refresh_mv(n)
            except Exception:  # noqa: BLE001
                # defining query no longer runs (e.g. base table dropped
                # without dropping the MV): keep the definition visible and
                # unmaterialized; queries against it fail with the real error
                pass
        ip = getattr(self.catalog, "ingest_plane", None)
        if ip is not None:
            # restored routine-load jobs resume from their persisted
            # offsets; a no-op when no jobs survived (zero threads)
            ip.poller.ensure_started()
        self.store.ensure_seq()

    def _log_meta(self, op: dict):
        """Journal a catalog-level op (no-op without a persistent store)."""
        if self.store is not None:
            self.store.log(op)

    def _external_defs_path(self):
        return (os.path.join(self.store.root, "external_tables.json")
                if self.store is not None else None)

    def _save_external_defs(self, add=None, remove=None):
        """External-table definitions survive restarts next to the store's
        manifests (the FE edit-log analog for connector metadata)."""
        from .failpoint import fail_point

        fail_point("session::external_defs")  # before the read-modify-
        #   write: an injected fault surfaces as a DDL error with the
        #   sidecar file untouched (the live catalog keeps the handle;
        #   only restart durability is degraded)
        import json as _json

        path = self._external_defs_path()
        if path is None:
            return
        defs = {}
        if os.path.exists(path):
            with open(path) as f:
                defs = _json.load(f)
        if add:
            defs.update(add)
        if remove:
            defs.pop(remove, None)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:  # atomic: the store's manifest pattern
            _json.dump(defs, f)
        os.replace(tmp, path)

    def _replay_external_defs(self):
        import json as _json

        path = self._external_defs_path()
        if path is None or not os.path.exists(path):
            return
        from ..storage.external import ExternalTableHandle

        try:
            with open(path) as f:
                defs = _json.load(f)
        except (OSError, _json.JSONDecodeError):
            return  # torn write must not brick the whole store
        for name, location in defs.items():
            try:
                self.catalog.register_handle(
                    ExternalTableHandle(name, location))
            except ValueError:
                pass  # files vanished; the definition stays until DROP

    def load_csv(self, table: str, path: str, **csv_opts) -> int:
        """Stream-load a CSV file into a table (reference: stream load path,
        http/action/stream_load.h:59 -> DeltaWriter). The reference's C++
        lane takes a plain file; quoted files and reader options take the
        port's RFC 4180 lane where the reference calls pyarrow
        (storage/formats/csv.py)."""
        from ..storage.formats.csv import read_csv
        from .metrics import ROWS_LOADED

        handle = self.catalog.get_table(table)
        if handle is None:
            raise ValueError(f"unknown table {table}")
        _reject_external(handle)
        incoming = read_csv(handle.schema, path, **csv_opts)
        ROWS_LOADED.inc(incoming.num_rows)
        return self._append(handle, incoming)

    def ingest_plane(self):
        """The catalog-wide continuous ingest plane (HTTP stream load +
        routine-load poller; ingest/plane.py). Lazily created like
        workgroups; its commit session is a dedicated sibling sharing
        this session's catalog/cache/store, so poller commits ride the
        same PK delta-write path, cache invalidation, and data epochs —
        the ingest package itself never imports Session."""
        from ..ingest import IngestPlane

        if getattr(self.catalog, "ingest_plane", None) is None:
            self.catalog.ingest_plane = IngestPlane()
        plane = self.catalog.ingest_plane
        if plane.gate is None:
            # under a serving tier, commits take the tier's per-table
            # exclusive gate side; bare sessions have no gate (the store
            # serializes, matching direct-session DML semantics)
            plane.gate = getattr(self.catalog, "serve_gate", None)
        if plane.commit_session is None:
            plane.commit_session = Session(
                catalog=self.catalog, cache=self.cache,
                store=self.store, dist_shards=self.dist_shards)
        return plane

    def sql(self, text: str):
        """Execute one statement. Top-level calls run inside a query
        lifecycle scope (runtime/lifecycle.py) — registered for KILL QUERY
        and SHOW PROCESSLIST, deadline-armed, memory-accounted — and append
        to the catalog's query log (information_schema.query_log). Nested
        internal statements (MV refresh bodies, INSERT..SELECT subqueries)
        ride the outer scope and don't double-log. After a top-level
        statement, once the journal tail outgrows CHECKPOINT_OPS, catalog
        metadata is snapshotted and the log truncated (the FE
        CheckpointController analog, leader/CheckpointController.java:85)."""
        if self._in_sql:
            return self._sql_inner(text)
        import time as _time

        group_limit = 0
        if self.resource_group:
            g = self.workgroups().get(self.resource_group)
            if g is not None:
                group_limit = g.mem_limit_bytes
        self._in_sql = True
        t0 = _time.time()
        entry = {"user": self.current_user, "sql": text.strip(),
                 "state": "OK", "rows": 0, "ms": 0,
                 "query_id": 0, "queue_wait_ms": 0, "slow": 0}
        qctx = None
        try:
            with lifecycle.query_scope(text.strip(), user=self.current_user,
                                       group=self.resource_group,
                                       group_limit=group_limit) as qctx:
                res = self._sql_inner(text)
            if isinstance(res, QueryResult):
                entry["rows"] = res.table.num_rows
            elif isinstance(res, int):
                entry["rows"] = res
            return res
        except Exception:
            entry["state"] = "ERR"
            raise
        finally:
            self._in_sql = False
            entry["ms"] = int((_time.time() - t0) * 1000)
            if qctx is not None:
                # joinable against information_schema.query_profiles: the
                # audit row carries the lifecycle qid + admission wait
                entry["query_id"] = qctx.qid
                entry["queue_wait_ms"] = int(qctx.queue_wait_ms)
            slow_ms = int(config.get("slow_query_ms") or 0)
            entry["slow"] = int(bool(slow_ms and entry["ms"] >= slow_ms))
            log = self.catalog.query_log
            with _QLOG_LOCK:
                log.append(entry)
                if len(log) > 10_000:
                    del log[:5000]
            if (self.store is not None
                    and (self.store.tail_count or 0) >= self.CHECKPOINT_OPS):
                try:
                    self.checkpoint_metadata()
                except OSError:
                    pass  # disk hiccup: keep serving; next statement retries

    def _sql_inner(self, text: str):
        # short-circuit point lane: `WHERE pk = ?` shapes on stored PK
        # tables answer from the primary index — no parse cache, no
        # optimizer, no device (runtime/point.py). Detection is
        # conservative: MISS falls through to the identical full path.
        text_key = text.strip().rstrip(";")
        if config.get("enable_short_circuit"):
            from . import point

            res = point.try_execute(self, text_key)
            if res is not point.MISS:
                return res
        # prepared-statement fast path: statement text -> analyzed plan
        # (cache/plan_cache.py); only SELECT plans are stored, so other
        # statements always miss. Privileges re-check per execution on the
        # plan (_check_select_privs).
        if config.get("enable_plan_cache"):
            hit = self.cache.plan_cache.lookup(text_key, self.catalog)
            if hit is not None:
                return self._query_planned(hit, from_plan_cache=True)
        import time as _time

        _pw0, _pt0 = _time.time(), _time.perf_counter()
        stmt = parse(text)
        # parse happens before any profile exists; _query attaches this
        # measurement so the trace export covers parse -> ... -> fetch
        self._last_parse = (_pw0, _time.perf_counter() - _pt0)
        self._enforce_privileges(stmt)
        _ctx = lifecycle.current()
        if _ctx is not None and isinstance(getattr(stmt, "table", None), str):
            # DML/DDL target table into the audit row's referenced set
            # (SELECT plans contribute theirs in _query_planned)
            _ctx.tables = tuple(sorted(
                set(_ctx.tables) | {stmt.table.lower()}))
        if isinstance(stmt, ast.CreateExternalTable):
            return self._create_external(stmt)
        if isinstance(stmt, ast.AdminSetIngestJob):
            # routine-load CRUD: `ADMIN SET ingest_job 'name' = '<json
            # spec>'` creates/replaces, `= 'drop'` drops (the CREATE/
            # PAUSE/DROP ROUTINE LOAD analog; specs journal + image)
            return self.ingest_plane().admin_set_job(self, stmt.name,
                                                     stmt.value)
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt)
        if isinstance(stmt, (ast.Select, ast.SetOp)):
            return self._query(stmt, cache_text=text_key)
        if isinstance(stmt, (ast.CreateUser, ast.DropUser, ast.Grant,
                             ast.Revoke, ast.ShowGrants)):
            return self._auth_stmt(stmt)
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
                name = str(stmt.value or "").lower()
                if name and self.workgroups().get(name) is None:
                    raise ValueError(f"unknown resource group {name!r}")
                self.resource_group = name or None
                return None
            config.set(stmt.name, stmt.value)
            return None
        if isinstance(stmt, ast.CreateResourceGroup):
            self.workgroups().create(stmt.name, dict(stmt.props),
                                     replace=stmt.replace)
            self._log_meta({"op": "create_rg", "name": stmt.name.lower(),
                            "props": dict(stmt.props)})
            return None
        if isinstance(stmt, ast.DropResourceGroup):
            self.workgroups().drop(stmt.name, stmt.if_exists)
            self._log_meta({"op": "drop_rg", "name": stmt.name.lower()})
            return None
        if isinstance(stmt, ast.ShowResourceGroups):
            return self.workgroups().snapshot()
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
        if isinstance(stmt, ast.KillQuery):
            a = self.auth()
            ok = lifecycle.REGISTRY.cancel(
                stmt.query_id, requester=self.current_user,
                admin=a.is_admin(self.current_user))
            return (f"query {stmt.query_id} cancel delivered (cooperative: "
                    "takes effect at the next stage boundary)" if ok else
                    f"query {stmt.query_id} is not running; "
                    "KILL is a no-op")
        if isinstance(stmt, ast.ShowProcesslist):
            return lifecycle.REGISTRY.snapshot()
        if isinstance(stmt, ast.ShowWorkload):
            from .workload import WORKLOAD

            # heaviest shapes first, tuple rows in the
            # information_schema.workload_summary column order
            return [tuple(r.values()) for r in WORKLOAD.snapshot()]
        if isinstance(stmt, ast.AdminSetFailpoint):
            from . import failpoint

            failpoint.set_from_sql(stmt.name, stmt.value)
            return None
        if isinstance(stmt, ast.AdminSetAlert):
            from .alerts import ALERTS

            ALERTS.set_from_sql(stmt.name, stmt.value)
            return None
        if isinstance(stmt, ast.AdminDiagnose):
            import json as _json

            from .audit import diagnostic_bundle

            # one parseable JSON document — the flight-recorder dump
            return _json.dumps(diagnostic_bundle(self), default=str)
        if isinstance(stmt, ast.ShowProfile):
            # SHOW PROFILE [FOR QUERY <id>]: the last query's RuntimeProfile
            # tree, or a retained profile from the ProfileManager
            if stmt.query_id is not None:
                from .profile import PROFILE_MANAGER

                e = PROFILE_MANAGER.get(stmt.query_id)
                if e is None:
                    return (f"no profile retained for query "
                            f"{stmt.query_id}")
                return (f"query {e['query_id']} [{e['state']}] "
                        f"{e['ms']}ms stage={e['stage']}\n{e['text']}")
            return (self.last_profile.render()
                    if self.last_profile is not None else "no queries yet")
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
        from ..storage.external import ExternalTableHandle

        was_external = isinstance(self.catalog.get_table(nm),
                                  ExternalTableHandle)
        existed = self.catalog.get_table(stmt.name) is not None
        self.catalog.drop(stmt.name, stmt.if_exists)
        self.cache.invalidate(nm)
        self.catalog.bump_version(nm)
        if was_external:
            self._save_external_defs(remove=nm)
            self._log_meta({"op": "drop_external", "name": nm})
        elif self.store is not None and existed:
            self.store.drop_table(nm)
        return None

    def _create_external(self, stmt: ast.CreateExternalTable):
        from ..storage.external import ExternalTableHandle

        name = stmt.name.lower()
        if self.catalog.get_table(name) is not None \
                or name in self.catalog.views:
            raise ValueError(f"name {name!r} already exists")
        self.catalog.register_handle(ExternalTableHandle(name, stmt.location))
        self._save_external_defs(add={name: stmt.location})
        # journaled like native DDL so image+tail replay agrees with the
        # sidecar, and the data epoch moves so any cached result under a
        # same-named earlier definition drops
        self._log_meta({"op": "create_external", "name": name,
                        "location": stmt.location})
        self.catalog.bump_data_epoch(name)
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
        _reject_external(handle)
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

    # --- auth and admission --------------------------------------------------
    def auth(self):
        from .auth import AuthManager

        if self.catalog.auth is None:
            self.catalog.auth = AuthManager()
        return self.catalog.auth

    def workgroups(self):
        """The catalog-wide admission manager (sessions sharing a catalog
        share slots — the process is the BE; runtime/workgroup.py)."""
        from .workgroup import WorkgroupManager

        if self.catalog.workgroups is None:
            self.catalog.workgroups = WorkgroupManager()
        return self.catalog.workgroups

    def _enforce_privileges(self, stmt):
        """Statement-level checks (reference: authorization/Authorizer.java
        checks in StmtExecutor). SELECT privileges are checked per base
        table on the analyzed plan in _query_planned."""
        a = self.auth()
        user = self.current_user
        if a.is_admin(user):
            return
        if isinstance(stmt, ast.Insert):
            a.require(user, stmt.table, "insert")
        elif isinstance(stmt, ast.Delete):
            a.require(user, stmt.table, "delete")
        elif isinstance(stmt, ast.Update):
            a.require(user, stmt.table, "update")
        elif isinstance(stmt, (ast.CreateTable, ast.DropTable,
                               ast.CreateView, ast.RefreshView,
                               ast.CreateUser, ast.DropUser, ast.Grant,
                               ast.Revoke, ast.AlterTable,
                               ast.CreateFunction, ast.DropFunction,
                               ast.CreateExternalTable,
                               ast.CreateResourceGroup,
                               ast.DropResourceGroup,
                               ast.AdminSetFailpoint,
                               ast.AdminSetAlert,
                               ast.AdminSetIngestJob,
                               ast.AdminDiagnose)):
            raise PermissionError(
                f"user {user!r} lacks the admin privileges for DDL")

    def _check_select_privs(self, plan):
        a = self.auth()
        user = self.current_user
        if a.is_admin(user):
            return
        from ..exprs.ir import Expr, walk as walk_expr
        from ..sql.analyzer import ScalarSubquery, SemiJoinMark
        from ..sql.logical import LScan, walk_plan

        def visit(p):
            for node in walk_plan(p):
                if isinstance(node, LScan) and not node.table.startswith("__"):
                    # internal relations (__dual__, information_schema) are
                    # world-readable, like the reference's system schemata
                    a.require(user, node.table, "select")
                # analyzed subquery markers carry their OWN plans inside
                # expressions — a table read only by `IN (SELECT ...)` must
                # be checked too
                for attr in getattr(node, "__dataclass_fields__", {}):
                    val = getattr(node, attr)
                    exprs = []
                    if isinstance(val, Expr):
                        exprs = [val]
                    elif isinstance(val, tuple):
                        exprs = [x for item in val
                                 for x in (item if isinstance(item, tuple)
                                           else (item,))
                                 if isinstance(x, Expr)]
                    for e in exprs:
                        for sub in walk_expr(e):
                            if isinstance(sub, (ScalarSubquery,
                                                SemiJoinMark)):
                                visit(sub.plan)

        visit(plan)

    def _auth_stmt(self, stmt):
        a = self.auth()
        if isinstance(stmt, ast.CreateUser):
            a.create_user(stmt.user, stmt.password)
            # journal the stage2 hash, never the password (the mysql
            # protocol only needs sha1(sha1(pw)) to authenticate)
            self._log_meta({"op": "create_user", "user": stmt.user,
                            "hash": a.users[stmt.user].hex()})
            return None
        if isinstance(stmt, ast.DropUser):
            a.drop_user(stmt.user)
            self._log_meta({"op": "drop_user", "user": stmt.user})
            return None
        if isinstance(stmt, ast.Grant):
            a.grant(stmt.user, stmt.table, stmt.privs)
            self._log_meta({"op": "grant", "user": stmt.user,
                            "table": stmt.table,
                            "privs": sorted(stmt.privs)})
            return None
        if isinstance(stmt, ast.Revoke):
            a.revoke(stmt.user, stmt.table, stmt.privs)
            self._log_meta({"op": "revoke", "user": stmt.user,
                            "table": stmt.table,
                            "privs": sorted(stmt.privs)})
            return None
        user = stmt.user or self.current_user
        if user != self.current_user and not a.is_admin(self.current_user):
            raise PermissionError("SHOW GRANTS for other users requires admin")
        return a.show_grants(user)

    # --- SELECT / EXPLAIN ------------------------------------------------------
    def _query(self, sel, cache_text: str | None = None) -> QueryResult:
        profile = RuntimeProfile("query")
        lp = self._last_parse
        if lp is not None:
            self._last_parse = None
            profile.add_counter("parse", lp[1], "s")
            profile.spans.append(("parse", lp[0], lp[1]))
        with profile.timer("analyze"):
            plan = Analyzer(self.catalog).analyze(sel)
        if cache_text is not None and config.get("enable_plan_cache"):
            # only top-level statement texts store (internal plans — view
            # expansions, MV refresh bodies — have no client-visible text)
            self.cache.plan_cache.store(cache_text, plan, self.catalog)
        return self._query_planned(plan, profile=profile)

    def _query_planned(self, plan, profile=None,
                       from_plan_cache: bool = False) -> QueryResult:
        """Execute an already-analyzed plan (the plan cache's hits enter
        here, skipping parse and analysis)."""
        if profile is None:
            profile = RuntimeProfile("query")
        if from_plan_cache:
            profile.add_counter("plan_cache_hits", 1)
        ctx = lifecycle.current()
        if ctx is not None:
            # retained on every exit path by the scope's unwind — a killed
            # query's profile reports the stage it died at
            ctx.profile = profile
            from ..sql.logical import LScan, walk_plan

            # referenced-table union for the audit row; UNIONED (not
            # replaced) so INSERT..SELECT's nested select adds to the
            # outer statement's set instead of clobbering it
            refs = {n.table for n in walk_plan(plan)
                    if isinstance(n, LScan)
                    and not n.table.startswith("__")}
            if refs:
                ctx.tables = tuple(sorted(set(ctx.tables) | refs))
        self._check_select_privs(plan)
        lifecycle.checkpoint("session::analyzed")
        # admission() releases the slot on ANY exit path — including a KILL
        # unwinding the lifecycle scope before this frame's finally runs
        with self._admit(plan):
            return self._query_admitted(plan, profile)

    def _admit(self, plan):
        """Resource-group admission (runtime/workgroup.py): estimate the
        query's scan mass from the catalog and pass the gate. Queries
        without a SET resource_group run unthrottled (default group) —
        unless a global admission queue is configured
        (`SET query_queue_concurrency`), which gates every statement.
        Returns a context manager whose exit releases the slot on any
        path (exception-safe; also registered on the query context)."""
        from . import workgroup as _wg  # noqa: F401 — defines queue knobs

        if self.resource_group is None \
                and not config.get("query_queue_concurrency"):
            import contextlib

            return contextlib.nullcontext()
        from ..sql.logical import LScan, walk_plan

        est_rows = est_bytes = 0
        for node in walk_plan(plan):
            if isinstance(node, LScan) and not node.table.startswith("__"):
                h = self.catalog.get_table(node.table)
                if h is not None:
                    est_rows += h.row_count
                    est_bytes += h.row_count * 8 * max(len(node.columns), 1)
        return self.workgroups().admission(self.resource_group, est_rows,
                                           est_bytes)

    def _query_admitted(self, plan, profile) -> QueryResult:
        res = self._executor().execute_logical(plan, profile)
        self.last_profile = res.profile
        ctx = lifecycle.current()
        if ctx is not None:
            ctx.rows = res.table.num_rows
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
            from .profile import render_explain_analyze

            res = self._query(stmt.stmt)
            # res.plan is the executed optimized plan; each node annotates
            # with est-vs-observed rows + its counter group via the
            # profile's node-ordinal table
            return render_explain_analyze(res.plan, res.profile,
                                          self.catalog)
        plan = Analyzer(self.catalog).analyze(stmt.stmt)
        self._check_select_privs(plan)  # EXPLAIN leaks schema/stats otherwise
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
        _reject_external(handle)
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
