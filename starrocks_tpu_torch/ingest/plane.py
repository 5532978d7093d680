"""Continuous ingest plane: stream-load staging + transactional
micro-batch commit, live under serving traffic.

Reference behavior: the BE's stream-load runtime (`PUT /api/{db}/{tbl}/
_stream_load` -> StreamLoadOrchestrator -> DeltaWriter/MemTable ->
txn-labelled rowset commit; storage/delta_writer.h, runtime/
stream_load/) plus the FE's txn label index. The shape here:

- **Stage**: a load request's rows land in a per-table MemTable-style
  staging buffer (list-of-dict rows + byte accounting). Staging takes
  NO statement-gate claim — concurrent analytic reads of the same table
  flow freely past it.

- **Group micro-batch commit**: staged requests fold into ONE commit
  onto the existing PK delta-write path (`Session._append` ->
  `TabletStore.upsert`: rowset + delete vectors + incremental PK index)
  under a size/age policy (`ingest_batch_rows` / `ingest_batch_age_ms`).
  Whichever staged request crosses the policy becomes the committer;
  the others wait on the plane condition and wake with the shared
  commit receipt. Only the commit critical section holds the statement
  gate's per-table EXCLUSIVE side, so readers of the ingested table
  stall for the append only — and readers of every other table never
  stall at all (plan-footprint readers, runtime/serving.py).

- **Exactly-once txn labels**: each load carries a label (client-chosen
  or auto). A committed label replays as a durable no-op returning the
  ORIGINAL receipt (ingest/labels.py); the label ledger journals through
  the catalog edit-log/image machinery, so replay detection survives
  restarts. A commit that faults AFTER the append but BEFORE the label
  journal write leaves the label unrecorded; the client's retry
  re-upserts the same keyed rows — idempotent on the PK delta path, so
  at-least-once folds to exactly-once.

- **Lifecycle**: every load runs inside its own `lifecycle.query_scope`
  (killable, deadline-armed, memory-accounted, exactly one audit record
  per load with stmt_class='load'); the batch commit runs inside the
  committer's scope and checkpoints before the append.

- **Backpressure**: staged bytes are budgeted (`ingest_staging_limit_
  bytes`, plus the MemoryAccountant's process headroom when a process
  limit is set). Over budget -> `IngestBackpressure` (HTTP 429) + an
  `ingest_backpressure` event; nothing is staged.

- **Small-segment hygiene**: micro-batching at 100 commits/min would
  bloat manifests; after `ingest_compact_commits` commits (or
  `ingest_compact_bytes` bytes) on one table the plane triggers the
  existing compaction path (`TabletStore.compact_table`) inside the
  same exclusive section.

The plane is catalog-attached (sessions sharing a catalog share one
plane, like workgroups/auth) and receives Session/store objects BY
REFERENCE — this package never imports the runtime session/executor
(module_boundary_manifest.json pins that).
"""

from __future__ import annotations

import contextlib
import json
import time

from .. import lockdep
from ..column import HostTable
from ..runtime import events
from ..runtime.config import config
from ..runtime.failpoint import fail_point
from ..runtime.metrics import metrics
from .labels import LabelRegistry

config.define("enable_ingest_plane", True, True,
              "continuous ingest plane (HTTP stream load + routine-load "
              "poller). Off: load endpoints reject, the poller idles, and "
              "every existing statement path is untouched; the plane "
              "starts ZERO background threads until a routine-load job "
              "exists regardless")
config.define("ingest_batch_rows", 4096, True,
              "micro-batch commit threshold: a table's staged ingest rows "
              "commit once they reach this count (the MemTable flush-size "
              "analog)")
config.define("ingest_batch_age_ms", 200, True,
              "micro-batch commit deadline: staged ingest rows commit "
              "once the oldest staged request is this old, bounding "
              "commit->visible freshness under trickle traffic")
config.define("ingest_staging_limit_bytes", 64 << 20, True,
              "total staged (uncommitted) ingest bytes across tables "
              "before new loads are rejected with backpressure (HTTP 429 "
              "+ ingest_backpressure event)")
config.define("ingest_compact_commits", 32, True,
              "trigger the existing compaction path on a table after this "
              "many ingest micro-batch commits since its last trigger "
              "(manifest hygiene under 100-commits/min micro-batching)")
config.define("ingest_compact_bytes", 64 << 20, True,
              "or after this many ingested bytes since the last trigger, "
              "whichever comes first")

INGEST_LOADS = metrics.counter(
    "sr_tpu_ingest_loads_total", "ingest load requests accepted (staged)")
INGEST_ROWS = metrics.counter(
    "sr_tpu_ingest_rows_total", "rows committed by the ingest plane")
INGEST_COMMITS = metrics.counter(
    "sr_tpu_ingest_commits_total", "ingest micro-batch commits")
INGEST_REPLAYS = metrics.counter(
    "sr_tpu_ingest_label_replays_total",
    "loads answered from the txn-label ledger (exactly-once no-ops)")
INGEST_BACKPRESSURE = metrics.counter(
    "sr_tpu_ingest_backpressure_total",
    "loads rejected because staging exceeded its byte budget")
INGEST_ERRORS = metrics.counter(
    "sr_tpu_ingest_errors_total", "loads that failed (stage or commit)")
INGEST_FRESHNESS_MS = metrics.histogram(
    "sr_tpu_ingest_freshness_ms",
    "per-load commit->visible freshness: milliseconds from a request's "
    "rows entering staging to their micro-batch commit becoming visible")
INGEST_COMMIT_MS = metrics.histogram(
    "sr_tpu_ingest_commit_ms",
    "wall milliseconds of the micro-batch commit critical section "
    "(gate-exclusive append + label journal)")


class IngestError(RuntimeError):
    """Base of the ingest plane's typed errors."""


class IngestBackpressure(IngestError):
    """Staging over budget: the load was rejected before staging anything
    (HTTP maps this to 429; the client retries with the SAME label)."""


class _Entry:
    """One staged load request awaiting its micro-batch commit."""

    __slots__ = ("label", "rows", "nbytes", "ts", "receipt", "error",
                 "done")

    def __init__(self, label, rows, nbytes, ts):
        self.label = label
        self.rows = rows
        self.nbytes = nbytes
        self.ts = ts
        self.receipt = None
        self.error = None
        self.done = False


class _Buffer:
    """Per-table staging state (all fields guarded by the plane cond)."""

    __slots__ = ("entries", "rows", "committing")

    def __init__(self):
        self.entries: list = []   # owned by the plane _cond
        self.rows = 0             # owned by the plane _cond
        self.committing = False   # owned by the plane _cond


def _estimate_bytes(rows) -> int:
    """Cheap per-request staging-size estimate (budget input, not an
    exact accounting — the commit-side HostTable is accounted exactly)."""
    total = 0
    for r in rows:
        total += 48
        for v in r.values():
            total += len(v) + 8 if isinstance(v, str) else 8
    return total


def _coerce(t, raw: str):
    """CSV cell -> python value per the column's logical type ('' and
    \\N are NULL, matching the reference's stream-load CSV defaults)."""
    if raw == "" or raw == "\\N":
        return None
    if t.is_string:
        return raw
    if t.is_float or t.is_decimal:
        return float(raw)
    return int(raw)


def parse_csv(handle, body: str, columns=None, sep: str = ",") -> list:
    """CSV body -> list of row dicts mapped onto `columns` (schema order
    when omitted — the stream-load `columns` header analog)."""
    names = [c.strip().lower() for c in columns] if columns \
        else [f.name for f in handle.schema]
    types = {f.name: f.type for f in handle.schema}
    for c in names:
        if c not in types:
            raise IngestError(f"unknown column {c!r} in column mapping")
        if types[c].is_array:
            raise IngestError(
                f"array column {c!r} requires the json format")
    out = []
    for line in body.splitlines():
        if not line.strip():
            continue
        cells = line.split(sep)
        if len(cells) != len(names):
            raise IngestError(
                f"CSV arity mismatch: {len(cells)} cells vs "
                f"{len(names)} mapped columns in line {line[:80]!r}")
        out.append({c: _coerce(types[c], cell.strip())
                    for c, cell in zip(names, cells)})
    return out


def parse_json(handle, body: str) -> list:
    """JSON body -> row dicts. Accepts a single object, a list of
    objects, {"rows": [...]}, or NDJSON (one object per line)."""
    types = {f.name: f.type for f in handle.schema}
    body = body.strip()
    try:
        doc = json.loads(body)
    except ValueError:
        doc = [json.loads(line) for line in body.splitlines()
               if line.strip()]  # NDJSON
    if isinstance(doc, dict) and "rows" in doc:
        doc = doc["rows"]
    if isinstance(doc, dict):
        doc = [doc]
    if not isinstance(doc, list):
        raise IngestError("json body must be an object, list, or NDJSON")
    out = []
    for r in doc:
        if not isinstance(r, dict):
            raise IngestError("json rows must be objects")
        row = {}
        for k, v in r.items():
            k = k.lower()
            if k not in types:
                raise IngestError(f"unknown column {k!r} in json row")
            row[k] = v
        out.append(row)
    return out


def _rows_to_table(handle, rows) -> HostTable:
    """Staged row dicts -> a schema-shaped HostTable (missing columns
    fill NULL; `Session._append` conforms + validates PK nullability)."""
    cols = {f.name: [r.get(f.name) for r in rows] for f in handle.schema}
    return HostTable.from_pydict(
        cols, types={f.name: f.type for f in handle.schema})


class IngestPlane:
    """Catalog-attached ingest plane: label ledger + per-table staging
    buffers + the group micro-batch committer. One condition guards ALL
    staging state; commits run OUTSIDE it (the gate + store serialize
    same-table commits; the per-buffer `committing` flag keeps batch
    order FIFO per table)."""

    def __init__(self):
        self._cond = lockdep.condition("ingest.IngestPlane._cond")
        self._bufs: dict = {}       # guarded_by: _cond — table -> _Buffer
        self._staged_bytes = 0      # guarded_by: _cond — all tables
        self._commit_seq = 0        # guarded_by: _cond
        self._auto_seq = 0          # guarded_by: _cond — auto-label suffix
        # per-table (commits, bytes) since the last compaction trigger
        self._compact_debt: dict = {}  # guarded_by: _cond
        self.labels = LabelRegistry()
        # set by the serving tier so commits take its per-table exclusive
        # side; None outside a tier (single-session tests — the store
        # serializes)  lint: unguarded-ok — written once at tier attach
        self.gate = None            # lint: unguarded-ok
        # a dedicated sibling session the routine-load poller commits
        # through; created BY the session layer (this package never
        # imports Session)  lint: unguarded-ok — written once at wire-up
        self.commit_session = None  # lint: unguarded-ok
        from .poller import IngestPoller

        self.poller = IngestPoller(self)

    # -- public API ---------------------------------------------------------
    def load(self, session, table: str, rows: list,
             label: str | None = None, user: str = "root") -> dict:
        """One stream-load request: stage -> (group) micro-batch commit ->
        receipt. Runs inside its OWN query_scope: killable while staged,
        audited exactly once, classified 'load'. Raises
        IngestBackpressure over budget; a committed `label` replays as a
        durable no-op returning the original receipt."""
        if not config.get("enable_ingest_plane"):
            raise IngestError(
                "ingest plane is disabled (SET enable_ingest_plane=on)")
        from ..runtime import lifecycle

        tname = table.lower()
        if label is None:
            label = self._auto_label(tname)
        with lifecycle.query_scope(
                f"load into {tname} /* label={label} rows={len(rows)} */",
                user=user) as ctx:
            ctx.stmt_class = "load"
            ctx.tables = (tname,)
            fail_point("ingest::stage")
            prior = self.labels.get(label)
            if prior is not None:
                # exactly-once: a committed label is a durable no-op that
                # answers with the ORIGINAL commit receipt
                INGEST_REPLAYS.inc()
                return dict(prior, replayed=True)
            handle = self._load_target(session, tname)
            self._validate_rows(handle, rows)
            entry = self._stage(tname, label, rows)
            INGEST_LOADS.inc()
            try:
                self._drive(session, tname, entry)
            finally:
                self._unstage_if_pending(tname, entry)
            if entry.error is not None:
                INGEST_ERRORS.inc()
                raise IngestError(
                    f"ingest commit failed for label {label!r}: "
                    f"{entry.error}")
            ctx.rows = len(rows)
            return entry.receipt

    def parse_body(self, session, table: str, body: str,
                   fmt: str = "csv", columns=None, sep: str = ",") -> list:
        """Request body -> row dicts against `table`'s schema (the HTTP
        front door's parse step; raises IngestError on any mismatch
        BEFORE anything stages)."""
        handle = self._load_target(session, table.lower())
        if fmt == "json":
            return parse_json(handle, body)
        return parse_csv(handle, body, columns=columns, sep=sep)

    def stats(self) -> dict:
        with self._cond:
            staged = {t: {"rows": b.rows, "requests": len(b.entries),
                          "committing": b.committing}
                      for t, b in self._bufs.items() if b.entries}
            return {
                "staged_bytes": self._staged_bytes,
                "staged_tables": staged,
                "commits": self._commit_seq,
                "labels": self.labels.stats()["labels"],
                "jobs": self.poller.stats(),
            }

    # -- durability (rides the catalog edit-log/image machinery) ------------
    def image(self) -> dict:
        """Ingest state for the catalog image (Session.checkpoint_
        metadata): the label ledger + routine-load jobs with offsets."""
        return {"labels": self.labels.snapshot(),
                "jobs": self.poller.image()}

    def restore_image(self, img: dict):
        self.labels.restore(img.get("labels", {}))
        self.poller.restore_image(img.get("jobs", {}))

    # -- staging ------------------------------------------------------------
    def _auto_label(self, tname: str) -> str:
        with self._cond:
            self._auto_seq += 1
            n = self._auto_seq
        return f"auto:{tname}:{int(time.time() * 1e6)}:{n}"

    @staticmethod
    def _load_target(session, tname: str):
        if tname in session.catalog.views or \
                tname in session.catalog.mv_defs:
            raise IngestError(f"{tname!r} is a view; loads need a base "
                              "table")
        handle = session.catalog.get_table(tname)
        if handle is None:
            raise IngestError(f"unknown table {tname!r}")
        from ..storage.external import ExternalTableHandle

        if isinstance(handle, ExternalTableHandle):
            raise IngestError(f"{tname!r} is an external table "
                              "(read-only)")
        return handle

    @staticmethod
    def _validate_rows(handle, rows):
        """Stage-side validation so one bad request cannot poison a whole
        micro-batch at commit time: known columns only, PK columns
        present and non-NULL."""
        if not rows:
            raise IngestError("empty load (no rows parsed)")
        names = {f.name for f in handle.schema}
        pk = {k for ks in handle.unique_keys for k in ks}
        for r in rows:
            for c in r:
                if c not in names:
                    raise IngestError(f"unknown column {c!r}")
            for k in pk:
                if r.get(k) is None:
                    raise IngestError(
                        f"NULL value in PRIMARY KEY column {k!r}")

    def _stage(self, tname: str, label: str, rows: list) -> _Entry:
        from ..runtime.lifecycle import ACCOUNTANT

        nbytes = _estimate_bytes(rows)
        limit = int(config.get("ingest_staging_limit_bytes") or 0)
        proc_limit = int(config.get("process_mem_limit_bytes") or 0)
        # the MemoryAccountant's process headroom backs the staging budget:
        # a load that would push the process over its limit backpressures
        # instead of staging toward a MemLimitExceeded at commit
        proc_bytes = (ACCOUNTANT.snapshot()["process_bytes"]
                      if proc_limit else 0)
        over = None
        with self._cond:
            if limit and self._staged_bytes + nbytes > limit:
                over = self._staged_bytes
            elif proc_limit and proc_bytes + nbytes > proc_limit:
                over = self._staged_bytes
            if over is None:
                buf = self._bufs.get(tname)
                if buf is None:
                    buf = self._bufs[tname] = _Buffer()
                entry = _Entry(label, rows, nbytes, time.monotonic())
                buf.entries.append(entry)
                buf.rows += len(rows)
                self._staged_bytes += nbytes
        if over is not None:
            INGEST_BACKPRESSURE.inc()
            events.emit("ingest_backpressure", table=tname,
                        staged_bytes=over, request_bytes=nbytes)
            raise IngestBackpressure(
                f"ingest staging over budget ({over} staged + {nbytes} "
                f"requested); retry with the same label")
        return entry

    def _unstage_if_pending(self, tname: str, entry: _Entry):
        """Unwind path (kill/timeout while waiting): if the entry's batch
        was never detached for commit, drop it so a dead request leaks no
        staged rows or bytes. Once detached, the commit owns it — the
        label lands in the ledger and the client's retry replays."""
        with self._cond:
            buf = self._bufs.get(tname)
            if buf is not None and not entry.done \
                    and entry in buf.entries:
                buf.entries.remove(entry)
                buf.rows -= len(entry.rows)
                self._staged_bytes -= entry.nbytes
                self._cond.notify_all()

    # -- the group micro-batch commit ---------------------------------------
    def _drive(self, session, tname: str, entry: _Entry):
        """Wait until `entry`'s batch commits; whichever staged request
        crosses the size/age policy detaches the batch and commits it for
        the group. Checkpoints every wait slice, so KILL/deadline land
        promptly."""
        from ..runtime import lifecycle

        while True:
            batch = None
            with self._cond:
                if entry.done:
                    break
                buf = self._bufs[tname]
                batch_rows = int(config.get("ingest_batch_rows") or 1)
                age_ms = float(config.get("ingest_batch_age_ms") or 0.0)
                oldest = buf.entries[0].ts if buf.entries else None
                ripe = buf.entries and (
                    buf.rows >= batch_rows
                    or (time.monotonic() - oldest) * 1000.0 >= age_ms)
                if ripe and not buf.committing:
                    buf.committing = True
                    batch = buf.entries
                    buf.entries = []
                    buf.rows = 0
                else:
                    self._cond.wait(timeout=0.02)
                    lifecycle.checkpoint("ingest::wait")
                    continue
            self._commit(session, tname, batch)

    def _commit(self, session, tname: str, batch: list):
        """Commit one detached micro-batch inside the committer's scope:
        gate-exclusive append on the PK delta path + label journal, then
        resolve every waiter with the shared receipt. Any failure fails
        the WHOLE batch atomically (the append is rowset-atomic at the
        store; nothing partial becomes visible) — clients retry by
        label."""
        from ..runtime import lifecycle

        t0 = time.monotonic()
        err = None
        receipt = None
        n = 0
        try:
            lifecycle.checkpoint("ingest::commit")
            fail_point("ingest::commit")
            handle = self._load_target(session, tname)
            rows = [r for e in batch for r in e.rows]
            ht = _rows_to_table(handle, rows)
            lifecycle.account(ht, "ingest::commit")
            gate = self.gate
            gate_side = gate.exclusive(tname) if gate is not None \
                else contextlib.nullcontext()
            with gate_side:
                n = session._append(handle, ht)
                with self._cond:
                    self._commit_seq += 1
                    seq = self._commit_seq
                ts = time.time()
                ms = round((time.monotonic() - t0) * 1000.0, 2)
                receipts = {
                    e.label: {"label": e.label, "table": tname,
                              "rows": len(e.rows), "commit_seq": seq,
                              "batch_rows": n, "ts": ts, "commit_ms": ms}
                    for e in batch}
                fail_point("ingest::label_journal")
                # journal BEFORE the in-memory ledger: if the journal
                # write faults, the label stays unrecorded and the
                # client's retry re-upserts the same keys (idempotent on
                # the PK delta path) — at-least-once folds to exactly-once
                session._log_meta({"op": "ingest_label",
                                   "labels": receipts})
                for label, r in receipts.items():
                    self.labels.record(label, r)
                receipt = receipts
                self._maybe_compact(session, tname, handle, batch)
        except BaseException as e:  # noqa: BLE001 — the batch fails as a
            #   unit; waiters get the error, the committer re-raises below
            err = e
        finally:
            now = time.monotonic()
            with self._cond:
                buf = self._bufs.get(tname)
                if buf is not None:
                    buf.committing = False
                for e in batch:
                    self._staged_bytes -= e.nbytes
                    e.done = True
                    if err is not None:
                        e.error = err
                    else:
                        e.receipt = receipt[e.label]
                self._cond.notify_all()
        if err is not None:
            raise err
        INGEST_COMMITS.inc()
        INGEST_ROWS.inc(n)
        ms = (now - t0) * 1000.0
        INGEST_COMMIT_MS.observe(ms)
        for e in batch:
            INGEST_FRESHNESS_MS.observe((now - e.ts) * 1000.0)
        events.emit("ingest_commit", table=tname, rows=n,
                    loads=len(batch), commit_ms=round(ms, 2))

    def _maybe_compact(self, session, tname: str, handle, batch: list):
        """Commit-count/bytes compaction trigger (small-segment hygiene):
        runs inside the gate-exclusive section, reusing the existing
        store compaction path (store::compact failpoint, `compaction`
        event)."""
        store = getattr(handle, "store", None)
        if store is None:
            return  # in-memory table: rewrites wholesale, nothing to merge
        nbytes = sum(e.nbytes for e in batch)
        with self._cond:
            c, b = self._compact_debt.get(tname, (0, 0))
            c, b = c + 1, b + nbytes
            trip = (c >= int(config.get("ingest_compact_commits") or 1)
                    or b >= int(config.get("ingest_compact_bytes") or 1))
            self._compact_debt[tname] = (0, 0) if trip else (c, b)
        if trip:
            store.compact_table(tname)

    # -- ADMIN SET ingest_job (routine-load CRUD) ---------------------------
    def admin_set_job(self, session, name: str, value: str):
        """`ADMIN SET ingest_job '<name>' = '<json spec>'|'drop'` — the
        CREATE/DROP ROUTINE LOAD analog. Specs journal through the
        session's edit log so jobs survive restarts."""
        if not config.get("enable_ingest_plane"):
            raise IngestError(
                "ingest plane is disabled (SET enable_ingest_plane=on)")
        if value.strip().lower() == "drop":
            self.poller.drop_job(name)
            session._log_meta({"op": "drop_ingest_job", "name": name})
            return None
        spec = json.loads(value)
        if "table" not in spec or "path" not in spec:
            raise IngestError(
                "ingest_job spec needs at least table and path "
                '(e.g. {"table": "t", "path": "/data/in", '
                '"format": "csv"})')
        self._load_target(session, str(spec.get("table", "")).lower())
        self.poller.create_job(name, spec)
        session._log_meta({"op": "ingest_job", "name": name,
                           "spec": spec})
        self.poller.ensure_started()
        return None
