"""Routine-load poller: continuous file/dir ingest jobs.

Reference behavior: the FE's RoutineLoadManager + routine-load task
scheduler (load/routineload/RoutineLoadJob.java — long-lived jobs pull
from a source, track consumed offsets, and fold at-least-once delivery
into exactly-once through the stream-load txn-label machinery).

A job watches one file or directory of CSV/JSON files. Each poll reads
bytes PAST the persisted per-file offset (complete lines only), loads
them through the ingest plane with a DETERMINISTIC label derived from
(job, file, offset range) — so a poll that faults after commit but
before the offset persists simply replays its label on the next tick:
a durable no-op, and the offset catches up. Offsets journal through
the catalog edit-log (`ingest_offset` ops) and ride the image, so a
restarted process resumes where it left off.

Thread lifecycle: ONE daemon thread for all jobs, started lazily by
the first job (`ensure_started`, idempotent) and stopped when the last
job drops — the plane keeps ZERO background threads while unused, so
`enable_ingest_plane` stays a pure endpoint switch for idle cost.
"""

from __future__ import annotations

import os
import threading
import time

from .. import lockdep
from ..runtime import events
from ..runtime.config import config
from ..runtime.failpoint import fail_point
from ..runtime.metrics import metrics

config.define("ingest_poll_interval_s", 0.5, True,
              "routine-load poll cadence: how often the ingest poller "
              "scans each job's source for new bytes")

INGEST_POLLS = metrics.counter(
    "sr_tpu_ingest_polls_total", "routine-load source scans")
INGEST_JOB_ERRORS = metrics.counter(
    "sr_tpu_ingest_job_errors_total", "routine-load polls that failed")


class _Job:
    """One routine-load job: immutable spec + volatile progress (all
    mutable fields guarded by the poller lock)."""

    __slots__ = ("name", "spec", "offsets", "rows_loaded", "commits",
                 "errors", "last_error", "last_poll_ts")

    def __init__(self, name: str, spec: dict, offsets=None):
        self.name = name
        self.spec = dict(spec)
        self.offsets = dict(offsets or {})  # owned by the poller _lock
        self.rows_loaded = 0                # owned by the poller _lock
        self.commits = 0                    # owned by the poller _lock
        self.errors = 0                     # owned by the poller _lock
        self.last_error = ""                # owned by the poller _lock
        self.last_poll_ts = 0.0             # owned by the poller _lock


class IngestPoller:
    """All routine-load jobs + the single lazy poll thread."""

    def __init__(self, plane):
        self.plane = plane
        self._lock = lockdep.lock("ingest.IngestPoller._lock")
        self._jobs: dict = {}       # guarded_by: _lock — name -> _Job
        self._stop = lockdep.event("ingest.IngestPoller._stop")
        self._thread = None         # guarded_by: _lock

    # -- job CRUD -----------------------------------------------------------
    def create_job(self, name: str, spec: dict):
        if "table" not in spec or "path" not in spec:
            from .plane import IngestError

            raise IngestError(
                "ingest_job spec needs at least table and path "
                '(e.g. {"table": "t", "path": "/data/in", '
                '"format": "csv"})')
        name = name.lower()
        with self._lock:
            old = self._jobs.get(name)
            job = _Job(name, spec,
                       offsets=old.offsets if old is not None else None)
            self._jobs[name] = job

    def drop_job(self, name: str):
        name = name.lower()
        stop_thread = False
        with self._lock:
            self._jobs.pop(name, None)
            stop_thread = not self._jobs
        if stop_thread:
            self.stop()

    def snapshot(self) -> list:
        """Job rows for information_schema.ingest_jobs / GET /api/ingest."""
        with self._lock:
            return [{
                "name": j.name,
                "table": str(j.spec.get("table", "")).lower(),
                "path": str(j.spec.get("path", "")),
                "format": str(j.spec.get("format", "csv")),
                "state": "RUNNING" if self._thread is not None
                else "PAUSED",
                "rows_loaded": j.rows_loaded,
                "commits": j.commits,
                "errors": j.errors,
                "last_error": j.last_error,
                "last_poll_ts": j.last_poll_ts,
                "offsets": dict(j.offsets),
            } for j in self._jobs.values()]

    def stats(self) -> dict:
        with self._lock:
            return {"jobs": len(self._jobs),
                    "running": self._thread is not None}

    # -- durability ---------------------------------------------------------
    def image(self) -> dict:
        with self._lock:
            return {j.name: {"spec": dict(j.spec),
                             "offsets": dict(j.offsets)}
                    for j in self._jobs.values()}

    def restore_image(self, jobs: dict):
        with self._lock:
            for name, st in jobs.items():
                self._jobs[name] = _Job(name, st.get("spec", {}),
                                        offsets=st.get("offsets", {}))

    def restore_job(self, name: str, spec: dict):
        """Journal-tail replay of an `ingest_job` op."""
        with self._lock:
            old = self._jobs.get(name.lower())
            self._jobs[name.lower()] = _Job(
                name.lower(), spec,
                offsets=old.offsets if old is not None else None)

    def restore_offset(self, name: str, fname: str, offset: int):
        """Journal-tail replay of an `ingest_offset` op."""
        with self._lock:
            j = self._jobs.get(name.lower())
            if j is not None:
                j.offsets[fname] = int(offset)

    # -- thread lifecycle ---------------------------------------------------
    def ensure_started(self):
        """Idempotent: one daemon poll thread while jobs exist and the
        plane is enabled; ZERO threads otherwise."""
        if not config.get("enable_ingest_plane"):
            return
        with self._lock:
            if self._thread is not None or not self._jobs:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="sr-tpu-ingest-poll")
            self._thread.start()

    def stop(self):
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            self._stop.set()
            t.join(timeout=5)

    # -- the poll loop ------------------------------------------------------
    def _run(self):
        while True:
            interval = float(config.get("ingest_poll_interval_s") or 0.5)
            if self._stop.wait(timeout=max(interval, 0.05)):
                return
            with self._lock:
                if self._thread is None:
                    return
            self.poll_once()

    def poll_once(self):
        """One tick of the poll loop over every job (the thread's body; a
        test drives ticks with it instead of waiting for the interval)."""
        with self._lock:
            jobs = list(self._jobs.values())
        if not config.get("enable_ingest_plane"):
            return
        for job in jobs:  # lint: checkpoint-exempt — the poll thread's body (or a test's tick), never a query context: stop() is its cancel path, and each load runs inside its OWN killable query_scope (plane.load)
            try:
                fail_point("ingest::poll")
                INGEST_POLLS.inc()
                self._poll_job(job)
            except Exception as e:  # noqa: BLE001 — one job's bad
                #   source must not kill the poll loop; the error is
                #   journaled and surfaced on the job row
                INGEST_JOB_ERRORS.inc()
                with self._lock:
                    job.errors += 1
                    job.last_error = f"{type(e).__name__}: {e}"[:256]
                events.emit("ingest_job_error", job=job.name,
                            error=f"{type(e).__name__}: {e}"[:200])

    def _poll_job(self, job: _Job):
        """One tick of one job: read complete new lines past each file's
        offset, load them with a deterministic (job, file, range) label,
        then persist the advanced offset. Crash between commit and
        offset write -> next tick replays the label (durable no-op) and
        the offset catches up: at-least-once folds to exactly-once."""
        from .plane import parse_csv, parse_json

        session = self.plane.commit_session
        if session is None:
            return  # not wired yet (no ADMIN SET ran in this process)
        with self._lock:
            job.last_poll_ts = time.time()
            offsets = dict(job.offsets)
        path = str(job.spec.get("path", ""))
        fmt = str(job.spec.get("format", "csv")).lower()
        table = str(job.spec.get("table", "")).lower()
        sep = str(job.spec.get("column_separator", ","))
        columns = job.spec.get("columns")
        if os.path.isdir(path):
            files = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if not f.startswith("."))
        elif os.path.exists(path):
            files = [path]
        else:
            files = []
        handle = session.catalog.get_table(table)
        if handle is None:
            raise RuntimeError(f"ingest job {job.name}: unknown table "
                               f"{table!r}")
        for fname in files:  # lint: checkpoint-exempt — poller daemon thread, never a query context: stop() is its cancel path, and each load below runs inside its OWN killable query_scope (plane.load)
            off = int(offsets.get(fname, 0))
            try:
                size = os.path.getsize(fname)
            except OSError:
                continue  # vanished between listdir and stat
            if size <= off:
                continue
            with open(fname, "rb") as f:
                f.seek(off)
                chunk = f.read(size - off)
            # complete lines only: a half-written tail line stays for the
            # next tick (the producer appends; we never re-read old bytes)
            cut = chunk.rfind(b"\n")
            if cut < 0:
                continue
            chunk = chunk[: cut + 1]
            new_off = off + len(chunk)
            text = chunk.decode("utf-8", errors="replace")
            rows = (parse_json(handle, text) if fmt == "json"
                    else parse_csv(handle, text, columns=columns,
                                   sep=sep))
            if not rows:
                continue
            label = (f"job:{job.name}:{os.path.basename(fname)}:"
                     f"{off}-{new_off}")
            receipt = self.plane.load(session, table, rows, label=label,
                                      user="root")
            with self._lock:
                job.offsets[fname] = new_off
                job.commits += 1
                if not receipt.get("replayed"):
                    job.rows_loaded += int(receipt.get("rows", 0))
            session._log_meta({"op": "ingest_offset", "name": job.name,
                               "file": fname, "offset": new_off})
