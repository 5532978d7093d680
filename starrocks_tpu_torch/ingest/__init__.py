"""Continuous ingest plane: HTTP stream load + routine-load poller with
transactional micro-batch commit (reference behavior: stream load's
group-commit path and the routine-load scheduler, folded onto this
repo's PK delta-write storage and txn-label exactly-once machinery).

Layering: this package sits BESIDE runtime (not under it) and never
imports sessions, stores, or the SQL stack — the session layer hands
those in by reference (`Session.ingest_plane()` owns the singleton via
the catalog), keeping `ingest` importable from tools and tests without
dragging in the executor.
"""

from .labels import LabelRegistry
from .plane import (IngestBackpressure, IngestError, IngestPlane,
                    parse_csv, parse_json)
from .poller import IngestPoller

__all__ = [
    "IngestBackpressure", "IngestError", "IngestPlane", "IngestPoller",
    "LabelRegistry", "parse_csv", "parse_json",
]
