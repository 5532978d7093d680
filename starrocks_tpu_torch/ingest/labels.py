"""Transaction-label ledger for exactly-once ingest.

Reference behavior: the FE's `DatabaseTransactionMgr` label index
(transaction/DatabaseTransactionMgr.java — every stream/routine load
carries a txn label; re-submitting a committed label returns the
original publish state instead of loading twice; labels age out under
`label_keep_max_second`).

Here a label maps to its commit RECEIPT (table, rows, commit seq,
timestamps). The ledger is process-memory with a bounded FIFO retention
window (`ingest_label_retention`), and it rides the existing catalog
edit-log/image machinery for durability: the ingest plane journals an
`ingest_label` op per micro-batch commit (session `_log_meta`), the
catalog image embeds a full snapshot (`Session.checkpoint_metadata`),
and `Session._restore_catalog_meta` replays image + journal tail back
into this registry on restart — so a replayed label stays a durable
no-op across process generations.
"""

from __future__ import annotations

from collections import deque

from .. import lockdep
from ..runtime.config import config

config.define("ingest_label_retention", 4096, True,
              "bounded number of committed ingest txn labels retained for "
              "exactly-once replay detection (the label_keep_max_second "
              "analog, count-bounded); oldest labels age out first")


class LabelRegistry:
    """Bounded label -> commit-receipt ledger. The lock is a LEAF: taken
    only for point get/record/snapshot, never while journaling or
    committing — the ingest plane journals the op outside this lock."""

    def __init__(self):
        self._lock = lockdep.lock("ingest.LabelRegistry._lock")
        self._receipts: dict = {}   # guarded_by: _lock — label -> receipt
        self._order: deque = deque()  # guarded_by: _lock — FIFO retention

    def get(self, label: str):
        """The committed receipt for `label`, or None (never committed —
        or aged out of the retention window, in which case a replay
        re-applies; PK upserts keep that idempotent)."""
        with self._lock:
            return self._receipts.get(label)

    def record(self, label: str, receipt: dict):
        # once-per-commit path (not per row): the config.get is fine here
        retention = max(int(config.get("ingest_label_retention") or 1), 1)
        with self._lock:
            if label not in self._receipts:
                self._order.append(label)
            self._receipts[label] = receipt
            while len(self._order) > retention:
                old = self._order.popleft()
                self._receipts.pop(old, None)

    def restore(self, receipts: dict):
        """Image/journal replay: merge committed receipts (startup path;
        `Session._restore_catalog_meta`). Idempotent."""
        for label, receipt in receipts.items():
            self.record(label, dict(receipt))

    def snapshot(self) -> dict:
        """Full {label: receipt} state for the catalog image."""
        with self._lock:
            return {la: dict(r) for la, r in self._receipts.items()}

    def stats(self) -> dict:
        with self._lock:
            return {"labels": len(self._receipts)}

    def clear(self):
        """Tests only."""
        with self._lock:
            self._receipts.clear()
            self._order.clear()
