"""Persistent tablet store: bucketed parquet rowsets + manifest + edit log.

Reference behavior re-designed (SURVEY §2.1 storage rows), after the JAX
package's ``storage/store.py``, with the same directory layout, manifest
fields, journal and data files, so either package opens a data directory
the other wrote:
- StorageEngine/Tablet/Rowset (be/src/storage/storage_engine.h:133,
  tablet.h:84, rowset/rowset.h:143): a table = N hash buckets ("tablets");
  every INSERT produces an immutable *rowset* = one data file per non-empty
  (partition, bucket). A data file is one parquet file, written by the
  port's own writer (storage/formats/parquet_write.py: the Arrow types the
  reference's `_to_arrow` gives, in the layout of pyarrow's defaults:
  SNAPPY pages, a dictionary per column chunk, row groups of up to 2^20
  rows) and read by its own reader (storage/formats/parquet.py), which also
  reads the reference's files and the port's older UNCOMPRESSED ones. NULL
  slots read back as zeros, as the reference's
  parquet read-back gives them. Directories the port wrote before it wrote
  parquet hold ``.npz`` files (numpy's zip of ``.npy`` arrays, read with
  pickling off), which still read.
- zonemap indexes (storage/rowset/zone_map_index*): per-file min/max stats
  recorded in the manifest; scans prune files by predicate.
- FE EditLog/BDB-JE journal (fe persist/EditLog.java:133): an append-only
  JSONL edit log records DDL/load ops, with an image checkpoint.
- PRIMARY KEY tables (be/src/storage/tablet_updates.h:108 + del_vector.h):
  upserts append a delta rowset and mark superseded rows in per-file delete
  vectors (sorted row positions in the manifest). The primary index is
  vectorised: the live keys sorted once into a numpy structured array,
  probed with np.searchsorted and merged with sorts, never a loop per row.

The rows of every file, and their order, are the reference's: rows go to
buckets by splitmix64 of the distribution key and to files by one stable
sort on (partition, bucket). So delete-vector positions, file names and
manifests agree with the reference's.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional

import numpy as np

from .. import lockdep
from .. import native
from .. import types as T
from ..column import Field, HostTable, Schema, StringDict
from ..exprs.ir import Call, Col, Expr, InList, Lit
from ..runtime.failpoint import fail_point
from .external import _bitmap
from .formats import Coded, Lists
from .formats.parquet import ParquetFile
from .formats.parquet_write import write_table

FILE_EXT = ".parquet"


def _type_to_json(t: T.LogicalType) -> dict:
    out = {"kind": t.kind.value, "precision": t.precision, "scale": t.scale}
    if t.elem is not None:
        out["elem"] = _type_to_json(t.elem)
    return out


def _type_from_json(d: dict) -> T.LogicalType:
    elem = _type_from_json(d["elem"]) if d.get("elem") else None
    return T.LogicalType(T.TypeKind(d["kind"]), d.get("precision"),
                         d.get("scale"), elem)


def schema_to_json(schema: Schema) -> list:
    return [
        {"name": f.name, "type": _type_to_json(f.type), "nullable": f.nullable}
        for f in schema
    ]


def schema_from_json(items: list) -> Schema:
    fields = []
    for it in items:
        t = _type_from_json(it["type"])
        d = StringDict.from_values([]) if t.is_string else None
        fields.append(Field(it["name"], t, it["nullable"], d))
    return Schema(tuple(fields))


def hash_partition_i64(keys: np.ndarray, nbuckets: int) -> np.ndarray:
    """splitmix64 bucket assignment of a single int64 key (the reference's
    numpy form, starrocks_tpu/native.py)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    z = keys.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(nbuckets)).astype(np.int32)


def _pmap(fn, items) -> list:
    """[fn(x) for x in items], on a few threads (file reads and writes,
    gathers, zip CRCs and reductions release the GIL); the first error
    raises."""
    items = list(items)
    if len(items) < 2:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1, len(items))) as ex:
        return list(ex.map(fn, items))


def _group_order(grp: np.ndarray, ngroups: int) -> np.ndarray:
    """Stable permutation sorting rows by group id: the rows of each group
    keep their input order. Group ids are cast to the narrowest unsigned
    type, where numpy's stable sort is a radix sort."""
    for dt in (np.uint8, np.uint16, np.uint32):
        if ngroups <= np.iinfo(dt).max + 1:
            return np.argsort(grp.astype(dt), kind="stable")
    return np.argsort(grp, kind="stable")


class TabletStore:
    """Directory layout:
    root/edit_log.jsonl
    root/image.json
    root/<table>/manifest.json
    root/<table>/rowset_<n>[_part_<p>]_bucket_<b>.parquet
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.log_path = os.path.join(root, "edit_log.jsonl")
        self.image_path = os.path.join(root, "image.json")
        # guards the index map, the listener list and the last-scan stats;
        # DML content stays single-writer
        self._state_lock = lockdep.lock("TabletStore._state_lock")
        # table -> _PKIndex
        self._pk_index: dict = {}   # guarded_by: _state_lock
        # table -> (manifest, Schema) for point probes, cached until the
        # next _write_manifest. Only the point path reads it (mutators read
        # fresh copies via read_manifest and edit their own dict)
        self._manifest_cache: dict = {}  # guarded_by: _state_lock
        # (table, file, columns) -> `_read_file` columns of ONE immutable
        # data file, delete vector NOT applied: delvecs only mask rows at
        # read, so raw positions stay valid across PK DML. The point gather
        # slices rows out of these; entries drop when the table's file set
        # changes (_drop_pk_index)
        self._part_cache = collections.OrderedDict()
        self.last_scan_stats: dict = {}  # guarded_by: _state_lock
        # host seconds of the last write (insert/upsert/rewrite), by step:
        # "bucket_s" (partition + bucket of each row, the stable group
        # order), "write_s" (slicing, zonemaps, file writes), "index_s"
        # (the primary index: canonical keys, batch dedupe, probe, delete
        # vectors, index update), and its "rows"
        self.last_write_stats: dict = {}  # lint: unguarded-ok — written by the writes alone (DML content stays single-writer, above); a diagnostic read after the write
        # serializes log() appends against checkpoint()'s snapshot+replace:
        # an append between the tail snapshot and os.replace would land on
        # the replaced inode and vanish from the journal
        self._journal_lock = lockdep.rlock("TabletStore._journal_lock")
        # lazily scanned (image seq + log tail); ops past the image (the
        # auto-checkpoint trigger)
        self._next_seq = None   # guarded_by: _journal_lock
        self.tail_count = None  # guarded_by: _journal_lock
        # mutation listeners: fn(table, op) fired after every storage-level
        # write; sessions wire them to catalog data-epoch bumps
        self._listeners: list = []  # guarded_by: _state_lock

    def add_listener(self, fn):
        with self._state_lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def _notify(self, table: str, op: str):
        with self._state_lock:
            listeners = list(self._listeners)
        for fn in listeners:  # called OUTSIDE the lock
            try:
                fn(table, op)
            except Exception:  # noqa: BLE001 — listeners must never fail a write
                pass

    def scan_stats(self) -> dict:
        """Snapshot of the most recent load_table's pruning stats."""
        with self._state_lock:
            return dict(self.last_scan_stats)

    COL_CACHE_FILES = 64  # point-gather per-file LRU capacity

    def _drop_pk_index(self, name: str):
        with self._state_lock:
            self._pk_index.pop(name, None)
            self._manifest_cache.pop(name, None)
            # the table's file set changed (rewrite/compact/alter/drop):
            # cached raw-file columns are dead with the positions
            for k in [k for k in self._part_cache if k[0] == name]:
                del self._part_cache[k]

    # --- edit log + image checkpoint -----------------------------------------
    # The journal is the FE EditLog/image pair (fe persist/EditLog.java:133 +
    # leader/CheckpointController.java:85): every op carries a monotone seq;
    # checkpoint() snapshots catalog-level metadata into image.json and
    # truncates the log to the ops after the image.
    def _scan_seq(self) -> int:  # lint: holds _journal_lock  # lint: blocking-ok — the lazy seq scan reads image+log and must serialize vs writers: a log append racing the scan would mint a duplicate seq
        img = self.read_image()
        base = img["seq"] if img else 0
        seq = base
        n_tail = 0
        for op in self.replay():
            seq = max(seq, op.get("seq", seq + 1))
            if op.get("seq", 0) > base:
                n_tail += 1
        self.tail_count = n_tail
        return seq

    def ensure_seq(self):  # lint: blocking-ok — startup-path journal scan under the journal lock: same serialization contract as _scan_seq
        """Force the lazy journal scan (startup paths want tail_count)."""
        with self._journal_lock:
            if self._next_seq is None:
                self._next_seq = self._scan_seq()

    def log(self, op: dict) -> int:  # lint: blocking-ok — the edit-log append IS the serialization point: writing outside the journal lock could tear op order against checkpoint truncation
        with self._journal_lock:
            # an injected failure here leaves the log un-torn: nothing is
            # appended before this point
            fail_point("journal::write")
            if self._next_seq is None:
                self._next_seq = self._scan_seq()
            self.tail_count = (self.tail_count or 0) + 1
            self._next_seq += 1
            op = {"seq": self._next_seq, **op}
            with open(self.log_path, "a") as f:
                f.write(json.dumps(op) + "\n")
            return self._next_seq

    def replay(self, after_seq: int = -1):
        """Yield logged ops in order (catalog rebuild). Ops without an
        explicit seq (pre-image logs) get their 1-based line number."""
        if not os.path.exists(self.log_path):
            return
        with open(self.log_path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if line:
                    op = json.loads(line)
                    op.setdefault("seq", i)
                    if op["seq"] > after_seq:
                        yield op

    def read_image(self):
        """The newest catalog image, or None (never checkpointed)."""
        if not os.path.exists(self.image_path):
            return None
        try:
            with open(self.image_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None  # torn image: fall back to full log replay

    def checkpoint(self, catalog_image: dict) -> int:  # lint: blocking-ok — image write + fsync + log truncation must be atomic vs concurrent log(): holding the journal lock across the IO is the durability contract
        """Write the catalog image at the current journal position and
        truncate the log. Image first (fsync'd tmp + atomic replace), then
        the log — a crash between the two leaves covered ops in the log,
        and replay of an already-applied catalog op is idempotent."""
        with self._journal_lock:
            fail_point("journal::checkpoint")
            if self._next_seq is None:
                self._next_seq = self._scan_seq()
            seq = self._next_seq
            tmp = self.image_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"seq": seq, "catalog": catalog_image}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.image_path)
            dfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dfd)  # the rename itself must survive power loss
            finally:
                os.close(dfd)
            keep = [op for op in self.replay(after_seq=seq)]
            tmp = self.log_path + ".tmp"
            with open(tmp, "w") as f:
                for op in keep:
                    f.write(json.dumps(op) + "\n")
            os.replace(tmp, self.log_path)
            self.tail_count = len(keep)
        from ..runtime import events

        events.emit("checkpoint", seq=seq, tail_ops=len(keep))
        return seq

    # --- table lifecycle ------------------------------------------------------
    def _tdir(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _manifest_path(self, name: str) -> str:
        return os.path.join(self._tdir(name), "manifest.json")

    def read_manifest(self, name: str) -> dict:
        with open(self._manifest_path(name)) as f:
            return json.load(f)

    def _write_manifest(self, name: str, m: dict):
        fail_point("store::manifest_write")
        tmp = self._manifest_path(name) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(m, f, indent=1)
        os.replace(tmp, self._manifest_path(name))
        with self._state_lock:
            self._manifest_cache.pop(name, None)

    def create_table(
        self, name: str, schema: Schema, distribution=(), buckets: int = 1,
        unique_keys=(), record: bool = True, partition_by=None,
    ):
        """partition_by: {"column": c, "names": [...], "uppers": [...]} —
        RANGE partitioning, uppers are exclusive upper bounds in partition
        order with None = MAXVALUE last (reference:
        fe catalog/RangePartitionInfo.java)."""
        if partition_by is not None:
            pf = schema.field(partition_by["column"])
            if not (pf.type.is_integer or pf.type.is_temporal):
                raise ValueError(
                    "RANGE partition column must be integer or date/datetime"
                    f", got {pf.type} for {partition_by['column']!r}")
        os.makedirs(self._tdir(name), exist_ok=True)
        m = {
            "name": name,
            "schema": schema_to_json(schema),
            "distribution": list(distribution),
            "buckets": max(buckets, 1),
            "unique_keys": [list(k) for k in unique_keys],
            "partition_by": partition_by,
            "rowsets": [],
            "next_rowset": 0,
        }
        self._write_manifest(name, m)
        if record:
            self.log({"op": "create", "table": name, "schema": schema_to_json(schema),
                      "distribution": list(distribution), "buckets": max(buckets, 1),
                      "unique_keys": [list(k) for k in unique_keys],
                      "partition_by": partition_by})

    def drop_table(self, name: str, record: bool = True):
        self._drop_pk_index(name)
        tdir = self._tdir(name)
        if os.path.isdir(tdir):
            for f in os.listdir(tdir):
                os.remove(os.path.join(tdir, f))
            os.rmdir(tdir)
        if record:
            self.log({"op": "drop", "table": name})
        self._notify(name, "drop")

    def table_names(self):
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(self._tdir(d))
            and os.path.exists(self._manifest_path(d))
        )

    # --- write path -----------------------------------------------------------
    def insert(self, name: str, data: HostTable, record: bool = True) -> int:
        """Append a rowset: hash-bucket rows, write one file per (partition,
        bucket), record zonemaps. Mirrors MemTable flush -> segment files
        (be/src/storage/memtable.h:77 -> rowset commit)."""
        fail_point("store::insert")
        m = self.read_manifest(name)
        nb = m["buckets"]
        t0 = time.perf_counter()
        bucket = self._bucket_of(m, data)
        n = data.num_rows
        part = self._partition_of(m, data)
        self.last_write_stats = {"rows": n, "index_s": 0.0,
                                 "bucket_s": time.perf_counter() - t0}
        rid = m["next_rowset"]
        files, _ = self._write_rowset_files(name, rid, data, bucket, nb, part)
        m["rowsets"].append({"id": rid, "files": files, "rows": n})
        m["next_rowset"] = rid + 1
        self._write_manifest(name, m)
        # appended rows are not in a cached primary index: the next upsert
        # rebuilds it from the files
        self._drop_pk_index(name)
        if record:
            self.log({"op": "insert", "table": name, "rowset": rid, "rows": n})
        self._notify(name, "insert")
        self._maybe_compact(name, m)
        return n

    def _partition_of(self, m: dict, data: HostTable):
        """Per-row partition index under the manifest's RANGE spec (None
        when unpartitioned). Rows above the last bound raise — the
        reference rejects them the same way unless dynamic partitions are
        on (clone/DynamicPartitionScheduler.java)."""
        pb = m.get("partition_by")
        if not pb:
            return None
        vals = np.asarray(data.arrays[pb["column"]])
        uppers = pb["uppers"]
        finite = [u for u in uppers if u is not None]
        idx = np.searchsorted(np.asarray(finite, dtype=vals.dtype), vals,
                              side="right")
        if uppers and uppers[-1] is None:
            pass  # overflow rows land in the MAXVALUE partition
        elif len(vals) and idx.max() >= len(uppers):
            bad = vals[idx >= len(uppers)][0]
            raise ValueError(
                f"value {bad!r} exceeds the last partition bound of "
                f"{m['name']!r}")
        return idx

    def _write_rowset_files(self, name, rid, data, bucket, nb, part=None):
        """One file per non-empty (partition, bucket), in that order; the
        rows of a file keep their order in `data` (one stable sort by
        group, then contiguous slices). Returns (file metas, the group of
        each row, the row's position within its file)."""
        n = data.num_rows
        t0 = time.perf_counter()
        bucket = np.asarray(bucket, dtype=np.int64)
        if part is None:
            grp, ngroups = bucket, nb
        else:
            part = np.asarray(part, dtype=np.int64)
            ngroups = (int(part.max()) + 1 if n else 1) * nb
            grp = part * nb + bucket
        order = _group_order(grp, ngroups)
        counts = np.bincount(grp, minlength=ngroups)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pos = np.empty(n, dtype=np.int64)
        pos[order] = np.arange(n, dtype=np.int64) - np.repeat(
            starts[:-1], counts)
        t1 = time.perf_counter()
        times = []  # each file's codec seconds (list.append is atomic)

        def one(g):
            p = None if part is None else int(g // nb)
            b = int(g % nb)
            suffix = "" if p is None else f"_part_{p}"
            fname = f"rowset_{rid}{suffix}_bucket_{b}{FILE_EXT}"
            sl = _slice_table(data, order[starts[g]:starts[g + 1]])
            times.append(self._write_file(name, fname, sl))
            meta = {
                "file": fname,
                "bucket": b,
                "rows": int(counts[g]),
                # live columns in THIS file: schema changes are linked
                # (files never rewritten), so readers consult this list
                # — a re-added name must NOT resurrect dropped bytes
                "cols": [f.name for f in data.schema],
                "zonemap": _zonemap(sl, slice(None)),
            }
            if p is not None:
                meta["part"] = p
            return meta

        files = _pmap(one, np.flatnonzero(counts))
        st = self.last_write_stats
        st["bucket_s"] = st.get("bucket_s", 0.0) + t1 - t0
        st["write_s"] = st.get("write_s", 0.0) + time.perf_counter() - t1
        st["compress_s"] = st.get("compress_s", 0.0) + sum(
            t.get("compress", 0.0) for t in times)
        return files, (grp, pos)

    def _write_file(self, name: str, fname: str, data: HostTable) -> dict:
        """Write one data file atomically (temporary name, then rename);
        the seconds it spent compressing, as {"compress": s}."""
        times: dict = {}
        write_table(data, os.path.join(self._tdir(name), fname), times=times)
        return times

    def rewrite_table(self, name: str, data: HostTable, record: bool = True) -> int:
        """Atomically replace a table's rows (DELETE/TRUNCATE rewrite): the
        replacement rowset is written FIRST, then the manifest swaps via
        os.replace; old files are removed only after the swap. A crash
        mid-rewrite leaves either the old or the new state, never data loss."""
        fail_point("store::rewrite")
        m = self.read_manifest(name)
        old_files = [
            f["file"] for rs in m["rowsets"] for f in rs["files"]
        ]
        rid = m["next_rowset"]
        n = data.num_rows
        self.last_write_stats = {"rows": n, "index_s": 0.0}
        if n:
            t0 = time.perf_counter()
            bucket = self._bucket_of(m, data)
            part = self._partition_of(m, data)
            self.last_write_stats["bucket_s"] = time.perf_counter() - t0
            files, _ = self._write_rowset_files(name, rid, data, bucket,
                                                m["buckets"], part)
            m["rowsets"] = [{"id": rid, "files": files, "rows": n}]
        else:
            m["rowsets"] = []
        m["next_rowset"] = rid + 1
        self._drop_pk_index(name)
        self._write_manifest(name, m)  # atomic swap: new state is now durable
        for f in old_files:
            try:
                os.remove(os.path.join(self._tdir(name), f))
            except OSError:
                pass
        if record:
            self.log({"op": "rewrite", "table": name, "rows": n})
        self._notify(name, "rewrite")
        return n

    # --- schema change --------------------------------------------------------
    @staticmethod
    def validate_alter(schema: Schema, action: str, column: str,
                       nullable: bool, has_rows: bool, protected: set):
        """Shared ALTER TABLE validation (stored + in-memory tables)."""
        names = [f.name for f in schema]
        if action == "add":
            if column in names:
                raise ValueError(f"column {column!r} already exists")
            if not nullable and has_rows:
                raise ValueError(
                    "ADD COLUMN ... NOT NULL requires an empty table "
                    "(no default values yet)")
        elif action == "drop":
            if column not in names:
                raise ValueError(f"unknown column {column!r}")
            if column in protected:
                raise ValueError(
                    f"column {column!r} is a key/distribution/partition "
                    "column and cannot be dropped")
            if len(names) == 1:
                raise ValueError("cannot drop the last column")
        else:
            raise ValueError(f"unknown ALTER action {action!r}")

    def alter_table(self, name: str, action: str, column: str,
                    ctype=None, nullable: bool = True, record: bool = True):
        """ADD COLUMN (nullable; existing rows read back NULL — linked
        schema change: data files are NOT rewritten, the reader fills
        missing columns) / DROP COLUMN (metadata-only; bytes reclaimed at
        the next compaction). Reference: alter/SchemaChangeJobV2.java's
        linked-schema-change fast path."""
        m = self.read_manifest(name)
        schema = schema_from_json(m["schema"])
        protected = set(m["distribution"]) | {
            k for ks in m["unique_keys"] for k in ks}
        pb = m.get("partition_by")
        if pb:
            protected.add(pb["column"])
        has_rows = any(
            f["rows"] for rs in m["rowsets"] for f in rs["files"])
        self.validate_alter(schema, action, column, nullable, has_rows,
                            protected)
        if action == "add":
            d = StringDict.from_values([]) if ctype.is_string else None
            fields = tuple(schema.fields) + (
                Field(column, ctype, nullable, d),)
        else:
            fields = tuple(f for f in schema.fields if f.name != column)
            # strip the name from every file's live-column list (entries
            # without one, written by compaction, take theirs from the
            # file once) so a future same-named ADD reads NULL, never the
            # dropped bytes
            metas = [f for rs in m["rowsets"] for f in rs["files"]]
            # lint: checkpoint-exempt — DDL under the DML gate, no query context to observe; it reads a footer only for a file without a live-column list, once
            for fmeta in metas:
                if "cols" not in fmeta:
                    fmeta["cols"] = self._file_names(name, fmeta)
                fmeta["cols"] = [c for c in fmeta["cols"] if c != column]
        m["schema"] = schema_to_json(Schema(fields))
        self._write_manifest(name, m)
        self._drop_pk_index(name)
        if record:
            self.log({"op": "alter", "table": name, "action": action,
                      "column": column})
        self._notify(name, "alter")
        return Schema(fields)

    # --- compaction -----------------------------------------------------------
    def _maybe_compact(self, name: str, m: dict):
        from ..runtime.config import config

        trigger = config.get("compaction_trigger_rowsets")
        if trigger and len(m["rowsets"]) >= trigger:
            self.compact_table(name)

    def compact_table(self, name: str, record: bool = True) -> int:
        """Merge every rowset into one per (partition, bucket), applying
        delete vectors (cumulative+base compaction collapsed into one pass —
        be/src/storage/compaction_manager.h:36). Atomic via manifest swap."""
        fail_point("store::compact")
        m = self.read_manifest(name)
        if len(m["rowsets"]) <= 1 and not any(
            f.get("delvec") for rs in m["rowsets"] for f in rs["files"]
        ):
            return 0
        old_files = [f["file"] for rs in m["rowsets"] for f in rs["files"]]
        groups: dict = {}
        for rs in m["rowsets"]:
            for fmeta in rs["files"]:
                groups.setdefault(
                    (fmeta.get("part"), fmeta["bucket"]), []
                ).append(fmeta)
        rid = m["next_rowset"]
        schema = schema_from_json(m["schema"])
        want = [f.name for f in schema]

        def merge(item):
            (part, b), metas = item
            ht = _concat_parts(
                [self._read_file(name, fm, want, schema) for fm in metas],
                want, schema)
            if ht.num_rows == 0:
                return None
            suffix = "" if part is None else f"_part_{part}"
            fname = f"rowset_{rid}{suffix}_bucket_{b}{FILE_EXT}"
            self._write_file(name, fname, ht)
            meta = {
                "file": fname, "bucket": b, "rows": ht.num_rows,
                "zonemap": _zonemap(ht, slice(None)),
            }
            if part is not None:
                meta["part"] = part
            return meta

        new_files = [meta for meta in _pmap(merge, sorted(
            groups.items(), key=lambda kv: (kv[0][0] is not None, kv[0])))
            if meta is not None]
        total_rows = sum(meta["rows"] for meta in new_files)
        m["rowsets"] = (
            [{"id": rid, "files": new_files, "rows": total_rows}]
            if new_files else []
        )
        m["next_rowset"] = rid + 1
        self._write_manifest(name, m)
        self._drop_pk_index(name)  # positions changed
        for f in old_files:
            try:
                os.remove(os.path.join(self._tdir(name), f))
            except OSError:
                pass
        if record:
            self.log({"op": "compact", "table": name, "rows": total_rows})
        self._notify(name, "compact")
        from ..runtime import events

        events.emit("compaction", table=name, rows=total_rows,
                    rowsets_merged=len(old_files))
        return total_rows

    # --- primary-key delta path -------------------------------------------------
    def _load_pk_index(self, name: str, m: dict, keys) -> "_PKIndex":
        """The primary index of the LIVE rows: canonical keys (strings by
        their text, dates and datetimes as their integers) -> (rowset,
        file, row position). Built once per table from the key columns
        only, then maintained by upserts (the tablet_updates primary index
        analog). Where two live rows share a key, the later file's wins, as
        a dict filled in file order would give."""
        with self._state_lock:
            cached = self._pk_index.get(name)
        if cached is not None:
            return cached
        schema = schema_from_json(m["schema"])

        def live_keys(loc):
            ri, fi, fmeta = loc
            raw = self._read_file(name, fmeta, keys, schema,
                                  apply_delvec=False)
            live = np.ones(fmeta["rows"], dtype=bool)
            dv = fmeta.get("delvec")
            if dv:
                live[np.asarray(dv, dtype=np.int64)] = False
            nl = int(live.sum())
            return ([_canon_array(raw[k][0], raw[k][2],
                                  schema.field(k).type)[live] for k in keys],
                    np.flatnonzero(live), np.full(nl, ri, dtype=np.int32),
                    np.full(nl, fi, dtype=np.int32))

        got = _pmap(live_keys, [(ri, fi, fmeta)
                                for ri, rs in enumerate(m["rowsets"])
                                for fi, fmeta in enumerate(rs["files"])])
        cols = [[g[0][j] for g in got] for j in range(len(keys))]
        poss = [g[1] for g in got]
        ris = [g[2] for g in got]
        fis = [g[3] for g in got]
        kc = [_concat_canon(c, schema.field(k).type)
              for c, k in zip(cols, keys)]
        ri = np.concatenate(ris) if ris else np.zeros(0, np.int32)
        fi = np.concatenate(fis) if fis else np.zeros(0, np.int32)
        pos = np.concatenate(poss) if poss else np.zeros(0, np.int64)
        index = _PKIndex.build(kc, ri, fi, pos)
        with self._state_lock:
            return self._pk_index.setdefault(name, index)

    def upsert(self, name: str, data: HostTable, record: bool = True) -> int:
        """PRIMARY KEY write: append the batch as a DELTA rowset and mark
        superseded rows in older rowsets via per-file delete vectors —
        O(delta) bytes written instead of rewriting the table
        (be/src/storage/tablet_updates.h:108 + del_vector.h). Within one
        batch, last write wins."""
        fail_point("store::upsert")
        m = self.read_manifest(name)
        keys = [k for ks in m["unique_keys"] for k in ks]
        if not keys:
            return self.insert(name, data, record=record)
        t0 = time.perf_counter()
        kc = _canon_key_cols(data, keys)
        # within-batch dedupe: keep the LAST occurrence per key
        keep, korder = _dedupe_last(kc)
        if keep is not None:
            data = _slice_table(data, keep)
            kc = [c[keep] for c in kc]
        index = self._load_pk_index(name, m, keys)
        at, found = index.lookup(kc)
        if found.any():
            hit = at[found]
            h_ri, h_fi, h_pos = index.ri[hit], index.fi[hit], index.pos[hit]
            fkey = (h_ri.astype(np.int64) << 32) | h_fi.astype(np.int64)
            order = np.argsort(fkey, kind="stable")
            fkey, h_pos = fkey[order], h_pos[order]
            bounds = np.flatnonzero(np.diff(fkey)) + 1
            for lo, hi in zip(np.concatenate([[0], bounds]),
                              np.concatenate([bounds, [len(fkey)]])):
                ri, fi = int(fkey[lo] >> 32), int(fkey[lo] & 0xFFFFFFFF)
                fmeta = m["rowsets"][ri]["files"][fi]
                fmeta["delvec"] = np.union1d(
                    np.asarray(fmeta.get("delvec") or (), dtype=np.int64),
                    h_pos[lo:hi]).tolist()
        # append the delta rowset (same bucketing/partitioning as insert)
        n = data.num_rows
        rid = m["next_rowset"]
        t1 = time.perf_counter()
        part = self._partition_of(m, data)
        bucket = self._bucket_of(m, data)
        self.last_write_stats = {"rows": n, "index_s": t1 - t0,
                                 "bucket_s": time.perf_counter() - t1}
        files, (grp, pos) = self._write_rowset_files(
            name, rid, data, bucket, m["buckets"], part)
        new_ri = len(m["rowsets"])
        m["rowsets"].append({"id": rid, "files": files, "rows": n})
        m["next_rowset"] = rid + 1
        self._write_manifest(name, m)
        # maintain the index: each appended row's file is the rank of its
        # (partition, bucket) group among the non-empty ones
        t2 = time.perf_counter()
        present = np.unique(grp)
        file_of = np.searchsorted(present, grp).astype(np.int32)
        index.upsert(kc, korder, at, found, new_ri, file_of, pos)
        self.last_write_stats["index_s"] += time.perf_counter() - t2
        if record:
            self.log({"op": "upsert", "table": name, "rowset": rid, "rows": n})
        self._notify(name, "upsert")
        self._maybe_compact(name, m)
        return n

    # --- point-query plane ----------------------------------------------------
    def _manifest_snapshot(self, name: str):
        """(manifest, Schema) snapshot for point probes, cached until the
        next manifest write — read_manifest re-parses JSON per call, which
        alone would dominate a sub-millisecond lookup."""
        with self._state_lock:
            snap = self._manifest_cache.get(name)
        if snap is not None:
            return snap
        m = self.read_manifest(name)
        schema = schema_from_json(m["schema"])
        with self._state_lock:
            return self._manifest_cache.setdefault(name, (m, schema))

    def _file_parts(self, name: str, fmeta: dict, want, schema: Schema):
        """`_read_file` columns of ONE immutable data file, delete vector
        not applied (raw row positions), LRU-cached: the point gather's row
        source — a lookup slices rows out of these with numpy indexing."""
        key = (name, fmeta["file"], tuple(want))
        with self._state_lock:
            parts = self._part_cache.get(key)
            if parts is not None:
                self._part_cache.move_to_end(key)
                return parts
        parts = self._read_file(name, fmeta, want, schema,
                                apply_delvec=False)
        with self._state_lock:
            self._part_cache[key] = parts
            self._part_cache.move_to_end(key)
            while len(self._part_cache) > self.COL_CACHE_FILES:
                self._part_cache.popitem(last=False)
        return parts

    def _probe_live(self, m: dict, schema: Schema, name: str, keys,
                    key_tuples):
        """(index, [(rowset, file, position, index slot)]) of the LIVE rows
        the canonical key tuples name, duplicates collapsed, in storage
        scan order."""
        index = self._load_pk_index(name, m, keys)
        uniq = list(dict.fromkeys(tuple(kv) for kv in key_tuples))
        if not uniq or not len(index):
            return index, []
        kc = [_key_query_column([kv[j] for kv in uniq],
                                schema.field(k).type)
              for j, k in enumerate(keys)]
        at, found = index.lookup(kc)
        hits = []
        dead_by_file: dict = {}
        for slot in at[found]:
            ri, fi, pos = (int(index.ri[slot]), int(index.fi[slot]),
                           int(index.pos[slot]))
            dead = dead_by_file.get((ri, fi))
            if dead is None:
                dead = set(m["rowsets"][ri]["files"][fi].get("delvec") or ())
                dead_by_file[(ri, fi)] = dead
            if pos in dead:
                continue  # superseded after the index entry was built
            hits.append((ri, fi, pos, int(slot)))
        hits.sort()
        return index, hits

    def point_lookup(self, name: str, key_tuples, columns=None) -> HostTable:
        """Primary-index point probe: pk index -> delvec check -> direct
        row gather from the owning files, never a whole-table load (the
        short-circuit read path; reference analog: be/src/exec/pipeline/
        short_circuit + the primary-index point get in tablet_updates).
        `key_tuples` are canonical pk tuples (text for VARCHAR, epoch
        days/microseconds for DATE/DATETIME, ints); duplicates collapse,
        IN-list style. Hit rows come back in storage scan order — the order
        the full scan path yields them."""
        fail_point("point::probe")
        m, schema = self._manifest_snapshot(name)
        keys = [k for ks in m["unique_keys"] for k in ks]
        if not keys:
            raise ValueError(f"table {name!r} has no PRIMARY KEY")
        _, hits = self._probe_live(m, schema, name, keys, key_tuples)
        want = list(columns) if columns else [f.name for f in schema]
        if not hits:
            return _empty_table(Schema(tuple(schema.field(c) for c in want)))
        by_file: dict = {}
        for ri, fi, pos, _ in hits:
            by_file.setdefault((ri, fi), []).append(pos)
        from ..runtime import lifecycle

        parts = []
        for (ri, fi), poss in sorted(by_file.items()):
            lifecycle.checkpoint("point::gather")
            raw = self._file_parts(name, m["rowsets"][ri]["files"][fi],
                                   want, schema)
            idx = np.asarray(poss, dtype=np.int64)
            parts.append({c: (a[idx], None if v is None else v[idx], d)
                          for c, (a, v, d) in raw.items()})
        return _concat_parts(parts, want, schema)

    def delete_rows(self, name: str, key_tuples, record: bool = True) -> int:
        """PRIMARY KEY point delete: mark the victims in their files'
        delete vectors and drop them from the live index — O(keys) work and
        O(manifest) bytes, never a table rewrite (the delvec write path
        upsert already uses, be/src/storage/del_vector.h analog)."""
        fail_point("store::delete_rows")
        m = self.read_manifest(name)
        schema = schema_from_json(m["schema"])
        keys = [k for ks in m["unique_keys"] for k in ks]
        if not keys:
            raise ValueError(f"table {name!r} has no PRIMARY KEY")
        index, hits = self._probe_live(m, schema, name, keys, key_tuples)
        if not hits:
            return 0
        touched: dict = {}
        for ri, fi, pos, _ in hits:
            touched.setdefault((ri, fi), set()).add(pos)
        for (ri, fi), dead in touched.items():
            fmeta = m["rowsets"][ri]["files"][fi]
            fmeta["delvec"] = sorted(set(fmeta.get("delvec") or ()) | dead)
        self._write_manifest(name, m)
        # the index mutation is single-writer (DML gate), like upsert's
        index.remove(np.asarray([h[3] for h in hits], dtype=np.int64))
        if record:
            self.log({"op": "delete_rows", "table": name,
                      "rows": len(hits)})
        self._notify(name, "delete_rows")
        return len(hits)

    def _bucket_of(self, m: dict, data: HostTable):
        """Per-row bucket under the manifest's hash distribution (the one
        routing recipe for insert AND upsert: single column via the
        splitmix64 partitioner, multi-column via xor-combined mixes)."""
        nb = m["buckets"]
        dist = m["distribution"]
        n = data.num_rows
        if not dist or nb <= 1:
            return np.zeros(n, dtype=np.int64)
        if len(dist) == 1:
            return hash_partition_i64(
                np.asarray(data.arrays[dist[0]], dtype=np.int64), nb
            ).astype(np.int64)
        h = np.zeros(n, dtype=np.uint64)
        for c in dist:
            a = np.asarray(data.arrays[c], dtype=np.int64).view(np.uint64)
            am = a * np.uint64(0x9E3779B97F4A7C15)
            z = (am ^ (am >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            h = h ^ (z ^ (z >> np.uint64(31)))
        return (h % np.uint64(nb)).astype(np.int64)

    # --- read path ------------------------------------------------------------
    def _file_names(self, name: str, fmeta: dict) -> list:
        """The columns a data file holds: its manifest entry's live list,
        else (files written by compaction) the names stored in the file."""
        if fmeta.get("cols") is not None:
            return list(fmeta["cols"])
        path = os.path.join(self._tdir(name), fmeta["file"])
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                return [str(x) for x in z["names"]]
        return [sp.name for sp in ParquetFile(path).specs]

    def _read_file(self, name: str, fmeta: dict, want, schema: Schema,
                   apply_delvec: bool = True, times=None) -> dict:
        """{column: (values, validity or None, dictionary or None)} of the
        `want` columns of one data file, delete vector applied. A column
        the file does not hold (added after it was written, or dropped and
        added again) reads back as NULL. A `.parquet` file (this store's,
        or the JAX package's written through pyarrow) is read by the
        port's parquet reader, an `.npz` one (the port's format before
        parquet) by numpy. A list `times` gains a parquet file's reader
        times (ParquetFile.times)."""
        path = os.path.join(self._tdir(name), fmeta["file"])
        live_cols = fmeta.get("cols")
        n = int(fmeta["rows"])
        if path.endswith(".npz"):
            got = _read_npz(path, want, live_cols)
        else:
            got = _read_parquet(path, want, live_cols, schema, times)
        keep = None
        dv = fmeta.get("delvec")
        if apply_delvec and dv:
            keep = np.ones(n, dtype=bool)
            keep[np.asarray(dv, dtype=np.int64)] = False
        out = {}
        for c in want:
            f = schema.field(c)
            if c in got:
                a, v, d = got[c]
            else:
                a = _null_column(f.type, n)
                v = np.zeros(n, dtype=np.bool_)
                d = None
            if d is None and _has_text(f.type):
                d = np.zeros(0, dtype="<U1")
            if len(a) != n:
                raise ValueError(
                    f"{fmeta['file']}: column {c!r} holds {len(a)} rows, "
                    f"the manifest says {n}")
            if keep is not None:
                a = a[keep]
                v = None if v is None else v[keep]
            out[c] = (a, v, d)
        return out

    def load_table(
        self, name: str, columns=None, predicate: Optional[Expr] = None,
        rf_predicate: Optional[Expr] = None, files=None,
        with_stats: bool = False,
    ):
        """Read the table (optionally only some columns), pruning files whose
        zonemaps prove the predicate false (segment zonemap filtering analog).

        `rf_predicate` is the runtime-filter channel of two-phase scan
        pruning: a build-side key-bound predicate derived at plan time from
        a join's dimension subplan. It prunes with the SAME zonemap prover
        but its kills are counted separately (`rf_pruned`).

        `files` restricts the read to the named data files (a set of
        manifest file names).

        A VARCHAR column read back from several files gets one dictionary:
        the sorted distinct values of the rows read (and "" where a row is
        NULL), as the reference builds it from parquet."""
        from ..runtime import lifecycle
        from ..runtime.config import config

        fail_point("scan::load_table")
        lifecycle.checkpoint("scan::load_table")
        m = self.read_manifest(name)
        schema = schema_from_json(m["schema"])
        prune_enabled = config.get("enable_zonemap_pruning")
        pb = m.get("partition_by")
        part_zms = _partition_zonemaps(pb)
        chosen = []
        total, pruned, part_pruned, rf_pruned = 0, 0, 0, 0
        for rs in m["rowsets"]:
            for fmeta in rs["files"]:
                if files is not None and fmeta["file"] not in files:
                    continue
                total += 1
                if (prune_enabled and predicate is not None
                        and part_zms is not None and "part" in fmeta
                        and _zonemap_excludes(part_zms[fmeta["part"]],
                                              predicate)):
                    # manifest-only partition pruning: decided from the
                    # DECLARED range bounds, no per-file stats needed
                    part_pruned += 1
                    continue
                if prune_enabled and predicate is not None and _zonemap_excludes(
                    fmeta["zonemap"], predicate
                ):
                    pruned += 1
                    continue
                if (prune_enabled and rf_predicate is not None
                        and _zonemap_excludes(fmeta["zonemap"],
                                              rf_predicate)):
                    rf_pruned += 1
                    continue
                chosen.append(fmeta)
        stats = {
            "files": total, "pruned": pruned, "partition_pruned": part_pruned,
            "rf_pruned": rf_pruned,
        }
        with self._state_lock:
            self.last_scan_stats = stats
        if not chosen:
            sub = schema if columns is None else Schema(
                tuple(schema.field(c) for c in columns)
            )
            out = _empty_table(sub)
            return (out, stats) if with_stats else out
        want = list(columns) if columns else [f.name for f in schema]
        times = []  # each parquet file's reader times
        t0 = time.perf_counter()
        parts = _pmap(lambda fm: self._read_file(name, fm, want, schema,
                                                 times=times), chosen)
        t1 = time.perf_counter()
        out = _concat_parts(parts, want, schema)
        # thread-seconds over the files: reading their bytes, decompressing,
        # decoding the rest; then the wall of the files' reads and of the
        # merge into one table
        read = sum(t["read"] for t in times)
        split = dict(
            read_s=read, decompress_s=sum(t["decompress"] for t in times),
            decode_s=sum(t["values"] for t in times) - read,
            files_wall_s=t1 - t0, concat_s=time.perf_counter() - t1)
        return (out, {**stats, **split}) if with_stats else out


# --- the primary index --------------------------------------------------------


class _PKIndex:
    """The live rows' canonical keys, sorted and unique, as one numpy
    structured array (field i = key column i; numpy orders and compares
    such arrays field by field), with each key's (rowset index, file index,
    row position) in parallel arrays."""

    def __init__(self, keys: np.ndarray, ri, fi, pos):
        self.keys, self.ri, self.fi, self.pos = keys, ri, fi, pos

    def __len__(self):
        return len(self.keys)

    @classmethod
    def build(cls, kc: list, ri, fi, pos) -> "_PKIndex":
        """From key columns in file order: the last occurrence of a key
        wins (a dict filled in that order)."""
        n = len(ri)
        if n == 0:
            return cls(_struct(kc, np.arange(0)), ri, fi, pos)
        order = _key_order(kc)
        last = _is_last_of_run([c[order] for c in kc])
        sel = order[last]
        return cls(_struct(kc, sel), ri[sel], fi[sel], pos[sel])

    def _common(self, q: np.ndarray):
        """The two structured arrays at one dtype (VARCHAR fields widen to
        the longer width)."""
        if q.dtype == self.keys.dtype:
            return self.keys, q
        dt = np.dtype([(nm, np.result_type(self.keys.dtype[nm], q.dtype[nm]))
                       for nm in q.dtype.names])
        self.keys = self.keys.astype(dt)
        return self.keys, q.astype(dt)

    def lookup(self, kc: list):
        """(position in the index, found?) for each batch key."""
        n = len(kc[0])
        if not len(self.keys):
            return np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)
        keys, q = self._common(_struct(kc, np.arange(n)))
        at = np.searchsorted(keys, q)
        found = np.zeros(n, dtype=bool)
        inb = at < len(keys)
        found[inb] = keys[at[inb]] == q[inb]
        return at, found

    def remove(self, slots: np.ndarray):
        """Drop the entries at index positions `slots` (deleted rows)."""
        keep = np.ones(len(self.keys), dtype=bool)
        keep[slots] = False
        self.keys = self.keys[keep]
        self.ri, self.fi, self.pos = (self.ri[keep], self.fi[keep],
                                      self.pos[keep])

    def upsert(self, kc: list, korder, at, found, ri: int, fi, pos):
        """Point every batch key (unique; `korder` sorts them) at its new
        row (rowset `ri`, files `fi`, positions `pos`): hits in place, new
        keys inserted in order."""
        self.ri[at[found]] = ri
        self.fi[at[found]] = fi[found]
        self.pos[at[found]] = pos[found]
        miss = korder[~found[korder]]  # the new keys, sorted
        if not len(miss):
            return
        if not len(self.keys):
            self.keys = _struct(kc, miss)
            self.ri = np.full(len(miss), ri, dtype=np.int32)
            self.fi, self.pos = fi[miss], pos[miss]
            return
        keys, q = self._common(_struct(kc, miss))
        ins = np.searchsorted(keys, q)
        self.keys = np.insert(keys, ins, q)
        self.ri = np.insert(self.ri, ins, np.int32(ri))
        self.fi = np.insert(self.fi, ins, fi[miss])
        self.pos = np.insert(self.pos, ins, pos[miss])


def _struct(kc: list, rows) -> np.ndarray:
    """The key columns' rows `rows` as one structured array."""
    dt = np.dtype([(f"k{i}", c.dtype) for i, c in enumerate(kc)])
    out = np.empty(len(rows), dtype=dt)
    for i, c in enumerate(kc):
        out[f"k{i}"] = c[rows]
    return out


def _is_last_of_run(sorted_cols: list) -> np.ndarray:
    """For key columns sorted together: True where the next row's key
    differs (the last row of each run of equal keys)."""
    n = len(sorted_cols[0])
    last = np.ones(n, dtype=bool)
    if n > 1:
        same = np.ones(n - 1, dtype=bool)
        for c in sorted_cols:
            same &= c[:-1] == c[1:]
        last[:-1] = ~same
    return last


def _key_order(kc: list) -> np.ndarray:
    """Stable permutation sorting rows by their key tuple, field by field
    (rows with equal keys keep their order). Integer keys whose value
    ranges multiply into 63 bits pack into one int64 first, so one stable
    argsort (linear on keys that arrive sorted) replaces a lexsort."""
    if len(kc) == 1:
        return np.argsort(kc[0], kind="stable")
    if len(kc[0]) and all(c.dtype.kind == "i" for c in kc):
        span, packed = 1, np.zeros(len(kc[0]), dtype=np.int64)
        for c in reversed(kc):  # the last field is the least significant
            lo, hi = int(c.min()), int(c.max())
            if span * (hi - lo + 1) >= 1 << 63:
                break
            packed += (c - np.int64(lo)) * np.int64(span)
            span *= hi - lo + 1
        else:
            return np.argsort(packed, kind="stable")
    return np.lexsort(tuple(reversed(kc)))


def _dedupe_last(kc: list):
    """(row mask keeping the LAST occurrence of each key in batch order, or
    None when every key is distinct; the kept rows' positions, among the
    kept rows, in key order)."""
    n = len(kc[0])
    order = _key_order(kc)
    last = _is_last_of_run([c[order] for c in kc]) if n else np.zeros(0, bool)
    if last.all():
        return None, order
    keep = np.zeros(n, dtype=bool)
    keep[order[last]] = True
    return keep, (np.cumsum(keep) - 1)[order[last]]


def _canon_key_cols(data: HostTable, keys) -> list:
    """Canonical key columns of a batch: VARCHAR codes decoded to their
    text, everything else as int64 (float64 for floats). A NULL key
    raises."""
    out = []
    for k in keys:
        f = data.schema.field(k)
        v = data.valids.get(k)
        if v is not None and not v.all():
            raise ValueError(f"NULL value in PRIMARY KEY column {k!r}")
        text = _dict_text(f.dict) if f.type.is_string else None
        out.append(_canon_array(np.asarray(data.arrays[k]), text, f.type))
    return out


def _dict_text(d) -> np.ndarray:
    """A dictionary's values as a fixed-width unicode array."""
    if d is None or len(d) == 0:
        return np.zeros(0, dtype="<U1")
    return np.asarray(d.values, dtype=str)


def _canon_array(a: np.ndarray, text, t: T.LogicalType) -> np.ndarray:
    """Canonical key values of one column: VARCHAR codes as the text of
    dictionary `text`; floats as float64; everything else as int64."""
    if t.is_string:
        if len(text) == 0:
            return np.full(len(a), "", dtype="<U1")
        return text[np.clip(a, 0, len(text) - 1)]
    if t.is_decimal128 or t.is_wide:
        raise ValueError(f"{t!r} primary keys are not supported")
    if t.is_float:
        return np.asarray(a, dtype=np.float64)
    return np.asarray(a, dtype=np.int64)


def _key_query_column(vals: list, t: T.LogicalType) -> np.ndarray:
    """Canonical key values of probe tuples (one key column) in the
    index's layout: text for VARCHAR, float64 for floats, else int64."""
    if t.is_string:
        return np.asarray([str(v) for v in vals], dtype=str)
    if t.is_float:
        return np.asarray(vals, dtype=np.float64)
    return np.asarray(vals, dtype=np.int64)


def _concat_canon(parts: list, t: T.LogicalType) -> np.ndarray:
    if parts:
        return np.concatenate(parts)
    return np.zeros(0, dtype=("<U1" if t.is_string else
                              np.float64 if t.is_float else np.int64))


# --- data file helpers ---------------------------------------------------------


def _slice_table(data: HostTable, idx) -> HostTable:
    """Rows `idx` (an index array or a boolean mask) of a HostTable."""
    return HostTable(
        data.schema,
        {n: np.asarray(a)[idx] for n, a in data.arrays.items()},
        {n: np.asarray(v)[idx] for n, v in data.valids.items()},
    )


def _has_text(t: T.LogicalType) -> bool:
    """A column whose file holds a dictionary: VARCHAR, ARRAY<VARCHAR>."""
    return t.is_string or (t.is_array and t.elem.is_string)


def _null_column(t: T.LogicalType, n: int) -> np.ndarray:
    """The zero values of `n` NULL rows in a column's in-memory layout (a
    column a file does not hold)."""
    if t.is_string:
        return np.zeros(n, dtype=np.int32)
    if t.is_array:
        return np.zeros((n, 2), dtype=t.np_dtype)
    if t.is_decimal128:
        return np.zeros((n, 4), dtype=np.int64)
    if t.is_hll or t.is_bitmap:
        return np.zeros((n, t.wide_width), dtype=np.int8)
    return np.zeros(n, dtype=t.np_dtype)


def _read_npz(path: str, want, live_cols) -> dict:
    """{column: (values, validity or None, dictionary or None)} of the
    `want` columns an `.npz` data file holds (`names` lists its columns,
    `c<j>` holds column j's values, `v<j>` its validity where it has
    NULLs, `d<j>` a VARCHAR column's own dictionary)."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        names = [str(x) for x in z["names"]]
        have = set(names if live_cols is None else live_cols)
        for c in want:
            if c in have and c in names:
                j = names.index(c)
                out[c] = (z[f"c{j}"],
                          z[f"v{j}"] if f"v{j}" in z.files else None,
                          z[f"d{j}"] if f"d{j}" in z.files else None)
    return out


def _read_parquet(path: str, want, live_cols, schema: Schema,
                  times=None) -> dict:
    """{column: (values, validity or None, dictionary or None)} of the
    `want` columns a parquet data file holds, in the layout the JAX
    package's `HostTable.from_arrow` and `_conform` give of the same file:
    VARCHAR as int32 codes into the file's dictionary (a fixed-width
    unicode array), ARRAY as [rows, K+1] lanes (K the file's longest
    list, at least 1), HLL/BITMAP as an int8 row per value, NULL rows as
    zeros. A list `times` gains the reader's times."""
    pf = ParquetFile(path)
    names = [sp.name for sp in pf.specs]
    have = set(names if live_cols is None else live_cols)
    cols = [c for c in want if c in have and c in names]
    if not cols:
        return {}
    got = pf.read(cols, codes=True)
    if times is not None:
        times.append(pf.times)
    specs = {sp.name: sp for sp in pf.specs}
    out = {}
    for c in cols:
        col, t = got[c], schema.field(c).type
        build = specs[c].build
        if build == "string":
            codes, d = _text_codes(col.data)
            out[c] = (codes, col.valid, d)
        elif build == "binary":
            out[c] = (_bitmap(c, col)[1], col.valid, None)
        elif build == "list":
            lanes, d = _lanes(col.data, t)
            out[c] = (lanes, col.valid, d)
        else:
            out[c] = (np.asarray(col.data).astype(t.np_dtype, copy=False),
                      col.valid, None)
    return out


def _text(strings: tuple) -> np.ndarray:
    """The strings (buffer, offsets) as a fixed-width unicode array."""
    buf, offs = strings
    if not len(offs):
        return np.zeros(0, dtype="<U1")
    return native.strings_at(buf, offs, np.arange(len(offs))).astype(str)


def _text_codes(data) -> tuple:
    """(int32 codes, dictionary as a unicode array) of decoded strings: a
    Coded column's own dictionary, or the sorted distinct values."""
    if isinstance(data, Coded):
        return data.codes, _text(data.strings)
    vals, codes = native.dict_encode(*data)
    return codes, (vals.astype(str) if len(vals)
                   else np.zeros(0, dtype="<U1"))


def _lanes(lists: Lists, t: T.LogicalType) -> tuple:
    """A LIST column's rows as [rows, K+1] lanes of the element type (the
    length, then the elements; K the longest list, at least 1), and for
    string elements the dictionary their codes index."""
    lengths = lists.lengths
    n = len(lengths)
    d = None
    if t.elem.is_string:
        vals, d = _text_codes(lists.elems.data)
    else:
        vals = np.asarray(lists.elems.data)
    k = max(int(lengths.max()) if n else 0, 1)
    out = np.zeros((n, k + 1), dtype=t.np_dtype)
    out[:, 0] = lengths
    live = np.arange(k)[None, :] < lengths[:, None]
    out[:, 1:][live] = vals
    return out, d


def _concat_array_parts(cols: list, t: T.LogicalType):
    """One [rows, K+1] array column from per-file reads: the lanes padded to
    the widest file's K; string elements re-coded into the union of the
    files' dictionaries. Returns (lanes, dictionary or None)."""
    k = max(max((a.shape[1] for a, _, _ in cols), default=2), 2)
    padded = []
    for a, _, _ in cols:
        if a.shape[1] < k:
            a = np.concatenate(
                [a, np.zeros((len(a), k - a.shape[1]), dtype=a.dtype)],
                axis=1)
        padded.append(a)
    if not t.elem.is_string:
        return (np.concatenate(padded).astype(t.np_dtype, copy=False),
                None)
    texts = [d for _, _, d in cols if d is not None and len(d)]
    union = (np.unique(np.concatenate(texts)) if texts
             else np.zeros(0, dtype="<U1"))
    out = []
    for a, (_, _, d) in zip(padded, cols):
        a = a.astype(np.int64)
        if d is not None and len(d) and len(union):
            lut = np.searchsorted(union, d)
            live = np.arange(k - 1)[None, :] < a[:, :1]
            a[:, 1:] = np.where(live, lut[np.clip(a[:, 1:], 0, len(d) - 1)],
                                0)
        else:
            a[:, 1:] = 0
        out.append(a)
    return (np.concatenate(out).astype(t.np_dtype, copy=False),
            StringDict(union.astype(object)))


def _concat_parts(parts: list, want, schema: Schema) -> HostTable:
    """One HostTable of the declared schema from per-file column reads
    (`_read_file` results, in file order)."""
    fields, arrays, valids = [], {}, {}
    for c in want:
        f = schema.field(c)
        cols = [p[c] for p in parts]
        n_each = [len(a) for a, _, _ in cols]
        has_null = any(v is not None and not v.all() for _, v, _ in cols)
        if has_null:
            valid = np.concatenate([
                np.ones(n, dtype=np.bool_) if v is None else v
                for (_, v, _), n in zip(cols, n_each)])
        else:
            valid = None
        if f.type.is_array:
            arr, dct = _concat_array_parts(cols, f.type)
            fields.append(Field(c, f.type, f.nullable, dct))
        elif f.type.is_hll or f.type.is_bitmap:
            w = f.type.wide_width
            out = []
            for (a, _, _) in cols:
                if a.shape[1] > w:
                    raise ValueError(
                        f"{c}: stored sketch width {a.shape[1]} exceeds "
                        f"declared {f.type!r}")
                if a.shape[1] < w:
                    # files written before a precision change: pad the
                    # registers up to the declared width
                    a = np.concatenate(
                        [a, np.zeros((len(a), w - a.shape[1]), np.int8)],
                        axis=1)
                out.append(a)
            arr = np.concatenate(out).astype(np.int8, copy=False)
            fields.append(Field(c, f.type, f.nullable, None))
        elif f.type.is_string:
            used = []
            for (a, v, d) in cols:
                if not len(d) or not len(a):
                    continue
                live = a if v is None else a[v]
                if len(live):
                    used.append(d[np.flatnonzero(
                        np.bincount(live, minlength=len(d)))])
            if has_null:
                used.append(np.asarray([""]))
            union = (np.unique(np.concatenate(used)) if used
                     else np.zeros(0, dtype="<U1"))
            out = []
            for (a, v, d) in cols:
                if len(d) and len(union):
                    lut = np.minimum(np.searchsorted(union, d),
                                     len(union) - 1).astype(np.int32)
                    a = lut[a]
                else:
                    a = np.zeros(len(a), dtype=np.int32)
                if v is not None and not v.all():
                    a = a.copy()
                    a[~v] = np.searchsorted(union, "")
                out.append(a)
            arr = np.concatenate(out).astype(np.int32, copy=False)
            fields.append(Field(c, f.type, f.nullable,
                                StringDict(union.astype(object))))
        else:
            arr = np.concatenate([a for a, _, _ in cols]).astype(
                f.type.np_dtype, copy=False)
            fields.append(Field(c, f.type, f.nullable, None))
        arrays[c] = arr
        if valid is not None:
            valids[c] = valid
    return HostTable(Schema(tuple(fields)), arrays, valids)


def _empty_table(schema: Schema) -> HostTable:
    """Zero-row HostTable with typed arrays (wide layouts keep rank 2)."""
    def empty(f):
        if f.type.is_array:
            return np.zeros((0, 2), dtype=f.type.np_dtype)
        if f.type.is_decimal128:
            return np.zeros((0, 4), dtype=np.int64)
        if f.type.is_hll or f.type.is_bitmap:
            return np.zeros((0, f.type.wide_width), dtype=np.int8)
        return np.zeros(0, dtype=f.type.np_dtype)

    return HostTable(schema, {f.name: empty(f) for f in schema}, {})


# --- zonemaps ----------------------------------------------------------------


def _zonemap(data: HostTable, sel) -> dict:
    """min/max per numeric/date column (+ dict-decoded strings lexicographic)."""
    zm = {}
    for f in data.schema:
        if f.type.is_wide:
            continue  # no ordering on ARRAY/sketch planes
        a = data.arrays[f.name][sel]
        if len(a) == 0:
            continue
        v = data.valids.get(f.name)
        if v is not None:
            mask = v[sel]
            a = a[mask]
            if len(a) == 0:
                continue
        if f.type.is_string and f.dict is not None:
            lo = str(f.dict.values[int(a.min())]) if len(f.dict) else ""
            hi = str(f.dict.values[int(a.max())]) if len(f.dict) else ""
            zm[f.name] = {"min": lo, "max": hi, "str": True}
        elif f.type.is_numeric or f.type.is_temporal:
            ent = {"min": int(a.min()) if a.dtype.kind in "iub" else float(a.min()),
                   "max": int(a.max()) if a.dtype.kind in "iub" else float(a.max())}
            if f.type.is_decimal:
                # stored values are scaled ints; record the scale so the
                # comparator can scale logical literals before comparing
                ent["scale"] = f.type.scale
            zm[f.name] = ent
    return zm


def _partition_zonemaps(pb):
    """Synthetic per-partition zonemaps from DECLARED range bounds: partition
    i covers [prev_upper, upper) on the partition column, so the existing
    zonemap-vs-predicate prover doubles as the partition pruner."""
    if not pb:
        return None
    col = pb["column"]
    out = []
    lo = None
    for u in pb["uppers"]:
        hi = None if u is None else u  # exclusive; prover treats as max
        out.append({col: {
            "min": lo, "max": hi, "exclusive_max": u is not None,
        }})
        lo = u
    return out


def _zonemap_excludes(zm: dict, predicate: Expr) -> bool:
    """True only when the zonemap PROVES no row can satisfy the predicate.
    Conservative: unknown shapes never exclude. Handles conjuncts of
    col CMP literal (and literal CMP col) on zonemapped columns."""
    for conj in _conjuncts_of(predicate):
        if _conjunct_excludes(zm, conj):
            return True
    return False


def _conjuncts_of(e: Expr):
    if isinstance(e, Call) and e.fn == "and":
        for a in e.args:
            yield from _conjuncts_of(a)
    else:
        yield e


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


def _conjunct_excludes(zm: dict, c: Expr) -> bool:
    if isinstance(c, InList) and isinstance(c.arg, Col) and not c.negated:
        ent = zm.get(_base(c.arg.name))
        if ent is None:
            return False
        vals = [v for v in c.values if v is not None]
        if not vals:
            return False
        if "scale" in ent:
            if any(isinstance(v, str) for v in vals):
                return False
            vals = [v * (10 ** ent["scale"]) for v in vals]
        lo_, hi_ = ent["min"], ent["max"]
        excl_ = ent.get("exclusive_max", False)
        try:
            return all(
                (lo_ is not None and v < lo_)
                or (hi_ is not None and (v >= hi_ if excl_ else v > hi_))
                for v in vals
            )
        except TypeError:
            return False
    if not (isinstance(c, Call) and c.fn in _FLIP and len(c.args) == 2):
        return False
    a, b = c.args
    if isinstance(a, Lit) and isinstance(b, Col):
        a, b = b, a
        fn = _FLIP[c.fn]
    elif isinstance(a, Col) and isinstance(b, Lit):
        fn = c.fn
    else:
        return False
    ent = zm.get(_base(a.name))
    if ent is None or b.value is None:
        return False
    v = b.value
    if b.type is not None and isinstance(v, str):
        import datetime

        if b.type.kind is T.TypeKind.DATE:
            v = (datetime.date.fromisoformat(v) - datetime.date(1970, 1, 1)).days
        elif b.type.kind is T.TypeKind.DATETIME:
            v = (
                datetime.datetime.fromisoformat(v.replace(" ", "T"))
                - datetime.datetime(1970, 1, 1)
            ) // datetime.timedelta(microseconds=1)
    if "scale" in ent:
        # decimal zonemaps hold scaled ints; scale the logical literal
        if isinstance(v, str):
            return False
        v = v * (10 ** ent["scale"])
    lo, hi = ent["min"], ent["max"]
    # None bound = unbounded (synthetic partition maps); exclusive_max marks
    # a range partition's open upper bound
    excl = ent.get("exclusive_max", False)
    try:
        if fn == "eq":
            return ((lo is not None and v < lo)
                    or (hi is not None
                        and (v >= hi if excl else v > hi)))
        if fn == "lt":
            return lo is not None and lo >= v
        if fn == "le":
            return lo is not None and lo > v
        if fn == "gt":
            return hi is not None and hi <= v
        if fn == "ge":
            return hi is not None and (hi <= v if excl else hi < v)
    except TypeError:
        return False
    return False


def _base(qualified: str) -> str:
    return qualified.split(".", 1)[-1]


def backup(store: TabletStore, dest_dir: str, max_retries: int = 3) -> int:
    """Snapshot the whole store (manifests + rowset files + edit log) into an
    EMPTY dest_dir (reference analog: backup jobs snapshotting tablets to
    broker storage, fe backup/).

    Consistency: the edit log is copied FIRST (it only under-describes the
    immutable rowsets that follow); each table's manifest is written after
    its files. A concurrent rewrite (DELETE/UPDATE) that removes files while
    a table is being copied is detected (missing file) and that table's
    snapshot restarts from its fresh manifest."""
    import shutil

    if os.path.exists(dest_dir) and os.listdir(dest_dir):
        raise ValueError(f"backup target {dest_dir!r} is not empty")
    os.makedirs(dest_dir, exist_ok=True)
    if os.path.exists(store.log_path):
        shutil.copy2(store.log_path, os.path.join(dest_dir, "edit_log.jsonl"))
    n = 0
    # lint: checkpoint-exempt — offline admin utility (no in-package callers run it on an engine thread); there is no QueryContext to observe
    for t in store.table_names():
        src = store._tdir(t)
        dst = os.path.join(dest_dir, t)
        for attempt in range(max_retries):
            os.makedirs(dst, exist_ok=True)
            m = store.read_manifest(t)
            try:
                for rs in m["rowsets"]:
                    for fmeta in rs["files"]:
                        shutil.copy2(os.path.join(src, fmeta["file"]), dst)
                break
            except FileNotFoundError:
                # a concurrent rewrite replaced this table's rowsets;
                # restart from the fresh manifest
                shutil.rmtree(dst, ignore_errors=True)
        else:
            raise RuntimeError(
                f"table {t!r} kept changing during backup ({max_retries} tries)"
            )
        with open(os.path.join(dst, "manifest.json"), "w") as f:
            json.dump(m, f, indent=1)
        n += 1
    return n


def restore(backup_dir: str, dest_dir: str) -> int:
    """Materialize a backup as a fresh store directory."""
    import shutil

    if os.path.exists(dest_dir) and os.listdir(dest_dir):
        raise ValueError(f"restore target {dest_dir!r} is not empty")
    shutil.copytree(backup_dir, dest_dir, dirs_exist_ok=True)
    return len(TabletStore(dest_dir).table_names())
