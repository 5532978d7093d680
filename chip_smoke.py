"""End-to-end check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 10] [--ssb-sf 10] [--tpcds-sf 10] [--seed 42]
                          [--out DIR]

Drives the port's paths through `starrocks_tpu_torch` `Session.sql` and
holds every hand-written CUDA kernel against its plain torch version.
Before each phase after `build`, garbage is collected and the allocator's
cache emptied, and the memory still allocated on the card is kept, so a
phase's peak is its own; a query's peak stands beside the memory
allocated when it started. Phases, each of which must pass:

1. device: the card's name, count, and `nvidia-smi` name + power limit;
   fails without a CUDA device.
2. build: compile every kernel source with nvcc (sm_90a), in parallel,
   and the native lane's host library with the host C++ compiler.
3. tpch (the main path): generate TPC-H at --sf (the data is the engine's
   "weights", made from --seed) and run all 22 TPC-H queries and the
   statistical queries S1/S2 cold and warm under the kernel strategies
   (`SET segment_strategy = 'pallas'`, `join_probe_strategy =
   'pallas_sorted'`, `topn_strategy = 'pallas'`). Every kernel's launch
   count is set to 0 just before and read just after; Q9 and Q20 must
   launch probe_searchsorted, S1 and S2 segment_sum. The peak device
   memory of the path is kept. Then the same queries under `auto`, in a
   fresh session, for the times beside them. A traced warm run of each
   query under the strategy sets in TRACED_PATH_STRATEGIES reads the
   device's busy time from torch.profiler (none: CUTS).
4. hash_topn (the first slice's path, counts set to 0 before it and read
   after it): Q9 at --sf with the hash-join kernels (`join_probe_strategy
   = 'pallas'`), and Q2 at SF 1, where its ORDER BY key packs for the
   top-N kernel (at SF 10 it does not, in the reference too). The route
   each hash probe took and the path's peak device memory are kept.
5. topn (the top-N path): N1-N3 (`TOPN_QUERIES`: ORDER BY .. LIMIT over
   lineitem and orders, whose keys pack into one int64) at --sf, cold and
   warm under `topn_strategy = 'pallas'`, then under `auto` in a fresh
   session. Launch counts are set to 0 before each query; every cold run
   under `pallas` must launch topn_select. The rows must be equal between
   the two strategies, exactly. Each query's kernel shapes, wall times and
   the path's peak device memory are kept, and one traced warm run per
   query splits the operator's device time by its profiler spans
   (`sort::pack`, `topn::select`, `topn::reduce`, `topn::gather`; the
   top-N kernel's own device time is under the `top` kernels beside it).
6. breadth (the new SQL surface): B1-B8 (`BREADTH_QUERIES`: UNION ALL,
   INTERSECT, EXCEPT, UNION with a FROM-less row, DECIMAL(38) sums and
   extremes, group_concat, the numeric, date and string functions) at
   --sf cold and warm under the kernel strategies, then under `auto` in a
   fresh session; launch counts set to 0 and peak memory reset before
   each query (cold only under both: CUTS); rows equal
   between the two (B7's floats to a relative
   1e-4, or one unit in the rounded place of its rounded cells: its float
   sums take the f32 segment-sum kernel under `pallas`);
   traced warm runs cut as tpch's.
6b. functions (the rest of the scalar surface): F1-F11
   (`FUNCTION_QUERIES`: the function waves' maths, bit, date and string
   functions, arrays, UNNEST, lambdas with MAP and STRUCT, HLL/BITMAP
   sketches, percentiles, array_agg over supplier, and a Python UDF,
   `FUNCTION_UDF`, over supplier) at --sf, before `tpcds` drops that
   catalog, as breadth runs B1-B8. Rows equal between
   the strategy sets (F1's, F10's and F11's floats to a relative 1e-4:
   their sums take the f32 segment-sum kernel under `pallas`);
   segment_sum must launch in F1 and F10, topn_select in F3. Each run
   keeps F10's UDF host seconds (`udf_s`), F5's unnest capacity and the
   recompiles.
6c. spill (execution beyond device memory): SPILL_QUERIES over the same
   catalog with `batch_rows_threshold = spill_batch_rows = 2^23`, so
   lineitem (60,004,659 rows at SF 10) streams through the card in 8
   batches and orders in 2: batched aggregation (Q1, Q6, S1, S2, B7), the
   hybrid partitioned join (Q4, Q12, Q14, Q19, and Q12 again under
   `join_hybrid_strategy = 'grace'`), the spilled sort (N3; N1 not run:
   CUTS) and the spilled window (W1). Each
   query runs cold under the kernel strategies in a Session of its own
   (S1 warm too: the batched aggregation takes segment_sum from its
   second run on), then the batched aggregations (SPILL_AUTO) under
   `auto` in another, cold (CUTS); launch counts set to 0 and peak
   memory reset before each run. Each run keeps its wall, the executor's
   profile node (batches or partitions, resident, spilled and skew keys,
   host-to-device seconds and bytes, host partition seconds, the host
   lexsort's seconds, device-to-host syncs), the join counters, the peak
   device memory and the resident host memory, launches and shapes; a
   traced warm run under `auto` of the queries in SPILL_TRACED (none:
   CUTS). Rows
   must equal the same query's
   rows without the threshold (S1/S2/B7's f32 cells to a relative 1e-4,
   W1's unordered rows as a sorted list); SPILL_PARTS_LIVE must read 0
   after every run; segment_sum must launch.
7. ssb: SSB-flat generated at --ssb-sf (default 10: lineorder_flat of
   60,000,000 rows) and dropped after the phase; the 13 FLAT_QUERIES as
   in breadth, rows equal exactly. Then the native filter-sum lane:
   NL1-NL3 (q1.1-q1.3 summing lo_quantity * lo_discount, so that every
   column is an integer) under `segment_strategy = 'native'` must take
   the host lane and give the card's `auto` rows, and q1.1-q1.3 must
   decline it; the lane's host time stands beside the card's wall.
8. store (statements and storage): first the data directory the JAX
   package wrote (tests/data/torch_store/reference_dir, made by its
   make_store_dirs.py: its journal, manifests, pyarrow's SNAPPY parquet
   rowsets and plan-feedback sidecar) is copied and opened by a Session
   on the card, and every query of reference_answers.json must give the
   file's rows. Then the --sf data persisted in a TabletStore under a
   temporary directory (removed at the end; its bytes on disk and the
   kinds of its data files, which must all be parquet, are kept). Each
   table is made by CREATE TABLE with its
   generator types, PRIMARY KEY from TPCH_UNIQUE_KEYS and DISTRIBUTED BY
   HASH .. BUCKETS 32 (lineitem, orders, partsupp, part, customer), 4
   (supplier) or one bucket (nation, region), then loaded by INSERT INTO t
   SELECT * FROM a staging copy, which is dropped; each load is split into
   the SELECT on the card, the fetch, the primary-key index, the bucketing
   and the file writes (with their compress thread-seconds: the files are
   pyarrow's layout, SNAPPY pages from the host compressor); the data
   files' bytes print beside the card's name and power limit. A fresh
   Session over the directory (its replay timed; each table's first load
   split into the files' read, decompress and decode thread-seconds, their
   wall, and the merge into one table) runs Q5, Q9 and Q20 under `join_probe_strategy =
   'pallas_sorted'`, Q9 under `'pallas'`, S1 under `segment_strategy =
   'pallas'`, N1 under `topn_strategy = 'pallas'` and Q1 under `auto`,
   cold (file reads included) and warm, counts set to 0 before each; all
   five kernels must launch, and the rows must equal the in-memory
   catalog's (S1's floats to a relative 1e-4). The query cache
   (`enable_query_cache` on): Q1 cold (its partial tier aggregates every
   lineitem segment) and warm (a full-result hit), and QC1 (a
   scan-aggregate over orders) before the first upsert and after it, where
   only the segments the upsert touched (new delete vectors, the new
   rowset's files) aggregate again: the cache's hit, miss and recompute
   counters are kept and checked, and the rows must equal those with the
   cache off. Then DML on the stored
   tables and on an in-memory twin, each answer held to numpy over the
   generated arrays: a 1% upsert of orders (count unchanged, the price sum
   up by exactly 1.00 per key, two rowsets, that many delete-vector rows),
   a DELETE by date and an UPDATE of customer; Q3 and Q5 (`pallas_sorted`)
   after them equal the twin's. A second restart must give the same
   answers; then a second 1% upsert and `compact_table('orders')` (one
   rowset, no delete vectors left), and the answers again.
8a. ingest (loading): `orders` at --sf, every column as generated, loaded
   three ways into one Session whose other tables are the generated
   ones: (1) written as CSV (`storage/formats/csv.py write_csv`) and
   loaded with `Session.load_csv` into an empty table of the same
   schema; (2) written as a directory of INGEST_PARQUET_FILES parquet
   files by the store's writer (`storage/formats/parquet_write.py
   write_table`, PLAIN and uncompressed, INGEST_ROW_GROUPS row groups per
   file, DECIMAL columns annotated) and declared
   with CREATE EXTERNAL TABLE (read by the port's own reader); (3) the
   first rows held in memory and the last INGEST_STREAM_ROWS
   stream-loaded over `PUT /api/load/orders` (format json) in
   INGEST_BATCHES labelled micro-batches, one label repeated (a no-op);
   then one routine-load job tails an NDJSON file of those last rows into
   a side table. Each load's wall splits into write, parse or decode,
   append and commit, and upload to the card; the loaded table equals the
   generated one column for column. After each load Q3, Q5, Q18 and N3
   under the kernel strategies and Q9 under `join_probe_strategy =
   'pallas'` run cold and warm with `plan_verify_level = 'strict'`; every
   answer equals the generated catalog's and no finding is reported.
8b. lake (the lake files, read without pyarrow): the committed fixtures
   of tests/data/torch_formats/ (made by its make_fixtures.py with
   pyarrow, which this machine lacks; MANIFEST.json holds each one's rows
   and each column's type, NULL count and digest as the reference's
   `from_arrow` gives them). The lakes (LAKES): each ZSTD fixture
   (`orders` of TPC-H SF 0.1, parquet and ORC) copied LAKE_COPIES (100)
   times into a directory declared with CREATE EXTERNAL TABLE (15,000,000
   rows, SF 10's orders), the BROTLI parquet fixture and the LZO ORC one
   (the same orders) BROTLI_COPIES and LZO_COPIES (10) times. For each
   lake: the footers' row count, the decode seconds (split into
   decompress and decode values, thread-seconds summed over the files,
   and the dictionaries), the bytes the codec gave and their rate per
   decompress thread-second (and one file's alone, on one thread), the
   upload to the card, and whether every column equals the manifest x
   copies. Over the ZSTD and LZO lakes, N3 under `topn_strategy =
   'pallas'` and G1 (a GROUP BY over o_orderpriority) under `auto` run
   cold and warm, counts set to 0 before each; rows equal to the same
   statements over an in-memory twin (the generated orders, as many times
   over as the lake's copies);
   topn_select must launch, and the kernels phase checks it at the lakes'
   shapes. Then every other fixture (LZ4_RAW, the DELTA and
   BYTE_STREAM_SPLIT encodings, INT96/binary/LIST, ORC LZ4, ORC 0.11, ORC
   TIMESTAMP/BINARY/LIST with ZSTD and with LZO, the schema-evolved
   directory, the level-11 BROTLI text) is read once and held to its
   manifest.
8c. dist (distribution): the earlier paths' device memory released, a
   fresh Session(dist_shards=8) over the --sf catalog (the default
   thresholds shard every table but nation and region, and the large
   group-bys take the shuffle; no module global is patched) runs
   DIST_QUERIES (Q1, Q3, Q5, Q6, Q10, Q12, Q14, Q18, Q19, S1, S2, N1, the
   PARTITION BY window W2 and the range-exchange sort O1) cold, and those
   of DIST_WARM warm too, under the kernel strategies (but those of
   DIST_AUTO_ONLY), then those of DIST_WARM cold and warm and those of
   DIST_AUTO_ONLY cold under `auto` (CUTS), then Q3 and Q5 cold
   under the hash kernels; the 8 shards run in lockstep in this process,
   spread over the visible cards (parallel/mesh.shard_devices: all on
   cuda:0 with one card); the cards and each shard's card are printed.
   Counts set to 0 and peak memory reset before each
   run; each keeps its wall, peak, launches (and per card), fragments,
   exchanges and
   exchange rows and bytes. Rows must equal the single-shard Session's
   (exactly, floats to 6 significant digits, S1/S2's f32 cells to a
   relative 1e-4; tied ORDER BY rows as a multiset); all five kernels must
   launch, on every card that holds shards; the fragment stats must be
   non-zero; every placed input must sit on its shard's device. Then the
   dist_mixed sub-phase: DIST_QUERIES cold at SF 0.1 (the CPU tests'
   lowered thresholds) over the explicit mixed mesh (cuda:0, cpu) x 4,
   under the kernel strategies (Q1 and S2 not: CUTS) and under `auto`,
   rows equal to the
   single-shard Session's, every placed input on its shard's device,
   the kernels launched on cuda:0 only. Then the cluster
   sub-phase at SF 1: ClusterRuntime(n_workers=2, shards=2), worker i on
   cuda:(i % cards) (its card printed), runs Q3 cold and warm, rows
   equal to the in-process path's, at least 3 fragments on the workers.
8c'. dist_procs (the process mesh: one process per card, on one host or
   several): the layouts of procs_layouts, in turn. One card: two
   emulated hosts, each seeing cuda:0, one rank x 4 shards each (NCCL),
   then, in the same two processes, one host of 2 ranks x 4 shards
   sharing cuda:0 (gloo, its collectives staged through pinned host
   memory; PROCS_SHARED_RUNS). Four cards: one host of 4 ranks x 2 shards
   (the machine itself), then two emulated hosts of two cards each, (a)
   2 ranks a host x 2 shards and (b) 1 rank a host x 4 shards over its
   two cards. An emulated host is
   what a machine of its own looks like to a process: its own
   CUDA_VISIBLE_DEVICES block (its ranks see cuda:0..k-1), its own host
   name (init_multihost's `host=`) and NCCL_HOSTID, and NCCL's sockets on
   loopback with InfiniBand off (EMULATED_HOST_ENV), so that NCCL runs its
   network transport between hosts. Every layout's ranks (this script
   with --mesh-rank; a layout that runs in an earlier one's processes
   starts none) generate the --sf catalog beside the generate phase
   and wait. Then the single-shard rows of Q3, Q5, Q18, S1 and N1 (under
   `auto`), the card's memory freed, and each layout's ranks told to go:
   each joins one process group (runtime.cluster.init_multihost,
   local_device_count 8 / P, a group timeout of PROCS_GROUP_TIMEOUT_S),
   whose backend and each rank's cards the rule host_layout gives from
   every rank's host and visible cards (NCCL when every rank has a card
   of its own, collectives on the device tensors; gloo otherwise, staged
   through host memory), and runs its layout's runs through
   Session(dist_shards=8) on its own cards (PROCS_RUNS: Q3, Q5 and Q18
   cold and warm and S1 and N1 cold under the kernel strategies, Q3 and
   Q5 cold under the hash kernels, Q3, Q5 and Q18 cold under `auto`),
   counts set to 0 and each card's peak memory reset before each, then
   leaves the group and frees the card's memory. Each rank prints its
   backend, Mesh.hosts, Mesh.devices, its cards and, per query, the wall,
   its process's CPU seconds, attempts, scan and run seconds, the
   allocator's retries, launches per kernel and per card, Mesh.moves and
   its peak per card; each layout prints the host memory available
   before and after; its NCCL log (NCCL_DEBUG=INFO, a file a process)
   gives the transport of every channel, printed by whether it joins two
   hosts. Fails on a rank that exits non-zero or outlives
   PROCS_DEADLINE_S (killed; a failed rank's peers are killed at once),
   rows that differ from the single-shard rows, a backend, cards,
   Mesh.hosts or Mesh.devices other than the ones each layout writes out
   (procs_layouts; not derived from the rule under test), a kernel that
   does not launch in every rank on each of that rank's cards and on no
   other, or, between emulated hosts over NCCL, a channel over anything
   but the network (P2P or SHM: the emulation leaked) or no channel seen
   at all. Nothing is retried, and nothing falls back from NCCL to gloo.
8d. serve (the serving planes), in a child process of its own (this
   script with --serve-child) started with the port's lock-order witness
   on (SR_TPU_LOCK_WITNESS=1), so that every other phase runs and is
   timed with plain locks; the child generates the --sf catalog anew
   while the generate phase runs, waits until this phase tells it to go,
   and hands its record back as JSON. The catalog sits behind one ServingTier
   and its MySQL and HTTP front doors on loopback ports, beside a stored
   PRIMARY KEY table, orders_pk (orders at --sf, written through the
   store path's DDL into a temporary data_dir, auto-compaction off for the
   phase). The clients are real sockets: a protocol-10 MySQL client kept
   here (MySQLClient: COM_QUERY; COM_STMT_PREPARE/EXECUTE with binary
   rows) and
   http.client POST /query. An admin connection SETs the kernel
   strategies over the wire. Rounds: (1) the reference answers through
   the template Session, after which every kernel count is set to 0, so
   that the launches read at the end are the doors' alone; (2) cold (no
   result cache), SERVE_MYSQL_CLIENTS +
   SERVE_HTTP_CLIENTS clients each run SERVE_ANALYTIC once, rotated by
   client, at pool size 1 and then at SERVE_POOL: QPS and client-observed
   p50/p99 of each, the pool's queue waits and peak device memory; (3)
   the point lane: each MySQL client SERVE_POINT_UPDATES point UPDATEs of
   o_comment and SERVE_POINT_SELECTS prepared point SELECTs over its own
   seeded slice of the keys, each row held to a numpy lookup of the
   generated orders with that client's updates; (4) warm (result cache
   on): the analytic set twice per client, the second pass all on the
   inline fast path; then Q9 and Q20 under `join_probe_strategy =
   'pallas'`; (5) the lifecycle: KILL QUERY of S2 from the admin
   connection while S2 is held by a failpoint at its fetch checkpoint
   (its device memory back to its value before it, read once the
   server's threads are done with it, with no garbage collection), a
   query past
   `query_timeout_s` (its clock moved at dispatch), one past
   `query_mem_limit_bytes`, one queued behind a resource group of one
   slot, EXPLAIN ANALYZE of Q3, SHOW PROCESSLIST and the HTTP endpoints
   (/metrics, /api/queries, /api/query/<id>/profile, /api/audit; the
   ingest plane's /api/ingest answers 501). Checks: every answer over
   either door equals round 1's in row order (tables_agree's float rule);
   the typed errors arrive on the wire; the audit log holds one record
   per statement sent; after the tier's shutdown no query is registered,
   queued, admitted or charged, the card's allocated memory is back to
   its value after round 1 but for the DeviceCache's own placements, and
   the port's lock-order witness (on in the child) has no cycle;
   all five kernels launched on the path.
9. tpcds (windows and TPC-DS): the TPC-H catalog is dropped, then TPC-DS
   is generated at --tpcds-sf (default 10: store_sales 28.8M rows,
   inventory 295.8M; seed 11; every query fits the card at SF 10, so the
   output's `reduced` list is empty). All 99 queries (`ALL_QUERIES`) run
   under `auto`, cold (the 15 window queries cold and warm: the cut in
   CUTS); the 15 window queries and every query that launches a kernel
   (`KERNEL_RUN_QUERIES`) then run under the kernel strategies in a
   fresh session, cold, and the window queries also warm (CUTS) (24
   queries at a time cold, then warm,
   then traced: a Session keeps its last 64 plans), both with `max_recompiles` 32
   (TPCDS_KNOBS: q24 needs more than the default 10 at SF 1 and up).
   Counts set to 0 and peak memory reset
   before each query; each query keeps its wall, launches per kernel,
   each kernel's shapes and its peak memory, and a traced warm run (of
   the queries in TPCDS_TRACED, none: the cut in CUTS) its
   busy time, idle share and device time by the
   window operator's spans (`window::prefilter`, `window::sort`,
   `window::scan`, `window::frame`). Rows equal between the two: exactly, floats to 6
   significant digits, the float cells of the queries that launch
   segment_sum to a relative 1e-4 (f32 block sums); probe_searchsorted,
   topn_select and segment_sum must each launch.
10. kernels: each kernel on the card, at the shapes its path gave it and on
   edge cases (sentinels, duplicates, INT64_MIN/MAX, heavy slot
   collisions; for the top-N select ties, all-equal keys, dead rows,
   INT64_MIN runs, clustered keys (its 64-bit pass), live spans too wide
   for 64-bit keys (its pair kernel) and k across a lane's and a warp's
   sizes; for the
   hash kernels chains across the end of an inner table slice and of the
   table, T below and equal to a slice, N = 0, all-sentinel keys, M = 0,
   all-sentinel probes, tables of 2^26, 2^28 and 2^31 slots, each also
   with slices of 64 slots and a halo of 1, the tables held to the chain
   invariant and both probe routes to the plain version; for the
   sorted probe K < 4, K off multiples of 4/64/1024, probes equal to the
   search tree's separators, runs of 5/65/1025 equal keys, int64-max
   probes with and without a sentinel tail, each also with a deep tree),
   against its plain version: the integer kernels exactly (the probe also
   against torch.searchsorted(out_int32=True)); the sorted probe is checked
   at every shape its paths gave it and timed at the largest. The top-N
   select is timed and checked on every edge case at every shape its
   paths gave it (Q2's, N1-N3's), and its candidates' reduction is
   timed two ways at the largest: the full stable sort, and the threshold
   sort the port uses (`ops/sort.py first_kk_desc`), which must return the
   same indices. The f32 segment sum is checked at every shape its paths
   gave it (S1/S2's, B7's, the functions, spill and tpcds paths') and
   timed at the largest and at each functions, spill and tpcds shape; it adds
   in its own fixed order, not the plain version's block order, so it is
   held to an f64 sum of the same f32 values: within 1e-6 * sum |x| per
   (group, column), and bit-identical over two runs; its error against
   the plain version and the plain version's against f64 are reported
   beside it. Each kernel is timed with CUDA events beside its bound (and
   its share of it), its plain version and a library yardstick, and one
   call is traced with torch.profiler for its split by device kernel; the
   hash probe at each of Q9's probe counts by either route, with the keys
   the build deferred past their slice and both kernels' scratch.
11. card vs CPU: the 22 queries, S1/S2, B1-B8 and INTERSECT ALL / EXCEPT
   ALL (BAG_QUERIES) and F1-F11 at SF 0.1 on the card under the kernel
   strategies, Q1/Q2/Q3/Q9 under the hash kernels, N1-N3 under the top-N
   kernel, the 13 SSB-flat queries and the 15 TPC-DS window queries at SF
   0.1 under the kernel strategies and NL1-NL3 under the native lane, and
   SPILL_QUERIES with a 2^17-row batch budget (lineitem in 5 batches) on
   both sides,
   against the CPU (`device="cpu"`) under `auto`; rows must agree, in
   order: exactly, except floats to 6 significant digits — and S1/S2's,
   B7's and F1/F10/F11's floats to a relative 1e-4, since `pallas` sums
   their moments in f32 blocks (the reference's contract) while `auto`
   sums in f64.

The last lines of output are the `kernels` JSON line (each kernel's
`launches` over its first path, the functions, spill, ingest, lake,
dist, dist_procs (every rank), serve and tpcds paths) and
then
{"ok": true, "device": {...}}; the full record goes to DIR/chip_smoke.json.
`--phases kernels` (a comma list) runs those phases only, after `device`
and `build`; the kernels then take the main path's shapes from
DEFAULT_SHAPES, and the run ends without the `ok` line. `--kernels
topn_select` (a comma list of the kernels phase's checks: hash,
topn_select, probe_searchsorted, segment_sum) runs only those checks.
Imports only the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import time
import traceback
from pathlib import Path

HASH_KNOBS = {"join_probe_strategy": "pallas", "topn_strategy": "pallas"}
TOPN_KNOBS = {"topn_strategy": "pallas"}
STAT_REL = 1e-4  # S1/S2 floats, f32 block sums vs f64 (see phase 10)


def qname(q: str) -> str:
    """"9" -> "Q9"; "S1", "N1", "B1", "F1", "NL1", "q1.1", "Q12g", "W1" and
    "spill:Q1" stay as they are."""
    return q if q[0] in "SNBFqQW" or ":" in q else f"Q{q}"


def query_texts() -> dict:
    """{"1": .., "22": .., "S1": .., "S2": ..} from the port's own copy."""
    from starrocks_tpu_torch.storage.tpch_queries import QUERIES, STAT_QUERIES

    return {**{str(q): t for q, t in QUERIES.items()}, **STAT_QUERIES}


def topn_texts() -> dict:
    """{"N1": .., "N2": .., "N3": ..}: the top-N path's queries."""
    from starrocks_tpu_torch.storage.tpch_queries import TOPN_QUERIES

    return dict(TOPN_QUERIES)


# H100 SXM published peaks (NVIDIA data sheet) used for the bounds: HBM3
# bandwidth, and the non-tensor-core FP32 rate as the ceiling on scalar ALU
# operations (the kernels here do integer compares, hashes and moves).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# name: (source, the TPU kernel it replaces, the path that launches it)
KERNEL_META = {
    "hash_build": ("starrocks_tpu_torch/csrc/hash_table.cu",
                   "starrocks_tpu/ops/pallas_kernels.py:206", "hash_topn"),
    "hash_probe": ("starrocks_tpu_torch/csrc/hash_table.cu",
                   "starrocks_tpu/ops/pallas_kernels.py:266", "hash_topn"),
    "topn_select": ("starrocks_tpu_torch/csrc/topn_select.cu",
                    "starrocks_tpu/ops/pallas_kernels.py:112", "topn"),
    "probe_searchsorted": ("starrocks_tpu_torch/csrc/probe_searchsorted.cu",
                           "starrocks_tpu/ops/pallas_kernels.py:316", "tpch"),
    "segment_sum": ("starrocks_tpu_torch/csrc/segment_sum.cu",
                    "starrocks_tpu/ops/pallas_kernels.py:60", "tpch"),
}

# the main path's shapes at SF 10 (chip_smoke, PR 2), for a kernels phase
# run without the paths: hash (N, T) and (T, M), top-N (N, k) of Q2 at SF 1
# and of N1, sorted probe (K, N) of Q9, segment sum (N, M, G, block) of S1
DEFAULT_SHAPES = {"hash_build": (8_000_512, 1 << 24),
                  "hash_probe": (1 << 24, 9_001_984),
                  "topn_select": [(2048, 1024), (60_005_376, 1024)],
                  "probe_searchsorted": (8_000_512, 9_001_984),
                  "segment_sum": (60_005_376, 1, 1024, 1024)}
# Q9's two probe shapes (T, M) at SF 10: its cold run and its warm run (a
# tighter capacity)
Q9_PROBE_SHAPES = [(1 << 24, 2_483_200), (1 << 24, 9_001_984)]
SEG_REL = 1e-6  # segment_sum vs f64: |err| <= SEG_REL * sum |x| per cell
# the top-N kernel is timed at the shapes of at least this many rows and at
# the largest; smaller ones (launch overhead) are checked only (CUTS)
TOPN_TIMED_MIN_ROWS = 1 << 20

I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)
CARD = "cuda"  # the device every phase runs the port on
# The depth cuts that keep the whole script within its time (CUTS, printed
# at the end): the tpch, breadth, functions and ssb paths trace no warm run
# (the strategy sets in TRACED_PATH_STRATEGIES would be traced)
TRACED_PATH_STRATEGIES = ()
CUTS = ["tpch, breadth, functions and ssb: no traced warm runs (earlier "
        "traces are in PERF.md)", "breadth and functions: cold only (under "
        "`auto` too since the lake path)", "tpcds: no traced runs (the window "
        "queries' traces of earlier runs are in PERF.md), to make room for "
        "the ingest path", "spill: no traced runs (earlier ones are in "
        "PERF.md), to make room for the ingest path",
        "spill: every query but S1 cold only (SPILL_WARM; Q4, Q12, Q14, "
        "Q19, Q12 (grace) and W1 since the lake path, under `auto` its "
        "warm runs were within 5% of its cold ones in PR 13; Q1, Q6, S2, "
        "B7 and N3 under the kernel strategies since the store's "
        "reference directory: their warm runs are in PERF.md)",
        "ingest: the stream load in 5 PUTs of 40,000 rows (20 of 10,000 "
        "before the lake path, 10 of 20,000 before the store's reference "
        "directory; each commit rewrites the whole table)",
        "spill: N1 not run (SPILL_SKIPPED: 16.9 s of its 18.6 s were a host "
        "lexsort, PR 10; N3 drives the spilled sort), for the lake path",
        "kernels: the top-N kernel timed only at shapes of 2^20 rows or "
        "more and at the largest (the smaller ones are launch overhead); "
        "every shape still checked",
        "ingest: the routine-load job tails a side table (the answers held "
        "to the generated catalog leave no further batch for orders)",
        "tpcds: the non-window queries cold only (under the kernel "
        "strategies too since the lake path)",
        "store: no traced runs (earlier ones are in PERF.md)",
        "kernels: every check at every shape stays; the extra timings at "
        "the functions and tpcds paths' shapes are not repeated (earlier "
        "timings are in PERF.md); the spill path's shapes are timed",
        "dist: no traced runs; the `auto` runs share the kernel runs' "
        "Session (the shards' placements already on the card); warm runs of "
        "Q3, Q5 and Q18 only (DIST_WARM; Q1 and W2 cold only since the "
        "lake path, the rest since the store's reference directory), the "
        "cluster sub-phase Q3 only (Q18 before), and Q3/Q5 under the hash "
        "kernels; "
        "the kernels timed at the largest per-shard shape of each",
        "the untraced cold and warm runs and every kernel check stay, but "
        "for the warm runs named above",
        "dist_mixed: Q1 and S2 under `auto` only (MIXED_AUTO_ONLY; under "
        "the kernel strategies their CPU shards' one-hot operands took 8.3 "
        "and 9.5 s on the host; tests/test_torch_gpu.py runs them)",
        "spill: under `auto` the batched aggregations only (SPILL_AUTO: Q1, "
        "Q6, S1, S2, B7): the hybrid and grace joins, the spilled sort and "
        "window launch no kernel under either strategy set, and their "
        "`auto` runs took 23.9 s of PR 18's final run; for the dist_procs "
        "path",
        "dist: under `auto` Q3, Q5 and Q18 only (DIST_WARM), cold and warm "
        "(the other 11 cold runs took 5.0 s of PR 18's final run; every "
        "query still runs under the kernel strategies); for the dist_procs "
        "path",
        "dist: Q1, Q6, Q12, W2 and O1 cold under `auto` only "
        "(DIST_AUTO_ONLY: under the kernel strategies they launched no "
        "kernel on this path, and Q1's one-hot operands took 9.2 s of host "
        "work; their kernel runs took 14.5 s of a final run, PERF.md; the "
        "gpu "
        "test test_dist_mixed_mesh_matches_single_shard[kernels] holds all "
        "14 dist queries under the kernel strategies to the single-shard "
        "rows at SF 0.1 on the card); for the dist_procs path's second "
        "one-card layout",
        "dist_procs: on one card the shared-card gloo layout (2 ranks x 4 "
        "shards on cuda:0) runs Q3, S1 and N1 cold and Q3 warm under the "
        "kernel strategies and Q3 cold under the hash kernels "
        "(PROCS_SHARED_RUNS: every kernel, all_to_all and all_gather; "
        "earlier runs of Q5 and Q18 over gloo are in PERF.md), in the "
        "processes of the emulated hosts' layout, whose catalogs it reuses"]
TOPN_SF = 1.0  # Q2's top-N scale (see phase_hash_topn)
CPU_SF = 0.1   # the card-vs-CPU phase's scale (the CPU runs it too)
CPU_SPILL_ROWS = 1 << 17  # its spill queries' batch budget


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


# --- row comparison (bench._rows_match's float rule, copied) -----------------


def _norm_val(v):
    if v is None or v != v:
        return "\x00null"
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, (int, float)) or str(type(v).__module__) == "numpy":
        try:
            f = float(v)
        except (TypeError, ValueError):
            return str(v).split(" 00:00:00")[0]
        if f == int(f) and abs(f) < 1e15:
            return str(int(f))
        return f"{f:.6g}"
    return str(v).split(" 00:00:00")[0]


def _floats_agree(x: float, y: float, rel: float = 1e-6) -> bool:
    """6 significant digits: bench._rows_match's %.6g rule, with a relative
    `rel` guard for values that straddle a rounding boundary."""
    if _norm_val(x) == _norm_val(y):
        return True
    return abs(x - y) <= rel * max(abs(x), abs(y))


def tables_agree(a, b, rel: float = 1e-6, units=None) -> bool:
    """Two result tables, in row order: same columns, types and NULLs;
    DOUBLE/FLOAT values to 6 significant digits (or a relative `rel`, or
    for a column named in `units` one unit in its rounded place, whichever
    is larger); everything else exact — decimals as their scaled integers,
    dates as days, strings decoded."""
    import numpy as np

    if [f.name for f in a.schema] != [f.name for f in b.schema]:
        return False
    if a.num_rows != b.num_rows:
        return False
    n = a.num_rows
    for fa, fb in zip(a.schema, b.schema):
        if repr(fa.type) != repr(fb.type):
            return False
        va, vb = a.valids.get(fa.name), b.valids.get(fb.name)
        ma = np.ones(n, bool) if va is None else np.asarray(va, bool)
        mb = np.ones(n, bool) if vb is None else np.asarray(vb, bool)
        if not (ma == mb).all():
            return False
        xa, xb = a.arrays[fa.name][ma], b.arrays[fb.name][mb]
        if fa.type.is_string:
            xa, xb = fa.dict.decode(xa), fb.dict.decode(xb)
        if fa.type.is_float:
            unit = (units or {}).get(fa.name, 0.0) * (1 + 1e-9)
            if not all(_floats_agree(float(x), float(y), rel)
                       or abs(float(x) - float(y)) <= unit
                       for x, y in zip(xa, xb)):
                return False
        elif not (np.asarray(xa) == np.asarray(xb)).all():
            return False
    return True


# --- timing ------------------------------------------------------------------


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call over `reps` calls, CUDA events around the
    run after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, nops: float):
    """(least time in ms, what bounds it): bytes over HBM bandwidth vs
    operations over the scalar peak."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def device_split(fn, tries: int = 3) -> list:
    """One call of `fn` under torch.profiler after a warm-up call: [[device
    kernel name, ms], ...] in launch order. The profiler has come back
    without device events once in a long run, so it tries `tries` times;
    an empty list where it never saw any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    kern = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        if kern:
            break
    return [[e.name[:70], e.time_range.elapsed_us() / 1e3] for e in kern]


# --- phases ------------------------------------------------------------------


def phase_device(rec):
    import torch

    if not torch.cuda.is_available():
        raise PhaseError("no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    line = smi_line()
    cpu = _host_cpu()  # beside the host-side numbers (the lakes' decoders)
    log(f"device: {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(line)
    log(f"host: {cpu}, {os.cpu_count()} CPUs")
    rec["device"] = {"kind": name, "count": count, "nvidia_smi": line,
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "host_cpu": cpu, "host_cpus": os.cpu_count()}


def smi_line() -> str:
    """The card's name and power limit as `nvidia-smi` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        f"nvidia-smi failed: {smi.stderr.strip()}")


def _host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it: its model name (or the
    machine, where there is none), then the vendor, family and model
    numbers (x86) or implementer and part (Arm), which a sandbox that
    reports its model name as "unknown" still gives."""
    import platform

    info: dict = {}
    for ln in Path("/proc/cpuinfo").read_text().splitlines():
        k, _, v = ln.partition(":")
        info.setdefault(k.strip().lower(), v.strip())
    ids = ", ".join(f"{k} {info[k]}" for k in (
        "vendor_id", "cpu family", "model", "cpu implementer", "cpu part")
        if info.get(k))
    return f"{info.get('model name') or platform.machine()} ({ids})"


def phase_build(rec):
    from starrocks_tpu_torch import native
    from starrocks_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    logs = kernels.build_kernels(verbose=True)
    # the host libraries: the filter-sum lane's and the spill executors'
    # bucket function
    native.build_all()
    dt = time.perf_counter() - t0
    for name in kernels.SOURCES:
        kernels._lib(name)  # load: the build really produced a library
    for name, text in logs.items():
        for ln in text.splitlines():
            if any(w in ln.lower() for w in ("registers", "smem", "spill",
                                             "function properties",
                                             "error")):
                log(f"  {name}: {ln.strip()}")
    log(f"build: {sorted(logs)} built in {dt:.1f} s")
    rec["build_s"] = dt


def _settle():
    """Collect garbage and return the allocator's cached blocks before a
    phase, so that its peak memory is its own: [GB allocated on the card
    before, after]."""
    import gc

    import torch

    before = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated() / 1e9
    log(f"  {before:.2f} GB allocated on the card, {after:.2f} after "
        "collecting garbage")
    return [before, after]


def _snapshot(kernels):
    return {n: c["launches"] for n, c in kernels.counts().items()}


def _prof_view(prof) -> dict:
    """The flat record the phases keep of a query's RuntimeProfile: its
    counters by name (seconds where the unit is "s"), the phase seconds
    (`optimize_s`, `fetch_s`, the UDF bodies' `udf_s`, the native lane's
    `native_s`), `recompiles`, its infos, one dict per attempt (`scan_s`
    host->device copies, `run_s` operators + the attempt's one check
    read, `capacities`) and one per spill executor or cache child (its
    infos and counters)."""
    ctr = {k: v for k, (v, _u) in prof.counters.items()}
    view = dict(prof.infos)
    view.update({"counters": ctr, "recompiles": ctr.get("recompiles"),
                 "optimize_s": ctr.get("optimize"),
                 "fetch_s": ctr.get("fetch_results"),
                 "udf_s": ctr.get("udf"), "native_s": ctr.get("native")})
    attempts = []
    for c in prof.children:
        cc = {k: v for k, (v, _u) in c.counters.items()}
        if c.name.startswith("attempt_"):
            attempts.append({"scan_s": cc.get("scan_to_device", 0.0),
                             "run_s": cc.get("run", 0.0),
                             "capacities": c.infos.get("capacities", {})})
        else:
            view[c.name] = {**c.infos, **cc}
    view["attempts"] = attempts
    return {k: v for k, v in view.items() if v is not None}


def set_knobs(knobs: dict):
    from starrocks_tpu_torch.runtime.config import config

    for k, v in knobs.items():
        config.set(k, v)


def strategies(name: str) -> dict:
    """The knob values of the "kernels" or the "auto" strategy set."""
    from starrocks_tpu_torch.runtime import config

    return {"kernels": config.KERNEL_STRATEGIES,
            "auto": config.AUTO_STRATEGIES}[name]


def _run_queries(s, label, texts, out, shapes, kernels):
    """Cold then warm run of each query; per-run wall time, rows, kernel
    launches (delta of the counters) and executor step times."""
    import torch

    # the hash probe's launches by route (a tree whose probe has one route
    # keeps no such counter)
    def routes():
        return dict(getattr(kernels.hash_probe, "routes", {}))

    for run in ("cold", "warm"):
        for q, text in texts.items():
            before = _snapshot(kernels)
            routes_before = routes()
            for w in kernels.WRAPPERS.values():
                w.shapes.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = s.sql(text)
            got = res.rows()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            after = _snapshot(kernels)
            delta = {n: after[n] - before[n] for n in after}
            probe_routes = {r: v - routes_before[r]
                            for r, v in routes().items()
                            if v != routes_before[r]}
            for n, w in kernels.WRAPPERS.items():
                if delta[n]:
                    shapes[n] += sorted(w.shapes)
            prof = _prof_view(res.profile)
            out.setdefault(f"{qname(q)}@{label}", {})[run] = {
                "wall_s": wall, "rows": len(got),
                "launches": {n: v for n, v in delta.items() if v},
                "probe_routes": probe_routes,
                "shapes": {n: kernels.WRAPPERS[n].last_shape
                           for n, v in delta.items() if v},
                "recompiles": prof.get("recompiles"),
                "attempts": len(prof.get("attempts", ())),
                # host clock per executor step (scan = host->device column
                # copies, run = operators + the one check read per attempt,
                # then the result fetch)
                "optimize_s": prof.get("optimize_s"),
                "scan_s": sum(a["scan_s"] for a in prof["attempts"]),
                "run_s": sum(a["run_s"] for a in prof["attempts"]),
                "fetch_s": prof.get("fetch_s"),
                "head": [[str(v) for v in r] for r in got[:3]],
            }
            if probe_routes:
                log(f"  {qname(q)}@{label} {run}: hash probe routes "
                    f"{probe_routes} at (T, M) {kernels.hash_probe.last_shape}")
            log(f"  {qname(q)}@{label} {run}: {wall * 1e3:.1f} ms, "
                f"{len(got)} rows, "
                f"launches {out[f'{qname(q)}@{label}'][run]['launches']}, "
                f"recompiles {prof.get('recompiles')}")


def _launched(queries, key, kernel) -> int:
    return queries[key]["cold"]["launches"].get(kernel, 0)


def phase_tpch(rec, cat, sf):
    """The 22 TPC-H queries and S1/S2 at `sf`: under the kernel strategies
    (the main path: launch counts from 0, peak memory), then under `auto`
    in a fresh session; a traced warm run of each under both."""
    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session

    texts = query_texts()
    label = f"SF{sf:g}"
    out = {"sf": sf}
    for name in ("kernels", "auto"):
        knobs = strategies(name)
        s = Session(cat, device=CARD)
        set_knobs(knobs)
        shapes = {n: [] for n in kernels.WRAPPERS}
        queries: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        _run_queries(s, label, texts, queries, shapes, kernels)
        total = _snapshot(kernels)
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"tpch under {name}: launches {total}, peak device memory "
            f"{peak:.2f} GB")
        out[name] = {"knobs": knobs, "queries": queries, "launches": total,
                     "shapes": {n: sorted(set(v)) for n, v in shapes.items()},
                     "peak_mem_gb": peak}
        out[name]["trace"] = (trace_queries(s, texts)
                              if name in TRACED_PATH_STRATEGIES else None)
        del s
        torch.cuda.empty_cache()
    # the main path's counts and shapes
    out["launches"] = out["kernels"]["launches"]
    out["shapes"] = out["kernels"]["shapes"]
    rec["tpch"] = out
    main = out["kernels"]["queries"]
    for q, kern in (("9", "probe_searchsorted"), ("20", "probe_searchsorted"),
                    ("S1", "segment_sum"), ("S2", "segment_sum")):
        if _launched(main, f"{qname(q)}@{label}", kern) < 1:
            raise PhaseError(f"{qname(q)} did not launch {kern}")
    empty = [q for q in ("1", "9", "20", "S1", "S2")
             if main[f"{qname(q)}@{label}"]["cold"]["rows"] == 0]
    if empty:
        raise PhaseError(f"queries returned no rows: {empty}")
    for q in texts:
        key = f"{qname(q)}@{label}"
        if (main[key]["warm"]["rows"]
                != out["auto"]["queries"][key]["warm"]["rows"]):
            raise PhaseError(f"{key}: row counts differ between strategies")


def phase_hash_topn(rec, cat, sf, seed):
    """The first slice's path: Q9 at `sf` with the hash-join kernels, then
    Q2 at TOPN_SF. Q2 reaches the top-N kernel only where its ORDER BY key
    (s_acctbal, n_name, s_name, p_partkey) packs into 62 bits: 58 bits at
    SF 1, 64 at SF 10, where the reference and the port both take the
    lexsort. Launches are counted over both catalogs."""
    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import tpch_catalog

    texts = query_texts()
    t0 = time.perf_counter()
    small = tpch_catalog(sf=TOPN_SF, seed=seed)
    gen_small_s = time.perf_counter() - t0
    s = Session(cat, device=CARD)
    s2 = Session(small, device=CARD)
    set_knobs(HASH_KNOBS)
    shapes = {n: [] for n in kernels.WRAPPERS}
    queries: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    _run_queries(s, f"SF{sf:g}", {"9": texts["9"]}, queries, shapes, kernels)
    _run_queries(s2, f"SF{TOPN_SF:g}", {"2": texts["2"]}, queries, shapes,
                 kernels)
    total = _snapshot(kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"hash_topn launches: {total}, peak device memory {peak:.2f} GB")
    rec["hash_topn"] = {"sf": sf, "topn_sf": TOPN_SF,
                        "gen_topn_sf_s": gen_small_s, "queries": queries,
                        "launches": total, "peak_mem_gb": peak,
                        "shapes": {n: sorted(set(v)) for n, v in shapes.items()}}
    # the kernel routes, required of the cold runs (a warm run may plan a
    # tighter capacity: the reference's post-success tightening can leave
    # Q2's sort one top-N block wide, and then it takes the plain sort)
    q9 = queries[f"Q9@SF{sf:g}"]["cold"]["launches"]
    if q9.get("hash_build", 0) < 1 or q9.get("hash_probe", 0) < 1:
        raise PhaseError("Q9 did not launch the hash kernels")
    if _launched(queries, f"Q2@SF{TOPN_SF:g}", "topn_select") < 1:
        raise PhaseError("Q2 did not launch the top-N kernel")
    del s, s2, small
    torch.cuda.empty_cache()


def _run_each(s, label, texts, out, launches, tables, kernels,
              cold_only=()):
    """Cold then warm run of each query (the queries in `cold_only` cold
    only), every launch count set to 0 just before it and read just after
    (`launches` sums them, and each run keeps the shapes of every launch),
    and the device's peak memory reset before it and read after it."""
    import torch

    for run in ("cold", "warm"):
        for q, text in texts.items():
            if run == "warm" and q in cold_only:
                continue
            kernels.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 1e9
            t = time.perf_counter()
            res = s.sql(text)
            table = res.table
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() / 1e9
            got = _snapshot(kernels)
            for n, v in got.items():
                launches[n] += v
            tables[(label, q, run)] = table
            prof = _prof_view(res.profile)
            shapes = {n: sorted(kernels.WRAPPERS[n].shapes)
                      for n, v in got.items() if v}
            attempts = prof.get("attempts", ())
            out.setdefault(q, {})[run] = {
                "wall_s": wall, "rows": table.num_rows, "peak_mem_gb": peak,
                "base_mem_gb": base,
                "launches": {n: v for n, v in got.items() if v},
                "shapes": shapes, "recompiles": prof.get("recompiles"),
                "optimize_s": prof.get("optimize_s"),
                "scan_s": sum(a["scan_s"] for a in attempts),
                "run_s": sum(a["run_s"] for a in attempts),
                "fetch_s": prof.get("fetch_s"),
                "native_fused": prof.get("native_fused"),
                "native_s": prof.get("native_s"),
                "udf_s": prof.get("udf_s"),
                "unnest_caps": {k: v for k, v in (
                    attempts[-1]["capacities"] if attempts else {}).items()
                    if k.startswith("unnest_")},
            }
            log(f"  {q}@{label} {run}: {wall * 1e3:.1f} ms, {table.num_rows} "
                f"rows, peak {peak:.2f} GB (from {base:.2f}), launches "
                f"{out[q][run]['launches']}, shapes {shapes}, scan "
                f"{out[q][run]['scan_s']:.3f} s, run "
                f"{out[q][run]['run_s']:.3f} s"
                + (f", native lane {prof['native_s'] * 1e3:.1f} ms"
                   if prof.get("native_fused") else ""))


def _path_shapes(queries) -> dict:
    """{kernel: the distinct shapes of its launches} over a path's runs."""
    shapes: dict = {}
    for q in queries.values():
        for r in q.values():
            for n, v in r["shapes"].items():
                shapes.setdefault(n, set()).update(tuple(x) for x in v)
    return {n: sorted(v) for n, v in shapes.items()}


# the top-N operator's profiler spans (ops/sort.py)
TOPN_SPANS = ("sort::pack", "topn::select", "topn::reduce", "topn::gather")


def phase_topn(rec, cat, sf):
    """N1-N3 at `sf` under `topn_strategy = 'pallas'`, then under `auto` in
    a fresh session (see the module docstring, phase 5)."""
    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session

    texts = topn_texts()
    out = {"sf": sf}
    tables: dict = {}
    for name, knobs in (("pallas", TOPN_KNOBS), ("auto", strategies("auto"))):
        s = Session(cat, device=CARD)
        set_knobs(knobs)
        queries: dict = {}
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        _run_each(s, name, texts, queries, launches, tables, kernels)
        # the path's peak: the largest of its queries' peaks
        peak = max(r["peak_mem_gb"] for q in queries.values()
                   for r in q.values())
        log(f"topn under {name}: launches {launches}, peak device memory "
            f"{peak:.2f} GB")
        out[name] = {"knobs": knobs, "queries": queries, "launches": launches,
                     "peak_mem_gb": peak,
                     "trace": trace_queries(s, texts, TOPN_SPANS)}
        del s
        torch.cuda.empty_cache()
    main = out["pallas"]["queries"]
    out["launches"] = out["pallas"]["launches"]
    out["shapes"] = _path_shapes(main)
    rec["topn"] = out
    missed = [q for q in texts if main[q]["cold"]["launches"].get(
        "topn_select", 0) < 1]
    if missed:
        raise PhaseError(f"{missed} did not launch topn_select")
    differ = [f"{q} {run}" for q in texts for run in ("cold", "warm")
              if not tables_agree(tables[("pallas", q, run)],
                                  tables[("auto", q, run)], rel=0.0)]
    empty = [q for q in texts if main[q]["cold"]["rows"] == 0]
    if differ or empty:
        raise PhaseError(f"rows differ between pallas and auto: {differ}; "
                         f"no rows: {empty}")


def _strategy_pair(cat, texts, kernels, out, tables,
                   traced=("kernels", "auto"), warm=("kernels", "auto")):
    """Run `texts` cold and warm under the kernel strategies, then under
    `auto` in a fresh session (launch counts and peak memory per query;
    a strategy set not in `warm` runs cold only), with one traced warm run
    of each under the strategy sets in `traced`."""
    import torch

    from starrocks_tpu_torch.runtime.session import Session

    for name in ("kernels", "auto"):
        s = Session(cat, device=CARD)
        knobs = strategies(name)
        set_knobs(knobs)
        queries: dict = {}
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        _run_each(s, name, texts, queries, launches, tables, kernels,
                  () if name in warm else list(texts))
        peak = max(r["peak_mem_gb"] for q in queries.values()
                   for r in q.values())
        log(f"  under {name}: launches {launches}, peak device memory "
            f"{peak:.2f} GB")
        out[name] = {"knobs": knobs, "queries": queries, "launches": launches,
                     "peak_mem_gb": peak,
                     "trace": (trace_queries(s, texts) if name in traced
                               else None)}
        del s
        torch.cuda.empty_cache()
    # the kernel strategies' shapes, for the kernels phase
    out["shapes"] = _path_shapes(out["kernels"]["queries"])


def _differ(texts, tables, a, b, rel=None, units=None) -> list:
    """Queries whose rows differ between labels a and b (cold, and warm
    where both ran warm); exactly, or floats to a relative `rel[q]` (or
    the rounded place of `units[q]`) where given."""
    rel = rel or {}
    units = units or {}
    return [f"{q} {run}" for q in texts for run in ("cold", "warm")
            if (a, q, run) in tables and (b, q, run) in tables
            and not tables_agree(tables[(a, q, run)], tables[(b, q, run)],
                                 rel=rel.get(q, 0.0), units=units.get(q))]


def phase_ssb(rec, sf, seed):
    """SSB-flat at `sf`: the 13 FLAT_QUERIES over lineorder_flat under the
    kernel strategies, then under `auto`; rows equal exactly. Then the
    native filter-sum lane: NL1-NL3 under `segment_strategy = 'native'`
    must take it and give auto's rows; q1.1-q1.3 must decline it."""
    import gc

    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.datagen.ssb import ssb_catalog
    from starrocks_tpu_torch.storage.ssb_queries import (
        FLAT_QUERIES, NATIVE_QUERIES)

    t0 = time.perf_counter()
    cat = ssb_catalog(sf=sf, seed=seed)
    gen_s = time.perf_counter() - t0
    rows = {n: h.row_count for n, h in cat.tables.items()}
    log(f"SSB SF {sf:g} generated in {gen_s:.1f} s: {rows}")
    out = {"sf": sf, "seed": seed, "gen_s": gen_s, "rows": rows}
    tables: dict = {}
    _strategy_pair(cat, FLAT_QUERIES, kernels, out, tables,
                   traced=TRACED_PATH_STRATEGIES)
    differ = _differ(FLAT_QUERIES, tables, "kernels", "auto")
    # the native lane, then the same queries on the card under auto
    lane = {**NATIVE_QUERIES,
            **{q: FLAT_QUERIES[q] for q in ("q1.1", "q1.2", "q1.3")}}
    for name, knobs in (("native", {"segment_strategy": "native"}),
                        ("auto", strategies("auto"))):
        s = Session(cat, device=CARD)
        set_knobs(strategies("auto"))
        set_knobs(knobs)
        queries: dict = {}
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        _run_each(s, f"lane_{name}", lane, queries, launches, tables,
                  kernels)
        out[f"lane_{name}"] = {"knobs": knobs, "queries": queries,
                               "launches": launches}
        del s
        torch.cuda.empty_cache()
    differ += _differ(lane, tables, "lane_native", "lane_auto")
    took = out["lane_native"]["queries"]
    wrong = [q for q in lane for run in ("cold", "warm")
             if (took[q][run]["native_fused"] == "filter_sum")
             != q.startswith("NL")]
    for q in NATIVE_QUERIES:
        log(f"  {q}: native lane {took[q]['warm']['native_s'] * 1e3:.1f} ms "
            f"(host), card under auto "
            f"{out['lane_auto']['queries'][q]['warm']['wall_s'] * 1e3:.1f} ms "
            "(warm wall)")
    rec["ssb"] = out
    del cat
    gc.collect()
    if differ or wrong:
        raise PhaseError(f"rows differ: {differ}; lane taken or declined "
                         f"wrongly: {wrong}")


# B7's float sums reach the segment-sum kernel under `pallas`, in f32; its
# rounded cells s = round(.., 4) and pe = round(.., 3) may also differ by
# one unit in their rounded place where the true value lies on a rounding
# boundary (TRUCK's s: 4.79465)
BREADTH_REL = {"B7": 1e-4}
BREADTH_UNITS = {"B7": {"s": 1e-4, "pe": 1e-3}}


def phase_breadth(rec, cat, sf):
    """B1-B8 (`BREADTH_QUERIES`: UNION ALL, INTERSECT, EXCEPT, UNION,
    DECIMAL(38), group_concat, the scalar functions) at `sf` under the
    kernel strategies, then under `auto`; rows equal (B7's floats to a
    relative 1e-4, or one unit in the rounded place of its rounded cells:
    its float sums take the f32 segment-sum kernel under `pallas`)."""
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.storage.tpch_queries import BREADTH_QUERIES

    out = {"sf": sf}
    tables: dict = {}
    _strategy_pair(cat, BREADTH_QUERIES, kernels, out, tables,
                   traced=TRACED_PATH_STRATEGIES, warm=())
    rec["breadth"] = out
    differ = _differ(BREADTH_QUERIES, tables, "kernels", "auto", BREADTH_REL,
                     BREADTH_UNITS)
    empty = [q for q in BREADTH_QUERIES
             if out["kernels"]["queries"][q]["cold"]["rows"] == 0]
    if differ or empty:
        raise PhaseError(f"rows differ between strategies: {differ}; no "
                         f"rows: {empty}")


# the functions path: the queries whose float sums take the f32 segment-sum
# kernel under `pallas` (their float cells agree to a relative 1e-4), and
# the launches the path must show at SF 10
FUNCTION_REL = {"F1": STAT_REL, "F10": STAT_REL, "F11": STAT_REL}
FUNCTION_MUST_LAUNCH = (("F1", "segment_sum"), ("F10", "segment_sum"),
                        ("F3", "topn_select"))


def register_function_udf():
    """FUNCTION_UDF in the process-wide UDF registry (F10's f_udf), anew."""
    from starrocks_tpu_torch.runtime import udf
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import Catalog
    from starrocks_tpu_torch.storage.tpch_queries import FUNCTION_UDF

    udf.drop_udf("f_udf", if_exists=True)
    Session(Catalog(), device=CARD).sql(FUNCTION_UDF)


def phase_functions(rec, cat, sf):
    """F1-F11 (`FUNCTION_QUERIES`: the function waves, arrays, unnest,
    lambdas/MAP/STRUCT, sketches, percentiles, array_agg and a Python UDF)
    at `sf` under the kernel strategies, then under `auto`; rows equal (the
    FUNCTION_REL queries' floats to a relative 1e-4); segment_sum must
    launch in F1 and F10 and topn_select in F3."""
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime import udf
    from starrocks_tpu_torch.storage.tpch_queries import FUNCTION_QUERIES

    register_function_udf()
    out = {"sf": sf, "segment_sum_queries": sorted(FUNCTION_REL)}
    tables: dict = {}
    try:
        _strategy_pair(cat, FUNCTION_QUERIES, kernels, out, tables,
                       traced=TRACED_PATH_STRATEGIES, warm=())
    finally:
        udf.drop_udf("f_udf", if_exists=True)
    main = out["kernels"]["queries"]
    out["launches"] = out["kernels"]["launches"]
    for name in ("kernels", "auto"):
        q = out[name]["queries"]
        runs = [r for r in ("cold", "warm") if r in q["F5"]]
        log(f"  functions under {name}: F10 udf_s "
            f"{[q['F10'][r]['udf_s'] for r in runs]}, F5 unnest capacity "
            f"{[q['F5'][r]['unnest_caps'] for r in runs]}, recompiles "
            f"{[q['F5'][r]['recompiles'] for r in runs]}")
    rec["functions"] = out
    differ = _differ(FUNCTION_QUERIES, tables, "kernels", "auto",
                     FUNCTION_REL)
    empty = [q for q in FUNCTION_QUERIES
             if main[q]["cold"]["rows"] == 0]
    missed = [f"{q}:{k}" for q, k in FUNCTION_MUST_LAUNCH
              if main[q]["cold"]["launches"].get(k, 0) < 1]
    if differ or empty or missed:
        raise PhaseError(f"rows differ between strategies: {differ}; no "
                         f"rows: {empty}; kernels not launched: {missed}")


# the spill path: a 2^23-row batch budget, so lineitem (60,004,659 rows at
# SF 10) streams through the card in 8 batches and orders in 2; the f32
# float cells of S1, S2 and B7 (segment_sum under `pallas`) agree with the
# in-memory rows to a relative 1e-4 (B7's rounded cells to one unit)
SPILL_ROWS = 1 << 23
SPILL_REL = {"S1": STAT_REL, "S2": STAT_REL, **BREADTH_REL}
# not run (CUTS): N1, whose spilled sort launches no kernel and spent
# 16.9 s of its 18.6 s in a host lexsort over 60M rows (PR 10); N3 drives
# the spilled sort
SPILL_SKIPPED = ("N1",)
# a spill query's keys in the output: Q12 also runs under the grace join
SPILL_GRACE = {"Q12g": "Q12"}
UNORDERED = ("W1",)


def spill_knobs(rows: int) -> dict:
    return {"batch_rows_threshold": rows, "spill_batch_rows": rows}


def _host_rss_gb() -> float:
    """The process's resident host memory now (Linux /proc)."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def _host_available_gb() -> float:
    """The machine's available host memory now (MemAvailable, Linux
    /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _sorted_rows(table):
    return sorted(table.to_pylist(), key=lambda r: tuple(map(str, r)))


def _spill_agree(q, got, want, rel, units=None) -> bool:
    if q in UNORDERED:
        return got.num_rows == want.num_rows and \
            _sorted_rows(got) == _sorted_rows(want)
    return tables_agree(got, want, rel=rel, units=units)


def phase_spill(rec, cat, sf):
    """The spill path (see the module docstring, phase 6c): SPILL_QUERIES
    over the TPC-H catalog at `sf` with a 2^23-row batch budget, each cold
    and warm under the kernel strategies in a Session of its own, then
    those of SPILL_AUTO under `auto` in another (Q12 also under the grace
    join; the queries in SPILL_SKIPPED not run); rows equal to the same
    query's rows without the threshold; SPILL_PARTS_LIVE 0 after every
    query; segment_sum must launch."""
    import gc
    import resource

    import torch

    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.tpch_queries import SPILL_QUERIES

    spill_queries = {q: t for q, t in SPILL_QUERIES.items()
                     if q not in SPILL_SKIPPED}
    texts = {**spill_queries,
             **{g: SPILL_QUERIES[q] for g, q in SPILL_GRACE.items()}}
    out = {"sf": sf, "batch_rows": SPILL_ROWS,
           "host_peak_rss_gb_before": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9}
    failures = []
    # the rows without the threshold, under `auto`, in a Session of its own
    set_knobs(strategies("auto"))
    s0 = Session(cat, device=CARD)
    want, ref_s = {}, {}
    for q, text in spill_queries.items():
        t = time.perf_counter()
        want[q] = s0.sql(text).table
        ref_s[q] = time.perf_counter() - t
    out["in_memory_s"] = ref_s
    del s0
    gc.collect()
    torch.cuda.empty_cache()
    for g, q in SPILL_GRACE.items():
        want[g] = want[q]
    try:
        _spill_runs(texts, want, cat, out, failures)
    finally:
        set_knobs({**spill_knobs(0), "join_hybrid_strategy": "auto"})
    out["launches"] = out["kernels"]["launches"]
    out["shapes"] = _path_shapes(out["kernels"]["queries"])
    out["host_peak_rss_gb"] = (resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9)
    log(f"spill: kernel shapes {out['shapes']}, host peak resident memory "
        f"{out['host_peak_rss_gb']:.1f} GB (before the path "
        f"{out['host_peak_rss_gb_before']:.1f})")
    rec["spill"] = out
    if out["launches"]["segment_sum"] < 1:
        failures.append("segment_sum did not launch on the spill path")
    if failures:
        raise PhaseError(f"spill: {failures}")


def _spill_runs(texts, want, cat, out, failures):
    """The spill path's runs (phase_spill): each query in a Session of its
    own, under the kernel strategies, then (SPILL_AUTO) under `auto`."""
    import gc

    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.batched import SPILL_PARTS_LIVE
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.tpch_queries import SPILL_EXECUTORS

    for strategy in ("kernels", "auto"):
        queries: dict = {}
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        traces = {}
        for q, text in texts.items():
            if strategy == "auto" and q not in SPILL_AUTO:
                continue  # (CUTS)
            executor = SPILL_EXECUTORS[SPILL_GRACE.get(q, q)]
            hybrid = "auto"
            if q in SPILL_GRACE:
                executor, hybrid = "grace", "grace"
            s = Session(cat, device=CARD)
            set_knobs({**strategies(strategy), **spill_knobs(SPILL_ROWS),
                       "join_hybrid_strategy": hybrid})
            for run in ("cold", "warm"):
                if run == "warm" and (q not in SPILL_WARM
                                      or strategy == "auto"):
                    continue  # (CUTS)
                kernels.reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated() / 1e9
                t = time.perf_counter()
                res = s.sql(text)
                table = res.table
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                peak = torch.cuda.max_memory_allocated() / 1e9
                got = _snapshot(kernels)
                for n, v in got.items():
                    launches[n] += v
                prof = _prof_view(res.profile)
                node = dict(prof.get(executor) or {})
                shapes = {n: sorted(kernels.WRAPPERS[n].shapes)
                          for n, v in got.items() if v}
                r = queries.setdefault(q, {})[run] = {
                    "wall_s": wall, "rows": table.num_rows,
                    "peak_mem_gb": peak, "base_mem_gb": base,
                    "host_rss_gb": _host_rss_gb(),
                    "launches": {n: v for n, v in got.items() if v},
                    "shapes": shapes, "executor": executor, "node": node,
                    "counters": {k: v for k, v in prof.get(
                        "counters", {}).items() if k.startswith("join_")},
                    "recompiles": prof.get("recompiles"),
                    "optimize_s": prof.get("optimize_s"),
                    "fetch_s": prof.get("fetch_s"),
                    "parts_live": SPILL_PARTS_LIVE.value,
                }
                h2d = node.get("h2d_batches") or 0
                log(f"  {q}@{strategy} {run}: {wall * 1e3:.1f} ms, "
                    f"{table.num_rows} rows, peak {peak:.2f} GB (from "
                    f"{base:.2f}), {executor} "
                    + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                else f"{k} {v}" for k, v in node.items())
                    + (f", h2d {node['h2d_s'] / h2d * 1e3:.1f} ms a batch"
                       if h2d else "")
                    + f", launches {r['launches']}, shapes {shapes}")
                if not node:
                    failures.append(f"{q}@{strategy} {run}: {executor} "
                                    "did not run")
                if SPILL_PARTS_LIVE.value != 0:
                    failures.append(f"{q}@{strategy} {run}: "
                                    f"SPILL_PARTS_LIVE {SPILL_PARTS_LIVE.value}")
                rel = SPILL_REL.get(q, 1e-6) if strategy == "kernels" else 1e-6
                if not _spill_agree(q, table, want[q], rel,
                                    BREADTH_UNITS.get(q)):
                    failures.append(f"{q}@{strategy} {run}: rows differ "
                                    "from the in-memory path's")
            if strategy == "auto" and q in SPILL_TRACED:
                traces.update(trace_queries(s, {q: text}))
            del s
            gc.collect()
            torch.cuda.empty_cache()
        out[strategy] = {"queries": queries, "launches": launches,
                         "trace": traces or None}
        log(f"spill under {strategy}: launches {launches}")


# the spill queries traced (one warm run under `auto`): the batched
# aggregations and N3; the partitioned joins and W1 are host-bound (idle
# share 0.73-0.95 when traced) and their traces repeat seconds of
# host partitioning
# cut (CUTS); the set traced before: Q1, Q6, S1, S2, B7, N3
SPILL_TRACED = ()
# the one query run warm too (CUTS), under the kernel strategies: the
# batched aggregation launches segment_sum from its second run on, at
# both of the path's shapes
SPILL_WARM = ("S1",)
# the queries also run under `auto` (CUTS): the batched aggregations, whose
# routes differ between the strategy sets; the hybrid and grace joins, the
# spilled sort and the spilled window launch no kernel under either, so
# their `auto` runs repeated their kernel-strategy runs' code
SPILL_AUTO = ("Q1", "Q6", "S1", "S2", "B7")


# TPC-DS (the tpcds path): the generator's seed, and the window operator's
# profiler spans (ops/window.py)
TPCDS_SEED = 11
# q24's plan needs 11 capacity recompiles at SF 1 (in the JAX package too)
# and more at SF 10, past max_recompiles' default of 10; a higher limit
# changes no answer, only how many attempts a plan may take
TPCDS_KNOBS = {"max_recompiles": 32}
TPCDS_GROUP = 24  # queries run cold, warm and traced together
TPCDS_TRACED = ()  # cut (CUTS); the 15 WINDOW_QUERIES were traced before
WINDOW_SPANS = ("window::prefilter", "window::sort", "window::scan",
                "window::frame")


def phase_tpcds(rec, sf):
    """TPC-DS generated at `sf`: all 99 queries cold and warm under
    `auto`, then the 15 window queries and the queries that launch a
    kernel under the kernel strategies in a fresh session, with one traced
    warm run of each (device busy and idle share, device time by window
    span). Rows equal between the two: exactly, floats to 6 significant
    digits, the float cells of the queries that launch segment_sum to
    SEGMENT_SUM_REL (the f32 contract). probe_searchsorted, topn_select
    and segment_sum must each launch on the path."""
    import gc

    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.config import config
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.datagen.tpcds import tpcds_catalog
    from starrocks_tpu_torch.storage.tpcds_queries import (
        ALL_QUERIES, KERNEL_RUN_QUERIES, SEGMENT_SUM_QUERIES,
        SEGMENT_SUM_REL, WINDOW_QUERIES)

    t0 = time.perf_counter()
    cat = tpcds_catalog(sf=sf, seed=TPCDS_SEED)
    gen_s = time.perf_counter() - t0
    rows = {n: h.row_count for n, h in cat.tables.items()}
    host_gb = sum(sum(a.nbytes for a in h.table.arrays.values())
                  for h in cat.tables.values()) / 1e9
    log(f"TPC-DS SF {sf:g} generated in {gen_s:.1f} s, {host_gb:.2f} GB of "
        f"host arrays: {rows}")
    # every query runs at `sf`: none needs a smaller scale to fit the card
    out = {"sf": sf, "seed": TPCDS_SEED, "reduced": [], "gen_s": gen_s,
           "host_gb": host_gb, "rows": rows}
    tables: dict = {}
    before = {k: config.get(k) for k in TPCDS_KNOBS}
    runs = (("auto", ALL_QUERIES),
            ("kernels", {q: ALL_QUERIES[q] for q in KERNEL_RUN_QUERIES}))
    try:
        for name, texts in runs:
            s = Session(cat, device=CARD)
            set_knobs({**strategies(name), **TPCDS_KNOBS})
            queries: dict = {}
            launches = dict.fromkeys(kernels.WRAPPERS, 0)
            trace: dict = {}
            # a Session keeps the last 64 plans and their capacities: run
            # cold, warm and traced a group at a time, so that the warm and
            # traced runs find what the cold run learned
            names = list(texts)
            for i in range(0, len(names), TPCDS_GROUP):
                group = {q: texts[q] for q in names[i:i + TPCDS_GROUP]}
                # the non-window queries run cold only (CUTS)
                cold_only = [q for q in group if q not in WINDOW_QUERIES]
                _run_each(s, name, group, queries, launches, tables, kernels,
                          cold_only)
                traced = {q: t for q, t in group.items()
                          if q in TPCDS_TRACED}
                if traced:
                    trace.update(trace_queries(s, traced, WINDOW_SPANS))
            peak = max(r["peak_mem_gb"] for q in queries.values()
                       for r in q.values())
            log(f"tpcds under {name}: launches {launches}, peak device "
                f"memory {peak:.2f} GB")
            out[name] = {"knobs": strategies(name), "queries": queries,
                         "launches": launches, "peak_mem_gb": peak,
                         "trace": trace}
            del s
            torch.cuda.empty_cache()
    finally:
        set_knobs(before)
    out["launches"] = out["kernels"]["launches"]
    out["shapes"] = _path_shapes(out["kernels"]["queries"])
    rec["tpcds"] = out
    del cat
    gc.collect()
    differ = [f"{q} {run}" for q in KERNEL_RUN_QUERIES
              for run in ("cold", "warm") if ("kernels", q, run) in tables
              and not tables_agree(
                  tables[("kernels", q, run)],
                  tables.get(("auto", q, run), tables[("auto", q, "cold")]),
                  rel=SEGMENT_SUM_REL if q in SEGMENT_SUM_QUERIES else 1e-6)]
    missed = [k for k in ("probe_searchsorted", "topn_select", "segment_sum")
              if out["launches"][k] < 1]
    log(f"tpcds: float cells of {list(SEGMENT_SUM_QUERIES)} held to a "
        f"relative {SEGMENT_SUM_REL} (f32 segment sums); rows differ: "
        f"{differ}; kernels not launched: {missed}")
    if differ or missed:
        raise PhaseError(f"rows differ between strategies: {differ}; not "
                         f"launched: {missed}")


# the store path: buckets of each TPC-H table (nation and region: one)
STORE_BUCKETS = {"lineitem": 32, "orders": 32, "partsupp": 32, "part": 32,
                 "customer": 32, "supplier": 4}
# the store path's queries over the stored tables: (label, knobs, query);
# each of the five kernels is launched by at least one of them
STORE_RUNS = [
    ("sorted", {"join_probe_strategy": "pallas_sorted"}, "5"),
    ("sorted", {"join_probe_strategy": "pallas_sorted"}, "9"),
    ("sorted", {"join_probe_strategy": "pallas_sorted"}, "20"),
    ("hash", {"join_probe_strategy": "pallas"}, "9"),
    ("segment", {"segment_strategy": "pallas"}, "S1"),
    ("topn", {"topn_strategy": "pallas"}, "N1"),
    ("auto", {}, "1"),
]
# the DML step's queries, run on the stored tables and on the in-memory twin
STORE_AFTER = [("auto", {}, "3"),
               ("sorted", {"join_probe_strategy": "pallas_sorted"}, "5")]
# S1's f32 moment sums under `pallas`: the stored row order differs
STORE_REL = {"S1": STAT_REL}


def _store_ddl(name, schema) -> str:
    """CREATE TABLE of a generated TPC-H table: its column types, its
    PRIMARY KEY from TPCH_UNIQUE_KEYS, hash buckets from STORE_BUCKETS."""
    from starrocks_tpu_torch.storage.catalog import (
        TPCH_DISTRIBUTION, TPCH_UNIQUE_KEYS)

    cols = ", ".join(f"{f.name} {f.type!r}" + ("" if f.nullable
                                              else " NOT NULL")
                     for f in schema)
    pk = ", ".join(TPCH_UNIQUE_KEYS[name][0])
    ddl = f"CREATE TABLE {name} ({cols}, PRIMARY KEY({pk}))"
    if name in STORE_BUCKETS:
        ddl += (f" DISTRIBUTED BY HASH({TPCH_DISTRIBUTION[name][0]}) "
                f"BUCKETS {STORE_BUCKETS[name]}")
    return ddl


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def _exact(table, col: int = 0) -> int:
    """A one-row result's column as an exact integer (decimals as their
    scaled integers, DECIMAL(38) from its limbs)."""
    from starrocks_tpu_torch.column.host_table import _dec128_to_int

    f = table.schema.fields[col]
    a = table.arrays[f.name]
    return _dec128_to_int(a[0]) if f.type.is_decimal128 else int(a[0])


def _timed(s, text):
    """(result, wall seconds) of one statement, the card synchronized."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = s.sql(text)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


# the query cache's delta check over orders (the store path's upserts
# change orders, not lineitem): a scan-aggregate the partial tier caches
# per segment
QC1 = ("select o_orderstatus, count(*) c, sum(o_totalprice) s, "
       "avg(o_totalprice) a from orders group by o_orderstatus order by 1")


def _segment_files(sess, table) -> dict:
    """{data file: its delete-vector length} of a stored table."""
    m = sess.store.read_manifest(table)
    return {f["file"]: len(f.get("delvec") or ())
            for rs in m["rowsets"] for f in rs["files"]}


def _qcache_runs(sess, text, runs, want, failures, name) -> dict:
    """`text` with `enable_query_cache` on, once per run: wall, the cache's
    own counters, rows held to `want` (the rows with the cache off)."""
    import torch

    set_knobs({**strategies("auto"), "enable_query_cache": True})
    out = {}
    try:
        for run in runs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = sess.sql(text)
            table = res.table
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            prof = _prof_view(res.profile)
            counters = {k: v for k, v in prof["counters"].items()
                        if k.startswith("qcache_")}
            node = prof.get("qcache_partial") or {}
            out[run] = {"wall_s": wall, "counters": counters,
                        "segments_s": node.get("segments_s"),
                        "merge_final_s": node.get("merge_final_s")}
            log(f"  query cache {name} {run}: {wall * 1e3:.1f} ms, "
                f"{counters}")
            if not tables_agree(table, want):
                failures.append(f"query cache {name} {run}: rows differ "
                                "from the uncached rows")
    finally:
        set_knobs({"enable_query_cache": False})
    return out


def store_data_dir() -> Path:
    return Path(__file__).resolve().parent / "tests" / "data" / "torch_store"


def answer_value(v):
    """One cell of a result row in an answers file's form (tests/data/
    torch_store/reference_answers.json): Decimal and date/time values as
    their text, numpy scalars as Python values."""
    import datetime
    import decimal

    if v is None or isinstance(v, bool):
        return v
    for t in (str, int, float):  # numpy's str_ and float64 included
        if isinstance(v, t):
            return t(v)
    if isinstance(v, (list, tuple)):
        return [answer_value(x) for x in v]
    if isinstance(v, (decimal.Decimal, datetime.date)):
        return str(v)
    if hasattr(v, "item"):
        return answer_value(v.item())
    return str(v)


def answer_rows(rows) -> list:
    return [[answer_value(v) for v in r] for r in rows]


def answers_agree(rows, want: list, rel: float = 1e-6) -> bool:
    """Result rows equal to an answers file's rows (answer_rows' form):
    each value equal and of the same type, floats to a relative `rel`."""
    got = answer_rows(rows)
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not (a == b or abs(a - b) <= rel * max(abs(a), abs(b))):
                    return False
            elif a != b or type(a) is not type(b):
                return False
    return True


def _store_reference_dir(root: str, failures: list) -> dict:
    """The data directory the JAX package wrote (tests/data/torch_store/
    reference_dir: its journal, manifests, pyarrow's SNAPPY parquet files
    and its plan-feedback sidecar), copied under `root` and opened by a
    Session on the card: every query of reference_answers.json must give
    the file's rows."""
    import shutil

    from starrocks_tpu_torch.runtime.session import Session

    here = store_data_dir()
    ans = json.loads((here / "reference_answers.json").read_text())
    d = os.path.join(root, "reference_dir")
    shutil.copytree(here / "reference_dir", d)
    t = time.perf_counter()
    s = Session(device=CARD, data_dir=d)
    out = {"open_s": time.perf_counter() - t, "queries": {}}
    for q, text in ans["queries"].items():
        res, wall = _timed(s, text)
        ok = answers_agree(res.rows(), ans["answers"][q])
        out["queries"][q] = {"wall_s": wall, "equal": ok}
        if not ok:
            failures.append(f"reference directory: {q} differs from "
                            "reference_answers.json")
    out["answers_equal"] = all(v["equal"] for v in out["queries"].values())
    log(f"  reference directory: opened in {out['open_s'] * 1e3:.1f} ms, "
        f"{len(out['queries'])} answers equal the file: "
        f"{out['answers_equal']}")
    del s
    shutil.rmtree(d)
    return out


def phase_store(rec, cat, sf):
    """The store path (see the module docstring, phase 8): TPC-H at `sf`
    persisted in a TabletStore under a temporary directory, which is
    removed at the end."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import Catalog

    texts = {**query_texts(), **topn_texts()}
    out = {"sf": sf, "buckets": STORE_BUCKETS}
    rec["store"] = out
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")
    d = os.path.join(root, "db")
    log(f"store: {root}, {shutil.disk_usage(root).free / 1e9:.1f} GB free")
    failures = []
    try:
        # 0. the directory the reference wrote, opened on the card
        out["reference_dir"] = _store_reference_dir(root, failures)
        # 1. bulk load: INSERT INTO t SELECT * FROM stage_t, per table
        s = Session(device=CARD, data_dir=d)
        load = {}
        for name, h in cat.tables.items():
            s.sql(_store_ddl(name, h.schema))
            s.catalog.register(f"stage_{name}", h.table)
            n, wall = _timed(s, f"INSERT INTO {name} SELECT * FROM stage_{name}")
            prof = _prof_view(s.last_profile)
            attempts = prof.get("attempts", ())
            step = {"rows": n, "wall_s": wall,
                    "select_s": (prof.get("optimize_s", 0.0)
                                 + sum(a["scan_s"] + a["run_s"]
                                       for a in attempts)),
                    "fetch_s": prof.get("fetch_s"),
                    **{k: v for k, v in s.store.last_write_stats.items()
                       if k != "rows"}}
            step["other_s"] = wall - sum(step[k] for k in (
                "select_s", "fetch_s", "index_s", "bucket_s", "write_s"))
            load[name] = step
            s.sql(f"DROP TABLE stage_{name}")
            if n != h.row_count:
                failures.append(f"load {name}: {n} rows of {h.row_count}")
            log(f"  load {name}: {n} rows in {wall:.2f} s (select "
                f"{step['select_s']:.2f}, fetch {step['fetch_s']:.2f}, key "
                f"index {step['index_s']:.2f}, bucketing "
                f"{step['bucket_s']:.2f}, writes {step['write_s']:.2f}, "
                f"other {step['other_s']:.2f})")
        out["load"] = load
        out["load_s"] = sum(v["wall_s"] for v in load.values())
        out["bytes_after_load"] = _dir_bytes(d)
        out["data_files"] = sorted({os.path.splitext(f)[1]
                                    for _, _, fs in os.walk(d) for f in fs
                                    if f.startswith("rowset_")})
        if out["data_files"] != [".parquet"]:
            failures.append(f"data files {out['data_files']}, not parquet")
        out["write_s"] = sum(v["write_s"] for v in load.values())
        out["compress_s"] = sum(v.get("compress_s", 0.0)
                                for v in load.values())
        out["bucket_s"] = sum(v["bucket_s"] for v in load.values())
        out["data_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                                for r, _, fs in os.walk(d) for f in fs
                                if f.startswith("rowset_"))
        out["nvidia_smi"] = smi_line()
        log(f"  load: {out['load_s']:.1f} s (parquet writes "
            f"{out['write_s']:.1f} s, of it {out['compress_s']:.1f} "
            f"compress thread-seconds; bucketing {out['bucket_s']:.1f} s), "
            f"data files {out['data_bytes']} bytes, "
            f"{out['bytes_after_load'] / 1e9:.2f} GB on disk in "
            f"{out['data_files']} files ({out['nvidia_smi']})")
        del s
        gc.collect()
        torch.cuda.empty_cache()

        # 2. restart over the same directory: the stored catalog's peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        s2 = Session(device=CARD, data_dir=d)
        out["replay_s"] = time.perf_counter() - t
        log(f"  restart: replay {out['replay_s'] * 1e3:.1f} ms")

        # 3. the queries over the stored tables, cold then warm
        queries, tables = {}, {}
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        for label, knobs, q in STORE_RUNS:
            set_knobs(strategies("auto"))
            set_knobs(knobs)
            sub: dict = {}
            _run_each(s2, label, {q: texts[q]}, sub, launches, tables,
                      kernels)
            queries[f"{qname(q)}@{label}"] = sub[q]
        out["queries"] = queries
        # host seconds each stored table took to load from its files (in
        # the first query that read it: its cold wall includes them)
        out["file_load_s"] = {n: h.load_s for n, h in s2.catalog.tables.items()
                              if getattr(h, "load_s", None) is not None}
        # each first load's split: thread-seconds over the files reading
        # their bytes, decompressing and decoding; the wall of the files'
        # reads and of the merge into one table
        out["file_load"] = {
            n: {k: h.load_stats[k] for k in (
                "files", "read_s", "decompress_s", "decode_s",
                "files_wall_s", "concat_s")}
            for n, h in s2.catalog.tables.items()
            if getattr(h, "load_stats", None) is not None}
        log("  file loads: " + ", ".join(
            f"{n} {v:.2f} s" for n, v in out["file_load_s"].items()))
        for n, v in out["file_load"].items():
            log(f"    {n}: {v['files']} files, read {v['read_s']:.2f}, "
                f"decompress {v['decompress_s']:.2f}, decode "
                f"{v['decode_s']:.2f} thread-s; files {v['files_wall_s']:.2f}"
                f" s, merge {v['concat_s']:.2f} s ({out['nvidia_smi']})")
        out["launches"] = launches
        out["shapes"] = _path_shapes(queries)
        out["trace"] = None  # cut: see CUTS
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  store queries: launches {launches}, peak device memory "
            f"{out['peak_mem_gb']:.2f} GB")
        missed = [n for n in kernels.WRAPPERS if launches[n] < 1]
        if missed:
            failures.append(f"kernels not launched over stored tables: {missed}")
        # the same queries on the in-memory catalog: equal rows
        m = Session(cat, device=CARD)
        for label, knobs, q in STORE_RUNS:
            set_knobs(strategies("auto"))
            set_knobs(knobs)
            want = m.sql(texts[q]).table
            for run in ("cold", "warm"):
                if not tables_agree(tables[(label, q, run)], want,
                                    rel=STORE_REL.get(q, 1e-6)):
                    failures.append(f"{qname(q)}@{label} {run}: stored rows "
                                    "differ from the in-memory catalog's")
        del m
        torch.cuda.empty_cache()

        # 3b. the query cache over the stored tables: Q1 cold then warm (a
        # full-result hit), QC1 over orders before the upsert (every
        # segment aggregated and cached)
        qc = out["query_cache"] = {}
        qc_want = {}
        set_knobs(strategies("auto"))
        for q, text in (("Q1", texts["1"]), ("QC1", QC1)):
            qc_want[q] = s2.sql(text).table
        qc["Q1"] = _qcache_runs(s2, texts["1"], ("cold", "warm"),
                                qc_want["Q1"], failures, "Q1")
        if qc["Q1"]["warm"]["counters"].get("qcache_hits") != 1:
            failures.append("query cache: Q1's warm run was not a hit")
        qc["QC1_before"] = _qcache_runs(s2, QC1, ("cold",), qc_want["QC1"],
                                        failures, "QC1")
        segs_before = _segment_files(s2, "orders")

        # 4. DML on the stored tables and on an in-memory twin, each
        # answer held to numpy over the generated arrays
        twin = Catalog()
        for h in cat.tables.values():
            twin.register_handle(h)
        tw = Session(twin, device=CARD)
        o = cat.tables["orders"].table.arrays
        c = cat.tables["customer"].table
        okey = o["o_orderkey"].astype(np.int64)
        price = o["o_totalprice"].astype(np.int64)  # scale 2
        cut = int((np.datetime64("1993-01-01") - np.datetime64("1970-01-01"))
                  .astype(np.int64))
        kept = o["o_orderdate"].astype(np.int64) >= cut
        up1, up2 = okey % 100 == 7, okey % 100 == 13
        seg = c.schema.field("c_mktsegment").dict.encode_one("BUILDING")
        building = c.arrays["c_mktsegment"] == seg
        acct = c.arrays["c_acctbal"].astype(np.int64)
        want = {
            "upsert": (len(okey), int(price.sum()) + 100 * int(up1.sum())),
            "delete": int((~kept).sum()),
            "after_delete": (int(kept.sum()),
                             int((price + 100 * up1)[kept].sum())),
            "update": int(building.sum()),
            "acctbal": int(acct.sum()) + 100 * int(building.sum()),
            "upsert2": (int(kept.sum()),
                        int((price + 100 * up1 + 100 * up2)[kept].sum())),
        }
        ocols = [f.name for f in cat.tables["orders"].schema]

        def upsert_sql(mod):
            items = ", ".join("o_totalprice + 1" if n == "o_totalprice" else n
                              for n in ocols)
            return (f"INSERT INTO orders SELECT {items} FROM orders "
                    f"WHERE o_orderkey % 100 = {mod}")

        stmts = {"upsert": upsert_sql(7),
                 "delete": "DELETE FROM orders WHERE o_orderdate < "
                           "DATE '1993-01-01'",
                 "update": "UPDATE customer SET c_acctbal = c_acctbal + 1 "
                           "WHERE c_mktsegment = 'BUILDING'"}
        osum = "SELECT count(*), sum(o_totalprice) FROM orders"
        csum = "SELECT sum(c_acctbal) FROM customer"
        dml = {}

        def check_orders(sess, key, where):
            t = sess.sql(osum).table
            got = (_exact(t, 0), _exact(t, 1))
            if got != want[key]:
                failures.append(f"{where}: orders count, sum {got} != "
                                f"numpy's {want[key]}")
            return got

        def delvec_rows(sess):
            mf = sess.store.read_manifest("orders")
            return (len(mf["rowsets"]),
                    sum(len(f.get("delvec") or ())
                        for rs in mf["rowsets"] for f in rs["files"]))

        set_knobs(strategies("auto"))
        for label, sess in (("stored", s2), ("twin", tw)):
            res = {}
            n, wall = _timed(sess, stmts["upsert"])
            res["upsert"] = {"rows": n, "wall_s": wall}
            if label == "stored":
                res["upsert"].update(s2.store.last_write_stats)
                res["upsert"]["manifest"] = delvec_rows(s2)
                if res["upsert"]["manifest"] != (2, int(up1.sum())):
                    failures.append(f"upsert manifest (rowsets, delete-vector"
                                    f" rows) {res['upsert']['manifest']}, "
                                    f"want (2, {int(up1.sum())})")
            if n != int(up1.sum()):
                failures.append(f"{label} upsert: {n} rows")
            res["after_upsert"] = check_orders(sess, "upsert",
                                               f"{label} upsert")
            if label == "stored":
                # QC1 after the upsert: only the segments it touched (new
                # delete vectors, the new rowset's files) aggregate again
                set_knobs({"enable_query_cache": False})
                after_want = s2.sql(QC1).table
                r = qc["QC1_after"] = _qcache_runs(
                    s2, QC1, ("cold", "warm"), after_want, failures, "QC1")
                segs_after = _segment_files(s2, "orders")
                touched = sum(1 for f, dv in segs_after.items()
                              if segs_before.get(f) != dv)
                qc["segments"] = {"before": len(segs_before),
                                  "after": len(segs_after),
                                  "touched": touched}
                c = r["cold"]["counters"]
                if (c.get("qcache_partial_recomputed") != touched
                        or c.get("qcache_partial_hits")
                        != len(segs_after) - touched):
                    failures.append(f"query cache after the upsert: "
                                    f"{c}, {touched} of {len(segs_after)} "
                                    "segments touched")
                log(f"  query cache: QC1 after the upsert {c}; "
                    f"{touched} of {len(segs_after)} segments touched")
            n, wall = _timed(sess, stmts["delete"])
            res["delete"] = {"rows": n, "wall_s": wall}
            if n != want["delete"]:
                failures.append(f"{label} delete: {n} rows, numpy "
                                f"{want['delete']}")
            res["after_delete"] = check_orders(sess, "after_delete",
                                               f"{label} delete")
            n, wall = _timed(sess, stmts["update"])
            res["update"] = {"rows": n, "wall_s": wall}
            got = _exact(sess.sql(csum).table)
            if n != want["update"] or got != want["acctbal"]:
                failures.append(f"{label} update: {n} rows, sum {got}; numpy "
                                f"{want['update']}, {want['acctbal']}")
            dml[label] = res
            log(f"  DML {label}: " + ", ".join(
                f"{k} {v['rows']} rows in {v['wall_s']:.2f} s"
                for k, v in res.items() if isinstance(v, dict)))
        after = {}

        def after_queries(sess, tag):
            for label, knobs, q in STORE_AFTER:
                set_knobs(strategies("auto"))
                set_knobs(knobs)
                res, wall = _timed(sess, texts[q])
                after[(tag, q)] = res.table
                dml.setdefault("after_s", {})[f"{qname(q)}@{tag}"] = wall
            set_knobs(strategies("auto"))

        def same_after(a, b, where):
            for _, _, q in STORE_AFTER:
                if not tables_agree(after[(a, q)], after[(b, q)]):
                    failures.append(f"{where}: {qname(q)} rows differ")

        after_queries(s2, "stored")
        after_queries(tw, "twin")
        same_after("stored", "twin", "after DML, stored vs twin")

        # 5. restart again (durability), then a second upsert and compaction
        del s2
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        s3 = Session(device=CARD, data_dir=d)
        dml["replay2_s"] = time.perf_counter() - t
        check_orders(s3, "after_delete", "second restart")
        if _exact(s3.sql(csum).table) != want["acctbal"]:
            failures.append("second restart: customer sum differs")
        after_queries(s3, "restart")
        same_after("restart", "twin", "second restart vs twin")
        for label, sess in (("stored", s3), ("twin", tw)):
            n, wall = _timed(sess, upsert_sql(13))
            dml[label]["upsert2"] = {"rows": n, "wall_s": wall}
            check_orders(sess, "upsert2", f"{label} second upsert")
        dml["manifest_before_compaction"] = delvec_rows(s3)
        t = time.perf_counter()
        dml["compacted_rows"] = s3.store.compact_table("orders")
        dml["compact_s"] = time.perf_counter() - t
        dml["manifest_after_compaction"] = delvec_rows(s3)
        if (dml["compacted_rows"] != want["upsert2"][0]
                or dml["manifest_after_compaction"] != (1, 0)):
            failures.append(f"compaction: {dml['compacted_rows']} rows, "
                            f"manifest {dml['manifest_after_compaction']}")
        s3.catalog.get_table("orders").invalidate()
        s3.cache.invalidate("orders")
        check_orders(s3, "upsert2", "after compaction")
        after_queries(s3, "compacted")
        after_queries(tw, "twin2")
        same_after("compacted", "twin2", "after compaction vs twin")
        log(f"  restart 2: replay {dml['replay2_s'] * 1e3:.1f} ms; compaction "
            f"{dml['manifest_before_compaction']} -> "
            f"{dml['manifest_after_compaction']} (rowsets, delete-vector "
            f"rows), {dml['compacted_rows']} rows in {dml['compact_s']:.2f} s")
        out["dml"] = dml
        import resource

        # the process's peak resident host memory so far (KiB on Linux)
        out["host_peak_rss_gb"] = (resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9)
        out["bytes_at_end"] = _dir_bytes(d)
        out["files_at_end"] = sum(len(fs) for _, _, fs in os.walk(d))
        log(f"  store: {out['bytes_at_end'] / 1e9:.2f} GB in "
            f"{out['files_at_end']} files at the end; host peak resident "
            f"memory {out['host_peak_rss_gb']:.1f} GB")
        del s3, tw, twin
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    if failures:
        raise PhaseError(f"store: {failures}")


# --- the ingest path (phase 8a) ---------------------------------------------

INGEST_PARQUET_FILES = 8   # the external table's directory
INGEST_ROW_GROUPS = 2      # per parquet file
INGEST_STREAM_ROWS = 200_000
INGEST_BATCHES = 5         # PUT /api/load micro-batches of those rows
INGEST_REPEAT = 3          # the batch whose label is sent a second time
# (label, knobs, query): each load's queries, under plan_verify_level strict
INGEST_RUNS = [("kernels", {}, "3"), ("kernels", {}, "5"),
               ("kernels", {}, "18"), ("kernels", {}, "N3"),
               ("hash", {"join_probe_strategy": "pallas"}, "9")]


def ingest_parquet(ht, path: str, lo: int, hi: int) -> int:
    """Rows [lo, hi) of a HostTable as one of the ingest path's parquet
    files, by the store's writer: PLAIN and uncompressed, as the path's
    files have been since it began (its decode seconds stay comparable),
    INGEST_ROW_GROUPS row groups, DECIMAL columns annotated (an external
    table takes its types from the files). Returns the file's bytes."""
    from starrocks_tpu_torch.storage.formats.parquet_write import write_table

    return write_table(_rows_slice(ht, lo, hi), path, codec="UNCOMPRESSED",
                       dictionary=False,
                       row_group_rows=-(-(hi - lo) // INGEST_ROW_GROUPS),
                       annotate_decimals=True)


def _rows_slice(ht, lo: int, hi: int):
    """Rows [lo, hi) of a HostTable (views of its arrays)."""
    from starrocks_tpu_torch.column import HostTable

    return HostTable(ht.schema,
                     {k: v[lo:hi] for k, v in ht.arrays.items()},
                     {k: v[lo:hi] for k, v in ht.valids.items()})


def _json_rows(ht, lo: int, hi: int) -> list:
    """Rows [lo, hi) as JSON-able dicts: strings decoded, dates as
    'YYYY-MM-DD', decimals as their float values (the stream load's JSON
    body)."""
    import numpy as np

    cols = {}
    for f in ht.schema:
        a = ht.arrays[f.name][lo:hi]
        t = f.type
        if t.is_string:
            cols[f.name] = f.dict.values[a].tolist()
        elif t.is_decimal:
            cols[f.name] = (a / 10 ** t.scale).tolist()
        elif repr(t) == "DATE":
            cols[f.name] = np.datetime_as_string(
                a.astype("datetime64[D]")).tolist()
        else:
            cols[f.name] = a.tolist()
    names = list(cols)
    return [dict(zip(names, r)) for r in zip(*cols.values())]


def _same_table(got, want) -> list:
    """The columns where two HostTables differ (names, types, NULLs, and
    every value; strings by their decoded values)."""
    import numpy as np

    bad = []
    if [f.name for f in got.schema] != [f.name for f in want.schema]:
        return ["<columns>"]
    for fg, fw in zip(got.schema, want.schema):
        a, b = got.arrays[fg.name], want.arrays[fw.name]
        va, vb = got.valids.get(fg.name), want.valids.get(fw.name)
        ok = (repr(fg.type) == repr(fw.type) and len(a) == len(b)
              and (va is None or bool(np.all(va)))
              and (vb is None or bool(np.all(vb))))
        if ok and fg.type.is_string:
            dg, dw = list(fg.dict.values), list(fw.dict.values)
            ok = (dg == dw and bool(np.array_equal(a, b))) or bool(
                np.array_equal(fg.dict.values[a], fw.dict.values[b]))
        elif ok:
            ok = bool(np.array_equal(a, b))
        if not ok:
            bad.append(fg.name)
    return bad


def _upload_s(s, name: str) -> float:
    """Seconds to copy every column of a table to the card (the device
    cache keeps them for the queries that follow)."""
    import torch

    h = s.catalog.get_table(name)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s.cache.chunk_for(h, name, tuple(h.schema.names))
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _ingest_queries(s, load, texts, want, out, launches, failures, kernels):
    """Each INGEST_RUNS query cold and warm over the loaded orders under
    plan_verify_level strict: rows equal to the generated catalog's."""
    from starrocks_tpu_torch import analysis

    n0 = analysis.findings_total()
    tables: dict = {}
    sub: dict = {}
    try:
        for label, knobs, q in INGEST_RUNS:
            set_knobs({**strategies("kernels"), **knobs,
                       "plan_verify_level": "strict"})
            _run_each(s, label, {q: texts[q]}, sub, launches, tables,
                      kernels)
            for run in ("cold", "warm"):
                if not tables_agree(tables[(label, q, run)],
                                    want[(label, q)],
                                    STAT_REL if q.startswith("S") else 1e-6):
                    failures.append(f"ingest {load}: {qname(q)}@{label} "
                                    f"{run} rows differ from the generated")
    finally:
        set_knobs({**strategies("auto"), "join_probe_strategy": "auto",
                   "plan_verify_level": "off"})
    found = analysis.findings_total() - n0
    if found:
        failures.append(f"ingest {load}: {found} plan findings")
    out["queries"] = {f"{qname(q)}@{label}": sub[q]
                      for label, _, q in INGEST_RUNS}
    out["findings"] = found


def phase_ingest(rec, cat, sf):
    """The ingest path (see the module docstring, phase 8a)."""
    import gc
    import http.client
    import os
    import shutil
    import tempfile

    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.config import config
    from starrocks_tpu_torch.runtime.http_service import SqlHttpServer
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage import formats
    from starrocks_tpu_torch.storage.catalog import Catalog
    from starrocks_tpu_torch.storage.formats.csv import write_csv

    texts = {**query_texts(), **topn_texts()}
    orders = cat.get_table("orders").table
    n = orders.num_rows
    out = {"sf": sf, "rows": n, "files": INGEST_PARQUET_FILES,
           "row_groups": INGEST_ROW_GROUPS, "batches": INGEST_BATCHES,
           "stream_rows": INGEST_STREAM_ROWS}
    rec["ingest"] = out
    launches = dict.fromkeys(kernels.WRAPPERS, 0)
    failures = []
    root = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    ddl = "CREATE TABLE orders (" + ", ".join(
        f"{f.name} {f.type!r}" for f in orders.schema) + ")"
    # one Session over the generated tables: orders is replaced per load
    ic = Catalog()
    for name, h in cat.tables.items():
        ic.register(name, h.table, h.unique_keys, h.distribution)
    s = Session(ic, device=CARD)
    srv = None
    try:
        # the reference rows: the generated catalog's
        want, ref = {}, {}
        try:
            for label, knobs, q in INGEST_RUNS:
                set_knobs({**strategies("kernels"), **knobs})
                ref[(label, q)] = s.sql(texts[q]).table
        finally:
            set_knobs({**strategies("auto"), "join_probe_strategy": "auto"})
        want.update(ref)

        # 1. CSV through load_csv
        csv_out = {}
        path = os.path.join(root, "orders.csv")
        t = time.perf_counter()
        csv_out["bytes"] = write_csv(orders, path)
        csv_out["write_s"] = time.perf_counter() - t
        s.sql("DROP TABLE orders")
        s.sql(ddl)
        box = {}
        real = formats.csv.read_csv

        def timed_read(*a, **k):
            t0 = time.perf_counter()
            r = real(*a, **k)
            box["parse_s"] = time.perf_counter() - t0
            return r

        formats.csv.read_csv = timed_read
        try:
            t = time.perf_counter()
            got = s.load_csv("orders", path)
            total = time.perf_counter() - t
        finally:
            formats.csv.read_csv = real
        os.remove(path)
        csv_out["parse_s"] = box["parse_s"]
        csv_out["append_s"] = total - box["parse_s"]
        csv_out["upload_s"] = _upload_s(s, "orders")
        bad = _same_table(s.catalog.get_table("orders").table, orders)
        if got != n or bad:
            failures.append(f"ingest csv: {got} rows, columns differ {bad}")
        log(f"  ingest csv: {got} rows, write {csv_out['write_s']:.2f} s "
            f"({csv_out['bytes'] / 1e9:.2f} GB), parse "
            f"{csv_out['parse_s']:.2f} s, append {csv_out['append_s']:.2f} "
            f"s, upload {csv_out['upload_s']:.2f} s")
        _ingest_queries(s, "csv", texts, want, csv_out, launches, failures,
                        kernels)
        out["csv"] = csv_out

        # 2. parquet files as an external table
        pq_out = {}
        d = os.path.join(root, "orders_parquet")
        os.makedirs(d)
        t = time.perf_counter()
        size = 0
        for i in range(INGEST_PARQUET_FILES):
            lo = n * i // INGEST_PARQUET_FILES
            hi = n * (i + 1) // INGEST_PARQUET_FILES
            size += ingest_parquet(orders, os.path.join(
                d, f"part-{i:03d}.parquet"), lo, hi)
        pq_out["write_s"] = time.perf_counter() - t
        pq_out["bytes"] = size
        s.sql("DROP TABLE orders")
        s.sql(f"CREATE EXTERNAL TABLE orders FROM '{d}'")
        h = s.catalog.get_table("orders")
        pq_out["footer_rows"] = h.row_count  # footers only
        t = time.perf_counter()
        loaded = h.table
        pq_out["decode_s"] = time.perf_counter() - t
        pq_out["append_s"] = 0.0  # the files are the table
        pq_out["upload_s"] = _upload_s(s, "orders")
        bad = _same_table(loaded, orders)
        if pq_out["footer_rows"] != n or bad:
            failures.append(f"ingest parquet: {pq_out['footer_rows']} rows "
                            f"by the footers, columns differ {bad}")
        log(f"  ingest parquet: {INGEST_PARQUET_FILES} files "
            f"({size / 1e9:.2f} GB) written in {pq_out['write_s']:.2f} s, "
            f"decode {pq_out['decode_s']:.2f} s, upload "
            f"{pq_out['upload_s']:.2f} s")
        _ingest_queries(s, "parquet", texts, want, pq_out, launches,
                        failures, kernels)
        out["parquet"] = pq_out
        shutil.rmtree(d)

        # 3. stream load over PUT /api/load/orders, then a routine load
        st_out = {}
        head = n - INGEST_STREAM_ROWS
        s.sql("DROP TABLE orders")
        s.catalog.register("orders", _rows_slice(orders, 0, head))
        srv = SqlHttpServer(s, port=0).start()
        plane = s.ingest_plane()
        per = INGEST_STREAM_ROWS // INGEST_BATCHES
        write_s = put_s = commit_ms = 0.0
        receipts = []
        for b in range(INGEST_BATCHES + 1):
            i = b if b < INGEST_BATCHES else INGEST_REPEAT
            t = time.perf_counter()
            body = json.dumps(_json_rows(orders, head + i * per,
                                         head + (i + 1) * per)).encode()
            write_s += time.perf_counter() - t
            c = http.client.HTTPConnection("127.0.0.1", srv.port,
                                           timeout=300)
            try:
                t = time.perf_counter()
                c.request("PUT", f"/api/load/orders?format=json&label=b{i}",
                          body)
                r = c.getresponse()
                doc = json.loads(r.read())
                put_s += time.perf_counter() - t
            finally:
                c.close()
            if r.status != 200:
                failures.append(f"ingest stream batch {i}: {r.status} {doc}")
                break
            receipts.append(doc)
            if b < INGEST_BATCHES:
                commit_ms += float(doc.get("commit_ms", 0.0))
        replay = receipts[-1] if len(receipts) > INGEST_BATCHES else {}
        if not replay.get("replayed"):
            failures.append(f"ingest stream: the repeated label was not a "
                            f"no-op: {replay}")
        st_out.update(write_s=write_s, put_s=put_s,
                      append_s=commit_ms / 1000.0,
                      parse_s=put_s - commit_ms / 1000.0,
                      commits=plane.stats()["commits"])
        st_out["upload_s"] = _upload_s(s, "orders")
        bad = _same_table(s.catalog.get_table("orders").table, orders)
        if bad:
            failures.append(f"ingest stream: columns differ {bad}")
        log(f"  ingest stream: {INGEST_BATCHES} batches of {per} rows over "
            f"PUT in {put_s:.2f} s (bodies {write_s:.2f} s, commits "
            f"{commit_ms / 1e3:.2f} s), label b{INGEST_REPEAT} replayed, "
            f"upload {st_out['upload_s']:.2f} s")
        _ingest_queries(s, "stream", texts, want, st_out, launches,
                        failures, kernels)
        # the routine-load job: the same last rows as NDJSON, into a side
        # table, one driven tick (the poll thread's interval is an hour)
        feed = os.path.join(root, "feed.ndjson")
        with open(feed, "w") as fh:
            for r in _json_rows(orders, head, n):
                fh.write(json.dumps(r) + "\n")
        s.sql(ddl.replace("CREATE TABLE orders", "CREATE TABLE orders_feed"))
        config.set("ingest_poll_interval_s", 3600.0)
        spec = json.dumps({"table": "orders_feed", "path": feed,
                           "format": "json"})
        t = time.perf_counter()
        s.sql(f"ADMIN SET ingest_job 'feed' = '{spec}'")
        plane.poller.poll_once()
        st_out["routine_s"] = time.perf_counter() - t
        res = s.sql("select count(*), sum(o_totalprice), min(o_orderkey), "
                    "max(o_orderkey) from orders_feed").table
        got_feed = [_exact(res, c) for c in range(4)]
        keys = orders.arrays["o_orderkey"][head:]
        want_feed = [INGEST_STREAM_ROWS,
                     int(orders.arrays["o_totalprice"][head:].sum()),
                     int(keys.min()), int(keys.max())]
        s.sql("ADMIN SET ingest_job 'feed' = 'drop'")
        st_out["routine_rows"] = got_feed[0]
        if got_feed != want_feed:
            failures.append(f"ingest routine load: {got_feed} != {want_feed}")
        log(f"  ingest routine load: {got_feed[0]} rows in "
            f"{st_out['routine_s']:.2f} s")
        out["stream"] = st_out
    finally:
        config.set("ingest_poll_interval_s", 0.5)
        if srv is not None:
            srv.stop()
        shutil.rmtree(root, ignore_errors=True)
        del s
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    log(f"  ingest launches {launches}")
    for k in ("probe_searchsorted", "hash_build", "hash_probe",
              "topn_select"):
        if launches[k] < 1:
            failures.append(f"ingest: {k} was not launched")
    if failures:
        raise PhaseError("; ".join(failures))


LAKE_COPIES = 100  # copies of each ZSTD fixture: 15,000,000 rows
LAKE_FILES = ("orders_zstd.parquet", "orders_zstd.orc")
# the BROTLI fixture (orders SF 0.1) and its copies: 1,500,000 rows
LAKE_BROTLI, BROTLI_COPIES = "orders_brotli.parquet", 10
# the ORC LZO fixture (orders SF 0.1) and its copies: 1,500,000 rows
LAKE_LZO, LZO_COPIES = "orders_lzo.orc", 10
# (fixture, copies, whether N3 and G1 run over it), in the order read
LAKES = (*((f, LAKE_COPIES, True) for f in LAKE_FILES),
         (LAKE_BROTLI, BROTLI_COPIES, False), (LAKE_LZO, LZO_COPIES, True))
LAKE_QUERIES = {
    "N3": ("topn", None),
    "G1": ("auto", "SELECT o_orderpriority, count(*) c, sum(o_totalprice) "
                   "s, min(o_orderdate) d, max(o_custkey) k FROM orders "
                   "GROUP BY o_orderpriority ORDER BY o_orderpriority"),
}


def fixtures_dir() -> Path:
    return Path(__file__).resolve().parent / "tests" / "data" / "torch_formats"


def _manifest_mismatches(t, entry: dict, copies: int = 1) -> list:
    """The columns of HostTable `t` that differ from a fixture's manifest
    entry repeated `copies` times: names, types, NULL counts, and each
    column's digest over the first copy, every copy equal to the first."""
    import numpy as np

    from starrocks_tpu_torch.storage.formats import column_digest

    want = entry["columns"]
    if [f.name for f in t.schema] != [c["name"] for c in want]:
        return ["<columns>"]
    if t.num_rows != entry["rows"] * copies:
        return ["<rows>"]
    n = entry["rows"]
    bad = []
    for f, c in zip(t.schema, want):
        a, v = t.arrays[f.name], t.valids.get(f.name)
        nulls = 0 if v is None else int((~v).sum())
        ok = str(f.type) == c["type"] and nulls == c["nulls"] * copies
        if ok and copies > 1:
            ok = bool((a.reshape((copies, n) + a.shape[1:]) == a[:n]).all())
            if ok and v is not None:
                ok = bool((v.reshape(copies, n) == v[:n]).all())
        if ok:
            ok = column_digest(f, a[:n], None if v is None
                               else v[:n]) == c["digest"]
        if not ok:
            bad.append(f.name)
    return bad


def phase_lake(rec):
    """The lake path (see the module docstring, phase 8b)."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from starrocks_tpu_torch.column import HostTable
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import Catalog
    from starrocks_tpu_torch.storage.datagen.tpch import gen_tpch
    from starrocks_tpu_torch.storage.external import ExternalTableHandle

    here = fixtures_dir()
    man = json.loads((here / "MANIFEST.json").read_text())
    texts = {q: t or topn_texts()[q] for q, (_, t) in LAKE_QUERIES.items()}
    out = {"copies": LAKE_COPIES, "lakes": {}, "small": {}}
    rec["lake"] = out
    launches = dict.fromkeys(kernels.WRAPPERS, 0)
    failures = []
    # the in-memory twins: the generated orders, as many times over as
    # each queried lake's copies
    gen = gen_tpch(0.1, man["seed"])["orders"]
    want: dict = {}
    try:
        for copies in sorted({c for _, c, q in LAKES if q}):
            mem = Catalog()
            mem.register("orders", HostTable(gen.schema, {
                f.name: np.concatenate([gen.arrays[f.name]] * copies)
                for f in gen.schema}, {}))
            ms = Session(mem, device=CARD)
            for q, (knobs, _) in LAKE_QUERIES.items():
                set_knobs({**strategies("auto"),
                           **(TOPN_KNOBS if knobs == "topn" else {})})
                want[(copies, q)] = ms.sql(texts[q]).table
            del ms, mem
    finally:
        set_knobs(strategies("auto"))
    queries: dict = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_lake_")
    try:
        for name, copies, queried in LAKES:
            out["lakes"][name] = _lake(
                here, name, copies, man["fixtures"][name], root, failures,
                queried and (texts, {q: want[(copies, q)]
                                     for q in LAKE_QUERIES},
                             launches, queries))
        # every other fixture once, against its manifest
        for name, entry in man["fixtures"].items():
            if any(name == lake for lake, _, _ in LAKES):
                continue
            h = ExternalTableHandle("f", str(here / name))
            t = time.perf_counter()
            bad = _manifest_mismatches(h.table, entry)
            so = {"what": entry["what"], "rows": h.table.num_rows,
                  "decode_s": time.perf_counter() - t, "columns_equal":
                  not bad}
            out["small"][name] = so
            if bad:
                failures.append(f"lake fixture {name}: columns differ {bad}")
        log(f"  lake fixtures: {len(out['small'])} read, columns equal "
            f"their manifests: "
            f"{all(v['columns_equal'] for v in out['small'].values())}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["shapes"] = _path_shapes(queries)
    log(f"  lake launches {launches}, shapes {out['shapes']}")
    if launches["topn_select"] < 1:
        failures.append("lake: topn_select was not launched")
    if failures:
        raise PhaseError("; ".join(failures))


def _lake(here, name: str, copies: int, entry: dict, root: str,
          failures: list, queried) -> dict:
    """Fixture `name` copied `copies` times into a directory under `root`,
    declared with CREATE EXTERNAL TABLE and held to its manifest x copies:
    the footers' row count, the decode seconds (decompress and values
    thread-seconds over the files, and the dictionaries), the bytes the
    codec gave and their rate per decompress thread-second (and that of
    one copy read alone, on one thread), and the upload to the card.
    `queried`, when not false, is (texts, the in-memory twin's tables,
    launches, queries): N3 under `topn_strategy = 'pallas'` and G1 under
    `auto` then run cold and warm over the lake, each equal to the twin's
    rows, their launches and runs added to the last two."""
    import gc
    import shutil

    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import Catalog
    from starrocks_tpu_torch.storage.external import ExternalTableHandle

    lo = {"file": name, "copies": copies,
          "bytes": (here / name).stat().st_size}
    d = os.path.join(root, name.replace(".", "_"))
    os.makedirs(d)
    t = time.perf_counter()
    ext = Path(name).suffix
    for i in range(copies):
        shutil.copyfile(here / name, os.path.join(d, f"part-{i:03d}{ext}"))
    lo["copy_s"] = time.perf_counter() - t
    s = Session(Catalog(), device=CARD)
    s.sql(f"CREATE EXTERNAL TABLE orders FROM '{d}'")
    h = s.catalog.get_table("orders")
    t = time.perf_counter()
    lo["footer_rows"] = h.row_count  # footers only
    lo["footer_s"] = time.perf_counter() - t
    t = time.perf_counter()
    table = h.table
    lo["decode_s"] = time.perf_counter() - t
    lo.update({k: v for k, v in h.read_stats.items() if k != "wall_s"})
    lo["decompress_mb_per_s"] = (lo["decompressed_bytes"] / 1e6
                                 / max(lo["decompress_s"], 1e-9))
    one = ExternalTableHandle("one", str(here / name))  # one file, one thread
    one.table  # the read
    lo["one_file_mb_per_s"] = (one.read_stats["decompressed_bytes"] / 1e6
                               / max(one.read_stats["decompress_s"], 1e-9))
    del one
    lo["upload_s"] = _upload_s(s, "orders")
    bad = _manifest_mismatches(table, entry, copies)
    lo["columns_equal"] = not bad
    if lo["footer_rows"] != entry["rows"] * copies or bad:
        failures.append(f"lake {name}: {lo['footer_rows']} rows by the "
                        f"footers, columns differ {bad}")
    log(f"  lake {name} x{copies}: {lo['footer_rows']} rows by the footers "
        f"in {lo['footer_s'] * 1e3:.1f} ms; decode {lo['decode_s']:.2f} s "
        f"(thread-seconds: decompress {lo['decompress_s']:.3f}, values "
        f"{lo['values_s']:.2f}; dictionaries {lo['dict_s']:.2f} s); "
        f"decompressed {lo['decompressed_bytes']} bytes, "
        f"{lo['decompress_mb_per_s']:.1f} MB per decompress thread-second "
        f"(one file on one thread: {lo['one_file_mb_per_s']:.1f}); "
        f"upload {lo['upload_s']:.2f} s; columns equal the manifest "
        f"x{copies}: {not bad}")
    del table
    if queried:
        texts, want, launches, queries = queried
        sub: dict = {}
        tables: dict = {}
        try:
            for q, (knobs, _) in LAKE_QUERIES.items():
                set_knobs({**strategies("auto"),
                           **(TOPN_KNOBS if knobs == "topn" else {})})
                _run_each(s, knobs, {q: texts[q]}, sub, launches, tables,
                          kernels)
                for run in ("cold", "warm"):
                    if not tables_agree(tables[(knobs, q, run)], want[q]):
                        failures.append(f"lake {name}: {q} {run} rows "
                                        "differ from the in-memory twin")
        finally:
            set_knobs(strategies("auto"))
        lo["queries"] = sub
        queries.update({f"{name}:{q}": r for q, r in sub.items()})
        del tables
    del s, h
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(d)
    return lo


DIST_SHARDS = 8
DIST_REL = {"S1": STAT_REL, "S2": STAT_REL}
# run once more, cold, under the hash kernels (`join_probe_strategy =
# 'pallas'`): their local joins build and probe the open-addressing table
DIST_HASH = ("Q3", "Q5")
# run cold under `auto` alone: under the kernel strategies they launched no
# kernel on this path (a final run, PERF.md), and Q1's one-hot operands took
# 9.2 s of host work there (CUTS)
DIST_AUTO_ONLY = ("Q1", "Q6", "Q12", "W2", "O1")
# the cluster sub-phase: TPC-H at this scale, Q3 scheduled onto two
# worker processes of two shards each, on the same card (Q18: CUTS)
CLUSTER_SF = 1.0
CLUSTER_QUERIES = ("Q3",)
# the queries also run warm (the rest cold only: CUTS)
DIST_WARM = ("Q3", "Q5", "Q18")


# the one dist query with no ORDER BY: its rows are compared in a
# canonical order; every other query is held to its row order
DIST_UNORDERED = ("W2",)


def _canonical(table):
    """`table` with its rows in order of their printed forms (types and
    NULLs kept)."""
    import numpy as np

    from starrocks_tpu_torch.column import HostTable

    rows = [str(r) for r in table.to_pylist()]
    order = np.array(sorted(range(len(rows)), key=rows.__getitem__),
                     dtype=np.int64)
    return HostTable(table.schema,
                     {k: v[order] for k, v in table.arrays.items()},
                     {k: v[order] for k, v in table.valids.items()})


def _dist_agree(q, got, want, rel) -> bool:
    """tables_agree in row order; a DIST_UNORDERED query's tables first
    put in canonical order."""
    if q in DIST_UNORDERED:
        got, want = _canonical(got), _canonical(want)
    return tables_agree(got, want, rel=rel)


def phase_dist(rec, cat, sf):
    """The distributed path (see the module docstring, phase 8c): a fresh
    Session(dist_shards=8) over the TPC-H catalog at `sf`, DIST_QUERIES
    cold and DIST_WARM warm under the kernel strategies, DIST_WARM cold
    and warm under `auto`, then DIST_HASH cold under the hash kernels;
    rows equal to the single-shard Session's; all five kernels must
    launch; the fragment stats must be non-zero. Then the cluster
    sub-phase."""
    import gc

    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

    out = {"sf": sf, "shards": DIST_SHARDS}
    failures = []
    # the single-shard path's rows under `auto`, in a Session of its own
    set_knobs(strategies("auto"))
    s1 = Session(cat, device=CARD)
    want, ref_s = {}, {}
    for q, text in DIST_QUERIES.items():
        t = time.perf_counter()
        want[q] = s1.sql(text).table
        ref_s[q] = time.perf_counter() - t
    out["single_shard_cold_s"] = ref_s
    del s1
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict.fromkeys(kernels.WRAPPERS, 0)
    per_card = {n: {} for n in kernels.WRAPPERS}
    shapes = {n: set() for n in kernels.WRAPPERS}
    queries: dict = {}
    s8 = Session(cat, device=CARD, dist_shards=DIST_SHARDS)
    mesh = s8._executor().mesh
    out["cards"] = [str(d) for d in mesh.cards]
    out["shard_cards"] = [str(d) for d in mesh.devices]
    log(f"dist: {DIST_SHARDS} shards on {len(mesh.cards)} of "
        f"{torch.cuda.device_count()} cards {out['cards']}; shard s on "
        f"{out['shard_cards']}")
    # under `auto` the DIST_WARM queries, and cold those of DIST_AUTO_ONLY
    # in place of their kernel runs (CUTS)
    runs = [(st, run, q) for st in ("kernels", "auto")
            for run in ("cold", "warm") for q in DIST_QUERIES
            if q in DIST_WARM or run == "cold" and (
                (st == "kernels") != (q in DIST_AUTO_ONLY))]
    runs += [("hash", "cold", q) for q in DIST_HASH]
    try:
        for strategy, run, q in runs:
            knobs = (strategies("kernels") if strategy != "auto"
                     else strategies("auto"))
            if strategy == "hash":
                knobs = {**knobs, "join_probe_strategy": "pallas"}
            set_knobs(knobs)
            kernels.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 1e9
            t = time.perf_counter()
            res = s8.sql(DIST_QUERIES[q])
            table = res.table
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() / 1e9
            got = _snapshot(kernels)
            for n, v in got.items():
                launches[n] += v
                if v:
                    shapes[n].update(kernels.WRAPPERS[n].shapes)
            for n, cards in kernels.launches_per_card().items():
                for c, v in cards.items():
                    per_card[n][c] = per_card[n].get(c, 0) + v
            prof = _prof_view(res.profile)
            ctr = prof.get("counters", {})
            r = queries.setdefault(f"{q}@{strategy}", {})[run] = {
                "wall_s": wall, "rows": table.num_rows, "peak_mem_gb": peak,
                "base_mem_gb": base,
                "launches": {n: v for n, v in got.items() if v},
                "fragments": prof.get("fragments"),
                "exchanges": prof.get("exchanges"),
                "exchange_rows": ctr.get("exchange_rows"),
                "exchange_bytes": ctr.get("exchange_bytes"),
                "recompiles": prof.get("recompiles"),
                "scan_s": sum(a["scan_s"] for a in prof.get("attempts", ())),
                "run_s": sum(a["run_s"] for a in prof.get("attempts", ())),
                "optimize_s": prof.get("optimize_s"),
                "fetch_s": prof.get("fetch_s")}
            log(f"  {q}@dist-{strategy} {run}: {wall * 1e3:.1f} ms, "
                f"{table.num_rows} rows, peak {peak:.2f} GB (from "
                f"{base:.2f}), fragments {r['fragments']}, exchanges "
                f"{r['exchanges']}, exchange rows {r['exchange_rows']} "
                f"bytes {r['exchange_bytes']}, launches {r['launches']}, "
                f"recompiles {r['recompiles']}")
            rel = DIST_REL.get(q, 1e-6) if strategy != "auto" else 1e-6
            if not _dist_agree(q, table, want[q], rel):
                failures.append(f"{q}@{strategy} {run}: rows differ from "
                                "the single-shard path's")
            if not (r["fragments"] and r["exchange_rows"]
                    and r["exchange_bytes"]):
                failures.append(f"{q}@{strategy} {run}: no fragment stats")
    finally:
        set_knobs(strategies("auto"))
    out["queries"] = queries
    out["launches"] = launches
    out["launches_per_card"] = per_card
    out["shapes"] = {n: sorted(v) for n, v in shapes.items()}
    log(f"dist: launches {launches}, per card {per_card}, kernel shapes "
        f"{out['shapes']}")
    for n, v in launches.items():
        if not v:
            failures.append(f"{n} did not launch on the dist path")
    cards_used = {c for v in per_card.values() for c in v}
    if cards_used != set(out["cards"]):
        failures.append(f"the kernels launched on {sorted(cards_used)}, "
                        f"the shards sit on {out['cards']}")
    errs = _placement_errors(s8)
    if errs:
        failures.append(f"dist placement: {errs[:5]}")
    del s8
    gc.collect()
    torch.cuda.empty_cache()
    try:
        out["mixed"] = _dist_mixed(failures)
    except Exception as e:  # the phase fails below, with the reason
        traceback.print_exc()
        failures.append(f"dist_mixed: {type(e).__name__}: {e}")
    gc.collect()
    torch.cuda.empty_cache()
    try:
        out["cluster"] = _dist_cluster(failures)
    except Exception as e:  # the phase fails below, with the reason
        traceback.print_exc()
        failures.append(f"cluster: {type(e).__name__}: {e}")
    rec["dist"] = out
    if failures:
        raise PhaseError(f"dist: {failures}")


def _placement_errors(s) -> list:
    """Every input the Session's DistExecutor placed for the plans it ran,
    walked shard by shard against its mesh (each shard's tensors on its
    shard's device, REPLICATED ones on the home device)."""
    from starrocks_tpu_torch.runtime.dist_executor import placement_errors

    ex = s._executor()
    errs = []
    for _ir, scans_meta in list(ex._frag_ir_memo.values()):
        errs += placement_errors(ex._place(scans_meta), ex.mesh)
    return errs


# the dist_mixed sub-phase: DIST_QUERIES cold at this scale over the mesh
# MIXED_MESH, under the CPU tests' lowered thresholds (every TPC-H table
# but nation and region sharded, the large group-bys shuffled)
MIXED_SF = 0.1
MIXED_MESH = ("cuda:0", "cpu") * 4
MIXED_THRESHOLDS = {"SHARD_THRESHOLD_ROWS": 10_000,
                    "SHUFFLE_AGG_MIN_GROUPS": 4_000}
# run under `auto` only (CUTS): under the kernel strategies their CPU
# shards build the one-hot operands on the host, 8.3 and 9.5 s of the
# sub-phase's 32.3 on an H100 host (PERF.md); the `gpu` tests run them
MIXED_AUTO_ONLY = ("Q1", "S2")


def _dist_mixed(failures) -> dict:
    """The dist_mixed sub-phase: a DistExecutor over the explicit mixed
    mesh (cuda:0, cpu) x 4, where every exchange crosses devices, every
    REPLICATED value is needed on both and the CPU shards take the plain
    versions; DIST_QUERIES at MIXED_SF cold under the kernel strategies
    (but MIXED_AUTO_ONLY) and then under `auto` (each in a Session of its
    own), rows equal to
    the single-shard card Session's, every placed input on its shard's
    device after each query, the kernels launched on cuda:0 only."""
    import gc

    import starrocks_tpu_torch.sql.distributed as D
    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.dist_executor import DistExecutor
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

    out = {"sf": MIXED_SF, "mesh": list(MIXED_MESH), "queries": {}}
    old = {k: getattr(D, k) for k in MIXED_THRESHOLDS}
    t0 = time.perf_counter()
    try:
        for k, v in MIXED_THRESHOLDS.items():
            setattr(D, k, v)
        cat = tpch_catalog(sf=MIXED_SF, seed=42)
        set_knobs(strategies("auto"))
        one = Session(cat, device=CARD)
        want = {q: one.sql(t).table for q, t in DIST_QUERIES.items()}
        del one
        per_card: dict = {}
        for strategy in ("kernels", "auto"):
            s = Session(cat, device=CARD, dist_shards=DIST_SHARDS)
            s._dist_executor = DistExecutor(cat, mesh=MIXED_MESH,
                                            device_cache=s.cache)
            set_knobs(strategies(strategy))
            kernels.reset_counts()
            for q, text in DIST_QUERIES.items():
                if strategy == "kernels" and q in MIXED_AUTO_ONLY:
                    continue
                t = time.perf_counter()
                table = s.sql(text).table
                wall = time.perf_counter() - t
                out["queries"][f"{q}@{strategy}"] = {
                    "wall_s": wall, "rows": table.num_rows}
                rel = (DIST_REL.get(q, 1e-6) if strategy != "auto"
                       else 1e-6)
                if not _dist_agree(q, table, want[q], rel):
                    failures.append(f"{q}@mixed-{strategy}: rows differ "
                                    "from the single-shard path's")
                errs = _placement_errors(s)
                if errs:
                    failures.append(f"{q}@mixed-{strategy} placement: "
                                    f"{errs[:3]}")
            for n, cards in kernels.launches_per_card().items():
                for c, v in cards.items():
                    per_card.setdefault(n, {})[c] = (
                        per_card.get(n, {}).get(c, 0) + v)
            del s
            gc.collect()
    finally:
        set_knobs(strategies("auto"))
        for k, v in old.items():
            setattr(D, k, v)
    out["launches_per_card"] = per_card
    out["wall_s"] = time.perf_counter() - t0
    cards = {c for v in per_card.values() for c in v}
    if cards - {"cuda:0"} or not per_card.get("segment_sum"):
        failures.append(f"dist_mixed: kernel launches per card {per_card}")
    log(f"  dist_mixed: {len(out['queries'])} runs over {MIXED_MESH} at SF "
        f"{MIXED_SF:g} in {out['wall_s']:.1f} s, launches per card "
        f"{per_card}")
    del cat
    torch.cuda.empty_cache()
    return out


def _dist_cluster(failures) -> dict:
    """The cluster sub-phase: TPC-H at CLUSTER_SF, a coordinator Session of
    two shards and ClusterRuntime(n_workers=2, shards=2) with its worker
    processes on the same card (the device travels in their bootstrap);
    CLUSTER_QUERIES through the workers, rows equal to the in-process
    path's, and at least 3 fragments run on the workers. The fleet stops
    in a finally."""
    import gc

    import torch

    from starrocks_tpu_torch.runtime.cluster_exec import ClusterRuntime
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

    out = {"sf": CLUSTER_SF, "workers": 2, "shards": 2}
    cat = tpch_catalog(sf=CLUSTER_SF, seed=42)
    s = Session(cat, device=CARD, dist_shards=2)
    want = {q: s.sql(DIST_QUERIES[q]).table for q in CLUSTER_QUERIES}
    t = time.perf_counter()
    # a CUDA context and the engine's imports hold a worker's interpreter
    # for seconds at bootstrap: a heartbeat deadline of 10 s rides it out
    cr = ClusterRuntime(n_workers=2, shards=2, hb_interval_s=1.0,
                        hb_miss_limit=10).start(s)
    out["start_s"] = time.perf_counter() - t
    try:
        cr.attach(s)
        for q in CLUSTER_QUERIES:
            for run in ("cold", "warm"):
                t = time.perf_counter()
                table = s.sql(DIST_QUERIES[q]).table
                wall = time.perf_counter() - t
                out.setdefault(q, {})[run] = {
                    "wall_s": wall, "rows": table.num_rows,
                    "cluster_workers": s.last_profile.infos.get(
                        "cluster_workers")}
                log(f"  {q}@cluster {run}: {wall * 1e3:.1f} ms, "
                    f"{table.num_rows} rows")
                if not _dist_agree(q, table, want[q], 1e-6):
                    failures.append(f"{q}@cluster {run}: rows differ from "
                                    "the in-process path's")
        out["stats"] = cr.stats()
    finally:
        s.catalog.cluster_runtime = None
        cr.stop()
    log(f"  cluster: started in {out['start_s']:.1f} s, worker cards "
        f"{out['stats']['devices']}, {out['stats']}")
    if out["stats"]["fragments_total"] < 3:
        failures.append(f"cluster: {out['stats']['fragments_total']} "
                        "fragments ran on the workers")
    del s, cat
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- the process mesh: one process per card, on one host or several ---------

# the dist_procs phase's runs in each rank: (strategy set, run, query)
PROCS_RUNS = ([("kernels", "cold", q) for q in ("Q3", "Q5", "Q18", "S1", "N1")]
              + [("kernels", "warm", q) for q in DIST_WARM]
              + [("hash", "cold", q) for q in DIST_HASH]
              + [("auto", "cold", q) for q in DIST_WARM])
# the runs of the one-card layout whose two ranks share the card over gloo
# (CUTS): every kernel and both collective kinds, in the processes of the
# layout before it
PROCS_SHARED_RUNS = [("kernels", "cold", q) for q in ("Q3", "S1", "N1")] + [
    ("kernels", "warm", "Q3"), ("hash", "cold", "Q3")]
PROCS_GROUP_TIMEOUT_S = 120  # each rank's group: set-up and every collective
PROCS_DEADLINE_S = 300       # a rank still running this long after "go" dies
# an emulated host's ranks: NCCL's sockets on loopback and no InfiniBand,
# so the path between hosts is NCCL's socket transport, and gloo's side on
# loopback too; NCCL_HOSTID (the host's name) makes NCCL take the host for
# a machine of its own
EMULATED_HOST_ENV = {"NCCL_SOCKET_IFNAME": "lo", "NCCL_IB_DISABLE": "1",
                     "GLOO_SOCKET_IFNAME": "lo"}
# every rank's NCCL log (its own file): set-up, environment and transports
NCCL_LOG_ENV = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,ENV,NET"}


def _layout(name, hosts, emulated, backend, cards, devices, shard_hosts,
            runs=PROCS_RUNS, reuse=None) -> dict:
    """One dist_procs layout: its hosts [(host, visible cards, ranks)] (a
    host None is this machine), whether they are emulated, its runs, the
    earlier layout whose processes run it (`reuse`, None: processes of its
    own), and what its ranks must report, written out: the backend, each
    rank's cards (as its host numbers them), Mesh.devices and Mesh.hosts
    over DIST_SHARDS shards (None: this machine's name)."""
    return {"name": name, "hosts": hosts, "emulated": emulated,
            "runs": [list(x) for x in runs], "reuse": reuse,
            "want": {"backend": backend, "cards": [list(c) for c in cards],
                     "devices": devices, "hosts": shard_hosts}}


def procs_layouts(cards: int) -> list:
    """The dist_procs phase's layouts on a machine of `cards` cards, run in
    turn. One card: two emulated hosts that each see cuda:0, one rank x 4
    shards each (NCCL), then in the same two processes one host
    of 2 ranks x 4 shards sharing cuda:0 (gloo). Two or three cards: two
    emulated hosts of one card each, one rank each. Four or more:
    one host of 4 ranks x 2 shards on cards 0-3, then two emulated hosts
    of two cards each, (a) 2 ranks a host x 2 shards, one process per
    card, and (b) 1 rank a host x 4 shards over its 2 cards, the JAX pod
    layout."""
    two = ["host0"] * 4 + ["host1"] * 4
    if cards < 2:
        return [_layout("hosts_2x1", [("host0", "0", 1), ("host1", "0", 1)],
                        True, "nccl", [(0,), (0,)], ["cuda:0"] * 8, two),
                _layout("one_host_2x4", [(None, "0", 2)], False, "gloo",
                        [(0,), (0,)], ["cuda:0"] * 8, [None] * 8,
                        runs=PROCS_SHARED_RUNS, reuse="hosts_2x1")]
    if cards < 4:
        return [_layout("hosts_2x1", [("host0", "0", 1), ("host1", "1", 1)],
                        True, "nccl", [(0,), (0,)], ["cuda:0"] * 8, two)]
    pairs = ["cuda:0", "cuda:0", "cuda:1", "cuda:1"] * 2
    return [_layout("one_host_4x2", [(None, "0,1,2,3", 4)], False, "nccl",
                    [(0,), (1,), (2,), (3,)],
                    ["cuda:0", "cuda:0", "cuda:1", "cuda:1", "cuda:2",
                     "cuda:2", "cuda:3", "cuda:3"], [None] * 8),
            _layout("hosts_2x2_a", [("host0", "0,1", 2), ("host1", "2,3", 2)],
                    True, "nccl", [(0,), (1,), (0,), (1,)], pairs, two),
            _layout("hosts_2x1_b", [("host0", "0,1", 1), ("host1", "2,3", 1)],
                    True, "nccl", [(0, 1), (0, 1)], pairs, two)]


def layout_ranks(hosts) -> list:
    """A layout's ranks in rank order, host by host: (host, visible
    cards)."""
    return [(h, vis) for h, vis, k in hosts for _ in range(k)]


def start_mesh_ranks(args) -> dict:
    """Start the dist_procs phase's ranks, every layout's at once but for a
    layout that runs in an earlier one's processes: this script with
    --mesh-rank, each with its host's CUDA_VISIBLE_DEVICES and, on an
    emulated host, NCCL_HOSTID and EMULATED_HOST_ENV, its NCCL log in a
    file of its own for each layout. Each generates its catalog at once
    (beside the generate phase, so the card's phases never share the host
    with it), then waits for a line "go <coordinator host:port>" on its
    stdin before each of its layouts."""
    import tempfile

    import torch

    d = Path(tempfile.mkdtemp(prefix="mesh_ranks_"))
    layouts, groups = [], {}
    for lay in procs_layouts(torch.cuda.device_count()):
        (d / lay["name"]).mkdir()
        lay["ranks"] = layout_ranks(lay["hosts"])
        lay["specs"] = [{"rank": r, "procs": len(lay["ranks"]), "host": h,
                         "layout": lay["name"], "dir": str(d / lay["name"]),
                         "runs": lay["runs"]}
                        for r, (h, _) in enumerate(lay["ranks"])]
        groups.setdefault(lay["reuse"] or lay["name"], []).append(lay)
        layouts.append(lay)
    for group in groups.values():
        owner = group[0]
        assert all([v for _, v in g["ranks"]] == [v for _, v in owner["ranks"]]
                   for g in group), "a reused process keeps its cards"
        procs = []
        for r, (host, vis) in enumerate(owner["ranks"]):
            env = {**os.environ, **NCCL_LOG_ENV, "CUDA_VISIBLE_DEVICES": vis,
                   "NCCL_DEBUG_FILE": str(d / f"nccl_{owner['name']}_{r}.log")}
            if owner["emulated"]:
                env.update(EMULATED_HOST_ENV, NCCL_HOSTID=host)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--sf",
                 repr(args.sf), "--seed", str(args.seed), "--mesh-rank",
                 json.dumps([g["specs"][r] for g in group])],
                stdin=subprocess.PIPE, env=env))
        logs = [d / f"nccl_{owner['name']}_{r}.log" for r in range(len(procs))]
        seen = [0] * len(procs)  # the part of each log read so far
        for g in group:
            g.update(procs=procs, last=g is group[-1], nccl_logs=logs,
                     nccl_seen=seen)
    return {"layouts": layouts, "dir": d}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ranks(procs, deadline_s: float, records=None) -> list:
    """Wait for the ranks until every one is done (its process ended, or,
    with `records`, its record file there), one has failed or the
    deadline has passed; then kill those not done (a rank blocked in a
    collective with a dead peer would hold on until its group's timeout).
    Returns the indices of the ranks it killed."""
    def done(r):
        return (procs[r].poll() is not None
                or (records is not None and records[r].exists()))

    end = time.monotonic() + deadline_s
    while not all(done(r) for r in range(len(procs))):
        if (time.monotonic() > end
                or any(p.poll() not in (None, 0) for p in procs)):
            break
        time.sleep(0.2)
    killed = [r for r in range(len(procs)) if not done(r)]
    for r in killed:
        procs[r].kill()
        procs[r].wait()
    return killed


def nccl_channels(text: str) -> list:
    """The channels in an NCCL log (NCCL_DEBUG=INFO): [(from rank, to rank,
    transport)], the transport the first word of the `via` field (NET,
    P2P, SHM, ...)."""
    import re

    found = re.findall(r"Channel \d+/\d+ : (\d+)\[\w+\] -> (\d+)\[\w+\]"
                       r"(?: \[\w+\])? via (\w+)", text)
    return [(int(a), int(b), t) for a, b, t in found]


def phase_dist_procs(rec, cat, ranks: dict):
    """The process mesh (see the module docstring, phase 8c'): the
    single-shard rows of the queries of every layout's runs, then the
    card's memory freed and each layout's ranks told to go in turn; each
    rank's record checked (its exit, backend, cards, mesh hosts and
    devices against the layout's, rows, and every kernel launched on its
    own cards alone, on each of them), and on an emulated host the
    transport of every NCCL channel between hosts. Nothing retries: a
    failed rank or NCCL set-up fails the phase."""
    import gc
    import pickle

    import torch
    import torch.distributed as dist

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

    cards = torch.cuda.device_count()
    nccl = (str(torch.cuda.nccl.version()) if dist.is_nccl_available()
            else None)
    out = {"cards": cards, "nccl_available": dist.is_nccl_available(),
           "nccl_version": nccl, "layouts": {}}
    log(f"dist_procs: {len(ranks['layouts'])} layout(s) on {cards} "
        f"card(s); NCCL available {dist.is_nccl_available()}, version "
        f"{nccl}")
    set_knobs(strategies("auto"))
    s1 = Session(cat, device=CARD)
    t = time.perf_counter()
    want = {q: s1.sql(DIST_QUERIES[q]).table
            for q in dict.fromkeys(q for lay in ranks["layouts"]
                                   for _, _, q in lay["runs"])}
    out["single_shard_s"] = time.perf_counter() - t
    del s1
    gc.collect()
    torch.cuda.empty_cache()
    out["parent_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    launches = dict.fromkeys(kernels.WRAPPERS, 0)
    failures = []
    for lay in ranks["layouts"]:
        (ranks["dir"] / lay["name"] / "want.pkl").write_bytes(
            pickle.dumps(want))
        got = _run_layout(lay, ranks["dir"] / lay["name"], failures)
        for k, v in got["launches"].items():
            launches[k] += v
        out["layouts"][lay["name"]] = got
    out["launches"] = launches
    log(f"dist_procs: launches {launches}")
    rec["dist_procs"] = out
    if failures:
        raise PhaseError(f"dist_procs: {failures[:12]}")


def _run_layout(lay: dict, d: Path, failures: list) -> dict:
    """Tell one layout's ranks to go (the end of their input after their
    last layout), wait for them, and check their records and NCCL logs
    against the layout's written-out expectations (failures appended);
    returns the layout's record."""
    import platform

    from starrocks_tpu_torch.ops import kernels

    name, procs, want = lay["name"], lay["procs"], lay["want"]
    n, per = len(procs), DIST_SHARDS // len(procs)
    this = platform.node()
    hosts = [h or this for h in want["hosts"]]
    shape = " + ".join(f"{h or 'this host'} (cards {vis}, {k} rank(s))"
                       for h, vis, k in lay["hosts"])
    log(f"dist_procs {name}: {n} ranks x {per} shards on {shape}"
        f"{' in the processes of ' + lay['reuse'] if lay['reuse'] else ''}"
        f"; backend expected: {want['backend']}; rank cards "
        f"{want['cards']}; {len(lay['runs'])} runs")
    out = {"ranks": n, "shards_per_rank": per, "hosts": lay["hosts"],
           "emulated": lay["emulated"], "reuse": lay["reuse"],
           "backend": want["backend"], "runs": lay["runs"],
           "host_available_gb": [_host_available_gb()]}
    coord = f"127.0.0.1:{_free_port()}"
    records = [d / f"rank{r}.json" for r in range(n)]
    t = time.perf_counter()
    for p in procs:
        try:
            p.stdin.write(f"go {coord}\n".encode())
            p.stdin.flush()
            if lay["last"]:
                p.stdin.close()
        except OSError:
            pass  # the rank already ended: its exit code says why
    killed = _wait_ranks(procs, PROCS_DEADLINE_S,
                         None if lay["last"] else records)
    out["wall_s"] = time.perf_counter() - t
    out["host_available_gb"].append(_host_available_gb())
    why = ("past its deadline" if out["wall_s"] > PROCS_DEADLINE_S
           else "after a peer failed")
    failures += [f"{name} rank {r} killed {why}" for r in killed]
    recs = []
    for r, p in enumerate(procs):
        got = (json.loads(records[r].read_text()) if records[r].exists()
               else {})
        recs.append(got)
        if p.poll() not in (None, 0) or got.get("status") != "ok":
            failures.append(f"{name} rank {r} exit {p.poll()}: "
                            f"{got.get('status', 'no record')}")
    out["rank_records"] = recs
    launches = dict.fromkeys(kernels.WRAPPERS, 0)
    backend = want["backend"]
    for r, got in enumerate(recs):
        if not got.get("runs"):
            continue
        mine = sorted(set(want["devices"][r * per:(r + 1) * per]))
        if (got.get("backend"), got.get("coll")) != (
                backend, backend.capitalize()):
            failures.append(f"{name} rank {r}: backend {got.get('backend')} "
                            f"({got.get('coll')}), expected {backend}")
        for key, exp in (("hosts", hosts), ("devices", want["devices"]),
                         ("cards", want["cards"][r])):
            if got.get(key) != exp:
                failures.append(f"{name} rank {r}: {key} {got.get(key)}, "
                                f"expected {exp}")
        per_card = {k: {} for k in kernels.WRAPPERS}
        for key, run in got["runs"].items():
            if not run["rows_equal"]:
                failures.append(f"{name} rank {r} {key}: rows differ from "
                                "the single-shard path's")
            for k, cs in run["launches_per_card"].items():
                for c, v in cs.items():
                    per_card[k][c] = per_card[k].get(c, 0) + v
        for k, cs in per_card.items():
            launches[k] += sum(cs.values())
            if sorted(cs) != mine:
                failures.append(f"{name} rank {r}: {k} launched on {cs}, "
                                f"not on each of {mine} alone")
    out["launches"] = launches
    out["nccl"] = _nccl_report(lay, [h or this for h, _ in lay["ranks"]],
                               failures)
    log(f"dist_procs {name}: ranks done in {out['wall_s']:.1f} s (host "
        f"memory available before and after: {out['host_available_gb']} "
        "GB); NCCL "
        f"transports between hosts {out['nccl']['between_hosts']}, within "
        f"a host {out['nccl']['within_host']}; NCCL_HOSTID honoured "
        f"{out['nccl']['hostid_lines']} of {n}, nNodes "
        f"{out['nccl']['nodes']}; launches {launches}")
    return out


def _nccl_report(lay: dict, rank_hosts: list, failures: list) -> dict:
    """Read the layout's NCCL logs (a log of processes that ran an earlier
    layout holds that one's lines first: only the part after them is
    read): the transport of each channel, counted by whether its two
    ranks are on one host, the ranks whose log says NCCL_HOSTID was set,
    and the node counts NCCL reported. Between emulated hosts every
    channel must take the network transport (P2P or SHM there means the
    emulation leaked), and one at least must have been seen where the
    group has NCCL."""
    import re

    between: dict = {}
    within: dict = {}
    hostid = 0
    nodes = set()
    seen = lay["nccl_seen"]
    for r, f in enumerate(lay["nccl_logs"]):
        text = f.read_text(errors="replace") if f.exists() else ""
        text, seen[r] = text[seen[r]:], len(text)
        hostid += "NCCL_HOSTID" in text
        nodes.update(int(x) for x in re.findall(r"nNodes (\d+)", text))
        for a, b, via in nccl_channels(text):
            side = within if rank_hosts[a] == rank_hosts[b] else between
            side[via] = side.get(via, 0) + 1
    if lay["emulated"] and lay["want"]["backend"] == "nccl":
        leaked = {k: v for k, v in between.items() if k != "NET"}
        if leaked:
            failures.append(f"{lay['name']}: NCCL channels between emulated "
                            f"hosts over {leaked}: the emulation leaked")
        if not between:
            failures.append(f"{lay['name']}: no NCCL channel between hosts "
                            "in the ranks' logs")
    return {"between_hosts": between, "within_host": within,
            "hostid_lines": hostid, "nodes": sorted(nodes)}


def stop_mesh_ranks(ranks: dict):
    """Reap ranks that were never told to go (a phase before them failed,
    or the run ended early): each ends at the end of its stdin, or is
    killed."""
    import shutil

    procs = list({id(p): p for lay in ranks.get("layouts", ())
                  for p in lay["procs"]}.values())
    for p in procs:
        if p.poll() is None:
            try:
                p.stdin.close()
            except OSError:
                pass
    if procs:
        _wait_ranks(procs, 60)
        shutil.rmtree(ranks["dir"], ignore_errors=True)


def _rank_log(msg: str):
    """One line of a rank's output in one write (the ranks share the
    parent's stdout)."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def mesh_rank(args) -> int:
    """--mesh-rank JSON (a list of {"rank", "procs", "host", "layout",
    "dir", "runs"}, one for each layout this process runs, in turn):
    generate the catalog; then for each layout wait for "go <coordinator>"
    on stdin (end of input: exit without running), join the process group
    (runtime.cluster.init_multihost: `procs` processes x DIST_SHARDS /
    procs shards, host `host`, None for this machine's name), run `runs`
    through Session(dist_shards=DIST_SHARDS) on this rank's cards, each
    held to the parent's single-shard rows (`want.pkl`), leave the group,
    free the card's memory and write rank<r>.json to the layout's
    directory."""
    import gc

    import torch

    specs = json.loads(args.mesh_rank)
    cat = None
    for spec in specs:
        r, d = spec["rank"], Path(spec["dir"])
        tag = f"{spec['layout']} rank {r}"
        rec = {"rank": r, "host": spec["host"], "status": "ok", "runs": {}}
        try:
            if cat is None:
                from starrocks_tpu_torch.storage.catalog import tpch_catalog

                t = time.perf_counter()
                cat = tpch_catalog(sf=args.sf, seed=args.seed)
                rec["gen_s"] = time.perf_counter() - t
                _rank_log(f"  {tag}: TPC-H SF {args.sf:g} generated in "
                          f"{rec['gen_s']:.1f} s")
            line = sys.stdin.readline().split()
            if not line or line[0] != "go":
                return 0
            _mesh_rank_runs(rec, cat, line[1], spec, tag)
        except Exception as e:  # noqa: BLE001 — reported to the parent
            traceback.print_exc()
            rec["status"] = f"FAILED: {type(e).__name__}: {e}"
        gc.collect()
        torch.cuda.empty_cache()
        tmp = d / f"rank{r}.json.tmp"
        tmp.write_text(json.dumps(rec))
        tmp.replace(d / f"rank{r}.json")
        if rec["status"] != "ok":
            return 1
    return 0


def _mesh_rank_runs(rec, cat, coord: str, spec: dict, tag: str):
    import pickle
    import resource

    import torch
    import torch.distributed as dist

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.parallel import mesh as M
    from starrocks_tpu_torch.runtime.cluster import init_multihost
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

    n = spec["procs"]
    want = pickle.loads((Path(spec["dir"]) / "want.pkl").read_bytes())
    t = time.perf_counter()
    init_multihost(coord, num_processes=n, process_id=spec["rank"],
                   local_device_count=DIST_SHARDS // n,
                   timeout_s=PROCS_GROUP_TIMEOUT_S, host=spec["host"])
    rec["init_s"] = time.perf_counter() - t
    s = Session(cat, dist_shards=DIST_SHARDS)
    mesh = s._executor().mesh
    rec.update(backend=M._PROCESS["backend"], group=str(dist.get_backend()),
               card=f"cuda:{torch.cuda.current_device()}",
               cards=list(M._PROCESS["cards"]),
               coll=type(mesh.coll).__name__, mesh=repr(mesh),
               devices=[str(x) for x in mesh.devices],
               hosts=list(mesh.hosts),
               local_cards=[str(x) for x in mesh.cards])
    _rank_log(f"  {tag}: joined in {rec['init_s']:.1f} s, backend "
              f"{rec['backend']} (group {rec['group']}), {rec['mesh']}; "
              f"shard s on {rec['devices']} of hosts {rec['hosts']}")

    def retries():
        return sum(torch.cuda.memory_stats(c).get("num_alloc_retries", 0)
                   for c in mesh.cards)

    try:
        for strategy, run, q in spec["runs"]:
            knobs = strategies("auto" if strategy == "auto" else "kernels")
            if strategy == "hash":
                knobs = {**knobs, "join_probe_strategy": "pallas"}
            set_knobs(knobs)
            kernels.reset_counts()
            mesh.reset_moves()
            for c in mesh.cards:
                torch.cuda.synchronize(c)
                torch.cuda.reset_peak_memory_stats(c)
            retried = retries()
            t, cpu = time.perf_counter(), time.process_time()
            res = s.sql(DIST_QUERIES[q])
            table = res.table
            for c in mesh.cards:
                torch.cuda.synchronize(c)
            wall = time.perf_counter() - t
            cpu = time.process_time() - cpu
            rel = DIST_REL.get(q, 1e-6) if strategy != "auto" else 1e-6
            got = _snapshot(kernels)
            prof = _prof_view(res.profile)
            attempts = prof.get("attempts", ())
            peaks = {str(c): torch.cuda.max_memory_allocated(c) / 1e9
                     for c in mesh.cards}
            x = rec["runs"][f"{q}@{strategy} {run}"] = {
                "wall_s": wall, "cpu_s": cpu, "rows": table.num_rows,
                "rows_equal": _dist_agree(q, table, want[q], rel),
                "attempts": len(attempts),
                "scan_s": sum(a["scan_s"] for a in attempts),
                "run_s": sum(a["run_s"] for a in attempts),
                "optimize_s": prof.get("optimize_s"),
                "alloc_retries": retries() - retried,
                "peak_mem_gb": max(peaks.values()),
                "peak_mem_gb_per_card": peaks,
                "launches": {k: v for k, v in got.items() if v},
                "launches_per_card": kernels.launches_per_card(),
                "moves": {k: [len(v), sum(v)] for k, v in mesh.moves.items()},
                "exchange_bytes": prof.get("counters", {}).get(
                    "exchange_bytes")}
            _rank_log(f"  {tag} {q}@procs-{strategy} {run}: "
                      f"{wall * 1e3:.1f} ms ({cpu:.1f} CPU s, "
                      f"{x['attempts']} attempt(s), scan {x['scan_s']:.2f} s,"
                      f" run {x['run_s']:.2f} s, {x['alloc_retries']} "
                      f"allocator retries), {table.num_rows} rows, equal "
                      f"{x['rows_equal']}, peak {peaks} GB, launches "
                      f"{x['launches']}, moves {x['moves']}")
    finally:
        set_knobs(strategies("auto"))
    rec["host_peak_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    dist.barrier()
    dist.destroy_process_group()


# --- the serving planes: the port's front doors under concurrent clients ------

SERVE_POOL = 4            # the tier's executor pool (serve_pool_size)
SERVE_MYSQL_CLIENTS = 4   # and as many HTTP clients
SERVE_HTTP_CLIENTS = 4
SERVE_ANALYTIC = ("Q3", "Q5", "Q6", "Q10", "Q12", "Q14", "Q18", "Q19", "N1",
                  "S1")
SERVE_HASH = ("Q9", "Q20")  # the short round under the hash kernels
SERVE_POINT_SELECTS = 200  # per MySQL client, over its own key slice
SERVE_POINT_UPDATES = 20   # per MySQL client, o_comment of its own keys
SERVE_WARM_PASSES = 2
SERVE_REL = {"S1": STAT_REL}


class MySQLClient:
    """A minimal MySQL protocol-10 client over one socket, the one the
    port's tests use too: the handshake (mysql_native_password), COM_QUERY
    with text resultsets, COM_STMT_PREPARE / EXECUTE / CLOSE with binary
    resultsets, COM_PING and COM_QUIT, and `query_raw` / `execute_raw`:
    one command's response packets as bytes, to compare two servers' wire
    encodings. An ERR packet raises RuntimeError("ERR <code>: <message>"),
    a refused login PermissionError."""

    def __init__(self, port: int, user: str = "root", password: str = "",
                 host: str = "127.0.0.1", timeout: float = 600):
        import socket

        from starrocks_tpu_torch.runtime.auth import scramble_password

        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.seq = 0
        greet = self._read_packet()
        if greet[0] != 0x0A:
            raise RuntimeError(f"protocol version {greet[0]}")
        end = greet.index(b"\x00", 1)
        self.server_version = greet[1:end].decode()
        # the salt: 8 bytes after the thread id, 12 more after the caps
        pos = end + 1 + 4
        salt = greet[pos:pos + 8]
        pos2 = pos + 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        salt += greet[pos2:pos2 + 12]
        token = scramble_password(password, salt)
        # HandshakeResponse41: PROTOCOL_41 | SECURE_CONNECTION | WITH_DB
        caps = 0x0200 | 0x8000 | 0x0008
        self._send_packet(struct.pack("<II", caps, 1 << 24) + bytes([45])
                          + b"\x00" * 23 + user.encode() + b"\x00"
                          + bytes([len(token)]) + token + b"default\x00")
        ok = self._read_packet()
        if ok[0] == 0xFF:
            raise PermissionError(f"auth failed: {self._err_text(ok)}")
        if ok[0] != 0x00:
            raise RuntimeError(f"handshake failed: {ok[:64]!r}")

    # --- framing
    def _read_packet(self) -> bytes:
        head = self._read_n(4)
        (n,) = struct.unpack("<I", head[:3] + b"\x00")
        self.seq = (head[3] + 1) & 0xFF
        return self._read_n(n)

    def _read_n(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise RuntimeError("server closed the connection")
            buf += chunk
        return buf

    def _send_packet(self, payload: bytes):
        self.sock.sendall(struct.pack("<I", len(payload))[:3]
                          + bytes([self.seq]) + payload)
        self.seq = (self.seq + 1) & 0xFF

    @staticmethod
    def _lenenc(buf: bytes, pos: int):
        c = buf[pos]
        if c < 0xFB:
            return c, pos + 1
        if c == 0xFC:
            return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
        if c == 0xFD:
            return struct.unpack("<I", buf[pos + 1:pos + 4] + b"\x00")[0], \
                pos + 4
        return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9

    @staticmethod
    def _err_text(p: bytes) -> str:
        code = struct.unpack_from("<H", p, 1)[0]
        return f"ERR {code}: {p[9:].decode('utf-8', 'replace')}"

    # --- commands
    def _exchange(self, payload: bytes) -> list:
        """Send one command; its response packets, up to the resultset's
        final EOF, an OK or an ERR."""
        self.seq = 0
        self._send_packet(payload)
        out = [self._read_packet()]
        if out[0][0] in (0x00, 0xFF):
            return out
        eofs = 0
        while eofs < 2:
            p = self._read_packet()
            out.append(p)
            if p[0] == 0xFE and len(p) < 9:
                eofs += 1
        return out

    def _result(self, packets: list, binary: bool):
        """(column names, rows) of a resultset, or ("OK", affected rows)."""
        first = packets[0]
        if first[0] == 0xFF:
            raise RuntimeError(self._err_text(first))
        if first[0] == 0x00:
            return "OK", self._lenenc(first, 1)[0]
        ncols, _ = self._lenenc(first, 0)
        names, types = [], []
        for p in packets[1:1 + ncols]:
            pos, parts = 0, []
            for _ in range(6):
                n, pos = self._lenenc(p, pos)
                parts.append(p[pos:pos + n])
                pos += n
            _, pos = self._lenenc(p, pos)  # the fixed-length block's size
            names.append(parts[4].decode())
            types.append(p[pos + 6])
        if packets[1 + ncols][0] != 0xFE:
            raise RuntimeError("no EOF after the column definitions")
        rows = [self._binary_row(p, types) if binary else self._text_row(p)
                for p in packets[2 + ncols:-1]]
        return names, rows

    def _text_row(self, p: bytes) -> tuple:
        pos, row = 0, []
        while pos < len(p):
            if p[pos] == 0xFB:
                row.append(None)
                pos += 1
                continue
            n, pos = self._lenenc(p, pos)
            row.append(p[pos:pos + n].decode())
            pos += n
        return tuple(row)

    def _binary_row(self, p: bytes, types) -> tuple:
        if p[0] != 0x00:
            raise RuntimeError(f"binary row header {p[0]}")
        nul = p[1:1 + (len(types) + 9) // 8]
        pos = 1 + len(nul)
        row = []
        for i, t in enumerate(types):
            if nul[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                row.append(None)
            elif t == 1:  # TINY
                row.append(struct.unpack_from("<b", p, pos)[0])
                pos += 1
            elif t == 3:  # LONG
                row.append(struct.unpack_from("<i", p, pos)[0])
                pos += 4
            elif t == 8:  # LONGLONG
                row.append(struct.unpack_from("<q", p, pos)[0])
                pos += 8
            elif t == 5:  # DOUBLE
                row.append(struct.unpack_from("<d", p, pos)[0])
                pos += 8
            elif t in (10, 12):  # DATE / DATETIME: y m d [h m s]
                n = p[pos]
                y = struct.unpack_from("<H", p, pos + 1)[0]
                s = f"{y:04d}-{p[pos + 3]:02d}-{p[pos + 4]:02d}"
                if n >= 7:
                    s += (f" {p[pos + 5]:02d}:{p[pos + 6]:02d}"
                          f":{p[pos + 7]:02d}")
                row.append(s)
                pos += 1 + n
            else:  # lenenc text: VARCHAR, DECIMAL
                n, pos = self._lenenc(p, pos)
                row.append(p[pos:pos + n].decode())
                pos += n
        return tuple(row)

    def query_raw(self, sql: str) -> list:
        return self._exchange(b"\x03" + sql.encode())

    def query(self, sql: str):
        """(column names, text rows), or ("OK", affected rows)."""
        return self._result(self.query_raw(sql), binary=False)

    def stmt_prepare(self, sql: str):
        """(statement id, columns, parameters)."""
        self.seq = 0
        self._send_packet(b"\x16" + sql.encode())
        first = self._read_packet()
        if first[0] == 0xFF:
            raise RuntimeError(self._err_text(first))
        sid, ncols, nparams = struct.unpack_from("<IHH", first, 1)
        for _ in range(nparams):
            self._read_packet()
        if nparams:
            self._read_packet()  # EOF
        return sid, ncols, nparams

    def execute_raw(self, sid: int, params) -> list:
        """COM_STMT_EXECUTE's response packets; the parameters bound as
        LONGLONG (int), DOUBLE (float), NULL (None) or VAR_STRING."""
        nul = bytearray((len(params) + 7) // 8)
        types, vals = b"", b""
        for i, v in enumerate(params):
            if v is None:
                nul[i // 8] |= 1 << (i % 8)
                types += bytes([6, 0])
            elif isinstance(v, int):
                types += bytes([8, 0])
                vals += struct.pack("<q", v)
            elif isinstance(v, float):
                types += bytes([5, 0])
                vals += struct.pack("<d", v)
            else:
                b = str(v).encode()
                if len(b) >= 0xFB:
                    raise ValueError("string parameter too long")
                types += bytes([253, 0])
                vals += bytes([len(b)]) + b
        pkt = b"\x17" + struct.pack("<I", sid) + b"\x00" + struct.pack("<I", 1)
        if params:
            pkt += bytes(nul) + b"\x01" + types + vals
        return self._exchange(pkt)

    def stmt_execute(self, sid: int, params):
        """(column names, binary rows), or ("OK", affected rows)."""
        return self._result(self.execute_raw(sid, params), binary=True)

    def stmt_close(self, sid: int):
        self.seq = 0
        self._send_packet(b"\x19" + struct.pack("<I", sid))

    def ping(self) -> bool:
        self.seq = 0
        self._send_packet(b"\x0e")
        return self._read_packet()[0] == 0x00

    def quit(self):
        try:
            self.seq = 0
            self._send_packet(b"\x01")
        finally:
            self.sock.close()


def _http_query(port: int, sql: str) -> dict:
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        c.request("POST", "/query", json.dumps({"sql": sql}))
        r = c.getresponse()
        body = json.loads(r.read())
    finally:
        c.close()
    if r.status != 200:
        raise RuntimeError(f"HTTP {r.status}: {body}")
    return body


def _http_get(port: int, path: str):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _wire_text(v) -> str | None:
    """A result value as the MySQL text protocol encodes it
    (runtime/mysql_service._cell)."""
    if v is None:
        return None
    if isinstance(v, bool):
        v = int(v)
    return repr(v) if isinstance(v, float) else str(v)


def _wire_agree(rows, want: list, rel: float) -> bool:
    """Wire rows (text or JSON values) against a HostTable's python rows in
    row order: floats to a relative `rel` (tables_agree's rule), every
    other value by its text, NULLs as NULLs."""
    if len(rows) != len(want):
        return False
    for g, w in zip(rows, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if a is None or b is None:
                if a is not b:
                    return False
            elif isinstance(b, float):
                if not _floats_agree(float(a), b, rel):
                    return False
            elif str(a) != _wire_text(b):
                return False
    return True


def _pcts(ms: list) -> dict:
    import numpy as np

    if not ms:
        return {"n": 0}
    a = np.asarray(ms, dtype=np.float64)
    return {"n": len(ms), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean())}


def _cache_bytes(cache) -> int:
    """Bytes of the device tensors a DeviceCache holds (its placements)."""
    import torch

    seen, total = set(), 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            key = (x.untyped_storage().data_ptr())
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
        elif isinstance(x, (tuple, list)):
            for y in x:
                add(y)

    with cache._lock:
        for d in (cache._cols, cache._sel, cache._border):
            for v in d.values():
                add(v)
    return total


def _settled_allocated(kernels) -> int:
    """Bytes allocated on the card by the engine: garbage collected, the
    cuBLAS workspaces torch caches per calling thread released (each new
    pool thread's first matmul allocates one, 32 MiB on this card), and
    the kernel wrappers' last-call diagnostics left out."""
    import gc

    import torch

    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - _diag_bytes(kernels)


def _allocated_down_to(kernels, target: int, wait_s: float = 5.0) -> int:
    """The engine's bytes allocated on the card (the kernels' last-call
    diagnostics left out), read until they fall to `target` or `wait_s`
    passes; no garbage collection, so a statement's tensors count as
    freed only once their owners let go of them."""
    import torch

    t_end = time.monotonic() + wait_s
    while True:
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated() - _diag_bytes(kernels)
        if now <= target or time.monotonic() > t_end:
            return now
        time.sleep(0.01)


def _diag_bytes(kernels) -> int:
    """Bytes the kernel wrappers' last-call diagnostics hold on the card
    (`hash_build.last_deferred`, `topn_select.last_listed`): the whole
    scratch buffer each is a view of, rounded up to the caching
    allocator's 512-byte blocks as memory_allocated counts them."""
    return sum(-(-int(t.untyped_storage().nbytes()) // 512) * 512 for t in (
        getattr(kernels.hash_build, "last_deferred", None),
        getattr(kernels.topn_select, "last_listed", None))
        if t is not None and t.device.type == "cuda")


def _orders_expected(orders, keys, comments: dict) -> dict:
    """{key: the row a point SELECT of orders_pk returns} by a numpy
    lookup of the generated orders table, the client's own updates of
    o_comment applied: values as the binary protocol decodes them."""
    import datetime
    import decimal

    import numpy as np

    ok = np.asarray(orders.arrays["o_orderkey"])
    pos = np.searchsorted(ok, np.asarray(keys, dtype=np.int64))
    out = {}
    epoch = datetime.date(1970, 1, 1)
    for k, i in zip(keys, pos):
        if i >= len(ok) or ok[i] != k:
            out[int(k)] = None
            continue
        row = []
        for f in orders.schema:
            a = orders.arrays[f.name]
            v = orders.valids.get(f.name)
            if v is not None and not v[i]:
                row.append(None)
            elif f.name == "o_comment" and int(k) in comments:
                row.append(comments[int(k)])
            elif f.type.is_string:
                row.append(str(f.dict.values[int(a[i])]))
            elif f.type.is_decimal:
                row.append(decimal.Decimal(int(a[i])).scaleb(-f.type.scale))
            elif repr(f.type) == "DATE":
                row.append(str(epoch + datetime.timedelta(days=int(a[i]))))
            else:
                row.append(int(a[i]))
        out[int(k)] = tuple(row)
    return out


def _point_agree(got: tuple, want: tuple) -> bool:
    import decimal

    if want is None:
        return got is None
    if got is None or len(got) != len(want):
        return False
    for a, b in zip(got, want):
        if isinstance(b, decimal.Decimal):
            if a is None or decimal.Decimal(str(a)) != b:
                return False
        elif a != b:
            return False
    return True


def phase_serve(rec, cat, sf, seed):
    """The serving planes (see the module docstring, phase 8d): the TPC-H
    catalog behind one ServingTier and its MySQL and HTTP front doors on
    loopback ports, driven by real sockets, round by round; every check
    below fails the phase."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from starrocks_tpu_torch import lockdep
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime import config as cfgmod
    from starrocks_tpu_torch.runtime import failpoint, lifecycle
    from starrocks_tpu_torch.runtime import serving as serving_mod
    from starrocks_tpu_torch.runtime.audit import AUDIT
    from starrocks_tpu_torch.runtime.http_service import SqlHttpServer
    from starrocks_tpu_torch.runtime.lifecycle import ACCOUNTANT, REGISTRY
    from starrocks_tpu_torch.runtime.mysql_service import MySQLServer
    from starrocks_tpu_torch.runtime.serving import ServingTier
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.tpch_queries import (
        QUERIES, STAT_QUERIES, TOPN_QUERIES)

    config = cfgmod.config
    texts = {**{f"Q{i}": t for i, t in QUERIES.items()}, **STAT_QUERIES,
             **TOPN_QUERIES}
    out = {"sf": sf, "pool": SERVE_POOL, "mysql_clients": SERVE_MYSQL_CLIENTS,
           "http_clients": SERVE_HTTP_CLIENTS, "analytic": SERVE_ANALYTIC,
           "compaction_trigger_rowsets": 0}
    rec["serve"] = out
    failures = []
    knobs0 = {k: config.get(k) for k in (
        "enable_query_cache", "compaction_trigger_rowsets",
        "query_timeout_s", "query_mem_limit_bytes",
        *cfgmod.KERNEL_STRATEGIES)}
    tmp = tempfile.mkdtemp(prefix="serve_")
    servers, clients = [], []
    tier = None
    phase_t0 = time.perf_counter()
    try:
        template = Session(cat, device=CARD, data_dir=tmp)
        # the point lane's table: orders at --sf, PRIMARY KEY(o_orderkey),
        # written through the store path's DDL; auto-compaction off for the
        # phase (it would rewrite 15M rows every 8 point updates)
        config.set("compaction_trigger_rowsets", 0)
        orders = cat.get_table("orders").table
        t = time.perf_counter()
        template.sql(_store_ddl("orders", orders.schema).replace(
            "CREATE TABLE orders ", "CREATE TABLE orders_pk ", 1))
        cat.register("stage_orders_pk", orders)
        template.sql("INSERT INTO orders_pk SELECT * FROM stage_orders_pk")
        template.sql("DROP TABLE stage_orders_pk")
        out["orders_pk_load_s"] = time.perf_counter() - t
        log(f"  orders_pk: {orders.num_rows} rows stored in "
            f"{out['orders_pk_load_s']:.1f} s")

        def start_doors(pool):
            tr = ServingTier(template, pool_size=pool)
            my = MySQLServer(template, port=0, tier=tr).start()
            ht = SqlHttpServer(template, port=0, tier=tr).start()
            servers.extend([my, ht])
            return tr, my, ht

        def stop_doors(my, ht):
            ht.stop()
            my.shutdown()
            servers.remove(my)
            servers.remove(ht)

        # the strategies, set over the wire by an admin connection: SET
        # takes the gate's exclusive side (pool 1 tier: the first doors)
        tier1, my1, ht1 = start_doors(1)
        admin = MySQLClient(my1.port)
        clients.append(admin)
        for k, v in cfgmod.KERNEL_STRATEGIES.items():
            admin.query(f"SET {k} = '{v}'")
        admin.query("SET enable_query_cache = false")
        if any(config.get(k) != v
               for k, v in cfgmod.KERNEL_STRATEGIES.items()):
            raise PhaseError("SET over the wire did not set the strategies")

        # round 1: the reference answers through the template Session
        t = time.perf_counter()
        want = {}
        for q in (*SERVE_ANALYTIC, *SERVE_HASH, "S2"):
            want[q] = template.sql(texts[q]).table.to_pylist()
        out["round1_s"] = time.perf_counter() - t
        # the launches read at the end are those of the statements sent
        # through the doors, not round 1's
        kernels.reset_counts()
        mem_before = _settled_allocated(kernels)
        cache_before = _cache_bytes(template.cache)
        log(f"  round 1 (reference answers, cold): {out['round1_s']:.1f} s; "
            f"{mem_before / 1e9:.2f} GB allocated, "
            f"{cache_before / 1e9:.2f} GB of it the DeviceCache's")
        audit0 = AUDIT.stats()["registered"]
        sent = [0]  # statements that reach Session.sql over the doors
        sent_lock = threading.Lock()

        def count(n=1):
            with sent_lock:
                sent[0] += n

        def analytic_round(my, ht, passes, lat):
            """Every client runs the analytic set `passes` times, rotated
            by client; each answer held to round 1's."""
            errors = []
            names = list(SERVE_ANALYTIC)

            def mysql_client(i):
                c = MySQLClient(my.port)
                try:
                    for _ in range(passes):
                        for k in range(len(names)):
                            q = names[(i + k) % len(names)]
                            t0 = time.perf_counter()
                            _, rows = c.query(texts[q])
                            lat.append((time.perf_counter() - t0) * 1e3)
                            count()
                            if not _wire_agree(rows, want[q],
                                               SERVE_REL.get(q, 1e-6)):
                                errors.append(f"mysql {q}")
                finally:
                    c.quit()

            def http_client(i):
                for _ in range(passes):
                    for k in range(len(names)):
                        q = names[(i + k) % len(names)]
                        t0 = time.perf_counter()
                        body = _http_query(ht.port, texts[q])
                        lat.append((time.perf_counter() - t0) * 1e3)
                        count()
                        if not _wire_agree(body["rows"], want[q],
                                           SERVE_REL.get(q, 1e-6)):
                            errors.append(f"http {q}")

            def guard(fn, i):
                try:
                    fn(i)
                except Exception as e:  # noqa: BLE001 — a failed check
                    errors.append(f"{fn.__name__} {i}: "
                                  f"{type(e).__name__}: {e}")

            ths = [threading.Thread(target=guard, args=(mysql_client, i))
                   for i in range(SERVE_MYSQL_CLIENTS)]
            ths += [threading.Thread(
                target=guard, args=(http_client, SERVE_MYSQL_CLIENTS + i))
                for i in range(SERVE_HTTP_CLIENTS)]
            t0 = time.perf_counter()
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            wall = time.perf_counter() - t0
            n = passes * len(names) * len(ths)
            return {"statements": n, "wall_s": wall, "qps": n / wall,
                    **_pcts(lat)}, errors

        # round 2: cold (no result cache), pool 1, then pool 4
        for pool in (1, SERVE_POOL):
            if pool == SERVE_POOL:
                stop_doors(my1, ht1)
                tier, my, ht = start_doors(SERVE_POOL)
            else:
                tier, my, ht = tier1, my1, ht1
            w0 = serving_mod.SERVE_QUEUE_WAIT_MS.value
            torch.cuda.reset_peak_memory_stats()
            lat = []
            r, errors = analytic_round(my, ht, 1, lat)
            r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            r["pool_wait_ms"] = serving_mod.SERVE_QUEUE_WAIT_MS.value - w0
            out[f"cold_pool{pool}"] = r
            failures += [f"cold pool {pool}: {e}" for e in errors]
            log(f"  round 2, pool {pool}: {r['statements']} statements in "
                f"{r['wall_s']:.1f} s, {r['qps']:.2f} QPS, p50 "
                f"{r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms, pool wait "
                f"{r['pool_wait_ms']} ms, peak {r['peak_mem_gb']:.2f} GB")
        out["qps_ratio_pool4_over_pool1"] = (
            out[f"cold_pool{SERVE_POOL}"]["qps"] / out["cold_pool1"]["qps"])
        admin.quit()
        clients.remove(admin)
        admin = MySQLClient(my.port)
        clients.append(admin)

        # round 3: the point lane (COM_STMT_PREPARE/EXECUTE) on orders_pk
        fast0 = serving_mod.SERVE_POINT_INLINE.value
        from starrocks_tpu_torch.runtime import point as point_mod

        lookups0 = point_mod.POINT_LOOKUPS.value
        keys = np.asarray(orders.arrays["o_orderkey"])
        rng = np.random.default_rng(seed)
        slices = np.array_split(rng.permutation(len(keys)),
                                SERVE_MYSQL_CLIENTS)
        point_lat, update_lat, perrors = [], [], []

        def point_client(i):
            c = MySQLClient(my.port)
            try:
                mine = keys[slices[i][:SERVE_POINT_SELECTS]]
                comments = {}
                for j, k in enumerate(mine[:SERVE_POINT_UPDATES]):
                    text = f"serve client {i} update {j}"
                    t0 = time.perf_counter()
                    c.query(f"UPDATE orders_pk SET o_comment = '{text}' "
                            f"WHERE o_orderkey = {int(k)}")
                    update_lat.append((time.perf_counter() - t0) * 1e3)
                    count()
                    comments[int(k)] = text
                expect = _orders_expected(orders, mine, comments)
                sid, _, _ = c.stmt_prepare(
                    "SELECT * FROM orders_pk WHERE o_orderkey = ?")
                for k in mine:
                    t0 = time.perf_counter()
                    _, rows = c.stmt_execute(sid, [int(k)])
                    point_lat.append((time.perf_counter() - t0) * 1e3)
                    count()
                    got = rows[0] if len(rows) == 1 else None
                    if len(rows) > 1 or not _point_agree(got,
                                                        expect[int(k)]):
                        perrors.append(f"client {i} key {int(k)}: {rows} "
                                       f"!= {expect[int(k)]}")
            finally:
                c.quit()

        def guard_point(i):
            try:
                point_client(i)
            except Exception as e:  # noqa: BLE001 — a failed check
                perrors.append(f"point client {i}: {type(e).__name__}: {e}")

        ths = [threading.Thread(target=guard_point, args=(i,))
               for i in range(SERVE_MYSQL_CLIENTS)]
        t0 = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        out["point"] = {
            "wall_s": time.perf_counter() - t0,
            "select": _pcts(point_lat), "update": _pcts(update_lat),
            "lane_statements": point_mod.POINT_LOOKUPS.value - lookups0,
            "inline": serving_mod.SERVE_POINT_INLINE.value - fast0}
        failures += perrors[:10]
        n_point = SERVE_MYSQL_CLIENTS * (
            SERVE_POINT_SELECTS + min(SERVE_POINT_UPDATES,
                                      SERVE_POINT_SELECTS))
        if out["point"]["lane_statements"] != n_point:
            failures.append(f"point lane served "
                            f"{out['point']['lane_statements']} of {n_point}")
        log(f"  round 3, point lane: selects {out['point']['select']}, "
            f"updates {out['point']['update']}, "
            f"{out['point']['lane_statements']} on the lane, "
            f"{out['point']['inline']} inline")

        # round 4: warm, the result cache on; the second pass must ride the
        # inline fast path, every statement of it
        admin.query("SET enable_query_cache = true")
        count()
        if not config.get("enable_query_cache"):
            raise PhaseError("SET enable_query_cache over the wire failed")
        torch.cuda.reset_peak_memory_stats()
        lat1 = []
        r1, errors = analytic_round(my, ht, 1, lat1)
        failures += [f"warm pass 1: {e}" for e in errors]
        fp0 = serving_mod.SERVE_FAST_PATH.value
        lat2 = []
        r2, errors = analytic_round(my, ht, SERVE_WARM_PASSES - 1, lat2)
        failures += [f"warm pass 2: {e}" for e in errors]
        fast_hits = serving_mod.SERVE_FAST_PATH.value - fp0
        out["warm"] = {"pass1": r1, "fast_path": r2,
                       "fast_path_hits": fast_hits,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if fast_hits != r2["statements"]:
            failures.append(f"warm pass 2: {fast_hits} of "
                            f"{r2['statements']} on the fast path")
        log(f"  round 4, warm: pass 1 {r1['qps']:.2f} QPS; pass 2 "
            f"{fast_hits} fast-path hits, p50 {r2.get('p50_ms', 0):.3f} ms, "
            f"p99 {r2.get('p99_ms', 0):.3f} ms; peak "
            f"{out['warm']['peak_mem_gb']:.2f} GB")
        admin.query("SET enable_query_cache = false")
        count()

        # the hash kernels: Q9 and Q20 under join_probe_strategy 'pallas'
        admin.query("SET join_probe_strategy = 'pallas'")
        count()
        herr = []

        def hash_client(i):
            c = MySQLClient(my.port)
            try:
                for q in SERVE_HASH:
                    _, rows = c.query(texts[q])
                    count()
                    if not _wire_agree(rows, want[q], 1e-6):
                        herr.append(f"{q}@pallas client {i}")
            except Exception as e:  # noqa: BLE001 — a failed check
                herr.append(f"hash client {i}: {type(e).__name__}: {e}")
            finally:
                c.quit()

        ths = [threading.Thread(target=hash_client, args=(i,))
               for i in range(SERVE_MYSQL_CLIENTS)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        failures += herr
        admin.query("SET join_probe_strategy = 'pallas_sorted'")
        count()

        # round 5: the lifecycle over the wire
        life = out["lifecycle"] = {}

        def hold_at(site):
            reached, release = threading.Event(), threading.Event()

            def action():
                reached.set()
                release.wait(120)

            failpoint.arm(site, action=action, times=1)
            return reached, release

        def run_in_thread(client, sql, box):
            def body():
                try:
                    box["rows"] = client.query(sql)
                except Exception as e:  # noqa: BLE001 — recorded
                    box["err"] = f"{type(e).__name__}: {e}"
            th = threading.Thread(target=body)
            th.start()
            return th

        def processlist_id(snippet, stage=None):
            _, rows = admin.query("SHOW PROCESSLIST")
            for r in rows:
                if snippet in r[-1] and (stage is None or r[-2] == stage):
                    return int(r[0])
            return None

        # KILL QUERY of S2, held after its program ran (fetch checkpoint)
        victim = MySQLClient(my.port)
        clients.append(victim)
        victim.query(texts["S2"])  # warm: its columns placed
        count()
        torch.cuda.synchronize()
        before_kill = torch.cuda.memory_allocated() - _diag_bytes(kernels)
        reached, release = hold_at("executor::fetch_results")
        box = {}
        th = run_in_thread(victim, texts["S2"], box)
        count()
        try:
            if not reached.wait(300):
                raise PhaseError("S2 never reached its fetch checkpoint")
            qid = processlist_id("stddev")
            t0 = time.perf_counter()
            admin.query(f"KILL QUERY {qid}")
        finally:
            release.set()
            th.join()
            failpoint.disarm("executor::fetch_results")
        unwind_ms = (time.perf_counter() - t0) * 1e3
        # the client holds the ERR packet; the server's threads may still
        # be leaving the statement's frames: COM_PING returns once the
        # connection thread is done, the reading waits out the worker
        victim.ping()
        t1 = time.perf_counter()
        after_kill = _allocated_down_to(kernels, before_kill)
        life["kill"] = {"qid": qid, "error": box.get("err", ""),
                        "unwind_ms": unwind_ms,
                        "settle_ms": (time.perf_counter() - t1) * 1e3,
                        "mem_before_gb": before_kill / 1e9,
                        "mem_after_gb": after_kill / 1e9}
        if "QueryCancelledError" not in box.get("err", ""):
            failures.append(f"KILL of S2: {box}")
        if after_kill != before_kill:
            failures.append(f"KILL of S2 left {after_kill - before_kill} "
                            "bytes allocated")

        # query_timeout_s: Q3's clock moves past the deadline at dispatch
        admin.query("SET query_timeout_s = 30")
        count()

        def advance():
            ctx = lifecycle.current()
            ctx.t0 -= 60.0
            ctx.deadline -= 60.0

        failpoint.arm("executor::before_dispatch", action=advance, times=1)
        try:
            victim.query(texts["Q3"])
            err = ""
        except RuntimeError as e:
            err = str(e)
        finally:
            failpoint.disarm("executor::before_dispatch")
        count()
        admin.query("SET query_timeout_s = 0")
        count()
        life["timeout_error"] = err
        if "QueryTimeoutError" not in err:
            failures.append(f"query_timeout_s: {err!r}")

        # query_mem_limit_bytes: Q6's scan alone passes 1 MiB
        admin.query(f"SET query_mem_limit_bytes = {1 << 20}")
        count()
        try:
            victim.query(texts["Q6"])
            err = ""
        except RuntimeError as e:
            err = str(e)
        count()
        admin.query("SET query_mem_limit_bytes = 0")
        count()
        life["mem_limit_error"] = err
        if "MemLimitExceeded" not in err:
            failures.append(f"query_mem_limit_bytes: {err!r}")

        # a query queued behind a resource group with one slot
        admin.query("CREATE RESOURCE GROUP rg_serve WITH "
                    "(concurrency_limit = 1)")
        count()
        a, b = MySQLClient(my.port), MySQLClient(my.port)
        clients += [a, b]
        for c in (a, b):
            c.query("SET resource_group = 'rg_serve'")
            count()
        reached, release = hold_at("executor::before_dispatch")
        box_a, box_b = {}, {}
        th_a = run_in_thread(a, texts["Q6"], box_a)
        count()
        try:
            if not reached.wait(300):
                raise PhaseError("the slot holder never reached dispatch")
            th_b = run_in_thread(b, texts["Q6"], box_b)
            count()
            qid_b = None
            t_end = time.monotonic() + 60
            while qid_b is None and time.monotonic() < t_end:
                qid_b = processlist_id("l_discount", "workgroup::queued")
        finally:
            release.set()
            th_a.join()
            failpoint.disarm("executor::before_dispatch")
        th_b.join()
        entry = next((e for e in reversed(template.catalog.query_log)
                      if e["query_id"] == qid_b), None)
        life["queued"] = {"qid": qid_b, "queue_wait_ms":
                          entry and entry["queue_wait_ms"],
                          "a": "rows" in box_a, "b": "rows" in box_b}
        if qid_b is None:
            failures.append("the second rg_serve query never queued")
        for tag, bx in (("holder", box_a), ("queued", box_b)):
            if "rows" not in bx or not _wire_agree(bx["rows"][1], want["Q6"],
                                                   1e-6):
                failures.append(f"rg_serve {tag}: {bx}")
        for c in (a, b):
            c.query("SET resource_group = ''")
            count()
        admin.query("DROP RESOURCE GROUP rg_serve")
        count()

        # EXPLAIN ANALYZE of Q3: the annotated tree, one row per line
        _, rows = admin.query("EXPLAIN ANALYZE " + texts["Q3"])
        count()
        lines = [r[0] for r in rows]
        life["explain_analyze_lines"] = len(lines)
        if not any("[#" in ln and "rows=" in ln for ln in lines):
            failures.append("EXPLAIN ANALYZE: no observed rows annotated")
        cols, _ = admin.query("SHOW PROCESSLIST")
        life["processlist_columns"] = cols
        if cols[:2] != ["Id", "User"]:
            failures.append(f"SHOW PROCESSLIST columns {cols}")
        # the HTTP observability endpoints
        http_status = {}
        for path in ("/metrics", "/api/queries", "/api/audit"):
            st, body = _http_get(ht.port, path)
            http_status[path] = st
            if st != 200 or not body:
                failures.append(f"GET {path}: {st}")
        last = AUDIT.snapshot(limit=1)[-1]["query_id"]
        st, body = _http_get(ht.port, f"/api/query/{last}/profile")
        http_status["/api/query/<id>/profile"] = st
        if st != 200 or b"profile" not in body:
            failures.append(f"GET /api/query/{last}/profile: {st}")
        st, body = _http_get(ht.port, "/api/ingest")
        http_status["/api/ingest"] = st
        if st != 200 or b'"ingest"' not in body:
            failures.append(f"GET /api/ingest: {st} {body[:80]!r}")
        life["http"] = http_status
        metrics_text = _http_get(ht.port, "/metrics")[1].decode()
        out["metrics"] = {k: v for k, v in (
            ln.rsplit(" ", 1) for ln in metrics_text.splitlines()
            if ln.startswith(("sr_tpu_serve_", "sr_tpu_point_",
                              "sr_tpu_admission_", "sr_tpu_queries_"))
            and "{" not in ln)}

        # the audit log: one record per statement sent
        AUDIT.flush()
        out["audit_records"] = AUDIT.stats()["registered"] - audit0
        out["statements_sent"] = sent[0]
        if out["audit_records"] != sent[0]:
            failures.append(f"audit: {out['audit_records']} records for "
                            f"{sent[0]} statements")
        log(f"  round 5, lifecycle: {life}")
    finally:
        failpoint.disarm("executor::fetch_results")
        failpoint.disarm("executor::before_dispatch")
        for c in clients:
            try:
                c.quit()
            except OSError:
                pass
        for srv in list(servers):
            if isinstance(srv, MySQLServer):
                srv.shutdown()
            else:
                srv.stop()
        try:
            template.sql("DROP TABLE IF EXISTS orders_pk")
        except Exception:  # noqa: BLE001 — the phase already failed
            traceback.print_exc()
        set_knobs(knobs0)
        shutil.rmtree(tmp, ignore_errors=True)
    # after the tier's shutdown: nothing running, queued or charged
    torch.cuda.synchronize()
    wm = template.catalog.workgroups
    qs = wm.queue_stats() if wm is not None else {"running": 0, "queued": 0}
    acct = ACCOUNTANT.snapshot()
    mem_after = _settled_allocated(kernels)
    cache_after = _cache_bytes(template.cache)
    cycles = lockdep.WITNESS.order_cycles()
    out["teardown"] = {
        "registry": len(REGISTRY.snapshot()), "running": qs["running"],
        "queued": qs["queued"], "accountant_bytes": acct["process_bytes"],
        "mem_before_gb": mem_before / 1e9, "mem_after_gb": mem_after / 1e9,
        "kernel_diagnostics_bytes": _diag_bytes(kernels),
        "cache_growth_gb": (cache_after - cache_before) / 1e9,
        "lock_witness": lockdep.enabled(), "lock_cycles": len(cycles)}
    if REGISTRY.snapshot() or qs["running"] or qs["queued"]:
        failures.append(f"teardown: {out['teardown']}")
    if acct["process_bytes"] or acct["group_bytes"]:
        failures.append(f"accountant not empty: {acct}")
    if mem_after - mem_before > max(cache_after - cache_before, 0):
        failures.append(f"device memory {mem_after - mem_before} bytes "
                        "above its value before the rounds, past the "
                        "DeviceCache's own placements (the kernels' "
                        "last-call diagnostics aside)")
    if cycles:
        failures.append(lockdep.WITNESS.render(cycles))
    got = _snapshot(kernels)
    out["launches"] = got
    out["shapes"] = {n: sorted(w.shapes) for n, w in kernels.WRAPPERS.items()}
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"  serve: launches {got}, teardown {out['teardown']}, "
        f"{out['phase_s']:.1f} s")
    missing = [n for n, v in got.items() if not v]
    if missing:
        failures.append(f"kernels not launched on the serve path: {missing}")
    del template
    if failures:
        raise PhaseError(f"serve: {failures[:12]}")


SERVE_CHILD_TIMEOUT_S = 600


def start_serve_child(args) -> dict:
    """Start the serve phase's process: this script with --serve-child
    and SR_TPU_LOCK_WITNESS=1, since the witness's factories read the
    variable when the package first loads and every other phase is timed
    with plain locks. The child generates its catalog at once (beside the
    generate phase, so the card's phases never share the host with it),
    then waits for a line on its stdin before it touches the card."""
    import tempfile

    d = Path(tempfile.mkdtemp(prefix="serve_child_"))
    cmd = [sys.executable, str(Path(__file__).resolve()),
           "--sf", repr(args.sf), "--seed", str(args.seed),
           "--serve-child", str(d / "serve.json")]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, env={
        **os.environ, "SR_TPU_LOCK_WITNESS": "1"})
    return {"proc": proc, "dir": d}


def run_serve_child(rec, child: dict):
    """Tell the serve child to go and wait for it: its record becomes
    rec["serve"]; a child that fails, or outlives SERVE_CHILD_TIMEOUT_S
    (then killed), fails the phase."""
    import shutil

    proc = child["proc"]
    try:
        proc.stdin.write(b"go\n")
        proc.stdin.close()
    except OSError:
        pass  # the child already ended: its record says why
    try:
        rc = proc.wait(timeout=SERVE_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise PhaseError(f"serve child killed after "
                         f"{SERVE_CHILD_TIMEOUT_S} s") from None
    path = child["dir"] / "serve.json"
    got = json.loads(path.read_text()) if path.exists() else {}
    shutil.rmtree(child["dir"], ignore_errors=True)
    if got.get("serve") is not None:
        rec["serve"] = {**got["serve"], "gen_s": got["gen_s"]}
    if rc != 0 or got.get("status") != "ok":
        raise PhaseError(f"serve child exit {rc}: "
                         f"{got.get('status', 'no record')}")


def stop_serve_child(child: dict):
    """Reap a serve child that was never told to go (a phase before it
    failed): it ends at the end of its stdin, or is killed."""
    import shutil

    proc = child.get("proc")
    if proc is None:
        return
    if proc.poll() is None:
        try:
            proc.stdin.close()
        except OSError:
            pass
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    shutil.rmtree(child["dir"], ignore_errors=True)


def serve_child(args) -> int:
    """--serve-child: generate the catalog, wait for "go" on stdin (end of
    input: exit without running), run phase_serve under the lock witness
    and write {"status", "gen_s", "serve"} to the named file."""
    from starrocks_tpu_torch import lockdep
    from starrocks_tpu_torch.storage.catalog import tpch_catalog

    rec, status, gen_s = {}, "ok", None
    t0 = time.perf_counter()
    try:
        if not lockdep.enabled():
            raise PhaseError("the lock witness is off (SR_TPU_LOCK_WITNESS)")
        cat = tpch_catalog(sf=args.sf, seed=args.seed)
        gen_s = time.perf_counter() - t0
        log(f"  serve child: TPC-H SF {args.sf:g} generated in {gen_s:.1f} s")
        if sys.stdin.readline().strip() != "go":
            return 0
        phase_serve(rec, cat, args.sf, args.seed)
    except Exception as e:  # noqa: BLE001 — reported to the parent
        traceback.print_exc()
        status = f"FAILED: {type(e).__name__}: {e}"
    Path(args.serve_child).write_text(json.dumps({
        "status": status, "gen_s": gen_s, "serve": rec.get("serve")}))
    return 0 if status == "ok" else 1


def _ns(event, what: str) -> int:
    """A raw profiler event's start or duration in ns (`start_ns()`, or
    `start_us()` where a torch build has only that)."""
    f = getattr(event, f"{what}_ns", None)
    return f() if f is not None else getattr(event, f"{what}_us")() * 1000


def trace_queries(s, texts, spans=()) -> dict:
    """One more warm run of each query, all under ONE torch.profiler
    session: per query the device's busy time (the summed durations of the
    kernels, copies and sets that start inside the query's range, not the
    device-side twins of record_function ranges; each query ends
    with a synchronize, so its kernels finish inside it), its idle share of
    the traced wall time, the kernels that took the most device time, and
    the device time under each of the profiler `spans` (record_function
    ranges: the device events whose launch lies inside one). It reads the
    profiler's raw event list: building torch.profiler's Python event tree
    costs ~2 s per TPC-DS query, more than the queries. The profiler slows
    the host side, so the traced wall time is not the query's wall time;
    the untraced warm runs are. The session is tried again where it
    recorded no device event (it has come back without any in long runs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    walls, kern = {}, []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for q, text in texts.items():
                t = time.perf_counter()
                with record_function(f"query::{q}"):
                    s.sql(text).rows()
                    torch.cuda.synchronize()
                walls[q] = time.perf_counter() - t
        raw = prof.profiler.kineto_results.events()
        host = [e for e in raw if e.device_type() != DeviceType.CUDA]
        host_names = {e.name() for e in host}
        # device events: kernels, copies and sets; a record_function range
        # also shows on the device's timeline, under its host name, and is
        # no work of its own
        kern = [(_ns(e, "start"), _ns(e, "duration"), e.name(),
                 e.correlation_id()) for e in raw
                if e.device_type() == DeviceType.CUDA
                and e.name() not in host_names]
        if kern:
            break
    ranges, span_ranges, launched = {}, [], {}
    for e in host:
        name = e.name()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if name.startswith("query::"):
            ranges[name[len("query::"):]] = (start, end)
        elif name in spans:
            span_ranges.append((name, start, end))
        elif name.startswith("cu"):
            # a launch (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel,
            # ...): its correlation id is the device event's
            launched[e.correlation_id()] = start
    res = {}
    attributed = 0
    for q in texts:
        r0, r1 = ranges[q]
        mine = [k for k in kern if r0 <= k[0] <= r1]
        by_name: dict = {}
        for _, dur, name, _ in mine:
            by_name[name] = by_name.get(name, 0) + dur
        busy = sum(by_name.values()) / 1e9
        attributed += sum(by_name.values())
        wall = walls[q]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        span_ms: dict = {}
        for name, a, b in span_ranges:
            if not r0 <= a <= r1:
                continue
            ms = sum(dur for _, dur, _, c in mine
                     if a <= launched.get(c, -1) <= b) / 1e6
            span_ms[name] = span_ms.get(name, 0.0) + ms
        res[q] = {
            "traced_wall_s": wall, "device_kernels": len(mine),
            "device_busy_s": busy if kern else None,
            "idle_share": (1 - busy / wall) if kern else None,
            "top": [[n[:80], ns / 1e6] for n, ns in top],
            "span_device_ms": span_ms,
        }
        log(f"  trace {qname(q)}: traced wall {wall * 1e3:.1f} ms, "
            f"{len(mine)} device kernels, busy "
            + (f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f}"
               if kern else "not measured (no device events)")
            + (f"; device ms by span {span_ms}" if spans else ""))
        for n, ns in top[:2]:
            log(f"      {ns / 1e6:8.2f} ms  {n[:90]}")
    total = sum(k[1] for k in kern)
    log(f"  traced {len(texts)} queries in one session: {total / 1e6:.1f} "
        f"ms of device time, {(total - attributed) / 1e6:.1f} ms of it "
        "outside every query's range")
    return res


def _colliding_keys(table_size: int, n: int, seed: int, slots=None):
    """n distinct keys whose home slot is one of `slots` (default T - 1,
    T - 2 and 5: long chains that wrap around the table's end)."""
    import numpy as np
    import torch

    from starrocks_tpu_torch.ops.common import mix64

    rng = np.random.default_rng(seed)
    want = torch.tensor(slots if slots is not None
                        else [table_size - 1, table_size - 2, 5])
    found = []
    while sum(len(f) for f in found) < n:
        cand = torch.from_numpy(
            rng.integers(-(1 << 62), 1 << 62, 1 << 20, dtype=np.int64))
        slot = mix64(cand) & (table_size - 1)
        found.append(cand[torch.isin(slot, want)])
    return torch.unique(torch.cat(found)[:n])


def _table_errors(keys, tkey, trow) -> list:
    """What is wrong with a linear-probing table over `keys` ([] if
    nothing): every non-sentinel key exactly once, with its row, and -1 in
    every empty slot; and the chain invariant — for every occupied slot s
    holding key k, every slot from home(k) to s, cyclically, is occupied.
    Works on the occupied slots alone, so it also checks 2^31 slots."""
    import torch

    from starrocks_tpu_torch.ops.common import mix64

    t = tkey.shape[0]
    errors = []
    idx = torch.nonzero(tkey != I64MAX).flatten()
    live = int((keys != I64MAX).sum())
    if idx.numel() != live:
        errors.append(f"{idx.numel()} occupied slots for {live} keys")
    if bool(((tkey == I64MAX) & (trow != -1)).any()):
        errors.append("an empty slot has a row")
    if idx.numel() == 0:
        return errors
    rows = trow[idx].to(torch.int64)
    if (int(rows.min()) < 0 or int(rows.max()) >= keys.shape[0]
            or torch.unique(rows).numel() != rows.numel()
            or not bool((keys[rows] == tkey[idx]).all())):
        errors.append("a slot's row does not hold its key")
    # the run of occupied slots that ends at each occupied slot
    starts = torch.ones_like(idx, dtype=torch.bool)
    starts[1:] = idx[1:] != idx[:-1] + 1
    pos = torch.arange(idx.numel(), device=idx.device)
    first = torch.cummax(torch.where(starts, pos, 0), 0).values
    run = idx - idx[first] + 1
    if int(idx[0]) == 0 and int(idx[-1]) == t - 1:  # through T - 1 -> 0
        run = torch.where(first == 0, run + (t - idx[first[-1]]), run)
    disp = (idx - (mix64(tkey[idx]) & (t - 1))) % t
    broken = int((disp >= run).sum())
    if broken:
        errors.append(f"{broken} keys break the chain invariant")
    return errors


def _key_rows(keys, tkey, trow):
    """The row each table slot gives each live key, in key order."""
    import torch

    occ = tkey != I64MAX
    k, r = tkey[occ], trow[occ].to(torch.int64)
    order = torch.argsort(k)
    return r[order]


def _oracle_rows(keys, probe):
    """The build row of each probe key, -1 where none, by a sort."""
    import torch

    rows = torch.nonzero(keys != I64MAX).flatten()
    k = keys[rows]
    if k.numel() == 0:
        return torch.full(probe.shape, -1, dtype=torch.int32,
                          device=probe.device)
    order = torch.argsort(k)
    sk, sr = k[order], rows[order]
    at = torch.searchsorted(sk, probe).clamp(max=sk.numel() - 1)
    hit = (sk[at] == probe) & (probe != I64MAX)
    return torch.where(hit, sr[at], -1).to(torch.int32)


def _hash_main_case(dev, build_shape, m, seed):
    """(name, keys, table_size, probe) on the card at the main path's
    shapes: unique keys in Q9's packed (partkey, suppkey) style with a
    dead-row tail, probes hitting ~90% and missing the rest, a few dead."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n, t = build_shape
    live = int(n * 0.9995)
    keys = np.full(n, I64MAX, np.int64)
    keys[:live] = (rng.permutation(live).astype(np.int64) << 20) | (
        rng.integers(0, 1 << 20, live))
    hits = keys[rng.integers(0, live, m)]
    miss = rng.integers(0, 1 << 60, m)
    probe = np.where(rng.random(m) < 0.9, hits, miss)
    probe[rng.random(m) < 0.01] = I64MAX  # dead probe rows
    return ("main_path_shape", torch.from_numpy(keys).to(dev), t,
            torch.from_numpy(probe).to(dev))


def _hash_cases(dev, seed):
    """(name, keys, table_size, probe) on the card: the edges of the
    partitioned kernels' slices."""
    import numpy as np
    import torch

    from starrocks_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    cases = []
    edge = np.array([0, 1, -1, 2, -2, I64MIN, I64MIN + 1, I64MAX - 1,
                     1 << 31, -(1 << 31), (1 << 62), -(1 << 62), I64MAX,
                     I64MAX], np.int64)
    eprobe = np.concatenate([edge, [3, -3, I64MAX - 2],
                             np.zeros(1024 - len(edge) - 3, np.int64)])
    cases.append(("int64_extremes_and_sentinels", edge, 64, eprobe))
    ck = _colliding_keys(1024, 400, seed).numpy()
    cprobe = np.concatenate([ck[::-1], ck + 1, np.full(2048 - 2 * len(ck), I64MAX)])
    cases.append(("heavy_collisions", ck, 1024, cprobe))

    def fill(aimed, count):  # `aimed` plus random distinct keys, count in all
        extra = np.setdiff1d(rng.integers(-(1 << 62), 1 << 62, 2 * count),
                             aimed)[:count - len(aimed)]
        return rng.permutation(np.concatenate([aimed, extra]))

    def probes(k):  # every live key, its neighbour, misses, sentinels
        lk = k[k != I64MAX]
        return np.concatenate([lk[::-1], lk + 1,
                               rng.integers(-(1 << 62), 1 << 62, 1000),
                               [I64MAX, 0, -1]])

    s = kernels.hash_partition_layout(1 << 31).slice_slots
    ts = 4 * s  # chains across the end of an inner slice, and T - 1 -> 0
    k = fill(_colliding_keys(ts, 300, seed, [2 * s - 1, 2 * s - 2,
                                             2 * s - 3]).numpy(), ts // 2 - 7)
    cases.append(("inner_slice_end", k, ts, probes(k)))
    k = fill(_colliding_keys(ts, 200, seed, [ts - 1, ts - 2]).numpy(), ts // 4)
    cases.append(("table_end_wraps", k, ts, probes(k)))
    for name, tt in (("t_below_slice", s // 2), ("t_equals_slice", s)):
        k = fill(_colliding_keys(tt, 40, seed, [tt - 1]).numpy(), tt // 2)
        cases.append((name, k, tt, probes(k)))
    # one key in most probes: its slice's places run out, and the rest of
    # those probes walk directly
    k = fill(np.zeros(0, np.int64), s // 2)
    cases.append(("skewed_probe", k, 4 * s,
                  np.concatenate([np.full(5 * s // 2, k[7]), probes(k)])))
    cases.append(("n0", np.zeros(0, np.int64), 2 * s,
                  rng.integers(-100, 100, 1000)))
    cases.append(("all_sentinel_keys", np.full(100, I64MAX), 256,
                  np.array([I64MAX, 0, 1, I64MAX - 1])))
    k = fill(np.zeros(0, np.int64), 1000)
    cases.append(("m0", k, 2048, np.zeros(0, np.int64)))
    cases.append(("all_sentinel_probes", k, 2048, np.full(3000, I64MAX)))
    # more slices than the probe's one scatter pass takes (8192: it walks
    # directly); more than a shared-memory histogram holds (2^15): the
    # build counts and scatters through global atomics; and the largest
    # table the build takes, 2^31 slots (64-bit slot arithmetic; the probe
    # takes tables below 2^31 slots, so it has no probe)
    k = fill(np.zeros(0, np.int64), 1 << 20)
    cases.append(("t_2_26", k, 1 << 26, probes(k)))
    cases.append(("t_2_28", k, 1 << 28, probes(k)))
    cases.append(("t_2_31", k, 1 << 31, np.zeros(0, np.int64)))
    return [(nm, torch.from_numpy(np.ascontiguousarray(k, np.int64)).to(dev),
             tt, torch.from_numpy(np.ascontiguousarray(p, np.int64)).to(dev))
            for nm, k, tt, p in cases]


def phase_kernels(rec, seed, only=None):
    """Every kernel against its plain version and timed (see the module
    docstring, phase 9); `only` names the checks to run (default all).
    Each kernel's check runs even where an earlier one failed; the phase
    fails if any did."""
    import torch

    from starrocks_tpu_torch.ops import kernels

    dev = torch.device(CARD)
    shapes = {n: [] for n in kernels.WRAPPERS}
    for path in ("hash_topn", "tpch", "topn", "breadth", "functions",
                 "spill", "ssb", "store", "lake", "dist", "serve", "tpcds"):
        for n, v in (rec.get(path) or {}).get("shapes", {}).items():
            shapes[n] += [tuple(x) for x in v]
    build_shape = max(shapes["hash_build"] or [DEFAULT_SHAPES["hash_build"]])
    probe_shapes = sorted(set(shapes["hash_probe"]) or Q9_PROBE_SHAPES)
    # the top-N and sorted-probe kernels at every shape their paths gave
    topn_shapes = sorted(set(shapes["topn_select"])
                         or DEFAULT_SHAPES["topn_select"])
    sorted_shapes = sorted(set(shapes["probe_searchsorted"])
                           or [DEFAULT_SHAPES["probe_searchsorted"]])
    # the segment-sum kernel at every shape its paths gave it
    segsum_shapes = sorted(set(shapes["segment_sum"])
                           or [DEFAULT_SHAPES["segment_sum"]])
    log(f"kernels: shapes build {build_shape} probe {probe_shapes} "
        f"topn {topn_shapes} sorted probe {sorted_shapes} segment sum "
        f"{segsum_shapes}")
    results = {n: {} for n in kernels.WRAPPERS}
    failures = []
    checks = [
        ("hash", lambda: _check_hash(dev, build_shape, probe_shapes, seed,
                                     failures, results)),
        ("topn_select", lambda: _check_topn(dev, topn_shapes, seed, failures,
                                            results["topn_select"])),
        ("probe_searchsorted", lambda: _check_probe_searchsorted(
            dev, sorted_shapes, seed, failures,
            results["probe_searchsorted"])),
        ("segment_sum", lambda: _check_segment_sum(
            dev, segsum_shapes, seed, failures, results["segment_sum"])),
    ]
    for name, check in checks:
        if only and name not in only:
            continue
        try:
            check()
        except Exception as e:  # report it, run the other kernels' checks
            traceback.print_exc()
            failures.append(f"{name}: {type(e).__name__}: {e}")
    if not only and rec.get("dist"):
        try:
            _time_dist_shapes(dev, rec["dist"]["shapes"], seed, results)
        except Exception as e:  # report it with the checks' failures
            traceback.print_exc()
            failures.append(f"dist timing: {type(e).__name__}: {e}")
    if not only or {"probe_searchsorted", "segment_sum"} & set(only):
        for path in ("spill",):
            try:
                _time_path_shapes(dev, path, (rec.get(path) or {}).get(
                    "shapes", {}), seed, results)
            except Exception as e:  # report it with the checks' failures
                traceback.print_exc()
                failures.append(f"{path} timing: {type(e).__name__}: {e}")
    for nm, r in results.items():
        if "ms" not in r:
            continue
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        log(f"  {nm}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {r['share_of_bound']:.3f} of it), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms at "
            f"{r['shape']}")
    rec["kernels"] = results
    if failures:
        raise PhaseError(f"kernel/plain mismatches: {failures}")


def _time_dist_shapes(dev, shapes, seed, results):
    """Each kernel at the largest per-shard shape the dist path gave it,
    kept in results[kernel]["dist"] as every path's timings are: the sorted
    probe and the segment sum through _time_path_shapes, the hash pair
    through _time_hash (the build at the largest build shape, the probe at
    the largest probe's count). The top-N select's checks time it at every
    path shape already, and the checks hold every kernel to its plain
    version at every one of these shapes."""
    import numpy as np

    largest = {n: [max(map(tuple, v), key=lambda x: (int(np.prod(x)), x))]
               for n, v in shapes.items() if v}
    _time_path_shapes(dev, "dist", largest, seed, results)
    if "hash_build" in largest and "hash_probe" in largest:
        [build], [(_, m)] = largest["hash_build"], largest["hash_probe"]
        _, keys, t, probe = _hash_main_case(dev, build, m, seed)
        timed = {"hash_build": {}, "hash_probe": {}}
        _time_hash(keys, t, probe, [m], timed)
        for name, r in timed.items():
            results[name].setdefault("dist", []).append(r)


def _time_path_shapes(dev, path, shapes, seed, results):
    """The sorted probe and the segment sum timed at each shape `path` (the
    spill or the dist path) launched them with (random inputs of that
    shape: sorted distinct build keys, uniform probes; four live groups of
    discount-like values): the kernel, its plain version and the library
    call with CUDA events, beside the bound (the checks' formulas), kept
    in a list under results[kernel][path]. The top-N select's checks time
    it at every path shape already."""
    import numpy as np
    import torch

    from starrocks_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    for k, n in shapes.get("probe_searchsorted", ()):
        build = torch.from_numpy(np.sort(rng.choice(
            1 << 40, size=k, replace=False))).to(dev)
        probe = torch.from_numpy(rng.integers(0, 1 << 40, n)).to(dev)
        b = bound_ms(k * 8 + n * 8 + n * 4, n * max(k, 1).bit_length() * 3)
        r = {"shape": [k, n], "bound_ms": b[0], "bound_by": b[1],
             "ms": cuda_ms(lambda: kernels.probe_searchsorted(build, probe)),
             "plain_ms": cuda_ms(lambda: kernels.probe_searchsorted_plain(
                 build, probe), reps=2),
             "library_ms": cuda_ms(lambda: torch.searchsorted(
                 build, probe, out_int32=True))}
        results["probe_searchsorted"].setdefault(path, []).append(r)
    for n, m, g, block in shapes.get("segment_sum", ()):
        gid = torch.from_numpy(rng.integers(0, min(g, 4), n).astype(
            np.int32)).to(dev)
        vals = torch.from_numpy((rng.integers(0, 11, (n, m)) / 100.0).astype(
            np.float32)).to(dev)
        b = bound_ms(n * 4 + n * m * 4 + g * m * 4, n * m)

        def library():
            acc = torch.zeros((g + 1, m), dtype=torch.float32, device=dev)
            return acc.index_add_(0, gid, vals)

        r = {"shape": [n, m, g, block], "bound_ms": b[0], "bound_by": b[1],
             "ms": cuda_ms(lambda: kernels.segment_sum(gid, vals, g, block)),
             "plain_ms": cuda_ms(lambda: kernels.segment_sum_plain(
                 gid, vals, g, block), reps=2),
             "library_ms": cuda_ms(library)}
        results["segment_sum"].setdefault(path, []).append(r)
    for name in ("probe_searchsorted", "segment_sum"):
        for r in results[name].get(path, ()):
            log(f"  {name} at the {path} shape {r['shape']}: {r['ms']:.4f} "
                f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
                f"plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms")


def _time_hash(keys, t, probe, probe_ms, results):
    """The build at the main path's shape, and the probe at each of the
    path's probe counts `probe_ms` (prefixes of `probe`), through the
    wrappers, beside their bounds, plain versions and library yardsticks.
    Uses only what every version of the wrappers has."""
    import torch

    from starrocks_tpu_torch.ops import kernels

    n = keys.shape[0]
    build_ms = cuda_ms(lambda: kernels.hash_build(keys, t))
    log(f"  hash_build at N={n} T={t}: {build_ms:.4f} ms")
    tk, tr = kernels.hash_build(keys, t)
    by_m = {}
    for m in probe_ms:
        p = probe[:m]
        by_m[m] = cuda_ms(lambda: kernels.hash_probe(tk, tr, p))
        log(f"  hash_probe at T={t} M={m}: {by_m[m]:.4f} ms")
    m = max(probe_ms)
    ptk, ptr = kernels.hash_build_plain(keys, t)
    build_plain = cuda_ms(lambda: kernels.hash_build_plain(keys, t), reps=2)
    probe_plain = cuda_ms(lambda: kernels.hash_probe_plain(ptk, ptr, probe),
                          reps=2)
    srt = torch.sort(keys, stable=True).values
    lib_build = cuda_ms(lambda: torch.sort(keys, stable=True))
    lib_probe = cuda_ms(lambda: torch.searchsorted(srt, probe))
    # bytes: keys in, (key, row) table out; probe keys + table in, rows
    # out. ops: ~12 integer ops of splitmix64 + slot math per key, plus one
    # compare per chain step (~1.5 at load <= 0.5)
    b_bound = bound_ms(n * 8 + t * 12, n * 16)
    results["hash_build"].update({
        "ms": build_ms, "plain_ms": build_plain, "library_ms": lib_build,
        "bound_ms": b_bound[0], "bound_by": b_bound[1], "shape": [n, t]})
    p_bound = {k: bound_ms(k * 8 + t * 12 + k * 4, k * 18) for k in by_m}
    results["hash_probe"].update({
        "ms": by_m[m], "plain_ms": probe_plain, "library_ms": lib_probe,
        "bound_ms": p_bound[m][0], "bound_by": p_bound[m][1],
        "shape": [t, m], "ms_by_m": {str(k): v for k, v in by_m.items()},
        "bound_ms_by_m": {str(k): b[0] for k, b in p_bound.items()}})


def _force_route(kernels, route):
    """Make `hash_partition_layout` pick `route` for every probe, through
    its byte rule (what a probe of the direct walk costs)."""
    kernels.HASH_RANDOM_BYTES = 0 if route == "direct" else 1 << 40


def _hash_routes(keys, t, probe, probe_ms, results):
    """Each probe route timed at each of the path's probe counts, the
    build's overflow count, the scratch bytes beyond the outputs, and the
    split of both kernels by device kernel."""
    import torch

    from starrocks_tpu_torch.ops import kernels

    tk, tr = kernels.hash_build(keys, t)
    torch.cuda.synchronize()
    deferred = int(kernels.hash_build.last_deferred.sum())
    lay = kernels.hash_partition_layout(t, max(probe_ms))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.hash_build(keys, t)
    torch.cuda.synchronize()
    build_scratch = torch.cuda.max_memory_allocated() - base - t * 12
    random_bytes = kernels.HASH_RANDOM_BYTES
    routes, probe_scratch = {}, {}
    try:
        for route in kernels.HASH_PROBE_ROUTES:
            _force_route(kernels, route)
            for m in probe_ms:
                p = probe[:m]
                routes.setdefault(str(m), {})[route] = cuda_ms(
                    lambda: kernels.hash_probe(tk, tr, p))
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.hash_probe(tk, tr, probe)
            torch.cuda.synchronize()
            probe_scratch[route] = (torch.cuda.max_memory_allocated() - base
                                    - probe.shape[0] * 4)
        _force_route(kernels, "partitioned")
        probe_split = device_split(lambda: kernels.hash_probe(tk, tr, probe))
    finally:
        kernels.HASH_RANDOM_BYTES = random_bytes
    build_split = device_split(lambda: kernels.hash_build(keys, t))
    chosen = {str(m): kernels.hash_partition_layout(t, m).probe_route
              for m in probe_ms}
    log(f"  hash layout at T={t}: {lay.partitions} slices of "
        f"{lay.slice_slots} slots, halo {lay.halo}; the build's scatter in "
        f"{lay.build_passes} passes; "
        f"keys deferred past their slice: {deferred} of {keys.shape[0]}; "
        f"scratch beyond the outputs: build {build_scratch} B, probe "
        f"{probe_scratch} B")
    log(f"  hash_probe by route (ms): {routes}; the wrapper's route: {chosen}")
    log(f"  hash_build split (device ms): {build_split}")
    log(f"  hash_probe split, partitioned (device ms): {probe_split}")
    results["hash_build"].update({
        "deferred": deferred, "scratch_bytes": build_scratch,
        "split": build_split, "slices": lay.partitions,
        "slice_slots": lay.slice_slots})
    results["hash_probe"].update({
        "route_ms": routes, "route": chosen, "scratch_bytes": probe_scratch,
        "split": probe_split, "halo": lay.halo})


# the kernels' layout constants the edge cases run under besides the
# default: slices small enough that chains cross many of them, and a halo
# of 1 that they leave
SMALL_SLICES = {"HASH_SLICE": 64, "HASH_HALO": 1}


def _check_hash(dev, build_shape, probe_shapes, seed, failures, results):
    """The main path's shapes timed first; then every case: the kernel's
    table held to the table invariants (each live key once, with its row;
    the chain invariant), and each probe route, forced where the table
    allows it, to a sort's answer and to the plain probe of the plain table
    (tables up to 2^24 slots), its route counter stepping once. The edge cases run again under
    SMALL_SLICES."""
    import torch

    from starrocks_tpu_torch.ops import kernels

    probe_ms = sorted({m for _, m in probe_shapes})
    main = _hash_main_case(dev, build_shape, probe_ms[-1], seed)
    _, keys, t, probe = main
    _time_hash(keys, t, probe, probe_ms, results)
    _hash_routes(keys, t, probe, probe_ms, results)
    cases = [main] + _hash_cases(dev, seed)
    err_build = err_probe = 0
    names = ("HASH_SLICE", "HASH_HALO", "HASH_RANDOM_BYTES")
    saved = {n: getattr(kernels, n) for n in names}
    try:
        for name, keys, t, probe in cases:
            configs = [("", {})]
            if name != "main_path_shape" and t <= 1 << 20:
                configs.append((" (small slices, halo 1)", SMALL_SLICES))
            want = _oracle_rows(keys, probe)
            plain = None
            if t <= 1 << 24:
                ptk, ptr = kernels.hash_build_plain(keys, t)
                plain = kernels.hash_probe_plain(ptk, ptr, probe)
            for label, consts in configs:
                for n in names:
                    setattr(kernels, n, consts.get(n, saved[n]))
                tk, tr = kernels.hash_build(keys, t)
                torch.cuda.synchronize()
                deferred = int(kernels.hash_build.last_deferred.sum())
                errors = _table_errors(keys, tk, tr)
                eb = 0
                if (plain is not None and not errors
                        and bool((keys != I64MAX).any())):
                    eb = int((_key_rows(keys, tk, tr)
                              - _key_rows(keys, ptk, ptr)).abs().max())
                ep = {}
                for route in kernels.HASH_PROBE_ROUTES if t < 1 << 31 else ():
                    # (a table of more than 2048 slices walks directly)
                    _force_route(kernels, route)
                    route = kernels.hash_partition_layout(
                        t, probe.shape[0]).probe_route
                    before = kernels.hash_probe.routes[route]
                    row = kernels.hash_probe(tk, tr, probe)
                    torch.cuda.synchronize()
                    ran = kernels.hash_probe.routes[route] - before
                    ep[route] = int((row.to(torch.int64) - want.to(torch.int64))
                                    .abs().max()) if probe.numel() else 0
                    if plain is not None and not torch.equal(row, plain):
                        ep[route] = max(ep[route], 1)
                    if ran != int(probe.numel() > 0) or ep[route]:
                        failures.append(f"hash {name}{label} {route}")
                    err_probe = max(err_probe, ep[route])
                kernels.HASH_RANDOM_BYTES = saved["HASH_RANDOM_BYTES"]
                lay = kernels.hash_partition_layout(t, probe.shape[0])
                log(f"  hash {name}{label}: N={keys.shape[0]} T={t} "
                    f"M={probe.shape[0]} ({lay.partitions} slices, the "
                    f"build's scatter in {lay.build_passes} passes) table "
                    f"errors {errors}, "
                    f"deferred {deferred}, build err {eb}, probe err by "
                    f"route {ep}, matches {int((want >= 0).sum())}")
                if errors or eb:
                    failures.append(f"hash {name}{label} build")
                err_build = max(err_build, eb, int(bool(errors)))
                del tk, tr
            torch.cuda.empty_cache()
    finally:
        for n in names:
            setattr(kernels, n, saved[n])
    results["hash_build"]["max_abs_err"] = err_build
    results["hash_probe"]["max_abs_err"] = err_probe


def _topn_cases(dev, shape, seed):
    """(name, neg [N] int64, k) on the card at the top-N shape (N, 1024):
    N1's 53-bit keys (complemented, as topn_order hands them on),
    N2's 6-bit keys (1/50 of the rows tied at the top), all-equal keys,
    N3's dead rows (INT64_MIN) after the live ones, INT64_MIN runs and
    all-dead blocks, clustered keys (the kernel's 64-bit pass), live spans
    too wide for its 64-bit keys (INT64_MAX and INT64_MIN + 1 among small
    values: its pair kernel), and N1's keys at k across a lane's (32) and
    a warp's (1024) sizes."""
    import torch

    n, k = shape
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ints(lo, hi, size=n):
        return torch.randint(lo, hi, (size,), generator=g, device=dev,
                             dtype=torch.int64)

    # N1's key: the price code (10,404,850 cents wide at SF 10) above 29
    # bits of (orderkey, linenumber)
    main = ~((ints(0, 10_404_850) << 29) | ints(0, 1 << 29))
    cases = [("main_path_shape", main, k), ("n2_ties", ~ints(0, 50), k),
             ("all_equal", torch.full((n,), 42, dtype=torch.int64,
                                      device=dev), k)]
    dead = torch.full((n,), I64MIN, dtype=torch.int64, device=dev)
    dead[:n // 2 + 77] = ~ints(0, 1 << 52, n // 2 + 77)
    cases.append(("dead_rows", dead, k))
    runs = main.clone()
    starts = ints(0, n - 2000, 4096)
    for ln in (1, 31, 97, 1024, 1500):
        for st in starts[:1024].tolist()[ln % 7::7]:
            runs[st:st + ln] = I64MIN
    runs[(n // 2048) * 1024:(n // 2048 + 1) * 1024] = I64MIN
    cases.append(("int64_min_runs", runs, k))
    # rows within 100 of each other and one far row a block: the 32-bit
    # keys' prefixes tie, and every block takes the kernel's 64-bit pass
    clustered = ints(0, 100)
    clustered[::1024] = 1 << 50
    cases.append(("clustered", clustered, k))
    wide = ints(-5, 5)
    wide[ints(0, n, n // 40)] = I64MAX
    wide[ints(0, n, n // 7)] = I64MIN
    wide[ints(0, n, n // 500)] = I64MIN + 1
    cases.append(("wide_spans", wide, k))
    cases += [(f"main_k{kk}", main, kk) for kk in (1, 33, 257, 1000)
              if kk < k]
    return cases


def _check_topn(dev, topn_shapes, seed, failures, res):
    """At each of `topn_shapes`: the kernel timed beside its bound, its
    plain version and two library calls (torch.sort of the blocks, the
    same function; torch.topk per block, which orders ties otherwise) and
    its host enqueue time (at the shapes of TOPN_TIMED_MIN_ROWS rows or
    more, and the largest: CUTS), then every case of _topn_cases against
    its plain version, bit for bit. At the largest shape the candidates'
    reduction is timed two ways — the full stable sort, and the threshold
    sort the port uses — which must return the same indices."""
    import torch

    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.ops import sort as sort_ops

    res["max_abs_err"] = 0
    by_shape = {}
    big = max(topn_shapes)
    for shape in sorted(topn_shapes):
        n, k = shape
        cases = _topn_cases(dev, shape, seed)
        r = by_shape[str(list(shape))] = {}
        if n >= TOPN_TIMED_MIN_ROWS or shape == big:  # else checked only
            _time_topn(cases[0][1], n, k, r)
        for name, neg, kk in cases:
            v, i = kernels.topn_select(neg, kk)
            listed = getattr(kernels.topn_select, "last_listed", None)
            listed = None if listed is None else listed.tolist()
            pv, pi = kernels.topn_select_plain(neg, kk)
            torch.cuda.synchronize()
            ev = float((v.double() - pv.double()).abs().max())
            ei = int((i.to(torch.int64) - pi.to(torch.int64)).abs().max())
            same = torch.equal(v, pv) and torch.equal(i, pi)
            log(f"  topn {name}: N={n} k={kk} equal={same} value err {ev} "
                f"idx err {ei}; blocks to the 64-bit pass and to the pair "
                f"kernel {listed}")
            r.setdefault("listed", {})[name] = listed
            if not same:
                failures.append(f"topn {name} at N={n}")
            res["max_abs_err"] = max(res["max_abs_err"], ei, ev)
            if (shape == big and name in ("main_path_shape", "n2_ties")
                    and hasattr(sort_ops, "first_kk_desc")):
                _time_topn_reduction(name, neg, v, kk, sort_ops, failures,
                                     res)
            del v, i, pv, pi
        del cases
        torch.cuda.empty_cache()
    res.update(by_shape[str(list(big))])
    res.update({"shape": list(big), "by_shape": by_shape})


def _time_topn(neg, n, k, r):
    """The top-N kernel timed at one shape beside its bound, its plain
    version, two library calls and its host enqueue time, into `r`."""
    import torch

    from starrocks_tpu_torch.ops import kernels

    nb = n // 1024
    ms = cuda_ms(lambda: kernels.topn_select(neg, k), reps=20)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        kernels.topn_select(neg, k)
    enqueue = (time.perf_counter() - t) / 20 * 1e3
    torch.cuda.synchronize()
    blocks = neg.view(-1, 1024)
    # bytes: N keys in, nb*k (value, row) pairs out; operations: the
    # compares a comparison sort of 1024 keys needs, log2(1024!) ~ 8770
    # a block (the bytes bound it)
    b = bound_ms(n * 8 + nb * k * 12, nb * 8770)
    r.update({
        "ms": ms, "enqueue_ms": enqueue,
        "plain_ms": cuda_ms(lambda: kernels.topn_select_plain(neg, k),
                            reps=5),
        "library_ms": cuda_ms(lambda: torch.sort(
            blocks, dim=1, descending=True, stable=True), reps=10),
        "library_topk_ms": cuda_ms(lambda: torch.topk(blocks, k, dim=1),
                                   reps=10),
        "bound_ms": b[0], "bound_by": b[1],
        "split": device_split(lambda: kernels.topn_select(neg, k))})
    log(f"  topn_select at N={n} k={k}: {ms:.4f} ms (host enqueue "
        f"{enqueue:.4f} ms), bound {b[0]:.4f} ms by {b[1]}, plain "
        f"{r['plain_ms']:.4f} ms, torch.sort of the blocks "
        f"{r['library_ms']:.4f} ms, torch.topk per block "
        f"{r['library_topk_ms']:.4f} ms; split {r['split']}")


def _time_topn_reduction(name, neg, cv, kk, sort_ops, failures, res):
    """topn_order's reduction on the kernel's candidates `cv` (the
    `pallas` route) and on `neg` itself (the `auto` route): the full
    stable sort against the threshold sort, same indices required."""
    import torch

    red = res.setdefault("reduction", {})
    for route, x in (("pallas", cv), ("auto", neg)):
        full = torch.sort(x, descending=True, stable=True).indices[:kk]
        got = sort_ops.first_kk_desc(x, kk)
        same = torch.equal(full, got)
        red[f"{name}/{route}"] = r = {
            "full_sort_ms": cuda_ms(lambda: torch.sort(
                x, descending=True, stable=True).indices[:kk], reps=5),
            "threshold_ms": cuda_ms(lambda: sort_ops.first_kk_desc(x, kk),
                                    reps=5),
            "same_indices": same,
            "rows_at_or_above_threshold": int(
                (x >= x[got[-1]]).sum()) if kk else 0}
        log(f"  topn reduction {name} ({route} route, N={x.shape[0]} "
            f"kk={kk}): full stable sort {r['full_sort_ms']:.4f} ms, "
            f"threshold {r['threshold_ms']:.4f} ms "
            f"({r['rows_at_or_above_threshold']} rows sorted), same "
            f"indices {same}")
        if not same:
            failures.append(f"topn reduction {name} {route}")


def _probe_cases(dev, shapes, seed):
    """(name, sorted build [K], probe [N]) on the card: one case at each of
    the paths' `shapes` (the largest, timed, is "main_path_shape"), then
    the search tree's edge cases."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    big = max(shapes, key=lambda kn: (kn[0] * kn[1], kn))
    cases = []
    for k, n in sorted(shapes):
        # unique packed keys with a sentinel (NULL/dead) tail, sorted;
        # probes hit ~90% and miss the rest, a few dead
        live = int(k * 0.9995)
        build = np.full(k, I64MAX, np.int64)
        build[:live] = np.sort((rng.permutation(live).astype(np.int64) << 20)
                               | rng.integers(0, 1 << 20, live))
        hits = build[rng.integers(0, live, n)]
        probe = np.where(rng.random(n) < 0.9, hits,
                         rng.integers(0, 1 << 60, n))
        probe[rng.random(n) < 0.01] = I64MAX
        cases.append(("main_path_shape" if (k, n) == big
                      else f"path_shape_{k}x{n}", build, probe))
    dup = np.sort(rng.integers(-50, 50, 5000))
    cases.append(("duplicates_sentinels",
                  np.concatenate([dup, np.full(300, I64MAX)]),
                  rng.integers(-60, 60, 10_001)))
    cases.append(("k1", np.array([7]), np.array([6, 7, 8, I64MIN, I64MAX])))
    cases.append(("k0", np.zeros(0, np.int64), np.array([1, 2, 3])))
    ext = np.sort(np.array([I64MIN, I64MIN, -1, 0, 0, 1, I64MAX - 1, I64MAX,
                            I64MAX]))
    cases.append(("int64_extremes", ext,
                  np.array([I64MIN, I64MIN + 1, -2, -1, 0, 1, 2, I64MAX - 1,
                            I64MAX] * 333)))
    # the tree's edges: K < 4 and off multiples of the leaf (4), node (64)
    # and 1024 keys, every key probed and its neighbours
    for kk in (2, 3, 5, 63, 65, 1023, 1025):
        b = np.sort(rng.integers(-1000, 1000, kk))
        cases.append((f"k{kk}", b, np.concatenate(
            [b, b - 1, b + 1, [I64MIN, I64MAX, I64MAX - 1]])))
    b = np.sort(rng.integers(-(1 << 50), 1 << 50, 70_001))
    seps = np.concatenate([b[s - 1::s] for s in (4, 64, 1024, 16384)])
    cases.append(("probe_equals_separators", b,
                  np.concatenate([seps, seps - 1, seps + 1])))
    runs = np.sort(rng.integers(-(1 << 40), 1 << 40, 9000))
    for ln, st in ((5, 2), (65, 126), (1025, 2047)):  # across node bounds
        runs[st:st + ln] = runs[st]
    runs = np.sort(runs)
    cases.append(("runs_5_65_1025", runs, np.concatenate(
        [runs[::7], runs[::7] - 1, runs[::7] + 1])))
    tail = np.concatenate([np.sort(rng.integers(0, 1 << 30, 5001)),
                           np.full(1031, I64MAX)])
    cases.append(("int64_max_probe_sentinel_tail", tail,
                  np.concatenate([tail[::3], [I64MAX, I64MAX - 1, 0]])))
    notail = np.sort(rng.integers(0, 1 << 30, 4096))
    cases.append(("int64_max_probe_no_tail", notail,
                  np.array([I64MAX, notail[-1], notail[-1] + 1, I64MIN])))
    return [(nm, torch.from_numpy(np.ascontiguousarray(b, np.int64)).to(dev),
             torch.from_numpy(np.ascontiguousarray(p, np.int64)).to(dev))
            for nm, b, p in cases]


def _check_probe_searchsorted(dev, shapes, seed, failures, res):
    """Every case against the plain ladder and torch.searchsorted, first
    with the default tree (timing the largest of the paths' `shapes`), then
    each edge case again with a top level of 2 entries: the deepest tree
    it makes."""
    import torch

    from starrocks_tpu_torch.ops import kernels

    res["max_abs_err"] = 0
    cases = _probe_cases(dev, shapes, seed)
    edges = cases[len(set(shapes)):]

    def check(name, build, probe, label):
        got = kernels.probe_searchsorted(build, probe)
        torch.cuda.synchronize()
        want = kernels.probe_searchsorted_plain(build, probe)
        lib = torch.searchsorted(build, probe, out_int32=True)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        same = bool(torch.equal(got, want)) and bool(torch.equal(got, lib))
        log(f"  probe_searchsorted {name}{label}: K={build.shape[0]} "
            f"N={probe.shape[0]} equal to plain and library {same}, "
            f"err {err}")
        if not same:
            failures.append(f"probe_searchsorted {name}{label}")
        res["max_abs_err"] = max(res["max_abs_err"], err)

    for name, build, probe in cases:
        check(name, build, probe, "")
        if name != "main_path_shape":
            continue
        k, n = build.shape[0], probe.shape[0]
        iters = max(k, 1).bit_length()
        # bytes: build once, probe keys in, int32 positions out; ops: per
        # probe and search step a load, a compare and an update
        b = bound_ms(k * 8 + n * 8 + n * 4, n * iters * 3)
        res.update({
            "ms": cuda_ms(lambda: kernels.probe_searchsorted(build, probe)),
            "plain_ms": cuda_ms(
                lambda: kernels.probe_searchsorted_plain(build, probe),
                reps=2),
            "library_ms": cuda_ms(lambda: torch.searchsorted(
                build, probe, out_int32=True)),
            "bound_ms": b[0], "bound_by": b[1], "shape": [k, n],
            "split": device_split(
                lambda: kernels.probe_searchsorted(build, probe))})
        log(f"  probe_searchsorted split (device ms): {res['split']}")
    top_max = kernels.PROBE_TOP_MAX
    res["tree_levels"] = len(kernels.probe_index_layout(res["shape"][0])[0])
    kernels.PROBE_TOP_MAX = 2
    try:
        for name, build, probe in edges:
            check(name, build, probe, " (deep tree)")
    finally:
        kernels.PROBE_TOP_MAX = top_max


def _segment_cases(dev, shapes, seed):
    """(name, gid [N] int32, vals [N, M] f32, G, block) on the card: one
    case at each of the paths' `shapes` (the largest, timed, is
    "main_path_shape"), then the edge cases."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    big = max(shapes, key=lambda s: (s[0] * s[1], s))
    cases = []
    for shape in sorted(shapes):
        n, m, g, block = shape
        # the paths' groups: few live codes (S1's l_returnflag, B7's ship
        # modes), the capacity's padding rows dead (id G), discount-like
        # values in [0, 0.1]
        live = int(n * 0.9999)
        gid = np.full(n, g, np.int32)
        gid[:live] = rng.integers(0, min(g, 4), live)
        vals = (rng.integers(0, 11, (n, m)) / 100.0).astype(np.float32)
        name = ("main_path_shape" if shape == big
                else "path_shape_" + "x".join(map(str, shape)))
        cases.append((name, gid, vals, g, block))
    gid8 = rng.integers(0, 9, 8192).astype(np.int32)
    cases.append(("g8_m4_block2048", gid8,
                  (rng.random((8192, 4)) * 100).astype(np.float32), 8, 2048))
    cases.append(("g8_m4_block8", gid8,
                  (rng.standard_normal((8192, 4)) * 1e3).astype(np.float32),
                  8, 8))
    g1k = rng.integers(0, 1025, 60_416).astype(np.int32)
    cases.append(("g1024_m1_block1024", g1k,
                  (rng.random((60_416, 1)) * 50).astype(np.float32), 1024,
                  1024))
    dead = np.full(4096, 5, np.int32)
    dead[:7] = rng.integers(0, 5, 7)
    cases.append(("mostly_dead_rows", dead,
                  rng.random((4096, 2)).astype(np.float32), 5, 512))
    # a last CTA that ends inside a tile (10,000 rows: 4 CTAs of 2048 + 1808)
    cases.append(("ragged_last_cta", rng.integers(0, 4, 10_000)
                  .astype(np.int32), rng.standard_normal((10_000, 1))
                  .astype(np.float32), 3, 8))
    out = [(nm, torch.from_numpy(ids).to(dev), torch.from_numpy(v).to(dev),
            groups, bl) for nm, ids, v, groups, bl in cases]
    # views one element into their storage: not 16-byte aligned, so the
    # kernel takes its scalar loads
    ids = torch.from_numpy(rng.integers(0, 8, 8193).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.random((8193, 1)).astype(np.float32)).to(dev)
    out.append(("unaligned_views", ids[1:], v[1:], 7, 8))
    return out


def _f64_sums(gid, vals, g):
    """(f64 sums of the f32 values, f64 sums of their magnitudes), [G, M]."""
    import torch

    key = gid.to(torch.int64).clamp(0, g)
    v = vals.double()
    zero = torch.zeros((g + 1, v.shape[1]), dtype=torch.float64,
                       device=v.device)
    return (zero.clone().index_add_(0, key, v)[:g],
            zero.clone().index_add_(0, key, v.abs())[:g])


def _err_over_mag(x, ref, mag) -> float:
    """max |x - ref| / mag over the cells (a cell of mag 0 must be exact)."""
    import torch

    diff = (x.double() - ref).abs()
    e = torch.where(mag > 0, diff / mag.clamp(min=1e-300),
                    torch.where(diff > 0, float("inf"), 0.0))
    return float(e.max())


def _check_segment_sum(dev, shapes, seed, failures, res):
    """The kernel within SEG_REL * sum |x| of an f64 sum of the same f32
    values, and bit-identical over two runs; its difference from the plain
    version (the TPU's block order) and the plain version's from f64 are
    reported beside it."""
    import torch

    from starrocks_tpu_torch.ops import kernels

    res.update({"max_abs_err": 0.0, "max_err_vs_f64": 0.0,
                "plain_max_err_vs_f64": 0.0})
    for name, gid, vals, g, block in _segment_cases(dev, shapes, seed):
        got = kernels.segment_sum(gid, vals, g, block)
        again = kernels.segment_sum(gid, vals, g, block)
        torch.cuda.synchronize()
        plain = kernels.segment_sum_plain(gid, vals, g, block)
        ref, mag = _f64_sums(gid, vals, g)
        e_kernel = _err_over_mag(got, ref, mag)
        e_plain = _err_over_mag(plain, ref, mag)
        abs_err = float((got.double() - plain.double()).abs().max())
        identical = bool(torch.equal(got, again))
        log(f"  segment_sum {name}: N={gid.shape[0]} M={vals.shape[1]} G={g} "
            f"block={block} |kernel - f64| / sum|x| {e_kernel:.3g}, plain's "
            f"{e_plain:.3g}, |kernel - plain| {abs_err:.3g}, two runs "
            f"bit-identical {identical}")
        if not (e_kernel <= SEG_REL and identical):
            failures.append(f"segment_sum {name}")
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        res["max_err_vs_f64"] = max(res["max_err_vs_f64"], e_kernel)
        res["plain_max_err_vs_f64"] = max(res["plain_max_err_vs_f64"],
                                          e_plain)
        if name == "main_path_shape":
            n, m = vals.shape
            # bytes: group ids and values in once, [G, M] sums out; ops:
            # one add per value
            b = bound_ms(n * 4 + n * m * 4 + g * m * 4, n * m)

            def library():
                acc = torch.zeros((g + 1, m), dtype=torch.float32, device=dev)
                return acc.index_add_(0, gid, vals)

            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.segment_sum(gid, vals, g, block)
            torch.cuda.synchronize()
            # device memory one call takes beyond its [G, M] output
            scratch = torch.cuda.max_memory_allocated() - base - g * m * 4
            res.update({
                "ms": cuda_ms(lambda: kernels.segment_sum(gid, vals, g, block)),
                "plain_ms": cuda_ms(
                    lambda: kernels.segment_sum_plain(gid, vals, g, block),
                    reps=2),
                "library_ms": cuda_ms(library),
                "bound_ms": b[0], "bound_by": b[1],
                "shape": [n, m, g, block], "scratch_bytes": scratch,
                "split": device_split(
                    lambda: kernels.segment_sum(gid, vals, g, block))})
            log(f"  segment_sum scratch {scratch} B; split (device ms): "
                f"{res['split']}")


# INTERSECT ALL / EXCEPT ALL (a row_number window over UNION ALL) over
# lineitem's duplicates, for the card-vs-CPU phase
BAG_QUERIES = {
    "BI": "select l_shipmode, l_returnflag from lineitem where l_orderkey "
          "< 4000 intersect all select l_shipmode, l_returnflag from "
          "lineitem where l_orderkey between 2000 and 9000 "
          "order by l_shipmode, l_returnflag",
    "BE": "select l_shipmode, l_returnflag from lineitem where l_orderkey "
          "< 4000 except all select l_shipmode, l_returnflag from lineitem "
          "where l_orderkey between 2000 and 5000 "
          "order by l_shipmode, l_returnflag",
}


def phase_card_vs_cpu(rec, sf, seed):
    import torch

    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.datagen.ssb import ssb_catalog
    from starrocks_tpu_torch.storage.ssb_queries import (
        FLAT_QUERIES, NATIVE_QUERIES)
    from starrocks_tpu_torch.storage.tpch_queries import (
        BREADTH_QUERIES, FUNCTION_QUERIES, SPILL_QUERIES)

    from starrocks_tpu_torch.storage.datagen.tpcds import tpcds_catalog
    from starrocks_tpu_torch.storage.tpcds_queries import (
        ALL_QUERIES, WINDOW_QUERIES)

    texts = query_texts()
    cat = tpch_catalog(sf=sf, seed=seed)
    ssb = ssb_catalog(sf=sf, seed=seed)
    ds = tpcds_catalog(sf=sf, seed=TPCDS_SEED)
    sessions = {"tpch": (Session(cat, device=CARD), Session(cat, device="cpu")),
                "ssb": (Session(ssb, device=CARD), Session(ssb, device="cpu")),
                "tpcds": (Session(ds, device=CARD), Session(ds, device="cpu"))}
    runs = [("kernels", strategies("kernels"), q) for q in texts]
    runs += [("hash_topn", HASH_KNOBS, q) for q in ("1", "2", "3", "9")]
    texts.update(topn_texts())
    runs += [("topn", TOPN_KNOBS, q) for q in topn_texts()]
    texts.update(BREADTH_QUERIES)
    runs += [("kernels", strategies("kernels"), q) for q in BREADTH_QUERIES]
    texts.update(FLAT_QUERIES)
    texts.update(NATIVE_QUERIES)
    runs += [("kernels", strategies("kernels"), q) for q in FLAT_QUERIES]
    runs += [("native", {"segment_strategy": "native"}, q)
             for q in NATIVE_QUERIES]
    texts.update(BAG_QUERIES)
    runs += [("kernels", strategies("kernels"), q) for q in BAG_QUERIES]
    texts.update({q: ALL_QUERIES[q] for q in WINDOW_QUERIES})
    runs += [("kernels", strategies("kernels"), q) for q in WINDOW_QUERIES]
    texts.update(FUNCTION_QUERIES)
    runs += [("kernels", strategies("kernels"), q) for q in FUNCTION_QUERIES]
    # the spill queries with lineitem streamed in at least 4 batches (SF
    # 0.1: 600,572 rows, 5 batches of 2^17), on both sides
    spill = spill_knobs(CPU_SPILL_ROWS)
    for q, text in SPILL_QUERIES.items():
        texts[f"spill:{q}"] = text
        runs.append(("spill", {**strategies("kernels"), **spill},
                     f"spill:{q}"))
    register_function_udf()
    want = {}
    bad = []
    out = {}
    for label, knobs, q in runs:
        card, cpu = sessions[
            "ssb" if q in FLAT_QUERIES or q in NATIVE_QUERIES
            else "tpcds" if q in WINDOW_QUERIES else "tpch"]
        if q not in want:
            set_knobs(strategies("auto"))
            if label == "spill":
                set_knobs(spill)
            want[q] = cpu.sql(texts[q]).table
        set_knobs(strategies("auto"))
        set_knobs(spill_knobs(0))
        set_knobs(knobs)
        res = card.sql(texts[q])
        got = res.table
        torch.cuda.synchronize()
        set_knobs(spill_knobs(0))
        base = q.split(":")[-1]
        rel = (STAT_REL if base.startswith("S")
               else {**BREADTH_REL, **FUNCTION_REL}.get(base, 1e-6))
        ok = _spill_agree(base, got, want[q], rel,
                          BREADTH_UNITS.get(base))
        if label == "native":
            ok = ok and res.profile.infos.get("native_fused") == "filter_sum"
        out[f"{q}@{label}"] = {"rows": got.num_rows, "agree": ok}
        log(f"  card ({label}) vs cpu (auto) SF {sf} {qname(q)}: {got.num_rows} "
            f"rows, agree {ok}")
        if not ok:
            bad.append(f"{q}@{label}")
    set_knobs(strategies("auto"))
    rec["card_vs_cpu"] = {"sf": sf, "queries": out}
    if bad:
        raise PhaseError(f"card and CPU rows differ for {bad}")


def run_phases(rec, phases, failed):
    """Run each (name, fn) phase, record its status and seconds in rec,
    and append the names of the failed ones to `failed`; stop after a
    failed device or generate phase."""
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        mem = _settle() if name not in ("device", "build") else None
        try:
            fn()
            status = "ok"
        except Exception as e:  # report every phase, fail at the end
            traceback.print_exc()
            status = f"FAILED: {type(e).__name__}: {e}"
            failed.append(name)
        finally:
            set_knobs({**strategies("auto"), **spill_knobs(0),
                       "join_hybrid_strategy": "auto"})
        dt = time.perf_counter() - t0
        rec["phases"][name] = {"status": status, "s": dt,
                               "mem_before_gb": mem}
        log(f"== phase {name}: {status} ({dt:.1f} s)")
        if name in ("device", "generate") and failed:
            break


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the main path (default 10)")
    ap.add_argument("--ssb-sf", type=float, default=10.0,
                    help="SSB scale factor of the ssb path (default 10)")
    ap.add_argument("--tpcds-sf", type=float, default=10.0,
                    help="TPC-DS scale factor of the tpcds path (default 10)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for chip_smoke.json")
    ap.add_argument("--phases", default=None,
                    help="comma list of phases to run after device and build "
                         "(default: all, and only then the ok line)")
    ap.add_argument("--serve-child", default=None, metavar="JSON",
                    help="generate the catalog, wait for a line 'go' on "
                         "stdin, run the serve phase alone in this process "
                         "and write its record to JSON (the serve phase "
                         "starts the script so, with the lock witness on)")
    ap.add_argument("--mesh-rank", default=None, metavar="JSON",
                    help="one rank of the dist_procs phase ({rank, procs, "
                         "host, layout, dir}): generate the catalog, wait "
                         "for a line 'go "
                         "<host:port>' on stdin, join the process group and "
                         "run the phase's queries (the phase starts the "
                         "script so)")
    ap.add_argument("--kernels", default=None,
                    help="comma list of the kernels phase's checks to run "
                         "(hash, topn_select, probe_searchsorted, "
                         "segment_sum; default all)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import starrocks_tpu_torch  # noqa: F401  (fails outside the repo)
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.storage.catalog import tpch_catalog

    if args.serve_child:
        return serve_child(args)
    if args.mesh_rank:
        return mesh_rank(args)
    rec = {"args": vars(args), "phases": {}, "cuts": CUTS}
    t_start = time.perf_counter()
    failed = []
    data = {}

    serve = {}  # the serve child, started beside the generate phase
    ranks = {}  # the dist_procs phase's ranks, started there too

    def generate():
        if any(name == "serve" for name, _ in phases):
            serve.update(start_serve_child(args))
        if any(name == "dist_procs" for name, _ in phases):
            ranks.update(start_mesh_ranks(args))
        t0 = time.perf_counter()
        data["cat"] = tpch_catalog(sf=args.sf, seed=args.seed)
        dt = time.perf_counter() - t0
        rows = {n: h.row_count for n, h in data["cat"].tables.items()}
        log(f"TPC-H SF {args.sf:g} generated in {dt:.1f} s: {rows}")
        rec["data"] = {"sf": args.sf, "seed": args.seed, "gen_s": dt,
                       "rows": rows}

    phases = [
        ("device", lambda: phase_device(rec)),
        ("build", lambda: phase_build(rec)),
        ("generate", generate),
        ("tpch", lambda: phase_tpch(rec, data["cat"], args.sf)),
        ("hash_topn", lambda: phase_hash_topn(rec, data["cat"], args.sf,
                                              args.seed)),
        ("topn", lambda: phase_topn(rec, data["cat"], args.sf)),
        ("breadth", lambda: phase_breadth(rec, data["cat"], args.sf)),
        ("functions", lambda: phase_functions(rec, data["cat"], args.sf)),
        ("spill", lambda: phase_spill(rec, data["cat"], args.sf)),
        ("ssb", lambda: phase_ssb(rec, args.ssb_sf, args.seed)),
        ("store", lambda: phase_store(rec, data["cat"], args.sf)),
        ("ingest", lambda: phase_ingest(rec, data["cat"], args.sf)),
        ("lake", lambda: phase_lake(rec)),
        ("dist", lambda: phase_dist(rec, data["cat"], args.sf)),
        ("dist_procs", lambda: phase_dist_procs(rec, data["cat"], ranks)),
        ("serve", lambda: run_serve_child(
            rec, serve or start_serve_child(args))),
        ("tpcds", lambda: (data.pop("cat", None), _settle(),
                           phase_tpcds(rec, args.tpcds_sf))),
        ("kernels", lambda: phase_kernels(
            rec, args.seed, args.kernels and args.kernels.split(","))),
        ("card_vs_cpu", lambda: phase_card_vs_cpu(rec, CPU_SF, args.seed)),
    ]
    if args.phases:
        wanted = {"device", "build", *args.phases.split(",")}
        if wanted & {"tpch", "hash_topn", "topn", "breadth", "functions",
                     "spill", "store", "ingest", "dist", "dist_procs"}:
            wanted.add("generate")
        unknown = wanted - {name for name, _ in phases}
        if unknown:
            ap.error(f"unknown phases {sorted(unknown)}")
        phases = [(name, fn) for name, fn in phases if name in wanted]
    try:
        run_phases(rec, phases, failed)
    finally:
        stop_serve_child(serve)
        stop_mesh_ranks(ranks)
    data.clear()
    rec["total_s"] = time.perf_counter() - t_start
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(rec, indent=1))
    if failed:
        log(f"chip_smoke FAILED phases: {failed}")
        return 1
    if args.phases:
        log(f"chip_smoke: phases {[name for name, _ in phases]} ok")
        return 0
    log(f"chip_smoke cuts: {CUTS}")
    line = []
    for name, (source, replaces, path) in KERNEL_META.items():
        r = rec["kernels"][name]
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": rec[path]["launches"][name]
            + rec["tpcds"]["launches"][name]
            + rec["functions"]["launches"][name]
            + rec["spill"]["launches"][name]
            + rec["ingest"]["launches"][name]
            + rec["lake"]["launches"][name]
            + rec["dist"]["launches"][name]
            + rec["dist_procs"]["launches"][name]
            + rec["serve"]["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    assert set(kernels.WRAPPERS) == set(KERNEL_META)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
