"""The port's CUDA kernels and its Session on the card.

Marked `gpu`: every test needs an NVIDIA GPU and skips without one (the
check is in a fixture, so every worker collects the same tests). This file
imports neither jax nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest -p no:cacheprovider --noconftest -o markers=gpu \
        -m gpu tests/test_torch_gpu.py

- each kernel against its plain torch version on the same inputs: the
  integer kernels exactly (sentinels, misses, INT64_MIN/MAX, heavy slot
  collisions, duplicates, ties, all-equal and dead-row top-N keys); the
  top-N select also against the numpy model of its one-word keys and
  network (tests/test_torch_kernel_layouts.py) at k across a lane's and a
  warp's sizes, 1 to 4096 blocks and N > 2^24, ties across lanes and
  blocks, INT64_MIN runs and all-dead blocks, and blocks too wide for its
  one-word key; its candidates' threshold reduction against the full
  stable sort; the
  hash build's table also against the chain invariant, on the edges of
  its slices (tests/test_torch_kernel_layouts.py), and both hash probe
  routes, each asserted by its counter; the
  sorted probe also against torch.searchsorted(out_int32=True) and the
  numpy model of its tree descent, on the tree's edge cases
  (tests/test_torch_kernel_layouts.py), with the default top level and
  with deep trees;
- the f32 segment sum against an f64 sum of the same f32 values, within
  1e-6 * sum |x| per (group, column) — the kernel adds in its own fixed
  order, not the plain version's block order — bit for bit against the
  numpy model of that order, and bit-identical over two runs;
- the one-hot limb matmul stays exact when the caller allows TF32;
- TPC-H Q1/Q2/Q3/Q9 at SF 0.01 through `Session.sql` on the card with the
  hash and top-N kernels, all 22 queries with S1/S2 under the
  segment-sum and sorted-probe kernels, and the top-N queries N1-N3 at SF
  0.1 under the top-N kernel, against the CPU run: the same result
  tables, and the kernels really launched;
- the native filter-sum lane on a card Session whose columns sit on the
  card, DECIMAL(38) sums, minima and maxima and the limb arithmetic on
  CUDA tensors, and UNION ALL's concatenation (dictionaries merged,
  masks kept on the card), each against the CPU;
- statements and storage: a small TabletStore on the card (create,
  insert, upsert, delete, update, restart, compaction, then queries under
  `auto` and the kernel strategies), a table registered again under a card
  Session, and DML on in-memory PRIMARY KEY tables, each against the CPU;
- the window operator on a 2^20-row chunk for every function and frame
  kind, its top-N prefilter under both branches and its rank mask, and
  the TPC-DS window and kernel queries at SF 0.01 under the kernel
  strategies, each against the CPU; decimal quotients (divisions by a
  power of ten) bit for bit against the CPU;
- the function surface: HLL registers and BITMAP planes at 2^22 rows bit
  for bit, unnest and lambda bodies at 2^20 rows exactly, F1's
  transcendentals to 6 significant digits, and F1-F11 at SF 0.01 through
  `Session.sql`, each against the CPU;
- execution beyond device memory at 2^20 rows in 2^18-row batches: the
  batched aggregation (segment_sum in every batch and the merge, f32 sums
  to 1e-4), the hybrid join with spilled partitions and a heavy hitter,
  the spilled sort and the spilled window, each against the CPU;
- distribution: Session(dist_shards=8) at SF 0.01 on the card against
  the same 8-shard Session on the CPU, with all five kernels launched;
  and the hash build of a 4096-slot table as a fresh process's first
  launch (its shared-memory opt-in); the mixed mesh (cuda:0, cpu) x 4 at
  SF 0.1 under the kernel strategies and `auto` against the single-shard
  Session, every placed shard on its device; the default Session's
  shards on the cards `shard_devices` names; with two or more cards
  (else skipped, with the reason), the default Session spread over
  them, each kernel on cuda:1 against its plain version, and a launch on
  cuda:0 after a hash build on cuda:1;
- the process mesh (tests/test_torch_process_mesh.py's ranks): two on
  cuda:0 and cuda:1 over NCCL (skipped with fewer than two cards), one
  over NCCL on cuda:0, and two sharing cuda:0 over gloo, every collective
  equal to InProcess with its results on the rank's card, and Q3 at SF
  0.1 equal to the single-shard rows; over emulated hosts (their own
  CUDA_VISIBLE_DEVICES, host names and NCCL_HOSTID): two hosts on one
  card over NCCL, two hosts on two cards (skipped with fewer than two),
  and one rank a host holding two cards, every kernel Q3 launches on both
  (skipped with fewer than four), with Mesh.hosts and Mesh.devices as
  runtime.cluster.host_layout says;
- the serving planes: a ServingTier over a card Session with four client
  threads against the CPU's rows, a query killed after its program ran
  returning the card's allocated memory to its value before it, and the
  kernels' launch counts from four threads at once equal to four times
  one thread's, and `enable_device_profile`'s per-attempt CUDA-event
  time and peak bytes;
- loading: TPC-H orders at SF 0.1 written as CSV and loaded with
  `load_csv`, and written as parquet files (chip_smoke.py's writer) and
  declared as an external table, each queried on the card against the
  CPU's rows; a stream-loaded batch visible to the next query on the
  card, the warm device cache dropped by the commit; the lake fixtures
  (tests/data/torch_formats/: ZSTD, LZ4, the DELTA and BYTE_STREAM_SPLIT
  encodings, INT96, binary and LIST columns, ORC 0.11, TIMESTAMP, the
  schema-evolved directory, BROTLI and ORC LZO) as external tables on the card
  against the CPU's rows, N3 under the top-N kernel on the ZSTD ones; the
  data directory the JAX package wrote (tests/data/torch_store/) opened on
  the card with its answers file's rows; the ORC LZO fixture against its
  manifest on the card, N3 launching the top-N kernel over it.
"""

import numpy as np
import pytest
import torch

from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.ops.common import mix64
from starrocks_tpu_torch.runtime.config import (
    AUTO_STRATEGIES, KERNEL_STRATEGIES, config,
)
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog

from starrocks_tpu_torch.ops import segment
from starrocks_tpu_torch.storage.tpch_queries import QUERIES, STAT_QUERIES

from test_torch_kernel_layouts import (
    HASH_EDGE_CASES, PROBE_CASES, SEG_CASES, SEG_REL, TOPN_EDGE_CASES,
    _probe_case as _tree_case, _seg_case, hash_edge_case, hash_table_errors,
    probe_descent_model, segment_sum_f64, segment_sum_order_model,
    topn_edge_case, topn_select_model, use_slices,
)

I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _colliding_keys(table_size, n, seed=0):
    rng = np.random.default_rng(seed)
    want = torch.tensor([table_size - 1, table_size - 2, 5])
    found = []
    while sum(len(f) for f in found) < n:
        cand = torch.from_numpy(
            rng.integers(-(1 << 62), 1 << 62, 1 << 18, dtype=np.int64))
        found.append(cand[torch.isin(mix64(cand) & (table_size - 1), want)])
    return torch.unique(torch.cat(found)[:n]).numpy()


def _hash_case(name):
    rng = np.random.default_rng(7)
    if name == "random_sentinels_misses":
        keys = rng.permutation(1 << 20)[:90_000].astype(np.int64)
        keys[3] = keys[77] = I64MAX
        probe = np.concatenate([keys, rng.integers(-100, 1 << 20, 110_000)])
        return keys, 1 << 18, probe
    if name == "int64_extremes":
        keys = np.array([0, 1, -1, I64MIN, I64MIN + 1, I64MAX - 1, 1 << 62,
                         -(1 << 62), I64MAX, I64MAX], np.int64)
        probe = np.concatenate([keys, [2, -2, I64MAX - 2]])
        return keys, 32, probe
    if name == "heavy_collisions":
        keys = _colliding_keys(1024, 400)
        return keys, 1024, np.concatenate([keys[::-1], keys + 1])
    if name == "dense_adjacent":
        return (np.arange(100_000, dtype=np.int64), 1 << 18,
                np.arange(-10, 200_000, dtype=np.int64))
    raise KeyError(name)


@pytest.mark.parametrize("case", ["random_sentinels_misses", "int64_extremes",
                                  "heavy_collisions", "dense_adjacent"])
def test_hash_kernels_match_plain(cuda, case):
    keys, table, probe = _hash_case(case)
    k = torch.from_numpy(keys)
    p = torch.from_numpy(np.ascontiguousarray(probe, np.int64))
    kernels.reset_counts()
    tk, tr = kernels.hash_build(k.to(cuda), table)
    row = kernels.hash_probe(tk, tr, p.to(cuda))
    torch.cuda.synchronize()
    assert kernels.counts()["hash_build"]["launches"] == 1
    assert kernels.counts()["hash_probe"]["launches"] == 1
    ptk, ptr = kernels.hash_build_plain(k, table)
    prow = kernels.hash_probe_plain(ptk, ptr, p)
    assert torch.equal(row.cpu(), prow)
    # table invariants: every non-sentinel key once, with its row, and the
    # chain invariant (every slot from a key's home to its slot occupied)
    tk, tr = tk.cpu(), tr.cpu()
    occ = tk != I64MAX
    assert int(occ.sum()) == int((k != I64MAX).sum())
    assert torch.equal(k[tr[occ].long()], tk[occ])
    assert hash_table_errors(keys, tk.numpy(), tr.numpy()) == []


# HASH_RANDOM_BYTES values that make every probe take one route
ROUTE_BYTES = {"direct": 0, "partitioned": 1 << 40}


@pytest.mark.parametrize("halo", [kernels.HASH_HALO, 1])
@pytest.mark.parametrize("slices", ["default", "small"])
@pytest.mark.parametrize("case", HASH_EDGE_CASES)
def test_hash_partitioned_edge_cases(cuda, monkeypatch, halo, slices, case):
    """The slices' edges (chains across the end of an inner build slice,
    of an inner probe slice and of T - 1 -> 0, T < S, T = S, N = 0,
    all-sentinel keys, M = 0, all-sentinel probes), with the default
    slices and with slices of 64 slots, the default halo and a halo of 1:
    a valid table, and each probe route, asserted by its counter, equal to
    the plain probe of the plain build."""
    use_slices(monkeypatch, slices)
    monkeypatch.setattr(kernels, "HASH_HALO", halo)
    _, keys, t, probe = hash_edge_case(case)
    k, p = torch.from_numpy(keys), torch.from_numpy(probe)
    kernels.reset_counts()
    tk, tr = kernels.hash_build(k.to(cuda), t)
    torch.cuda.synchronize()
    assert kernels.counts()["hash_build"]["launches"] == 1
    assert hash_table_errors(keys, tk.cpu().numpy(), tr.cpu().numpy()) == []
    if case in ("inner_slice_end", "table_end_wraps"):
        assert int(kernels.hash_build.last_deferred.sum()) > 0
    ptk, ptr = kernels.hash_build_plain(k, t)
    want = kernels.hash_probe_plain(ptk, ptr, p)
    for route, nbytes in ROUTE_BYTES.items():
        monkeypatch.setattr(kernels, "HASH_RANDOM_BYTES", nbytes)
        before = kernels.hash_probe.routes[route]
        got = kernels.hash_probe(tk, tr, p.to(cuda))
        torch.cuda.synchronize()
        # an empty probe launches nothing
        assert kernels.hash_probe.routes[route] - before == int(len(probe) > 0)
        assert torch.equal(got.cpu(), want)
    assert sum(kernels.hash_probe.routes.values()) == (
        kernels.counts()["hash_probe"]["launches"])


@pytest.mark.parametrize("m,route", [(1000, "direct"),
                                     (3_000_000, "partitioned")])
def test_hash_probe_routes_by_shape(cuda, m, route):
    """The route follows from (T, M): a small probe walks directly, a large
    one takes the partitioned probe; both equal the plain probe."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(-(1 << 62), 1 << 62, 1_000_000))
    t = 1 << 21
    probe = np.concatenate([keys, rng.integers(-(1 << 62), 1 << 62, m)])[
        rng.permutation(len(keys) + m)[:m]]
    assert kernels.hash_partition_layout(t, m).probe_route == route
    k, p = torch.from_numpy(keys), torch.from_numpy(probe)
    tk, tr = kernels.hash_build(k.to(cuda), t)
    kernels.reset_counts()
    got = kernels.hash_probe(tk, tr, p.to(cuda))
    torch.cuda.synchronize()
    assert kernels.hash_probe.routes == {
        r: int(r == route) for r in kernels.HASH_PROBE_ROUTES}
    want = kernels.hash_probe_plain(tk.cpu(), tr.cpu(), p)
    assert torch.equal(got.cpu(), want)
    assert int((got >= 0).sum()) > 0


@pytest.mark.parametrize("case", ["ties", "all_equal", "int64_extremes",
                                  "dead_tail"])
def test_topn_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(3)
    n = 8192
    if case == "ties":
        x, k = rng.integers(0, 50, n), 1024
    elif case == "all_equal":
        x, k = np.full(n, 42), 100
    elif case == "int64_extremes":
        x = rng.integers(-5, 5, n)
        x[rng.integers(0, n, n // 7)] = I64MIN
        x[rng.integers(0, n, n // 40)] = I64MAX
        x[n // 2:] = I64MIN
        k = 333
    else:
        x = np.full(n, I64MIN)
        x[:30] = rng.integers(-1000, 0, 30)
        k = 100
    neg = torch.from_numpy(np.asarray(x, np.int64))
    v, i = kernels.topn_select(neg.to(cuda), k)
    pv, pi = kernels.topn_select_plain(neg, k)
    assert torch.equal(v.cpu(), pv)
    assert torch.equal(i.cpu(), pi)


@pytest.mark.parametrize("case", TOPN_EDGE_CASES + ["blocks4096",
                                                    "n_over_2_24"])
def test_topn_kernel_edge_cases(cuda, case):
    _, x, k = topn_edge_case(case, big=True)
    neg = torch.from_numpy(x)
    v, i = kernels.topn_select(neg.to(cuda), k)
    pv, pi = kernels.topn_select_plain(neg, k)
    assert torch.equal(v.cpu(), pv)
    assert torch.equal(i.cpu(), pi)
    if len(x) <= 1 << 20:
        mv, mi, _, _ = topn_select_model(x, k)
        assert (v.cpu().numpy() == mv).all() and (i.cpu().numpy() == mi).all()


def test_topn_kernel_unaligned_input(cuda):
    """A view one key into its storage: the kernel's 8-byte copies."""
    _, x, k = topn_edge_case("int64_min_runs")
    store = torch.from_numpy(np.concatenate([[5], x])).to(cuda)
    v, i = kernels.topn_select(store[1:], k)
    pv, pi = kernels.topn_select_plain(torch.from_numpy(x), k)
    assert torch.equal(v.cpu(), pv) and torch.equal(i.cpu(), pi)


@pytest.mark.parametrize("n", [3 << 20, 3_000_000])  # by blocks or not
@pytest.mark.parametrize("ties", [False, True])
def test_topn_threshold_reduction_on_card(cuda, ties, n):
    from starrocks_tpu_torch.ops.sort import first_kk_desc

    rng = np.random.default_rng(9)
    x = rng.integers(0, 50 if ties else 1 << 60, n)
    x[rng.integers(0, len(x), 1000)] = I64MIN
    t = torch.from_numpy(x).to(cuda)
    for kk in (1, 100, 1024, 4096):
        want = torch.sort(t, descending=True, stable=True).indices[:kk]
        assert torch.equal(first_kk_desc(t, kk), want)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError):
        kernels.topn_select(torch.zeros(1000, dtype=torch.int64, device=cuda), 8)
    keys = torch.arange(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        kernels.hash_build(keys[::2], 256)  # not contiguous
    with pytest.raises(ValueError):
        kernels.hash_build(keys, 64)        # load factor above 0.5


def _probe_case(name):
    rng = np.random.default_rng(5)
    if name == "duplicates_sentinels":
        build = np.sort(rng.integers(-50, 50, 5000))
        build = np.concatenate([build, np.full(300, I64MAX)])
        probe = rng.integers(-60, 60, 10_000)
        probe[::97] = I64MAX
        return build, probe
    if name == "k1":
        return np.array([7]), np.array([6, 7, 8, I64MIN, I64MAX])
    if name == "k0":
        return np.zeros(0), np.array([1, 2, 3])
    if name == "int64_extremes":
        build = np.sort(np.array([I64MIN, I64MIN, -1, 0, 0, 1, I64MAX - 1,
                                  I64MAX, I64MAX]))
        probe = np.array([I64MIN, I64MIN + 1, -2, -1, 0, 1, 2, I64MAX - 1,
                          I64MAX] * 300)
        return build, probe
    if name == "large_random":
        build = np.sort(rng.integers(-(1 << 40), 1 << 40, 1_000_003))
        probe = np.concatenate([build[rng.integers(0, len(build), 700_000)],
                                rng.integers(-(1 << 41), 1 << 41, 300_001)])
        return build, probe
    raise KeyError(name)


@pytest.mark.parametrize("case", ["duplicates_sentinels", "k1", "k0",
                                  "int64_extremes", "large_random"])
def test_probe_searchsorted_matches_plain(cuda, case):
    build, probe = _probe_case(case)
    b = torch.from_numpy(np.ascontiguousarray(build, np.int64))
    p = torch.from_numpy(np.ascontiguousarray(probe, np.int64))
    kernels.reset_counts()
    got = kernels.probe_searchsorted(b.to(cuda), p.to(cuda))
    torch.cuda.synchronize()
    # an empty build launches nothing (the answer is all zeros)
    assert (kernels.counts()["probe_searchsorted"]["launches"]
            == (1 if len(build) else 0))
    assert got.dtype == torch.int32
    want = kernels.probe_searchsorted_plain(b, p)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, torch.searchsorted(b, p, out_int32=True))


@pytest.mark.parametrize("top_max", [kernels.PROBE_TOP_MAX, 2])
@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_tree_edge_cases(cuda, monkeypatch, top_max, case):
    """The tree's edge cases, with the default top level and with a top
    level of 2 entries (deep trees at small K): exact against the plain
    ladder, torch.searchsorted(out_int32=True) and the descent model."""
    monkeypatch.setattr(kernels, "PROBE_TOP_MAX", top_max)
    _, build, probe = _tree_case(case)
    b, p = torch.from_numpy(build), torch.from_numpy(probe)
    kernels.reset_counts()
    got = kernels.probe_searchsorted(b.to(cuda), p.to(cuda))
    torch.cuda.synchronize()
    assert kernels.counts()["probe_searchsorted"]["launches"] == 1
    got = got.cpu()
    assert torch.equal(got, kernels.probe_searchsorted_plain(b, p))
    assert torch.equal(got, torch.searchsorted(b.to(cuda), p.to(cuda),
                                               out_int32=True).cpu())
    assert np.array_equal(got.numpy(), probe_descent_model(build, probe))


def _within_f64(got, gid, vals, g):
    want, mag = segment_sum_f64(gid, vals, g)
    return bool((np.abs(got.cpu().double().numpy() - want)
                 <= SEG_REL * mag).all())


@pytest.mark.parametrize("g,m,block,n", [(8, 4, 8, 4096), (1024, 1, 1024, 60_416),
                                         (1024, 1, 2048, 1 << 20),
                                         (3, 2, 64, 64 * 100)])
def test_segment_sum_matches_plain(cuda, g, m, block, n):
    """Within 1e-6 * sum |x| of the f64 sum. The plain version adds in
    the TPU's block order and is not held to that bound (at S1's shape it
    is 3.68e-6 off: PERF.md)."""
    rng = np.random.default_rng(g + m)
    gid = rng.integers(0, g + 1, n).astype(np.int32)  # g = dead rows
    vals = (rng.random((n, m)) * 100).astype(np.float32)
    gt, vt = torch.from_numpy(gid), torch.from_numpy(vals)
    kernels.reset_counts()
    got = kernels.segment_sum(gt.to(cuda), vt.to(cuda), g, block)
    torch.cuda.synchronize()
    assert kernels.counts()["segment_sum"]["launches"] == 1
    assert got.shape == (g, m)
    assert _within_f64(got, gid, vals, g)


@pytest.mark.parametrize("case", SEG_CASES)
def test_segment_sum_order_and_determinism(cuda, case):
    """Bit for bit the numpy model of the kernel's order of addition,
    bit-identical over two runs, and within 1e-6 * sum |x| of f64."""
    _, gid, vals, g, block = _seg_case(case)
    gt = torch.from_numpy(gid).to(cuda)
    vt = torch.from_numpy(vals).to(cuda)
    first = kernels.segment_sum(gt, vt, g, block)
    second = kernels.segment_sum(gt, vt, g, block)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert np.array_equal(first.cpu().numpy(),
                          segment_sum_order_model(gid, vals, g))
    assert _within_f64(first, gid, vals, g)


def test_segment_sum_refuses_a_too_wide_accumulator(cuda):
    gid = torch.zeros(1024, dtype=torch.int32, device=cuda)
    vals = torch.zeros((1024, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.segment_sum(gid, vals, 1024, 1024)
    with pytest.raises(ValueError):
        kernels.segment_sum(gid, vals[:, :1].contiguous(), 8, 1000)


def test_limb_matmul_exact_under_tf32(cuda):
    """The caller asks for TF32 ('high'); the one-hot limb matmul pins full
    f32 around its products and still returns the exact int64 sums."""
    rng = np.random.default_rng(9)
    n = 1 << 16
    vals = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(cuda)
    gid = torch.from_numpy(rng.integers(0, 1001, n).astype(np.int32)).to(cuda)
    want = segment._scatter_sum(vals, gid, 1000)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = segment._seg_sum_int_matmul(vals, gid, 1000, 64)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


def test_tpch_on_card_matches_cpu(cuda):
    from chip_smoke import tables_agree

    cat = tpch_catalog(sf=0.01)
    card = Session(cat, device=cuda)
    cpu = Session(cat, device="cpu")
    try:
        card.sql("SET join_probe_strategy = 'pallas'")
        card.sql("SET topn_strategy = 'pallas'")
        kernels.reset_counts()
        for q in (1, 2, 3, 9):
            got = card.sql(QUERIES[q]).table
            want = cpu.sql(QUERIES[q]).table
            assert got.num_rows > 0
            assert tables_agree(got, want), f"Q{q}"
        launched = {n: c["launches"] for n, c in kernels.counts().items()}
        assert all(launched[n] >= 1 for n in
                   ("hash_build", "hash_probe", "topn_select")), launched
    finally:
        config.set("join_probe_strategy", "auto")
        config.set("topn_strategy", "auto")


def _set(knobs):
    for k, v in knobs.items():
        config.set(k, v)


def test_topn_queries_on_card_match_cpu(cuda):
    """N1-N3 at SF 0.1 on the card under the top-N kernel against the CPU
    under auto: the same rows, exactly, and the kernel launched by each."""
    from chip_smoke import tables_agree
    from starrocks_tpu_torch.storage.tpch_queries import TOPN_QUERIES

    cat = tpch_catalog(sf=0.1)
    card = Session(cat, device=cuda)
    cpu = Session(cat, device="cpu")
    try:
        for q, text in TOPN_QUERIES.items():
            _set(AUTO_STRATEGIES)
            want = cpu.sql(text).table
            config.set("topn_strategy", "pallas")
            kernels.reset_counts()
            got = card.sql(text).table
            torch.cuda.synchronize()
            assert kernels.topn_select.launches >= 1, q
            assert got.num_rows > 0
            assert tables_agree(got, want, rel=0.0), q
    finally:
        _set(AUTO_STRATEGIES)


def test_all_queries_on_card_under_kernel_strategies(cuda):
    """All 22 TPC-H queries and S1/S2 on the card under the kernel
    strategies, against the CPU under auto. TPC-H rows agree exactly
    (floats to 6 digits); S1/S2's float moments are summed in f32 blocks
    under `pallas` (the reference's contract), so their floats agree to a
    relative 1e-4 (measured f32-vs-f64 drift is ~1e-5 at SF 10, less here)."""
    from chip_smoke import tables_agree

    cat = tpch_catalog(sf=0.01)
    card = Session(cat, device=cuda)
    cpu = Session(cat, device="cpu")
    texts = {**{str(q): t for q, t in QUERIES.items()}, **STAT_QUERIES}
    launched = {}
    try:
        for q, text in texts.items():
            _set(AUTO_STRATEGIES)
            want = cpu.sql(text).table
            _set(KERNEL_STRATEGIES)
            kernels.reset_counts()
            got = card.sql(text).table
            torch.cuda.synchronize()
            launched[q] = {n: c["launches"] for n, c in kernels.counts().items()}
            rel = 1e-4 if q.startswith("S") else 1e-6
            assert tables_agree(got, want, rel=rel), q
    finally:
        _set(AUTO_STRATEGIES)
    assert launched["9"]["probe_searchsorted"] >= 1
    assert launched["20"]["probe_searchsorted"] >= 1
    assert launched["S1"]["segment_sum"] >= 1
    assert launched["S2"]["segment_sum"] >= 1


def test_native_lane_with_card_resident_columns(cuda):
    """NL1-NL3 on a card Session whose lineorder_flat columns already sit
    on the card (an `auto` run put them there): the host lane answers as
    the CPU Session does, and as the card does under `auto`."""
    from starrocks_tpu_torch.storage.datagen.ssb import ssb_catalog
    from starrocks_tpu_torch.storage.ssb_queries import NATIVE_QUERIES

    cat = ssb_catalog(sf=0.01)
    card = Session(cat, device=cuda)
    cpu = Session(cat, device="cpu")
    try:
        for q, text in NATIVE_QUERIES.items():
            _set(AUTO_STRATEGIES)
            on_card = card.sql(text).rows()
            want = cpu.sql(text).rows()
            assert card.cache._cols, "no column cached on the card"
            assert all(d.is_cuda for d, _ in card.cache._cols.values())
            config.set("segment_strategy", "native")
            r = card.sql(text)
            assert r.profile.infos.get("native_fused") == "filter_sum", q
            assert r.rows() == want == on_card, q
    finally:
        _set(AUTO_STRATEGIES)


def _dec128_spec(seed, n=50_000):
    from starrocks_tpu_torch.column.host_table import _int_to_dec128

    rng = np.random.default_rng(seed)
    vals = [int(a) * 10 ** 20 + int(b) for a, b in zip(
        rng.integers(-10 ** 15, 10 ** 15, n), rng.integers(0, 10 ** 18, n))]
    vals[:2] = [(1 << 126), -(1 << 126)]
    limbs = np.array([_int_to_dec128(v) for v in vals], np.int64)
    return {"t": [
        ("g", "BIGINT", rng.integers(0, 300, n), None, None),
        ("d", "DECIMAL(38,2)", limbs, None, rng.random(n) > 0.05),
        ("p", "DECIMAL(15,2)", rng.integers(-10 ** 9, 10 ** 9, n), None,
         None),
    ]}


@pytest.mark.parametrize("strategy", ["auto", "kernels"])
def test_dec128_aggregates_on_card_match_cpu(cuda, strategy):
    """DECIMAL(38) sums, minima and maxima (and a product promoted to the
    128-bit path) on CUDA tensors equal the CPU's, exactly."""
    from chip_smoke import tables_agree
    from starrocks_tpu_torch.storage.catalog import catalog_from_numpy

    cat = catalog_from_numpy(_dec128_spec(3))
    card = Session(cat, device=cuda)
    cpu = Session(cat, device="cpu")
    sql = ("select g, sum(d) s, min(d) mn, max(d) mx, count(d) c, "
           "sum(cast(p as decimal(38,2)) * cast(p as decimal(38,2))) pp "
           "from t group by g order by g")
    try:
        _set(AUTO_STRATEGIES)
        want = cpu.sql(sql).table
        _set(KERNEL_STRATEGIES if strategy == "kernels" else AUTO_STRATEGIES)
        got = card.sql(sql).table
        assert got.num_rows == 300
        assert tables_agree(got, want, rel=0.0)
    finally:
        _set(AUTO_STRATEGIES)


def test_dec128_limbs_on_card_match_cpu(cuda):
    from starrocks_tpu_torch.ops import dec128

    spec = _dec128_spec(4, 20_000)["t"][1][2]
    a = torch.from_numpy(spec)
    b = torch.from_numpy(np.roll(spec, 7, axis=0))
    for fn in ("add", "sub", "mul", "lt", "eq"):
        got = getattr(dec128, fn)(a.to(cuda), b.to(cuda))
        assert got.is_cuda
        assert torch.equal(got.cpu(), getattr(dec128, fn)(a, b)), fn
    assert torch.equal(dec128.to_f64(a.to(cuda)).cpu(), dec128.to_f64(a))


def test_union_all_keeps_dictionaries_and_masks_on_card(cuda):
    from starrocks_tpu_torch.column import HostTable
    from starrocks_tpu_torch.ops.setops import union_all

    a = HostTable.from_pydict({"s": ["x", None, "pear", "fig"] * 300,
                               "v": list(range(1200))})
    b = HostTable.from_pydict({"s": ["kiwi", "fig", None] * 200,
                               "v": [1.5, None, -2.0] * 200})
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        ca, cb = a.to_chunk(device=dev), b.to_chunk(device=dev)
        cb = cb.with_sel(torch.arange(cb.capacity, device=dev) % 5 != 1)
        outs[dev.type] = union_all(ca, cb)
    card, cpu = outs["cuda"], outs["cpu"]
    assert card.device.type == "cuda"
    assert all(t.is_cuda for t in card.data)
    assert all(v is None or v.is_cuda for v in card.valid)
    assert card.sel.is_cuda
    assert card.schema.fields[0].dict.values.tolist() == \
        cpu.schema.fields[0].dict.values.tolist()
    for x, y in zip(card.data + card.valid + (card.sel,),
                    cpu.data + cpu.valid + (cpu.sel,)):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x.cpu(), y)


def test_union_all_widens_decimal38_on_card(cuda):
    """A DECIMAL(38, 2) child against a DECIMAL(38, 4) and a BIGINT one:
    the widened limbs on the card equal the CPU's."""
    from decimal import Decimal

    from starrocks_tpu_torch import types as T
    from starrocks_tpu_torch.column import HostTable
    from starrocks_tpu_torch.ops.setops import union_all

    rng = np.random.default_rng(7)
    a = HostTable.from_pydict(
        {"v": [None if i % 13 == 0 else Decimal(int(x)).scaleb(-2)
               for i, x in enumerate(rng.integers(-10 ** 18, 10 ** 18, 900))]},
        types={"v": T.DECIMAL(38, 2)})
    others = [
        HostTable.from_pydict(
            {"v": [Decimal(int(x)).scaleb(-4)
                   for x in rng.integers(-10 ** 18, 10 ** 18, 500)]},
            types={"v": T.DECIMAL(38, 4)}),
        HostTable.from_pydict({"v": rng.integers(-2 ** 62, 2 ** 62, 500)
                               .tolist()}, types={"v": T.BIGINT})]
    for b in others:
        card, cpu = (union_all(a.to_chunk(device=dev), b.to_chunk(device=dev))
                     for dev in (cuda, torch.device("cpu")))
        assert card.schema.fields[0].type == cpu.schema.fields[0].type
        assert card.data[0].shape[1] == 4
        assert torch.equal(card.data[0].cpu(), cpu.data[0])
        assert card.data[0].device.type == cuda.type
        assert torch.equal(card.valid[0].cpu(), cpu.valid[0])


# --- statements and storage (slice 4 of queue A) -------------------------------


def _statement_script(mod: int):
    """DDL, an upsert with a duplicate key, DELETE and UPDATE over a small
    PRIMARY KEY table, then the queries whose rows are compared."""
    rows = ", ".join(f"({i}, {i % mod}, 'n{i % 7}', {i * 0.25})"
                     for i in range(3000))
    return [
        "create table f (id bigint, k bigint, s varchar, x decimal(12,2), "
        "primary key(id)) distributed by hash(id) buckets 8",
        "create table d (k bigint, g varchar, primary key(k))",
        f"insert into f values {rows}",
        "insert into d values " + ", ".join(
            f"({i}, 'g{i % 3}')" for i in range(mod)),
        "insert into f values (7, 1, 'new', 1.5), (7, 2, 'newer', 2.5), "
        "(99999, 3, 'tail', 3.5)",
        "delete from f where x < 10",
        "update f set x = x + 1 where s = 'n3'",
    ], [
        "select count(*), sum(x) from f",
        "select d.g, count(*) c, sum(f.x) sx from f join d on f.k = d.k "
        "group by d.g order by d.g",
        "select s, count(*) from f group by s order by s",
        "select id, x from f order by x desc, id limit 5",
    ]


def _run_script(s, ddl, queries):
    return ([s.sql(t) for t in ddl], [s.sql(q).table for q in queries])


def _tables_equal(a, b):
    assert [f.name for f in a.schema] == [f.name for f in b.schema]
    assert a.to_pylist() == b.to_pylist()


@pytest.mark.parametrize("knobs", ["auto", "kernels"])
def test_store_on_card_matches_cpu(cuda, tmp_path, knobs):
    """A small store on the card: create, insert, upsert, delete and
    update, restart, then query: every statement's value and every query's
    rows equal the CPU's, before and after the restart."""
    ddl, queries = _statement_script(97)
    for k, v in (KERNEL_STRATEGIES if knobs == "kernels"
                 else AUTO_STRATEGIES).items():
        config.set(k, v)
    try:
        card = Session(data_dir=str(tmp_path / "card"))
        cpu = Session(device="cpu", data_dir=str(tmp_path / "cpu"))
        vals_card, got_card = _run_script(card, ddl, queries)
        vals_cpu, got_cpu = _run_script(cpu, ddl, queries)
        assert vals_card == vals_cpu
        for a, b in zip(got_card, got_cpu):
            _tables_equal(a, b)
        card2 = Session(data_dir=str(tmp_path / "card"))
        cpu2 = Session(device="cpu", data_dir=str(tmp_path / "cpu"))
        assert card2.device.type == "cuda"
        for q, b in zip(queries, got_cpu):
            _tables_equal(card2.sql(q).table, b)
        # an upsert leaves a delta rowset and delete vectors, which
        # compaction folds into one rowset
        extra = "insert into f values (8, 1, 'again', 9.5), (9, 2, 'x', 1)"
        assert card2.sql(extra) == cpu2.sql(extra) == 2
        want = [cpu2.sql(q).table for q in queries]
        n = cpu2.sql("select count(*) from f").rows()[0][0]
        assert card2.store.compact_table("f") == n
        card2.catalog.get_table("f").invalidate()
        card2.cache.invalidate("f")
        for q, b in zip(queries, want):
            _tables_equal(card2.sql(q).table, b)
    finally:
        for k, v in AUTO_STRATEGIES.items():
            config.set(k, v)


def test_invalidation_on_card(cuda):
    """A table registered again under a card Session: the new rows are
    served (the catalog's listener drops the device cache)."""
    from starrocks_tpu_torch.column import HostTable
    from starrocks_tpu_torch.storage.catalog import Catalog

    cat = Catalog()
    cat.register("t", HostTable.from_pydict(
        {"k": np.arange(10), "v": np.ones(10, dtype=np.int64)}))
    s = Session(cat)
    q = "select k, sum(v) from t group by k order by k desc limit 2"
    assert s.sql(q).rows() == [(9, 1), (8, 1)]
    assert s.sql("select count(*) from t").rows() == [(10,)]
    cat.register("t", HostTable.from_pydict(
        {"k": np.arange(100), "v": np.full(100, 2, dtype=np.int64)}))
    assert s.sql(q).rows() == [(99, 2), (98, 2)]
    assert s.sql("select count(*) from t").rows() == [(100,)]


def test_dml_on_card_matches_cpu(cuda):
    """Upsert, delete and update on in-memory PRIMARY KEY tables on the
    card: the same counts and rows as the CPU, keys past the old maximum
    included."""
    ddl, queries = _statement_script(31)
    ddl += ["insert into d values (5000, 'far')",
            "insert into f values (5000, 5000, 'far', 7.25)"]
    vals_card, got_card = _run_script(Session(), ddl, queries)
    vals_cpu, got_cpu = _run_script(Session(device="cpu"), ddl, queries)
    assert vals_card == vals_cpu
    for a, b in zip(got_card, got_cpu):
        _tables_equal(a, b)


# --- the window operator (ops/window.py) -------------------------------------

WINDOW_CAP = 1 << 20


def _window_chunk(device):
    """A seeded chunk of WINDOW_CAP rows with NULLs and dead rows: a
    partition key of 600 values (g), a dictionary one of 7 (p), an
    order key with ties (k), a DECIMAL(10, 2) (kd), a DOUBLE (v) and a
    BIGINT (i)."""
    from starrocks_tpu_torch import types as T
    from starrocks_tpu_torch.column import (
        Field, Schema, StringDict, chunk_from_arrays)

    rng = np.random.default_rng(23)
    n = WINDOW_CAP
    pd_ = StringDict.from_values([f"p{j}" for j in range(7)])
    arrays = {"g": rng.integers(0, 600, n).astype(np.int32),
              "p": rng.integers(0, 7, n).astype(np.int32),
              "k": rng.integers(0, 5000, n).astype(np.int32),
              "kd": rng.integers(0, 100_000, n).astype(np.int64),
              "v": np.round(rng.normal(50, 20, n), 2),
              "i": rng.integers(-10**6, 10**6, n).astype(np.int64)}
    valids = {c: rng.random(n) > 0.05 for c in ("g", "k", "v", "i")}
    schema = Schema((Field("g", T.INT, True), Field("p", T.VARCHAR, False,
                                                    pd_),
                     Field("k", T.INT, True), Field("kd", T.DECIMAL(10, 2),
                                                    False),
                     Field("v", T.DOUBLE, True), Field("i", T.BIGINT, True)))
    c = chunk_from_arrays(schema, arrays, valids, device=device)
    return c.and_sel(torch.from_numpy(rng.random(n) > 0.03).to(device))


def _wspec(spec):
    from starrocks_tpu_torch.exprs.ir import Col

    part, order, funcs = spec
    return (tuple(Col(c) for c in part),
            tuple((Col(c), a, nf) for c, a, nf in order),
            tuple((f[0], f[1], None if f[2] is None else Col(f[2]), *f[3:])
                  for f in funcs))


def _wframe(frame):
    return [(f"{fn}_{c}", fn, c, None, None, frame)
            for c in ("v", "i", "kd") for fn in ("sum", "avg", "min", "max",
                                                 "count")]


_WAGGS = [("cnt", "count", None, None, None)] + [
    (f"{fn}_{c}", fn, c, None, None) for c in ("v", "i", "kd")
    for fn in ("sum", "avg", "min", "max", "count")]
WINDOW_GPU_CASES = {
    "ranks": (("g",), (("k", True, True), ("v", False, False)),
              [("rn", "row_number", None, None, None),
               ("rk", "rank", None, None, None),
               ("dr", "dense_rank", None, None, None)]),
    "lead_lag": (("p", "g"), (("k", True, False), ("i", True, False)),
                 [("ld", "lead", "v", 1, None), ("lg", "lag", "v", 2, None),
                  ("lgd", "lag", "i", 1, 0), ("ld3", "lead", "kd", 3, None)]),
    "first_last": (("g",), (("k", True, True),),
                   [("fv", "first_value", "v", None, None),
                    ("lv", "last_value", "i", None, None),
                    ("fr", "first_value", "v", None, None,
                     ("rows", "p", 1, "f", 1)),
                    ("lr", "last_value", "i", None, None,
                     ("range", "p", 50, "f", 50))]),
    "ntile": (("p",), (("i", True, True),),
              [("n3", "ntile", None, 3, None), ("n7", "ntile", None, 7,
                                                 None)]),
    "whole_partition": (("g",), (), _WAGGS),
    "running": (("g",), (("k", True, False),), _WAGGS),
    "rows_frame": (("g",), (("k", True, False), ("i", True, False)),
                   _wframe(("rows", "p", 3, "f", 2))),
    "range_frame": (("p",), (("kd", False, True),),
                    _wframe(("range", "p", 5, "f", 1.5))),
}


def _window_tables_equal(a, b):
    from starrocks_tpu_torch.column import HostTable

    ta, tb = HostTable.from_chunk(a), HostTable.from_chunk(b)
    assert [f.name for f in ta.schema] == [f.name for f in tb.schema]
    assert ta.num_rows == tb.num_rows
    for f in ta.schema:
        va, vb = ta.valids.get(f.name), tb.valids.get(f.name)
        ma = np.ones(ta.num_rows, bool) if va is None else np.asarray(va)
        mb = np.ones(tb.num_rows, bool) if vb is None else np.asarray(vb)
        assert (ma == mb).all(), f.name
        xa, xb = ta.arrays[f.name][ma], tb.arrays[f.name][mb]
        if f.type.is_float:
            # explicit-frame sums are prefix-sum differences (the JAX
            # package's design): the card's cumsum adds in another order
            # than the CPU's, so a difference carries the rounding of the
            # prefix (~5e7 here: 2^-52 * 5e7 = 1.1e-8), not of the frame
            np.testing.assert_allclose(xa, xb, rtol=1e-9, atol=1e-6,
                                       err_msg=f.name)
        else:
            assert (np.asarray(xa) == np.asarray(xb)).all(), f.name


@pytest.mark.parametrize("name", sorted(WINDOW_GPU_CASES))
def test_window_op_on_card_matches_cpu(cuda, name):
    """window_op on a 2^20-row chunk on the card equals the CPU's, row for
    row in the window's sorted order."""
    from starrocks_tpu_torch.ops.window import window_op

    spec = _wspec(WINDOW_GPU_CASES[name])
    card = window_op(_window_chunk(cuda), *spec)
    assert card.data[0].is_cuda
    _window_tables_equal(card, window_op(_window_chunk("cpu"), *spec))


@pytest.mark.parametrize("strategy", ["auto", "mxu"])
def test_window_topn_on_card_matches_cpu(cuda, strategy):
    """The top-N prefilter (the strided ladder under `auto`, the exact
    torch.topk threshold under `mxu`) and the in-window rank mask on the
    card: the same keep mask, pruned count and rows as the CPU."""
    from starrocks_tpu_torch.exprs.ir import Col
    from starrocks_tpu_torch.ops.window import (
        window_op, window_topn_prefilter)

    config.set("segment_strategy", strategy)
    try:
        spec = _wspec((("p",), (("v", False, False),),
                       [("r", "rank", None, None, None)]))
        out = []
        for dev in (cuda, "cpu"):
            c = _window_chunk(dev)
            keep, seed = window_topn_prefilter(
                c, (Col("p"),), ((Col("v"), False, False),), 10)
            ctr = {}
            w = window_op(c.and_sel(keep), *spec, limit_spec=("r", 10),
                          counters=ctr)
            out.append((keep.cpu(), seed, int(ctr["window_topn_pruned"]), w))
        assert (out[0][0] == out[1][0]).all()
        assert out[0][1:3] == out[1][1:3]
        _window_tables_equal(out[0][3], out[1][3])
    finally:
        config.set("segment_strategy", AUTO_STRATEGIES["segment_strategy"])


def test_tpcds_window_queries_on_card_match_cpu(cuda):
    """The 15 TPC-DS window queries and the kernel queries at SF 0.01 on
    the card under the kernel strategies, against the CPU under `auto`;
    the float cells of the segment-sum queries to a relative 1e-4."""
    from starrocks_tpu_torch.storage.datagen.tpcds import tpcds_catalog
    from starrocks_tpu_torch.storage.tpcds_queries import (
        ALL_QUERIES, KERNEL_RUN_QUERIES, SEGMENT_SUM_QUERIES,
        SEGMENT_SUM_REL)

    from chip_smoke import tables_agree

    cat = tpcds_catalog(sf=0.01)
    card, cpu = Session(cat, device=cuda), Session(cat, device="cpu")
    launched = dict.fromkeys(kernels.WRAPPERS, 0)
    try:
        for q in KERNEL_RUN_QUERIES:
            _set(AUTO_STRATEGIES)
            want = cpu.sql(ALL_QUERIES[q]).table
            _set(KERNEL_STRATEGIES)
            kernels.reset_counts()
            got = card.sql(ALL_QUERIES[q]).table
            torch.cuda.synchronize()
            for n, c in kernels.counts().items():
                launched[n] += c["launches"]
            rel = SEGMENT_SUM_REL if q in SEGMENT_SUM_QUERIES else 1e-6
            assert tables_agree(got, want, rel=rel), q
    finally:
        _set(AUTO_STRATEGIES)
    assert all(launched[n] >= 1 for n in
               ("probe_searchsorted", "topn_select", "segment_sum")), launched


def test_decimal_quotients_on_card_equal_the_cpu(cuda):
    """Decimal -> DOUBLE conversions, averages and round() divide by a
    power of ten: on the card a float tensor divided by a host scalar is
    x * (1 / s), up to an ulp off the CPU's quotient (TPC-DS q89's ORDER BY
    on such a difference then broke its ties otherwise). div_scalar gives
    the CPU's bits."""
    from starrocks_tpu_torch.exprs.compile import div_scalar

    x = torch.from_numpy(np.random.default_rng(3).integers(
        -10**9, 10**9, 1 << 16)).to(torch.float64)
    for s in (100, 10**4, 1000.0):
        assert torch.equal(div_scalar(x.to(cuda), s).cpu(), x / s)


# --- the function surface (slice 5b) ---------------------------------------


def test_sketches_on_card_equal_the_cpu_bit_for_bit(cuda):
    """HLL registers and BITMAP planes over 2^22 rows (INT64 extremes, NULLs
    and dead rows included): the card's scatter maxima and presence
    writes give the CPU's bits."""
    from starrocks_tpu_torch.ops import sketch

    rng = np.random.default_rng(17)
    n = 1 << 22
    v = torch.from_numpy(rng.integers(I64MIN, I64MAX, n, dtype=np.int64,
                                      endpoint=True))
    v[:4] = torch.tensor([I64MIN, I64MAX, 0, -1])
    valid = torch.from_numpy(rng.random(n) > 0.05)
    gid = torch.from_numpy(rng.integers(0, 65, n).astype(np.int32))
    small = v % 70000
    for p in (12, 14):
        cpu = sketch.hll_registers_from_values(v, valid, gid, 64, p)
        card = sketch.hll_registers_from_values(
            v.to(cuda), valid.to(cuda), gid.to(cuda), 64, p)
        assert torch.equal(card.cpu(), cpu)
        assert torch.equal(sketch.hll_estimate(card).cpu(),
                           sketch.hll_estimate(cpu))
        assert torch.equal(
            sketch.hll_union_registers(card, gid[:64].to(cuda) % 8, 8).cpu(),
            sketch.hll_union_registers(cpu, gid[:64] % 8, 8))
    cpu = sketch.bitmap_union_from_values(small, valid, gid, 64, 65536)
    card = sketch.bitmap_union_from_values(small.to(cuda), valid.to(cuda),
                                           gid.to(cuda), 64, 65536)
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(sketch.bitmap_count(card).cpu(),
                       sketch.bitmap_count(cpu))
    rows = sketch.bitmap_from_values(small[:4096] % 4096, valid[:4096], 4096)
    assert torch.equal(
        sketch.bitmap_union_planes(rows.to(cuda), gid[:4096].to(cuda),
                                   64).cpu(),
        sketch.bitmap_union_planes(rows, gid[:4096], 64))


def _function_chunk(n, device):
    from starrocks_tpu_torch import types as T
    from starrocks_tpu_torch.column import HostTable

    rng = np.random.default_rng(23)
    lists = [None if k % 17 == 0 else
             rng.integers(-9, 99, int(rng.integers(0, 6))).tolist()
             for k in range(n)]
    data = {"nums": lists,
            "q": rng.integers(1, 51, n).astype(np.int64),
            "p": rng.uniform(900.0, 105000.0, n),
            "d": rng.integers(0, 11, n) / 100.0,
            "t": rng.integers(0, 9, n) / 100.0}
    ht = HostTable.from_pydict(data, {"nums": T.ARRAY(T.BIGINT)})
    keep = torch.from_numpy(np.arange(ht.to_chunk().capacity) % 7 != 0)
    return ht.to_chunk(device=device).and_sel(keep.to(device))


def test_unnest_and_lambda_on_card_equal_the_cpu(cuda):
    """ops/unnest.py and a lambda body over 2^20 rows with NULL arrays and
    dead rows: every output slot (the dead tail included) and the true
    count equal the CPU's."""
    from starrocks_tpu_torch.exprs import ir
    from starrocks_tpu_torch.exprs.compile import ExprCompiler
    from starrocks_tpu_torch.ops.unnest import unnest_op

    n = 1 << 20
    cpu, card = _function_chunk(n, "cpu"), _function_chunk(n, cuda)
    for cap in (4 * n, n):  # the second overflows and truncates
        co, ct = unnest_op(cpu, ir.Col("nums"), "x", cap)
        go, gt = unnest_op(card, ir.Col("nums"), "x", cap)
        assert int(gt) == int(ct)
        assert torch.equal(go.sel_mask().cpu(), co.sel_mask())
        for a, b in zip(go.data, co.data):
            assert torch.equal(a.cpu(), b)
    lam = ir.Call("array_map", ir.Lambda(("e",), ir.Call(
        "add", ir.Call("multiply", ir.Col("@lam.e"), ir.Lit(2)),
        ir.Col("q"))), ir.Col("nums"))
    flt = ir.Call("array_filter", ir.Col("nums"), ir.Lambda(
        ("e",), ir.Call("gt", ir.Col("@lam.e"), ir.Col("q"))))
    for e in (lam, flt):
        c = ExprCompiler(cpu).eval(e)
        g = ExprCompiler(card).eval(e)
        assert torch.equal(g.data.cpu(), c.data)
        assert torch.equal(g.valid.cpu(), c.valid)


def test_f1_transcendentals_on_card_to_six_digits(cuda):
    """cbrt, log2 and atan2 over F1's column shapes: CUDA's libm differs
    from the CPU's by ulps, so the card holds to 6 significant digits."""
    from starrocks_tpu_torch.exprs import ir
    from starrocks_tpu_torch.exprs.compile import ExprCompiler

    n = 1 << 20
    cpu, card = _function_chunk(n, "cpu"), _function_chunk(n, cuda)
    e = ir.Call("add", ir.Call("add", ir.Call("cbrt", ir.Col("p")),
                               ir.Call("log2", ir.Call("add", ir.Col("q"),
                                                       ir.Lit(1)))),
                ir.Call("atan2", ir.Col("d"), ir.Call("add", ir.Col("t"),
                                                      ir.Lit(0.01))))
    c = ExprCompiler(cpu).eval(e).data
    g = ExprCompiler(card).eval(e).data.cpu()
    assert torch.allclose(g, c, rtol=1e-6, atol=0)


def test_function_queries_on_card_match_cpu(cuda):
    """F1-F11 at SF 0.01 on the card under the kernel strategies against
    the CPU under `auto` (F10's UDF body runs on the host either way)."""
    from starrocks_tpu_torch.runtime import udf
    from starrocks_tpu_torch.storage.tpch_queries import (
        FUNCTION_QUERIES, FUNCTION_UDF)

    from chip_smoke import tables_agree

    cat = tpch_catalog(sf=0.01)
    card, cpu = Session(cat, device=cuda), Session(cat, device="cpu")
    card.sql(FUNCTION_UDF)
    try:
        for q, text in FUNCTION_QUERIES.items():
            _set(AUTO_STRATEGIES)
            want = cpu.sql(text).table
            _set(KERNEL_STRATEGIES)
            got = card.sql(text).table
            rel = 1e-4 if q in ("F1", "F10", "F11") else 1e-6
            assert tables_agree(got, want, rel=rel), q
    finally:
        _set(AUTO_STRATEGIES)
        udf._REGISTRY.clear()


# --- execution beyond device memory (slice 6) -------------------------------


SPILL_N = 1 << 20


def _spill_catalog():
    """2^20 rows of facts (groups, float and decimal values, NULLs) and a
    2^19-row build side whose key 7 holds a quarter of it."""
    from starrocks_tpu_torch.column import HostTable
    from starrocks_tpu_torch.storage.catalog import Catalog

    rng = np.random.default_rng(41)
    n, m = SPILL_N, SPILL_N // 2
    x = rng.random(n) * 100
    bk = rng.integers(0, 60_000, m)
    bk[: m // 4] = 7
    cat = Catalog()
    fact = HostTable.from_pydict({
        "k": rng.integers(0, 70_000, n), "g": rng.integers(0, 12, n),
        "x": x, "v": rng.integers(-1000, 1000, n)})
    fact.valids["x"] = rng.random(n) > 0.05
    cat.register("fact", fact)
    cat.register("dim", HostTable.from_pydict({
        "k": bk, "w": rng.integers(0, 100, m)}))
    return cat


SPILL_GPU_QUERIES = {
    "batched": "select g, count(*) c, sum(v) sv, sum(x) sx, avg(x) ax, "
               "stddev_samp(x) sd from fact group by g order by g",
    "hybrid": "select count(*) c, sum(v + w) s from fact, dim "
              "where fact.k = dim.k",
    "spill_sort": "select k, g, v from fact order by v desc, k, g "
                  "limit 5000",
    "spill_window": "select k, g, v, row_number() over (partition by k "
                    "order by v, g) rn, sum(v) over (partition by k order "
                    "by v, g) rs from fact where g < 3",
}


@pytest.mark.parametrize("executor", sorted(SPILL_GPU_QUERIES))
def test_spill_executors_on_card_match_cpu(cuda, executor):
    """Each spill executor on the card (lineitem-like 2^20 rows streamed in
    2^18-row batches) against the CPU: batched aggregation (warm, under the
    kernel strategies: segment_sum in every PARTIAL batch and the FINAL
    merge, f32 sums to 1e-4), the hybrid join with spilled partitions, the
    spilled sort and the spilled window, exactly."""
    from chip_smoke import tables_agree
    from starrocks_tpu_torch.runtime import batched

    cat = _spill_catalog()
    q = SPILL_GPU_QUERIES[executor]
    knobs = {"batch_rows_threshold": 1 << 18, "spill_batch_rows": 1 << 18}
    try:
        _set({**AUTO_STRATEGIES, **knobs})
        want = Session(cat, device="cpu").sql(q).table
        _set({**KERNEL_STRATEGIES, **knobs})
        card = Session(cat, device=cuda)
        card.sql(q)  # cold: the batched aggregation learns its capacity
        kernels.reset_counts()
        got = card.sql(q).table
        node = next({**c.infos, **{k: v for k, (v, _) in c.counters.items()}}
                    for c in card.last_profile.children if c.name == executor)
        if executor == "batched":
            assert node["batches"] == 4
            assert kernels.counts()["segment_sum"]["launches"] > 0
            assert tables_agree(got, want, rel=1e-4)
        else:
            if executor == "hybrid":
                assert node["hybrid_spilled"] >= 1
                assert node["hybrid_skew_keys"] >= 1
            if executor == "spill_window":
                got, want = (_sorted_table(t) for t in (got, want))
            assert tables_agree(got, want)
        assert batched.SPILL_PARTS_LIVE.value == 0
    finally:
        for k in knobs:
            config.set(k, 0)
        _set(AUTO_STRATEGIES)


def _sorted_table(t):
    """A HostTable's rows in a canonical order (a spilled window's groups
    come back in hash order)."""
    from starrocks_tpu_torch.column import HostTable

    rows = sorted(t.to_pylist(), key=str)
    cols = list(zip(*rows)) if rows else [[] for _ in t.schema]
    return HostTable.from_pydict(
        {f.name: list(c) for f, c in zip(t.schema, cols)})


DIST_GPU_RUNS = [("kernels", "Q1"), ("kernels", "Q5"), ("kernels", "Q18"),
                 ("kernels", "S1"), ("kernels", "S2"), ("kernels", "N1"),
                 ("kernels", "W2"), ("kernels", "O1"), ("hash", "Q3"),
                 ("hash", "Q10")]


def test_dist_path_on_card_matches_cpu(cuda):
    """Session(dist_shards=8) at SF 0.01 on the card (the shards' tables
    under the lowered thresholds of the CPU tests) against the same
    8-shard Session on the CPU under `auto`: the same rows (S1/S2's f32
    sums to 1e-4), and every one of the five kernels launched on the card
    (segment_sum by S1/S2's per-shard PARTIAL, topn_select by N1's
    per-shard top-N, probe_searchsorted and the hash pair by the local
    joins)."""
    import starrocks_tpu_torch.sql.distributed as D
    from chip_smoke import tables_agree
    from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

    old = D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS
    D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS = 10_000, 4_000
    cat = tpch_catalog(sf=0.01)
    launched = dict.fromkeys(kernels.WRAPPERS, 0)
    try:
        _set(AUTO_STRATEGIES)
        cpu = Session(cat, device="cpu", dist_shards=8)
        want = {q: cpu.sql(DIST_QUERIES[q]).table for _, q in DIST_GPU_RUNS}
        card = Session(cat, device=cuda, dist_shards=8)
        for strategy, q in DIST_GPU_RUNS:
            _set({**KERNEL_STRATEGIES, **(
                {"join_probe_strategy": "pallas"} if strategy == "hash"
                else {})})
            kernels.reset_counts()
            got = card.sql(DIST_QUERIES[q]).table
            for n, c in kernels.counts().items():
                launched[n] += c["launches"]
            rel = 1e-4 if q in ("S1", "S2") else 1e-6
            assert tables_agree(_sorted_table(got), _sorted_table(want[q]),
                                rel=rel), q
            assert card.last_profile.infos["fragments"] >= 2, q
    finally:
        _set(AUTO_STRATEGIES)
        D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS = old
    assert all(v > 0 for v in launched.values()), launched


def test_hash_build_of_4096_slots_first_in_a_process(cuda):
    """A table of 4096 slots is one slice of 48 KB of keys and rows in
    shared memory, and the insert kernel has 4 bytes of static shared
    memory besides: the launch needs the opt-in past 48 KB. Launched first
    in a fresh process (before any larger table set the opt-in) it failed
    with `invalid argument` (the dist path's Q3 at SF 0.01, 8 shards)."""
    import os
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from starrocks_tpu_torch.ops import kernels\n"
        "k = torch.arange(2048, dtype=torch.int64, device='cuda') * 7919\n"
        "t, r = kernels.hash_build(k, 4096)\n"
        "row = kernels.hash_probe(t, r, k)\n"
        "assert torch.equal(row.long().cpu(), torch.arange(2048)), row\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


# --- the mesh over several devices ---------------------------------------------

MIXED_MESH = ("cuda:0", "cpu") * 4


def _mixed_session(cat):
    """A card Session whose 8-shard executor runs over the mixed mesh
    (cuda:0, cpu) x 4: every exchange crosses devices, every REPLICATED
    value is needed on both, and the CPU shards take the plain versions."""
    from starrocks_tpu_torch.runtime.dist_executor import DistExecutor

    s = Session(cat, device="cuda", dist_shards=8)
    s._dist_executor = DistExecutor(cat, mesh=MIXED_MESH,
                                    device_cache=s.cache)
    return s


def _misplaced(s) -> list:
    """Every input the executor placed for the plans it ran, walked shard
    by shard against its mesh (placement_errors)."""
    from starrocks_tpu_torch.runtime.dist_executor import placement_errors

    ex = s._dist_executor
    errs = []
    for _ir, scans_meta in list(ex._frag_ir_memo.values()):
        errs += placement_errors(ex._place(scans_meta), ex.mesh)
    return errs


@pytest.mark.parametrize("strategy", ["kernels", "auto"])
def test_dist_mixed_mesh_matches_single_shard(cuda, strategy):
    """DIST_QUERIES at SF 0.1 over the mixed mesh (cuda:0, cpu) x 4, under
    the kernel strategies and under `auto`, with the rows of the
    single-shard card Session (S1/S2's f32 cells to 1e-4 under the
    kernels), every placed shard on its own device after each query, and
    under the kernels every launch on cuda:0."""
    import starrocks_tpu_torch.sql.distributed as D
    from chip_smoke import tables_agree
    from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

    old = D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS
    D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS = 10_000, 4_000
    cat = tpch_catalog(sf=0.1)
    try:
        _set(AUTO_STRATEGIES)
        one = Session(cat, device=cuda)
        want = {q: one.sql(t).table for q, t in DIST_QUERIES.items()}
        mixed = _mixed_session(cat)
        _set(KERNEL_STRATEGIES if strategy == "kernels" else AUTO_STRATEGIES)
        kernels.reset_counts()
        for q, text in DIST_QUERIES.items():
            got = mixed.sql(text).table
            rel = 1e-4 if strategy == "kernels" and q in ("S1", "S2") else 1e-6
            assert tables_agree(_sorted_table(got), _sorted_table(want[q]),
                                rel=rel), q
            assert mixed.last_profile.infos["fragments"] >= 2, q
            assert _misplaced(mixed) == [], q
        per_card = kernels.launches_per_card()
    finally:
        _set(AUTO_STRATEGIES)
        D.SHARD_THRESHOLD_ROWS, D.SHUFFLE_AGG_MIN_GROUPS = old
    cards = {c for v in per_card.values() for c in v}
    if strategy == "kernels":
        assert cards == {"cuda:0"}, per_card
        assert per_card["segment_sum"] and per_card["probe_searchsorted"]
    else:
        assert cards == set(), per_card


def test_default_dist_session_places_shards_by_the_rule(cuda):
    """Session(dist_shards=8) on a bare `cuda`: the shards on the cards
    `shard_devices` names for this machine's count (all on cuda:0 with one
    card), its placed inputs there; on `cuda:0` by name, every shard on
    cuda:0."""
    from starrocks_tpu_torch.parallel.mesh import shard_devices

    import starrocks_tpu_torch.sql.distributed as D

    old = D.SHARD_THRESHOLD_ROWS
    D.SHARD_THRESHOLD_ROWS = 10_000  # SF 0.01: lineitem and orders shard
    cat = tpch_catalog(sf=0.01)
    try:
        s = Session(cat, dist_shards=8)
        mesh = s._executor().mesh
        assert mesh.devices == shard_devices(8, "cuda",
                                             torch.cuda.device_count())
        assert mesh.device == torch.device("cuda", 0)
        assert s.sql(QUERIES[3]).table.num_rows > 0
        assert _misplaced(s) == []
        named = Session(cat, device="cuda:0", dist_shards=8)._executor().mesh
        assert set(named.devices) == {torch.device("cuda", 0)}
    finally:
        D.SHARD_THRESHOLD_ROWS = old


@pytest.fixture
def two_cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards; this machine has {n}")
    return n


def test_default_dist_session_spreads_over_the_cards(two_cards):
    """With two or more cards the default 8-shard Session covers k > 1 of
    them, and Q3 under the kernel strategies launches on each card that
    holds a shard, with the single-card Session's rows."""
    import starrocks_tpu_torch.sql.distributed as D
    from chip_smoke import tables_agree

    old = D.SHARD_THRESHOLD_ROWS
    D.SHARD_THRESHOLD_ROWS = 10_000
    cat = tpch_catalog(sf=0.1)
    try:
        want = Session(cat, device="cuda:0", dist_shards=8).sql(
            QUERIES[3]).table
        s = Session(cat, dist_shards=8)
        mesh = s._executor().mesh
        assert len(mesh.cards) > 1, mesh
        _set(KERNEL_STRATEGIES)
        kernels.reset_counts()
        got = s.sql(QUERIES[3]).table
        per_card = kernels.launches_per_card()["probe_searchsorted"]
        config.set("enable_device_profile", True)
        assert tables_agree(_sorted_table(s.sql(QUERIES[3]).table),
                            _sorted_table(want))
        tries = [c for c in s.last_profile.children
                 if c.name.startswith("attempt_")]
    finally:
        config.set("enable_device_profile", False)
        _set(AUTO_STRATEGIES)
        D.SHARD_THRESHOLD_ROWS = old
    assert tables_agree(_sorted_table(got), _sorted_table(want))
    assert _misplaced(s) == []
    assert set(per_card) == {str(d) for d in mesh.cards}, per_card
    # the device profile synchronises every card and reports each peak
    assert tries and all(c.infos["device_time_ms"] > 0 for c in tries)
    for c in tries:
        assert set(c.infos["device_memory_per_card"]) == {
            str(d) for d in mesh.cards}


def test_each_kernel_on_the_second_card_equals_plain(two_cards):
    """Each of the five kernels launched on cuda:1, on tensors of cuda:1:
    its answer equals its plain version's and its launch counts on
    cuda:1."""
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(7)
    keys = torch.from_numpy(rng.permutation(1 << 20)[:50_000].astype(
        np.int64) * 7919).to(dev)
    kernels.reset_counts()
    tkey, trow = kernels.hash_build(keys, 1 << 17)
    assert tkey.device == dev
    probe = torch.cat([keys[:20_000], keys[:5_000] + 1])
    got = kernels.hash_probe(tkey, trow, probe)
    want = kernels.hash_probe_plain(tkey, trow, probe)
    assert torch.equal(got, want)
    assert torch.equal(got[:20_000].long().cpu(), torch.arange(20_000))
    neg = torch.from_numpy(rng.integers(-1 << 40, 1 << 40, 1 << 16)).to(dev)
    v, i = kernels.topn_select(neg, 37)
    pv, pi = kernels.topn_select_plain(neg, 37)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    build = torch.sort(keys).values
    assert torch.equal(kernels.probe_searchsorted(build, probe),
                       kernels.probe_searchsorted_plain(build, probe))
    gid = rng.integers(0, 9, 1 << 16).astype(np.int32)  # 8 = dead rows
    vals = (rng.random((1 << 16, 3)) * 100).astype(np.float32)
    out = kernels.segment_sum(torch.from_numpy(gid).to(dev),
                              torch.from_numpy(vals).to(dev), 8, 1024)
    assert out.device == dev
    # the kernel's own order of addition, as on cuda:0: bit for bit, and
    # within 1e-6 * sum |x| of f64 as the plain version is held
    assert _within_f64(out, gid, vals, 8)
    assert np.array_equal(out.cpu().numpy(),
                          segment_sum_order_model(gid, vals, 8))
    per_card = kernels.launches_per_card()
    assert all(set(v) == {"cuda:1"} for v in per_card.values()), per_card


def test_hash_build_on_card_1_leaves_card_0_launchable(two_cards):
    """A hash build on cuda:1 sets its shared-memory opt-in on cuda:1
    under the launch's device guard: a build of the same size on cuda:0
    after it still launches and answers."""
    for d in (1, 0):
        k = torch.arange(2048, dtype=torch.int64, device=f"cuda:{d}") * 7919
        t, r = kernels.hash_build(k, 4096)
        row = kernels.hash_probe(t, r, k)
        assert torch.equal(row.long().cpu(), torch.arange(2048)), d


# --- the process mesh on the card --------------------------------------------


def _process_mesh_on_cards(visible: str, backend: str, cards: list):
    """len(cards) ranks of tests/test_torch_process_mesh.py's worker with
    CUDA_VISIBLE_DEVICES=`visible`: each takes `backend`, every collective
    case it runs equals InProcess with its results on the rank's card
    (`cards[r]`), the mesh names every shard's card, and Q3 at SF 0.1 over
    the 8 shards gives the single-shard Session's rows."""
    import gc

    from chip_smoke import answer_rows, answers_agree
    from test_torch_process_mesh import CLASSES, query_text, run_ranks

    want = Session(tpch_catalog(sf=0.1), device="cuda:0").sql(
        query_text("Q3")).rows()
    gc.collect()
    torch.cuda.empty_cache()
    recs, outs, rcs = run_ranks("cuda", 0.1, ["Q3"], procs=len(cards),
                                env={"CUDA_VISIBLE_DEVICES": visible})
    assert rcs == [0] * len(cards), "\n".join(o[-3000:] for o in outs)
    classes = set(CLASSES) if backend == "nccl" else {"Gloo"}
    for r, rec in enumerate(recs):
        assert rec["backend"] == backend and rec["device"] == cards[r]
        assert {k[0] for k in rec["collectives"]} == classes
        bad = {k: v for k, v in rec["collectives"].items()
               if v != {"equal": True, "devices": [cards[r]]}}
        assert not bad, bad
        per = 8 // len(cards)
        assert rec["devices"] == [cards[s // per] for s in range(8)]
        assert rec["coll"] == ("Nccl" if backend == "nccl" else "Gloo")
        got = sorted(rec["rows"]["Q3"], key=str)
        assert answers_agree(got, answer_rows(sorted(want, key=str)))


def test_process_mesh_over_nccl_on_two_cards(two_cards):
    """Ranks 0 and 1 on cuda:0 and cuda:1, one group with an NCCL side:
    the `Nccl` collectives run on the cards (and `Gloo`'s staged ones over
    the group's gloo side), their results CUDA tensors on each rank's
    card."""
    _process_mesh_on_cards("0,1", "nccl", ["cuda:0", "cuda:1"])


def test_process_mesh_of_one_rank_over_nccl(cuda):
    """One rank, its own card: the group has the NCCL side, and every
    `Nccl` collective runs through NCCL on cuda:0 (a world of one)."""
    _process_mesh_on_cards("0", "nccl", ["cuda:0"])


def test_process_mesh_sharing_one_card_over_gloo(cuda):
    """Both ranks on cuda:0 (NCCL refuses two ranks on one card): a gloo
    group, the `Gloo` collectives staged through host memory, their
    results back on cuda:0."""
    _process_mesh_on_cards("0", "gloo", ["cuda:0", "cuda:0"])


# --- the process mesh over emulated hosts -----------------------------------


@pytest.fixture
def four_cards(cuda):
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four or more cards; this machine has {n}")
    return n


def _emulated_hosts(visible: list, ranks_per_host: int, backend: str,
                    cards: list, devices: list, knobs=None) -> list:
    """Two or more emulated hosts, as chip_smoke's dist_procs phase starts
    them: host h is named host<h>, sees the cards `visible[h]` (its own
    CUDA_VISIBLE_DEVICES) and sets NCCL_HOSTID host<h>, with NCCL's sockets
    on loopback (chip_smoke.EMULATED_HOST_ENV); `ranks_per_host` ranks of
    tests/test_torch_process_mesh.py's worker each. Every rank takes
    `backend` and its cards `cards[r]` (as its host numbers them), every
    collective case equals InProcess with its results on the rank's first
    card, Mesh.devices is `devices` and Mesh.hosts each shard's rank's
    host, and Q3 at SF 0.1 gives the single-shard rows. Returns the
    records."""
    import gc

    from chip_smoke import EMULATED_HOST_ENV, answer_rows, answers_agree
    from test_torch_process_mesh import CLASSES, query_text, run_ranks

    ranks = [(f"host{h}", vis) for h, vis in enumerate(visible)
             for _ in range(ranks_per_host)]
    envs = [{**EMULATED_HOST_ENV, "CUDA_VISIBLE_DEVICES": vis,
             "NCCL_HOSTID": h} for h, vis in ranks]
    per = len(devices) // len(ranks)
    hosts = [h for h, _ in ranks for _ in range(per)]
    want = Session(tpch_catalog(sf=0.1), device="cuda:0").sql(
        query_text("Q3")).rows()
    gc.collect()
    torch.cuda.empty_cache()
    recs, outs, rcs = run_ranks("cuda", 0.1, ["Q3"], procs=len(ranks),
                                hosts=[h for h, _ in ranks], envs=envs,
                                knobs=knobs)
    assert rcs == [0] * len(ranks), "\n".join(o[-3000:] for o in outs)
    classes = set(CLASSES) if backend == "nccl" else {"Gloo"}
    for r, rec in enumerate(recs):
        first = f"cuda:{cards[r][0]}"
        assert rec["backend"] == backend and rec["device"] == first
        assert tuple(rec["cards"]) == cards[r]
        assert {k[0] for k in rec["collectives"]} == classes
        bad = {k: v for k, v in rec["collectives"].items()
               if v != {"equal": True, "devices": [first]}}
        assert not bad, bad
        assert rec["devices"] == devices
        assert rec["hosts"] == hosts
        assert rec["coll"] == ("Nccl" if backend == "nccl" else "Gloo")
        got = sorted(rec["rows"]["Q3"], key=str)
        assert answers_agree(got, answer_rows(sorted(want, key=str)))
    return recs


def test_process_mesh_over_two_emulated_hosts_on_one_card(cuda):
    """Two emulated hosts that each see cuda:0, one rank x 4 shards each:
    a card a rank on each host, so the rule says NCCL, which runs its
    network transport between the hosts (on one physical card)."""
    _emulated_hosts(["0", "0"], 1, "nccl", [(0,), (0,)], ["cuda:0"] * 8)


def test_process_mesh_over_two_emulated_hosts_on_two_cards(two_cards):
    """Host 0 sees card 0, host 1 card 1, a rank each: the cross-host
    collectives of `Nccl` and `Gloo` equal InProcess; each host numbers
    its card cuda:0."""
    _emulated_hosts(["0", "1"], 1, "nccl", [(0,), (0,)], ["cuda:0"] * 8)


def test_one_rank_per_host_holds_two_cards(four_cards):
    """The JAX pod layout: one rank a host holding its host's two cards,
    4 shards over them (cuda:0, cuda:0, cuda:1, cuda:1 on each host);
    Q3 under the kernel strategies launches each kernel it runs on both
    of a rank's cards."""
    recs = _emulated_hosts(["0,1", "2,3"], 1, "nccl", [(0, 1), (0, 1)],
                           ["cuda:0", "cuda:0", "cuda:1", "cuda:1"] * 2,
                           knobs=KERNEL_STRATEGIES)
    for rec in recs:
        per_card = {k: v for k, v in rec["launches_per_card"].items() if v}
        assert "probe_searchsorted" in per_card, per_card
        assert all(set(v) == {"cuda:0", "cuda:1"}
                   for v in per_card.values()), per_card


# --- the serving planes on the card ------------------------------------------

SERVE_GPU_QUERIES = {"Q3": QUERIES[3], "Q9": QUERIES[9],
                     "S1": STAT_QUERIES["S1"]}


def _serve_texts():
    from starrocks_tpu_torch.storage.tpch_queries import TOPN_QUERIES

    return {**SERVE_GPU_QUERIES, "N1": TOPN_QUERIES["N1"]}


def test_serving_tier_on_card_with_four_clients_matches_cpu(cuda):
    """A ServingTier over a card Session at SF 0.01: four client threads
    run Q3, Q9, S1 and N1 under the kernel strategies, each rotated, and
    every answer equals the CPU's under `auto` (S1's f32 sums to 1e-4);
    the kernels launched; nothing is left registered or queued."""
    import threading

    from chip_smoke import tables_agree
    from starrocks_tpu_torch.runtime.lifecycle import REGISTRY
    from starrocks_tpu_torch.runtime.serving import ServingTier

    texts = _serve_texts()
    cat = tpch_catalog(sf=0.01)
    _set(AUTO_STRATEGIES)
    cpu = Session(cat, device="cpu")
    want = {q: cpu.sql(t).table for q, t in texts.items()}
    _set(KERNEL_STRATEGIES)
    tier = ServingTier(Session(cat, device=cuda), pool_size=4)
    errors = []
    try:
        kernels.reset_counts()
        names = sorted(texts)

        def client(i):
            sess = tier.new_session()
            try:
                for k in range(len(names)):
                    q = names[(i + k) % len(names)]
                    got = tier.execute(sess, texts[q]).table
                    rel = 1e-4 if q == "S1" else 1e-6
                    if not tables_agree(got, want[q], rel=rel):
                        errors.append(q)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(repr(e))

        ths = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
        launched = {n: c["launches"] for n, c in kernels.counts().items()}
    finally:
        tier.shutdown()
        _set(AUTO_STRATEGIES)
    assert not errors, errors
    for n in ("segment_sum", "probe_searchsorted", "topn_select"):
        assert launched[n] > 0, launched
    assert REGISTRY.snapshot() == [] and tier.pool.pending() == 0


def test_killed_query_on_card_frees_its_device_memory(cuda):
    """A KILL that lands after the program ran (at the fetch checkpoint,
    its intermediates alive) unwinds with QueryCancelledError, and the
    memory allocated on the card returns to its value before the query,
    but for what the DeviceCache placed during it (a join's cached build
    order) and the kernels' last-call diagnostics."""
    import gc

    from chip_smoke import _cache_bytes, _diag_bytes
    from starrocks_tpu_torch.runtime import failpoint, lifecycle

    cat = tpch_catalog(sf=0.01)
    _set(KERNEL_STRATEGIES)
    s = Session(cat, device=cuda)
    q = QUERIES[9]
    try:
        s.sql(q)  # places the columns and learns the capacities
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated() - _diag_bytes(kernels)
        cache_before = _cache_bytes(s.cache)

        def kill_current():
            ctx = lifecycle.current()
            lifecycle.REGISTRY.cancel(ctx.qid, requester="root", admin=True)

        killed = False
        with failpoint.scoped("executor::fetch_results", action=kill_current):
            try:
                s.sql(q)
            except lifecycle.QueryCancelledError:
                killed = True
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated() - _diag_bytes(kernels)
        grown = _cache_bytes(s.cache) - cache_before
    finally:
        _set(AUTO_STRATEGIES)
    assert killed
    assert after - before <= max(grown, 0), (before, after, grown)


def test_launch_counts_under_four_threads_sum_the_single_counts(cuda):
    """Q9 and S1 under the kernel strategies from four threads at once, on
    four card Sessions over one catalog: every kernel's launches are four
    times one thread's."""
    import threading

    texts = [QUERIES[9], STAT_QUERIES["S1"]]
    cat = tpch_catalog(sf=0.01)
    _set(KERNEL_STRATEGIES)
    try:
        sessions = [Session(cat, device=cuda) for _ in range(4)]
        for s in sessions:
            for t in texts:
                s.sql(t)  # cold capacities learned in every session
        kernels.reset_counts()
        for t in texts:
            sessions[0].sql(t)
        one = {n: c["launches"] for n, c in kernels.counts().items()}
        kernels.reset_counts()
        errors = []

        def run(i):
            try:
                for t in texts:
                    sessions[i].sql(t)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(repr(e))

        ths = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
        four = {n: c["launches"] for n, c in kernels.counts().items()}
    finally:
        _set(AUTO_STRATEGIES)
    assert not errors, errors
    assert one["segment_sum"] > 0 and one["probe_searchsorted"] > 0
    assert four == {n: 4 * v for n, v in one.items()}, (one, four)


def test_device_profile_on_card(cuda):
    """`SET enable_device_profile` on the card: each attempt of Q9 under
    the kernel strategies carries its CUDA-event milliseconds and the peak
    allocated bytes (at least what was allocated before it), and the rows
    equal those with the knob off."""
    cat = tpch_catalog(sf=0.01)
    _set(KERNEL_STRATEGIES)
    s = Session(cat, device=cuda)
    try:
        want = s.sql(QUERIES[9]).rows()
        config.set("enable_device_profile", True)
        got = s.sql(QUERIES[9]).rows()
        tries = [c for c in s.last_profile.children
                 if c.name.startswith("attempt_")]
    finally:
        config.set("enable_device_profile", False)
        _set(AUTO_STRATEGIES)
    assert got == want and tries
    for c in tries:
        mem = c.infos["device_memory"]
        assert c.infos["device_time_ms"] > 0
        assert mem["peak_allocated_bytes"] >= mem["allocated_before_bytes"] > 0


# --- loading ------------------------------------------------------------------

LOAD_QUERIES = ("3", "5", "18")


def _orders_ddl(orders, name="orders"):
    return f"CREATE TABLE {name} (" + ", ".join(
        f"{f.name} {f.type!r}" for f in orders.schema) + ")"


def _load_both(tmp_path, load):
    """The card's and the CPU's rows of Q3, Q5, Q18 and N3 over TPC-H SF
    0.1 whose orders `load(session, orders)` replaced."""
    from starrocks_tpu_torch.storage.tpch_queries import TOPN_QUERIES

    out = []
    for dev in ("cuda", "cpu"):
        cat = tpch_catalog(sf=0.1)
        orders = cat.get_table("orders").table
        s = Session(cat, device=dev)
        s.sql("DROP TABLE orders")
        load(s, orders)
        s.sql("SET join_probe_strategy = 'pallas_sorted'")
        s.sql("SET topn_strategy = 'pallas'")
        try:
            out.append([s.sql(QUERIES[int(q)]).rows() for q in LOAD_QUERIES]
                       + [s.sql(TOPN_QUERIES["N3"]).rows()])
        finally:
            config.set("join_probe_strategy", "auto")
            config.set("topn_strategy", "auto")
    return out


def test_load_csv_on_card_matches_cpu(cuda, tmp_path):
    from starrocks_tpu_torch.storage.formats.csv import write_csv

    path = str(tmp_path / "orders.csv")

    def load(s, orders):
        if not (tmp_path / "orders.csv").exists():
            write_csv(orders, path)
        s.sql(_orders_ddl(orders))
        assert s.load_csv("orders", path) == orders.num_rows

    got, want = _load_both(tmp_path, load)
    assert got == want and all(len(r) for r in got[:1])


def test_external_parquet_on_card_matches_cpu(cuda, tmp_path):
    import chip_smoke

    d = tmp_path / "orders_pq"

    def load(s, orders):
        if not d.exists():
            d.mkdir()
            n = orders.num_rows
            for i in range(3):
                chip_smoke.ingest_parquet(
                    orders, str(d / f"part-{i}.parquet"), n * i // 3,
                    n * (i + 1) // 3)
        s.sql(f"CREATE EXTERNAL TABLE orders FROM '{d}'")

    got, want = _load_both(tmp_path, load)
    assert got == want


def test_lake_fixtures_on_card_match_cpu(cuda):
    """Every lake fixture as an external table: SELECT * (ARRAY and BITMAP
    columns included) on the card equals the CPU's rows; on the two ZSTD
    fixtures N3 launches the top-N kernel and equals the CPU's rows."""
    import json
    import os

    from starrocks_tpu_torch.storage.catalog import Catalog
    from starrocks_tpu_torch.storage.tpch_queries import TOPN_QUERIES

    here = os.path.join(os.path.dirname(__file__), "data", "torch_formats")
    with open(os.path.join(here, "MANIFEST.json")) as fh:
        names = sorted(json.load(fh)["fixtures"])
    for name in names:
        out = []
        for dev in ("cuda", "cpu"):
            s = Session(Catalog(), device=dev)
            s.sql(f"CREATE EXTERNAL TABLE orders FROM "
                  f"'{os.path.join(here, name)}'")
            rows = [s.sql("select * from orders").rows()]
            if name.startswith("orders_zstd"):
                s.sql("SET topn_strategy = 'pallas'")
                kernels.reset_counts()
                try:
                    rows.append(s.sql(TOPN_QUERIES["N3"]).rows())
                finally:
                    config.set("topn_strategy", "auto")
                if dev == "cuda":
                    assert kernels.counts()["topn_select"]["launches"] >= 1
            out.append(rows)
        assert out[0] == out[1], name
        assert len(out[0][0]) > 0, name


def test_reference_data_dir_and_brotli_on_card(cuda, tmp_path):
    """The data directory the JAX package wrote (tests/data/torch_store/
    reference_dir: pyarrow's parquet rowsets, its journal and sidecar)
    opened by a Session on the card gives every answer of
    reference_answers.json; the port's own parquet files written there
    (an upsert, then compaction) read back on the card as on the CPU; and
    the BROTLI lake fixtures read on the card equal their CPU rows."""
    import json
    import os
    import shutil

    from chip_smoke import answers_agree, fixtures_dir, store_data_dir
    from starrocks_tpu_torch.storage.catalog import Catalog

    here = store_data_dir()
    ans = json.loads((here / "reference_answers.json").read_text())
    d = tmp_path / "db"
    shutil.copytree(here / "reference_dir", d)
    s = Session(data_dir=str(d))
    for q, text in ans["queries"].items():
        assert answers_agree(s.sql(text).rows(), ans["answers"][q]), q
    s.sql("insert into kv values (2, 'two', 22), (10, 'ten', 100)")
    s.store.compact_table("kv")
    s.catalog.get_table("kv").invalidate()
    q = "select * from kv order by k"
    got = s.sql(q).rows()
    assert got == Session(device="cpu", data_dir=str(d)).sql(q).rows()
    assert (2, "two", 22) in got and len(got) == 7
    assert all(f.endswith(".parquet") for f in os.listdir(d / "kv")
               if f.startswith("rowset_"))
    for name in ("orders_brotli.parquet", "text_brotli11.parquet"):
        out = []
        for dev in ("cuda", "cpu"):
            e = Session(Catalog(), device=dev)
            e.sql(f"CREATE EXTERNAL TABLE lake FROM "
                  f"'{fixtures_dir() / name}'")
            out.append(e.sql("select * from lake").rows())
        assert out[0] == out[1] and len(out[0]) > 0, name


def test_orc_lzo_lake_on_card(cuda):
    """The committed ORC LZO fixture (orders SF 0.1) as an external table
    on the card: every column equals its manifest entry, and N3 under the
    top-N kernel launches it and equals the CPU's rows."""
    import json

    from chip_smoke import _manifest_mismatches, fixtures_dir
    from starrocks_tpu_torch.storage.catalog import Catalog
    from starrocks_tpu_torch.storage.tpch_queries import TOPN_QUERIES

    name = "orders_lzo.orc"
    entry = json.loads((fixtures_dir() / "MANIFEST.json").read_text())[
        "fixtures"][name]
    rows = []
    for dev in ("cuda", "cpu"):
        s = Session(Catalog(), device=dev)
        s.sql(f"CREATE EXTERNAL TABLE orders FROM '{fixtures_dir() / name}'")
        assert _manifest_mismatches(
            s.catalog.get_table("orders").table, entry) == []
        s.sql("SET topn_strategy = 'pallas'")
        kernels.reset_counts()
        try:
            rows.append(s.sql(TOPN_QUERIES["N3"]).rows())
        finally:
            config.set("topn_strategy", "auto")
        if dev == "cuda":
            assert kernels.counts()["topn_select"]["launches"] >= 1
    assert rows[0] == rows[1] and len(rows[0]) > 0


def test_stream_load_visible_on_card_and_drops_the_warm_cache(cuda):
    """A micro-batch committed through the ingest plane is in the next
    query's rows on the card; the commit drops the table's warm device
    columns."""
    from starrocks_tpu_torch.storage.catalog import Catalog

    s = Session(Catalog())
    s.sql("create table ti (k bigint, v double, primary key (k))")
    s.sql("insert into ti values " + ", ".join(
        f"({i}, {i * 0.5})" for i in range(1000)))
    q = "select count(*), sum(k), max(v) from ti"
    assert s.sql(q).rows() == [(1000, 499500, 499.5)]
    s.sql(q)  # warm: the columns sit in the device cache
    assert any(k[0] == "ti" for k in s.cache._cols)
    plane = s.ingest_plane()
    config.set("ingest_batch_age_ms", 5)
    try:
        r = plane.load(s, "ti", [{"k": 5000 + i, "v": 1e4 + i}
                                 for i in range(10)], label="gpu1")
    finally:
        config.set("ingest_batch_age_ms", 200)
    assert r["rows"] == 10
    assert not any(k[0] == "ti" for k in s.cache._cols)
    assert s.sql(q).rows() == [(1010, 499500 + 50045, 10009.0)]
    assert s.cache._cols and all(
        d.device.type == "cuda" for d, _ in s.cache._cols.values())
