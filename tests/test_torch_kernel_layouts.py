"""The host-side layouts of the port's redesigned CUDA kernels, and numpy
models of what the kernels do with them, on the CPU.

The CUDA code (starrocks_tpu_torch/csrc/probe_searchsorted.cu,
segment_sum.cu and hash_table.cu) cannot run here; what it mirrors can:

- `probe_index_layout` / `probe_index`: the static search tree's level
  sizes, separators and int64-max padding, and a numpy model of the
  kernel's descent over it (top level searched, one node per lower level,
  one leaf group of the build) that equals np.searchsorted exactly on
  every edge case — K < 4, K not a multiple of 4, 64 or 1024, probes equal
  to separators, runs of equal keys of length 5, 65 and 1025 across node
  boundaries, int64-max probes with and without a sentinel tail,
  INT64_MIN — with the default top level and with deep trees forced by a
  small top level;
- `segment_sum_partition` / `segment_sum_warps`: pass 1's CTAs and rows
  (a function of N alone) and warps, and a numpy model of the kernel's
  order of addition in float32 (lane trees over each group's lanes,
  per-warp chains, warps, CTAs strided by 8), held to an f64 sum at
  1e-6 * sum |x| per (group, column). tests/test_torch_gpu.py holds the
  card's kernels to these same models bit for bit;
- `hash_partition_layout`: the hash kernels' table slices, shared memory
  and probe route, and numpy models of the partitioned build (keys
  grouped by slice, inserted per slice in seeded random orders, deferred
  at the slice's end, then a global overflow walk) and of the partitioned
  probe (a window of slice + halo, then the global walk), on the slices'
  edges: chains across an inner slice's end and T - 1 -> 0, T < S, T = S,
  N = 0, all-sentinel keys, M = 0, all-sentinel probes; with the default
  slices and slices of 64 slots, the default halo and a halo of 1. The
  model's tables satisfy the table invariants (each live key once, with
  its row; the chain invariant) and answer every probe as the plain
  build's table does. The card's kernels race, so the gpu tests hold them
  to the same invariants and answers, not to the model slot for slot.

JAX-free: the file imports only the port, torch and numpy.
"""

import functools

import numpy as np
import pytest
import torch

from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.ops.common import mix64

I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)
SEG_REL = 1e-6  # |sum - f64 sum| <= SEG_REL * sum |x|, per (group, column)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain hash build's claim rounds are thousands of small torch ops
    over the table: with the CPU's whole thread pool per op, six test
    workers oversubscribe the cores and one case took 663 s instead of 7."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the probe's search tree ---------------------------------------------------


def probe_descent_model(build, probe):
    """The kernel's descent, vectorised over the probes, over the index the
    wrapper builds (numpy; raises IndexError if a node is out of bounds)."""
    build = np.asarray(build, np.int64)
    probe = np.asarray(probe, np.int64)
    k = len(build)
    if k == 0:
        return np.zeros(len(probe), np.int32)
    index, levels = kernels.probe_index(torch.from_numpy(build))
    index = index.numpy()
    _, n_top, off_top = levels[-1]
    node = np.searchsorted(index[off_top:off_top + n_top], probe, "left")
    past = node == n_top
    node = np.where(past, 0, node)
    lanes = np.arange(kernels.PROBE_NODE)
    for _, _, off in reversed(levels[:-1]):
        seg = index[off + node[:, None] * kernels.PROBE_NODE + lanes]
        node = node * kernels.PROBE_NODE + (seg < probe[:, None]).sum(1)
    first = node * kernels.PROBE_LEAF
    at = first[:, None] + np.arange(kernels.PROBE_LEAF)
    leaf = np.where(at < k, build[np.minimum(at, k - 1)], I64MAX)
    pos = np.minimum(first + (leaf < probe[:, None]).sum(1), k)
    return np.where(past, k, pos).astype(np.int32)


def _runs(lengths, starts, size, rng):
    """A sorted build of `size` keys holding a run of equal keys of each
    length, starting at each position."""
    keys = np.sort(rng.integers(-(1 << 40), 1 << 40, size))
    for ln, st in zip(lengths, starts):
        keys[st:st + ln] = keys[st]
    return np.sort(keys)


def probe_edge_cases(seed=11):
    """(name, sorted build, probe) with the tree's edge cases."""
    rng = np.random.default_rng(seed)
    cases = []
    for k in (1, 2, 3, 4, 5, 63, 64, 65, 1023, 1024, 1025, 4099):
        build = np.sort(rng.integers(-1000, 1000, k))
        probe = np.concatenate([build, build - 1, build + 1,
                                rng.integers(-1100, 1100, 300),
                                [I64MIN, I64MAX, I64MAX - 1]])
        cases.append((f"k{k}", build, probe))
    build = np.sort(rng.integers(-(1 << 50), 1 << 50, 70_001))
    seps = np.concatenate([build[s - 1::s] for s in (4, 64, 1024, 16384)])
    cases.append(("probe_equals_separators", build,
                  np.concatenate([seps, seps - 1, seps + 1])))
    runs = _runs((5, 65, 1025), (2, 126, 2047), 9000, rng)
    cases.append(("runs_5_65_1025_across_nodes", runs,
                  np.concatenate([runs[::7], runs[::7] - 1, runs[::7] + 1])))
    allsame = np.full(3000, 42)
    cases.append(("one_run_of_3000", allsame, np.array([41, 42, 43, I64MIN,
                                                        I64MAX])))
    tail = np.concatenate([np.sort(rng.integers(0, 1 << 30, 5001)),
                           np.full(1031, I64MAX)])
    cases.append(("sentinel_tail", tail,
                  np.concatenate([tail[::3], [I64MAX, I64MAX - 1, 0, -1]])))
    notail = np.sort(rng.integers(0, 1 << 30, 4096))
    cases.append(("int64_max_probe_no_tail", notail,
                  np.array([I64MAX, I64MAX, notail[-1], notail[-1] + 1,
                            notail[0] - 1, I64MIN])))
    ext = np.array([I64MIN, I64MIN, I64MIN + 1, -1, 0, 0, 1, I64MAX - 1,
                    I64MAX, I64MAX])
    cases.append(("int64_extremes", ext,
                  np.array([I64MIN, I64MIN + 1, I64MIN + 2, -2, -1, 0, 1, 2,
                            I64MAX - 2, I64MAX - 1, I64MAX])))
    return [(nm, np.ascontiguousarray(b, np.int64),
             np.ascontiguousarray(p, np.int64)) for nm, b, p in cases]


PROBE_CASES = [c[0] for c in probe_edge_cases()]


def _probe_case(name):
    return next(c for c in probe_edge_cases() if c[0] == name)


@pytest.mark.parametrize("k,sizes", [
    (1, [1]), (4, [1]), (5, [2]), (8192, [2048]), (8193, [2049, 129]),
    (32_768, [8192, 512]),
    (8_000_512, [2_000_128, 125_008, 7_813, 489]),
    ((1 << 31) - 1, [1 << 29, 1 << 25, 1 << 21, 1 << 17, 1 << 13, 1 << 9]),
])
def test_probe_index_layout_sizes(k, sizes):
    levels, total = kernels.probe_index_layout(k)
    assert [n for _, n, _ in levels] == sizes
    assert [s for s, _, _ in levels] == [
        kernels.PROBE_LEAF * kernels.PROBE_NODE ** i for i in range(len(sizes))]
    assert levels[-1][1] <= kernels.PROBE_TOP_MAX
    assert all(n > kernels.PROBE_TOP_MAX for _, n, _ in levels[:-1])
    padded = [-(-n // 16) * 16 for n in sizes]
    assert [off for _, _, off in levels] == list(np.cumsum([0] + padded[:-1]))
    assert total == sum(padded)
    # a node of one level covers exactly the padded level below it
    for (_, lower, _), (_, upper, _) in zip(levels, levels[1:]):
        assert upper * kernels.PROBE_NODE == -(-lower // 16) * 16


@pytest.mark.parametrize("top_max", [kernels.PROBE_TOP_MAX, 2])
@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_index_separators_and_padding(monkeypatch, top_max, case):
    monkeypatch.setattr(kernels, "PROBE_TOP_MAX", top_max)
    _, build, _ = _probe_case(case)
    k = len(build)
    index, levels = kernels.probe_index(torch.from_numpy(build))
    index = index.numpy()
    for li, (stride, n, off) in enumerate(levels):
        size = -(-n // 16) * 16
        level = index[off:off + size]
        # entry j is the build key at stride * (j + 1) - 1, int64-max past K
        at = stride * np.arange(1, size + 1) - 1
        want = np.where(at < k, build[np.minimum(at, k - 1)], I64MAX)
        assert np.array_equal(level, want)
        assert (level[n:] == I64MAX).all()
        assert (np.diff(level) >= 0).all()
        if li + 1 < len(levels):
            # each node's last entry is its parent's entry
            _, n_up, off_up = levels[li + 1]
            assert np.array_equal(level[15::16], index[off_up:off_up + n_up])


@pytest.mark.parametrize("top_max", [kernels.PROBE_TOP_MAX, 16, 2])
@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_descent_model_equals_searchsorted(monkeypatch, top_max, case):
    monkeypatch.setattr(kernels, "PROBE_TOP_MAX", top_max)
    _, build, probe = _probe_case(case)
    levels, _ = kernels.probe_index_layout(len(build))
    if top_max == 2 and len(build) > 128:
        assert len(levels) >= 3  # the small top level forces a deep tree
    got = probe_descent_model(build, probe)
    assert np.array_equal(got, np.searchsorted(build, probe, "left"))
    # and the wrapper's plain version (the CPU route) agrees
    plain = kernels.probe_searchsorted(torch.from_numpy(build),
                                       torch.from_numpy(probe))
    assert np.array_equal(plain.numpy(), got)


def test_probe_empty_build_or_probe_launches_nothing():
    kernels.reset_counts()
    got = kernels.probe_searchsorted(torch.zeros(0, dtype=torch.int64),
                                     torch.tensor([I64MIN, 0, I64MAX]))
    assert got.tolist() == [0, 0, 0] and got.dtype == torch.int32
    got = kernels.probe_searchsorted(torch.arange(5),
                                     torch.zeros(0, dtype=torch.int64))
    assert got.shape == (0,) and got.dtype == torch.int32
    assert kernels.counts()["probe_searchsorted"] == {"calls": 2,
                                                      "launches": 0}
    assert probe_descent_model([], [1, 2]).tolist() == [0, 0]


# --- the segment sum's partition and order of addition -------------------------


@pytest.mark.parametrize("n", [1, 8, 1023, 1024, 1025, 10_000, 270_336,
                               270_337, 60_005_376, 60_006_400])
def test_segment_sum_partition(n):
    ctas, rows = kernels.segment_sum_partition(n)
    assert 1 <= ctas <= kernels.SEG_CTAS
    assert rows % kernels.SEG_ROW_ALIGN == 0
    assert (ctas - 1) * rows < n <= ctas * rows  # every CTA has rows
    assert kernels.segment_sum_partition(n) == (ctas, rows)
    if n >= kernels.SEG_CTAS * kernels.SEG_ROW_ALIGN * 2:
        assert ctas >= kernels.SEG_CTAS - 1  # large inputs fill the grid
    assert kernels.segment_sum_partition(0) == (0, 0)


def test_segment_sum_partition_at_s1():
    # S1 at SF 10: 264 CTAs of 111 tiles of 2048 rows
    assert kernels.segment_sum_partition(60_005_376) == (264, 227_328)


@pytest.mark.parametrize("g,m,warps", [(1024, 1, 16), (8, 4, 16), (3, 2, 16),
                                       (1024, 2, 8), (1024, 4, 4),
                                       (1024, 14, 1),
                                       (2047, 8, 1), (4095, 4, 1)])
def test_segment_sum_warps(g, m, warps):
    assert kernels.segment_sum_warps(g, m) == warps
    assert (warps * (g + 1) * m * 4 <= kernels.SEG_SMEM_BUDGET
            or warps == 1)


def _pairwise_f32(x):
    """Pairwise sum over axis 0 in lane order, as the kernel's shuffle
    tree: adjacent pairs, an odd last element passing through."""
    x = np.asarray(x, np.float32)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[0:2 * h:2] + x[1:2 * h:2]
        x = np.concatenate([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def segment_sum_order_model(gid, vals, g):
    """The CUDA kernel's sums in float32, in its order of addition."""
    gid = np.asarray(gid, np.int64)
    vals = np.asarray(vals, np.float32)
    n, m = vals.shape
    ctas, rows = kernels.segment_sum_partition(n)
    warps = kernels.segment_sum_warps(g, m)
    key = np.clip(gid, 0, g)
    partial = np.zeros((ctas, g, m), np.float32)
    lane_rows = 4 * np.arange(32)
    for c in range(ctas):
        begin, end = c * rows, min((c + 1) * rows, n)
        acc = np.zeros((warps, g + 1, m), np.float32)
        for w in range(warps):
            for base in range(begin + w * 128, end, warps * 128):
                for j in range(4):
                    r = base + lane_rows + j
                    r = r[r < end]
                    for kk in np.unique(key[r]):
                        acc[w, kk] += _pairwise_f32(vals[r[key[r] == kk]])
        s = acc[0].copy()
        for w in range(1, warps):
            s += acc[w]
        partial[c] = s[:g]
    chains = np.zeros((8, g, m), np.float32)
    for q in range(ctas):
        chains[q % 8] += partial[q]
    out = chains[0].copy()
    for w in range(1, 8):
        out += chains[w]
    return out


def segment_sum_f64(gid, vals, g):
    """(the f64 sums of the f32 values, the f64 sums of their magnitudes)
    per (group, column)."""
    key = np.clip(np.asarray(gid, np.int64), 0, g)
    v = np.asarray(vals, np.float64)
    s = np.zeros((g + 1, v.shape[1]))
    a = np.zeros((g + 1, v.shape[1]))
    np.add.at(s, key, v)
    np.add.at(a, key, np.abs(v))
    return s[:g], a[:g]


def segment_cases(seed=5):
    """(name, gid, vals, G, block): mixed signs, dead rows, clamped ids,
    ragged CTAs, few and many groups, small and wide M."""
    rng = np.random.default_rng(seed)
    cases = []
    n = 8192
    gid8 = rng.integers(0, 9, n).astype(np.int32)
    cases.append(("g8_m4_block8", gid8,
                  (rng.standard_normal((n, 4)) * 1e3).astype(np.float32), 8, 8))
    gid3 = rng.integers(0, 3, 10_000).astype(np.int32)
    gid3[-37:] = 3  # dead tail
    cases.append(("g3_m1_ragged_ctas", gid3,
                  (rng.integers(0, 11, (10_000, 1)) / 100).astype(np.float32),
                  3, 8))
    g1k = rng.integers(0, 1025, 20_480).astype(np.int32)
    cases.append(("g1024_m1", g1k,
                  (rng.random((20_480, 1)) * 50).astype(np.float32), 1024,
                  1024))
    wild = rng.integers(-5, 12, 3000).astype(np.int32)  # clamped into [0, 6]
    cases.append(("clamped_ids_m2", wild,
                  rng.standard_normal((3000, 2)).astype(np.float32), 6, 8))
    one = np.zeros(4096, np.int32)
    cases.append(("one_group", one,
                  rng.random((4096, 1)).astype(np.float32), 1, 512))
    dead = np.full(4096, 5, np.int32)
    dead[:7] = rng.integers(0, 5, 7)
    cases.append(("mostly_dead_rows", dead,
                  rng.random((4096, 3)).astype(np.float32), 5, 512))
    return cases


SEG_CASES = [c[0] for c in segment_cases()]


def _seg_case(name):
    return next(c for c in segment_cases() if c[0] == name)


def test_pairwise_order():
    x = np.array([1e8, 1, -1e8, 1, 3], np.float32)
    # ((1e8 + 1) + (-1e8 + 1)) + 3 in float32
    assert _pairwise_f32(x) == np.float32(
        (np.float32(1e8) + np.float32(1)) + (np.float32(-1e8) + np.float32(1))
    ) + np.float32(3)
    assert _pairwise_f32(np.ones((7, 2), np.float32)).tolist() == [7.0, 7.0]


@pytest.mark.parametrize("case", SEG_CASES)
def test_segment_order_model_within_f64_bound(case):
    _, gid, vals, g, block = _seg_case(case)
    got = segment_sum_order_model(gid, vals, g)
    want, mag = segment_sum_f64(gid, vals, g)
    assert got.shape == (g, vals.shape[1]) and got.dtype == np.float32
    assert (np.abs(got - want) <= SEG_REL * mag).all()


# --- the hash kernels' slices, and models of the partitioned build and probe ---


def hash_home(keys, table_size):
    """Home slots of int64 keys: splitmix64(key) & (T - 1)."""
    keys = torch.from_numpy(np.ascontiguousarray(keys, np.int64))
    return (mix64(keys) & (table_size - 1)).numpy()


def hash_table_errors(keys, tkey, trow):
    """What is wrong with a linear-probing table built over `keys` ([] if
    nothing): every live key exactly once, with its row, nothing else in
    the table; and the chain invariant — for every occupied slot s holding
    key k, every slot from home(k) to s, cyclically, is occupied."""
    keys, tkey = np.asarray(keys, np.int64), np.asarray(tkey, np.int64)
    trow = np.asarray(trow, np.int64)
    t = len(tkey)
    errors = []
    idx = np.nonzero(tkey != I64MAX)[0]
    live = keys != I64MAX
    if len(idx) != int(live.sum()):
        errors.append(f"{len(idx)} occupied slots for {int(live.sum())} keys")
    rows = trow[idx]
    if len(idx) and (rows.min() < 0 or rows.max() >= len(keys)
                     or len(np.unique(rows)) != len(rows)
                     or not (keys[rows] == tkey[idx]).all()):
        errors.append("a slot's row does not hold its key")
    if (trow[tkey == I64MAX] != -1).any():
        errors.append("an empty slot has a row")
    if len(idx) == 0:
        return errors
    # run of occupied slots ending at each occupied slot (cyclic)
    starts = np.ones(len(idx), bool)
    starts[1:] = idx[1:] != idx[:-1] + 1
    first = np.maximum.accumulate(np.where(starts, np.arange(len(idx)), 0))
    run = idx - idx[first] + 1
    if idx[0] == 0 and idx[-1] == t - 1:  # the run through T - 1 -> 0
        run[first == 0] += t - idx[first[-1]]
    disp = (idx - hash_home(tkey[idx], t)) % t
    if (disp >= run).any():
        errors.append(f"{int((disp >= run).sum())} keys break the chain "
                      "invariant")
    return errors


def hash_build_model(keys, table_size, seed):
    """The partitioned build of csrc/hash_table.cu, in numpy, over the
    slices of `hash_partition_layout`: each slice's keys are inserted in a
    seeded random order (the CTA's threads race for the shared-memory CAS),
    walking inside the slice; a key that runs off the slice's end is
    deferred; then the deferred keys, in another random order, walk the
    global table from the next slice's first slot, wrapping at T - 1 -> 0.
    Returns (table_key, table_row, number deferred)."""
    keys = np.asarray(keys, np.int64)
    lay = kernels.hash_partition_layout(table_size)
    s, mask = lay.slice_slots, table_size - 1
    rng = np.random.default_rng(seed)
    tkey = np.full(table_size, I64MAX, np.int64)
    trow = np.full(table_size, -1, np.int32)
    live = np.nonzero(keys != I64MAX)[0]
    home = hash_home(keys[live], table_size)
    part = home >> lay.slice_log2
    deferred = []
    for p in np.unique(part):
        for j in rng.permutation(np.nonzero(part == p)[0]):
            at = int(home[j]) & (s - 1)
            while at < s and tkey[p * s + at] != I64MAX:
                at += 1
            if at == s:
                deferred.append((int(p), int(live[j])))
            else:
                tkey[p * s + at], trow[p * s + at] = keys[live[j]], live[j]
    for i in rng.permutation(len(deferred)):
        p, r = deferred[i]
        at = ((p + 1) * s) & mask
        while tkey[at] != I64MAX:
            at = (at + 1) & mask
        tkey[at], trow[at] = keys[r], r
    return tkey, trow, len(deferred)


def hash_probe_model(tkey, trow, probe):
    """The partitioned probe of csrc/hash_table.cu, in numpy: each probe
    walks its slice's window in shared memory (the slice, then a halo
    of `hash_partition_layout(T).halo` slots past it, wrapping at T), and
    continues in the global table past the window. Returns (rows, number of
    probes whose chain left the window)."""
    tkey, trow = np.asarray(tkey, np.int64), np.asarray(trow, np.int32)
    probe = np.asarray(probe, np.int64)
    t = len(tkey)
    lay = kernels.hash_partition_layout(t, len(probe))
    s, mask = lay.slice_slots, t - 1
    first = (np.arange(lay.partitions, dtype=np.int64) * s)
    window = [tkey[(f + np.arange(s + lay.halo)) & mask] for f in first]
    out = np.full(len(probe), -1, np.int32)
    left = 0
    home = hash_home(probe, t)
    for i, k in enumerate(probe):
        if k == I64MAX:
            continue
        p = int(home[i]) >> lay.slice_log2
        at = int(home[i]) & (s - 1)
        win = window[p]
        while at < len(win) and win[at] != k and win[at] != I64MAX:
            at += 1
        if at < len(win):
            if win[at] == k:
                out[i] = trow[(first[p] + at) & mask]
            continue
        left += 1
        g = int(first[p] + len(win)) & mask
        while tkey[g] != k and tkey[g] != I64MAX:
            g = (g + 1) & mask
        if tkey[g] == k:
            out[i] = trow[g]
    return out, left


def _aimed_keys(table_size, slots, n, seed):
    """n distinct live keys whose home slot is one of `slots`."""
    rng = np.random.default_rng(seed)
    found = []
    while sum(len(f) for f in found) < n:
        cand = rng.integers(-(1 << 62), 1 << 62, 1 << 20, dtype=np.int64)
        found.append(cand[np.isin(hash_home(cand, table_size), slots)])
    return np.unique(np.concatenate(found))[:n]


def _fill(keys, n, rng):
    """`keys` plus random distinct keys, n in all."""
    extra = rng.integers(-(1 << 62), 1 << 62, 2 * n, dtype=np.int64)
    extra = np.setdiff1d(np.unique(extra), keys)[:n - len(keys)]
    return rng.permutation(np.concatenate([keys, extra]))


def hash_edge_cases(seed=13):
    """(name, keys, table size, probe) of the partitioned kernels' edges, at
    the slice size of `hash_partition_layout` at call time (the arrays are
    shared between calls: read only)."""
    return _hash_edge_cases(
        seed, kernels.hash_partition_layout(1 << 31).slice_slots)


@functools.lru_cache(maxsize=None)
def _hash_edge_cases(seed, s):
    rng = np.random.default_rng(seed)
    cases = []

    def probes(keys, t):
        live = keys[keys != I64MAX]
        miss = rng.integers(-(1 << 62), 1 << 62, max(64, len(live)),
                            dtype=np.int64)
        return np.concatenate([live[::-1], live + 1, miss, [I64MAX, 0, -1]])

    t = 4 * s  # the last slots of an inner slice, with the slice full
    aimed = _aimed_keys(t, [2 * s - 1, 2 * s - 2, 2 * s - 3], min(300, s // 2),
                        seed)
    keys = _fill(aimed, t // 2 - 7, rng)
    cases.append(("inner_slice_end", keys, t, probes(keys, t)))
    aimed = _aimed_keys(t, [t - 1, t - 2], min(200, s // 2), seed + 1)
    keys = _fill(aimed, t // 4, rng)
    cases.append(("table_end_wraps", keys, t, probes(keys, t)))
    for name, tt in (("t_below_slice", s // 2), ("t_equals_slice", s)):
        aimed = _aimed_keys(tt, [tt - 1], min(40, tt // 8), seed + 2)
        keys = _fill(aimed, tt // 2, rng)
        cases.append((name, keys, tt, probes(keys, tt)))
    keys = _fill(np.zeros(0, np.int64), 4 * s, rng)
    keys[rng.integers(0, len(keys), 50)] = I64MAX
    cases.append(("full_load_dead_rows", keys, 8 * s, probes(keys, 8 * s)))
    # one key in most probes: its slice's places run out, and the rest of
    # those probes walk directly
    keys = _fill(np.zeros(0, np.int64), s // 2, rng)
    cases.append(("skewed_probe", keys, 4 * s, np.concatenate([
        np.full(5 * s // 2, keys[7]), probes(keys, 4 * s)])))
    cases.append(("n0", np.zeros(0, np.int64), 2 * s,
                  rng.integers(-100, 100, 1000, dtype=np.int64)))
    cases.append(("all_sentinel_keys", np.full(100, I64MAX, np.int64), 256,
                  np.array([I64MAX, 0, 1, I64MAX - 1], np.int64)))
    keys = _fill(np.zeros(0, np.int64), 1000, rng)
    cases.append(("m0", keys, 2048, np.zeros(0, np.int64)))
    cases.append(("all_sentinel_probes", keys, 2048,
                  np.full(3000, I64MAX, np.int64)))
    return [(nm, np.ascontiguousarray(k, np.int64), tt,
             np.ascontiguousarray(p, np.int64)) for nm, k, tt, p in cases]


HASH_EDGE_CASES = [c[0] for c in hash_edge_cases()]
# slices small enough that every case spans many of them
SMALL_SLICES = {"HASH_SLICE": 64}


def use_slices(monkeypatch, slices: str):
    """The kernels' default slices, or ("small") SMALL_SLICES."""
    if slices == "small":
        for name, value in SMALL_SLICES.items():
            monkeypatch.setattr(kernels, name, value)


def hash_edge_case(name):
    return next(c for c in hash_edge_cases() if c[0] == name)


@pytest.mark.parametrize("t", [1, 2, 4, 16, 64, 4096, 8192, 16_384, 32_768,
                               1 << 17, 1 << 24, 1 << 25, 1 << 27, 1 << 28,
                               1 << 31])
def test_hash_partition_layout(t):
    lay = kernels.hash_partition_layout(t)
    s = lay.slice_slots
    assert s == min(t, kernels.HASH_SLICE)
    assert s & (s - 1) == 0 and s == 1 << lay.slice_log2
    assert lay.partitions * s == t
    # the CUDA code indexes slices with 32-bit unsigned ints
    assert lay.partitions < 1 << 32
    assert lay.build_smem == 12 * s
    w = s + lay.halo
    assert 12 * w <= lay.probe_smem < 12 * w + 16
    # one histogram bin per slice in shared memory while it fits (2^14)
    shared = 4 * lay.partitions <= kernels.HASH_HIST_SMEM
    assert lay.hist_smem == (4 * lay.partitions if shared else 0)
    assert shared == (t <= 1 << 27)
    # the build's scatter sorts tiles in shared memory: one pass up to 128
    # slices, two up to 2^14, global atomics beyond
    assert lay.build_passes == (
        0 if not shared else 1 if lay.partitions <= 128 else 2)
    assert lay.work_ints == 4 * lay.partitions + kernels.HASH_COARSE_BINS + 1
    for smem in (lay.build_smem, lay.probe_smem, lay.hist_smem,
                 lay.build_scatter_smem):
        assert 0 <= smem <= kernels.SMEM_MAX_BYTES
    if lay.partitions <= kernels.HASH_WIDE_BINS:
        assert lay.probe_scatter_smem <= kernels.SMEM_MAX_BYTES
    else:  # the probe's one scatter pass takes 2048 slices at most
        assert kernels.hash_partition_layout(t, 1 << 30).probe_route == "direct"


@pytest.mark.parametrize("t,passes", [(1 << 17, 1), (1 << 24, 2), (1 << 27, 2),
                                      (1 << 28, 0)])
def test_hash_build_scatter_passes(t, passes):
    """Q9's table (2^24 slots): 2048 slices, the build's keys scattered in
    two passes."""
    assert kernels.hash_partition_layout(t).build_passes == passes


@pytest.mark.parametrize("t", [1024, 1 << 20, 1 << 24, 1 << 25])
def test_hash_probe_route_moves_fewer_bytes(t):
    """Partitioned while its T * 12 + M * 44 bytes are fewer than the
    direct walk's M * (12 + HASH_RANDOM_BYTES), and the table has at most
    HASH_WIDE_BINS slices; a single switch point in M."""
    routes = []
    for m in np.unique(np.geomspace(1, 64 * t, 60).astype(np.int64)):
        lay = kernels.hash_partition_layout(t, int(m))
        direct = m * (12 + kernels.HASH_RANDOM_BYTES)
        fits = lay.partitions <= kernels.HASH_WIDE_BINS
        assert (lay.probe_route == "partitioned") == (
            fits and t * 12 + m * 44 < direct)
        routes.append(lay.probe_route)
    assert routes[0] == "direct"
    assert routes[-1] == ("partitioned" if t <= 1 << 24 else "direct")
    assert routes == sorted(routes)  # "direct" < "partitioned"


@pytest.mark.parametrize("t,m", [(1 << 24, 9_001_984), (1 << 24, 1),
                                 (1024, 3000), (1 << 17, 1 << 20)])
def test_hash_probe_cap(t, m):
    """A slice's places for the probe: 1/8 over an even share, and 64."""
    lay = kernels.hash_partition_layout(t, m)
    share = m / lay.partitions
    assert share * 1.125 + 64 <= lay.probe_cap < share * 1.125 + 66
    assert lay.partitions * lay.probe_cap < 1 << 31


def test_hash_probe_route_at_q9():
    """Q9's probes at SF 10 against 2^24 slots: M 9,001,984 take the
    partitioned route, M 2,483,200 the direct walk."""
    assert kernels.hash_partition_layout(
        1 << 24, 9_001_984).probe_route == "partitioned"
    assert kernels.hash_partition_layout(
        1 << 24, 2_483_200).probe_route == "direct"


def test_hash_table_errors_sees_a_broken_chain():
    """One chain of six keys homed at slot 60 of 64 fills 60..63, 0, 1
    (through T - 1 -> 0); a hole at 61 breaks it."""
    keys = _aimed_keys(64, [60], 6, 0)
    tk, tr = kernels.hash_build_plain(torch.from_numpy(keys), 64)
    tk, tr = tk.numpy(), tr.numpy()
    assert sorted(np.nonzero(tk != I64MAX)[0]) == [0, 1, 60, 61, 62, 63]
    assert hash_table_errors(keys, tk, tr) == []
    bk, br = tk.copy(), tr.copy()
    bk[2], br[2] = tk[61], tr[61]
    bk[61], br[61] = I64MAX, -1
    errors = hash_table_errors(keys, bk, br)
    assert len(errors) == 1 and "chain" in errors[0]
    bk, br = tk.copy(), tr.copy()
    bk[2], br[2] = tk[61], tr[61]  # a key twice
    assert hash_table_errors(keys, bk, br)
    br = tr.copy()
    br[60], br[61] = tr[61], tr[60]  # rows swapped
    assert hash_table_errors(keys, tk, br) == [
        "a slot's row does not hold its key"]


@pytest.mark.parametrize("slices", ["default", "small"])
@pytest.mark.parametrize("case", HASH_EDGE_CASES)
def test_hash_build_model(monkeypatch, slices, case):
    """The partitioned build, in three insertion orders: a valid table, and
    every probe answers as on the plain build's table."""
    use_slices(monkeypatch, slices)
    _, keys, t, probe = hash_edge_case(case)
    pk, pr = kernels.hash_build_plain(torch.from_numpy(keys), t)
    want = kernels.hash_probe_plain(pk, pr, torch.from_numpy(probe)).numpy()
    oracle = {int(k): i for i, k in enumerate(keys) if k != I64MAX}
    assert np.array_equal(want, [oracle.get(int(p), -1) for p in probe])
    for seed in range(3):
        tk, tr, deferred = hash_build_model(keys, t, seed)
        assert hash_table_errors(keys, tk, tr) == []
        got = kernels.hash_probe_plain(torch.from_numpy(tk),
                                       torch.from_numpy(tr),
                                       torch.from_numpy(probe)).numpy()
        assert np.array_equal(got, want)
        if case in ("inner_slice_end", "table_end_wraps"):
            assert deferred > 0  # chains really cross the slice's end


@pytest.mark.parametrize("halo", [kernels.HASH_HALO, 1])
@pytest.mark.parametrize("slices", ["default", "small"])
@pytest.mark.parametrize("case", HASH_EDGE_CASES)
def test_hash_probe_model(monkeypatch, halo, slices, case):
    """The partitioned probe, on the model build's table, with the default
    halo and with a halo of 1: equal to the plain probe."""
    use_slices(monkeypatch, slices)
    monkeypatch.setattr(kernels, "HASH_HALO", halo)
    _, keys, t, probe = hash_edge_case(case)
    tk, tr, _ = hash_build_model(keys, t, 0)
    got, left = hash_probe_model(tk, tr, probe)
    want = kernels.hash_probe_plain(torch.from_numpy(tk), torch.from_numpy(tr),
                                    torch.from_numpy(probe)).numpy()
    assert np.array_equal(got, want)
    if halo == 1 and case in ("inner_slice_end", "table_end_wraps"):
        assert left > 0  # chains leave the window for the global walk


# --- the top-N select's keys and its sorting network -------------------------

TOPN_LANE_BITS = 10
TOPN_MAX_SPAN = (1 << (64 - TOPN_LANE_BITS)) - 2  # csrc/topn_select.cu
TOPN_PREFIX_BITS = 32 - TOPN_LANE_BITS
TOPN_MAX_PASSES = 4


def topn_slot(e):
    """The kernel's `slot_of`: element e's 8-byte word in a warp's buffer,
    16-byte chunks XOR-swizzled within each 256-byte row."""
    e = np.asarray(e)
    row = e >> 5
    chunk = ((e & 31) >> 1) ^ (row & 15)
    return (row << 5) | (chunk << 1) | (e & 1)


def topn_keys_model(neg):
    """The kernel's keys of each block, [nb, 1024]: the 64-bit keys
    ((v - lo) << 10 | (1023 - lane)) + 1, the 32-bit keys (the top 22 bits
    of v - lo above the lane) and their shift, 0 for INT64_MIN rows; and
    the blocks too wide for 64-bit keys, and each block's live minimum."""
    x = np.asarray(neg, np.int64).reshape(-1, 1024)
    live = x != I64MIN
    lo = np.where(live, x, np.iinfo(np.int64).max).min(axis=1)
    hi = np.where(live, x, I64MIN).max(axis=1)
    span = np.where(hi == I64MIN, np.uint64(0),
                    hi.astype(np.uint64) - lo.astype(np.uint64))
    pairs = np.nonzero(span > np.uint64(TOPN_MAX_SPAN))[0]
    lane = np.arange(1024, dtype=np.uint64)
    with np.errstate(over="ignore"):
        off = x.astype(np.uint64) - lo[:, None].astype(np.uint64)
        key64 = ((off << np.uint64(TOPN_LANE_BITS)) | (np.uint64(1023) - lane)
                 ) + np.uint64(1)
    top = (1 << TOPN_PREFIX_BITS) - 1
    shift = np.array([0 if int(sp) < top else int(sp).bit_length()
                      - TOPN_PREFIX_BITS for sp in span])
    shift += np.array([int(sp) >> int(sh) >= top
                       for sp, sh in zip(span, shift)])
    pre = off >> shift[:, None].astype(np.uint64)
    key32 = ((pre << np.uint64(TOPN_LANE_BITS)) | (np.uint64(1023) - lane)
             ) + np.uint64(1)
    zero = np.uint64(0)
    return (np.where(live, key64, zero), np.where(live, key32, zero), shift,
            pairs, lo)


def topn_network_model(key):
    """The kernel's bitonic schedule on [nb, 1024] keys, element e = 32 *
    lane + r: the mirror stage of each merge, then its strides, the larger
    key always to the lower position; strides under 32 inside a lane,
    larger ones between lanes lane ^ (stride / 32) (the shuffles)."""
    k = np.array(key, np.uint64).reshape(-1, 32, 32)  # [block, lane, r]
    lanes = np.arange(32)

    def in_lane(q_of):
        r = np.array([r for r in range(32) if r < q_of(r)])
        q = np.array([q_of(r) for r in r])
        a, b = k[:, :, r], k[:, :, q]
        k[:, :, r], k[:, :, q] = np.maximum(a, b), np.minimum(a, b)

    for ls in range(1, 6):
        in_lane(lambda r: r ^ ((1 << ls) - 1))
        for ss in range(ls - 2, -1, -1):
            in_lane(lambda r: r ^ (1 << ss))
    for ls in range(6, 11):
        mask = (1 << (ls - 5)) - 1
        lower = ((lanes & (1 << (ls - 6))) == 0)[None, :, None]
        other = k[:, lanes ^ mask, ::-1]  # (lane ^ mask, 31 - r)
        k[...] = np.where(lower, np.maximum(k, other), np.minimum(k, other))
        for ss in range(ls - 2, 4, -1):
            m = 1 << (ss - 5)
            lower = ((lanes & m) == 0)[None, :, None]
            other = k[:, lanes ^ m, :]
            k[...] = np.where(lower, np.maximum(k, other),
                              np.minimum(k, other))
        for ss in range(4, -1, -1):
            in_lane(lambda r: r ^ (1 << ss))
    return k.reshape(-1, 1024)


def topn_transposition_pass(key):
    """One odd-even transposition pass over a block's 1024 keys: pairs
    (2i, 2i + 1), then (2i + 1, 2i + 2), the larger first."""
    k = key.copy()
    for start in (0, 1):
        a, b = k[start:1023:2], k[start + 1::2]
        n = min(len(a), len(b))
        hi, lo = np.maximum(a[:n], b[:n]), np.minimum(a[:n], b[:n])
        k[start:start + 2 * n:2], k[start + 1:start + 2 * n:2] = hi, lo
    return k


def topn_sorted_model(neg):
    """Each block's 64-bit keys in the kernel's final order, and the blocks
    it sends on: to the 64-bit pass (prefix ties the transposition passes
    did not order) and to the pair kernel. The first pass sorts the 32-bit
    keys, reads each row's 64-bit key through its lane, and orders rows
    whose prefixes tie with up to TOPN_MAX_PASSES transposition passes."""
    key64, key32, shift, pairs, lo = topn_keys_model(neg)
    srt32 = topn_network_model(key32)
    lanes = (1023 - ((srt32 - np.uint64(1)) & np.uint64(1023))).astype(np.int64)
    out = np.where(srt32 == 0, np.uint64(0),
                   np.take_along_axis(key64, lanes, axis=1))
    wide = []
    for b in range(len(out)):
        if b in pairs or shift[b] == 0:
            continue
        passes = 0
        while (np.diff(out[b].astype(object)) > 0).any():
            if passes == TOPN_MAX_PASSES:
                wide.append(b)
                out[b] = topn_network_model(key64[b:b + 1])[0]
                break
            out[b] = topn_transposition_pass(out[b])
            passes += 1
    return out, np.array(wide, int), pairs, lo


def topn_select_model(neg, k):
    """The kernel's answer: the keys in the kernel's order, unpacked, the
    blocks for the pair kernel sorted as (value, lane) pairs."""
    x = np.asarray(neg, np.int64).reshape(-1, 1024)
    srt, wide, pairs, lo = topn_sorted_model(neg)
    srt = srt[:, :k]
    c = srt - np.uint64(1)
    dead = srt == 0
    vals = np.where(dead, I64MIN,
                    lo[:, None] + (c >> np.uint64(TOPN_LANE_BITS)).astype(
                        np.int64))
    lane = np.where(dead, 0, 1023 - (c & np.uint64(1023)).astype(np.int64))
    for b in pairs:  # a stable sort, and lane 0 for INT64_MIN
        order = np.argsort(-x[b].astype(object), kind="stable")[:k]
        vals[b] = x[b][order]
        lane[b] = np.where(x[b][order] == I64MIN, 0, order)
    base = (np.arange(len(x)) * 1024)[:, None]
    return (vals.reshape(-1), (base + lane).astype(np.int32).reshape(-1),
            wide, pairs)


def topn_edge_cases(seed=17, big=False):
    """(name, neg, k): k across the lane and warp sizes, block counts, ties
    that straddle a lane's, a block's and a CTA's rows, blocks of nothing
    but INT64_MIN, INT64_MIN runs inside blocks, live spans too wide for
    the one-word key; with `big`, block counts of 4096 and N > 2^24 (for
    the card)."""
    rng = np.random.default_rng(seed)
    cases = []
    for k in (1, 31, 32, 33, 100, 255, 256, 257, 1000, 1024):
        x = rng.integers(0, 1 << 52, 3 * 1024)
        x[rng.integers(0, len(x), 500)] = x[7]  # some ties
        cases.append((f"k{k}", ~x, k))
    counts = (1, 2, 3, 264, 265) + ((4096,) if big else ())
    for nb in counts:
        cases.append((f"blocks{nb}", rng.integers(-(1 << 40), 1 << 40,
                                                  nb * 1024), 1024))
    if big:
        n = (1 << 24) + 1024
        cases.append(("n_over_2_24", rng.integers(-(1 << 52), 0, n), 1024))
    x = rng.integers(0, 1 << 20, 8 * 1024)
    for start, ln in ((20, 40), (1000, 60), (4090, 20), (5000, 300)):
        x[start:start + ln] = 12345  # across a lane, a block, 4 blocks
    x[2048:3072] = 999  # one block all tied
    cases.append(("ties_straddle", x, 1024))
    x = rng.integers(-1000, 1000, 6 * 1024)
    x[1024:2048] = I64MIN          # a block of dead-row codes only
    x[3000:3100] = I64MIN          # a run inside a block
    x[4096 + 31:4096 + 97] = I64MIN  # across lanes
    x[5120:5120 + 1023] = I64MIN   # one live row, the block's last
    cases.append(("int64_min_runs", x, 1024))
    cases.append(("int64_min_runs_k100", x, 100))
    x = rng.integers(-5, 5, 4 * 1024)
    x[1024:2048] = I64MAX - rng.integers(0, 5, 1024)  # near INT64_MAX
    x[rng.integers(0, len(x), 600)] = I64MIN
    x[1024 + rng.integers(0, 1024, 50)] = I64MAX
    x[2048 + 5] = I64MIN + 1       # span 2^64 - 2: the pair kernel
    x[3072:] = rng.integers(-(1 << 62), 1 << 62, 1024)
    cases.append(("wide_spans", x, 333))
    # rows whose 32-bit keys tie on the prefix, the larger value at the
    # later row: the transposition passes order them
    x = rng.integers(0, 1 << 40, 4 * 1024)
    for i in rng.integers(0, 4 * 1024 - 600, 300):
        x[i + 1 + (i % 500)] = x[i] + 1 + (i % 3)
    x[5:9] = x[4] + np.arange(4, 0, -1)  # a run of 5: four ordered
    x[900:905] = x[899] + np.arange(1, 6)  # a run of 6, backwards
    cases.append(("prefix_ties", x, 1024))
    # 900 rows within 100 of each other and one far away: more prefix ties
    # than the passes order, so the block takes the 64-bit pass
    x = rng.integers(0, 100, 2 * 1024)
    x[1024 + 77] = 1 << 50
    x[1024:1024 + 30] = I64MIN
    cases.append(("prefix_cluster", x, 1024))
    x = rng.integers(0, 1 << 20, 2 * 1024)
    x[0], x[1] = 0, TOPN_MAX_SPAN       # span at the 64-bit key's limit
    x[1024], x[1025] = 0, TOPN_MAX_SPAN + 1  # one past it: listed
    cases.append(("span_limit", x, 1024))
    cases.append(("all_equal", np.full(2 * 1024, 42), 1024))
    return [(nm, np.asarray(x, np.int64), k) for nm, x, k in cases]


TOPN_EDGE_CASES = [c[0] for c in topn_edge_cases()]


def topn_edge_case(name, big=False):
    return next(c for c in topn_edge_cases(big=big) if c[0] == name)


def test_topn_slots_are_a_bijection_without_bank_conflicts():
    e = np.arange(1024)
    assert sorted(topn_slot(e)) == list(range(1024))
    # a blocked read: lane L reads elements 32 L + r, r + 1 (16 B); every
    # 8 lanes (one phase of a 16-byte access) hit 8 distinct 4-bank groups
    for r in range(0, 32, 2):
        banks = (topn_slot(32 * np.arange(32) + r) * 2 // 4) % 8
        for q in range(4):
            assert len(set(banks[8 * q:8 * q + 8])) == 8
    # a striped read: lanes read elements 32 i + lane, one 256-byte row
    for i in range(32):
        words = topn_slot(32 * i + np.arange(32)) * 2
        assert sorted(words % 64) == list(range(0, 64, 2))


def test_topn_key_widths():
    """The largest 64-bit key (span TOPN_MAX_SPAN, lane 0) and the largest
    32-bit key fit their words; the 32-bit key's prefix is exact up to a
    span of 2^22 - 2 and drops bits above it."""
    assert ((TOPN_MAX_SPAN << TOPN_LANE_BITS) | 1023) + 1 < 1 << 64
    for span, shift in ((0, 0), ((1 << 22) - 2, 0), ((1 << 22) - 1, 1),
                        (1 << 22, 1), ((1 << 40) + 5, 19),
                        (TOPN_MAX_SPAN, 33)):
        x = np.full(1024, I64MIN, np.int64)
        x[0], x[1] = 7, 7 + span
        key64, key32, sh, pairs, _ = topn_keys_model(x)
        assert sh[0] == shift and len(pairs) == 0, span
        assert int(key32.max()) < 1 << 32 and int(key64.max()) < 1 << 64


def test_topn_network_model_sorts():
    rng = np.random.default_rng(1)
    key = rng.integers(0, 1 << 62, (5, 1024)).astype(np.uint64)
    key[1, :500] = key[1, 0]  # equal keys
    key[2] = 0
    got = topn_network_model(key)
    assert (got == -np.sort(-key.astype(object), axis=1)).all()


def test_topn_keys_order_as_value_then_lane():
    _, x, _ = topn_edge_case("ties_straddle")
    key, _, _, pairs, _ = topn_keys_model(x)
    assert len(pairs) == 0
    for b in range(len(key)):
        blk = x[b * 1024:(b + 1) * 1024]
        order = np.argsort(-blk, kind="stable")
        assert (np.argsort(-key[b].astype(object), kind="stable")
                == order).all()


@pytest.mark.parametrize("case", TOPN_EDGE_CASES)
def test_topn_select_model_equals_plain(case):
    _, x, k = topn_edge_case(case)
    v, i, wide, pairs = topn_select_model(x, k)
    pv, pi = kernels.topn_select_plain(torch.from_numpy(x), k)
    assert (v == pv.numpy()).all()
    assert (i == pi.numpy()).all()
    assert list(pairs) == {"wide_spans": [2, 3],
                           "span_limit": [1]}.get(case, [])
    assert list(wide) == {"prefix_cluster": [1],
                          "span_limit": [0]}.get(case, [])


def test_topn_prefix_ties_need_the_transposition_passes():
    """In prefix_ties the 32-bit keys leave rows out of order in every
    block (the passes order them); a run of 6 rows needs 3 passes."""
    _, x, _ = topn_edge_case("prefix_ties")
    key64, key32, shift, _, _ = topn_keys_model(x)
    srt32 = topn_network_model(key32)
    lanes = (1023 - ((srt32 - np.uint64(1)) & np.uint64(1023))).astype(int)
    first = np.take_along_axis(key64, lanes, axis=1)
    assert all((np.diff(b.astype(object)) > 0).any() for b in first)
    want = -np.sort(-key64.astype(object), axis=1)
    b = first[0]
    for passes in range(1, TOPN_MAX_PASSES + 1):
        b = topn_transposition_pass(b)
        if (b == want[0]).all():
            break
    assert 3 <= passes <= TOPN_MAX_PASSES
