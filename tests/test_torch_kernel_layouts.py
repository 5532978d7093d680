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
