"""The host-side layouts of the port's two redesigned CUDA kernels, and
numpy models of what the kernels do with them, on the CPU.

The CUDA code (starrocks_tpu_torch/csrc/probe_searchsorted.cu and
segment_sum.cu) cannot run here; what it mirrors can:

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
  card's kernels to these same models bit for bit.

JAX-free: the file imports only the port, torch and numpy.
"""

import numpy as np
import pytest
import torch

from starrocks_tpu_torch.ops import kernels

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
