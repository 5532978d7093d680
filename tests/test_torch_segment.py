"""The port's segment reductions and its segment-sum kernel against the JAX
package's, on the same numpy inputs, on the CPU.

- kernels.segment_sum_plain (what the CUDA kernel is held to on the card)
  against segment_sum_pallas run with interpret=True: f32 sums to a
  relative 1e-6 — both add the block partials in block order, and differ
  only in the order of the additions inside a block;
- seg_sum / seg_count / seg_min / seg_max under `segment_strategy` mxu and
  pallas (and auto) against the JAX package's, through every strategy the
  dispatch can pick (one-hot limb matmul, broadcast-reduce, sorted prefix
  differences, segmented scans, the kernel, the scatters): integers and
  min/max exactly, float64 sums to a relative 1e-12, f32 kernel sums 1e-6;
- the slabs that bound the port's one-hot and broadcast temporaries do not
  change a result;
- the variance and covariance aggregates through hash_aggregate, on the
  low-cardinality and the sort path, with NULLs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import starrocks_tpu.ops as jops
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.exprs import ir as jir
from starrocks_tpu.ops import pallas_kernels as pk
from starrocks_tpu.ops import segment as jseg
from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu import types as JT

import starrocks_tpu_torch.ops as tops
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.exprs import ir as tir
from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.ops import segment as tseg
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch import types as TT

I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_strategy():
    for cfg in (jcfg, tcfg):
        cfg.set("segment_strategy", "auto")
    yield
    for cfg in (jcfg, tcfg):
        cfg.set("segment_strategy", "auto")


def _strategy(s):
    jcfg.set("segment_strategy", s)
    tcfg.set("segment_strategy", s)


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())


# --- the kernel's plain version vs the Pallas kernel --------------------------


@pytest.mark.parametrize("g,m,block,nb", [(8, 4, 8, 6), (8, 4, 256, 3),
                                          (8, 4, 2048, 2), (1024, 1, 1024, 4),
                                          (1024, 1, 2048, 2), (3, 2, 64, 5)])
def test_segment_sum_plain_matches_pallas(g, m, block, nb):
    rng = np.random.default_rng(block + g)
    n = block * nb
    gid = rng.integers(0, g + 1, n).astype(np.int32)  # id g: dead rows
    gid[: n // 7] = g
    vals = (rng.random((n, m)) * 100).astype(np.float32)
    want = np.asarray(pk.segment_sum_pallas(jnp.asarray(gid), jnp.asarray(vals),
                                            g, block=block, interpret=True))
    kernels.reset_counts()
    got = kernels.segment_sum(torch.from_numpy(gid), torch.from_numpy(vals),
                              g, block)
    assert kernels.counts()["segment_sum"] == {"calls": 1, "launches": 0}
    assert got.shape == (g, m) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= 1e-6


def test_segment_sum_rejects_what_the_kernel_cannot_take():
    gid = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.segment_sum(gid, torch.zeros((1024, 64)), 1024, 1024)
    with pytest.raises(ValueError, match="multiple"):
        kernels.segment_sum(gid, torch.zeros((1024, 1)), 8, 1000)
    with pytest.raises(TypeError):
        kernels.segment_sum(gid, torch.zeros((1024, 1), dtype=torch.float64),
                            8, 1024)
    with pytest.raises(TypeError):
        kernels.segment_sum(gid.to(torch.int64), torch.zeros((1024, 1)), 8, 1024)


# --- segment strategies vs the reference ---------------------------------------


def _both(fn_name, vals, gid, g, **kw):
    j = getattr(jseg, fn_name)(jnp.asarray(vals), jnp.asarray(gid), g, **kw)
    t = getattr(tseg, fn_name)(torch.from_numpy(np.asarray(vals)),
                               torch.from_numpy(np.asarray(gid)), g, **kw)
    return np.asarray(j), t.numpy()


def _gids(rng, n, g, sorted_gid):
    gid = rng.integers(0, g, n).astype(np.int32)
    gid[rng.random(n) < 0.05] = g  # dead rows past the last group
    if sorted_gid:
        gid = np.sort(gid)
    return gid


# (rows, groups, sorted): the shapes steer the dispatch — rows with a
# power-of-two factor >= 512 and groups <= 1024 take the limb matmul,
# fewer groups than 65 the broadcast, sorted rows the prefix tricks
INT_SHAPES = [(4096, 7, False), (4096, 1024, True), (3000, 40, True),
              (3000, 40, False), (2048, 3000, True), (6144, 1, False)]


@pytest.mark.parametrize("strategy", ["auto", "mxu", "pallas"])
@pytest.mark.parametrize("n,g,sorted_gid", INT_SHAPES)
def test_int_sums_and_counts_exact(strategy, n, g, sorted_gid):
    _strategy(strategy)
    rng = np.random.default_rng(n + g)
    gid = _gids(rng, n, g, sorted_gid)
    vals = rng.integers(I64MIN, I64MAX, n, dtype=np.int64)  # wraps mod 2^64
    vals[:5] = [I64MIN, I64MAX, -1, 0, 1]
    j, t = _both("seg_sum", vals, gid, g, sorted_gid=sorted_gid)
    assert np.array_equal(j, t)
    small = rng.integers(-1000, 1000, n).astype(np.int64)
    j, t = _both("seg_sum", small, gid, g, sorted_gid=sorted_gid)
    assert np.array_equal(j, t)
    live = rng.random(n) < 0.7
    j, t = _both("seg_count", live, gid, g, sorted_gid=sorted_gid)
    assert np.array_equal(j, t)


@pytest.mark.parametrize("strategy", ["auto", "mxu"])
@pytest.mark.parametrize("n,g,sorted_gid", [(4096, 7, False), (4096, 300, True),
                                            (3000, 300, False),
                                            (2048, 3000, True)])
def test_float64_sums(strategy, n, g, sorted_gid):
    _strategy(strategy)
    rng = np.random.default_rng(n * g)
    gid = _gids(rng, n, g, sorted_gid)
    vals = rng.standard_normal(n) * 1e3
    j, t = _both("seg_sum", vals, gid, g, sorted_gid=sorted_gid)
    assert t.dtype == np.float64
    assert np.allclose(t, j, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n,g", [(4096, 7), (4096, 1024), (2048, 100)])
def test_float_sums_through_the_kernel(n, g):
    """Under pallas, float sums over <= 1024 groups take the segment-sum
    kernel (f32 blocks) in both packages."""
    _strategy("pallas")
    rng = np.random.default_rng(g)
    gid = _gids(rng, n, g, False)
    vals = rng.random(n) * 10
    kernels.reset_counts()
    j, t = _both("seg_sum", vals, gid, g)
    assert kernels.counts()["segment_sum"]["calls"] == 1
    assert t.dtype == np.float64
    nz = j != 0
    assert np.array_equal(nz, t != 0)
    assert _rel_err(t[nz], j[nz]) <= 1e-6


@pytest.mark.parametrize("strategy", ["auto", "mxu", "pallas"])
@pytest.mark.parametrize("dtype", ["int64", "int32", "float64"])
@pytest.mark.parametrize("n,g,sorted_gid", [(4096, 7, False), (4096, 300, True),
                                            (3000, 300, False), (1, 5, True)])
def test_min_max_exact(strategy, dtype, n, g, sorted_gid):
    _strategy(strategy)
    rng = np.random.default_rng(n + g + len(dtype))
    gid = _gids(rng, n, g, sorted_gid)
    if dtype == "float64":
        vals = rng.standard_normal(n)
        lo, hi = np.inf, -np.inf
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, n).astype(dtype)
        lo, hi = info.max, info.min
    j, t = _both("seg_min", vals, gid, g, identity=lo, sorted_gid=sorted_gid)
    assert np.array_equal(j, t)
    j, t = _both("seg_max", vals, gid, g, identity=hi, sorted_gid=sorted_gid)
    assert np.array_equal(j, t)


def test_native_strategy_still_raises():
    """`native` no longer raises: it selects the executor's host filter-sum
    lane, and every segment reduction runs as under `scatter` (the
    reference's `_use_mxu` is False there); the sums and extremes equal
    the JAX package's under `scatter`."""
    rng = np.random.default_rng(5)
    n, g = 4096, 37
    gid = _gids(rng, n, g, False)
    vals = rng.integers(-10 ** 12, 10 ** 12, n)
    tcfg.set("segment_strategy", "native")
    try:
        assert not tseg._use_mxu()
        out = {fn: getattr(tseg, fn)(torch.from_numpy(vals),
                                     torch.from_numpy(gid), g, **kw).numpy()
               for fn, kw in (("seg_sum", {}),
                              ("seg_min", {"identity": I64MAX}),
                              ("seg_max", {"identity": I64MIN}))}
    finally:
        tcfg.set("segment_strategy", "auto")
    for fn, kw in (("seg_sum", {}), ("seg_min", {"identity": I64MAX}),
                   ("seg_max", {"identity": I64MIN})):
        j, _ = _both(fn, vals, gid, g, **kw)
        assert np.array_equal(j, out[fn]), fn


def test_small_slabs_give_the_same_results(monkeypatch):
    """The one-hot and broadcast operands are built a slab at a time; a
    slab of one block (or a few rows) changes no integer or min/max
    result, and float sums only by rounding (the products group their
    additions per slab)."""
    rng = np.random.default_rng(3)
    n, g = 1 << 14, 1000
    gid = torch.from_numpy(rng.integers(0, g + 1, n).astype(np.int32))
    ivals = torch.from_numpy(rng.integers(I64MIN, I64MAX, n, dtype=np.int64))
    fvals = torch.from_numpy((rng.random((n, 1)) * 7).astype(np.float32))
    g40 = torch.from_numpy(rng.integers(0, 41, n).astype(np.int32))
    dvals = torch.from_numpy(rng.standard_normal(n))

    def run():
        return (tseg._seg_sum_int_matmul(ivals, gid, g, 64),
                tseg._seg_minmax_bcast(dvals, g40, 40, True, float("inf")),
                tseg._seg_minmax_bcast(ivals, g40, 40, False, I64MIN),
                kernels.segment_sum_plain(gid, fvals, g, 1024),
                tseg._seg_sum_float_bcast(dvals, g40, 40))

    whole = run()
    one_block = 1024 * (g + 1) * 4
    monkeypatch.setattr(tseg, "SLAB_BYTES", one_block)
    monkeypatch.setattr(kernels, "SLAB_BYTES", one_block)
    assert tseg._slab_rows(n, (g + 1) * 4, 1024) == 1024
    assert tseg._slab_rows(n, 40 * 8) == one_block // 320
    sliced = run()
    for a, b in zip(whole[:3], sliced[:3]):
        assert torch.equal(a, b)
    assert _rel_err(sliced[3].numpy(), whole[3].numpy()) <= 1e-6
    assert torch.allclose(sliced[4], whole[4], rtol=1e-12, atol=1e-12)


# --- the moment aggregates through hash_aggregate ------------------------------


def _stat_chunks(lowcard: bool):
    rng = np.random.default_rng(21 if lowcard else 22)
    n = 3000
    # the columns track each other, as TPC-H's l_extendedprice tracks
    # l_quantity: a covariance near 0 would be a difference of large f32
    # sums under `pallas`, whose rounding it would magnify without bound
    xs = rng.integers(1, 5000, n) / 100.0
    x = [None if m else float(v) for m, v in zip(rng.random(n) < 0.08, xs)]
    y = [None if m else float(v) for m, v in
         zip(rng.random(n) < 0.05, 30 * xs + rng.standard_normal(n) * 40)]
    q = np.maximum(np.rint(xs).astype(np.int64) + rng.integers(-3, 4, n),
                   1).tolist()
    if lowcard:
        k = [f"k{v}" for v in rng.integers(0, 5, n)]
    else:
        k = rng.integers(0, 400, n).tolist()
    k[7] = None
    data = {"k": k, "x": x, "y": y, "q": q}
    jt = {"x": JT.DECIMAL(12, 2), "q": JT.BIGINT}
    tt = {"x": TT.DECIMAL(12, 2), "q": TT.BIGINT}
    return (JHostTable.from_pydict(data, jt).to_chunk(),
            THostTable.from_pydict(data, tt).to_chunk(device="cpu"))


STAT_AGGS = [("vs", "var_samp", "x", None), ("vp", "var_pop", "y", None),
             ("ss", "stddev_samp", "q", None), ("sp", "stddev_pop", "x", None),
             ("cs", "covar_samp", "x", "y"), ("cp", "covar_pop", "q", "y"),
             ("cr", "corr", "x", "y"), ("c", "count", None, None)]


# under pallas both packages sum f32 row blocks, each in its own order
# inside a block, and var = (sum x^2 - (sum x)^2 / n) / (n - 1) magnifies
# the difference by mean^2 / var. The low-cardinality path (S1/S2's) has 5
# big groups: measured 4e-6 apart. The sort path puts each group's ~7 rows
# (values up to 50, variance ~4) in one block: the two orders of those 7
# f32 additions may differ by 7 ulp of sum x^2 (~8750), 2e-3 of a variance
# of ~4, a relative 5e-4 at worst (measured 1.9e-5)
PALLAS_REL = {True: 1e-5, False: 1e-3}


@pytest.mark.parametrize("strategy", ["auto", "mxu", "pallas"])
@pytest.mark.parametrize("lowcard", [True, False])
def test_moment_aggregates_match_jax(strategy, lowcard):
    """float64 moments under auto (the same operations in the same order)
    and mxu (broadcast sums and segmented scans, in another order); f32
    block sums under pallas (PALLAS_REL)."""
    rel = {"auto": 1e-12, "mxu": 1e-9, "pallas": PALLAS_REL[lowcard]}[strategy]
    _strategy(strategy)
    jc, tc = _stat_chunks(lowcard)

    def aggs(ir):
        out = []
        for name, fn, a, b in STAT_AGGS:
            if fn == "count":
                out.append((name, ir.AggExpr("count", None)))
            elif b is None:
                out.append((name, ir.AggExpr(fn, ir.Col(a))))
            else:
                out.append((name, ir.AggExpr(fn, ir.Col(a), False,
                                             (ir.Col(b),))))
        return tuple(out)

    cap = 1024 if lowcard else 512
    jout, jn = jops.hash_aggregate(jc, (("k", jir.Col("k")),), aggs(jir), cap)
    tout, tn = tops.hash_aggregate(tc, (("k", tir.Col("k")),), aggs(tir), cap)
    assert int(tn) == int(jn)
    want = JHostTable.from_chunk(jout).to_pylist()
    got = THostTable.from_chunk(tout).to_pylist()
    assert len(got) == len(want)
    for gr, wr in zip(got, want):
        for a, b in zip(gr, wr):
            if isinstance(b, float):
                assert a is not None and abs(a - b) <= rel * max(abs(b), 1e-9), \
                    (gr, wr)
            else:
                assert a == b, (gr, wr)
