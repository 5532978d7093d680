"""Two-phase (PARTIAL/FINAL) aggregation of the PyTorch port
(starrocks_tpu_torch/ops/aggregate.py) against COMPLETE and against the
JAX package's PARTIAL states.

The spill executors and the query cache's partial tier split an
aggregation in two: each batch aggregates PARTIAL (avg -> sum + count, the
moment families -> their power/product sums + count), the states
concatenate, and a FINAL aggregation merges them. Held here, over split
batches with NULLs, dead rows (a filter) and an empty batch:

- PARTIAL then FINAL equals COMPLETE for every aggregate `decomposable`
  admits: exact for integers and decimals, floats to 6 significant digits
  (another order of addition), under `segment_strategy` auto and pallas
  (the segment-sum kernel's plain version on the CPU: f32 block sums, held
  at STAT_KERNEL_REL);
- each batch's PARTIAL state rows equal the JAX package's, and the FINAL
  rows too, with the same number of segment_sum calls (the JAX operators
  run eagerly here, so its counter counts calls, not traces);
- `decomposable` and the state fields answer as the reference's do.
"""

import decimal
import math

import numpy as np
import pytest
import torch

import starrocks_tpu.ops as jops
from starrocks_tpu import types as JT
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.exprs.ir import AggExpr, Col
from starrocks_tpu.ops import aggregate as jagg
from starrocks_tpu.ops.setops import concat_many as j_concat_many

import starrocks_tpu_torch.ops as tops
from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.column.column import pad_capacity
from starrocks_tpu_torch.exprs import ir as tir
from starrocks_tpu_torch.ops import aggregate as tagg
from starrocks_tpu_torch.ops.setops import concat_many as t_concat_many
from starrocks_tpu_torch.runtime.config import config as tcfg

from torch_tpch_parity import STAT_KERNEL_REL, reset_knobs

N = 5000
# batch bounds: the second batch is empty
BATCHES = ((0, 2500), (2500, 2500), (2500, N))
PALLAS_BATCHES = ((0, 1000), (1000, 1000), (1000, 2000))
GROUPS = {
    "global": (),
    "g": (("g", "g"),),                 # dictionary key: the packed-gid path
    "g_h": (("g", "g"), ("h", "h")),    # an unbounded int key: the sort path
}
CAP = 512

AGGS = (
    ("c", ("count_star", None)),
    ("ci", ("count", "i")),
    ("si", ("sum", "i")),
    ("sd", ("sum", "d")),
    ("sx", ("sum", "x")),
    ("sb", ("sum", "big")),
    ("mni", ("min", "i")),
    ("mxx", ("max", "x")),
    ("mnd", ("min", "d")),
    ("mxg", ("max", "g")),
    ("mxb", ("max", "big")),
    ("ai", ("avg", "i")),
    ("ad", ("avg", "d")),
    ("ax", ("avg", "x")),
    ("vp", ("var_pop", "x")),
    ("vs", ("var_samp", "i")),
    ("sp", ("stddev_pop", "d")),
    ("ss", ("stddev_samp", "x")),
    ("cp", ("covar_pop", "x", "y")),
    ("cs", ("covar_samp", "y", "x")),
    ("co", ("corr", "x", "y")),
)
# the float sums under `pallas`: the JAX kernel runs in interpret mode, so
# its side holds a few aggregates only
PALLAS_AGGS = ("sx", "ax", "vp", "co")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


def _data():
    rng = np.random.default_rng(21)
    nul = lambda p: rng.random(N) < p  # noqa: E731
    gn, inl, xn = nul(0.05), nul(0.1), nul(0.08)
    xv = rng.random(N) * 100 - 20
    return {
        "g": [None if m else f"g{v}" for m, v in
              zip(gn, rng.integers(0, 7, N))],
        "h": rng.integers(0, 40, N).tolist(),
        "i": [None if m else int(v) for m, v in
              zip(inl, rng.integers(-500, 500, N))],
        "d": [decimal.Decimal(int(v)).scaleb(-2)
              for v in rng.integers(-10**6, 10**6, N)],
        "x": [None if m else float(v) for m, v in zip(xn, xv)],
        # correlated with x: the covariances' f32 moment sums do not
        # cancel down to their rounding error
        "y": (0.5 * xv + rng.random(N) * 3).tolist(),
        "big": [int(v) * 10**20 + int(w) for v, w in
                zip(rng.integers(-10**6, 10**6, N),
                    rng.integers(0, 10**9, N))],
        "keep": (rng.random(N) > 0.15).tolist(),  # the filter's dead rows
    }


def _types(M):
    return {"d": M.DECIMAL(12, 2), "big": M.DECIMAL(38, 0)}


def _aggs(ir, names=None):
    out = []
    for name, (fn, *args) in AGGS:
        if names is not None and name not in names:
            continue
        arg = None if args[0] is None else ir.Col(args[0])
        extra = tuple(ir.Col(a) for a in args[1:])
        out.append((name, ir.AggExpr(fn, arg, False, extra)))
    return tuple(out)


def _group(ir, key):
    return tuple((n, ir.Col(c)) for n, c in GROUPS[key])


@pytest.fixture(scope="module")
def tables():
    data = _data()
    return (JHostTable.from_pydict(data, _types(JT)),
            THostTable.from_pydict(data, _types(TT)))


def _slice(HT, ht, lo, hi):
    return HT(ht.schema, {k: a[lo:hi] for k, a in ht.arrays.items()},
              {k: v[lo:hi] for k, v in ht.valids.items()})


def _cap(bounds):
    """One capacity for every batch (the JAX operators run eagerly: one
    shape compiles each primitive once)."""
    return pad_capacity(max(hi - lo for lo, hi in bounds))


def _port_batches(tht, bounds=BATCHES):
    out = []
    for lo, hi in bounds:
        c = _slice(THostTable, tht, lo, hi).to_chunk(capacity=_cap(bounds),
                                                     device="cpu")
        out.append(tops.filter_chunk(c, tir.Col("keep")))
    return out


def _jax_batches(jht, bounds=BATCHES):
    out = []
    for lo, hi in bounds:
        c = _slice(JHostTable, jht, lo, hi).to_chunk(capacity=_cap(bounds))
        out.append(jops.filter_chunk(c, Col("keep")))
    return out


def _two_phase(ops, concat, batches, group, aggs, mod):
    """(PARTIAL states per batch, FINAL chunk) of one aggregation."""
    states = [ops.hash_aggregate(b, group, aggs, CAP, mode=mod.PARTIAL)[0]
              for b in batches]
    fgroup = tuple((n, type(e)(n)) for n, e in group)
    out, _ = ops.hash_aggregate(concat(states), fgroup,
                                mod.final_agg_exprs(aggs), CAP,
                                mode=mod.FINAL)
    return states, out


def _rows(HT, chunk):
    return sorted(HT.from_chunk(chunk).to_pylist(),
                  key=lambda r: tuple((v is None, str(v)) for v in r))


def _close(a, b, rel):
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not (x == y or math.isclose(x, y, rel_tol=rel,
                                               abs_tol=1e-9)):
                    return False
            elif x != y:
                return False
    return True


@pytest.mark.parametrize("strategy", ["auto", "pallas"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_partial_then_final_equals_complete(tables, group, strategy):
    _, tht = tables
    tcfg.set("segment_strategy", strategy)
    batches = _port_batches(tht)
    g, aggs = _group(tir, group), _aggs(tir)
    whole = tops.filter_chunk(tht.to_chunk(device="cpu"), tir.Col("keep"))
    want, _ = tops.hash_aggregate(whole, g, aggs, CAP)
    _, got = _two_phase(tops, t_concat_many, batches, g, aggs, tagg)
    rel = 1e-6 if strategy == "auto" else STAT_KERNEL_REL
    w, o = _rows(THostTable, want), _rows(THostTable, got)
    assert _close(o, w, rel), (o[:2], w[:2])
    names = [f.name for f in THostTable.from_chunk(got).schema]
    assert names == [n for n, _ in g] + [n for n, _ in aggs]


@pytest.fixture(scope="module")
def jax_states(tables):
    """The JAX package's PARTIAL states and FINAL rows under `auto`, for
    the packed-gid and the sort path, computed once per module (the global
    aggregation is held under `pallas` below)."""
    jht, _ = tables
    reset_knobs()
    batches = _jax_batches(jht)
    out = {}
    for key in JAX_GROUPS:
        states, final = _two_phase(jops, j_concat_many, batches,
                                   _group(jagg, key), _aggs(jagg), jagg)
        out[key] = ([_rows(JHostTable, s) for s in states],
                    _rows(JHostTable, final))
    return out


JAX_GROUPS = ("g", "g_h")


@pytest.mark.parametrize("group", JAX_GROUPS)
def test_partial_states_match_jax(tables, jax_states, group):
    _, tht = tables
    states, final = _two_phase(tops, t_concat_many, _port_batches(tht),
                               _group(tir, group), _aggs(tir), tagg)
    jstates, jfinal = jax_states[group]
    for s, js in zip(states, jstates):
        assert _close(_rows(THostTable, s), js, 1e-9)
    assert _close(_rows(THostTable, final), jfinal, 1e-9)
    # state column names and types are the reference's
    jnames = [(f.name, repr(f.type)) for f in JHostTable.from_chunk(
        jops.hash_aggregate(_jax_batches(tables[0])[0], _group(jagg, group),
                            _aggs(jagg), CAP, mode=jagg.PARTIAL)[0]).schema]
    tnames = [(f.name, repr(f.type)) for f in
              THostTable.from_chunk(states[0]).schema]
    assert tnames == jnames


ALL_FNS = sorted(
    {"count", "count_star", "sum", "min", "max", "avg", "group_concat"}
    | jagg._VAR_FNS | jagg._COVAR_FNS | jagg._HOLISTIC_FNS)


@pytest.mark.parametrize("fn", ALL_FNS)
def test_decomposable_matches_the_reference(fn):
    assert tagg.decomposable(((fn, tir.AggExpr(fn, None)),)) == \
        jagg.decomposable(((fn, AggExpr(fn, None)),))
    if fn in jagg._HOLISTIC_FNS or fn == "group_concat":
        return
    for jt, tt in ((JT.DOUBLE, TT.DOUBLE), (JT.DECIMAL(12, 2),
                                            TT.DECIMAL(12, 2)),
                   (JT.DECIMAL(38, 0), TT.DECIMAL(38, 0)),
                   (JT.INT, TT.INT)):
        want = [(n, repr(t)) for n, t in jagg._state_fields(
            "a", AggExpr(fn, None), jt)]
        got = [(n, repr(t)) for n, t in tagg._state_fields(
            "a", tir.AggExpr(fn, None), tt)]
        assert got == want
    want = repr(jagg.final_agg_exprs((("a", AggExpr(fn, Col("x"))),)))
    got = repr(tagg.final_agg_exprs((("a", tir.AggExpr(fn, tir.Col("x"))),)))
    assert got == want


@pytest.mark.parametrize("fn", ["percentile_cont", "approx_count_distinct"])
def test_holistic_aggregates_run_complete_only(tables, fn):
    _, tht = tables
    extra = (tir.Lit(0.5),) if fn == "percentile_cont" else ()
    aggs = (("p", tir.AggExpr(fn, tir.Col("x"), False, extra)),)
    with pytest.raises(NotImplementedError, match="cannot be split"):
        tops.hash_aggregate(_port_batches(tht)[0], (), aggs, CAP,
                            mode=tagg.PARTIAL)
