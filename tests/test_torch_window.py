"""The window operator of the PyTorch port (ops/window.py) against the JAX
package's, on the same inputs.

- `window_op` of both packages on one seeded chunk with NULLs and dead
  rows: row_number, rank, dense_rank; lead and lag with and without a
  default; first_value and last_value under the default frame and under
  explicit frames; ntile; count, sum, avg, min and max over the whole
  partition, running, and over explicit ROWS and RANGE frames (ASC and
  DESC, a decimal RANGE key); the in-window `limit_spec` mask and its
  counter. The output chunks (in the window's sorted order) must agree
  row for row: integers, decimals, strings and NULLs exactly, floats to a
  relative 1e-9 (the same float64 operations, added in another order).
- The top-N prefilter's two branches (`segment_strategy` auto: the strided
  selection ladder; `mxu`: the exact threshold) give the reference's keep
  mask of the same branch, and the same final rows.
- The reference's window SQL tests (tests/test_window.py,
  tests/test_window_frames.py): the same CREATE TABLE, INSERT and SELECT
  statements through both Sessions.
"""

import math

import numpy as np
import pytest
import torch

from starrocks_tpu import types as JT
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.exprs import ir as jir
from starrocks_tpu.ops import window as jwin
from starrocks_tpu.runtime.config import config as jcfg

from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.exprs import ir as tir
from starrocks_tpu_torch.ops import window as twin
from starrocks_tpu_torch.runtime.config import config as tcfg

from torch_sql_scripts import run_both, sessions
from torch_tpch_parity import reset_knobs

N = 3000


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


def _data():
    rng = np.random.default_rng(5)

    def nulls(values, p):
        return [None if rng.random() < p else v for v in values]

    g = nulls(rng.integers(0, 9, N).tolist(), 0.05)
    g2 = nulls([f"p{i}" for i in rng.integers(0, 6, N)], 0.05)
    k = nulls(rng.integers(0, 40, N).tolist(), 0.08)
    kd = nulls(np.round(rng.integers(0, 4000, N) / 100, 2).tolist(), 0.05)
    v = nulls(np.round(rng.normal(50, 20, N), 2).tolist(), 0.1)
    i = nulls(rng.integers(-500, 500, N).tolist(), 0.1)
    s = nulls([f"s{j:03d}" for j in rng.integers(0, 120, N)], 0.1)
    live = rng.random(N) > 0.05
    return {"g": g, "g2": g2, "k": k, "kd": kd, "v": v, "i": i, "s": s}, live


def _chunks():
    data, live = _data()

    def types(T):
        return {"g": T.INT, "g2": T.VARCHAR, "k": T.INT,
                "kd": T.DECIMAL(10, 2), "v": T.DOUBLE, "i": T.BIGINT,
                "s": T.VARCHAR}

    jc = JHostTable.from_pydict(data, types(JT)).to_chunk()
    tc = THostTable.from_pydict(data, types(TT)).to_chunk(device="cpu")
    pad = np.zeros(jc.capacity - N, bool)
    mask = np.concatenate([live, pad])
    import jax.numpy as jnp

    return (jc.and_sel(jnp.asarray(mask)),
            tc.and_sel(torch.from_numpy(mask)))


@pytest.fixture(scope="module")
def chunks():
    return _chunks()


def _spec(ir, spec):
    """(partition_by, order_by, funcs) in one package's IR; columns by
    name, ORDER BY entries (name, asc, nulls_first), function entries
    (out, fn, arg name | None, offset, default[, frame])."""
    part, order, funcs = spec
    return (tuple(ir.Col(c) for c in part),
            tuple((ir.Col(c), a, nf) for c, a, nf in order),
            tuple((f[0], f[1], None if f[2] is None else ir.Col(f[2]),
                   *f[3:]) for f in funcs))


def _agree(a, b) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if math.isnan(x) and math.isnan(y):
                    continue
                if not math.isclose(x, y, rel_tol=1e-9, abs_tol=1e-9):
                    return False
            elif x != y or type(x) is not type(y):
                return False
    return True


def _frame_funcs(frame, cols=("v", "i", "kd")):
    out = []
    for c in cols:
        for fn in ("sum", "avg", "min", "max", "count"):
            out.append((f"{fn}_{c}", fn, c, None, None, frame))
    return out


ROWS_FRAMES = {
    "p2_cr": ("rows", "p", 2, "cr", None),
    "p1_f2": ("rows", "p", 1, "f", 2),
    "up_f1": ("rows", "up", None, "f", 1),
    "cr_uf": ("rows", "cr", None, "uf", None),
    "f3_f5": ("rows", "f", 3, "f", 5),
    "p5_p3": ("rows", "p", 5, "p", 3),
}
RANGE_FRAMES = {
    "p5_f5": ("range", "p", 5, "f", 5),
    "p7_cr": ("range", "p", 7, "cr", None),
    "up_f4": ("range", "up", None, "f", 4),
    "cr_uf": ("range", "cr", None, "uf", None),
    "up_cr": ("range", "up", None, "cr", None),
}
AGGS = [("cnt_star", "count", None, None, None)] + [
    (f"{fn}_{c}", fn, c, None, None)
    for c in ("v", "i", "kd", "s") for fn in ("sum", "avg", "min", "max",
                                              "count")
    if not (c == "s" and fn in ("sum", "avg"))]

CASES = {
    "ranks": (("g",), (("k", True, True), ("v", False, False)),
              [("rn", "row_number", None, None, None),
               ("rk", "rank", None, None, None),
               ("dr", "dense_rank", None, None, None)]),
    "ranks_no_partition": ((), (("k", False, False),),
                           [("rk", "rank", None, None, None),
                            ("rn", "row_number", None, None, None),
                            ("dr", "dense_rank", None, None, None)]),
    "ranks_string_partition": (("g2", "g"), (("s", True, False),),
                               [("rk", "rank", None, None, None),
                                ("dr", "dense_rank", None, None, None)]),
    "lead_lag": (("g",), (("k", True, False), ("i", True, False)),
                 [("ld", "lead", "v", 1, None), ("lg2", "lag", "v", 2, None),
                  ("lgd", "lag", "i", 1, 0), ("lds", "lead", "s", 1, None),
                  ("ld3", "lead", "i", 3, -1), ("lgk", "lag", "kd", 1, None)]),
    "first_last_default": (("g2",), (("k", True, True),),
                           [("fv", "first_value", "v", None, None),
                            ("lv", "last_value", "i", None, None),
                            ("fs", "first_value", "s", None, None),
                            ("ls", "last_value", "s", None, None)]),
    "first_last_frames": (("g",), (("k", True, False),),
                          [("fv", "first_value", "v", None, None,
                            ("rows", "p", 1, "f", 1)),
                           ("lv", "last_value", "v", None, None,
                            ("rows", "p", 1, "f", 1)),
                           ("fr", "first_value", "i", None, None,
                            ("range", "p", 5, "f", 5)),
                           ("lr", "last_value", "s", None, None,
                            ("range", "p", 5, "f", 5))]),
    "ntile": (("g2",), (("i", True, True),),
              [("n3", "ntile", None, 3, None), ("n4", "ntile", None, 4, None),
               ("n1", "ntile", None, 1, None)]),
    "whole_partition": (("g",), (), AGGS),
    "whole_no_partition": ((), (), AGGS),
    "running": (("g",), (("k", True, False),), AGGS),
    "running_desc": (("g2",), (("kd", False, True),), AGGS),
    **{f"rows_{n}": (("g",), (("k", True, False), ("i", True, False)),
                     _frame_funcs(f))
       for n, f in ROWS_FRAMES.items()},
    "rows_desc": (("g",), (("i", False, False),),
                  _frame_funcs(("rows", "p", 2, "cr", None))),
    **{f"range_{n}": (("g",), (("k", True, False),), _frame_funcs(f))
       for n, f in RANGE_FRAMES.items()},
    "range_desc": (("g",), (("k", False, True),),
                   _frame_funcs(("range", "p", 6, "cr", None))),
    "range_decimal_key": (("g2",), (("kd", True, False),),
                          _frame_funcs(("range", "p", 0.5, "f", 1.25))),
    "range_decimal_key_desc": ((), (("kd", False, False),),
                               _frame_funcs(("range", "p", 2, "cr", None))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_op_matches_jax(chunks, name):
    jc, tc = chunks
    jout = jwin.window_op(jc, *_spec(jir, CASES[name]))
    tout = twin.window_op(tc, *_spec(tir, CASES[name]))
    want = JHostTable.from_chunk(jout).to_pylist()
    got = THostTable.from_chunk(tout).to_pylist()
    assert [f.name for f in tout.schema] == [f.name for f in jout.schema]
    assert [repr(f.type) for f in tout.schema] == \
        [repr(f.type) for f in jout.schema]
    assert len(got) == int(np.asarray(jc.sel_mask()).sum()) and \
        _agree(got, want)


@pytest.mark.parametrize("fn", ["rank", "row_number", "dense_rank"])
def test_window_limit_spec_mask_and_counter(chunks, fn):
    jc, tc = chunks
    spec = (("g",), (("v", False, False),), [("r", fn, None, None, None)])
    jctr, tctr = {}, {}
    jout = jwin.window_op(jc, *_spec(jir, spec), limit_spec=("r", 3),
                          counters=jctr)
    tout = twin.window_op(tc, *_spec(tir, spec), limit_spec=("r", 3),
                          counters=tctr)
    want = JHostTable.from_chunk(jout).to_pylist()
    got = THostTable.from_chunk(tout).to_pylist()
    assert _agree(got, want) and 0 < len(got) < N
    assert int(tctr["window_topn_pruned"]) == \
        int(jctr["window_topn_pruned"]) > 0


@pytest.mark.parametrize("strategy", ["auto", "mxu"])
@pytest.mark.parametrize("order", [("v", False, False), ("k", True, True),
                                   ("i", True, False)])
def test_topn_prefilter_branches_match_jax(chunks, strategy, order):
    """Under `auto` the strided ladder, under `mxu` the exact threshold:
    each gives the reference's keep mask of the same branch."""
    jc, tc = chunks
    for cfg in (jcfg, tcfg):
        cfg.set("segment_strategy", strategy)
    part = ("g2",)
    jk, jseed = jwin.window_topn_prefilter(
        jc, tuple(jir.Col(c) for c in part),
        ((jir.Col(order[0]), order[1], order[2]),), 4)
    tk, tseed = twin.window_topn_prefilter(
        tc, tuple(tir.Col(c) for c in part),
        ((tir.Col(order[0]), order[1], order[2]),), 4)
    assert tseed == jseed
    assert (np.asarray(jk) == tk.numpy()).all()


def test_topn_prefilter_declines_like_jax(chunks):
    """Two order keys, or an unbounded partition key: no prefilter."""
    jc, tc = chunks
    assert twin.window_topn_prefilter(
        tc, (tir.Col("g"),), ((tir.Col("v"), False, False),
                              (tir.Col("k"), True, False)), 3) is None
    assert jwin.window_topn_prefilter(
        jc, (jir.Col("i"),), ((jir.Col("v"), False, False),), 3) is None
    assert twin.window_topn_prefilter(
        tc, (tir.Col("i"),), ((tir.Col("v"), False, False),), 3) is None
    assert not twin.window_topn_prefilter_safe(
        (("d", "dense_rank", None, None, None),), ("d", 3))
    assert not twin.window_topn_prefilter_safe(
        (("r", "rank", None, None, None), ("l", "lead", None, 1, None)),
        ("r", 3))
    assert twin.window_topn_prefilter_safe(
        (("r", "rank", None, None, None), ("d", "dense_rank", None, None,
                                           None)), ("r", 3))


# --- the reference's window SQL tests, through both Sessions ----------------


def _w_script():
    """tests/test_window.py's tables and queries."""
    rng = np.random.default_rng(7)
    n = 500
    g = rng.integers(0, 12, n)
    x = rng.integers(0, 40, n)
    v = np.round(rng.normal(10, 3, n), 2)
    rows = ", ".join(f"({a}, {b}, {c})" for a, b, c in zip(g, x, v))
    return [
        "create table w (g int, x int, v double)",
        f"insert into w values {rows}",
        "select g, x, v, row_number() over (partition by g order by x, v) rn,"
        " rank() over (partition by g order by x) rk from w order by g, x, v",
        "select g, v, sum(v) over (partition by g) t, avg(v) over "
        "(partition by g) a, count(*) over (partition by g) c, max(v) over "
        "(partition by g) mx from w order by g, v",
        "select g, x, sum(x) over (partition by g order by x) rs from w "
        "order by g, x",
        "select * from (select g, x, sum(v) sv, rank() over (partition by g "
        "order by sum(v) desc) rk from w group by g, x) t where rk <= 3 "
        "order by g, rk, x",
        "create table wt (g varchar, x int)",
        "insert into wt values ('a',1),('a',2),('a',3),('b',10),('b',20)",
        "select g, x, lag(x) over (partition by g order by x) lg, lead(x) "
        "over (partition by g order by x) ld, lead(x, 2) over (partition by "
        "g order by x) ld2, first_value(x) over (partition by g order by x) "
        "fv, last_value(x) over (partition by g order by x) lv, ntile(2) "
        "over (partition by g order by x) nt from wt order by g, x",
        "select g, x, min(x) over (partition by g order by x) m from wt "
        "order by g, x",
        "create table wh (g varchar, x int, y int)",
        "insert into wh values ('a',1,100),('a',2,200),('b',3,300)",
        "select g, lag(x, 1, 0) over (partition by g order by x) d from wh "
        "order by g, x",
        "select g, lead(y, 1) over (partition by g order by x) l from wh "
        "order by g, x",
        "select g, lead(g, 1) over (order by g) n from wh group by g "
        "order by g",
        "select g from wh order by x desc",
    ]


def _wf_script():
    """tests/test_window_frames.py's table and every frame it queries."""
    import pandas as pd

    rng = np.random.default_rng(42)
    n = 400
    g = np.sort(rng.integers(0, 8, n))
    df = pd.DataFrame({"g": g})
    df["k"] = df.groupby("g").cumcount() * 3 + rng.integers(0, 3, n)
    v = np.round(rng.normal(50, 20, n), 2)
    nulls = rng.random(n) < 0.12
    rows = ", ".join(
        f"({a}, {b}, {'null' if nu else c})"
        for a, b, c, nu in zip(df.g, df.k, v, nulls))
    frames = [
        "rows between 2 preceding and current row", "rows 3 preceding",
        "rows between 1 preceding and 2 following",
        "rows between unbounded preceding and 1 following",
        "rows between current row and unbounded following",
        "rows between 3 following and 5 following",
        "rows between 5 preceding and 3 preceding",
        "range between 5 preceding and 5 following",
        "range between 7 preceding and current row",
        "range between unbounded preceding and 4 following",
        "range between unbounded preceding and current row",
    ]
    script = ["create table wf (g int, k int, v double)",
              f"insert into wf values {rows}"]
    for fr in frames:
        cols = ", ".join(
            f"{fn}(v) over (partition by g order by k {fr}) c{i}"
            for i, fn in enumerate(("sum", "avg", "min", "max", "count")))
        script.append(f"select g, k, {cols} from wf order by g, k")
    script += [
        "select g, k, first_value(v) over (partition by g order by k rows "
        "between 1 preceding and 1 following) f, last_value(v) over "
        "(partition by g order by k rows between 1 preceding and 1 "
        "following) l from wf order by g, k",
        "select g, k, sum(v) over (partition by g order by k desc rows "
        "between 2 preceding and current row) s from wf order by g, k",
        "select g, k, sum(v) over (partition by g order by k desc range "
        "between 6 preceding and current row) s from wf order by g, k",
        "select sum(v) over (partition by g order by k) s from wf "
        "order by g, k",
        "create table wd (g int, k decimal(10, 2), v double)",
        "insert into wd values " + ", ".join(
            f"(1, {k}, {v})" for k, v in zip(
                [1.00, 1.25, 1.50, 3.00, 3.10, 9.99],
                [1.0, 2.0, 4.0, 8.0, 16.0, 32.0])),
        "select k, sum(v) over (order by k range between 0.5 preceding and "
        "current row) s from wd order by k",
    ]
    return script


@pytest.mark.parametrize("script", ["window", "window_frames"])
def test_reference_window_scripts_match_jax(script):
    js, ts = sessions()
    text = _w_script() if script == "window" else _wf_script()
    out = run_both(js, ts, text)
    assert all(o[0] != "error" for o in out)
    if script == "window":
        assert out[8][1] == [
            ("a", 1, None, 2, 3, 1, 1, 1), ("a", 2, 1, 3, None, 1, 2, 1),
            ("a", 3, 2, None, None, 1, 3, 2), ("b", 10, None, 20, None, 10,
                                               10, 1),
            ("b", 20, 10, None, None, 10, 20, 2)]


@pytest.mark.parametrize("strategy", ["auto", "kernels"])
def test_window_topn_sql_under_both_prefilter_branches(strategy):
    """`rk <= k` over a bounded partition key takes the prefilter: the
    ladder under `auto`, the exact threshold under the kernel strategies;
    the rows equal the JAX package's under the same strategies."""
    from torch_tpch_parity import AUTO_KNOBS, KERNEL_KNOBS, set_knobs

    js, ts = sessions()
    script = _w_script()[:2] + [
        "select * from (select g, x, v, rank() over (partition by g order "
        "by v desc) rk, row_number() over (partition by g order by v desc) "
        "rn from w) t where rk <= 4 order by g, rk, x, v"]
    knobs = KERNEL_KNOBS if strategy == "kernels" else AUTO_KNOBS
    set_knobs(jcfg, knobs)
    set_knobs(tcfg, knobs)
    out = run_both(js, ts, script)
    rows = out[-1][1]
    assert 4 * 12 <= len(rows) < 500
    ctr = {k: v for k, (v, _) in ts.last_profile.counters.items()}
    assert ctr["window_topn_prefiltered"] > 0
    assert ctr["window_topn_pruned"] >= 0
