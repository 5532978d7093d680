"""ARRAY columns and functions, UNNEST, array_agg, lambdas, MAP and STRUCT
in the PyTorch port, against the JAX package.

- `exprs/functions_array.py` functions and lambda bodies evaluated by both
  packages' ExprCompiler on one seeded chunk (arrays built from its
  columns): types, validity and values agree exactly.
- `ops/unnest.py` against the reference's unnest_op on a seeded chunk with
  NULL arrays and dead rows, the dead tail included (clamped gathers).
- The reference's SQL scripts (tests/test_array_decimal128.py's array
  part, tests/test_lambda_functions.py) run through both Sessions;
  array_agg past its 256-element capacity recompiles; stored ARRAY columns
  wait for slice 5c and say so; a raw MAP result column raises.
"""

import numpy as np
import pytest

from starrocks_tpu import types as JT
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.exprs import ir as jir
from starrocks_tpu.ops.unnest import unnest_op as j_unnest

from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.exprs import ir as tir
from starrocks_tpu_torch.ops.unnest import unnest_op as t_unnest
from starrocks_tpu_torch.runtime.session import Session as TSession

from torch_function_parity import C, L, chunk_pair, check_spec, run_pair, \
    session_pair
from torch_tpch_parity import reset_knobs


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


@pytest.fixture(scope="module")
def chunks():
    return chunk_pair()


A_I = ("array", (C, "i"), ("pmod", (C, "j"), (L, 5)), (L, 3), (C, "i"))
A_F = ("array", (C, "f"), (C, "unit"), (L, 2.5))
A_D = ("array", (C, "dt"), (C, "dt2"))
A_S = ("split", (C, "s"), (L, " "))
A_MIX = ("array", (C, "s"), (L, "zz"), ("upper", (C, "s")))

CASES = {
    "array": [A_I, A_F, A_D, A_MIX, ("array", (L, 1), (L, 2))],
    "array_length": [("array_length", A_I), ("array_length", A_S)],
    "cardinality": [("cardinality", A_S)],
    "element_at": [("element_at", A_I, (L, 2)), ("element_at", A_S, (L, 2)),
                   ("element_at", A_I, ("pmod", (C, "j"), (L, 6))),
                   ("element_at", A_I, (L, 0))],
    "array_contains": [("array_contains", A_I, (L, 3)),
                       ("array_contains", A_S, (L, "world")),
                       ("array_contains", A_I, (C, "i"))],
    "array_position": [("array_position", A_I, (L, 3)),
                       ("array_position", A_S, (L, "IN"))],
    "array_sum": [("array_sum", A_I), ("array_sum", A_F)],
    "array_avg": [("array_avg", A_I), ("array_avg", A_F)],
    "array_min": [("array_min", A_I), ("array_min", A_F),
                  ("array_min", A_D)],
    "array_max": [("array_max", A_I), ("array_max", A_F)],
    "array_sort": [("array_sort", A_I), ("array_sort", A_F),
                   ("array_sort", A_S), ("array_sort", A_MIX)],
    "array_distinct": [("array_distinct", A_I), ("array_distinct", A_S),
                       ("array_distinct", ("array", (L, 1), (L, 1),
                                           (C, "i"), (L, 1)))],
    "split": [A_S, ("split", (C, "s"), (L, ",")),
              ("split", (C, "js"), (L, '"'))],
}


@pytest.mark.parametrize("fn", sorted(CASES))
def test_array_function_matches_jax(chunks, fn):
    for spec in CASES[fn]:
        check_spec(chunks, spec)


def _lam(ir, params, body):
    return ir.Lambda(tuple(params), body)


LAMBDAS = {
    "array_map_capture": lambda ir: ir.Call(
        "array_map", _lam(ir, ["e"], ir.Call("add", ir.Call(
            "multiply", ir.Col("@lam.e"), ir.Lit(2)), ir.Col("i"))),
        ir.Call("array", ir.Col("i"), ir.Lit(7), ir.Col("sh"))),
    "array_map_strings": lambda ir: ir.Call(
        "array_map", _lam(ir, ["w"], ir.Call("upper", ir.Col("@lam.w"))),
        ir.Call("split", ir.Col("s"), ir.Lit(" "))),
    "array_filter": lambda ir: ir.Call(
        "array_filter", ir.Call("array", ir.Col("i"), ir.Col("sh"),
                                ir.Lit(4)),
        _lam(ir, ["e"], ir.Call("gt", ir.Col("@lam.e"), ir.Col("i")))),
    "any_match": lambda ir: ir.Call(
        "any_match", _lam(ir, ["e"], ir.Call("gt", ir.Col("@lam.e"),
                                             ir.Lit(30))),
        ir.Call("array", ir.Col("i"), ir.Col("sh"))),
    "all_match": lambda ir: ir.Call(
        "all_match", ir.Call("array", ir.Col("i"), ir.Col("sh")),
        _lam(ir, ["e"], ir.Call("ge", ir.Col("@lam.e"), ir.Lit(0)))),
    "array_sortby": lambda ir: ir.Call(
        "array_sortby", _lam(ir, ["e"], ir.Call("negate", ir.Col("@lam.e"))),
        ir.Call("array", ir.Col("sh"), ir.Col("i"), ir.Lit(9))),
    "zip_map": lambda ir: ir.Call(
        "array_map", _lam(ir, ["a", "b"], ir.Call(
            "subtract", ir.Col("@lam.a"), ir.Col("@lam.b"))),
        ir.Call("array", ir.Col("i"), ir.Col("sh")),
        ir.Call("array", ir.Lit(1), ir.Lit(2), ir.Lit(3))),
    "map_element": lambda ir: ir.Call(
        "element_at", ir.Call("map_from_arrays",
                              ir.Call("array", ir.Lit("q"), ir.Lit("n")),
                              ir.Call("array", ir.Col("i"), ir.Col("sh"))),
        ir.Lit("n")),
    "map_size_dup": lambda ir: ir.Call(
        "map_size", ir.Call("map_from_arrays",
                            ir.Call("array", ir.Col("i"), ir.Lit(3)),
                            ir.Call("array", ir.Col("sh"), ir.Lit(4)))),
    "struct_field": lambda ir: ir.Call(
        "struct_field", ir.Call("named_struct", ir.Lit("k"), ir.Col("j"),
                                ir.Lit("q"), ir.Col("dec")), ir.Lit("q")),
    "array_top_n": lambda ir: ir.Call(
        "array_top_n", ir.Call("array", ir.Col("i"), ir.Col("sh"),
                               ir.Lit(5)), ir.Lit(2)),
}


@pytest.mark.parametrize("name", sorted(LAMBDAS))
def test_lambda_and_map_matches_jax(chunks, name):
    from starrocks_tpu.exprs.compile import ExprCompiler as JCompiler
    from starrocks_tpu_torch.exprs.compile import ExprCompiler as TCompiler

    from torch_function_parity import assert_same_eval

    jc, tc = chunks
    jv = JCompiler(jc).eval(LAMBDAS[name](jir))
    tv = TCompiler(tc).eval(LAMBDAS[name](tir))
    assert_same_eval(jv, tv, jc.capacity, np.asarray(jc.sel_mask()), name)


# --- unnest --------------------------------------------------------------


def _unnest_tables(seed=5, n=3000):
    rng = np.random.default_rng(seed)
    lists = [None if k % 17 == 0 else
             rng.integers(-9, 99, rng.integers(0, 6)).tolist()
             for k in range(n)]
    words = [None if k % 13 == 0 else
             [["a", "bb", "c", "dd"][x] for x in rng.integers(0, 4, 2)]
             for k in range(n)]
    data = {"id": list(range(n)), "nums": lists, "tags": words,
            "v": rng.normal(size=n).tolist()}
    return (JHostTable.from_pydict(data, {"nums": JT.ARRAY(JT.BIGINT),
                                          "tags": JT.ARRAY(JT.VARCHAR)}),
            THostTable.from_pydict(data, {"nums": TT.ARRAY(TT.BIGINT),
                                          "tags": TT.ARRAY(TT.VARCHAR)}))


@pytest.mark.parametrize("col,cap", [("nums", 16384), ("tags", 8192),
                                     ("nums", 4096)])
def test_unnest_op_matches_jax_dead_tail_included(col, cap):
    """Every output slot — the live rows and the dead tail past the true
    count (which repeats the last row) — and the true count agree; the
    4096 case overflows the capacity and truncates like the reference."""
    jh, th = _unnest_tables()
    keep = np.arange(3000) % 5 != 0  # dead input rows
    jc = jh.to_chunk().and_sel(np.pad(keep, (0, 72)))
    import torch
    tc = th.to_chunk(device="cpu").and_sel(
        torch.from_numpy(np.pad(keep, (0, 72))))
    jo, jt = j_unnest(jc, jir.Col(col), "x", cap)
    to, tt = t_unnest(tc, tir.Col(col), "x", cap)
    assert int(jt) == int(tt)
    assert np.array_equal(np.asarray(jo.sel_mask()), to.sel_mask().numpy())
    for i, f in enumerate(jo.schema.fields):
        assert np.array_equal(np.asarray(jo.data[i]), to.data[i].numpy()), \
            f.name
    if cap == 4096:
        assert int(tt) > cap


ARRAY_SETUP = [
    "CREATE TABLE t (id BIGINT, nums ARRAY<BIGINT>, tags ARRAY<VARCHAR>, "
    "txt VARCHAR)",
    "INSERT INTO t VALUES (1, array(3, 1, 2, 1), array('x', 'y'), 'a,b,c'),"
    "(2, array(9), array('z'), 'solo'),"
    "(3, array(5, 5), array('y', 'x', 'y'), 'p,,q')",
    "CREATE TABLE n (a ARRAY<VARCHAR>)",
    "INSERT INTO n VALUES (NULL)",
    "INSERT INTO n VALUES (array('k'))",
    "CREATE TABLE p (x BIGINT, s1 VARCHAR, s2 VARCHAR)",
    "INSERT INTO p VALUES (1, 'aa', 'bb')",
    "create table lt (g int, arr array<int>, x int)",
    "insert into lt values (1, array(1,2,3), 10), (2, array(5), 100), "
    "(3, array(), 7), (4, null, 1)",
    "create table st (g int, names array<varchar>, nums array<int>)",
    "insert into st values (1, array('a','b','c'), array(3,1,2)), "
    "(2, array('z'), array(9))",
    "create table zz (a array<int>, b array<int>)",
    "insert into zz values (array(1,2,3), array(7))",
]
MAPQ = "map_from_arrays(arr, array_map(e -> e * 10, arr))"
MCAT = ("map_concat(map_from_arrays(array(1, 2), array(10, 20)), "
        "map_from_arrays(array(2, 3), array(200, 300)))")
ARRAY_QUERIES = [
    "SELECT array_length(nums), element_at(nums, 2), array_contains(nums, 1),"
    " array_position(tags, 'y') FROM t ORDER BY id",
    "SELECT array_sum(nums), array_avg(nums), array_min(nums), "
    "array_max(nums) FROM t ORDER BY id",
    "SELECT array_sort(nums), array_distinct(nums), array_sort(tags) "
    "FROM t ORDER BY id",
    "SELECT split(txt, ',') FROM t ORDER BY id",
    "SELECT id, x FROM t, unnest(nums) u(x) ORDER BY id, x",
    "SELECT tag, count(*) c FROM t, unnest(tags) u(tag) GROUP BY tag "
    "ORDER BY tag",
    "SELECT sum(x) FROM t, unnest(nums) u(x) WHERE x > 2",
    "SELECT id, array_sort(array_agg(x)) FROM t, unnest(nums) u(x) "
    "GROUP BY id ORDER BY id",
    "SELECT array(x, 2.5) m, array(s1, s2, 'cc') st FROM p",
    "SELECT a FROM n",
    "SELECT id, nums, tags FROM t ORDER BY id",
    "SELECT id, array_agg(txt) FROM t GROUP BY id ORDER BY id",
    # tests/test_lambda_functions.py
    "select g, array_map(e -> e * 2 + x, arr) m from lt order by g",
    "select array_map(arr, e -> e + 1) m from lt where g = 1",
    "select array_map((a, b) -> a * b, arr, arr) m from lt order by g",
    "select array_map(s -> length(s) + g, names) m from st order by g",
    "select g, array_filter(arr, e -> e % 2 = 1) f from lt order by g",
    "select g, all_match(arr, e -> e > 0) a, any_match(arr, e -> e > 2) y "
    "from lt order by g",
    "select array_sortby(names, s -> length(s)) s from st where g = 1",
    "select array_sortby(arr, e -> -e) s from lt where g = 1",
    "select array_sortby((s, n) -> n, names, nums) s from st where g = 1",
    f"select g, map_size({MAPQ}) z from lt where g <= 3 order by g",
    f"select element_at({MAPQ}, 2) v, map_contains_key({MAPQ}, 5) c "
    "from lt where g <= 2 order by g",
    f"select map_keys({MAPQ}) k, map_values({MAPQ}) v from lt where g = 1",
    f"select cardinality({MAPQ}) c from lt where g = 1",
    "select g, array_map(e -> 'k', arr) m from lt where g <= 2 order by g",
    f"select map_values(transform_values({MAPQ}, (k, v) -> v + k)) tv "
    "from lt where g = 1",
    f"select map_keys(transform_keys({MAPQ}, (k, v) -> k * 100)) tk "
    "from lt where g = 1",
    f"select map_keys(map_filter({MAPQ}, (k, v) -> v >= 20)) mk "
    "from lt where g = 1",
    f"select element_at({MCAT}, 2) v, map_size({MCAT}) z from lt where g = 1",
    f"select map_keys({MCAT}) k, map_values({MCAT}) v from lt where g = 1",
    "select g, array_map(e -> e + g, array(g, g * 2)) m, count(*) c "
    "from lt where g <= 2 group by g order by g",
    "select g from lt where g <= 3 group by g "
    "having any_match(array(g, g * 2), e -> e > 3) order by g",
    "select array_map(e -> cardinality(array_filter(arr, f -> f > e)), arr) m"
    " from lt where g = 1",
    "select array_map((x, y) -> x + y, a, b) m from zz",
    "select array_filter(a, b, x -> x > 1) m from zz",
    "select named_struct('a', x, 'b', g * 2).a sa, "
    "named_struct('a', x, 'b', g * 2).b sb from lt where g = 2",
    "select struct_field(row(x, g), 'col2') c2 from lt where g = 1",
    "select named_struct('a', 1).zz from lt where g = 1",
    "select g from lt where any_match(arr, e -> e >= 5) order by g",
    "select sum(cardinality(array_filter(arr, e -> e > 1))) s from lt "
    "where g <= 3",
    "select array_map(x -> x + 1, arr) m from lt where g = 1",
    "select element_at(map_from_arrays(array(1, 1), array(10, 20)), 1) v, "
    "map_size(map_from_arrays(array(1, 1), array(10, 20))) z "
    "from lt where g = 1",
    "select g, element_at(map_from_arrays(array(g, 7), array(g * 10, 70)), g)"
    " v from lt order by g",
    "select g, element_at(map_from_arrays(array(7), array(70)), g) v "
    "from lt order by g",
    "select array_top_n(arr, 2), array_sort_lambda(arr, e -> -e) from lt "
    "where g = 1",
    "select map_entries_values(map_from_arrays(array('a'), array(x))) "
    "from lt where g = 1",
]


@pytest.fixture(scope="module")
def array_sessions():
    reset_knobs()
    pair = session_pair()
    for text in ARRAY_SETUP:
        run_pair(pair, text)
    return pair


@pytest.mark.parametrize("k", range(len(ARRAY_QUERIES)))
def test_array_script_matches_jax(array_sessions, k):
    run_pair(array_sessions, ARRAY_QUERIES[k])


def test_array_agg_capacity_overflow_recompiles():
    """Groups larger than the default 256-element array capacity trigger
    the adaptive recompile, not a truncation."""
    pair = session_pair()
    run_pair(pair, "CREATE TABLE big (g BIGINT, v BIGINT)")
    rows = ", ".join(f"({i % 2}, {i})" for i in range(700))
    run_pair(pair, f"INSERT INTO big VALUES {rows}")
    got = run_pair(pair, "SELECT g, array_length(array_agg(v)) FROM big "
                         "GROUP BY g ORDER BY g")
    assert got == ("rows", [(0, 350), (1, 350)])
    assert pair[1].last_profile.counters["recompiles"][0] >= 1


def test_raw_map_result_column_raises(array_sessions):
    _, ts = array_sessions
    with pytest.raises(NotImplementedError, match="MAP value cannot be"):
        ts.sql(f"select {MAPQ} m from lt")


def test_stored_array_columns_wait_for_slice_5c(tmp_path):
    """The reference's ARRAY storage round trip
    (tests/test_array_decimal128.py::test_array_storage_roundtrip) through
    both Sessions, each over its own data_dir: the TabletStore persists
    ARRAY<INT> and ARRAY<VARCHAR> columns ([rows, K+1] lanes, per-file
    element dictionaries) and a restart reads them back. (The name is
    kept from when the port raised here.)"""
    from starrocks_tpu.runtime.session import Session as JSession

    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    pair = (JSession(data_dir=dirs[0]),
            TSession(device="cpu", data_dir=dirs[1]))
    run_pair(pair, "CREATE TABLE at (id BIGINT, a ARRAY<INT>, "
                   "s ARRAY<VARCHAR>)")
    run_pair(pair, "INSERT INTO at VALUES (1, array(1, 2), array('p', 'q')),"
                   "(2, array(7), array('r'))")
    run_pair(pair, "INSERT INTO at VALUES (3, array(4, 5, 6), "
                   "array('q', 'z', 'a'))")
    restarted = (JSession(data_dir=dirs[0]),
                 TSession(device="cpu", data_dir=dirs[1]))
    got = run_pair(restarted, "SELECT id, a, s FROM at ORDER BY id")
    assert got == ("rows", [(1, [1, 2], ["p", "q"]), (2, [7], ["r"]),
                            (3, [4, 5, 6], ["q", "z", "a"])])
    got = run_pair(restarted,
                   "SELECT id, x FROM at, unnest(s) u(x) ORDER BY id, x")
    assert got[1][:3] == [(1, "p"), (1, "q"), (2, "r")]


def test_alter_add_array_column_waits_for_slice_5c(tmp_path):
    """The reference's tests/test_storage.py::test_alter_add_array_column
    through both Sessions: ALTER TABLE ADD COLUMN of an ARRAY, stored
    (old files read the column back NULL) and in memory. (The name is kept
    from when the port raised here.)"""
    from starrocks_tpu.runtime.session import Session as JSession

    stored = (JSession(data_dir=str(tmp_path / "jax")),
              TSession(device="cpu", data_dir=str(tmp_path / "port")))
    for pair, t in ((stored, "v"), (session_pair(), "w")):
        run_pair(pair, f"CREATE TABLE {t} (a BIGINT)")
        run_pair(pair, f"INSERT INTO {t} VALUES (1)")
        run_pair(pair, f"ALTER TABLE {t} ADD COLUMN arr ARRAY<BIGINT>")
        run_pair(pair, f"INSERT INTO {t} VALUES (2, array(7, 8))")
        got = run_pair(pair, f"SELECT a, arr FROM {t} ORDER BY a")
        assert got == ("rows", [(1, None), (2, [7, 8])])
    run_pair(stored, "SELECT a, array_length(arr) FROM v ORDER BY a")
