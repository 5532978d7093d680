"""The scalar forms the port's compiler gained for the 22 TPC-H queries,
against the JAX package's compiler, on edge values.

Each expression is built once per package from the same spec, evaluated
by both packages' `project` over the same rows, and the results compared
value for value, NULLs included, exactly (DOUBLE results come from the
same float64 operations): searched CASE (first true branch wins, NULL
conditions, no ELSE, mixed types), IN / NOT IN lists (NULL in the list,
strings, decimals, dates, doubles), DOUBLE division (x/0 is NULL),
date + n months (Jan 31 + 1 month, Feb 29 in and out of leap years,
negative months, dates before 1970), NOT LIKE, substr (negative and zero
starts, starts past the end, lengths), and coalesce.
"""

import datetime

import pytest

import starrocks_tpu.ops as jops
from starrocks_tpu import types as JT
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.exprs import ir as jir

import starrocks_tpu_torch.ops as tops
from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.exprs import ir as tir


def _days(iso):
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


DATES = ["2023-01-31", "2024-01-31", "2024-02-29", "2023-03-31", "1969-12-31",
         "2000-02-29", "2100-01-31", None, "1900-03-01", "2024-12-31"]
DATA = {
    "d": [None if v is None else _days(v) for v in DATES],
    "n": [1, 1, 12, -1, 2, 12, 1, 3, -1, None],
    "x": [1.5, 0.0, -2.25, None, 10.0, 3.0, 0.01, 7.5, -1.0, 2.0],
    "y": [2, 0, -3, 4, None, 0, 1, 5, -1, 7],
    "f": [1.0, 0.0, 2.5, None, -4.0, 0.5, 3.25, 2.0, -0.0, 9.0],
    "s": ["hello", "ab", "", None, "xyz-long string", "a", "abc", "b", "la",
          "hello"],
}


def _chunks():
    def types(T):
        return {"d": T.DATE, "n": T.BIGINT, "x": T.DECIMAL(12, 2),
                "y": T.BIGINT, "f": T.DOUBLE}

    jc = JHostTable.from_pydict(DATA, types(JT)).to_chunk()
    tc = THostTable.from_pydict(DATA, types(TT)).to_chunk(device="cpu")
    return jc, tc


def build(ir, T, spec):
    """The expression `spec` (nested tuples) in one package's IR."""
    kind = spec[0]
    if kind == "col":
        return ir.Col(spec[1])
    if kind == "lit":
        return ir.Lit(spec[1])
    if kind == "date":
        return ir.Lit(spec[1], T.DATE)
    if kind == "call":
        return ir.Call(spec[1], *[build(ir, T, a) for a in spec[2:]])
    if kind == "case":
        whens = tuple((build(ir, T, c), build(ir, T, v)) for c, v in spec[1])
        return ir.Case(whens, None if spec[2] is None else build(ir, T, spec[2]))
    if kind == "in":
        return ir.InList(build(ir, T, spec[1]), tuple(spec[2]), spec[3])
    raise KeyError(kind)


def C(name):
    return ("col", name)


def L(v):
    return ("lit", v)


def F(fn, *args):
    return ("call", fn, *args)


EXPRS = {
    # division: DOUBLE, x/0 and NULL operands NULL
    "div_dec_int": F("divide", C("x"), C("y")),
    "div_int_dec": F("divide", C("y"), C("x")),
    "div_dbl_int": F("divide", C("f"), C("y")),
    "div_by_lit_zero": F("divide", C("x"), L(0)),
    "div_lit_by_col": F("divide", L(7), C("y")),
    "div_dbl_dbl": F("divide", C("f"), C("f")),
    # date + months: month-end clamping, leap years, negative months
    "months_col": F("date_add_months", C("d"), C("n")),
    "months_plus1": F("date_add_months", C("d"), L(1)),
    "months_minus1": F("date_add_months", C("d"), L(-1)),
    "months_plus12": F("date_add_months", C("d"), L(12)),
    "months_minus25": F("date_add_months", C("d"), L(-25)),
    "months_lit_date": F("date_add_months", ("date", "2024-01-31"), C("n")),
    # NOT LIKE over a dictionary column with NULLs
    "not_like_infix": F("not_like", C("s"), L("%l%")),
    "not_like_underscore": F("not_like", C("s"), L("a_")),
    "not_like_empty": F("not_like", C("s"), L("")),
    # substr: 1-based, negative starts count from the end, 0 gives ''
    "substr_1_2": F("substr", C("s"), L(1), L(2)),
    "substr_neg2": F("substr", C("s"), L(-2)),
    "substr_neg2_1": F("substr", C("s"), L(-2), L(1)),
    "substr_zero": F("substr", C("s"), L(0)),
    "substr_past_end": F("substr", C("s"), L(10)),
    "substr_neg_past": F("substr", C("s"), L(-10), L(3)),
    "substr_2_neglen": F("substr", C("s"), L(2), L(-1)),
    # searched CASE
    "case_no_else": ("case", [(F("gt", C("y"), L(0)), C("x")),
                              (F("lt", C("y"), L(0)), L(1))], None),
    "case_first_wins": ("case", [(F("gt", C("f"), L(1)), C("f")),
                                 (F("gt", C("f"), L(0)), C("y"))], C("x")),
    "case_null_cond": ("case", [(F("eq", C("s"), L("ab")), C("y")),
                                (F("gt", C("n"), L(1)), L(100))], L(None)),
    "case_bool": ("case", [(F("gt", C("y"), L(2)), L(True))], L(False)),
    # IN lists
    "in_ints_null": ("in", C("y"), (1, 2, None), False),
    "not_in_ints": ("in", C("y"), (0, 5), False),
    "not_in_null": ("in", C("y"), (0, None), True),
    "in_strings": ("in", C("s"), ("ab", "zz", "hello"), False),
    "not_in_strings": ("in", C("s"), ("hello", ""), True),
    "in_decimals": ("in", C("x"), (1.5, 0, 7.5), False),
    "in_dates": ("in", C("d"), ("2024-02-29", "1969-12-31"), False),
    "in_doubles": ("in", C("f"), (0.0, 2.5), False),
    # coalesce
    "coalesce_int": F("coalesce", C("y"), L(-1)),
    "coalesce_dec_int": F("coalesce", C("x"), C("y")),
    "coalesce_three": F("coalesce", C("f"), C("x"), L(0)),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_jax(name):
    jc, tc = _chunks()
    je = build(jir, JT, EXPRS[name])
    te = build(tir, TT, EXPRS[name])
    jout = jops.project(jc, [je], ["v"])
    tout = tops.project(tc, [te], ["v"])
    jf, tf = jout.schema.field("v"), tout.schema.field("v")
    assert repr(tf.type) == repr(jf.type)
    want = JHostTable.from_chunk(jout).to_pylist()
    got = THostTable.from_chunk(tout).to_pylist()
    assert got == want
    assert len(got) == len(DATES)


def test_month_end_clamping_values():
    """The expected dates themselves, for the month-end cases."""
    _, tc = _chunks()
    out = tops.project(tc, [build(tir, TT, EXPRS["months_plus1"]),
                            build(tir, TT, EXPRS["months_plus12"])],
                       ["p1", "p12"])
    rows = THostTable.from_chunk(out).to_pylist()
    iso = [[None if v is None else str(v) for v in r] for r in rows]
    assert iso[0][0].startswith("2023-02-28")   # Jan 31 2023 + 1
    assert iso[1][0].startswith("2024-02-29")   # Jan 31 2024 + 1 (leap)
    assert iso[2][1].startswith("2025-02-28")   # Feb 29 2024 + 12
    assert iso[5][1].startswith("2001-02-28")   # Feb 29 2000 + 12
    assert iso[6][0].startswith("2100-02-28")   # 2100 is not a leap year
    assert iso[4][0].startswith("1970-01-31")   # before the epoch
    assert iso[7] == [None, None]


def test_string_valued_case_raises():
    """A string-valued CASE over a string literal or over two dictionaries
    (the reference answers with raw codes or fails) raises in the port."""
    _, tc = _chunks()
    gt = F("gt", C("y"), L(0))
    for spec in (("case", [(gt, C("s"))], L("none")),
                 ("case", [(gt, C("s"))], F("upper", C("s")))):
        with pytest.raises(NotImplementedError):
            tops.project(tc, [build(tir, TT, spec)], ["v"])


def test_string_valued_case_of_one_dictionary():
    """CASE whose values are one string column (or NULL) keeps that
    column's dictionary (TPC-DS q36/q86 partition by such a CASE)."""
    _, tc = _chunks()
    e = build(tir, TT, ("case", [(F("gt", C("y"), L(0)), C("s"))], None))
    rows = THostTable.from_chunk(tops.project(tc, [e], ["v"])).to_pylist()
    want = [s if (y is not None and y > 0) else None
            for s, y in zip(DATA["s"], DATA["y"])]
    assert [r[0] for r in rows] == want
