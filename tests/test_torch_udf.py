"""Python scalar UDFs of the PyTorch port (`runtime/udf.py`, CREATE/DROP
FUNCTION in the Session) against the JAX package's.

The reference's SQL script (tests/test_udf.py, without its distributed
case) runs through both Sessions, each registering the functions in its
own package's registry. A redefined function is never served from a stale
plan (the plan cache keys on `registry_epoch()`), and the host seconds of
the UDF bodies land in the query profile's `udf_s`.
"""

import pytest

from starrocks_tpu.runtime import udf as judf

from starrocks_tpu_torch.runtime import udf as tudf

from torch_function_parity import run_pair, session_pair
from torch_tpch_parity import reset_knobs


@pytest.fixture()
def pair():
    reset_knobs()
    p = session_pair({"t": {"a": [1, 2, None, 4],
                            "b": [10.0, 2.5, 3.0, None],
                            "s": ["x", "yy", "zzz", None]}})
    yield p
    judf._REGISTRY.clear()
    tudf._REGISTRY.clear()
    reset_knobs()


MY_MIX = ("create function my_mix(a bigint, b double) returns double as '\n"
          "def my_mix(a, b):\n    return a * b + 0.5\n'")
ODD_LEN = ("create function odd_len(s varchar) returns boolean as '\n"
           "def odd_len(s):\n    if s == \"zzz\":\n        return None\n"
           "    return len(s) % 2 == 1\n'")
TWICE = ("create function twice(a bigint) returns bigint as '\n"
         "def twice(a):\n    return 2 * a\n'")


def _f1(body):
    return ("create function f1(a bigint) returns bigint as '\ndef f1(a):\n"
            f"    return {body}\n'")


UDF_SCRIPTS = {
    "select_and_where": [MY_MIX, "select a, my_mix(a, b) from t order by a",
                         "select a from t where my_mix(a, b) > 6 order by a"],
    "string_args_and_none": [ODD_LEN,
                             "select s, odd_len(s) from t order by a"],
    "with_aggregates": [TWICE, "select sum(twice(a)) from t",
                        "select s, twice(a) + 1 from t where a > 1 "
                        "order by s"],
    "replace_and_drop": [
        _f1("a + 1"), "select f1(1) from t limit 1", _f1("a"),
        "create or replace " + _f1("a + 10")[len("create "):],
        "select f1(1) from t limit 1", "drop function f1",
        "select f1(1) from t", "drop function if exists f1",
        "drop function f1"],
    "date_and_decimal": [
        "create function next_day_of(d date) returns date as '\n"
        "import datetime\ndef next_day_of(d):\n"
        "    return d + datetime.timedelta(days=1)\n'",
        "create table dd (d date, m decimal(10, 2))",
        "insert into dd values ('2024-02-28', 1.25), ('2023-12-31', 2.50)",
        "select next_day_of(d) from dd order by d"],
    "string_return_raises": [
        "create function bad(a bigint) returns varchar as '\ndef bad(a):\n"
        "    return str(a)\n'"],
}


@pytest.mark.parametrize("name", sorted(UDF_SCRIPTS))
def test_udf_script_matches_jax(pair, name):
    for text in UDF_SCRIPTS[name]:
        run_pair(pair, text)


def test_redefined_udf_is_not_served_from_a_stale_plan(pair):
    """The plan cache keys on the registry epoch: after a redefinition in
    ANOTHER session (no cache clear here), the same query text answers with
    the new body."""
    from starrocks_tpu_torch.runtime.session import Session

    _, ts = pair
    other = Session(ts.catalog, device="cpu")
    other.sql(_f1("a + 1"))
    q = "select f1(a) from t where a = 1"
    assert ts.sql(q).rows() == [(2,)]
    e0 = tudf.registry_epoch()
    tudf.create_udf("f1", (("a", None),), tudf.get_udf("f1").ret,
                    "def f1(a):\n    return a + 100\n", replace=True)
    assert tudf.registry_epoch() == e0 + 1
    assert ts.sql(q).rows() == [(101,)]


def test_udf_host_seconds_land_in_the_profile(pair):
    _, ts = pair
    ts.sql(TWICE)
    ts.sql("select sum(twice(a)) from t")
    assert ts.last_profile.counters["udf"][0] > 0
    ts.sql("select sum(a) from t")
    assert "udf" not in ts.last_profile.counters
