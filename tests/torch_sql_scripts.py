"""Shared machinery of the statement and storage parity tests of the
PyTorch port (tests/test_torch_statements.py, test_torch_store.py,
test_torch_mv.py, test_torch_scan_rf.py): run one script of SQL statements
through the JAX package's Session and the port's `Session(device="cpu")`,
in memory or each over its own `data_dir`, and compare what every statement
returns.

A statement's result is compared by kind: a query's rows under
bench._rows_match's rule (exact, floats to 6 significant digits), and
anything else (row counts, lists of names, SHOW/DESCRIBE tuples, EXPLAIN
and SHOW CREATE text, None) exactly, with the same Python type. An error
is compared by its type's name.
"""

from __future__ import annotations

import pytest

from starrocks_tpu.runtime.session import QueryResult as JQueryResult
from starrocks_tpu.runtime.session import Session as JSession

from starrocks_tpu_torch.runtime.executor import QueryResult as TQueryResult
from starrocks_tpu_torch.runtime.session import Session as TSession

from torch_tpch_parity import reset_knobs, rows_match


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


def sessions(tmp_path=None, jax_catalog=None, port_catalog=None):
    """(JAX session, port session): in memory, or over two data dirs under
    tmp_path (one per package: their rowset files differ)."""
    if tmp_path is None:
        return (JSession(jax_catalog),
                TSession(port_catalog, device="cpu"))
    return (JSession(jax_catalog, data_dir=str(tmp_path / "jax")),
            TSession(port_catalog, device="cpu",
                     data_dir=str(tmp_path / "port")))


def outcome(session, text):
    """What a statement returns, in a comparable form: ("rows", [...]) for
    a query, ("value", v) otherwise, ("error", type name) if it raised."""
    try:
        res = session.sql(text)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__)
    if isinstance(res, (JQueryResult, TQueryResult)):
        return ("rows", res.rows())
    return ("value", res)


def same_outcome(a, b) -> bool:
    if a[0] != b[0]:
        return False
    if a[0] == "rows":
        return rows_match(b[1], a[1])
    if a[0] == "value":
        return a[1] == b[1] and type(a[1]) is type(b[1])
    return a[1] == b[1]


def run_both(js, ts, script) -> list:
    """Each statement through both sessions; asserts equal outcomes and
    returns the port's."""
    out = []
    for text in script:
        want = outcome(js, text)
        got = outcome(ts, text)
        assert same_outcome(want, got), (text, want, got)
        out.append(got)
    return out
