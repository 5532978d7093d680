"""Shared machinery of the 22-query parity tests of the PyTorch port
(tests/test_torch_tpch22_*.py): the JAX package's answers, computed once
per test module, and the comparison rules.

- TPC-H under `auto`: the JAX `Session` answers each query once; its
  answers under the kernel strategies are the same rows (TPC-H sums only
  integers and decimals), which the fixture checks for the queries whose
  plans reach a JAX kernel (Q9, Q20) rather than assumes.
- S1/S2 under the kernel strategies sum float moments in f32 row blocks
  (the reference's contract), so the JAX package answers them under both.
- While the JAX package runs a query under the kernel strategies, its two
  Pallas entry points (probe_searchsorted_pallas, segment_sum_pallas) are
  wrapped with counters, so the port can be held to the same number of
  kernel calls per query.
"""

from __future__ import annotations

import math

import numpy as np
import pandas as pd
import pytest

from starrocks_tpu.ops import pallas_kernels as jpk
from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession

from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.runtime.config import (
    AUTO_STRATEGIES as AUTO_KNOBS, KERNEL_STRATEGIES as KERNEL_KNOBS,
    config as tcfg,
)

SF = 0.01
# queries whose full output order is deterministic given the sort keys
# (tests/test_tpch_sql.py's list)
FULLY_ORDERED = {1, 4, 5, 6, 7, 8, 9, 12, 14, 17, 19, 20, 22}
# queries whose JAX plans reach a Pallas kernel under the kernel strategies
KERNEL_QUERIES = {9, 20, "S1", "S2"}
JAX_KERNELS = {"probe_searchsorted": "probe_searchsorted_pallas",
               "segment_sum": "segment_sum_pallas"}
# S1/S2 under the kernel strategies, port vs JAX: both sum f32 row blocks,
# each in its own order inside a block (torch's CPU matmul vs XLA's dot),
# and var = (sum x^2 - (sum x)^2 / n) / (n - 1) cancels: measured 2.4e-6
# apart at SF 0.01
STAT_KERNEL_REL = 1e-5
# S1/S2 f32 block sums vs float64 sums (measured 1.4e-6 at SF 0.01)
STAT_F32_VS_F64_REL = 1e-4


def set_knobs(cfg, knobs: dict):
    for k, v in knobs.items():
        cfg.set(k, v)


def reset_knobs():
    """Both registries' copies of the port's knobs at their defaults (a knob
    a module defines when it loads, such as `enable_plan_cache`, may not be
    in the JAX registry yet)."""
    for cfg in (tcfg, jcfg):
        for name, _, _, mutable, _ in tcfg.items():
            if mutable and name in cfg._fields:
                cfg.set(name, cfg._fields[name].default)


def jax_answers(jax_catalog, texts: dict) -> dict:
    """{(strategy, q): rows} and {q: {kernel: JAX calls}} for `texts`
    ({q: sql}), strategy "auto" for every query and "kernels" for those in
    KERNEL_QUERIES."""
    reset_knobs()
    s = JSession(jax_catalog)
    rows = {("auto", q): s.sql(t).rows() for q, t in texts.items()}
    calls = {}
    counter = {}
    with pytest.MonkeyPatch.context() as mp:
        for port_name, jax_name in JAX_KERNELS.items():
            fn = getattr(jpk, jax_name)

            def counted(*a, _fn=fn, _n=port_name, **k):
                counter[_n] = counter.get(_n, 0) + 1
                return _fn(*a, **k)

            mp.setattr(jpk, jax_name, counted)
        set_knobs(jcfg, KERNEL_KNOBS)
        try:
            for q, t in texts.items():
                if q not in KERNEL_QUERIES:
                    continue
                counter.clear()
                rows[("kernels", q)] = JSession(jax_catalog).sql(t).rows()
                calls[q] = dict(counter)
        finally:
            set_knobs(jcfg, AUTO_KNOBS)
    return {"rows": rows, "calls": calls}


def rows_match(got, want, rel: float = 1e-6) -> bool:
    """bench._rows_match's rule (exact, except floats to 6 significant
    digits), or a relative `rel` for floats."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not (a == b or math.isclose(a, b, rel_tol=rel)):
                    return False
            elif a != b or type(a) is not type(b):
                return False
    return True


def _norm(v):
    if v is None:
        return None
    if isinstance(v, (np.floating, float, np.integer, int)):
        return float(v)
    if isinstance(v, pd.Timestamp):
        return v.strftime("%Y-%m-%d")
    if isinstance(v, np.datetime64):
        return str(v)[:10]
    return str(v)


def oracle_match(got, oracle_df, qid) -> bool:
    """tests/test_tpch_sql.py's oracle rule: floats to max(|x|, 1) * 1e-6,
    unordered comparison where the query's sort keys leave ties."""
    exp = [tuple(r) for r in oracle_df.itertuples(index=False)]
    if len(got) != len(exp):
        return False
    if qid not in FULLY_ORDERED:
        got, exp = sorted(got, key=str), sorted(exp, key=str)
    for g, e in zip(got, exp):
        if len(g) != len(e):
            return False
        for a, b in zip(g, e):
            a, b = _norm(a), _norm(b)
            if a is None or b is None:
                if not (a is None and b is None):
                    return False
            elif isinstance(a, float) and isinstance(b, float):
                if abs(a - b) > max(abs(b), 1.0) * 1e-6:
                    return False
            elif a != b:
                return False
    return True


def port_run(session, text: str, knobs: dict):
    """(rows, {kernel: calls}) of one port query under `knobs`; no kernel
    launches on the CPU."""
    set_knobs(tcfg, knobs)
    kernels.reset_counts()
    rows = session.sql(text).rows()
    counts = kernels.counts()
    assert all(c["launches"] == 0 for c in counts.values())
    return rows, {n: c["calls"] for n, c in counts.items() if c["calls"]}
