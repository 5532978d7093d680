"""The PyTorch port's first slice as a whole: TPC-H Q1/Q2/Q3/Q9 from SQL
text, on the CPU, against the JAX package and the pandas oracle.

- the port's generator makes the JAX generator's tables bit for bit;
- the port's optimizer makes the JAX optimizer's plans, node for node;
- `Session(..., device="cpu")` answers like the JAX `Session`, under both
  the `auto` strategies and the kernel (`pallas`) ones: integers, decimals,
  dates and strings exactly, in order; floats to 6 significant digits (the
  rule of bench._rows_match) — and like the oracle;
- under `pallas`, the wrapper counters show Q9 took the hash kernels and Q2
  the top-N kernel;
- the package imports neither jax nor starrocks_tpu, and its entry point
  refuses to run without a card unless asked for the CPU.
"""

import dataclasses
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.sql.analyzer import Analyzer as JAnalyzer
from starrocks_tpu.sql.optimizer import optimize as joptimize
from starrocks_tpu.sql.parser import parse as jparse
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog
from starrocks_tpu.storage.datagen.tpch import gen_tpch as jax_gen_tpch

from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.sql.analyzer import Analyzer
from starrocks_tpu_torch.sql.optimizer import optimize
from starrocks_tpu_torch.sql.parser import parse
from starrocks_tpu_torch.storage.catalog import (
    TPCH_DISTRIBUTION, TPCH_UNIQUE_KEYS, catalog_from_numpy, tpch_catalog,
)
from starrocks_tpu_torch.storage.datagen.tpch import gen_tpch

from tpch_oracle import ORACLES, load_frames
from tpch_queries import QUERIES

SF = 0.01
QIDS = (1, 2, 3, 9)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on these small inputs need no thread pool; one
    thread keeps them from crowding the other test workers' timing-bound
    tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_knobs(cfg):
    """The port's knobs at their defaults in `cfg` (either registry)."""
    for name, _, _, mutable, _ in tcfg.items():
        # a knob a plane module defines when it loads may not be in the
        # other registry yet
        if mutable and name in cfg._fields:
            cfg.set(name, cfg._fields[name].default)


@pytest.fixture(autouse=True)
def _default_knobs():
    """Both registries at their defaults for every test (other test files
    in the same worker may have SET knobs on the JAX side)."""
    _reset_knobs(tcfg)
    _reset_knobs(jcfg)
    yield
    _reset_knobs(tcfg)


@pytest.fixture(scope="module")
def jax_catalog():
    return jax_tpch_catalog(sf=SF)


@pytest.fixture(scope="module")
def jax_rows(jax_catalog):
    _reset_knobs(jcfg)
    s = JSession(jax_catalog)
    return {q: s.sql(QUERIES[q]).rows() for q in QIDS}


@pytest.fixture(scope="module")
def oracle_frames(jax_catalog):
    return load_frames(jax_catalog)


def _jax_catalog_to_port(jc):
    """Hand the JAX catalog's tables to the port as plain numpy arrays."""
    tables = {}
    for name, h in jc.tables.items():
        ht = h.table
        tables[name] = [
            (f.name, repr(f.type), ht.arrays[f.name],
             None if f.dict is None else list(f.dict.values),
             ht.valids.get(f.name))
            for f in ht.schema
        ]
    return catalog_from_numpy(tables, TPCH_UNIQUE_KEYS, TPCH_DISTRIBUTION)


def test_generator_bit_identical():
    want = jax_gen_tpch(sf=SF, seed=42)
    got = gen_tpch(sf=SF, seed=42)
    assert sorted(got) == sorted(want)
    for name in want:
        w, g = want[name], got[name]
        assert [repr(f) for f in g.schema] == [repr(f) for f in w.schema]
        for fw, fg in zip(w.schema, g.schema):
            assert fg.nullable == fw.nullable
            assert (fg.dict is None) == (fw.dict is None), fw.name
            if fw.dict is not None:
                assert list(fg.dict.values) == list(fw.dict.values), fw.name
            aw, ag = w.arrays[fw.name], g.arrays[fw.name]
            assert ag.dtype == aw.dtype and (ag == aw).all(), fw.name
        assert sorted(g.valids) == sorted(w.valids)


def _deep_repr(x):
    """Structural repr of a plan: every dataclass field, recursively (the
    node classes' own reprs abbreviate)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        inner = ", ".join(f"{f.name}={_deep_repr(getattr(x, f.name))}"
                          for f in dataclasses.fields(x))
        return f"{type(x).__name__}({inner})"
    if isinstance(x, (tuple, list)):
        return "(" + ", ".join(_deep_repr(v) for v in x) + ")"
    return repr(x)


@pytest.mark.parametrize("qid", QIDS)
def test_optimized_plans_match_reference(jax_catalog, qid):
    jplan = joptimize(JAnalyzer(jax_catalog).analyze(jparse(QUERIES[qid])),
                      jax_catalog)
    cat = tpch_catalog(sf=SF)
    tplan = optimize(Analyzer(cat).analyze(parse(QUERIES[qid])), cat)
    assert repr(tplan) == repr(jplan)
    assert _deep_repr(tplan) == _deep_repr(jplan)


def _rows_match(got, want):
    """bench._rows_match's rule: exact, except floats to 6 significant
    digits."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not (a == b or math.isclose(a, b, rel_tol=1e-6)):
                    return False
            elif a != b or type(a) is not type(b):
                return False
    return True


def _norm(v):
    import pandas as pd

    if v is None:
        return None
    if isinstance(v, (np.floating, float, np.integer, int)):
        return float(v)
    if isinstance(v, pd.Timestamp):
        return v.strftime("%Y-%m-%d")
    return str(v)


def _oracle_match(got, frames, qid):
    exp = [tuple(r) for r in ORACLES[qid](frames).itertuples(index=False)]
    if len(got) != len(exp):
        return False
    if qid not in (1, 9):  # Q2/Q3 may tie on their sort keys
        got, exp = sorted(got, key=str), sorted(exp, key=str)
    for g, e in zip(got, exp):
        for a, b in zip(g, e):
            a, b = _norm(a), _norm(b)
            if isinstance(a, float) and isinstance(b, float):
                if abs(a - b) > max(abs(b), 1.0) * 1e-6:
                    return False
            elif a != b:
                return False
    return True


@pytest.mark.parametrize("strategy", ["auto", "pallas"])
def test_q1_q2_q3_q9_match_jax_and_oracle(jax_catalog, jax_rows,
                                          oracle_frames, strategy):
    s = Session(_jax_catalog_to_port(jax_catalog), device="cpu")
    s.sql(f"SET join_probe_strategy = '{strategy}'")
    s.sql(f"SET topn_strategy = '{strategy}'")
    routed = {}
    for q in QIDS:
        kernels.reset_counts()
        got = s.sql(QUERIES[q]).rows()
        routed[q] = {n: c["calls"] for n, c in kernels.counts().items()}
        assert _rows_match(got, jax_rows[q]), f"Q{q} differs from JAX"
        assert _oracle_match(got, oracle_frames, q), f"Q{q} differs from oracle"
        assert all(c["launches"] == 0 for c in kernels.counts().values())
    if strategy == "pallas":
        assert routed[9]["hash_build"] >= 1 and routed[9]["hash_probe"] >= 1
        assert routed[2]["topn_select"] >= 1
        assert sum(routed[1].values()) == 0 and sum(routed[3].values()) == 0
    else:
        assert all(sum(r.values()) == 0 for r in routed.values())


def test_generated_catalog_answers_alike(jax_rows):
    """The port's own generator + catalog (no JAX data involved), run twice
    in one session: the warm run reuses cached device columns and
    capacities and answers the same."""
    s = Session(tpch_catalog(sf=SF), device="cpu")
    for q in QIDS:
        first = s.sql(QUERIES[q]).rows()
        assert _rows_match(first, jax_rows[q])
        warm = s.sql(QUERIES[q])
        assert _rows_match(warm.rows(), first)
        assert warm.profile.counters["recompiles"][0] == 0


@pytest.mark.parametrize("sql", [
    "select count(*) as c from lineitem "
    "where l_quantity > (select avg(l_quantity) from lineitem)",
    "select o_orderkey, o_totalprice from orders "
    "where o_totalprice = (select min(o_totalprice) from orders)",
])
def test_uncorrelated_scalar_subquery(jax_catalog, sql):
    """The executor resolves uncorrelated scalar subqueries into literals
    (decimal results exactly, as scaled decimals) before the plan runs."""
    want = JSession(jax_catalog).sql(sql).rows()
    got = Session(_jax_catalog_to_port(jax_catalog), device="cpu").sql(sql)
    assert _rows_match(got.rows(), want)
    assert got.rows()


def test_session_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(tpch_catalog(sf=SF))
    with pytest.raises(RuntimeError):
        Session(device="cuda")
    assert Session(device="cpu").device.type == "cpu"


def test_unported_statements_raise():
    """Every statement is ported (DDL and DML since slice 4, users and
    grants since slice 8, external tables in the last slice, which raise
    the reference's error over a location no file matches); a function
    neither package registers raises; `native` (the host filter-sum lane,
    now ported) answers Q1, which is grouped and so not the lane's shape,
    as `auto` does."""
    s = Session(tpch_catalog(sf=SF), device="cpu")
    with pytest.raises(ValueError, match="no parquet/ORC files match"):
        s.sql("create external table ext from '/nowhere'")
    with pytest.raises(Exception, match="unknown function"):
        s.sql("select no_such_function(l_quantity) from lineitem")
    want = s.sql(QUERIES[1]).rows()
    s.sql("SET segment_strategy = 'native'")
    try:
        r = s.sql(QUERIES[1])
    finally:
        s.sql("SET segment_strategy = 'auto'")
    assert r.rows() == want
    assert "native_fused" not in r.profile.infos


_BLOCKER = textwrap.dedent("""
    import importlib, pkgutil, sys
    for m in list(sys.modules):
        if m.split(".")[0] in ("jax", "jaxlib", "starrocks_tpu"):
            del sys.modules[m]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "starrocks_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import starrocks_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        starrocks_tpu_torch.__path__, "starrocks_tpu_torch.")]
    for n in names:
        importlib.import_module(n)
    import chip_smoke
    print(len(names))
""")


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 25
    # lazy imports inside functions never run at import: scan the sources
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|starrocks_tpu)\b",
                     re.M)
    files = list((REPO / "starrocks_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
