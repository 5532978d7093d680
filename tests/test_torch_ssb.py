"""SSB-flat on the PyTorch port, against the JAX package and the pandas
oracle of tests/test_ssb_sql.py.

The port's copy of the SSB generator (storage/datagen/ssb.py) makes the
JAX generator's tables bit for bit at SF 0.005, and its copy of the 13
FLAT_QUERIES equals tests/ssb_queries.py. Every query runs through
`Session(..., device="cpu")` under `auto` and under the kernel strategies;
the rows equal the JAX Session's exactly and the oracle's at
tests/test_ssb_sql.py's tolerance. SSB-flat launches no kernel: the port
makes no kernel-wrapper call for it under either strategy set.
"""

import numpy as np
import pytest

from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.datagen.ssb import gen_ssb as jax_gen_ssb
from starrocks_tpu.storage.datagen.ssb import ssb_catalog as jax_ssb_catalog

from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage import ssb_queries
from starrocks_tpu_torch.storage.datagen.ssb import SSB_UNIQUE_KEYS, gen_ssb, ssb_catalog

import ssb_queries as test_ssb_queries
from test_ssb_sql import _oracle
from torch_tpch_parity import AUTO_KNOBS, KERNEL_KNOBS, port_run, reset_knobs

SF = 0.005


@pytest.fixture(autouse=True)
def _default_knobs():
    reset_knobs()
    yield
    reset_knobs()


def test_generator_bit_identical():
    want, got = jax_gen_ssb(sf=SF), gen_ssb(sf=SF)
    assert sorted(got) == sorted(want)
    for name in want:
        w, g = want[name], got[name]
        assert [repr(f) for f in g.schema] == [repr(f) for f in w.schema]
        for fw, fg in zip(w.schema, g.schema):
            assert (fg.dict is None) == (fw.dict is None), fw.name
            if fw.dict is not None:
                assert list(fg.dict.values) == list(fw.dict.values), fw.name
            assert g.arrays[fw.name].dtype == w.arrays[fw.name].dtype
            assert np.array_equal(g.arrays[fw.name], w.arrays[fw.name])
            assert sorted(g.valids) == sorted(w.valids)
    from starrocks_tpu.storage.datagen.ssb import SSB_UNIQUE_KEYS as J_KEYS

    assert SSB_UNIQUE_KEYS == J_KEYS


def test_query_copy_matches_the_tests():
    assert ssb_queries.FLAT_QUERIES == test_ssb_queries.FLAT_QUERIES
    assert sorted(ssb_queries.NATIVE_QUERIES) == ["NL1", "NL2", "NL3"]


@pytest.fixture(scope="module")
def sessions():
    js = JSession(jax_ssb_catalog(sf=SF))
    flat = js.catalog.get_table("lineorder_flat").table.to_pandas()
    return js, Session(ssb_catalog(sf=SF), device="cpu"), flat


def _oracle_match(got, exp, qid):
    """tests/test_ssb_sql.py's rule."""
    assert len(got) == len(exp), f"{qid}: {len(got)} vs {len(exp)} rows"
    for i, (g, e) in enumerate(zip(got, exp)):
        for gv, ev in zip(g, e):
            if isinstance(ev, (int, float, np.floating, np.integer)):
                ok = (gv is None and (ev != ev)) or abs(
                    float(gv) - float(ev)) <= max(abs(float(ev)), 1) * 1e-9
                assert ok, f"{qid} row {i}: {gv} vs {ev}"
            else:
                assert str(gv) == str(ev), f"{qid} row {i}: {gv!r} vs {ev!r}"


@pytest.mark.parametrize("strategy", ["auto", "kernels"])
@pytest.mark.parametrize("qid", sorted(ssb_queries.FLAT_QUERIES))
def test_ssb_flat_matches_jax_and_oracle(sessions, qid, strategy):
    js, ts, flat = sessions
    text = ssb_queries.FLAT_QUERIES[qid]
    got, calls = port_run(ts, text, KERNEL_KNOBS if strategy == "kernels"
                          else AUTO_KNOBS)
    assert got == js.sql(text).rows()
    _oracle_match(got, _oracle(flat, qid), qid)
    assert calls == {}
