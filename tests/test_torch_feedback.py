"""The plan-feedback loop of the PyTorch port (starrocks_tpu_torch/runtime/
feedback.py) against the JAX package: the cases of
tests/test_plan_feedback.py, through both Sessions where a case runs SQL.

Held: a learning run that burns adaptive retries teaches the store, and a
fresh Session over the same data_dir (the restart) pre-tightens from the
`plan_feedback.json` sidecar and runs with zero retries, counting the ones
it did not burn; DML and DDL invalidate entries, version tokens reject a
stale sidecar, the consult token reaches a fixpoint, `plan_feedback = off`
answers the same rows; the store's LRU bound, observation counts and
band-tier token moves; the recursive salted split. Rows and the feedback
counters equal the reference's at every step. The fingerprint's cases are
in tests/test_torch_feedback_fingerprint.py; the key-read audit of the
consult path is in tests/test_torch_plan_verifier.py. The reference's
static lint fixtures (tools/src_lint.py) belong to its tools, which the
port does not carry.
"""

import os

import numpy as np
import pytest
import torch

from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession

from starrocks_tpu_torch.runtime.batched import MAX_SALT_DEPTH, _salted_split
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.feedback import FeedbackStore
from starrocks_tpu_torch.runtime.session import Session as TSession

from torch_tpch_parity import reset_knobs, rows_match

EXPAND_Q = "select count(*) c, sum(a.v + b.w) s from a join b on a.k = b.k"


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


def _jctr(profile, name):
    tot = profile.counters.get(name, (0, ""))[0]
    for c in profile.children:
        tot += _jctr(c, name)
    return tot


def _tctr(profile, name):
    return profile.counters.get(name, (0,))[0]


def _pair(tmp_path):
    return (JSession(data_dir=str(tmp_path / "jax")),
            TSession(device="cpu", data_dir=str(tmp_path / "port")))


def _expansion_pair(tmp_path):
    """Store-backed many-to-many join whose output (200k rows over 20 keys)
    overflows any estimate-derived capacity: the learning run must burn at
    least one adaptive retry."""
    pair = _pair(tmp_path)
    ra = ",".join(f"({i % 20},{i})" for i in range(2000))
    for s in pair:
        s.sql("create table a (k bigint, v bigint)")
        s.sql("create table b (k bigint, w bigint)")
        s.sql(f"insert into a values {ra}")
        s.sql(f"insert into b values {ra}")
    return pair


def _q(pair, text=EXPAND_Q,
       counters=("feedback_hits", "recompiles", "feedback_retries_avoided")):
    """One query through both Sessions: equal rows and feedback counters.
    Returns (port rows, port counters)."""
    js, ts = pair
    want = js.sql(text).rows()
    got = ts.sql(text).rows()
    assert rows_match(got, want)
    j = {n: _jctr(js.last_profile, n) for n in counters}
    t = {n: _tctr(ts.last_profile, n) for n in counters}
    assert t == j, (t, j)
    return got, t


def _sql(pair, text):
    for s in pair:
        s.sql(text)


# --- restart persistence + pre-tightening ------------------------------------


def test_restart_pretightens_zero_recompiles(tmp_path):
    pair = _expansion_pair(tmp_path)
    r1, c1 = _q(pair)
    assert c1["recompiles"] >= 1, "learning run must burn an adaptive retry"
    assert os.path.exists(tmp_path / "port" / "plan_feedback.json")
    restarted = _pair(tmp_path)  # fresh process analog
    r2, c2 = _q(restarted)
    assert r2 == r1
    assert c2["feedback_hits"] == 1 and c2["recompiles"] == 0
    assert c2["feedback_retries_avoided"] >= c1["recompiles"]


def test_consult_token_fixpoint(tmp_path):
    pair = _expansion_pair(tmp_path)
    for _ in range(6):  # past the band floor (obs >= 5)
        _q(pair)
    tokens = [s.cache.feedback.stats()["tokens"] for s in pair]
    _q(pair)
    _q(pair)
    assert [s.cache.feedback.stats()["tokens"] for s in pair] == tokens
    assert tokens[0] == tokens[1]


# --- staleness ---------------------------------------------------------------


@pytest.mark.parametrize("stmt", ["insert into b values (999, 999)",
                                  "drop table b"])
def test_dml_and_ddl_invalidate(tmp_path, stmt):
    pair = _expansion_pair(tmp_path)
    _q(pair)
    assert [s.cache.feedback.stats()["entries"] for s in pair] == [1, 1]
    _sql(pair, stmt)
    assert [s.cache.feedback.stats()["entries"] for s in pair] == [0, 0]


def test_version_token_rejects_stale_sidecar(tmp_path):
    pair = _expansion_pair(tmp_path)
    _q(pair)
    restarted = _pair(tmp_path)
    _sql(restarted, "insert into a values (7, 7)")  # move the data
    assert _q(restarted)[1]["feedback_hits"] == 0


# --- the A/B anchor ------------------------------------------------------------


def test_feedback_off_same_rows(tmp_path):
    pair = _expansion_pair(tmp_path)
    r_on1, _ = _q(pair)
    r_on2, c = _q(pair)  # consult-hit run
    assert c["feedback_hits"] == 1
    _sql(pair, "set plan_feedback = off")
    r_off, c = _q(pair)
    assert c["feedback_hits"] == 0
    assert r_off == r_on1 == r_on2


def test_annealed_feedback_keeps_results_identical(tmp_path):
    pair = _expansion_pair(tmp_path)
    base, _ = _q(pair)
    for _ in range(7):
        assert _q(pair)[0] == base
    _sql(pair, "set plan_feedback = off")
    assert _q(pair)[0] == base


def test_store_lru_bound():
    fs = FeedbackStore()

    class _Cat:
        def data_version(self, name):
            return (0, "mem", 1)

    for i in range(FeedbackStore.MAX_ENTRIES + 16):
        fs.record(f"fp{i}", _Cat(), ["t"], "local", {"x": 1}, 0)
    assert fs.stats()["entries"] == FeedbackStore.MAX_ENTRIES


# --- recursive salted repartitioning -----------------------------------------


def test_salted_split_bounds_and_conserves():
    rng = np.random.default_rng(1)
    rk = rng.integers(0, 40, 20000).astype(np.int64)
    lk = rng.integers(0, 40, 8000).astype(np.int64)
    out, stats = [], {"sub": 0, "oversized": 0, "hot": []}
    _salted_split(lk, rk, np.arange(lk.size), np.arange(rk.size),
                  4096, "inner", 1000, np.uint64(1), 0, out, stats)
    assert stats["oversized"] == 0
    assert max(b.size for _, b in out) <= 4096
    allb = np.concatenate([b for _, b in out])
    assert np.array_equal(np.sort(allb), np.arange(rk.size))
    allp = np.concatenate([p for p, _ in out])
    assert np.array_equal(np.sort(allp), np.arange(lk.size))


def test_salted_split_single_key_records_hot():
    rk = np.full(9000, 7, dtype=np.int64)
    lk = np.full(100, 7, dtype=np.int64)
    out, stats = [], {"sub": 0, "oversized": 0, "hot": []}
    _salted_split(lk, rk, np.arange(100), np.arange(9000),
                  4096, "inner", 1000, np.uint64(1), 0, out, stats)
    assert len(out) == 1 and stats["oversized"] == 1
    assert stats["hot"] == [(7, 9000)]


def test_salted_split_depth_bound():
    rk = np.repeat(np.arange(8, dtype=np.int64), 1000)
    lk = np.arange(8, dtype=np.int64)
    out, stats = [], {"sub": 0, "oversized": 0, "hot": []}
    _salted_split(lk, rk, np.arange(8), np.arange(8000), 4096, "inner",
                  10 ** 9, np.uint64(1), MAX_SALT_DEPTH, out, stats)
    assert len(out) == 1 and stats["oversized"] == 1 and stats["sub"] == 0
    assert MAX_SALT_DEPTH >= 2


def test_hybrid_hot_key_runs_match_jax_with_feedback(tmp_path):
    """A hybrid join over stored tables whose build key 7 owns more rows
    than a batch: its two runs (the second consults the feedback the first
    recorded: partition outcomes and probe-side heavy hitters) give the
    reference's rows and join counters, the broadcast lane included."""
    pair = _pair(tmp_path)
    _sql(pair, "create table p (k bigint, v bigint)")
    _sql(pair, "create table d (k bigint, w bigint)")
    _sql(pair, "insert into p values " + ",".join(
        f"({i % 50},{i})" for i in range(5000)))
    # key 7 owns 1500 build rows: past the batch budget
    _sql(pair, "insert into d values " + ",".join(
        f"({7 if i < 1500 else i % 40},{i})" for i in range(2000)))
    for cfg in (jcfg, tcfg):
        cfg.set("batch_rows_threshold", 1024)
        cfg.set("spill_batch_rows", 1024)
        cfg.set("join_skew_factor", 1)
    q = "select count(*) c, sum(v + w) s from p join d on p.k = d.k"
    js, ts = pair
    for run in range(2):
        want = js.sql(q).rows()
        got = ts.sql(q).rows()
        assert rows_match(got, want)
        jc = {k: v for k, (v, _) in js.last_profile.counters.items()
              if k.startswith("join_")}
        tc = {k: v for k, (v, _) in ts.last_profile.counters.items()
              if k.startswith("join_")}
        assert tc == jc, (run, tc, jc)
        assert tc["join_skew_keys"] == 1
    assert ts.last_profile.counters["feedback_hits"][0] == 1


# --- guard-band annealing ---------------------------------------------------------


def test_feedback_band_anneals_to_floor():
    from starrocks_tpu_torch.sql.optimizer import (
        FEEDBACK_BAND_FLOOR, FEEDBACK_CARD_BAND, feedback_band)
    assert feedback_band(0) == FEEDBACK_CARD_BAND
    assert feedback_band(1) == FEEDBACK_CARD_BAND
    prev = feedback_band(1)
    for obs in range(2, 12):
        cur = feedback_band(obs)
        assert cur <= prev and cur >= FEEDBACK_BAND_FLOOR
        prev = cur
    assert feedback_band(5) == FEEDBACK_BAND_FLOOR
    assert feedback_band(10 ** 6) == FEEDBACK_BAND_FLOOR


def test_record_counts_observations_and_resets_with_versions():
    fs = FeedbackStore()

    class _Cat:
        ver = 0

        def data_version(self, name):
            return (0, "mem", self.ver)

    cat = _Cat()
    for _ in range(3):
        fs.record("fp", cat, ["t"], "local", {"x": 1}, 0)
    assert fs.consult("fp", cat)["obs"] == 3
    cat.ver = 1  # the data moved: everything learned decays
    fs.record("fp", cat, ["t"], "local", {"x": 1}, 0)
    assert fs.consult("fp", cat)["obs"] == 1


def test_band_tier_move_bumps_token_then_fixpoint():
    from starrocks_tpu_torch.sql.optimizer import feedback_band
    fs = FeedbackStore()

    class _Cat:
        def data_version(self, name):
            return (0, "mem", 1)

    fs.record("fp", _Cat(), ["t"], "local", {"x": 1}, 0)
    tokens = [fs.consult("fp", _Cat())["token"]]
    for _ in range(6):
        fs.record("fp", _Cat(), ["t"], "local", {"x": 1}, 0)
        tokens.append(fs.consult("fp", _Cat())["token"])
    for i in range(1, len(tokens)):
        moved = feedback_band(i) != feedback_band(i + 1)
        assert tokens[i] == tokens[i - 1] + (1 if moved else 0)
    assert tokens[-1] == tokens[-2] == tokens[-3]
