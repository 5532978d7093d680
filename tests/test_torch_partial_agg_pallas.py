"""Two-phase (PARTIAL/FINAL) aggregation of the PyTorch port under
`segment_strategy='pallas'`, against the JAX package (whose segment-sum
kernel runs in interpret mode on the CPU, hence a file of its own).

The float sums of PARTIAL and FINAL go through segment_sum wherever the
reference's do (the <= 1024-group rule): the same states and FINAL rows
(f32 block sums, STAT_KERNEL_REL apart), and the same number of
segment_sum calls per phase (the JAX operators run eagerly here, so its
counter counts calls, not traces). Data and helpers:
tests/test_torch_partial_agg.py.
"""

import pytest

import starrocks_tpu.ops as jops
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.ops import aggregate as jagg
from starrocks_tpu.ops import pallas_kernels as jpk
from starrocks_tpu.ops.setops import concat_many as j_concat_many
from starrocks_tpu.runtime.config import config as jcfg

import starrocks_tpu_torch.ops as tops
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.exprs import ir as tir
from starrocks_tpu_torch.ops import aggregate as tagg
from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.ops.setops import concat_many as t_concat_many
from starrocks_tpu_torch.runtime.config import config as tcfg

from test_torch_partial_agg import (  # noqa: F401 — fixtures
    PALLAS_AGGS, PALLAS_BATCHES, _aggs, _close, _default_knobs, _group,
    _jax_batches, _one_torch_thread, _port_batches, _rows, _two_phase,
    tables,
)
from torch_tpch_parity import STAT_KERNEL_REL


def test_pallas_states_and_calls_match_jax(tables):
    """Under segment_strategy='pallas' the float sums of PARTIAL and FINAL
    go through segment_sum wherever the reference's do (<= 1024 groups):
    the same states, and the same calls per phase."""
    jht, tht = tables
    names = PALLAS_AGGS
    jcfg.set("segment_strategy", "pallas")
    tcfg.set("segment_strategy", "pallas")
    counter = {"n": 0}
    real = jpk.segment_sum_pallas

    def counted(*a, **k):
        counter["n"] += 1
        return real(*a, **k)

    jb = _jax_batches(jht, PALLAS_BATCHES)
    tb = _port_batches(tht, PALLAS_BATCHES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpk, "segment_sum_pallas", counted)
        for key in ("global", "g"):
            counter["n"] = 0
            jstates, jfinal = _two_phase(
                jops, j_concat_many, jb, _group(jagg, key),
                _aggs(jagg, names), jagg)
            jcalls = counter["n"]
            kernels.reset_counts()
            tstates, tfinal = _two_phase(
                tops, t_concat_many, tb, _group(tir, key),
                _aggs(tir, names), tagg)
            tcalls = kernels.counts()["segment_sum"]["calls"]
            assert tcalls == jcalls and tcalls > 0, (key, tcalls, jcalls)
            for s, js in zip(tstates, jstates):
                assert _close(_rows(THostTable, s), _rows(JHostTable, js),
                              STAT_KERNEL_REL)
            assert _close(_rows(THostTable, tfinal),
                          _rows(JHostTable, jfinal), STAT_KERNEL_REL)
