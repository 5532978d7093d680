"""The port's sorted-build probe kernel and the unique join that runs it,
against the JAX package's, on the CPU.

- kernels.probe_searchsorted_plain (what the CUDA kernel is held to on the
  card) against probe_searchsorted_pallas run with interpret=True, exactly:
  duplicate build keys, sentinel-padded builds, K = 1, INT64_MIN/MAX
  probes, probe counts that are not a multiple of 2048 (the reference's
  block then shrinks to 1024 rows, or to the whole probe);
- hash_join_unique under `join_probe_strategy = 'pallas_sorted'` against
  the JAX package's under the same knob, for every join type: the same
  rows, and one call of the probe wrapper.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import starrocks_tpu.ops as jops
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.exprs.ir import Col
from starrocks_tpu.ops import pallas_kernels as pk
from starrocks_tpu.ops.join import _probe_block
from starrocks_tpu.runtime.config import config as jcfg

import starrocks_tpu_torch.ops as tops
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.exprs import ir as tir
from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.runtime.config import config as tcfg

I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_probe_strategy():
    for cfg in (jcfg, tcfg):
        cfg.set("join_probe_strategy", "auto")
    yield
    for cfg in (jcfg, tcfg):
        cfg.set("join_probe_strategy", "auto")


def _case(name):
    rng = np.random.default_rng(17)
    if name == "duplicates":
        return (np.sort(rng.integers(-40, 40, 3000)),
                rng.integers(-50, 50, 4096))
    if name == "sentinel_padded":
        build = np.concatenate([np.sort(rng.permutation(1 << 20)[:2000]),
                                np.full(48, I64MAX)])
        probe = np.concatenate([build[rng.integers(0, 2048, 3000)],
                                rng.integers(0, 1 << 20, 1094), [I64MAX, I64MAX]])
        return build, probe
    if name == "k1":
        return np.array([5]), np.tile([4, 5, 6, I64MIN, I64MAX, 0, -5, 99], 128)
    if name == "int64_extremes":
        build = np.array([I64MIN, I64MIN, I64MIN + 1, -1, 0, 0, 1, I64MAX - 1,
                          I64MAX, I64MAX])
        probe = np.tile([I64MIN, I64MIN + 1, I64MIN + 2, -2, -1, 0, 1, 2,
                         I64MAX - 2, I64MAX - 1, I64MAX, 7], 256)
        return build, probe
    if name == "probe_1024_multiple":   # 3072 rows: the reference's block 1024
        return (np.sort(rng.integers(-(1 << 40), 1 << 40, 5000)),
                rng.integers(-(1 << 41), 1 << 41, 3072))
    if name == "probe_ragged":          # 1000 rows: one block of 1000
        return (np.sort(rng.integers(-1000, 1000, 777)),
                rng.integers(-1100, 1100, 1000))
    raise KeyError(name)


@pytest.mark.parametrize("case", ["duplicates", "sentinel_padded", "k1",
                                  "int64_extremes", "probe_1024_multiple",
                                  "probe_ragged"])
def test_probe_plain_matches_pallas(case):
    build, probe = _case(case)
    build = np.ascontiguousarray(build, np.int64)
    probe = np.ascontiguousarray(probe, np.int64)
    want = np.asarray(pk.probe_searchsorted_pallas(
        jnp.asarray(build), jnp.asarray(probe),
        block=_probe_block(len(probe)), interpret=True))
    kernels.reset_counts()
    got = kernels.probe_searchsorted(torch.from_numpy(build),
                                     torch.from_numpy(probe))
    assert kernels.counts()["probe_searchsorted"] == {"calls": 1, "launches": 0}
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.searchsorted(build, probe, "left"))


def test_probe_plain_empty_build_and_rejects():
    got = kernels.probe_searchsorted(torch.zeros(0, dtype=torch.int64),
                                     torch.tensor([1, 2, I64MAX]))
    assert got.tolist() == [0, 0, 0]
    with pytest.raises(TypeError):
        kernels.probe_searchsorted(torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.probe_searchsorted(torch.arange(8)[::2],
                                   torch.zeros(4, dtype=torch.int64))


def _chunks(data):
    jc = JHostTable.from_pydict(data).to_chunk()
    tc = THostTable.from_pydict(data).to_chunk(device="cpu")
    return jc, tc


@pytest.mark.parametrize("join_type", ["inner", "left_outer", "left_semi",
                                       "left_anti"])
def test_unique_join_through_the_sorted_probe(join_type):
    """A composite (k1, k2) key packed with bit widths (TPC-H Q9's partsupp
    join shape), NULL keys on both sides, under pallas_sorted in both."""
    rng = np.random.default_rng(23)
    nb, npr = 700, 2300
    a = rng.permutation(400)[:nb // 2]
    b = rng.integers(0, 3, nb // 2)
    build = {"k1": np.concatenate([a, a]).tolist(),
             "k2": np.concatenate([b, b + 3]).tolist(),
             "w": rng.integers(-10**9, 10**9, nb).tolist()}
    build["k1"][5] = None
    probe = {"p1": rng.integers(-5, 410, npr).tolist(),
             "p2": rng.integers(0, 7, npr).tolist()}
    for i in rng.integers(0, npr, 40):
        probe["p1"][i] = None
    jb, tb = _chunks(build)
    jp, tp = _chunks(probe)
    jcfg.set("join_probe_strategy", "pallas_sorted")
    tcfg.set("join_probe_strategy", "pallas_sorted")
    jout = jops.hash_join_unique(jp, jb, (Col("p1"), Col("p2")),
                                 (Col("k1"), Col("k2")), join_type,
                                 bit_widths=(10, 4))
    kernels.reset_counts()
    tout = tops.hash_join_unique(tp, tb, (tir.Col("p1"), tir.Col("p2")),
                                 (tir.Col("k1"), tir.Col("k2")), join_type,
                                 bit_widths=(10, 4))
    assert kernels.counts()["probe_searchsorted"]["calls"] == 1
    assert kernels.counts()["hash_build"]["calls"] == 0
    want = JHostTable.from_chunk(jout).to_pylist()
    got = THostTable.from_chunk(tout).to_pylist()
    assert got == want and got


def test_unknown_probe_strategy_raises():
    tcfg.set("join_probe_strategy", "nonsense")
    _, tb = _chunks({"k": [1, 2, 3]})
    _, tp = _chunks({"p": [1, 2, 5]})
    with pytest.raises(ValueError, match="join_probe_strategy"):
        tops.hash_join_unique(tp, tb, (tir.Col("p"),), (tir.Col("k"),))
