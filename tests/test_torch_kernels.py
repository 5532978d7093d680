"""Kernel modules of the PyTorch port against the JAX package's Pallas
kernels.

The port's three kernels (ops/kernels.py: hash_build, hash_probe,
topn_select) take their plain torch versions on CPU tensors; here those are
held against the JAX package's hash_build_pallas / hash_probe_pallas /
topn_select_pallas run with interpret=True on the same numpy inputs. The
results must be EXACT: probe rows and top-N candidates element for element,
and the build table slot for slot. mix64, the engine's hash, must be
bit-identical on edge values. The card's partitioned hash build lays its
table out otherwise; its numpy model's table answers every probe as
hash_probe_pallas does on the reference's own table.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from starrocks_tpu.ops import common as jcommon
from starrocks_tpu.ops import pallas_kernels as pk
from starrocks_tpu_torch.ops import common as tcommon
from starrocks_tpu_torch.ops import kernels

from test_torch_kernel_layouts import (
    hash_build_model, hash_edge_case, hash_probe_model, use_slices,
)

I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on these small inputs need no thread pool; one
    thread keeps them from crowding the other test workers' timing-bound
    tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_mix64(x):
    z = np.asarray(x, np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z.view(np.int64)


def _colliding_keys(table_size, n, seed=0):
    """n distinct keys whose home slot is one of 3 slots: long chains and
    wrap-around past the table's end."""
    rng = np.random.default_rng(seed)
    want = {table_size - 1, table_size - 2, 5}
    out = []
    while len(out) < n:
        cand = rng.integers(-(1 << 62), 1 << 62, 200_000, dtype=np.int64)
        slot = _np_mix64(cand) & (table_size - 1)
        out.extend(int(c) for c in cand[np.isin(slot, list(want))])
    return np.unique(np.asarray(out[:n], np.int64))


EDGE = np.array([0, 1, -1, 2, -2, I64MIN, I64MIN + 1, I64MAX - 1, 1 << 31,
                 -(1 << 31), 0x5555555555555555, -0x5555555555555556,
                 (1 << 62), -(1 << 62), 123456789012345], np.int64)


def test_mix64_bit_identity():
    rng = np.random.default_rng(1)
    x = np.concatenate([EDGE, np.array([I64MAX], np.int64),
                        rng.integers(I64MIN, I64MAX, 5000, dtype=np.int64)])
    want = np.asarray(jcommon.mix64(jnp.asarray(x).view(jnp.uint64))).view(
        np.int64)
    got = tcommon.mix64(torch.from_numpy(x)).numpy()
    assert (got == want).all()
    assert (got == _np_mix64(x)).all()


def _jax_build(keys, table):
    tk, tr = pk.hash_build_pallas(jnp.asarray(keys), table, interpret=True)
    return np.asarray(tk), np.asarray(tr)


def _jax_probe(tk, tr, probe, block):
    return np.asarray(pk.hash_probe_pallas(
        jnp.asarray(tk), jnp.asarray(tr), jnp.asarray(probe), block=block,
        interpret=True))


def _hash_case(name):
    rng = np.random.RandomState(7)
    if name == "random_sentinels_misses":
        keys = rng.permutation(1 << 20)[:900].astype(np.int64)
        keys[3] = I64MAX    # NULL/dead build rows carry the sentinel
        keys[77] = I64MAX
        probe = np.concatenate([
            keys, rng.randint(-100, 1 << 20, 3196)]).astype(np.int64)[:4096]
        return keys, 2048, probe, 1024
    if name == "dense_adjacent":
        keys = np.arange(1000, dtype=np.int64)
        return keys, 2048, np.arange(2048, dtype=np.int64), 1024
    if name == "int64_extremes":
        keys = np.concatenate([EDGE, [I64MAX, I64MAX]]).astype(np.int64)
        probe = np.concatenate([
            EDGE, [I64MAX, 3, -3, I64MAX - 2],
            np.zeros(1024 - len(EDGE) - 4, np.int64)]).astype(np.int64)
        return keys, 64, probe, 1024
    if name == "heavy_collisions":
        keys = _colliding_keys(256, 120)
        probe = np.concatenate([keys[::-1], keys + 1,
                                np.full(1024 - 2 * len(keys), I64MAX)])
        return keys, 256, probe.astype(np.int64), 1024
    raise KeyError(name)


HASH_CASES = ["random_sentinels_misses", "dense_adjacent", "int64_extremes",
              "heavy_collisions"]


@pytest.mark.parametrize("case", HASH_CASES)
def test_hash_build_probe_plain_matches_pallas(case):
    keys, table, probe, block = _hash_case(case)
    jtk, jtr = _jax_build(keys, table)
    ttk, ttr = kernels.hash_build(torch.from_numpy(keys), table)
    # slot for slot: the plain build reproduces the claim rounds exactly
    assert (ttk.numpy() == jtk).all()
    assert (ttr.numpy() == jtr).all()
    jrow = _jax_probe(jtk, jtr, probe, block)
    trow = kernels.hash_probe(ttk, ttr, torch.from_numpy(probe)).numpy()
    assert (trow == jrow).all()
    oracle = {int(k): i for i, k in enumerate(keys) if k != I64MAX}
    assert (trow == np.array([oracle.get(int(p), -1) for p in probe])).all()


@pytest.mark.parametrize("case", ["inner_slice_end", "table_end_wraps"])
def test_partitioned_build_model_probes_as_pallas(monkeypatch, case):
    """The card's partitioned build (its numpy model, at slices of 64 slots
    so that chains cross slices and T - 1 -> 0) answers every probe as
    hash_probe_pallas does on the reference's own table; the partitioned
    probe's model answers the same."""
    use_slices(monkeypatch, "small")
    _, keys, t, probe = hash_edge_case(case)
    block = 1024
    probe = np.concatenate([probe, np.full(-len(probe) % block, I64MAX)])
    jtk, jtr = _jax_build(keys, t)
    want = _jax_probe(jtk, jtr, probe, block)
    tk, tr, deferred = hash_build_model(keys, t, seed=0)
    assert deferred > 0
    got = kernels.hash_probe(torch.from_numpy(tk), torch.from_numpy(tr),
                             torch.from_numpy(probe)).numpy()
    assert (got == want).all()
    assert (hash_probe_model(tk, tr, probe)[0] == want).all()


def test_hash_wrappers_validate_and_count():
    keys = torch.arange(10, dtype=torch.int64)
    kernels.reset_counts()
    tk, tr = kernels.hash_build(keys, 32)
    kernels.hash_probe(tk, tr, keys)
    c = kernels.counts()
    assert c["hash_build"] == {"calls": 1, "launches": 0}
    assert c["hash_probe"] == {"calls": 1, "launches": 0}
    with pytest.raises(ValueError):
        kernels.hash_build(keys, 16)          # load factor above 0.5
    with pytest.raises(ValueError):
        kernels.hash_build(keys, 24)          # not a power of two
    with pytest.raises(TypeError):
        kernels.hash_build(keys.to(torch.int32), 32)
    with pytest.raises(ValueError):
        kernels.hash_probe(tk, tr, keys.reshape(2, 5).t().reshape(-1)[::2])


def _topn_case(name):
    rng = np.random.default_rng(3)
    if name == "random_ties":
        return rng.integers(0, 50, 4096).astype(np.int64), 37
    if name == "all_equal":
        return np.full(3072, 42, np.int64), 100
    if name == "int64_extremes":
        x = rng.integers(-5, 5, 2048).astype(np.int64)
        x[rng.integers(0, 2048, 300)] = I64MIN
        x[rng.integers(0, 2048, 50)] = I64MAX
        x[1024:] = I64MIN  # a block of nothing but dead-row codes
        x[1030] = 7
        return x, 64
    if name == "dead_tail":
        # the shape sort_chunk feeds it: live codes, then complemented
        # INT64_MAX dead rows (= INT64_MIN), fewer live rows than k
        x = np.full(2048, I64MIN, np.int64)
        x[:30] = rng.integers(-1000, 0, 30)
        return x, 100
    raise KeyError(name)


TOPN_CASES = ["random_ties", "all_equal", "int64_extremes", "dead_tail"]


@pytest.mark.parametrize("case", TOPN_CASES)
def test_topn_select_plain_matches_pallas(case):
    neg, k = _topn_case(case)
    jv, ji = pk.topn_select_pallas(jnp.asarray(neg), k, interpret=True)
    tv, ti = kernels.topn_select(torch.from_numpy(neg), k)
    assert (tv.numpy() == np.asarray(jv)).all()
    assert (ti.numpy() == np.asarray(ji)).all()
    assert ti.dtype == torch.int32 and tv.dtype == torch.int64


def test_topn_select_plain_full_block():
    """k = 1024 (a whole block; Q2's shape) against a stable sort."""
    rng = np.random.default_rng(5)
    neg = rng.integers(-3, 3, 2048).astype(np.int64)
    tv, ti = kernels.topn_select(torch.from_numpy(neg), 1024)
    for b in range(2):
        blk = neg[b * 1024:(b + 1) * 1024]
        order = np.argsort(-blk, kind="stable")
        assert (ti.numpy()[b * 1024:(b + 1) * 1024] == order + b * 1024).all()
        assert (tv.numpy()[b * 1024:(b + 1) * 1024] == blk[order]).all()


def test_topn_select_validates():
    with pytest.raises(ValueError):
        kernels.topn_select(torch.zeros(1000, dtype=torch.int64), 10)
    with pytest.raises(ValueError):
        kernels.topn_select(torch.zeros(1024, dtype=torch.int64), 1025)
    with pytest.raises(TypeError):
        kernels.topn_select(torch.zeros(1024, dtype=torch.int32), 10)
