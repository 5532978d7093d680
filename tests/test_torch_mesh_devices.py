"""The port's mesh over a tuple of devices, one per shard (the counterpart
of the JAX Mesh's device array), on the CPU:

- the placement rule `shard_devices(n, device, count)`: a bare `cuda`
  spreads the shards over the first k cards, k the largest divisor of n
  that is at most the card count, in consecutive blocks; a named card and
  the CPU hold every shard; no card raises;
- a mesh over an explicit tuple of 8 CPU devices answers as the default
  mesh does, collective for collective;
- `Mesh.to` copies a value to another device once per device inside a
  program's run (`Mesh.replicas`), and `chunk_from_host` puts each shard
  on its own device (the meta device stands in for a second one);
- the port's DistExecutor over an explicit 8-device tuple against the JAX
  package's Session(dist_shards=8) on the 8 virtual CPU devices of
  tests/conftest.py, for DIST_QUERIES at TPC-H SF 0.01: integers,
  decimals and row counts exactly, floats to 6 significant digits.

The mixed mesh (cuda:0, cpu) x 4 and the meshes over several cards run
in tests/test_torch_gpu.py.
"""

import types

import numpy as np
import pytest
import torch

import starrocks_tpu.sql.distributed as JD
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.catalog import tpch_catalog as jax_tpch_catalog

import starrocks_tpu_torch.sql.distributed as D
from starrocks_tpu_torch import lockdep
from starrocks_tpu_torch.column import HostTable
from starrocks_tpu_torch.exprs.ir import Col
from starrocks_tpu_torch.parallel.exchange import (
    all_gather_chunk, range_partition_chunk, shuffle_chunk,
)
from starrocks_tpu_torch.parallel.mesh import (
    Mesh, device_runs, make_mesh, shard_devices, shard_host_table,
)
from starrocks_tpu_torch.runtime.cluster_exec import ClusterRuntime
from starrocks_tpu_torch.runtime.dist_executor import (
    DistExecutor, chunk_from_host, chunk_to_host, placement_errors,
)
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

from torch_tpch_parity import reset_knobs, rows_match

CPU = torch.device("cpu")
# the queries whose ORDER BY orders every row: compared in order
ORDERED = {"Q1", "Q5", "Q6", "Q12", "Q14", "Q19", "O1"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in six processes on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the placement rule --------------------------------------------------------


@pytest.mark.parametrize("count,k", [(1, 1), (2, 2), (3, 2), (4, 4), (8, 8),
                                     (16, 8)])
def test_eight_shards_take_the_largest_dividing_card_count(count, k):
    devs = shard_devices(8, "cuda", count)
    assert len(devs) == 8
    assert sorted({d.index for d in devs}) == list(range(k))
    # consecutive blocks of 8 // k shards, card by card
    assert [d.index for d in devs] == [s // (8 // k) for s in range(8)]
    assert all(d.type == "cuda" for d in devs)
    assert [(str(d), c) for d, _, c in device_runs(devs)] == [
        (f"cuda:{i}", 8 // k) for i in range(k)]


def test_shard_counts_other_than_eight():
    assert [d.index for d in shard_devices(6, "cuda", 4)] == [0, 0, 1, 1, 2, 2]
    assert [d.index for d in shard_devices(5, "cuda", 4)] == [0] * 5
    assert [d.index for d in shard_devices(2, "cuda", 8)] == [0, 1]


def test_a_named_card_keeps_every_shard():
    assert shard_devices(8, "cuda:1", 4) == (torch.device("cuda", 1),) * 8
    assert shard_devices(8, torch.device("cuda", 3), 8) == (
        torch.device("cuda", 3),) * 8


def test_the_cpu_keeps_every_shard():
    assert shard_devices(8, "cpu", 4) == (CPU,) * 8
    mesh = make_mesh(8, device="cpu")
    assert mesh.devices == (CPU,) * 8 and mesh.device == CPU
    assert mesh.cards == (CPU,)


def test_no_card_raises_and_never_falls_back():
    with pytest.raises(RuntimeError):
        shard_devices(8, "cuda", 0)
    missing = f"cuda:{torch.cuda.device_count() + 7}"
    with pytest.raises(RuntimeError):
        Mesh(8, (missing,) * 8)
    with pytest.raises(RuntimeError):
        make_mesh(devices=("cpu", missing) * 4)
    with pytest.raises(ValueError):
        Mesh(8, ("cpu",) * 7)


def test_explicit_devices_name_the_mesh():
    mesh = make_mesh(devices=("cpu",) * 8)
    assert mesh.n == 8 and mesh.devices == (CPU,) * 8
    assert mesh.local_devices == (CPU,) * 8
    ex = DistExecutor(tpch_catalog(sf=0.01), mesh=("cpu",) * 8,
                      device_cache=Session(device="cpu").cache)
    assert ex.mesh.devices == (CPU,) * 8 and ex.n == 8


# --- an explicit tuple answers as the default mesh ----------------------------


def _table(n=5000, seed=3):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-1000, 1000, n)
    valid = rng.random(n) > 0.1
    return HostTable.from_pydict({
        "k": rng.integers(0, 97, n).tolist(),
        "v": [int(x) if ok else None for x, ok in zip(vals, valid)],
        "f": rng.standard_normal(n).tolist(),
    })


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
        return
    assert repr(a.schema) == repr(b.schema) and a.device == b.device
    _same(a.data, b.data)
    assert [v is None for v in a.valid] == [v is None for v in b.valid]
    _same([v for v in a.valid if v is not None],
          [v for v in b.valid if v is not None])
    _same(a.sel_mask(), b.sel_mask())


def test_explicit_cpu_tuple_answers_as_the_default_mesh():
    ht = _table()
    outs = []
    for mesh in (make_mesh(8, device="cpu"), make_mesh(devices=("cpu",) * 8)):
        shards = shard_host_table(ht, mesh)
        assert placement_errors([shards], mesh) == []
        ranks = tuple(c.col("f")[0] for c in shards)
        outs.append((
            shards, all_gather_chunk(shards, mesh),
            shuffle_chunk(shards, (Col("k"),), mesh, 2048),
            range_partition_chunk(shards, ranks, mesh, 2048),
            mesh.psum([c.num_rows() for c in shards]),
            mesh.pmax([c.col("k")[0].max() for c in shards]),
        ))
    _same(outs[0], outs[1])


def test_replicas_copy_once_per_device_in_a_run():
    """Inside `replicas` a value reaches another device once (the meta
    device stands in for a second card); outside, every call copies; a
    value already on the device is itself."""
    mesh = make_mesh(devices=("cpu",) * 4)
    x = torch.arange(10)
    assert mesh.to(x, CPU) is x
    meta = torch.device("meta")
    assert mesh.to(x, meta) is not mesh.to(x, meta)
    with mesh.replicas():
        a = mesh.to(x, meta)
        with mesh.replicas():  # a nested run shares the outer copies
            assert mesh.to(x, meta) is a
        assert a.device == meta and a.shape == x.shape
    chunk = shard_host_table(_table(100), mesh)[0]
    assert mesh.to(chunk, CPU) is chunk
    with mesh.replicas():
        moved = mesh.to(chunk, meta)
        assert moved.device == meta
        assert all(t.device == meta for t in moved.data)
        assert mesh.to(chunk, meta).data[0] is moved.data[0]
    assert mesh._rep.memo is None


def test_chunk_from_host_places_each_shard_on_its_device():
    mesh = make_mesh(devices=("cpu",) * 2)
    shards = shard_host_table(_table(300), mesh)
    host = chunk_to_host(shards)
    meta = torch.device("meta")
    back = chunk_from_host(host, CPU, (CPU, meta))
    assert back[0].device == CPU and back[1].device == meta
    assert all(t.device == meta for t in back[1].data)
    assert chunk_from_host(chunk_to_host(shards[0]), CPU).device == CPU
    fake = types.SimpleNamespace(devices=(CPU, meta), local_devices=(CPU, meta),
                                 device=CPU, local=(0, 1))
    errs = placement_errors([back, back[0]], fake)
    assert errs == []
    assert placement_errors([(back[1], back[0])], fake)


def test_cluster_workers_get_cards_in_turn(monkeypatch):
    """A coordinator on a bare `cuda` names cuda:(i % cards) for its i-th
    worker, keeps a worker's card across a respawn, and a named card or
    the CPU gives every worker its own device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def runtime(device):
        return types.SimpleNamespace(
            _lock=lockdep.lock("test.cluster"), devices={},
            _boot_session=types.SimpleNamespace(device=torch.device(device)))

    rt = runtime("cuda")
    got = [ClusterRuntime.worker_device(rt, w) for w in ("w0", "w1", "w2")]
    assert got == ["cuda:0", "cuda:1", "cuda:0"]
    assert ClusterRuntime.worker_device(rt, "w1") == "cuda:1"
    rt = runtime("cuda:1")
    assert ClusterRuntime.worker_device(rt, "w0") == "cuda:1"
    rt = runtime("cpu")
    assert ClusterRuntime.worker_device(rt, "w3") == "cpu"


# --- against the JAX package's 8-device mesh ----------------------------------


@pytest.fixture()
def thresholds(eight_devices):
    old = [(m, m.SHARD_THRESHOLD_ROWS, m.SHUFFLE_AGG_MIN_GROUPS)
           for m in (D, JD)]
    for m in (D, JD):
        m.SHARD_THRESHOLD_ROWS = 10_000
        m.SHUFFLE_AGG_MIN_GROUPS = 4_000
    reset_knobs()
    yield
    for m, a, b in old:
        m.SHARD_THRESHOLD_ROWS, m.SHUFFLE_AGG_MIN_GROUPS = a, b


@pytest.fixture(scope="module")
def catalogs():
    return jax_tpch_catalog(sf=0.01), tpch_catalog(sf=0.01)


@pytest.mark.parametrize("q", sorted(DIST_QUERIES))
def test_explicit_eight_device_executor_matches_jax(catalogs, thresholds, q):
    jcat, tcat = catalogs
    want = JSession(jcat, dist_shards=8).sql(DIST_QUERIES[q]).rows()
    s = Session(tcat, device="cpu", dist_shards=8)
    s._dist_executor = DistExecutor(tcat, mesh=("cpu",) * 8,
                                    device_cache=s.cache)
    got = s.sql(DIST_QUERIES[q]).rows()
    assert s.last_profile.infos["n_shards"] == 8
    if q not in ORDERED:
        want, got = sorted(want, key=str), sorted(got, key=str)
    assert rows_match(got, want), f"{q}: {got[:3]} vs {want[:3]}"
    ex = s._dist_executor
    for _ir, scans_meta in ex._frag_ir_memo.values():
        assert placement_errors(ex._place(scans_meta), ex.mesh) == []
