"""The kernel wrappers' counts stay exact when the serving tier runs
statements from several threads: `calls`, `launches`, `shapes` and the hash
probe's per-route counts move under one lock (ops/kernels.py). On the CPU a
wrapper takes its plain version, so the threads here count calls through
the real wrappers, and launches through the one function every wrapper
counts a launch with."""

import threading

import numpy as np
import pytest
import torch

from starrocks_tpu_torch import lockdep
from starrocks_tpu_torch.ops import kernels
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.catalog import tpch_catalog
from starrocks_tpu_torch.storage.tpch_queries import QUERIES, STAT_QUERIES

THREADS = 4


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness."""
    yield
    cycles = lockdep.WITNESS.order_cycles()
    assert not cycles, lockdep.WITNESS.render(cycles)


def _in_threads(fn, n: int = THREADS):
    errors = []
    start = threading.Barrier(n)

    def body(i):
        try:
            start.wait()
            fn(i)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    ths = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    assert not errors, errors[:2]


def test_calls_from_four_threads_sum_exactly():
    rng = np.random.default_rng(7)
    gid = torch.from_numpy(rng.integers(0, 8, 4096).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((4096, 2)).astype(np.float32))
    build = torch.from_numpy(np.sort(rng.integers(0, 1 << 40, 2048)))
    probe = torch.from_numpy(rng.integers(0, 1 << 40, 1024))
    per_thread = 200
    kernels.reset_counts()

    def work(i):
        for _ in range(per_thread):
            kernels.segment_sum(gid, vals, 8, 1024)
            kernels.probe_searchsorted(build, probe)

    _in_threads(work)
    got = kernels.counts()
    assert got["segment_sum"]["calls"] == THREADS * per_thread
    assert got["probe_searchsorted"]["calls"] == THREADS * per_thread
    assert kernels.segment_sum.shapes == {(4096, 2, 8, 1024)}
    kernels.reset_counts()


def test_launch_counts_from_four_threads_sum_exactly():
    per_thread = 5000
    kernels.reset_counts()

    def work(i):
        for _ in range(per_thread):
            kernels._launched(kernels.topn_select)
            kernels._launched(kernels.hash_probe, "direct")

    _in_threads(work)
    assert kernels.topn_select.launches == THREADS * per_thread
    assert kernels.hash_probe.launches == THREADS * per_thread
    assert kernels.hash_probe.routes["direct"] == THREADS * per_thread
    kernels.reset_counts()


def test_concurrent_sessions_count_what_one_thread_counts():
    """S1 (segment_sum under `pallas`) and Q9 (probe_searchsorted under
    `pallas_sorted`) from four threads at once: each kernel's calls are
    four times one thread's, and every thread's rows are the one thread's."""
    cat = tpch_catalog(sf=0.01)
    knobs = {"segment_strategy": "pallas",
             "join_probe_strategy": "pallas_sorted"}
    from starrocks_tpu_torch.runtime.config import config

    prev = {k: config.get(k) for k in knobs}
    for k, v in knobs.items():
        config.set(k, v)
    try:
        texts = [STAT_QUERIES["S1"], QUERIES[9]]
        warm = Session(cat, device="cpu")
        for q in texts:
            warm.sql(q)
        kernels.reset_counts()
        want = [warm.sql(q).rows() for q in texts]
        one = {n: c["calls"] for n, c in kernels.counts().items()}
        assert one["segment_sum"] > 0 and one["probe_searchsorted"] > 0
        sessions = [Session(cat, device="cpu") for _ in range(THREADS)]
        for s in sessions:  # each session's cold capacities learned
            for q in texts:
                s.sql(q)
        kernels.reset_counts()
        rows = {}

        def work(i):
            rows[i] = [sessions[i].sql(q).rows() for q in texts]

        _in_threads(work)
        got = {n: c["calls"] for n, c in kernels.counts().items()}
        assert got == {n: THREADS * v for n, v in one.items()}
        assert all(rows[i] == want for i in range(THREADS))
    finally:
        for k, v in prev.items():
            config.set(k, v)
        kernels.reset_counts()
