"""The port's process mesh: one torch.distributed group over processes
(runtime.cluster.init_multihost), as jax.distributed spans one mesh over
processes. On the CPU:

- the backend rule `process_backend(cards, procs_on_host)`: NCCL where
  the host has cards and each process a card of its own, gloo otherwise;
- the global device map `process_devices`, from each rank's device;
- `Gloo` and `Nccl` on a two-process CPU gloo group (Nccl's collectives
  run where their tensors are: on the CPU here, over the gloo side), each
  equal to `InProcess` on the same seeded blocks: all_gather, all_to_all,
  psum, pmax and pmin over int64, float64 and bool, with 4 local shards
  (8 in all) and with 1 (2 in all). The float64 values are multiples of
  1/8 below 2^10, so a sum is exact in any order;
- the rows of the 2 x 4-shard process mesh at TPC-H SF 0.01 for a
  join-aggregate (Q3), a shuffle aggregate over (l_partkey, l_suppkey)
  and a top-N (N1), equal to the JAX package's Session(dist_shards=8) on
  the 8 virtual CPU devices of tests/conftest.py: integers exact, floats
  within 1e-6 relative.

The file is its own worker: `python tests/test_torch_process_mesh.py
SPEC` runs one rank (SPEC a JSON object: rank, procs, coord, device, sf,
queries, thresholds, out, and optionally host and knobs, the SET values
its queries run under) and pickles its record to `out`; `run_ranks`
starts the ranks, each with its own host name and environment where
asked (tests/test_torch_hosts.py's emulated hosts), and reads their
records. tests/test_torch_gpu.py runs the same ranks on the card, over
NCCL with a card each, over gloo sharing one card, and as emulated
hosts.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from starrocks_tpu_torch.parallel.mesh import process_devices
from starrocks_tpu_torch.runtime.cluster import process_backend

ROOT = Path(__file__).resolve().parents[1]
CLASSES = ("Gloo", "Nccl")
OPS = ("all_gather", "all_to_all", "psum", "pmax", "pmin")
DTYPES = ("int64", "float64", "bool")
LOCAL_SHARDS = (4, 1)
# the CPU tests' lowered thresholds at SF 0.01: lineitem, orders and
# customer shard, a group-by over (l_partkey, l_suppkey) takes the shuffle
THRESHOLDS = {"SHARD_THRESHOLD_ROWS": 10_000, "SHUFFLE_AGG_MIN_GROUPS": 4_000}
SHUFFLE_AGG = ("select l_partkey, l_suppkey, sum(l_quantity) q, count(*) c, "
               "avg(l_extendedprice) a from lineitem "
               "group by l_partkey, l_suppkey "
               "order by q desc, l_partkey, l_suppkey limit 20")
RANK_TIMEOUT_S = 240


def query_text(q: str) -> str:
    from starrocks_tpu_torch.storage.tpch_queries import DIST_QUERIES

    return SHUFFLE_AGG if q == "SA" else DIST_QUERIES[q]


# --- the ranks ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(device: str, sf: float, queries, procs: int = 2, env=None,
              timeout: float = RANK_TIMEOUT_S, hosts=None, envs=None,
              knobs=None):
    """Start `procs` ranks of this file's worker and wait for them (a rank
    past `timeout` is killed): (records, outputs, exit codes); a record is
    None where the rank wrote none. `env` is every rank's environment on
    top of this process's; `hosts` and `envs` give rank r its host name
    (init_multihost's `host=`) and its own environment on top of that;
    `knobs` the SET values the queries run under (default: `auto`)."""
    coord = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory(prefix="process_mesh_") as d:
        specs = [{"rank": r, "procs": procs, "coord": coord,
                  "device": device, "sf": sf, "queries": list(queries),
                  "thresholds": THRESHOLDS, "out": str(Path(d) / f"{r}.pkl"),
                  "host": hosts[r] if hosts else None, "knobs": knobs or {}}
                 for r in range(procs)]
        path = os.pathsep.join(
            [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])
        procs_ = [subprocess.Popen(
            [sys.executable, __file__, json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, **(env or {}), **(envs[r] if envs else {}),
                 "PYTHONPATH": path})
            for r, spec in enumerate(specs)]
        outs, rcs = [], []
        for p in procs_:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate(timeout=30)
            outs.append(out)
            rcs.append(p.returncode)
        recs = []
        for spec in specs:
            f = Path(spec["out"])
            recs.append(pickle.loads(f.read_bytes()) if f.exists() else None)
    return recs, outs, rcs


def _blocks(op: str, dtype: str, n: int, seed: int) -> list:
    """n seeded per-shard blocks: [n, C, 2] send buffers for all_to_all,
    [C, 2] blocks for all_gather, [G] vectors for the reductions."""
    shape = {"all_to_all": (n, 3, 2), "all_gather": (5, 2)}.get(op, (4,))
    ints = np.random.default_rng(seed).integers(-1000, 1000, (n, *shape))
    x = torch.from_numpy(ints)
    if dtype == "bool":
        x = x > 0
    elif dtype == "float64":
        x = x.double() / 8
    else:
        x = x * (1 << 40)  # past 32 bits
    return list(x)


def collective_case(coll, op: str, dtype: str, dev, seed: int) -> dict:
    """One collective of `coll` over this process's shards of seeded
    blocks on `dev`, against InProcess over every shard: {"equal": bool,
    "devices": [the results' devices]}."""
    from starrocks_tpu_torch.parallel.mesh import InProcess

    n = coll.n
    xs = [x.to(dev) for x in _blocks(op, dtype, n, seed)]
    mine = [xs[s] for s in coll.local]
    ref = InProcess(n)
    if op == "all_gather":
        got, want = [coll.all_gather(mine, dev)], [ref.all_gather(xs, dev)]
    elif op == "all_to_all":
        got = coll.all_to_all(mine, (dev,) * len(mine))
        every = ref.all_to_all(xs, (dev,) * n)
        want = [every[s] for s in coll.local]
    else:
        red = op[1:]
        got, want = [coll.reduce(mine, red, dev)], [ref.reduce(xs, red, dev)]
    equal = len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        for g, w in zip(got, want))
    return {"equal": equal, "devices": sorted({str(g.device) for g in got})}


def rank_main(spec: dict):
    """One rank: join the group, run every collective case over this
    process's shards, build the default mesh, run the SQL through
    Session(dist_shards=8), and pickle the record."""
    import torch.distributed as dist

    import starrocks_tpu_torch.sql.distributed as D
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.parallel import mesh as M
    from starrocks_tpu_torch.runtime.cluster import init_multihost
    from starrocks_tpu_torch.runtime.config import config
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import tpch_catalog

    torch.set_num_threads(1)
    procs, rank = spec["procs"], spec["rank"]
    init_multihost(spec["coord"], num_processes=procs, process_id=rank,
                   local_device_count=8 // procs, timeout_s=120,
                   host=spec.get("host"))
    dev = M.indexed_device(spec["device"])
    backend = M._PROCESS["backend"]
    # the NCCL class needs the group's NCCL side for tensors on a card
    classes = [c for c in CLASSES
               if c == "Gloo" or dev.type == "cpu" or backend == "nccl"]
    rec = {"backend": backend, "device": str(dev), "collectives": {},
           "rows": {}, "exchanges": {}, "cards": M._PROCESS["cards"]}
    for nl in LOCAL_SHARDS:
        for name in classes:
            coll = getattr(M, name)(nl * procs)
            for i, op in enumerate(OPS):
                for j, dtype in enumerate(DTYPES):
                    rec["collectives"][(name, op, dtype, nl)] = \
                        collective_case(coll, op, dtype, dev, 10 * i + j)
    for k, v in spec["thresholds"].items():
        setattr(D, k, v)
    for k, v in spec.get("knobs", {}).items():
        config.set(k, v)
    kernels.reset_counts()
    s = Session(tpch_catalog(sf=spec["sf"]), device=spec["device"],
                dist_shards=8)
    for q in spec["queries"]:
        rec["rows"][q] = s.sql(query_text(q)).rows()
        # the exchange kinds of the plans run so far
        rec["exchanges"][q] = sorted(
            {ev.kind for ir, _ in s._executor()._frag_ir_memo.values()
             for ev in ir.events})
    mesh = s._executor().mesh
    rec.update(mesh=repr(mesh), devices=[str(d) for d in mesh.devices],
               hosts=list(mesh.hosts), local=list(mesh.local),
               coll=type(mesh.coll).__name__,
               launches_per_card=kernels.launches_per_card())
    dist.barrier()
    dist.destroy_process_group()
    Path(spec["out"]).write_bytes(pickle.dumps(rec))
    print(f"rank {rank}: ok {rec['mesh']}", flush=True)


# --- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("cards, procs, want", [
    (0, 1, "gloo"), (0, 2, "gloo"), (1, 1, "nccl"), (1, 2, "gloo"),
    (2, 2, "nccl"), (4, 2, "nccl"), (4, 4, "nccl"), (2, 4, "gloo"),
    (8, 4, "nccl"), (4, 8, "gloo")])
def test_process_backend_rule(cards, procs, want):
    assert process_backend(cards, procs) == want


@pytest.mark.parametrize("ranks, n, want", [
    (["cuda:0", "cuda:1"], 8, ["cuda:0"] * 4 + ["cuda:1"] * 4),
    (["cuda:0", "cuda:0"], 8, ["cuda:0"] * 8),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], 8,
     [f"cuda:{s // 2}" for s in range(8)]),
    (["cuda:3", "cuda:2"], 2, ["cuda:3", "cuda:2"]),
    (["cpu", "cpu"], 8, ["cpu"] * 8),
    (["cpu", "cuda:1"], 4, ["cpu", "cpu", "cuda:1", "cuda:1"])])
def test_process_devices_map(ranks, n, want):
    assert process_devices(ranks, n) == tuple(map(torch.device, want))


def test_process_devices_refuse_an_uneven_split():
    with pytest.raises(ValueError, match="do not divide"):
        process_devices(["cpu"] * 3, 8)


@pytest.fixture(scope="module")
def cpu_ranks():
    recs, outs, rcs = run_ranks("cpu", 0.01, ("Q3", "SA", "N1"))
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in outs)
    return recs


@pytest.mark.parametrize("local", LOCAL_SHARDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("cls", CLASSES)
def test_collective_equals_in_process(cpu_ranks, cls, op, dtype, local):
    for rec in cpu_ranks:
        assert rec["collectives"][(cls, op, dtype, local)] == {
            "equal": True, "devices": ["cpu"]}


def test_cpu_process_mesh_takes_gloo_and_names_each_device(cpu_ranks):
    for r, rec in enumerate(cpu_ranks):
        assert rec["backend"] == "gloo" and rec["coll"] == "Gloo"
        assert rec["devices"] == ["cpu"] * 8
        assert rec["local"] == list(range(4 * r, 4 * r + 4))
        assert "backend=gloo" in rec["mesh"]
    assert "hash" in cpu_ranks[0]["exchanges"]["SA"]


@pytest.fixture(scope="module")
def jax_rows(eight_devices):
    import starrocks_tpu.sql.distributed as JD
    from starrocks_tpu.runtime.session import Session as JSession
    from starrocks_tpu.storage.catalog import tpch_catalog as jax_catalog

    from torch_tpch_parity import reset_knobs

    old = {k: getattr(JD, k) for k in THRESHOLDS}
    try:
        for k, v in THRESHOLDS.items():
            setattr(JD, k, v)
        reset_knobs()
        s = JSession(jax_catalog(sf=0.01), dist_shards=8)
        return {q: s.sql(query_text(q)).rows() for q in ("Q3", "SA", "N1")}
    finally:
        for k, v in old.items():
            setattr(JD, k, v)


@pytest.mark.parametrize("q", ["Q3", "SA", "N1"])
def test_process_mesh_rows_match_jax_mesh(cpu_ranks, jax_rows, q):
    from torch_tpch_parity import rows_match

    want = jax_rows[q]
    assert want
    for rec in cpu_ranks:
        got = rec["rows"][q]
        if q == "Q3":  # ORDER BY revenue, o_orderdate leaves ties unordered
            got, want = sorted(got, key=str), sorted(want, key=str)
        assert rows_match(got, want), f"{q}: {got[:3]} vs {want[:3]}"


if __name__ == "__main__":
    rank_main(json.loads(sys.argv[1]))
