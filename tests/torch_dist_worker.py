"""Worker process of the port's two-process mesh tests.

Launched twice by tests/test_torch_dist_fragments.py and
tests/test_torch_cluster.py: `python tests/torch_dist_worker.py <pid>
<host:port> [<monitor port>]`. Each process joins one gloo process group
(cluster.init_multihost: 2 processes x 4 shards = an 8-shard mesh), beats
into the test's ClusterMonitor when given its port, and checks against the
contract, on the CPU:

1. a shuffle-aggregate over the process-spanning mesh: hash-partition a
   seeded table, aggregate per shard, psum — equal to a numpy oracle;
2. the same SQL through Session(dist_shards=8) with the fragment executor
   and monolithically: this process materializes only its 4 shards, the
   hash exchange and the counter sums cross the process boundary — the
   rows equal an in-process 8-shard mesh's.

Prints one line `proc <pid>: ... ok=True ...` per check; exits 3 on a
failed check. `run_two_processes` starts both ranks for a test.
"""

import os
import socket
import subprocess
import sys

import numpy as np


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_two_processes(extra=(), timeout=240):
    """Both ranks of tests/torch_dist_worker.py; (outputs, exit codes).
    Every wait is bounded; a rank past its time is killed."""
    worker = os.path.abspath(__file__)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), coord, *map(str, extra)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs, rcs = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate(timeout=30)
        outs.append(out)
        rcs.append(p.returncode)
    return outs, rcs


def main():
    pid = int(sys.argv[1])
    coord = sys.argv[2]
    mon_port = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from starrocks_tpu_torch.runtime.cluster import Heartbeater, init_multihost

    shards = init_multihost(coord, num_processes=2, process_id=pid,
                            local_device_count=4)
    assert len(shards) == 8, shards
    hb = None
    if mon_port:
        hb = Heartbeater("127.0.0.1", mon_port, f"worker-{pid}",
                         interval_s=0.1)

    from starrocks_tpu_torch.column import HostTable
    from starrocks_tpu_torch.exprs.ir import Col
    from starrocks_tpu_torch.parallel import (
        make_mesh, mesh_spans_processes, shard_host_table, shuffle_chunk,
    )

    mesh = make_mesh(device="cpu")
    ok_all = True

    # 1. shuffle-aggregate: every row reaches the shard of its key
    total = 8 * 16
    keys = (np.arange(total, dtype=np.int64) * 7) % 5
    vals = np.arange(total, dtype=np.float64)
    ht = HostTable.from_pydict({"k": keys, "v": vals})
    local = shard_host_table(ht, mesh)
    moved, _mx = shuffle_chunk(local, (Col("k"),), mesh, 64)
    part = torch.zeros(5, dtype=torch.float64)
    for c in moved:
        k, v, live = c.data[0], c.data[1], c.sel_mask()
        part.index_add_(0, k[live], v[live])
    sums = mesh.psum([part])
    expected = np.array([vals[keys == g].sum() for g in range(5)])
    ok = (mesh_spans_processes(mesh) and mesh.local == tuple(
        range(4 * pid, 4 * pid + 4)) and np.allclose(sums.numpy(), expected))
    print(f"proc {pid}: shuffle-agg ok={ok} totals={sums.tolist()}",
          flush=True)
    ok_all &= ok

    # 2. SQL over the process-spanning mesh against an in-process one
    import starrocks_tpu_torch.sql.distributed as D
    from starrocks_tpu_torch.parallel.mesh import Mesh
    from starrocks_tpu_torch.runtime.config import config
    from starrocks_tpu_torch.runtime.dist_executor import DistExecutor
    from starrocks_tpu_torch.runtime.executor import DeviceCache
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import tpch_catalog

    D.SHARD_THRESHOLD_ROWS = 10_000
    D.SHUFFLE_AGG_MIN_GROUPS = 100
    cat = tpch_catalog(sf=0.01)
    sess = Session(cat, device="cpu", dist_shards=8)
    sql = ("select l_suppkey, l_linestatus, sum(l_quantity) q "
           "from lineitem group by l_suppkey, l_linestatus "
           "order by q desc, l_suppkey, l_linestatus limit 5")
    config.set("dist_fragments", True)
    rows = sess.sql(sql).rows()
    config.set("dist_fragments", False)
    rows_mono = sess.sql(sql).rows()
    config.set("dist_fragments", True)
    total_q = sess.sql("select sum(l_quantity) t from lineitem").rows()[0][0]
    local_ex = DistExecutor(cat, mesh=Mesh(8, "cpu"),
                            device_cache=DeviceCache("cpu"))
    from starrocks_tpu_torch.sql.analyzer import Analyzer
    from starrocks_tpu_torch.sql.parser import parse

    want = local_ex.execute_logical(
        Analyzer(cat).analyze(parse(sql))).rows()
    de = sess._dist_executor
    kinds = sorted({ev.kind for (ir, _) in de._frag_ir_memo.values()
                    for ev in ir.events})
    expected_q = float(np.asarray(
        cat.get_table("lineitem").table.arrays["l_quantity"]).sum()) / 100
    ok = (rows == rows_mono == want and len(rows) == 5
          and abs(float(total_q) - expected_q) < 1e-6 * expected_q
          and "hash" in kinds and mesh_spans_processes(de.mesh))
    print(f"proc {pid}: sql ok={ok} spans_processes="
          f"{mesh_spans_processes(de.mesh)} exchange_kinds={kinds} "
          f"rows={rows}", flush=True)
    ok_all &= ok
    if hb is not None:
        import time

        time.sleep(0.5)  # let the monitor see both workers beat
        hb.stop()
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    if not ok_all:
        sys.exit(3)


if __name__ == "__main__":
    main()
