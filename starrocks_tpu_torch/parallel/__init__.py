"""Mesh parallelism: sharding, exchange collectives, distributed operators.

Reference: the fragment/exchange machinery (SURVEY §2.4) — fragments over
BEs -> one program in lockstep over a tuple of per-shard Chunks (mesh.py);
bRPC transmit_chunk -> all_to_all / all_gather over the shard tuple
(exchange.py), in process or across processes: staged through host memory
over gloo, or on the device tensors over NCCL where each process has a
card of its own.
"""

from .dist_ops import BROADCAST, SHUFFLE, broadcast_join, dist_aggregate
from .exchange import all_gather_chunk, range_partition_chunk, shuffle_chunk
from .mesh import (
    DATA_AXIS, Mesh, make_mesh, mesh_spans_processes, shard_host_table,
)

__all__ = [
    "BROADCAST", "SHUFFLE", "DATA_AXIS", "Mesh",
    "all_gather_chunk", "broadcast_join", "dist_aggregate", "make_mesh",
    "mesh_spans_processes", "range_partition_chunk", "shard_host_table",
    "shuffle_chunk",
]
