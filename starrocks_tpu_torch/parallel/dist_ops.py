"""Distributed operator patterns composed from local ops + exchange.

Reference behavior mapping (SURVEY §2.4):
- two-phase aggregation (local partial -> exchange -> final) mirrors the
  reference's two-phase agg split chosen by the optimizer enforcers
  (fe sql/optimizer/ChildOutputPropertyGuarantor.java);
- broadcast join = all_gather the build side (UNPARTITIONED exchange);
- shuffle join   = hash-partition both sides onto the mesh, local join.
A port of the JAX package's parallel/dist_ops.py over the shard tuple.
"""

from __future__ import annotations

import torch

from ..exprs.ir import Col
from ..ops.aggregate import FINAL, PARTIAL, final_agg_exprs, hash_aggregate
from ..ops.common import compact
from ..ops.join import hash_join_unique
from .exchange import all_gather_chunk, shuffle_chunk

BROADCAST = "broadcast"
SHUFFLE = "shuffle"


def dist_aggregate(local_chunks, group_by, aggs, mesh, partial_groups: int,
                   final_groups: int, via: str = BROADCAST,
                   bucket_capacity: int | None = None):
    """Distributed grouped aggregation over this process's shards.

    via=BROADCAST: all_gather the partial states (right when the group
    count is small, e.g. TPC-H Q1's 4 groups); the final result is
    REPLICATED — one Chunk, computed once.
    via=SHUFFLE: hash-partition the partial states by group key so each
    shard finalizes its own key range (high-cardinality group-bys); the
    output is a tuple of per-shard Chunks.
    Returns (final, ngroups, max_bucket, partial_ngroups): ngroups per the
    output's placement, max_bucket (zeros for BROADCAST) and
    partial_ngroups per shard — the host checks max_bucket <=
    bucket_capacity and partial_ngroups <= partial_groups."""
    parts = [hash_aggregate(c, group_by, aggs, partial_groups, mode=PARTIAL)
             for c in local_chunks]
    partial_ng = tuple(ng for _, ng in parts)
    key_cols = tuple(Col(name) for name, _ in group_by)
    final_group_by = tuple((name, Col(name)) for name, _ in group_by)
    final_aggs = final_agg_exprs(aggs)
    if via == BROADCAST:
        merged = all_gather_chunk([p for p, _ in parts], mesh)
        out, ng = hash_aggregate(merged, final_group_by, final_aggs,
                                 final_groups, mode=FINAL)
        zeros = tuple(torch.zeros((), dtype=torch.int64, device=p.device)
                      for p, _ in parts)
        return out, ng, zeros, partial_ng
    cap = bucket_capacity or max(partial_groups, 16)
    merged, max_bucket = shuffle_chunk([p for p, _ in parts], key_cols, mesh,
                                       cap)
    finals = [hash_aggregate(m, final_group_by, final_aggs, final_groups,
                             mode=FINAL) for m in merged]
    return (tuple(o for o, _ in finals), tuple(ng for _, ng in finals),
            max_bucket, partial_ng)


def broadcast_join(probe_chunks, build_chunks, probe_keys, build_keys, mesh,
                   join_type: str = "inner", payload=None, bit_widths=None,
                   build_capacity: int | None = None):
    """Replicate the (small) build side to every shard, then join locally.

    The reference analog: UNPARTITIONED exchange on the build side of a
    broadcast HashJoin fragment. With build_capacity set, the gathered
    build side is compacted down to that capacity. Returns (per-shard
    joined chunks, build_rows): the host checks build_rows <=
    build_capacity (when set) or build rows were dropped."""
    build_all = all_gather_chunk(build_chunks, mesh)
    build_n = build_all.num_rows()
    if build_capacity is not None:
        build_all, build_n = compact(build_all, build_capacity)
    # the build side once on each device of the probe's shards
    with mesh.replicas():
        joined = tuple(
            hash_join_unique(p, mesh.to(build_all, dev), probe_keys,
                             build_keys, join_type, payload=payload,
                             bit_widths=bit_widths)
            for p, dev in zip(probe_chunks, mesh.local_devices))
    return joined, build_n
