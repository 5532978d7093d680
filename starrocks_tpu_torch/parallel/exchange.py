"""Exchange: data movement between mesh shards.

Reference behavior: ExchangeSinkOperator -> SinkBuffer -> bRPC
transmit_chunk -> DataStreamMgr -> ExchangeSourceOperator
(be/src/exec/pipeline/exchange/exchange_sink_operator.h:47), with the
partition strategies UNPARTITIONED (broadcast/gather), HASH_PARTITIONED and
RANGE. The JAX package compiles them into collectives over the device
axis; here they are plain torch ops over the shard tuple (parallel/mesh.py),
with the same row order as the JAX collectives:

- broadcast / gather       -> all_gather: the shards concatenated in order
- hash partition (shuffle) -> bucket + pad + all_to_all: shard j receives
  block (i, j) from every source i, in order of i
- skew shows up as padding, handled by a bucket capacity and a true-count
  overflow check the host reacts to (the adaptive-dop analog).

Every function takes the per-shard Chunks this process holds (a tuple, in
shard order, shard j on the mesh's `local_devices[j]`) and the Mesh. A
gathered result lands on the home device; each receiver of a HASH or RANGE
exchange gets its rows on its own device.
"""

from __future__ import annotations

import torch

from ..column.column import Chunk
from ..ops.common import (
    GOLDEN, argsort_stable, eval_keys, mix64, scatter_set, shr64,
)


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """Unsigned remainder of int64-held uint64 lanes by a small n."""
    return ((shr64(x, 1) % n) * 2 + (x & 1)) % n


def _col(xs, fill, devs):
    """One column over the shards: None when every shard has None, else
    each shard's tensor (a None shard materialized as `fill` on its
    shard's device, `devs`)."""
    if all(x is None for x in xs):
        return None
    like = next(x for x in xs if x is not None)
    return [torch.full(like.shape, fill, dtype=like.dtype, device=d)
            if x is None else x for x, d in zip(xs, devs)]


def all_gather_chunk(chunks, mesh) -> Chunk:
    """Every shard receives all rows (UNPARTITIONED/broadcast exchange):
    local capacity C -> one REPLICATED Chunk of capacity n*C."""
    chunks = tuple(chunks)
    c0 = chunks[0]
    mesh.note_move("all_gather", c0.capacity)
    devs = mesh.local_devices
    data = tuple(mesh.all_gather([c.data[i] for c in chunks])
                 for i in range(len(c0.data)))
    valid = []
    for i in range(len(c0.valid)):
        v = _col([c.valid[i] for c in chunks], True, devs)
        valid.append(None if v is None else mesh.all_gather(v))
    sel = mesh.all_gather([c.sel_mask() for c in chunks])
    return Chunk(c0.schema, data, tuple(valid), sel, mesh.device)


def shuffle_bucket(chunk: Chunk, key_exprs, n_shards: int) -> torch.Tensor:
    """Destination shard of each row: hash(keys) % n; dead rows carry n.
    NULL keys hash like a value (-1), so group-by-NULL still works."""
    live = chunk.sel_mask()
    keys = eval_keys(chunk, key_exprs)
    mix = torch.zeros((chunk.capacity,), dtype=torch.int64,
                      device=chunk.device)
    for k in keys:
        kd = k.data.to(torch.int64)
        if k.valid is not None:
            kd = torch.where(k.valid, kd, -1)
        mix = mix64(mix ^ (kd * GOLDEN))
    bucket = _umod(mix, n_shards).to(torch.int32)
    return torch.where(live, bucket, n_shards)


def shuffle_chunk(chunks, key_exprs, mesh, bucket_capacity: int,
                  bit_widths=None):
    """HASH_PARTITIONED exchange: rows travel to shard hash(key) % n.

    Returns (chunks_out, max_bucket_count): each shard's received rows at
    capacity n * bucket_capacity (dead slots masked), and per shard the
    largest bucket's row count BEFORE padding — the host checks it against
    bucket_capacity (else reruns bigger)."""
    buckets = [shuffle_bucket(c, key_exprs, mesh.n) for c in chunks]
    return _exchange_by_bucket(chunks, buckets, mesh, bucket_capacity)


def _exchange_by_bucket(chunks, buckets, mesh, bucket_capacity: int):
    """Route each live row to shard `bucket[row]` (dead rows carry n):
    stable-pack the rows of each destination, pad to bucket_capacity, one
    all_to_all per column. Shared tail of the HASH and RANGE exchanges."""
    chunks = tuple(chunks)
    n = mesh.n
    out_cap = n * bucket_capacity
    dests, orders, oks, maxes = [], [], [], []
    for c, bucket in zip(chunks, buckets):
        order = argsort_stable(bucket)
        b_sorted = bucket[order].to(torch.int64)
        counts = torch.bincount(bucket.to(torch.int64), minlength=n + 1)[:n]
        starts = torch.cumsum(counts, 0) - counts
        pos = (torch.arange(c.capacity, device=c.device)
               - starts[b_sorted.clamp(0, n - 1)])
        ok = (b_sorted < n) & (pos < bucket_capacity)
        # not-ok rows (dead / bucket overflow) go out of bounds: dropped
        dests.append(torch.where(ok, b_sorted * bucket_capacity + pos,
                                 out_cap))
        orders.append(order)
        oks.append(ok)
        maxes.append(counts.max())
    c0 = chunks[0]
    mesh.note_move("all_to_all", out_cap)

    def a2a(cols, fill, sorted_already=False):
        # wide [cap, W] columns route row-wise: dest indexes the rows
        bufs = [scatter_set(out_cap, d, x if sorted_already else x[o], fill,
                            x.dtype).reshape(
                    (n, bucket_capacity) + tuple(x.shape[1:]))
                for x, d, o in zip(cols, dests, orders)]
        return mesh.all_to_all(bufs)

    devs = mesh.local_devices
    data = [a2a([c.data[i] for c in chunks], 0) for i in range(len(c0.data))]
    valid = []
    for i in range(len(c0.valid)):
        v = _col([c.valid[i] for c in chunks], True, devs)
        valid.append(None if v is None else a2a(v, False))
    sel = a2a(oks, False, sorted_already=True)
    out = tuple(
        Chunk(c0.schema, tuple(d[j] for d in data),
              tuple(None if v is None else v[j] for v in valid), sel[j],
              devs[j])
        for j in range(len(sel)))
    return out, tuple(maxes)


def range_partition_chunk(chunks, ranks, mesh, bucket_capacity: int,
                          sample_per_shard: int = 64):
    """RANGE exchange: rows travel to shards by sampled splitters of `ranks`
    (one totally-ordered sort key per row and shard; dead rows may hold
    anything). Afterwards shard i's live rows all rank <= shard i+1's, so a
    local sort per shard gives GLOBAL order across the shards (the merge-
    path sort analog, be/src/compute_env/sorting/merge_path.h). Same
    (chunks_out, max_bucket_count) contract as shuffle_chunk."""
    chunks = tuple(chunks)
    rs, samples = [], []
    for c, rank in zip(chunks, ranks):
        live = c.sel_mask()
        big = (float("inf") if rank.is_floating_point()
               else torch.iinfo(rank.dtype).max)
        r = torch.where(live, rank, torch.tensor(big, dtype=rank.dtype,
                                                 device=rank.device))
        srt = torch.sort(r).values
        n_live = live.sum(dtype=torch.int64)
        idx = (torch.arange(sample_per_shard, device=c.device)
               * torch.clamp(n_live, min=1)) // sample_per_shard
        samples.append(srt[idx.clamp(0, c.capacity - 1)])
        rs.append(r)
    # every shard sees every sample: all derive IDENTICAL splitters (empty
    # shards contribute `big`, a balance issue only)
    ss = torch.sort(mesh.all_gather(samples)).values
    n = mesh.n
    total = n * sample_per_shard
    pick = (torch.arange(1, n, device=ss.device) * total) // n
    splitters = ss[pick].contiguous()
    buckets = []
    for c, r in zip(chunks, rs):
        b = torch.searchsorted(mesh.to(splitters, r.device), r.contiguous(),
                               side="left")
        buckets.append(torch.where(c.sel_mask(), b.to(torch.int32), n))
    return _exchange_by_bucket(chunks, buckets, mesh, bucket_capacity)
