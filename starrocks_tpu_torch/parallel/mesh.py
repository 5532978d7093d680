"""The shard mesh and the collectives behind it.

Reference behavior: plan fragments get N instances across BEs with scan
ranges assigned by locality (fe qe/CoordinatorPreprocessor.java:70,
BackendSelector). The JAX package runs one SPMD program over a
jax.sharding.Mesh; this port runs the same program in LOCKSTEP over a tuple
of per-shard Chunks:

- a SHARDED value is a tuple of the shards this process holds, one Chunk
  each, all on the Session's device; a REPLICATED value is one Chunk, held
  once (the JAX program computes it redundantly on every shard);
- the collectives go through one small interface with two implementations:
  `InProcess` (every shard in this process, on one device: NCCL will not
  put two ranks on one GPU) and `Gloo` (a
  torch.distributed process group spanning processes, set up by
  `runtime.cluster.init_multihost`; each process holds its slice of the
  shards and stages device tensors through host memory, the transport gloo
  runs on).

Collective inputs are lists of the LOCAL shards' tensors, in shard order.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..column.column import Chunk, pad_capacity

DATA_AXIS = "d"  # the mesh's one axis (the JAX package's name)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """bool lanes travel as uint8 (gloo has no bool reductions)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


class InProcess:
    """Every shard in this process: the collectives are plain torch ops
    over the shard tuple."""

    world = 1
    rank = 0

    def __init__(self, n_shards: int):
        self.n = n_shards
        self.local = tuple(range(n_shards))

    def all_gather(self, xs) -> torch.Tensor:
        """lax.all_gather(tiled=True): the shards concatenated in order."""
        return torch.cat(list(xs))

    def all_to_all(self, xs) -> list:
        """lax.all_to_all(split_axis=0, concat_axis=0, tiled=False) over
        [n, C, ...] send buffers: shard j receives block (i, j) from every
        source i, in order of i, as one [n*C, ...] tensor."""
        n = self.n
        return [torch.cat([xs[i][j] for i in range(n)]) for j in range(n)]

    def reduce(self, xs, op: str) -> torch.Tensor:
        return _reduce_stack(torch.stack(list(xs)), op)


def _reduce_stack(s: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sum":
        return s.sum(0)
    if op == "max":
        return s.max(0).values if s.ndim > 1 else s.max()
    if op == "min":
        return s.min(0).values if s.ndim > 1 else s.min()
    raise ValueError(op)


class Gloo:
    """A torch.distributed process group over gloo: `world` processes, each
    holding n / world consecutive shards. Every collective copies its
    device tensors to host memory, runs there and copies the result back
    (gloo's collectives run on CPU tensors)."""

    def __init__(self, n_shards: int, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if n_shards % self.world:
            raise ValueError(
                f"{n_shards} shards do not divide over {self.world} processes")
        self.n = n_shards
        nl = n_shards // self.world
        self.local = tuple(range(self.rank * nl, (self.rank + 1) * nl))

    def all_gather(self, xs) -> torch.Tensor:
        dev = xs[0].device
        mine = _wire(torch.cat(list(xs))).cpu()
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        self._dist.all_gather(parts, mine, group=self.group)
        out = torch.cat(parts)
        if xs[0].dtype == torch.bool:
            out = out.to(torch.bool)
        return out.to(dev)

    def all_to_all(self, xs) -> list:
        nl, w = len(self.local), self.world
        dev, dtype = xs[0].device, xs[0].dtype
        block = xs[0].shape[1:]  # [C, ...]
        # send[p, i, j]: local source i's block for global shard p*nl + j
        send = torch.stack([_wire(x).cpu().reshape((w, nl) + block)
                            for x in xs], 1).contiguous()
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send, group=self.group)
        # recv[q, i, j]: global source q*nl + i's block for local shard j
        out = []
        for j in range(nl):
            r = recv[:, :, j].reshape((self.n * block[0],) + block[1:])
            if dtype == torch.bool:
                r = r.to(torch.bool)
            out.append(r.to(dev))
        return out

    def reduce(self, xs, op: str) -> torch.Tensor:
        dev, dtype = xs[0].device, xs[0].dtype
        mine = _wire(_reduce_stack(torch.stack(list(xs)), op)).cpu().clone()
        rop = {"sum": self._dist.ReduceOp.SUM, "max": self._dist.ReduceOp.MAX,
               "min": self._dist.ReduceOp.MIN}[op]
        self._dist.all_reduce(mine, op=rop, group=self.group)
        return mine.to(dtype).to(dev)


class Dry:
    """Shard 0 alone standing in for n shards, with collectives that give
    the right SHAPES (the fragment-IR derivation runs the program once this
    way: the exchange set depends on placements, dtypes and estimates,
    never on values, and the capacities of shard 0 are every shard's)."""

    world = 1
    rank = 0

    def __init__(self, n_shards: int):
        self.n = n_shards
        self.local = (0,)

    def all_gather(self, xs) -> torch.Tensor:
        return torch.cat(list(xs) * self.n)

    def all_to_all(self, xs) -> list:
        x = xs[0]
        return [x.reshape((self.n * x.shape[1],) + tuple(x.shape[2:]))]

    def reduce(self, xs, op: str) -> torch.Tensor:
        return xs[0]


class Mesh:
    """n shards on one device. `coll` is the collective backend; `local`
    the global ids of the shards this process holds. `moves` counts each
    collective's calls and the per-shard capacities it moved (a test hook:
    the JAX package's tests read the same facts from HLO)."""

    def __init__(self, n_shards: int, device, coll=None):
        self.n = int(n_shards)
        self.device = torch.device(device)
        self.coll = coll if coll is not None else InProcess(self.n)
        if self.coll.n != self.n:
            raise ValueError("collective backend sized for another mesh")
        self.local = self.coll.local
        self.moves: dict = {}
        # per-thread observer of the reductions (analysis/trace_check.py's
        # counter audit of a program's first run)
        self._obs = threading.local()

    def note_move(self, kind: str, rows: int):
        moved = self.moves.setdefault(kind, [])
        if len(moved) < 1024:  # bounded: a long-lived mesh keeps no log
            moved.append(int(rows))

    def reset_moves(self):
        self.moves = {}

    # reductions over a per-shard sequence (psum / pmax / pmin)
    def psum(self, xs):
        return self._reduce(xs, "sum")

    def pmax(self, xs):
        return self._reduce(xs, "max")

    def pmin(self, xs):
        return self._reduce(xs, "min")

    def _reduce(self, xs, op: str):
        xs = list(xs)
        out = self.coll.reduce(xs, op)
        fn = getattr(self._obs, "fn", None)
        if fn is not None:
            fn(op, len(xs), len(self.local), out)
        return out

    @contextlib.contextmanager
    def observing(self, fn):
        """Call fn(op, shards reduced, shards held, result) for every
        reduction this thread makes while the context is open."""
        prev = getattr(self._obs, "fn", None)
        self._obs.fn = fn
        try:
            yield
        finally:
            self._obs.fn = prev

    def host_max(self, vals: dict) -> dict:
        """Merge {key: int} maxima of this process's shards across
        processes (one collective); identity on a one-process mesh."""
        if self.coll.world == 1 or not vals:
            return vals
        keys = sorted(vals)
        t = torch.tensor([int(vals[k]) for k in keys], dtype=torch.int64)
        t = self.coll.reduce([t], "max")
        return dict(zip(keys, t.tolist()))

    def __repr__(self):
        return (f"Mesh(n={self.n}, local={self.local}, device={self.device}, "
                f"{type(self.coll).__name__})")


# multi-process state set by runtime.cluster.init_multihost
_PROCESS = {"local_shards": None}


def make_mesh(n_devices: int | None = None, *, device) -> Mesh:
    """A mesh of n shards on `device`, which the caller names (a Session
    passes its own). After `cluster.init_multihost` the mesh spans every
    process of the group (n defaults to processes x local shards);
    otherwise every shard lives in this process (n is required)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        per = _PROCESS["local_shards"] or 1
        n = n_devices or per * dist.get_world_size()
        return Mesh(n, device, Gloo(n))
    if not n_devices:
        raise ValueError("an in-process mesh needs its shard count")
    return Mesh(n_devices, device, InProcess(n_devices))


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when the mesh's shards live in more than one process."""
    return mesh.coll.world > 1


def shard_host_table(table, mesh: Mesh):
    """Row-shard a HostTable: every shard gets equal capacity
    pad_capacity(ceil(rows / n)), rows in order, the tail padded; the
    selection mask marks the real rows. Returns this process's shards."""
    n = mesh.n
    rows = table.num_rows
    local_cap = pad_capacity((rows + n - 1) // n)
    chunk = table.to_chunk(capacity=local_cap * n, device=mesh.device)
    sel = chunk.sel_mask()
    out = []
    for s in mesh.local:
        lo, hi = s * local_cap, (s + 1) * local_cap
        out.append(Chunk(
            chunk.schema, tuple(d[lo:hi] for d in chunk.data),
            tuple(None if v is None else v[lo:hi] for v in chunk.valid),
            sel[lo:hi], mesh.device))
    return tuple(out)


def hash_layout(keys: np.ndarray, n: int):
    """Colocate placement of rows by the splitmix64 bucket of an integer
    key (the device shuffle's recipe): (row order, rows per shard)."""
    from .. import native

    bucket = native.hash_partition_i64(
        np.asarray(keys, dtype=np.int64), n)
    order, offsets = native.bucket_order(bucket, n)  # a stable argsort
    return order, np.diff(offsets)
