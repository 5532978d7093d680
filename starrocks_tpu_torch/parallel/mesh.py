"""The shard mesh and the collectives behind it.

Reference behavior: plan fragments get N instances across BEs with scan
ranges assigned by locality (fe qe/CoordinatorPreprocessor.java:70,
BackendSelector). The JAX package runs one SPMD program over a
jax.sharding.Mesh; this port runs the same program in LOCKSTEP over a tuple
of per-shard Chunks:

- the mesh holds one device per shard (`Mesh.devices`, the counterpart of
  the JAX Mesh's device array). A Session on `cuda` spreads its shards
  over the visible cards in consecutive blocks (`shard_devices`); on one
  card, on `cuda:<i>` or on the CPU every shard shares one device;
- a SHARDED value is a tuple of the shards this process holds, one Chunk
  each, shard s on `devices[s]`; a REPLICATED value is one Chunk on the
  home device (`Mesh.device`, shard 0's), held once (the JAX program
  computes it redundantly on every shard). A per-shard op that takes a
  REPLICATED input reads a copy on its shard's device: `Mesh.to`, one
  copy per device and value for a program's run (`Mesh.replicas`);
- the collectives go through one small interface with three
  implementations: `InProcess` (every shard in this process, on its own
  device: blocks travel between cards as blocking peer copies), and over
  a torch.distributed process group spanning processes on one host or
  several, set up by `runtime.cluster.init_multihost` (as jax.distributed
  spans one mesh over a pod's hosts, each process holding its host's
  chips) either `Gloo`, which stages device tensors through host memory,
  the transport gloo runs on, or `Nccl`, whose collectives run on the
  device tensors where they are, over NCCL (between the cards of a host
  and over the network between hosts, as NCCL picks). `make_mesh` takes
  `Nccl` when the group has the NCCL side (every rank a card of its own),
  `Gloo` otherwise;
- a rank of a process mesh holds the cards `runtime.cluster.host_layout`
  gives it (a block of its host's cards, or a card it shares) and spreads
  its shards over them as an in-process mesh does (`process_devices`);
  its collectives go through its first card, the card of its NCCL rank.
  `Mesh.devices` names every shard's card as its host numbers it and
  `Mesh.hosts` its host, so a shard on another host's cuda:0 is told
  apart from this host's.

Collective inputs are lists of the LOCAL shards' tensors, in shard order.
Gathered and reduced results land on the home device; an all_to_all
delivers each receiver's rows on the receiver's device.
"""

from __future__ import annotations

import contextlib
import platform
import threading

import numpy as np
import torch

from ..column.column import Chunk, pad_capacity

DATA_AXIS = "d"  # the mesh's one axis (the JAX package's name)


def shard_devices(n: int, device, count: int) -> tuple:
    """The device of each of n shards (the JAX Mesh's device array). A
    `cuda` device without an index spreads the shards over the visible
    cards (`spread`, over cuda:0 .. cuda:(count - 1)). A device with an
    index (`cuda:1`) or the CPU holds every shard."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return (dev,) * n
    if count < 1:
        raise RuntimeError("a cuda mesh needs a visible card; none is")
    return spread(n, [torch.device("cuda", i) for i in range(count)])


def spread(n: int, cards) -> tuple:
    """n shards over the first k of `cards`, k the largest divisor of n
    that is at most their number, in consecutive blocks: shard s on
    `cards[s // (n // k)]`."""
    k = max(d for d in range(1, min(n, len(cards)) + 1) if n % d == 0)
    return tuple(torch.device(cards[s // (n // k)]) for s in range(n))


def indexed_device(device) -> torch.device:
    """`device` with its card's index: a bare `cuda` is the current card
    (tensors report indexed devices, so placements compare against
    these)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_runs(devices) -> list:
    """[(device, first, count)]: the runs of equal consecutive devices of a
    shard sequence (a one-device mesh is one run)."""
    runs: list = []
    for i, d in enumerate(devices):
        if runs and runs[-1][0] == d:
            runs[-1][2] += 1
        else:
            runs.append([d, i, 1])
    return [tuple(r) for r in runs]


def _move(x, device):
    """A tensor on `device`: itself when it is there, else a blocking copy
    (a copy between two cards orders itself against both cards' current
    streams)."""
    return x if x is None or x.device == device else x.to(device)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """bool lanes travel as uint8 (gloo has no bool reductions)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


class InProcess:
    """Every shard in this process: the collectives are plain torch ops
    over the shard tuple, with blocking copies between the shards'
    devices. `home` is the device a gathered or reduced result lands on,
    `devs` the local shards' devices."""

    world = 1
    rank = 0
    backend = "in-process"

    def __init__(self, n_shards: int):
        self.n = n_shards
        self.local = tuple(range(n_shards))

    def all_gather(self, xs, home) -> torch.Tensor:
        """lax.all_gather(tiled=True): the shards concatenated in order."""
        return torch.cat([_move(x, home) for x in xs])

    def all_to_all(self, xs, devs) -> list:
        """lax.all_to_all(split_axis=0, concat_axis=0, tiled=False) over
        [n, C, ...] send buffers: shard j receives block (i, j) from every
        source i, in order of i, as one [n*C, ...] tensor on its device."""
        n = self.n
        return [torch.cat([_move(xs[i][j], devs[j]) for i in range(n)])
                for j in range(n)]

    def reduce(self, xs, op: str, home) -> torch.Tensor:
        return _reduce_stack(torch.stack([_move(x, home) for x in xs]), op)


def _reduce_stack(s: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sum":
        return s.sum(0)
    if op == "max":
        return s.max(0).values if s.ndim > 1 else s.max()
    if op == "min":
        return s.min(0).values if s.ndim > 1 else s.min()
    raise ValueError(op)


class _ProcessGroup:
    """The collectives over a torch.distributed process group: `world`
    processes, each holding n / world consecutive shards. A collective
    lays its blocks out on this process's device (an all_to_all's in the
    [world, local, block] layout of the group's ranks), hands them to the
    group through `_stage` and moves what comes back to the device it
    belongs on: gathered and reduced results to the home device, an
    all_to_all's rows to the receiver's."""

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

    @property
    def backend(self) -> str:
        """The group's backend as torch.distributed names it ("gloo", or
        "cpu:gloo,cuda:nccl" for a group with both sides)."""
        return str(self._dist.get_backend(self.group))

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """`x` where the group's collective reads it."""
        raise NotImplementedError

    @staticmethod
    def _like(x: torch.Tensor) -> torch.Tensor:
        """An output buffer of `x`'s shape, dtype and memory."""
        return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                           pin_memory=x.is_pinned())

    def all_gather(self, xs, home) -> torch.Tensor:
        mine = self._stage(_wire(torch.cat([_move(x, home) for x in xs])))
        parts = [self._like(mine) for _ in range(self.world)]
        self._dist.all_gather(parts, mine, group=self.group)
        out = torch.cat([_move(p, home) for p in parts])
        return out.to(torch.bool) if xs[0].dtype == torch.bool else out

    def all_to_all(self, xs, devs) -> list:
        nl, w, dev = len(self.local), self.world, devs[0]
        dtype = xs[0].dtype
        block = xs[0].shape[1:]  # [C, ...]
        # send[p, i, j]: local source i's block for global shard p*nl + j
        send = self._stage(torch.stack(
            [_wire(_move(x, dev)).reshape((w, nl) + block) for x in xs],
            1).contiguous())
        recv = self._like(send)
        self._dist.all_to_all_single(recv, send, group=self.group)
        # recv[q, i, j]: global source q*nl + i's block for local shard j
        recv = _move(recv, dev)
        out = []
        for j in range(nl):
            r = recv[:, :, j].reshape((self.n * block[0],) + block[1:])
            if dtype == torch.bool:
                r = r.to(torch.bool)
            out.append(_move(r, devs[j]))
        return out

    def reduce(self, xs, op: str, home) -> torch.Tensor:
        # the local shards' reduction keeps InProcess's dtype (a sum of
        # bool lanes counts them in int64)
        local = _reduce_stack(torch.stack([_move(x, home) for x in xs]), op)
        mine = self._stage(_wire(local))
        rop = {"sum": self._dist.ReduceOp.SUM, "max": self._dist.ReduceOp.MAX,
               "min": self._dist.ReduceOp.MIN}[op]
        self._dist.all_reduce(mine, op=rop, group=self.group)
        return _move(mine, home).to(local.dtype)


class Gloo(_ProcessGroup):
    """The process group's collectives staged through host memory, the
    transport gloo runs on: a collective's blocks, laid out on this
    process's card, go to the CPU in one copy into pinned memory (torch
    caches its pinned blocks, so a repeated exchange reuses them), the
    group's gloo side moves them, and what comes back returns to the card
    in one copy. The route where processes share a card, or have none."""

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return host.copy_(x)


class Nccl(_ProcessGroup):
    """The process group's collectives on the device tensors where they
    are: on this process's card over the group's NCCL side, with no host
    copy (a CPU tensor, as `Mesh.host_max` reduces, takes the group's gloo
    side). NCCL runs on its own stream; torch makes it wait for the
    current stream of the input's card and makes that stream wait for the
    result, so each collective is ordered against the ops that produced
    its inputs and those that read its outputs."""

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Dry:
    """Shard 0 alone standing in for n shards, with collectives that give
    the right SHAPES (the fragment-IR derivation runs the program once this
    way: the exchange set depends on placements, dtypes and estimates,
    never on values, and the capacities of shard 0 are every shard's)."""

    world = 1
    rank = 0
    backend = "dry"

    def __init__(self, n_shards: int):
        self.n = n_shards
        self.local = (0,)

    def all_gather(self, xs, home) -> torch.Tensor:
        return torch.cat(list(xs) * self.n)

    def all_to_all(self, xs, devs) -> list:
        x = xs[0]
        return [x.reshape((self.n * x.shape[1],) + tuple(x.shape[2:]))]

    def reduce(self, xs, op: str, home) -> torch.Tensor:
        return xs[0]


class Mesh:
    """n shards, shard s on `devices[s]`. `device` may name one device for
    every shard or give one per shard; `device` then is the home device,
    the device of this process's first shard (shard 0 in one process),
    where REPLICATED values and gathered results live. `coll` is the
    collective backend; `local` the global ids of the shards this process
    holds. `moves` counts each collective's calls and the per-shard
    capacities it moved (a test hook: the JAX package's tests read the
    same facts from HLO). A card of this process's shards that does not
    exist raises here (another process's shards name its own cards).
    `hosts` names each shard's host (default: this process's host for
    every shard), the process_index of the JAX Mesh's devices."""

    def __init__(self, n_shards: int, device, coll=None, hosts=None):
        self.n = int(n_shards)
        if isinstance(device, (tuple, list)):
            devices = tuple(indexed_device(d) for d in device)
            if len(devices) != self.n:
                raise ValueError(f"{len(devices)} devices for {self.n} shards")
        else:
            devices = (indexed_device(device),) * self.n
        self.devices = devices
        self.hosts = tuple(hosts) if hosts is not None else (
            this_host(),) * self.n
        if len(self.hosts) != self.n:
            raise ValueError(f"{len(self.hosts)} hosts for {self.n} shards")
        self.coll = coll if coll is not None else InProcess(self.n)
        if self.coll.n != self.n:
            raise ValueError("collective backend sized for another mesh")
        self.local = self.coll.local
        self.local_devices = tuple(devices[s] for s in self.local)
        for d in set(self.local_devices):
            if d.type == "cuda" and not (
                    torch.cuda.is_available()
                    and d.index < torch.cuda.device_count()):
                raise RuntimeError(f"mesh device {d} is not a visible card")
        self.device = self.local_devices[0]
        self.moves: dict = {}
        # per-thread observer of the reductions (analysis/trace_check.py's
        # counter audit of a program's first run), and per-thread copies
        # of REPLICATED values on other devices (see `replicas`)
        self._obs = threading.local()
        self._rep = threading.local()

    def note_move(self, kind: str, rows: int):
        moved = self.moves.setdefault(kind, [])
        if len(moved) < 1024:  # bounded: a long-lived mesh keeps no log
            moved.append(int(rows))

    def reset_moves(self):
        self.moves = {}

    @property
    def cards(self) -> tuple:
        """The distinct devices of this process's shards, in shard order."""
        return tuple(dict.fromkeys(self.local_devices))

    # collectives over a per-shard sequence of this process's tensors
    def all_gather(self, xs) -> torch.Tensor:
        return self.coll.all_gather(list(xs), self.device)

    def all_to_all(self, xs) -> list:
        return self.coll.all_to_all(list(xs), self.local_devices)

    # reductions over a per-shard sequence (psum / pmax / pmin)
    def psum(self, xs):
        return self._reduce(xs, "sum")

    def pmax(self, xs):
        return self._reduce(xs, "max")

    def pmin(self, xs):
        return self._reduce(xs, "min")

    def _reduce(self, xs, op: str):
        xs = list(xs)
        out = self.coll.reduce(xs, op, self.device)
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

    @contextlib.contextmanager
    def replicas(self):
        """A program's run: while it is open, `to` copies each value to
        each device once on this thread (a REPLICATED build side exists
        once per card, not once per shard). Nested runs share the
        outermost's copies."""
        if getattr(self._rep, "memo", None) is not None:
            yield
            return
        self._rep.memo = {}
        try:
            yield
        finally:
            self._rep.memo = None

    def to(self, value, device):
        """`value` (a Chunk or a tensor) on `device`: itself where it
        already is, else a blocking copy, memoized per tensor and device
        inside `replicas`. Any other value (None, a number) is itself."""
        if isinstance(value, torch.Tensor):
            if value.device == device:
                return value
            memo = getattr(self._rep, "memo", None)
            if memo is None:
                return value.to(device)
            key = (id(value), device)
            hit = memo.get(key)
            if hit is None:
                # the source rides along: its id stays unique in the memo
                hit = memo[key] = (value, value.to(device))
            return hit[1]
        if not isinstance(value, Chunk):
            return value
        c = value
        data = tuple(self.to(d, device) for d in c.data)
        valid = tuple(self.to(v, device) for v in c.valid)
        sel = self.to(c.sel, device)
        if (c.device == device and sel is c.sel
                and all(a is b for a, b in zip(data + valid,
                                               c.data + c.valid))):
            return c
        return Chunk(c.schema, data, valid, sel, device)

    def host_max(self, vals: dict) -> dict:
        """Merge {key: int} maxima of this process's shards across
        processes (one collective on a CPU tensor: the group's gloo side
        under either process-group class); identity on a one-process
        mesh."""
        if self.coll.world == 1 or not vals:
            return vals
        keys = sorted(vals)
        t = torch.tensor([int(vals[k]) for k in keys], dtype=torch.int64)
        t = self.coll.reduce([t], "max", torch.device("cpu"))
        return dict(zip(keys, t.tolist()))

    def __repr__(self):
        return (f"Mesh(n={self.n}, local={self.local}, device={self.device}, "
                f"cards={self.cards}, {type(self.coll).__name__}, "
                f"backend={self.coll.backend}, "
                f"hosts={tuple(dict.fromkeys(self.hosts))})")


# multi-process state set by runtime.cluster.init_multihost: each process's
# shard count, the backend its devices' collectives take ("nccl" when the
# group has the NCCL side, "gloo" when it has gloo alone), its host and the
# cards of its host it holds (host_layout)
_PROCESS = {"local_shards": None, "backend": None, "host": None,
            "cards": None}


def this_host() -> str:
    """This process's host: the name it joined its process group under,
    else the machine's (`platform.node()`, the host name)."""
    return _PROCESS["host"] or platform.node()


def process_devices(rank_devices, n: int) -> tuple:
    """The global device map of a mesh over processes (the JAX mesh's
    device array, each device with its process_index): rank r of w holds
    shards [r * n / w, (r + 1) * n / w), spread (`spread`) over its own
    devices `rank_devices[r]`, one device or a sequence of them (the
    cards of its host it holds, as its host numbers them)."""
    w = len(rank_devices)
    if n % w:
        raise ValueError(f"{n} shards do not divide over {w} processes")
    out: list = []
    for devs in rank_devices:
        if isinstance(devs, (str, torch.device)):
            devs = (devs,)
        out += spread(n // w, devs)
    return tuple(out)


def _rank_devices(device) -> list:
    """Each process's (host, devices), in rank order: one gather of
    objects over the group's gloo side. In each process a bare `cuda` is
    the cards init_multihost gave the rank (its current card where it was
    given none), any other device itself, and None no device (the caller
    names every shard's). Every process of the group must call it."""
    import torch.distributed as dist

    dev = torch.device(device) if device is not None else None
    if dev is None:
        devs = ()
    elif dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a process mesh runs on a card or the CPU: {dev}")
    elif dev.type == "cuda" and dev.index is None and _PROCESS["cards"]:
        devs = tuple(f"cuda:{c}" for c in _PROCESS["cards"])
    else:
        devs = (str(indexed_device(dev)),)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (this_host(), devs))
    return out


def make_mesh(n_devices: int | None = None, *, device=None,
              devices=None) -> Mesh:
    """A mesh of n shards, placed on `device`, which the caller names (a
    Session passes its own): a bare `cuda` spreads the shards over the
    visible cards (`shard_devices`), any other device holds them all. Or
    on `devices`, one per shard, as the JAX Mesh takes any device array
    (n defaults to their number). After `cluster.init_multihost` the mesh
    spans every process of the group, on one host or several (n defaults
    to processes x local shards): this process's shards spread over the
    cards host_layout gave it (on a bare `cuda`), the collectives take
    `Nccl` where the group has the NCCL side and `Gloo` otherwise, and
    every process's host (and without `devices` its devices,
    `process_devices`) is gathered, so every process of the group builds
    it at the same point. Otherwise every shard lives in this process (n
    is required)."""
    import torch.distributed as dist

    if device is None and devices is None:
        raise TypeError("make_mesh needs device= or devices=")
    if devices is not None:
        devices = tuple(devices)
        n_devices = n_devices or len(devices)
    if dist.is_available() and dist.is_initialized():
        w = dist.get_world_size()
        per = _PROCESS["local_shards"] or 1
        n = n_devices or per * w
        coll = Nccl(n) if _PROCESS["backend"] == "nccl" else Gloo(n)
        ranks = _rank_devices(device if devices is None else None)
        hosts = [h for h, _ in ranks]
        if devices is None:
            devices = process_devices([d for _, d in ranks], n)
        return Mesh(n, devices, coll,
                    hosts=[hosts[s // (n // w)] for s in range(n)])
    if not n_devices:
        raise ValueError("an in-process mesh needs its shard count")
    if devices is None:
        count = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        devices = shard_devices(n_devices, device, count)
    return Mesh(n_devices, devices, InProcess(n_devices))


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when the mesh's shards live in more than one process."""
    return mesh.coll.world > 1


def shard_host_table(table, mesh: Mesh):
    """Row-shard a HostTable: every shard gets equal capacity
    pad_capacity(ceil(rows / n)), rows in order, the tail padded; the
    selection mask marks the real rows. Returns this process's shards,
    each on its own device: one upload per run of shards that share a
    device, and each shard a view of its run's."""
    n = mesh.n
    rows = table.num_rows
    local_cap = pad_capacity((rows + n - 1) // n)
    chunk = table.to_chunk(capacity=local_cap * n, device="cpu")
    sel = chunk.sel_mask()
    base = mesh.local[0] * local_cap
    out = []
    for dev, j0, cnt in device_runs(mesh.local_devices):
        lo = base + j0 * local_cap
        hi = lo + cnt * local_cap

        def up(x):
            return None if x is None else x[lo:hi].to(dev)

        data = [up(d) for d in chunk.data]
        valid = [up(v) for v in chunk.valid]
        run_sel = up(sel)
        for j in range(cnt):
            a, b = j * local_cap, (j + 1) * local_cap
            out.append(Chunk(
                chunk.schema, tuple(d[a:b] for d in data),
                tuple(None if v is None else v[a:b] for v in valid),
                run_sel[a:b], dev))
    return tuple(out)


def hash_layout(keys: np.ndarray, n: int):
    """Colocate placement of rows by the splitmix64 bucket of an integer
    key (the device shuffle's recipe): (row order, rows per shard)."""
    from .. import native

    bucket = native.hash_partition_i64(
        np.asarray(keys, dtype=np.int64), n)
    order, offsets = native.bucket_order(bucket, n)  # a stable argsort
    return order, np.diff(offsets)
