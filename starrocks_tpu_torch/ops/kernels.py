"""Hand-written CUDA kernels of the port, their plain torch versions, and
their launch counters.

Every TPU kernel of `starrocks_tpu/ops/pallas_kernels.py` has a
counterpart here:

| wrapper              | CUDA source                 | replaces (pallas_kernels.py)    |
|----------------------|-----------------------------|---------------------------------|
| `segment_sum`        | csrc/segment_sum.cu         | segment_sum_pallas        :60   |
| `topn_select`        | csrc/topn_select.cu         | topn_select_pallas        :112  |
| `hash_build`         | csrc/hash_table.cu          | hash_build_pallas         :206  |
| `hash_probe`         | csrc/hash_table.cu          | hash_probe_pallas         :266  |
| `probe_searchsorted` | csrc/probe_searchsorted.cu  | probe_searchsorted_pallas :316  |

A wrapper takes its plain version only for a tensor that lies on the CPU;
for a CUDA tensor it launches the kernel or raises — there is no fallback.
`<wrapper>.calls` counts every call (either device) and `<wrapper>.launches`
counts kernel launches only, so a run on the card shows that the main path
went through the kernels; `<wrapper>.last_shape` keeps the sizes of the
latest call and `<wrapper>.shapes` those of every call since the counts were
last reset, so a benchmark can time a kernel at the shapes a query gave it.
`<wrapper>.per_card` counts its launches by card ("cuda:1": a launch
runs on the card of its tensors, under a device guard), `hash_probe.routes`
its launches by route ("direct", "partitioned": csrc/hash_table.cu), `hash_build.last_deferred` holds the latest build's
per-slice count of keys inserted past their slice, and
`topn_select.last_listed` the latest launch's count of blocks sent to the
top-N kernel's 64-bit pass and to its pair kernel (device tensors).

The serving tier runs statements from several threads at once, so every
count (`calls`, `launches`, `shapes`, `routes`) moves under one lock and
stays exact under concurrency. The `last_*` diagnostics (`last_shape`,
`hash_build.last_deferred`, `topn_select.last_listed`) are last-writer:
under concurrent statements they describe whichever call finished its
bookkeeping last. The two device diagnostics are views of their launch's
scratch buffer and keep that buffer allocated until the next launch.

The kernels are compiled with nvcc for sm_90a into plain-C shared libraries
(one per source, built in parallel) at first use, under `_build/` next to
this package, and loaded with ctypes. Building needs the CUDA toolkit
(`CUDA_HOME`, default /usr/local/cuda); importing this module needs nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from .. import lockdep
from .common import exact_f32_matmul, mix64, onehot_blocked
from .segment import SLAB_BYTES

I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)
TOPN_BLOCK = 1024

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("hash_table", "topn_select", "probe_searchsorted", "segment_sum")
# dynamic shared memory one CTA may use on an H100 (227 KB)
SMEM_MAX_BYTES = 232_448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "hash_table": {
        "sr_hash_build": [_P, _I64, _P, _P, _I64, ctypes.c_int,
                          ctypes.c_int, _P, _P, _P, _P],
        "sr_hash_probe": [_P, _P, _I64, _P, _I64, _P, _P],
        "sr_hash_probe_partitioned": [_P, _P, _I64, _P, _I64, _P,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, _P, _P, _P, _P],
    },
    "topn_select": {
        "sr_topn_select": [_P, _I64, ctypes.c_int, _P, _P, _P, _P],
    },
    "probe_searchsorted": {
        "sr_probe_searchsorted": [_P, _I64, _P, _I64, _P, _P,
                                  ctypes.POINTER(_I64), ctypes.c_int,
                                  ctypes.c_int, _P],
    },
    "segment_sum": {
        "sr_segment_sum": [_P, _P, _I64, ctypes.c_int, ctypes.c_int, _I64,
                           _I64, ctypes.c_int, _P, _P, _P],
    },
}

_libs: dict = {}
_libs_lock = lockdep.lock("kernels._libs_lock")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build_kernels(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every missing kernel library, one nvcc per source, all started
    together. Returns {name: nvcc output} for the ones built (ptxas register
    and shared-memory reports with verbose=True). Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    failed = []
    try:
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
    finally:
        # an interrupted build (a failed spawn, KeyboardInterrupt) leaves no
        # compiler running
        kill([p for p, _, _ in procs.values()])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def kill(procs):
    """Kill the processes of `procs` that are still running (each Popen
    reaps its process when it is collected)."""
    for p in procs:
        if p.poll() is None:
            p.kill()


def _lib(name: str):
    with _libs_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not path.exists():
            build_kernels((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.sr_error_string.argtypes = [ctypes.c_int]
        lib.sr_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def _check_launch(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.sr_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(t: torch.Tensor):
    """The device guard of a launch: the CUDA runtime's current device is
    `t`'s card while the library runs, so its attribute calls
    (cudaFuncSetAttribute, cudaGetDevice) act on the card whose stream it
    launches on."""
    return torch.cuda.device(t.device)


def _check_vector(t: torch.Tensor, dtype: torch.dtype, what: str):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.ndim != 1:
        raise ValueError(f"{what}: expected a 1-D tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.shape[0] >= (1 << 31):
        raise ValueError(f"{what}: {t.shape[0]} rows exceed int32 row ids")


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU tensor)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{what}: no kernel for device {t.device}")


def _counted(fn):
    fn.calls = 0
    fn.launches = 0
    fn.per_card = {}
    fn.last_shape = None
    fn.shapes = set()
    return fn


# guards every wrapper's counts: read-modify-writes from the serving
# tier's worker threads must not lose increments
_count_lock = lockdep.lock("kernels._count_lock")


def _called(fn, shape):
    with _count_lock:
        fn.calls += 1
        fn.last_shape = shape
        fn.shapes.add(shape)


def _launched(fn, route=None, on: torch.Tensor | None = None):
    """Count one kernel launch of wrapper `fn` (and of `route`, for the
    hash probe's per-route counts), on the card of tensor `on`."""
    card = None if on is None else str(on.device)
    with _count_lock:
        fn.launches += 1
        if card is not None:
            fn.per_card[card] = fn.per_card.get(card, 0) + 1
        if route is not None:
            fn.routes[route] += 1


def reset_counts():
    with _count_lock:
        for w in WRAPPERS.values():
            w.calls = 0
            w.launches = 0
            w.per_card = {}
            w.last_shape = None
            w.shapes = set()
        hash_build.last_deferred = None
        hash_probe.routes = dict.fromkeys(HASH_PROBE_ROUTES, 0)
        topn_select.last_listed = None


def counts() -> dict:
    """{wrapper name: {"calls": n, "launches": n}}."""
    with _count_lock:
        return {n: {"calls": w.calls, "launches": w.launches}
                for n, w in WRAPPERS.items()}


def launches_per_card() -> dict:
    """{wrapper name: {card: launches}} since the counts were last reset."""
    with _count_lock:
        return {n: dict(w.per_card) for n, w in WRAPPERS.items()}


# --- the hash kernels' partitioned layout ------------------------------------

# csrc/hash_table.cu groups keys by slices of the table, HASH_SLICE
# consecutive slots (the whole table where it is smaller), and works on one
# slice at a time in a CTA's shared memory (12 B a slot: 96 KB, two CTAs
# to an SM); the probe's CTA also holds a halo of the next HASH_HALO
# slots. The build's keys reach their slices through a scatter that sorts
# tiles of HASH_SORT_TILE keys by slice in shared memory: in one pass for
# up to HASH_COARSE_BINS slices, else in two (coarse bins of slices
# first); where a histogram of one bin per slice exceeds HASH_HIST_SMEM
# (more than 2^14 slices), through one global atomic per key. The probe's
# scatter sorts tiles of HASH_WIDE_TILE keys in one pass, for up to
# HASH_WIDE_BINS slices (a probe of a larger table walks directly), into a
# range of probe_cap places a slice, with no count beforehand: 1/8 more
# than an even share, and HASH_CAP_SLACK; a probe whose slice is full
# walks directly. These mirror the constants of the CUDA source.
HASH_SLICE = 8192
HASH_HALO = 256
HASH_HIST_SMEM = 64 * 1024
HASH_SORT_TILE = 4096
HASH_COARSE_BINS = 128
HASH_WIDE_TILE = 16384
HASH_WIDE_BINS = 2048
HASH_CAP_SLACK = 64
# What one probe of the direct route costs in device-memory traffic beyond
# its key and its answer: two random reads (its chain's first keys, then
# the row) of 64 bytes each where the table is larger than the L2, fewer
# where part of it stays in the L2. 92 puts the switch of the byte rule of
# hash_partition_layout where the two routes' times cross on an H100 at
# Q9's table, 2^24 slots (M = 3.3M: PERF.md).
HASH_RANDOM_BYTES = 92
HASH_PROBE_ROUTES = ("direct", "partitioned")


class HashLayout(NamedTuple):
    slice_log2: int
    slice_slots: int         # S
    partitions: int          # P = T / S
    halo: int                # H
    hist_smem: int           # bytes of a count CTA's histogram (0: global)
    build_passes: int        # the build's sorting passes (0: global atomics)
    build_scatter_smem: int  # bytes of shared memory of their CTAs
    build_smem: int          # ... of an insert CTA
    probe_scatter_smem: int  # ... of a CTA of the probe's wide scatter
    probe_smem: int          # ... of an answer CTA
    work_ints: int           # the int32 scratch of the build
    probe_cap: int           # places a slice for a probe of `m` keys
    probe_route: str         # the route of a probe of `m` keys


def hash_partition_layout(table_size: int, m: int = 0) -> HashLayout:
    """The slices of the hash kernels over a table of `table_size` slots,
    and the route of a probe of `m` keys. The route is the one that moves
    fewer bytes: the direct walk M * (8 + 4 + HASH_RANDOM_BYTES); the
    partitioned probe reads the table once (T * 12) and, per probe, 44
    bytes: in the scatter its key read and written and where it went (20);
    in the answer the key and the row (12); in the gather where it went
    and its answer, read, and the answer written (12). A table of more
    than HASH_WIDE_BINS slices is walked directly, and so is a probe whose
    slices' places would pass int32 indices."""
    s = min(HASH_SLICE, table_size)
    parts = table_size // s
    shared = parts * 4 <= HASH_HIST_SMEM
    passes = 0 if not shared else 1 if parts <= HASH_COARSE_BINS else 2
    w = s + HASH_HALO
    cap = -(-m * 9 // (8 * parts)) + HASH_CAP_SLACK
    direct = m * (8 + 4 + HASH_RANDOM_BYTES)
    partitioned = table_size * 12 + m * 44
    return HashLayout(
        slice_log2=s.bit_length() - 1, slice_slots=s, partitions=parts,
        halo=HASH_HALO, hist_smem=parts * 4 if shared else 0,
        build_passes=passes,
        build_scatter_smem=HASH_SORT_TILE * 14 + parts * 8 if shared else 0,
        build_smem=s * 12,
        probe_scatter_smem=HASH_WIDE_TILE * 10 + parts * 8,
        probe_smem=-(-w * 8 // 16) * 16 + w * 4,
        work_ints=4 * parts + HASH_COARSE_BINS + 1, probe_cap=cap,
        probe_route=("partitioned" if parts <= HASH_WIDE_BINS
                     and parts * cap < 1 << 31 and partitioned < direct
                     else "direct"))


def _check_smem(what: str, nbytes: int):
    if nbytes > SMEM_MAX_BYTES:
        raise ValueError(f"{what}: {nbytes} B of shared memory per CTA, more "
                         f"than {SMEM_MAX_BYTES}")


# --- hash build -------------------------------------------------------------


def hash_build_plain(keys: torch.Tensor, table_size: int):
    """The TPU kernel's claim rounds, in torch: every round each unplaced
    key claims its current probe slot with a scatter-min of its row id;
    winners write (key, row) and park, losers advance. On the CPU this
    gives the reference's table slot for slot."""
    n = keys.shape[0]
    dev = keys.device
    mask = table_size - 1
    h = mix64(keys) & mask
    rowid = torch.arange(n, dtype=torch.int32, device=dev)
    # one spill slot past the table takes the writes of parked rows
    tkey = torch.full((table_size + 1,), I64MAX, dtype=torch.int64, device=dev)
    trow = torch.full((table_size + 1,), -1, dtype=torch.int32, device=dev)
    disp = torch.zeros((n,), dtype=torch.int64, device=dev)
    placed = keys == I64MAX  # sentinel (NULL/dead) rows never insert
    while not bool(placed.all()):
        slot = (h + disp) & mask
        occupied = tkey[slot] != I64MAX
        want = (~placed) & (~occupied)
        cand = torch.where(want, slot, table_size)  # parked rows drop
        claim = torch.full((table_size + 1,), n, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, cand, rowid, reduce="amin", include_self=True)
        won = want & (claim[slot] == rowid)
        wslot = torch.where(won, slot, table_size)
        tkey[wslot] = keys
        trow[wslot] = rowid
        tkey[table_size] = I64MAX
        placed = placed | won
        disp = disp + torch.where(placed, 0, 1)
    return tkey[:table_size].clone(), trow[:table_size].clone()


@_counted
def hash_build(keys: torch.Tensor, table_size: int):
    """Open-addressing table over `keys` ([N] int64, unique except the
    int64-max NULL/dead sentinel): returns (table_key [T] int64, table_row
    [T] int32, -1 = empty). T must be a power of two >= 2N. On the card
    the keys go to their table slices first, and each slice is built in
    shared memory (csrc/hash_table.cu); the slot order of colliding keys
    may differ from run to run."""
    _check_vector(keys, torch.int64, "hash_build keys")
    n = keys.shape[0]
    if table_size <= 0 or table_size & (table_size - 1):
        raise ValueError(f"hash_build: table size {table_size} is not a power of 2")
    if table_size < 2 * n:
        raise ValueError(f"hash_build: table size {table_size} < 2 * {n} keys")
    if table_size > (1 << 31):
        raise ValueError(f"hash_build: table size {table_size} too large")
    _called(hash_build, (n, table_size))
    if not _route(keys, "hash_build"):
        return hash_build_plain(keys, table_size)
    lay = hash_partition_layout(table_size)
    _check_smem("hash_build", max(lay.build_smem, lay.build_scatter_smem))
    lib = _lib("hash_table")
    dev = keys.device
    # the kernel writes every slot: no fill
    tkey = torch.empty((table_size,), dtype=torch.int64, device=dev)
    trow = torch.empty((table_size,), dtype=torch.int32, device=dev)
    skey = torch.empty((n,), dtype=torch.int64, device=dev)
    srow = torch.empty((n,), dtype=torch.int32, device=dev)
    work = torch.empty((lay.work_ints,), dtype=torch.int32, device=dev)
    with _on_card(keys):
        rc = lib.sr_hash_build(keys.data_ptr(), n, tkey.data_ptr(),
                               trow.data_ptr(), table_size, lay.slice_log2,
                               int(lay.hist_smem > 0), skey.data_ptr(),
                               srow.data_ptr(), work.data_ptr(),
                               _stream(keys))
    _check_launch(lib, rc, "hash_build")
    _launched(hash_build, on=keys)
    hash_build.last_deferred = work[3 * lay.partitions:4 * lay.partitions]
    return tkey, trow


# --- hash probe -------------------------------------------------------------


def hash_probe_plain(table_key: torch.Tensor, table_row: torch.Tensor,
                     probe: torch.Tensor):
    """Every probe key walks its chain in lockstep until it meets its key
    (matched: the build row) or an empty slot (no match: -1). Sentinel
    probes never match."""
    t = table_key.shape[0]
    mask = t - 1
    h = mix64(probe) & mask
    disp = torch.zeros(probe.shape, dtype=torch.int64, device=probe.device)
    row = torch.full(probe.shape, -1, dtype=torch.int32, device=probe.device)
    done = probe == I64MAX
    while not bool(done.all()):
        slot = (h + disp) & mask
        k = table_key[slot]
        hit = (~done) & (k == probe)
        miss = (~done) & (k == I64MAX)
        row = torch.where(hit, table_row[slot], row)
        done = done | hit | miss
        disp = disp + 1
    return row


@_counted
def hash_probe(table_key: torch.Tensor, table_row: torch.Tensor,
               probe: torch.Tensor):
    """Probe the table from `hash_build`: [M] int32 matched build row ids
    (-1 = no match). On the card the route (a direct walk per probe, or the
    partitioned probe) follows from (T, M) alone: `hash_partition_layout`;
    an empty probe launches nothing."""
    _check_vector(table_key, torch.int64, "hash_probe table_key")
    _check_vector(table_row, torch.int32, "hash_probe table_row")
    _check_vector(probe, torch.int64, "hash_probe probe")
    t = table_key.shape[0]
    if t <= 0 or t & (t - 1) or table_row.shape[0] != t:
        raise ValueError("hash_probe: table must be two pow-2 vectors of one size")
    if not (table_key.device == table_row.device == probe.device):
        raise ValueError("hash_probe: table and probe on different devices")
    m = probe.shape[0]
    _called(hash_probe, (t, m))
    if not _route(probe, "hash_probe"):
        return hash_probe_plain(table_key, table_row, probe)
    dev = probe.device
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    lay = hash_partition_layout(t, m)
    if lay.probe_route == "partitioned" and (
            table_key.data_ptr() % 16 or table_row.data_ptr() % 16):
        raise ValueError("hash_probe: the table's vectors must start on 16 "
                         "bytes (the partitioned probe copies whole slices)")
    lib = _lib("hash_table")
    if lay.probe_route == "direct":
        with _on_card(probe):
            rc = lib.sr_hash_probe(table_key.data_ptr(), table_row.data_ptr(),
                                   t, probe.data_ptr(), m, out.data_ptr(),
                                   _stream(probe))
    else:
        _check_smem("hash_probe", max(lay.probe_smem, lay.probe_scatter_smem))
        # the keys by slice; where each probe went, then the answers by
        # slice; how many places of each slice are taken
        places = lay.partitions * lay.probe_cap
        skey = torch.empty((places,), dtype=torch.int64, device=dev)
        sints = torch.empty((m + places,), dtype=torch.int32, device=dev)
        fill = torch.empty((lay.partitions,), dtype=torch.int32, device=dev)
        with _on_card(probe):
            rc = lib.sr_hash_probe_partitioned(
                table_key.data_ptr(), table_row.data_ptr(), t,
                probe.data_ptr(), m, out.data_ptr(), lay.slice_log2,
                lay.halo, lay.probe_cap, skey.data_ptr(), sints.data_ptr(),
                fill.data_ptr(), _stream(probe))
    _check_launch(lib, rc, "hash_probe")
    _launched(hash_probe, lay.probe_route, on=probe)
    return out


# --- top-N select -----------------------------------------------------------


def topn_select_plain(neg: torch.Tensor, k: int):
    """Per 1024-row block, the first k rows in (value desc, row asc) order,
    as the TPU kernel's k rounds of first-argmax produce them — including
    its lane-0 answer once only INT64_MIN lanes remain."""
    nb = neg.shape[0] // TOPN_BLOCK
    x = neg.reshape(nb, TOPN_BLOCK)
    v, lane = torch.sort(x, dim=1, descending=True, stable=True)
    v, lane = v[:, :k], lane[:, :k]
    lane = torch.where(v == I64MIN, 0, lane)
    base = torch.arange(nb, dtype=torch.int64, device=neg.device) * TOPN_BLOCK
    idx = (base[:, None] + lane).to(torch.int32)
    return v.reshape(-1), idx.reshape(-1)


@_counted
def topn_select(neg: torch.Tensor, k: int):
    """Per-block top-k candidates of `neg` ([N] int64, N % 1024 == 0,
    LARGEST first): (vals [N/1024*k] int64, idx [N/1024*k] int32)."""
    _check_vector(neg, torch.int64, "topn_select neg")
    n = neg.shape[0]
    if n % TOPN_BLOCK:
        raise ValueError(f"topn_select: {n} rows is not a multiple of {TOPN_BLOCK}")
    if not 1 <= k <= TOPN_BLOCK:
        raise ValueError(f"topn_select: k={k} outside [1, {TOPN_BLOCK}]")
    _called(topn_select, (n, k))
    if not _route(neg, "topn_select"):
        return topn_select_plain(neg, k)
    lib = _lib("topn_select")
    nb = n // TOPN_BLOCK
    vals = torch.empty((nb * k,), dtype=torch.int64, device=neg.device)
    idx = torch.empty((nb * k,), dtype=torch.int32, device=neg.device)
    # two counts and two lists of blocks, those the 32-bit keys cannot
    # order and those too wide for 64-bit keys (csrc/topn_select.cu)
    wide = torch.empty((2 + 2 * nb,), dtype=torch.int32, device=neg.device)
    with _on_card(neg):
        rc = lib.sr_topn_select(neg.data_ptr(), n, k, vals.data_ptr(),
                                idx.data_ptr(), wide.data_ptr(), _stream(neg))
    _check_launch(lib, rc, "topn_select")
    _launched(topn_select, on=neg)
    topn_select.last_listed = wide[:2]
    return vals, idx


# --- sorted-build probe -----------------------------------------------------


def probe_searchsorted_plain(sorted_build: torch.Tensor, probe: torch.Tensor):
    """The TPU kernel's branch-free ladder, in torch: bit_length(K) masked
    halving steps over all probes in lockstep; converged lanes stop
    moving."""
    k = sorted_build.shape[0]
    dev = probe.device
    if k == 0:
        return torch.zeros(probe.shape, dtype=torch.int32, device=dev)
    lo = torch.zeros(probe.shape, dtype=torch.int64, device=dev)
    hi = torch.full(probe.shape, k, dtype=torch.int64, device=dev)
    for _ in range(k.bit_length()):
        mid = (lo + hi) // 2
        mv = sorted_build[mid.clamp(0, k - 1)]
        active = lo < hi
        go_right = (mv < probe) & active
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


# The static search tree of the probe kernel (csrc/probe_searchsorted.cu):
# leaves are groups of PROBE_LEAF build keys, inner nodes PROBE_NODE
# entries, and levels are added until one has at most PROBE_TOP_MAX
# entries (it goes to each CTA's shared memory).
PROBE_LEAF = 4
PROBE_NODE = 16
PROBE_TOP_MAX = 2048


def probe_index_layout(k: int):
    """The levels of the search tree over `k` sorted keys, bottom first, as
    (stride, entries, offset): entry j of a level is the build key at
    stride * (j + 1) - 1 (int64-max past k); each level is padded with
    int64-max to whole nodes at `offset` of one int64 index. Returns
    (levels, the index's length)."""
    levels = []
    off = 0
    stride = PROBE_LEAF
    while True:
        n = -(-k // stride)
        levels.append((stride, n, off))
        off += -(-n // PROBE_NODE) * PROBE_NODE
        if n <= PROBE_TOP_MAX:
            return levels, off
        stride *= PROBE_NODE


def probe_index(sorted_build: torch.Tensor):
    """The search tree's separator levels over `sorted_build` ([K] int64,
    K >= 1), in one int64 tensor on its device: one strided copy and one
    int64-max fill per level. Returns (index, levels)."""
    k = sorted_build.shape[0]
    levels, total = probe_index_layout(k)
    index = torch.empty((total,), dtype=torch.int64,
                        device=sorted_build.device)
    for stride, n, off in levels:
        full = k // stride  # the entries that lie inside the build
        end = off + -(-n // PROBE_NODE) * PROBE_NODE
        index[off:off + full] = sorted_build[stride - 1::stride]
        index[off + full:end] = I64MAX
    return index, levels


@_counted
def probe_searchsorted(sorted_build: torch.Tensor, probe: torch.Tensor):
    """searchsorted(sorted_build, probe, side='left') as [N] int32:
    `sorted_build` [K] int64 ascending (sentinels last), `probe` [N]
    int64. On the card the kernel descends `probe_index`'s tree; an empty
    build or probe launches nothing."""
    _check_vector(sorted_build, torch.int64, "probe_searchsorted build")
    _check_vector(probe, torch.int64, "probe_searchsorted probe")
    if sorted_build.device != probe.device:
        raise ValueError("probe_searchsorted: build and probe on different "
                         "devices")
    k, n = sorted_build.shape[0], probe.shape[0]
    _called(probe_searchsorted, (k, n))
    if not _route(probe, "probe_searchsorted"):
        return probe_searchsorted_plain(sorted_build, probe)
    if k == 0 or n == 0:
        return torch.zeros((n,), dtype=torch.int32, device=probe.device)
    lib = _lib("probe_searchsorted")
    index, levels = probe_index(sorted_build)
    offs = (_I64 * len(levels))(*[off for _, _, off in levels])
    out = torch.empty((n,), dtype=torch.int32, device=probe.device)
    with _on_card(probe):
        rc = lib.sr_probe_searchsorted(sorted_build.data_ptr(), k,
                                       probe.data_ptr(), n, out.data_ptr(),
                                       index.data_ptr(), offs, len(levels),
                                       levels[-1][1], _stream(probe))
    _check_launch(lib, rc, "probe_searchsorted")
    _launched(probe_searchsorted, on=probe)
    return out


# --- grouped float sums -----------------------------------------------------


def segment_sum_plain(gid: torch.Tensor, vals: torch.Tensor,
                      num_groups: int, block: int):
    """Each row block's [G+1, M] partial from a one-hot product in f32,
    then the partials added in block order in f32, as the TPU grid does.
    The one-hot is built a slab of whole blocks at a time (SLAB_BYTES)."""
    n, m = vals.shape
    nb = n // block
    acc = torch.zeros((num_groups + 1, m), dtype=torch.float32,
                      device=vals.device)
    step = max(1, SLAB_BYTES // (block * (num_groups + 1) * 4))
    with exact_f32_matmul():
        for b0 in range(0, nb, step):
            r0, r1 = b0 * block, min(nb, b0 + step) * block
            oh = onehot_blocked(gid[r0:r1], num_groups, block)
            v = vals[r0:r1].reshape(-1, block, m)
            for part in torch.bmm(oh.transpose(1, 2), v):
                acc += part
    return acc[:num_groups]


# The segment-sum kernel's fixed shape (csrc/segment_sum.cu). Pass 1 runs
# at most SEG_CTAS CTAs (two per SM of an H100), each over a contiguous
# range of rows, a multiple of SEG_ROW_ALIGN (the largest tile: SEG_WARPS
# warps x 128 rows). Both depend on the row count alone, never on the card,
# so the order of the additions (and every bit of the sums) is fixed by
# the shape. A CTA has SEG_WARPS warps, halved while their private
# accumulators would take more than SEG_SMEM_BUDGET (two CTAs to an SM).
SEG_CTAS = 264
SEG_WARPS = 16
SEG_ROW_ALIGN = 128 * SEG_WARPS
SEG_SMEM_BUDGET = 112 * 1024


def segment_sum_partition(n: int):
    """(CTAs, rows per CTA) of the segment-sum kernel's pass 1 over n rows:
    CTA c takes rows [c * rows, min((c + 1) * rows, n))."""
    if n <= 0:
        return 0, 0
    per = -(-n // SEG_CTAS)
    rows = -(-per // SEG_ROW_ALIGN) * SEG_ROW_ALIGN
    return -(-n // rows), rows


def segment_sum_warps(num_groups: int, m: int) -> int:
    """Warps per CTA of pass 1: each keeps a [G+1, M] f32 accumulator."""
    w = SEG_WARPS
    while w > 1 and w * (num_groups + 1) * m * 4 > SEG_SMEM_BUDGET:
        w //= 2
    return w


@_counted
def segment_sum(gid: torch.Tensor, vals: torch.Tensor, num_groups: int,
                block: int):
    """Per-group column sums in f32: `gid` [N] int32 in [0, G] (G takes
    dead rows), `vals` [N, M] float32, N a multiple of `block` -> [G, M]
    float32. The plain version adds block partials in block order, as the
    TPU does; the kernel adds in its own fixed order (see
    csrc/segment_sum.cu), the same on every run."""
    _check_vector(gid, torch.int32, "segment_sum gid")
    if vals.dtype != torch.float32 or vals.ndim != 2:
        raise TypeError(f"segment_sum vals: expected [N, M] float32, got "
                        f"{vals.dtype} {tuple(vals.shape)}")
    if not vals.is_contiguous():
        raise ValueError("segment_sum vals: expected a contiguous tensor")
    n, m = vals.shape
    if gid.shape[0] != n or gid.device != vals.device:
        raise ValueError("segment_sum: gid and vals differ in rows or device")
    if block <= 0 or n % block:
        raise ValueError(f"segment_sum: {n} rows is not a multiple of "
                         f"block {block}")
    if num_groups < 1 or m < 1:
        raise ValueError(f"segment_sum: {num_groups} groups x {m} columns")
    smem = (num_groups + 1) * m * 4
    if smem > SMEM_MAX_BYTES:
        raise ValueError(f"segment_sum: a [{num_groups + 1}, {m}] f32 "
                         f"accumulator needs {smem} B of shared memory, "
                         f"more than {SMEM_MAX_BYTES}")
    _called(segment_sum, (n, m, num_groups, block))
    if not _route(vals, "segment_sum"):
        return segment_sum_plain(gid, vals, num_groups, block)
    lib = _lib("segment_sum")
    ctas, rows = segment_sum_partition(n)
    warps = segment_sum_warps(num_groups, m)
    partial = torch.empty((ctas, num_groups, m), dtype=torch.float32,
                          device=vals.device)
    out = torch.empty((num_groups, m), dtype=torch.float32,
                      device=vals.device)
    with _on_card(vals):
        rc = lib.sr_segment_sum(gid.data_ptr(), vals.data_ptr(), n, m,
                                num_groups, ctas, rows, warps,
                                partial.data_ptr(), out.data_ptr(),
                                _stream(vals))
    _check_launch(lib, rc, "segment_sum")
    _launched(segment_sum, on=vals)
    return out


WRAPPERS = {"hash_build": hash_build, "hash_probe": hash_probe,
            "topn_select": topn_select,
            "probe_searchsorted": probe_searchsorted,
            "segment_sum": segment_sum}
reset_counts()
